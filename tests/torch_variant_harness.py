"""What the port's train-step variant tests share (``test_torch_variants.py``,
``test_torch_optim.py``, ``test_torch_ema.py``, ``test_torch_accum.py``).

The GAN, batch and σ of ``tests/test_torch_step.py`` (16x16x3, batch 4,
dropout 0); a JAX run of the JAX package's step for some steps with the keys
``PRNGKey(11 + i)``, and the port's run of the same steps from the same flax
weights (``convert.flax_state_to_torch``) with the JAX step's own draws pinned
through ``noise``, from its first step or from the JAX state (weights, Adam
moments, counters) before a later one; the JAX gradients of one step rebuilt
from the package's loss functions; and the checks at ``test_torch_step.py``'s
tolerances. ``compute_dtype`` (``"float32"`` or ``"bfloat16"``) and
``fast_gen`` build both sides' networks as the entry points' ``--bf16`` and
``--fast_gen`` do (``tests/test_torch_bf16.py``).
"""

import copy
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import torch

from blurred_gan_tpu.losses.wgan import (
    wgan_discriminator_loss as jax_wgan_d_loss, wgan_generator_loss as jax_g_loss,
    wgangp_discriminator_loss as jax_wgangp_d_loss)
from blurred_gan_tpu.models import DCGANDiscriminator as JaxD, DCGANGenerator as JaxG
from blurred_gan_tpu.train.config import (
    BlurredWGANGPHyperParameters as JaxHP, WGANHyperParameters as JaxWGANHP)
from blurred_gan_tpu.train.state import GAN as JaxGAN, create_train_state as jax_state
from blurred_gan_tpu.train.step import make_train_step as jax_step
from blurred_gan_tpu_torch.convert import flax_state_to_torch, flax_to_torch
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.train import step as step_mod
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters, WGANHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from test_torch_step import (
    B, D_CHANNELS, G_KW, GRAD, GRAD_FLOOR, LATENT, LOSS, PARAM_ATOL, RES, SIGMA, STATS,
    flat_torch, to_torch_layout, torch_gan)

PARAM_TOL = dict(rtol=5e-4, atol=5e-5)  # several steps, port against JAX (tests/test_fast.py)
KEY0 = 11  # the JAX step key of step i is PRNGKey(KEY0 + i)


def hparams(penalty_free: bool = False, **kw):
    """The port's hyperparameters at batch ``B``."""
    cls = WGANHyperParameters if penalty_free else BlurredWGANGPHyperParameters
    return cls(batch_size=B, global_batch_size=B, **kw)


def jax_hparams(penalty_free: bool = False, **kw):
    cls = JaxWGANHP if penalty_free else JaxHP
    return cls(batch_size=B, global_batch_size=B, **kw)


def jax_gan(compute_dtype: str = "float32", fast_gen: bool = False):
    """The JAX GAN; ``compute_dtype`` and ``fast_gen`` as the root
    ``train_celeba.py`` applies ``--bf16`` and ``--fast_gen``."""
    dt = jnp.dtype(compute_dtype)
    gen_kw = {"bn_dtype": dt, "output_f32": False} if fast_gen and dt != jnp.float32 else {}
    return JaxGAN(JaxG(**G_KW, compute_dtype=dt, **gen_kw),
                  JaxD(channels=D_CHANNELS, dropout_rate=0.0, compute_dtype=dt),
                  latent_size=LATENT, blurred=True)


def port_gan(compute_dtype: str = "float32", fast_gen: bool = False):
    """The port's GAN of :func:`jax_gan`'s configuration."""
    dt = getattr(torch, compute_dtype)
    if dt == torch.float32:
        return torch_gan()
    gen_kw = {"bn_dtype": dt, "output_f32": False} if fast_gen else {}
    return GAN(DCGANGenerator(**G_KW, compute_dtype=dt, **gen_kw),
               DCGANDiscriminator(channels=D_CHANNELS, dropout_rate=0.0, in_channels=3,
                                  image_hw=(RES, RES), compute_dtype=dt),
               latent_size=LATENT)


def reals_batches(n: int):
    rng = np.random.RandomState(0)
    return [rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8) for _ in range(n)]


def jax_draws(key, flip: bool):
    """The JAX step's draws for ``key`` (``train/step.py``): the flip mask
    split off first when on, then ``split(key, 4)``."""
    out = {}
    if flip:
        key, k_flip = jax.random.split(key)
        out["flip"] = jax.random.bernoulli(k_flip, 0.5, (B,))
    k_zd, _, k_gp, k_zg = jax.random.split(key, 4)
    out["z_d"] = jax.random.uniform(k_zd, (B, LATENT), jnp.float32)
    out["alpha"] = jax.random.uniform(k_gp, (B, 1, 1, 1), dtype=jnp.float32)
    out["z_g"] = jax.random.uniform(k_zg, (B, LATENT), jnp.float32)
    return {k: np.asarray(v) for k, v in out.items()}


def exact_rounding(fn, compute_dtype: str, *args):
    """The jitted ``fn`` as called on ``args``; off float32 compiled without
    XLA's excess precision, so that every bfloat16 value is rounded where the
    JAX package's dtypes put it (the CPU compiler's fusions otherwise keep
    some in float32, which neither the port nor the dtypes do)."""
    if compute_dtype == "float32":
        return fn
    return fn.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})


def jax_run(n_steps: int, n0: int = 0, penalty_free: bool = False,
            compute_dtype: str = "float32", fast_gen: bool = False, **kw):
    """``(states, metrics, draws)`` of ``n_steps`` JAX steps from the initial
    state with its batch counter set to ``n0``; ``states[0]`` is the start.
    One run per configuration, however the arguments are spelled."""
    return _jax_run(n_steps, n0, penalty_free, compute_dtype, fast_gen,
                    tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _jax_run(n_steps, n0, penalty_free, compute_dtype, fast_gen, kw):
    kw = dict(kw)
    hp = jax_hparams(penalty_free, **kw)
    jgan = jax_gan(compute_dtype, fast_gen)
    state = jax_state(jgan, hp, jax.random.PRNGKey(3), (RES, RES, 3))
    state = state.replace(n_batches=jnp.asarray(n0, jnp.int32))
    state = jax.tree_util.tree_map(np.asarray, state)
    step = jax_step(jgan, hp, donate_state=False)
    states, metrics, draws = [state], [], []
    for i, reals in enumerate(reals_batches(n_steps)):
        key = jax.random.PRNGKey(KEY0 + i)
        args = (state, jnp.asarray(reals), jnp.float32(SIGMA), key)
        if i == 0:
            step = exact_rounding(step, compute_dtype, *args)
        state, m, _ = step(*args)
        states.append(jax.tree_util.tree_map(np.asarray, state))
        metrics.append({k: float(v) for k, v in m.items()})
        draws.append(jax_draws(key, bool(kw.get("flip_augment"))))
    return states, metrics, draws


def load_jax_state(state, jstate) -> None:
    """The JAX state's weights, average, Adam moments and counters into the
    port's ``state``."""
    flax_state_to_torch(state, jstate)
    for opt, module, opt_state in ((state.g_opt, state.generator, jstate.g_opt_state),
                                   (state.d_opt, state.discriminator, jstate.d_opt_state)):
        adam = opt_state[0]  # optax.adam: (ScaleByAdamState, EmptyState)
        if not hasattr(adam, "mu") or int(adam.count) == 0:
            continue  # another optimizer's state, or Adam's before its first step
        moments = [flat_torch(flax_to_torch(copy.deepcopy(module), tree)).values()
                   for tree in (adam.mu, adam.nu)]
        for p, mu, nu in zip(module.parameters(), *moments):
            opt.state[p] = {"step": torch.tensor(float(adam.count)),
                            "exp_avg": torch.from_numpy(mu), "exp_avg_sq": torch.from_numpy(nu)}
    state.n_batches = int(jstate.n_batches)
    state.n_img = state.n_batches * B


def port_run(n_steps: int, n0: int = 0, penalty_free: bool = False, first: int = 0,
             total: Optional[int] = None, compute_dtype: str = "float32",
             fast_gen: bool = False, **kw):
    """The port's run of steps ``first`` to ``first + n_steps - 1`` of
    :func:`jax_run` (of ``total`` steps) from the JAX state before step
    ``first``: ``(gan, state, metrics, grads)``, ``grads`` per step ``{"d":
    [...], "g": [...]}`` as handed to the optimizers (``g`` absent on a step
    that skips the generator)."""
    states, _, draws = jax_run(total or first + n_steps, n0, penalty_free, compute_dtype,
                               fast_gen, **kw)
    gan = port_gan(compute_dtype, fast_gen)
    state = create_train_state(gan, hparams(penalty_free, **kw), device="cpu")
    load_jax_state(state, states[first])
    step = make_train_step(gan, hparams(penalty_free, **kw))
    grads, metrics = [], []
    real_apply = step_mod._apply

    def recording_apply(opt, params, gs):
        grads[-1]["g" if opt is state.g_opt else "d"] = [g.detach().numpy().copy() for g in gs]
        real_apply(opt, params, gs)

    step_mod._apply = recording_apply
    try:
        for i in range(first, first + n_steps):
            grads.append({})
            noise = {k: torch.from_numpy(v.copy()) for k, v in draws[i].items()}
            m, _ = step(state, torch.from_numpy(reals_batches(i + 1)[i]), SIGMA, noise=noise)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        step_mod._apply = real_apply
    return gan, state, metrics, grads


def jax_grads(jstate0, jstate1, reals, draws, *, gp_coefficient, with_gp, accum=1,
              e_drift=1e-4, gen=True, compute_dtype: str = "float32", fast_gen: bool = False):
    """The JAX gradients of one step, rebuilt from the package's losses:
    the critic's from ``jstate0`` on the (flipped) reals, the generator's
    through ``jstate1``'s critic; each the sum over ``accum`` microbatches
    with the penalty and drift scaled by 1/``accum``. In the port's
    parameter layout."""
    jgan = jax_gan(compute_dtype, fast_gen)
    x = (jnp.asarray(reals).astype(jnp.float32) - 127.5) / 127.5
    if "flip" in draws:
        x = jnp.where(draws["flip"][:, None, None, None], x[:, :, ::-1, :], x)
    fakes, _ = jgan.generate(jstate0.g_params, jstate0.g_stats, draws["z_d"], train=False)
    m = B // accum
    micro = [slice(i * m, (i + 1) * m) for i in range(accum)]

    def d_loss(dp):
        total = 0.0
        for mb in micro:
            f, r = fakes[mb], x[mb]
            scores = jgan.critic(dp, jnp.concatenate([f, r]), SIGMA, train=False)
            fs, rs = jnp.split(scores, 2)
            if gp_coefficient is None:
                total = total + jax_wgan_d_loss(rs, fs, float(B))
            else:
                total = total + jax_wgangp_d_loss(
                    lambda im: jgan.critic(dp, im, SIGMA, train=False), r, f, rs, fs, None,
                    global_batch_size=float(B), gp_coefficient=gp_coefficient / accum,
                    e_drift=e_drift / accum, alpha=draws["alpha"][mb], include_gp=with_gp)[0]
        return total

    def g_loss(gp):
        total = 0.0
        for mb in micro:
            out, _ = jgan.generate(gp, jstate0.g_stats, draws["z_g"][mb], train=True)
            total = total + jax_g_loss(jgan.critic(jstate1.d_params, out, SIGMA, train=False),
                                       float(B))
        return total

    def grad(loss, params):
        if compute_dtype == "float32":  # op by op, as before
            return jax.grad(loss)(params)
        return exact_rounding(jax.jit(jax.grad(loss)), compute_dtype, params)(params)

    out = {"d": to_torch_layout(torch_gan().discriminator, grad(d_loss, jstate0.d_params))}
    if gen:
        out["g"] = to_torch_layout(torch_gan().generator, grad(g_loss, jstate0.g_params))
    return out


def named(module, arrays):
    return dict(zip([n for n, _ in module.named_parameters()], arrays))


def assert_grads_close(module, got, want):
    got = named(module, got)
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


def assert_post_step_close(module, want_flax_params, grads):
    """Post-step parameters at ``PARAM_ATOL``, elements with ``|g| <
    GRAD_FLOOR`` exempt (``tests/test_torch_step.py``). ``grads``: the step's
    gradients, by name or in parameter order."""
    want = to_torch_layout(_fresh(module), want_flax_params)
    if not isinstance(grads, dict):
        grads = named(module, grads)
    checked = 0
    for name, got in flat_torch(module).items():
        mask = np.abs(grads[name]) >= GRAD_FLOOR
        np.testing.assert_allclose(got[mask], want[name][mask], rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
        checked += int(mask.sum())
    assert checked > 0.9 * sum(g.size for g in grads.values())


def _fresh(module):
    gan = torch_gan()
    return gan.generator if isinstance(module, type(gan.generator)) else gan.discriminator


def assert_params_close(module, want_flax_params, **tol):
    want = to_torch_layout(_fresh(module), want_flax_params)
    for name, got in flat_torch(module).items():
        np.testing.assert_allclose(got, want[name], err_msg=name, **(tol or PARAM_TOL))


def assert_bn_stats_close(generator, g_stats):
    for i, bn in enumerate([generator.dense_bn, *generator.bns]):
        s = g_stats[f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), **STATS)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), **STATS)
