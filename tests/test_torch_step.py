"""One full train step of the port against ``blurred_gan_tpu.train.step.make_train_step``.

Both sides start from the same flax weights (carried into the port by
``convert.flax_to_torch``), take the same uint8 batch and σ, and use the same
draws: ``z_d``, ``z_g`` and the penalty's ``alpha`` are computed from the JAX
step key exactly as the JAX step does (``split(rng, 4)``, ``uniform``), and
handed to the port through its ``noise`` argument. The critic's dropout is 0,
since the two frameworks cannot draw the same masks. Widths are narrow
(16x16x3 images, batch 4).

Tolerances: losses rtol 1e-5 / atol 1e-6 (float32 forward); gradients rtol
1e-4 / atol 1e-5 (grad-of-grad through the blur and the convolutions, as
tests/test_blur_pallas.py); BatchNorm running statistics rtol 1e-5 / atol
1e-6. Post-step parameters atol 1e-6: Adam's first update is
``-lr * g / (|g| + 1e-7)``, close to ``-lr * sign(g)``, so an element whose
gradient is within float32 rounding of zero can move by up to ``lr`` in either
direction on either side. Elements with ``|g| < 1e-4`` (where the gradient
tolerance above is 10% of ``|g|``) are exempt from the parameter check; their
gradients are still checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.models import DCGANDiscriminator as JaxD, DCGANGenerator as JaxG
from blurred_gan_tpu.losses.wgan import wgan_generator_loss, wgangp_discriminator_loss
from blurred_gan_tpu.train import BlurredWGANGPHyperParameters as JaxHP
from blurred_gan_tpu.train.state import GAN as JaxGAN, create_train_state as jax_state
from blurred_gan_tpu.train.step import make_train_step as jax_step
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.train import step as step_mod
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

LOSS = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
STATS = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
GRAD_FLOOR = 1e-4

B, LATENT, RES, SIGMA = 4, 8, 16, 1.5
G_KW = dict(latent_size=LATENT, init_hw=(4, 4), init_features=32,
            blocks=((32, 1), (16, 2), (8, 2)), out_channels=3)
D_CHANNELS = (8, 16)


def torch_gan():
    return GAN(DCGANGenerator(**G_KW),
               DCGANDiscriminator(channels=D_CHANNELS, dropout_rate=0.0, in_channels=3,
                                  image_hw=(RES, RES)),
               latent_size=LATENT)


def flat_torch(module):
    return {n: p.detach().numpy().copy() for n, p in module.named_parameters()}


def to_torch_layout(module, params, stats=None):
    """flax params -> {torch parameter name: array} through the converter."""
    flax_to_torch(module, params, stats)
    return flat_torch(module)


@pytest.fixture(scope="module")
def run():
    rng = np.random.RandomState(0)
    reals = rng.randint(0, 256, (B, RES, RES, 3)).astype(np.uint8)
    hp_j = JaxHP(batch_size=B, global_batch_size=B)
    jgan = JaxGAN(JaxG(**G_KW), JaxD(channels=D_CHANNELS, dropout_rate=0.0),
                  latent_size=LATENT, blurred=True)
    state0 = jax_state(jgan, hp_j, jax.random.PRNGKey(3), (RES, RES, 3))
    state0 = jax.tree_util.tree_map(np.asarray, state0)
    key = jax.random.PRNGKey(11)
    state1, jmetrics, _ = jax_step(jgan, hp_j, donate_state=False)(
        state0, jnp.asarray(reals), jnp.float32(SIGMA), key)

    # The JAX step's own draws (train/step.py, losses/wgan.py).
    k_zd, _, k_gp, k_zg = jax.random.split(key, 4)
    z_d = jax.random.uniform(k_zd, (B, LATENT), jnp.float32)
    z_g = jax.random.uniform(k_zg, (B, LATENT), jnp.float32)
    alpha = jax.random.uniform(k_gp, (B, 1, 1, 1), dtype=jnp.float32)

    # The JAX gradients, rebuilt from the package's own loss functions.
    x = (jnp.asarray(reals).astype(jnp.float32) - 127.5) / 127.5
    fakes, _ = jgan.generate(state0.g_params, state0.g_stats, z_d, train=False)

    def d_loss(dp):
        scores = jgan.critic(dp, jnp.concatenate([fakes, x]), SIGMA, train=False)
        f, r = jnp.split(scores, 2)
        return wgangp_discriminator_loss(
            lambda im: jgan.critic(dp, im, SIGMA, train=False), x, fakes, r, f, None,
            global_batch_size=float(B), alpha=alpha)[0]

    def g_loss(gp):
        out, _ = jgan.generate(gp, state0.g_stats, z_g, train=True)
        return wgan_generator_loss(jgan.critic(state1.d_params, out, SIGMA, train=False),
                                   float(B))

    jd_grads = jax.grad(d_loss)(state0.d_params)
    jg_grads = jax.grad(g_loss)(state0.g_params)

    # The port, from the same weights and draws.
    gan = torch_gan()
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B)
    state = create_train_state(gan, hp, device="cpu")
    flax_to_torch(gan.generator, state0.g_params, state0.g_stats)
    flax_to_torch(gan.discriminator, state0.d_params)
    grads = {}

    def recording_apply(opt, params, gs):
        grads[id(opt)] = [g.detach().numpy().copy() for g in gs]
        real_apply(opt, params, gs)

    real_apply = step_mod._apply
    step_mod._apply = recording_apply
    try:
        noise = {k: torch.from_numpy(np.array(v)) for k, v in
                 (("z_d", z_d), ("z_g", z_g), ("alpha", alpha))}
        metrics, _ = make_train_step(gan, hp)(state, torch.from_numpy(reals), SIGMA,
                                              noise=noise)
    finally:
        step_mod._apply = real_apply

    names_d = [n for n, _ in gan.discriminator.named_parameters()]
    names_g = [n for n, _ in gan.generator.named_parameters()]
    return dict(
        jmetrics={k: float(v) for k, v in jmetrics.items()},
        metrics={k: float(v) for k, v in metrics.items()},
        d_grads=dict(zip(names_d, grads[id(state.d_opt)])),
        g_grads=dict(zip(names_g, grads[id(state.g_opt)])),
        jd_grads=to_torch_layout(torch_gan().discriminator, jd_grads),
        jg_grads=to_torch_layout(torch_gan().generator, jg_grads),
        d_after=flat_torch(gan.discriminator), g_after=flat_torch(gan.generator),
        jd_after=to_torch_layout(torch_gan().discriminator, state1.d_params),
        jg_after=to_torch_layout(torch_gan().generator, state1.g_params),
        g_stats=state1.g_stats, generator=gan.generator, state=state)


@pytest.mark.parametrize("name", ["disc_loss", "gen_loss", "wgan_loss", "gp_term",
                                  "norm_term", "fake_scores", "real_scores", "std"])
def test_metrics(run, name):
    np.testing.assert_allclose(run["metrics"][name], run["jmetrics"][name], **LOSS)


@pytest.mark.parametrize("net", ["d", "g"])
def test_gradients(run, net):
    got, want = run[f"{net}_grads"], run[f"j{net}_grads"]
    assert got.keys() == want.keys()
    for name in got:
        np.testing.assert_allclose(got[name], want[name], err_msg=name, **GRAD)


@pytest.mark.parametrize("net", ["d", "g"])
def test_post_step_parameters(run, net):
    grads = run[f"j{net}_grads"]
    checked = 0
    for name, got in run[f"{net}_after"].items():
        mask = np.abs(grads[name]) >= GRAD_FLOOR
        np.testing.assert_allclose(got[mask], run[f"j{net}_after"][name][mask],
                                   rtol=0, atol=PARAM_ATOL, err_msg=name)
        checked += int(mask.sum())
    assert checked > 0.9 * sum(g.size for g in grads.values())


def test_batchnorm_running_stats(run):
    bns = [run["generator"].dense_bn, *run["generator"].bns]
    for i, bn in enumerate(bns):
        s = run["g_stats"][f"BatchNorm_{i}"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), **STATS)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), **STATS)


def test_counters(run):
    assert run["state"].n_img == B and run["state"].n_batches == 1


@pytest.mark.parametrize("field,value", [("d_steps_per_g_step", 2), ("gp_every_n_steps", 4),
                                         ("ema_decay", 0.999), ("g_learning_rate", 1e-4),
                                         ("flip_augment", True),
                                         ("grad_accumulation_steps", 2),
                                         ("gp_coefficient", None)])
def test_unported_settings_raise(field, value):
    # Once unported, each of these settings now builds a step that runs: two
    # CPU steps with finite losses (the variants' parity with the JAX step is
    # in tests/test_torch_variants.py, test_torch_ema.py, test_torch_accum.py).
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B)
    setattr(hp, field, value)
    gan = torch_gan()
    state = create_train_state(gan, hp, device="cpu")
    step = make_train_step(gan, hp)
    reals = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (B, RES, RES, 3))
                             .astype(np.uint8))
    for _ in range(2):
        metrics, fakes = step(state, reals, SIGMA)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        assert fakes.shape == (B, 3, RES, RES)
    assert state.n_batches == 2


def test_draws_are_a_function_of_seed_and_counter():
    def two_steps(seed):
        gan = GAN(DCGANGenerator(**G_KW),
                  DCGANDiscriminator(channels=D_CHANNELS, in_channels=3, image_hw=(RES, RES)),
                  latent_size=LATENT)
        hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B)
        state = create_train_state(gan, hp, device="cpu", seed=0)
        step = make_train_step(gan, hp, seed=seed)
        reals = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (B, RES, RES, 3))
                                 .astype(np.uint8))
        return [step(state, reals, SIGMA)[0]["disc_loss"].item() for _ in range(2)]

    a, b, c = two_steps(0), two_steps(0), two_steps(1)
    assert a == b and a != c and a[0] != a[1]
