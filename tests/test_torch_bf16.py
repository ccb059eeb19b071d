"""bfloat16 compute in the port (``--bf16``, ``--fast_gen``) against the JAX
package's ``compute_dtype=jnp.bfloat16``.

The same numpy inputs and the same flax weights (``convert.flax_to_torch``) go
through both. The JAX package trains with XLA's excess precision on (its
default compile), which keeps the generator's bfloat16 products as float32
sums where a float32 BatchNorm or the float32 tanh consumes them; the port
does the same (``models/dcgan.py``'s ``f32_sums``). Elsewhere the CPU
compiler's fusions also keep some bfloat16 values in float32 (the critic's
operands), which neither the JAX package's dtypes nor the port do, so the
critic's side is compiled without excess precision
(``torch_variant_harness.exact_rounding``). The references: the generator
alone as compiled by default; the critic alone compiled exactly; a step,
``torch_variant_harness.mixed_step``, which composes the two at the
generator / critic boundary. The port's eval-mode critic is then bit-equal to
JAX's and its generator equal to within float32 rounding; what is left
elsewhere is float32 rounding in another order (BatchNorm's batch
statistics, the blur) that moves a bfloat16 rounding by one unit here and
there.

Tolerances, each from bfloat16's roundoff (8 significant bits, a unit of
2^-7 at 1):

- the generator's forward: max |diff| <= 1e-6 without ``fast_gen``
  (measured <= 4.9e-7; the compile without excess precision is 1.9e-2 away
  in train mode), one unit (2^-7) with it, whose bfloat16 output rounds
  where the batch statistics' float32 order moves a value across a
  rounding boundary (measured <= 2^-8), and relative L2 <= 2e-3;
- critic scores: atol 2e-4 (measured 4e-8; JAX's own gap 1.1e-3);
- the generator's gradient for a fixed cotangent: relative L2 3e-2 per
  tensor (measured <= 6.1e-3 without ``fast_gen``, <= 3.2e-5 with it: the
  port keeps the backward's float32 sums where the default compile does,
  and last-bit differences in BatchNorm's float32 sums become bfloat16
  units further up without ``fast_gen``, ``tests/test_torch_bf16_backward.py``;
  JAX's own gap between its two compiles 9e-3 to 9e-2);
- one train step against ``mixed_step``: losses rtol 1e-5 / atol 1e-4
  (measured <= 3.3e-5); the critic's gradient, relative L2 over the network
  1e-2 (measured 4.5e-3; JAX's own gap 1.8e-2) and per weight 1e-3
  (measured 1e-4); the generator's, relative L2 over the network 3e-2 with
  ``fast_gen`` (measured 3.6e-3) and 1e-1 without (measured 3.8e-3);
  post-step parameters atol 2e-6 where both gradients are at least 1e-4
  and agree in sign (Adam's first step moves an element by
  ``lr·g/(|g| + 1e-7)``, so two such gradients part it by at most
  ``lr·1e-7/1e-4`` = 1e-6), which must be 90% of the elements;
- BatchNorm running statistics: rtol 2^-8 / atol 1e-6.

The dtype checks read the JAX modules' own intermediates, so a port that ran
any bfloat16 layer in float32, or a float32 one in bfloat16, fails them.
"""

import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.losses.wgan import gradient_penalty as jax_gradient_penalty
from blurred_gan_tpu.models import dcgan as jm
from blurred_gan_tpu.train.step import make_train_step as jax_step
from blurred_gan_tpu_torch import train_celeba
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.losses.wgan import gradient_penalty
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.models import dcgan as tm
from blurred_gan_tpu_torch.ops.blur import blur_images
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig, _nhwc_numpy
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_models import flax_state, nchw, nhwc
from test_torch_step import (
    B, D_CHANNELS, G_KW, GRAD_FLOOR, PARAM_ATOL, RES, SIGMA, flat_torch, to_torch_layout)
from torch_variant_harness import (
    KEY0, exact_rounding, jax_gan, jax_hparams, jax_run, mixed_grads, mixed_step, named,
    port_gan, port_run, reals_batches)
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: JAX's draws as pinned)
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

BF16_UNIT = 2.0 ** -7
GEN_ATOL = 1e-6
FORWARD_REL_L2 = 2e-3
SCORE_ATOL = 2e-4
LOSS = dict(rtol=1e-5, atol=1e-4)
D_GRAD_REL_L2, D_WEIGHT_REL_L2 = 1e-2, 1e-3
G_GRAD_REL_L2 = {False: 1e-1, True: 3e-2}         # keyed by fast_gen
G_VJP_REL_L2 = 3e-2
STATS = dict(rtol=2.0 ** -8, atol=1e-6)
# (compute_dtype, fast_gen): float32, --bf16, --bf16 --fast_gen.
CONFIGS = [("float32", False), ("bfloat16", False), ("bfloat16", True)]
BF16_CONFIGS = CONFIGS[1:]


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


def config_id(config):
    dtype, fast = config
    return dtype + ("+fast_gen" if fast else "")


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def jax_generator(dtype, fast, upsample="transpose"):
    dt = jnp.dtype(dtype)
    kw = {"bn_dtype": dt, "output_f32": False} if fast else {}
    return jm.DCGANGenerator(**G_KW, upsample=upsample, compute_dtype=dt, **kw)


def port_generator(dtype, fast, upsample="transpose"):
    dt = getattr(torch, dtype)
    kw = {"bn_dtype": dt, "output_f32": False} if fast else {}
    return tm.DCGANGenerator(**G_KW, upsample=upsample, compute_dtype=dt, **kw)


def latents():
    return np.random.RandomState(1).rand(4, G_KW["latent_size"]).astype(np.float32)


def images():
    return np.random.RandomState(2).uniform(-1, 1, (4, RES, RES, 3)).astype(np.float32)


def generator_pair(dtype, fast, upsample):
    """(JAX module, port module, variables) from one perturbed flax state."""
    z = latents()
    params, stats = flax_state(jax_generator("float32", False, upsample), z)
    port = port_generator(dtype, fast, upsample)
    flax_to_torch(port, params, stats)
    return jax_generator(dtype, fast, upsample), port, {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# (i) forward parity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("upsample", ["transpose", "resize"])
@pytest.mark.parametrize("fast", [False, True], ids=["bf16", "bf16+fast_gen"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_generator_forward(upsample, fast, train):
    jg, tg, variables = generator_pair("bfloat16", fast, upsample)
    z = latents()

    def apply(v, z):
        if train:
            return jg.apply(v, z, train=True, mutable=["batch_stats"])[0]
        return jg.apply(v, z, train=False)

    want = jax.jit(apply)(variables, jnp.asarray(z))
    tg.train(train)
    got = tg(torch.from_numpy(z)).detach()
    assert got.dtype == (torch.bfloat16 if fast else torch.float32)
    assert want.dtype == (jnp.bfloat16 if fast else jnp.float32)
    got, want = nhwc(got.float()), np.asarray(want, np.float32)
    assert np.abs(got - want).max() <= (BF16_UNIT if fast else GEN_ATOL)
    assert rel_l2(got, want) <= FORWARD_REL_L2


def test_critic_scores():
    x = images()
    jd32 = jm.DCGANDiscriminator(channels=D_CHANNELS, dropout_rate=0.0)
    params, _ = flax_state(jd32, x)
    # Biases off zero, as after a step: flax adds a Conv's bias to the
    # bfloat16 product, not inside it.
    rng = np.random.RandomState(5)
    for name in params:
        params[name]["bias"] = (0.05 * rng.randn(*params[name]["bias"].shape)).astype(np.float32)
    jd = jm.DCGANDiscriminator(channels=D_CHANNELS, dropout_rate=0.0,
                               compute_dtype=jnp.bfloat16)
    td = tm.DCGANDiscriminator(channels=D_CHANNELS, dropout_rate=0.0, image_hw=(RES, RES),
                               compute_dtype=torch.bfloat16)
    flax_to_torch(td, params)
    apply = jax.jit(lambda p, x: jd.apply({"params": p}, x))
    want = np.asarray(exact_rounding(apply, "bfloat16", params, jnp.asarray(x))(
        params, jnp.asarray(x)))
    got = td(nchw(x)).detach()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    # ... and not the float32 critic's scores.
    gap = np.abs(np.asarray(jd32.apply({"params": params}, jnp.asarray(x))) - want).max()
    assert gap > 2 * SCORE_ATOL


@pytest.mark.parametrize("fast", [False, True], ids=["bf16", "bf16+fast_gen"])
def test_generator_gradient(fast):
    """The train-mode generator's parameter gradient for one fixed float32
    cotangent on its output."""
    jg, tg, variables = generator_pair("bfloat16", fast, "transpose")
    z = latents()
    cot = np.random.RandomState(3).randn(4, RES, RES, 3).astype(np.float32)

    def loss(params):
        out, _ = jg.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          jnp.asarray(z), train=True, mutable=["batch_stats"])
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = to_torch_layout(port_generator("float32", False),
                           jax.jit(jax.grad(loss))(variables["params"]))
    tg.train(True)
    torch.sum(tg(torch.from_numpy(z)).float() * nchw(cot)).backward()
    for name, p in tg.named_parameters():
        assert p.grad.dtype == torch.float32
        assert rel_l2(p.grad.numpy(), want[name]) <= G_VJP_REL_L2, name


def test_critic_input_gradient():
    """The blurred critic's input gradient (what the generator step
    backpropagates into the fakes), bit for bit up to the blur's float32
    rounding."""
    states, _, _ = jax_run(1, compute_dtype="bfloat16")
    d_params = states[0].d_params
    jgan, gan = jax_gan("bfloat16"), port_gan("bfloat16")
    flax_to_torch(gan.discriminator, d_params)
    x = images()
    grad = jax.jit(jax.grad(lambda x: jnp.sum(jgan.critic(d_params, x, SIGMA, train=False))))
    want = np.asarray(exact_rounding(grad, "bfloat16", jnp.asarray(x))(jnp.asarray(x)))
    xt = nchw(x).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(gan.critic(xt, SIGMA, train=False)), xt)
    assert got.dtype == torch.float32
    assert rel_l2(nhwc(got), want) <= 1e-5


# ---------------------------------------------------------------------------
# (ii) dtypes, read from the JAX modules' intermediates
# ---------------------------------------------------------------------------


def jax_output_dtypes(module, variables, x, **apply_kw):
    out, state = module.apply(variables, x, capture_intermediates=True,
                              mutable=["intermediates", "batch_stats"], **apply_kw)
    dtypes = {name: np.dtype(v["__call__"][0].dtype).name
              for name, v in state["intermediates"].items() if name != "__call__"}
    return dtypes, np.dtype(out.dtype).name


def recorded_dtypes(named_modules):
    """Forward hooks recording each module's output dtype, and (under
    ``name + ".input"``) its first input's."""
    seen, handles = {}, []
    for name, module in named_modules.items():
        def hook(m, args, out, name=name):
            seen[name] = str(out.dtype).replace("torch.", "")
            seen[name + ".input"] = str(args[0].dtype).replace("torch.", "")
        handles.append(module.register_forward_hook(hook))
    return seen, handles


def flax_named_generator_layers(tg):
    """The port generator's modules by flax name (``convert.flax_to_torch``'s
    naming)."""
    out = {f"BatchNorm_{i}": bn for i, bn in enumerate([tg.dense_bn, *tg.bns])}
    counts = Counter()
    for layer in [*tg.ups, tg.final]:
        kind = layer.flax_kind if isinstance(layer, tm.Upsample) else "Conv"
        out[f"{kind}_{counts[kind]}"] = layer
        counts[kind] += 1
    return out


@pytest.mark.parametrize("upsample", ["transpose", "resize"])
@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_generator_dtypes(config, upsample):
    dtype, fast = config
    jg, tg, variables = generator_pair(dtype, fast, upsample)
    want, want_out = jax_output_dtypes(jg, variables, jnp.asarray(latents()), train=True)
    layers = flax_named_generator_layers(tg)
    seen, handles = recorded_dtypes(layers)
    tg.train(True)
    out = tg(torch.from_numpy(latents()))
    for h in handles:
        h.remove()
    assert str(out.dtype).replace("torch.", "") == want_out
    # The products whose consumer is float32 (every BatchNorm; the tanh
    # unless fast_gen) return their float32 sums, as JAX's default compile
    # keeps them; every other layer returns JAX's declared dtype.
    sums = {"Dense_0"} | {name for name, layer in layers.items()
                          if getattr(getattr(layer, "conv", layer), "f32_sums", False)}
    final = next(name for name, layer in layers.items() if layer is tg.final)
    products = {"Dense_0", *(name for name in layers if not name.startswith("BatchNorm"))}
    assert sums == products - ({final} if fast else set())

    def port_dtype(name):
        return "float32" if name in sums else want[name]

    assert seen["BatchNorm_0.input"] == port_dtype("Dense_0")  # the Dense's output
    for name in layers:
        assert seen[name] == port_dtype(name), name
    conv = "bfloat16" if dtype == "bfloat16" else "float32"
    assert want["ConvTranspose_0"] == conv
    assert want["BatchNorm_1"] == ("bfloat16" if fast else "float32")
    assert want_out == ("bfloat16" if fast else "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_critic_dtypes(dtype):
    x = images()
    jd = jm.DCGANDiscriminator(channels=D_CHANNELS, compute_dtype=jnp.dtype(dtype))
    params, _ = flax_state(jm.DCGANDiscriminator(channels=D_CHANNELS), x)
    want, want_out = jax_output_dtypes(jd, {"params": params}, jnp.asarray(x), train=True,
                                       rngs={"dropout": jax.random.PRNGKey(0)})
    td = tm.DCGANDiscriminator(channels=D_CHANNELS, image_hw=(RES, RES),
                               compute_dtype=getattr(torch, dtype))
    flax_to_torch(td, params)
    layers = {f"Conv_{i}": conv for i, conv in enumerate(td.convs)}
    layers["Dense_0"] = td.dense
    seen, handles = recorded_dtypes(layers)
    td.train(True)  # dropout on: its scaling runs in the convolutions' dtype
    out = td(nchw(x), generator=torch.Generator().manual_seed(0))
    for h in handles:
        h.remove()
    for name in layers:
        assert seen[name] == want[name], name
    assert seen["Dense_0.input"] == "float32" and want["Dense_0"] == "float32"
    assert str(out.dtype).replace("torch.", "") == want_out == "float32"
    assert want["Conv_0"] == dtype


def test_penalty_interpolates_are_float32():
    """bfloat16 fakes meet float32 reals: the interpolates, their gradient and
    the penalty are float32, as ``jnp`` promotes them."""
    rng = np.random.RandomState(4)
    reals = rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)
    fakes = torch.from_numpy(rng.uniform(-1, 1, (4, 3, 8, 8)).astype(np.float32)).bfloat16()
    alpha = rng.rand(4, 1, 1, 1).astype(np.float32)
    seen = []

    def critic(x):
        seen.append(x.dtype)
        return torch.sum(x.to(torch.float32) ** 2, dim=(1, 2, 3))

    gp = gradient_penalty(critic, torch.from_numpy(reals), fakes, alpha=torch.from_numpy(alpha))
    assert seen == [torch.float32] and gp.dtype == torch.float32
    want = jax_gradient_penalty(
        lambda x: jnp.sum(x.astype(jnp.float32) ** 2, axis=(1, 2, 3)),
        jnp.asarray(reals), jnp.asarray(fakes.float().numpy()).astype(jnp.bfloat16), None,
        alpha=jnp.asarray(alpha))
    assert want.dtype == jnp.float32
    np.testing.assert_allclose(float(gp.detach()), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# (iii) one full train step against the JAX package's
# ---------------------------------------------------------------------------


def step_args(state):
    return (state, jnp.asarray(reals_batches(1)[0]), jnp.float32(SIGMA),
            jax.random.PRNGKey(KEY0))


def test_mixed_step_at_float32_is_the_jitted_step():
    """The reference of the bfloat16 step tests (``mixed_step``) at float32,
    where its two compiles are one: the JAX package's jitted step at
    ``test_torch_step.py``'s tolerances (losses rtol 1e-5 / atol 1e-6,
    parameters atol 1e-6 where ``|g| >= 1e-4``, statistics rtol 1e-5)."""
    states, metrics, _ = jax_run(1)
    state, got, _, grads = mixed_step(jax_gan(), jax_hparams(), "float32")(*step_args(states[0]))
    for k, want in metrics[0].items():
        np.testing.assert_allclose(float(got[k]), want, rtol=1e-5, atol=1e-6, err_msg=k)
    for side in ("d", "g"):
        leaves = [jax.tree_util.tree_leaves(t) for t in (
            getattr(state, f"{side}_params"), getattr(states[1], f"{side}_params"), grads[side])]
        for a, b, g in zip(*leaves):
            mask = np.abs(np.asarray(g)) >= GRAD_FLOOR
            np.testing.assert_allclose(np.asarray(a)[mask], np.asarray(b)[mask], rtol=0,
                                       atol=PARAM_ATOL)
    for a, b in zip(jax.tree_util.tree_leaves(state.g_stats),
                    jax.tree_util.tree_leaves(states[1].g_stats)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_mixed_step_compiles_the_generator_by_default_and_the_critic_exactly():
    """At bfloat16 the critic step's fakes are those of the JAX package's
    step compiled by default (XLA's excess precision on), not those of the
    step compiled without it, and the reals' scores, which no generator
    touches, the latter's (at this width the two compiles agree on them;
    at full width the default drops 40 of the critic's roundings,
    ``tests/torch_fullwidth_parity.py --hlo``)."""
    jgan, hp = jax_gan("bfloat16"), jax_hparams()
    args = step_args(jax_run(1, compute_dtype="bfloat16")[0][0])
    _, metrics, fakes, _ = mixed_step(jgan, hp, "bfloat16")(*args)
    lowered = jax.jit(jax_step(jgan, hp, donate_state=False)).lower(*args)
    default = lowered.compile()(*args)
    exact = lowered.compile(compiler_options={"xla_allow_excess_precision": False})(*args)
    fakes, want, other = (np.asarray(f, np.float32) for f in (fakes, default[2], exact[2]))
    np.testing.assert_allclose(fakes, want, rtol=0, atol=1e-6)
    assert np.abs(fakes - other).max() > 1e-4
    assert float(metrics["real_scores"]) == float(exact[1]["real_scores"])


@pytest.fixture(scope="module", params=BF16_CONFIGS, ids=config_id)
def step_run(request):
    dtype, fast = request.param
    states, jmetrics, _ = jax_run(1, compute_dtype=dtype, fast_gen=fast)
    gan, state, metrics, grads = port_run(1, compute_dtype=dtype, fast_gen=fast)
    jgrads = mixed_grads(1, dtype, fast)[0]
    return dict(fast=fast, gan=gan, metrics=metrics[0], jmetrics=jmetrics[0], grads=grads[0],
                jgrads=jgrads, jstates=states)


def test_step_metrics(step_run):
    got, want = step_run["metrics"], step_run["jmetrics"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS)


def test_step_critic_gradient(step_run):
    got = named(step_run["gan"].discriminator, step_run["grads"]["d"])
    want = step_run["jgrads"]["d"]
    assert got.keys() == want.keys()
    flat = [np.concatenate([d[n].ravel() for n in got]) for d in (got, want)]
    assert rel_l2(*flat) <= D_GRAD_REL_L2
    for name in got:
        assert got[name].dtype == np.float32
        if name.endswith("weight"):
            assert rel_l2(got[name], want[name]) <= D_WEIGHT_REL_L2, name


def test_step_generator_gradient(step_run):
    got = named(step_run["gan"].generator, step_run["grads"]["g"])
    want = step_run["jgrads"]["g"]
    assert got.keys() == want.keys()
    flat = [np.concatenate([d[n].ravel() for n in got]) for d in (got, want)]
    assert rel_l2(*flat) <= G_GRAD_REL_L2[step_run["fast"]]


@pytest.mark.parametrize("net", ["discriminator", "generator"])
def test_step_parameters(step_run, net):
    module = getattr(step_run["gan"], net)
    side = net[0]
    flax_params = getattr(step_run["jstates"][1], f"{side}_params")
    want = to_torch_layout(getattr(port_gan(), net), flax_params)
    got_g, want_g = named(module, step_run["grads"][side]), step_run["jgrads"][side]
    checked = total = 0
    for name, p in flat_torch(module).items():
        assert p.dtype == np.float32
        mask = ((np.abs(got_g[name]) >= GRAD_FLOOR) & (np.abs(want_g[name]) >= GRAD_FLOOR)
                & (np.sign(got_g[name]) == np.sign(want_g[name])))
        np.testing.assert_allclose(p[mask], want[name][mask], rtol=0, atol=2 * PARAM_ATOL,
                                   err_msg=name)
        checked, total = checked + int(mask.sum()), total + mask.size
    assert checked > 0.9 * total


def test_step_batchnorm_statistics(step_run):
    g_stats = step_run["jstates"][1].g_stats
    gen = step_run["gan"].generator
    for i, bn in enumerate([gen.dense_bn, *gen.bns]):
        s = g_stats[f"BatchNorm_{i}"]
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), **STATS)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), **STATS)


@pytest.mark.parametrize("config", CONFIGS, ids=config_id)
def test_step_returns_the_generators_fakes(config):
    gan = port_gan(*config)
    hp = BlurredWGANGPHyperParameters(batch_size=B, global_batch_size=B)
    state = create_train_state(gan, hp, device="cpu")
    metrics, fakes = make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]),
                                              SIGMA)
    assert fakes.dtype == (torch.bfloat16 if config[1] else torch.float32)
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in metrics.values())
    assert all(p.dtype == torch.float32 for p in gan.generator.parameters())


# ---------------------------------------------------------------------------
# (iv) the chunked runner; (vi) checkpoints across dtypes; feeders and grids
# ---------------------------------------------------------------------------


def micro_gan(dtype="float32", fast=False):
    dt = getattr(torch, dtype)
    kw = {"bn_dtype": dt, "output_f32": False} if fast else {}
    g = tm.DCGANGenerator(latent_size=16, init_hw=(4, 4), init_features=32,
                          blocks=((32, 2), (16, 2)), out_channels=1, compute_dtype=dt, **kw)
    d = tm.DCGANDiscriminator(channels=(16, 32), in_channels=1, image_hw=(16, 16),
                              compute_dtype=dt)
    return GAN(g, d, latent_size=16, blurred=True)


def micro_trainer(tmp_path, subdir, config=("float32", False), **kw):
    cfg = TrainerConfig(log_dir=str(tmp_path / subdir), log_metrics_every_n_examples=16,
                        checkpoint_every_n_examples=kw.pop("ckpt_every", 1_000_000),
                        sample_grid_every_n_examples=kw.pop("grid_every", 1_000_000),
                        image_summaries_interval_batches=kw.pop("summaries", 0),
                        save_sample_pngs=True, seed=0)
    return Trainer(micro_gan(*config), BlurredWGANGPHyperParameters(batch_size=8,
                                                                    global_batch_size=8),
                   synthetic_dataset((16, 16, 1), num_examples=64), device="cpu",
                   trainer_config=cfg, blur_controller=BlurDecayController(640, max_value=1.0),
                   **kw)


@pytest.mark.parametrize("config", BF16_CONFIGS, ids=config_id)
def test_chunked_equals_fit(tmp_path, config):
    """On the CPU the runner runs fit's step function eagerly: the same
    draws, σ and arithmetic, so the same bits."""
    fit = micro_trainer(tmp_path, "fit", config)
    fit.fit(total_examples=10_000, max_steps=4)
    chunked = micro_trainer(tmp_path, "chunked", config)
    chunked.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    assert chunked.chunk_runner.fakes.dtype == (torch.bfloat16 if config[1] else torch.float32)
    for a, b in zip(fit.history, chunked.history):
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores",
                  "real_scores", "std"):
            assert a[k] == b[k], k
    for m_a, m_b in ((fit.state.generator, chunked.state.generator),
                     (fit.state.discriminator, chunked.state.discriminator)):
        for (name, t_a), t_b in zip(m_a.state_dict().items(), m_b.state_dict().values()):
            assert t_a.dtype == torch.float32 and torch.equal(t_a, t_b), name
    fit.close()
    chunked.close()


@pytest.mark.parametrize("first,second", [(("float32", False), ("bfloat16", True)),
                                          (("bfloat16", True), ("float32", False))],
                         ids=["float32->bf16", "bf16->float32"])
def test_checkpoint_resumes_across_dtypes(tmp_path, first, second):
    a = micro_trainer(tmp_path, "run", first, ckpt_every=16)
    a.fit(total_examples=10_000, max_steps=3)
    a.close()
    b = micro_trainer(tmp_path, "run", second)
    assert b.restored_examples == 24 and b.state.n_batches == 3
    for m_a, m_b in ((a.state.generator, b.state.generator),
                     (a.state.discriminator, b.state.discriminator)):
        for (name, t_a), t_b in zip(m_a.state_dict().items(), m_b.state_dict().values()):
            assert t_b.dtype == torch.float32 and torch.equal(t_a, t_b), name
    assert b.state.generator.compute_dtype == getattr(torch, second[0])
    b.fit(total_examples=10_000, max_steps=1)
    assert b.state.n_batches == 4 and np.isfinite(b.history[-1]["disc_loss"])
    b.close()


def test_grids_summaries_and_feeders_take_bf16_samples(tmp_path):
    """Sample grids, image summaries and the SWD, FID and Inception feeders
    take the ``fast_gen`` generator's bfloat16 images, each as the float32
    images of the same values."""
    tr = micro_trainer(tmp_path, "run", ("bfloat16", True), grid_every=16, summaries=1)
    samples = tr.sample_fn(tr.state, tr.grid_latents)
    assert samples.dtype == torch.bfloat16
    assert _nhwc_numpy(samples).dtype == np.float32
    tr.fit(total_examples=10_000, max_steps=2)
    assert [n for n in os.listdir(tr.cfg.log_dir) if n.startswith("samples_grid_")]
    tr.close()
    reals = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (8, 1, 16, 16))
                             .astype(np.float32))
    fakes = tr.sample_fn(tr.state, tr.grid_latents[:8])
    swd = []
    for f in (fakes, fakes.float()):
        m = SWDMetric()
        m.update_state(reals, f)
        swd.append(m.results())
    assert swd[0] == swd[1] and all(np.isfinite(v) for v in swd[0].values())
    fid = []
    for f in (fakes, fakes.float()):
        m = FIDMetric()
        m.update_state(reals, f)
        fid.append((m._fake.s, m._fake.ss))
    assert all(torch.equal(a, b) for a, b in zip(*fid))
    extract = inception_feature_fn(resize_to=80)
    assert torch.equal(extract(fakes[:2]), extract(fakes[:2].float()))


# ---------------------------------------------------------------------------
# (v) the entry point
# ---------------------------------------------------------------------------


def entry_args(tmp_path, *flags):
    return train_celeba.parse_args(
        ["--device", "cpu", "--resolution", "16", "--batch_size", "4", "--num_examples", "32",
         "--max_steps", "2", "--log_dir", str(tmp_path), "--sample_grid_every", "8",
         "--checkpoint_every", "1000000", *flags])


def network_dtypes(trainer):
    g, d = trainer.gan.generator, trainer.gan.discriminator
    return (g.compute_dtype, g.dense_bn.dtype, g.output_f32, d.compute_dtype)


def test_entry_point_trains_in_bf16(tmp_path, capsys):
    trainer = train_celeba.main(["--device", "cpu", "--resolution", "16", "--batch_size", "4",
                                 "--num_examples", "32", "--max_steps", "2", "--log_dir",
                                 str(tmp_path), "--sample_grid_every", "8",
                                 "--checkpoint_every", "1000000", "--bf16", "--fast_gen"])
    assert "compute=bfloat16+fast_gen" in capsys.readouterr().out
    assert network_dtypes(trainer) == (torch.bfloat16, torch.bfloat16, False, torch.bfloat16)
    assert trainer.state.n_batches == 2
    assert all(np.isfinite(h["disc_loss"]) and np.isfinite(h["gen_loss"])
               for h in trainer.history)
    assert all(p.dtype == torch.float32 for p in trainer.state.generator.parameters())


@pytest.mark.parametrize("flags,want", [
    ((), (torch.float32, torch.float32, True, torch.float32)),
    (("--fast_gen",), (torch.float32, torch.float32, True, torch.float32)),
    (("--bf16",), (torch.bfloat16, torch.float32, True, torch.bfloat16))],
    ids=["none", "fast_gen-alone", "bf16"])
def test_entry_point_flags_set_the_dtypes(tmp_path, flags, want):
    trainer, _ = train_celeba.build_trainer(entry_args(tmp_path, *flags), feeders=[])
    assert network_dtypes(trainer) == want
    trainer.close()


# ---------------------------------------------------------------------------
# (vii) the blur on a bfloat16 input
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_blur_keeps_bf16_through_both_backwards(impl):
    """float32 arithmetic, the input's dtype out, and bfloat16 gradients back
    through the backward and the penalty's double backward; each within a
    bfloat16 rounding of the float32 computation on the same values (relative
    L2 2^-8, half a unit: the output and the gradient are rounded once, the
    double backward's input gradient once more; measured 1.7e-3 to 1.8e-3)."""
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 3, 16, 16).astype(np.float32))
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        xi = x.to(torch.bfloat16).to(dtype).requires_grad_(True)
        y = blur_images(xi, SIGMA, impl=impl)
        (g,) = torch.autograd.grad(torch.sum(y.float() ** 2), xi, create_graph=True)
        norms = torch.sqrt(torch.sum(g.float().reshape(2, -1) ** 2, dim=1))
        (gg,) = torch.autograd.grad(torch.sum(norms), xi)
        results[dtype] = (y, g, gg)
    for got, want in zip(results[torch.bfloat16], results[torch.float32]):
        assert got.dtype == torch.bfloat16
        assert rel_l2(got.detach().float().numpy(), want.detach().numpy()) <= BF16_UNIT / 2
