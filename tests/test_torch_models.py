"""Parity of the port's DCGAN modules with the JAX package's flax modules.

Flax weights (with BatchNorm scales, offsets and running statistics perturbed
away from their initial values, so that every mapping is exercised) are
carried into the port by ``blurred_gan_tpu_torch.convert.flax_to_torch``; the
same numpy latents and images go through both. Images are NHWC on the JAX
side and NCHW in the port.

Tolerances: rtol 1e-5 / atol 1e-5 at narrow widths (float32 both sides; the
convolutions sum a few hundred terms in another order). At the full
CelebA-128 widths (the 512-channel 5x5 convolutions sum ~13k terms per output)
rtol 1e-4 / atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.models import dcgan as jm
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.models import dcgan as tm
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NARROW = dict(rtol=1e-5, atol=1e-5)
FULL = dict(rtol=1e-4, atol=1e-4)


def flax_state(module, x, seed=0):
    """numpy (params, batch_stats) with BN entries perturbed."""
    variables = module.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables.get("batch_stats", {}))
    for name in params:
        if name.startswith("BatchNorm"):
            n = params[name]["scale"].shape
            params[name]["scale"] = (1 + 0.2 * rng.randn(*n)).astype(np.float32)
            params[name]["bias"] = (0.1 * rng.randn(*n)).astype(np.float32)
            stats[name]["mean"] = (0.1 * rng.randn(*n)).astype(np.float32)
            stats[name]["var"] = (1 + 0.5 * rng.rand(*n)).astype(np.float32)
    return params, stats


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def narrow_pair(upsample):
    kw = dict(latent_size=8, init_hw=(4, 4), init_features=32,
              blocks=((32, 1), (16, 2), (8, 2)), out_channels=3)
    return (jm.DCGANGenerator(**kw, upsample=upsample),
            tm.DCGANGenerator(**kw, upsample=upsample))


@pytest.mark.parametrize("upsample", ["transpose", "resize"])
@pytest.mark.parametrize("train", [False, True])
def test_generator_narrow(upsample, train):
    jg, tg = narrow_pair(upsample)
    z = np.random.RandomState(1).rand(4, 8).astype(np.float32)
    params, stats = flax_state(jg, z)
    flax_to_torch(tg, params, stats)
    tg.train(train)
    got = tg(torch.from_numpy(z))
    if train:
        want, new = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z),
                             train=True, mutable=["batch_stats"])
        # Running statistics move with the biased batch variance, momentum 0.99.
        bns = [tg.dense_bn, *tg.bns]
        for i, bn in enumerate(bns):
            s = new["batch_stats"][f"BatchNorm_{i}"]
            np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(s["mean"]), **NARROW)
            np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(s["var"]), **NARROW)
    else:
        want = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z), train=False)
    assert got.shape == (4, 3, 16, 16)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), **NARROW)


@pytest.mark.parametrize("channels,res", [((8, 16), 16), ((4, 8, 16), 32), ((8,), 28)])
def test_discriminator_narrow(channels, res):
    jd = jm.DCGANDiscriminator(channels=channels)
    td = tm.DCGANDiscriminator(channels=channels, in_channels=3, image_hw=(res, res))
    x = np.random.RandomState(2).randn(3, res, res, 3).astype(np.float32)
    params, _ = flax_state(jd, x)
    flax_to_torch(td, params)
    td.eval()
    want = jd.apply({"params": params}, jnp.asarray(x), train=False)
    np.testing.assert_allclose(td(nchw(x)).detach().numpy(), np.asarray(want), **NARROW)


@pytest.mark.parametrize("upsample", ["transpose", "resize"])
def test_mnist_pair(upsample):
    jg, tg = jm.mnist_generator(upsample=upsample), tm.mnist_generator(upsample=upsample)
    z = np.random.RandomState(3).rand(2, 100).astype(np.float32)
    params, stats = flax_state(jg, z)
    flax_to_torch(tg, params, stats).eval()
    fakes = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z), train=False)
    got = tg(torch.from_numpy(z))
    assert got.shape == (2, 1, 28, 28)
    np.testing.assert_allclose(nhwc(got), np.asarray(fakes), **NARROW)
    jd, td = jm.mnist_discriminator(), tm.mnist_discriminator()
    dparams, _ = flax_state(jd, np.asarray(fakes))
    flax_to_torch(td, dparams).eval()
    want = jd.apply({"params": dparams}, fakes, train=False)
    np.testing.assert_allclose(td(got).detach().numpy(), np.asarray(want), **NARROW)


def test_celeba128_full_width_forward():
    jg, tg = jm.celeba_generator(128), tm.celeba_generator(128)
    z = np.random.RandomState(4).rand(2, 100).astype(np.float32)
    params, stats = flax_state(jg, z)
    flax_to_torch(tg, params, stats).eval()
    fakes = jg.apply({"params": params, "batch_stats": stats}, jnp.asarray(z), train=False)
    with torch.no_grad():
        got = tg(torch.from_numpy(z))
    assert got.shape == (2, 3, 128, 128)
    np.testing.assert_allclose(nhwc(got), np.asarray(fakes), **FULL)
    jd, td = jm.celeba_discriminator(128), tm.celeba_discriminator(128)
    dparams, _ = flax_state(jd, np.asarray(fakes))
    flax_to_torch(td, dparams).eval()
    want = jd.apply({"params": dparams}, fakes, train=False)
    with torch.no_grad():
        np.testing.assert_allclose(td(got).numpy(), np.asarray(want), **FULL)


def test_named_configs_match_flax_shapes():
    # Every flax parameter has a port counterpart of the same size.
    for res in (8, 32, 64, 256):
        for jmod, tmod in ((jm.celeba_generator(res), tm.celeba_generator(res)),
                           (jm.celeba_discriminator(res), tm.celeba_discriminator(res))):
            x = (np.zeros((1, 100), np.float32) if isinstance(jmod, jm.DCGANGenerator)
                 else np.zeros((1, res, res, 3), np.float32))
            shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), x))
            n_flax = sum(int(np.prod(l.shape)) for l in
                         jax.tree_util.tree_leaves(shapes["params"]))
            assert n_flax == sum(p.numel() for p in tmod.parameters()), res


def test_dropout_draws_from_the_given_generator():
    td = tm.DCGANDiscriminator(channels=(8,), in_channels=1, image_hw=(16, 16)).train()
    x = torch.randn(4, 1, 16, 16)
    a = td(x, generator=torch.Generator().manual_seed(7))
    b = td(x, generator=torch.Generator().manual_seed(7))
    c = td(x, generator=torch.Generator().manual_seed(8))
    torch.testing.assert_close(a, b)
    assert not torch.allclose(a, c)
    td.eval()
    torch.testing.assert_close(td(x), td(x))


def test_seeded_init_is_glorot_and_deterministic():
    g1 = tm.celeba_generator(16, generator=torch.Generator().manual_seed(0))
    g2 = tm.celeba_generator(16, generator=torch.Generator().manual_seed(0))
    for p1, p2 in zip(g1.parameters(), g2.parameters()):
        torch.testing.assert_close(p1, p2)
    w = g1.ups[0].conv.weight.detach()  # (in 512, out 512, 5, 5)
    bound = np.sqrt(6.0 / (2 * 512 * 25))
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound


def test_converter_rejects_mismatched_shapes():
    jd = jm.DCGANDiscriminator(channels=(8,))
    params, _ = flax_state(jd, np.zeros((1, 16, 16, 3), np.float32))
    td = tm.DCGANDiscriminator(channels=(4,), in_channels=3, image_hw=(16, 16))
    with pytest.raises(ValueError):
        flax_to_torch(td, params)
