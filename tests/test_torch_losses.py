"""Parity of the port's WGAN-GP losses with ``blurred_gan_tpu.losses.wgan``.

The critic is a narrow DCGAN critic behind the blur, with flax weights carried
into the port, and α is pinned to the same numpy draw on both sides.

Tolerances: loss values rtol 1e-5 / atol 1e-6 (float32 forward); the penalty's
gradient with respect to the critic's weights, a grad-of-grad through the blur
and the convolutions, rtol 1e-4 / atol 1e-5 (as tests/test_blur_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.losses import wgan as jl
from blurred_gan_tpu.models import dcgan as jm
from blurred_gan_tpu.ops.blur import blur_images as jax_blur
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.losses import wgan as tl
from blurred_gan_tpu_torch.models import dcgan as tm
from blurred_gan_tpu_torch.ops.blur import blur_images as torch_blur
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

VALUE = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)
SIGMA = 1.5


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(0)
    reals = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    fakes = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    alpha = rng.rand(4, 1, 1, 1).astype(np.float32)
    jd = jm.DCGANDiscriminator(channels=(8, 16), dropout_rate=0.0)
    params = jax.tree_util.tree_map(
        np.asarray, jd.init(jax.random.PRNGKey(1), jnp.asarray(reals))["params"])
    td = tm.DCGANDiscriminator(channels=(8, 16), dropout_rate=0.0, in_channels=3,
                               image_hw=(16, 16))
    flax_to_torch(td, params).eval()

    def jcritic(p):
        return lambda x: jd.apply({"params": p}, jax_blur(x, SIGMA), train=False)

    def tcritic(x):
        return td(torch_blur(x, SIGMA))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))

    return dict(reals=reals, fakes=fakes, alpha=alpha, params=params, jcritic=jcritic,
                td=td, tcritic=tcritic, treals=t(reals), tfakes=t(fakes),
                talpha=torch.from_numpy(alpha.reshape(4, 1, 1, 1)))


def test_gp_on_linear_critic_is_exact():
    # For D(x) = <w, x>, ||grad D|| = ||w|| everywhere: GP = (||w|| - 1)^2.
    rng = np.random.RandomState(0)
    w = torch.from_numpy(rng.randn(16).astype(np.float32))
    reals = torch.from_numpy(rng.randn(8, 4, 2, 2).astype(np.float32))
    fakes = torch.from_numpy(rng.randn(8, 4, 2, 2).astype(np.float32))
    gp = tl.gradient_penalty(lambda x: x.reshape(x.shape[0], -1) @ w, reals, fakes,
                             torch.Generator().manual_seed(1))
    assert float(gp) == pytest.approx((float(torch.linalg.norm(w)) - 1.0) ** 2, rel=1e-4)


def test_plain_losses():
    r = np.array([0.5, -1.0, 2.0], np.float32)
    f = np.array([0.25, 1.5, -0.5], np.float32)
    assert float(tl.wgan_discriminator_loss(torch.from_numpy(r), torch.from_numpy(f), 4.0)) \
        == pytest.approx(float(jl.wgan_discriminator_loss(r, f, 4.0)), rel=1e-6)
    assert float(tl.wgan_generator_loss(torch.from_numpy(f), 4.0)) \
        == pytest.approx(float(jl.wgan_generator_loss(f, 4.0)), rel=1e-6)


def test_gradient_penalty_value_and_weight_grads(setup):
    s = setup
    jgp, jgrads = jax.value_and_grad(
        lambda p: jl.gradient_penalty(s["jcritic"](p), jnp.asarray(s["reals"]),
                                      jnp.asarray(s["fakes"]), None, alpha=s["alpha"]))(
        s["params"])
    tgp = tl.gradient_penalty(s["tcritic"], s["treals"], s["tfakes"], alpha=s["talpha"])
    np.testing.assert_allclose(float(tgp.detach()), float(jgp), **VALUE)
    td = s["td"]
    tgrads = torch.autograd.grad(tgp, [td.convs[0].weight, td.convs[1].bias, td.dense.weight])
    want = [np.asarray(jgrads["Conv_0"]["kernel"]).transpose(3, 2, 0, 1),
            np.asarray(jgrads["Conv_1"]["bias"]),
            np.asarray(jgrads["Dense_0"]["kernel"]).T]
    for g, w in zip(tgrads, want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD)


def test_gp_interpolates_before_the_blur(setup):
    # x̂ is formed from the pre-blur images: α=1 puts it exactly on the fakes.
    s = setup
    ones = torch.ones(4, 1, 1, 1)
    seen = []

    def critic(x):
        seen.append(x.detach().clone())
        return s["tcritic"](x)

    tl.gradient_penalty(critic, s["treals"], s["tfakes"], alpha=ones)
    torch.testing.assert_close(seen[0], s["tfakes"])


@pytest.mark.parametrize("reference_grad_scale", [False, True])
def test_wgangp_discriminator_loss(setup, reference_grad_scale):
    s = setup
    jr = np.asarray(s["jcritic"](s["params"])(jnp.asarray(s["reals"])))
    jf = np.asarray(s["jcritic"](s["params"])(jnp.asarray(s["fakes"])))
    jloss, jaux = jl.wgangp_discriminator_loss(
        s["jcritic"](s["params"]), jnp.asarray(s["reals"]), jnp.asarray(s["fakes"]),
        jnp.asarray(jr), jnp.asarray(jf), None, global_batch_size=4.0,
        alpha=s["alpha"], reference_grad_scale=reference_grad_scale)
    with torch.no_grad():
        tr, tf = s["tcritic"](s["treals"]), s["tcritic"](s["tfakes"])
    np.testing.assert_allclose(tr.numpy(), jr, **VALUE)
    tloss, taux = tl.wgangp_discriminator_loss(
        s["tcritic"], s["treals"], s["tfakes"], tr, tf, global_batch_size=4.0,
        alpha=s["talpha"], reference_grad_scale=reference_grad_scale)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), **VALUE)
    for k in ("wgan_loss", "gp_term", "norm_term"):
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]), **VALUE)


def test_alpha_drawn_from_generator():
    reals, fakes = torch.zeros(3, 1, 2, 2), torch.ones(3, 1, 2, 2)
    seen = []

    def critic(x):
        seen.append(x.detach()[:, 0, 0, 0].clone())
        return x.reshape(3, -1).sum(1)

    for seed in (5, 5, 6):
        tl.gradient_penalty(critic, reals, fakes, torch.Generator().manual_seed(seed))
    torch.testing.assert_close(seen[0], seen[1])
    assert not torch.equal(seen[0], seen[2])
    assert bool(((seen[0] >= 0) & (seen[0] < 1)).all())
