"""``tests/torch_tpu_precision.py``: the port's convolutions and dense
products as a TPU computes float32 at XLA's DEFAULT precision.

At small shapes each wrapped product, its two gradients and one
second-order gradient equal a float64 product of the bfloat16-rounded
operands (the cotangents rounded too), within float32 accumulation error:
rtol 1e-5 / atol 1e-5 on unit-scale operands summed over at most 200 terms.
The same products without the rounding differ from it by far more (bfloat16
keeps 8 significant bits), and leaving the context restores the exact
float32 products of ``models/dcgan.py``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_tpu_precision as tp
from blurred_gan_tpu_torch.models import dcgan

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rand(seed, *shape):
    return torch.from_numpy(np.random.RandomState(seed).standard_normal(shape).astype(np.float32))


def r64(t):
    """``t`` rounded to bfloat16, in float64."""
    return t.to(torch.bfloat16).to(torch.float64)


# (name, wrapped product, float64 reference, x shape, w shape)
def _conv_t_ref(x, w):
    return F.conv_transpose2d(x, w, stride=2, padding=2)


PRODUCTS = [
    ("conv_s1", lambda x, w: tp.conv2d(x, w, stride=1, padding=2),
     lambda x, w: F.conv2d(x, w, stride=1, padding=2), (2, 3, 6, 6), (4, 3, 5, 5)),
    ("conv_s2", lambda x, w: tp.conv2d(x, w, stride=2),
     lambda x, w: F.conv2d(x, w, stride=2), (2, 3, 9, 9), (4, 3, 5, 5)),
    ("conv_transpose_s2", lambda x, w: tp.conv_transpose2d(x, w, stride=2, padding=2),
     _conv_t_ref, (2, 4, 4, 4), (4, 3, 5, 5)),
    ("linear", lambda x, w: tp.linear(x, w), lambda x, w: F.linear(x, w), (3, 7), (5, 7)),
]


@pytest.mark.parametrize("name,wrapped,ref,xs,ws", PRODUCTS, ids=[p[0] for p in PRODUCTS])
def test_product_and_its_gradients_round_every_operand(name, wrapped, ref, xs, ws):
    x, w = rand(1, *xs).requires_grad_(), rand(2, *ws).requires_grad_()
    y = wrapped(x, w)
    x64, w64 = r64(x.detach()).requires_grad_(), r64(w.detach()).requires_grad_()
    y64 = ref(x64, w64)
    np.testing.assert_allclose(y.detach().numpy(), y64.detach().numpy(), **TOL)
    # Without the rounding the product is elsewhere: the test can tell.
    exact = ref(x.detach().double(), w.detach().double())
    assert np.abs(exact.numpy() - y64.detach().numpy()).max() > 100 * TOL["atol"]

    # Both first derivatives, the cotangent rounded: create_graph for the
    # second order below.
    g = rand(3, *y.shape)
    gx, gw = torch.autograd.grad(y, (x, w), g, create_graph=True)
    gx64, gw64 = torch.autograd.grad(y64, (x64, w64), r64(g), create_graph=True)
    np.testing.assert_allclose(gx.detach().numpy(), gx64.detach().numpy(), **TOL)
    np.testing.assert_allclose(gw.detach().numpy(), gw64.detach().numpy(), **TOL)

    # One second-order derivative, as the penalty's: d<gx, v>/dw, v rounded.
    v = rand(4, *xs)
    (gww,) = torch.autograd.grad((gx * v).sum(), w)
    (gww64,) = torch.autograd.grad((gx64 * r64(v)).sum(), w64)
    np.testing.assert_allclose(gww.numpy(), gww64.numpy(), **TOL)


def test_bias_is_added_after_the_product():
    x, w, b = rand(1, 2, 3, 6, 6), rand(2, 4, 3, 5, 5), rand(3, 4)
    got = tp.conv2d(x, w, b, padding=2)
    want = F.conv2d(r64(x), r64(w), b.double(), padding=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    x, w, b = rand(4, 3, 7), rand(5, 5, 7), rand(6, 5)
    np.testing.assert_allclose(tp.linear(x, w, b).numpy(),
                               F.linear(r64(x), r64(w), b.double()).numpy(), **TOL)


def narrow_gan():
    gen = dcgan.DCGANGenerator(latent_size=4, init_hw=(2, 2), init_features=8,
                               blocks=((8, 1), (4, 2)), out_channels=3)
    critic = dcgan.DCGANDiscriminator(channels=(4, 8), dropout_rate=0.0, image_hw=(4, 4))
    dcgan.init_weights(gen, torch.Generator().manual_seed(0))
    dcgan.init_weights(critic, torch.Generator().manual_seed(1))
    return gen.eval(), critic.eval()


def test_the_networks_products_go_through_it_and_leaving_restores_float32():
    gen, critic = narrow_gan()
    z = rand(5, 3, 4)
    exact = critic(gen(z)).detach()
    with tp.tpu_default_precision() as count:
        count["products"] = 0
        assert not torch.backends.cudnn.allow_tf32
        rounded = critic(gen(z)).detach()
        # Dense + 2 transposed convolutions + the last convolution; 2
        # convolutions + the Dense in the critic.
        assert count["products"] == 7
    assert dcgan.F is F and torch.nn.Linear.forward is not tp._dense_forward
    assert not torch.equal(rounded, exact)
    np.testing.assert_allclose(rounded.numpy(), exact.numpy(), rtol=5e-2, atol=5e-3)
    torch.testing.assert_close(critic(gen(z)).detach(), exact, rtol=0, atol=0)


def test_the_critics_penalty_double_backward_rounds():
    """The penalty's gradient of a gradient through a rounded critic: the
    second-order weight gradient differs from float32's and is finite."""
    _, critic = narrow_gan()
    x = rand(6, 2, 3, 4, 4).requires_grad_()

    def penalty_grad():
        (gx,) = torch.autograd.grad(critic(x).sum(), x, create_graph=True)
        return torch.autograd.grad((gx ** 2).sum(), critic.convs[0].weight)[0]

    exact = penalty_grad()
    with tp.tpu_default_precision() as count:
        before = count["products"]
        rounded = penalty_grad()
        assert count["products"] - before > 3 * 3  # forward, backward and its backward
    assert torch.isfinite(rounded).all() and not torch.equal(rounded, exact)
    np.testing.assert_allclose(rounded.numpy(), exact.numpy(), rtol=0.1, atol=0.1 * float(
        exact.abs().max()))


def test_generator_f32_sums_is_the_jax_default_compile():
    """``--mode generator_f32_sums``: the ``--bf16`` generator with its
    products' float32 sums kept equals the JAX package's bfloat16 generator
    compiled by default (XLA's excess precision on), as the port without it
    equals the compile without excess precision; in train mode the two
    compiles are more than a bfloat16 unit apart (max |diff| measured
    1.9e-2; each match 1.8e-7)."""
    import jax
    import jax.numpy as jnp

    from test_torch_bf16 import generator_pair, latents, nhwc

    jg, tg, variables = generator_pair("bfloat16", False, "transpose")
    z = latents()

    def apply(v, z):
        return jg.apply(v, z, train=True, mutable=["batch_stats"])[0]

    lowered = jax.jit(apply).lower(variables, jnp.asarray(z))
    default = np.asarray(lowered.compile()(variables, jnp.asarray(z)), np.float32)
    exact = np.asarray(lowered.compile(compiler_options={"xla_allow_excess_precision": False})(
        variables, jnp.asarray(z)), np.float32)
    tg.train(True)
    with torch.no_grad():
        plain = nhwc(tg(torch.from_numpy(z)).float())
        with tp.generator_f32_sums() as count:
            before = count["products"]
            sums = nhwc(tg(torch.from_numpy(z)).float())
            assert count["products"] - before == 5  # the Dense and 4 convolutions
    assert np.abs(default - exact).max() > 2.0 ** -7
    np.testing.assert_allclose(sums, default, rtol=0, atol=1e-6)
    np.testing.assert_allclose(plain, exact, rtol=0, atol=1e-6)
