"""The blur kernel's σ mode against the JAX package, on the CPU.

σ mode (``ops.blur_cuda.BlurSigma``) is the blur of the main path: on a card
the kernel builds the band's taps from σ itself (``csrc/blur_planes.cu``) and
no band matrix is built. Here its two CPU-reachable halves are held to the JAX
package:

- the taps: ``ops.blur.band_taps``, the plain mirror of the kernel's tap
  construction (the same float32 policy, ``2·half + 1`` taps normalised by
  their sum), against ``blur_matrix`` (each row of T is the taps, zero off the
  band) and ``masked_gaussian_taps``, at the main path's plane sizes and two
  non-square ones, across σ from the 3-tap floor to the clip;
- the autograd Function: on a CPU tensor it runs its plain version (the band
  matrices and two matmuls), whose forward, backward and the WGAN-GP
  penalty's double backward through a small critic are held against the JAX
  package's ``blur_images_pallas`` (its CPU lowering, and the Pallas kernel
  body in TPU interpret mode) and against the T path; a σ that requires grad
  takes the T path and gives JAX's σ-gradient.

The kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances: taps and T rtol 1e-6 / atol 1e-9 (float32 both sides; the taps'
sum is taken in another order); forward rtol 1e-5 / atol 1e-6 (float32, only
the summation order differs); gradients and grad-of-grad rtol 1e-4 /
atol 1e-5 (as tests/test_blur_pallas.py). σ mode and the T path on the CPU
compute the same products on the same matrices and are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from blurred_gan_tpu.ops import blur as jb
from blurred_gan_tpu.ops.blur_pallas import blur_images_pallas
from blurred_gan_tpu_torch.ops import blur as tb
from blurred_gan_tpu_torch.ops import blur_cuda
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TAPS = dict(rtol=1e-6, atol=1e-9)
FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)

# The 3-tap floor, a sub-pixel σ, the bench's and the run's σ, MNIST's
# adaptive σ₀ and the clip to the plane.
SIGMAS = [0.05, 0.3, 2.5, 5.0, 23.5, 100.0]
# (h, w): MNIST, the quality runs, CelebA-128, the bench's 256², non-square.
PLANES = [(28, 28), (64, 64), (128, 128), (256, 256), (16, 32), (36, 30)]


def images(shape, seed=0):
    """(NHWC numpy for JAX, NCHW torch for the port) of the same values."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def toeplitz(half, taps, dim):
    """T[i, j] = taps[half + j - i], zero off the band."""
    d = np.arange(dim)[None, :] - np.arange(dim)[:, None]
    return np.where(np.abs(d) <= half, taps[np.clip(d + half, 0, 2 * half)], 0.0)


class TestTaps:
    @pytest.mark.parametrize("sigma", SIGMAS)
    @pytest.mark.parametrize("h,w", PLANES)
    def test_band_matrices_are_the_taps(self, h, w, sigma):
        res = max(h, w)
        half, taps = tb.band_taps(sigma, res)
        assert half == int(jb.effective_blur_params(sigma, res)[1])
        assert taps.shape == (2 * half + 1,) and taps.dtype == torch.float32
        for dim in {h, w}:
            np.testing.assert_allclose(toeplitz(half, taps.numpy(), dim),
                                       np.asarray(jb.blur_matrix(sigma, dim, res)), **TAPS)

    @pytest.mark.parametrize("sigma", SIGMAS)
    @pytest.mark.parametrize("res", [28, 64, 128, 256, 32, 36])
    def test_taps_are_the_masked_taps(self, res, sigma):
        half, taps = tb.band_taps(sigma, res)
        want = np.asarray(jb.masked_gaussian_taps(sigma, res))
        mid = want.shape[0] // 2
        np.testing.assert_allclose(taps.numpy(), want[mid - half:mid + half + 1], **TAPS)
        assert not want[:mid - half].any() and not want[mid + half + 1:].any()

    def test_taps_symmetric_so_the_backward_is_the_forward(self):
        for sigma in SIGMAS:
            _, taps = tb.band_taps(sigma, 128)
            assert torch.equal(taps, taps.flip(0))
            t = tb.blur_matrix(sigma, 128)
            assert torch.equal(t, t.t())

    def test_device_tensor_sigma(self):
        half, taps = tb.band_taps(torch.tensor(2.5), 128)
        assert half == 8 and torch.equal(taps, tb.band_taps(2.5, 128)[1])


class TestForward:
    @pytest.mark.parametrize("sigma", [0.3, 2.5, 5.0, 23.5])
    @pytest.mark.parametrize("shape", [(2, 28, 28, 1), (2, 32, 32, 3), (1, 16, 32, 2),
                                       (1, 36, 30, 1)])
    def test_matches_jax(self, shape, sigma):
        x, xt = images(shape)
        want = np.asarray(blur_images_pallas(jnp.asarray(x), jnp.float32(sigma)))
        np.testing.assert_allclose(to_nhwc(tb.blur_images(xt, sigma)), want, **FWD)

    def test_kernel_body_interpret_mode(self):
        x, xt = images((2, 32, 32, 3), seed=1)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(blur_images_pallas(jnp.asarray(x), jnp.float32(2.5)))
        np.testing.assert_allclose(to_nhwc(tb.blur_images(xt, 2.5)), want, **FWD)

    @pytest.mark.parametrize("sigma", SIGMAS)
    def test_same_as_the_t_path(self, sigma):
        _, xt = images((2, 24, 20, 3), seed=2)
        t_h, t_w = tb.blur_matrix(sigma, 24, 24), tb.blur_matrix(sigma, 20, 24)
        assert torch.equal(tb.blur_images(xt, sigma),
                           blur_cuda.blur_images_fused(xt, t_h, t_w))

    def test_bf16_images_cast_around_the_blur(self):
        _, xt = images((2, 16, 16, 3), seed=3)
        xb = xt.to(torch.bfloat16)
        y = tb.blur_images(xb, 1.5)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, tb.blur_images(xb.float(), 1.5).to(torch.bfloat16))


def node_names(t):
    """The autograd node types that ``t``'s graph reaches."""
    names, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or type(fn).__name__ in names:
            continue
        names.add(type(fn).__name__)
        stack.extend(f for f, _ in fn.next_functions)
    return names


def critic_params(c, h, w, seed=7):
    rng = np.random.RandomState(seed)
    return ((rng.randn(c * h * w, 8) / np.sqrt(c * h * w)).astype(np.float32),
            rng.randn(8).astype(np.float32))


def jax_penalty(x, sigma, w1, w2):
    """WGAN-GP's penalty on a blurred tanh critic, NHWC."""
    def critic(im):
        y = blur_images_pallas(im, sigma)
        y = jnp.transpose(y, (0, 3, 1, 2)).reshape(im.shape[0], -1)
        return jnp.tanh(y @ w1) @ w2

    g = jax.grad(lambda im: jnp.sum(critic(im)))(x)
    norms = jnp.sqrt(jnp.sum(g.reshape(x.shape[0], -1) ** 2, axis=1))
    return jnp.mean((norms - 1.0) ** 2)


def torch_penalty(x, sigma, w1, w2, blur):
    def critic(im):
        return torch.tanh(blur(im, sigma).reshape(im.shape[0], -1) @ w1) @ w2

    (g,) = torch.autograd.grad(torch.sum(critic(x)), x, create_graph=True)
    norms = torch.sqrt(torch.sum(g.reshape(x.shape[0], -1) ** 2, dim=1))
    return torch.mean((norms - 1.0) ** 2)


def t_path(images, sigma):
    n, c, h, w = images.shape
    res = max(h, w)
    return blur_cuda.blur_images_fused(images, tb.blur_matrix(sigma, h, res),
                                       tb.blur_matrix(sigma, w, res))


class TestAutodiff:
    @pytest.mark.parametrize("sigma", [0.3, 2.5, 5.0])
    def test_backward_matches_jax_and_the_t_path(self, sigma):
        x, xt = images((2, 28, 28, 3), seed=4)
        want = jax.grad(lambda im: jnp.sum(blur_images_pallas(im, sigma) ** 2))(jnp.asarray(x))
        xt.requires_grad_(True)
        y = tb.blur_images(xt, sigma)
        (got,) = torch.autograd.grad(torch.sum(y ** 2), xt)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GRAD)
        (via_t,) = torch.autograd.grad(torch.sum(t_path(xt, sigma) ** 2), xt)
        assert torch.equal(got, via_t)

    @pytest.mark.parametrize("sigma", [0.3, 2.5, 5.0])
    @pytest.mark.parametrize("shape", [(2, 16, 16, 3), (3, 16, 24, 1)])
    def test_penalty_double_backward_matches_jax(self, shape, sigma):
        x, xt = images(shape, seed=5)
        n, h, w, c = shape
        w1, w2 = critic_params(c, h, w)
        want_x, want_w1 = jax.grad(jax_penalty, argnums=(0, 2))(
            jnp.asarray(x), jnp.float32(sigma), jnp.asarray(w1), jnp.asarray(w2))
        xt.requires_grad_(True)
        tw1 = torch.from_numpy(w1).requires_grad_(True)
        tw2 = torch.from_numpy(w2)
        pen = torch_penalty(xt, sigma, tw1, tw2, tb.blur_images)
        got_x, got_w1 = torch.autograd.grad(pen, (xt, tw1))
        np.testing.assert_allclose(to_nhwc(got_x), np.asarray(want_x), **GRAD)
        np.testing.assert_allclose(got_w1.numpy(), np.asarray(want_w1), **GRAD)
        # The T path's double backward computes the same products.
        pen_t = torch_penalty(xt, sigma, tw1, tw2, t_path)
        for a, b in zip(torch.autograd.grad(pen_t, (xt, tw1)), (got_x, got_w1)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

    def test_double_backward_reenters_the_function(self):
        _, xt = images((2, 16, 16, 1), seed=6)
        xt.requires_grad_(True)
        y = tb.blur_images(xt, 2.0)
        (g,) = torch.autograd.grad(torch.sum(y ** 2), xt, create_graph=True)
        names = node_names(g)
        assert "BlurSigmaBackward" in names and "BlurPlanesBackward" not in names

    def test_gradgradcheck_float64(self):
        gen = torch.Generator().manual_seed(0)
        x = torch.randn(2, 5, 7, generator=gen, dtype=torch.float64, requires_grad=True)
        sigma = torch.tensor(1.2)
        fn = lambda p: blur_cuda.BlurSigma.apply(p, sigma, 7)  # noqa: E731
        assert torch.autograd.gradcheck(fn, (x,))
        assert torch.autograd.gradgradcheck(fn, (x,))

    @pytest.mark.parametrize("sigma", [0.8, 2.5, 5.0])
    def test_sigma_gradient_matches_jax_through_the_t_path(self, sigma):
        x, xt = images((2, 16, 16, 3), seed=8)
        wgt = np.random.RandomState(9).randn(*x.shape).astype(np.float32)
        want = jax.grad(lambda s: jnp.sum(blur_images_pallas(jnp.asarray(x), s) * wgt))(
            jnp.float32(sigma))
        s = torch.tensor(sigma, requires_grad=True)
        y = tb.blur_images(xt, s)
        before = tb.matrix_count
        (got,) = torch.autograd.grad(torch.sum(y * torch.from_numpy(wgt.transpose(0, 3, 1, 2))),
                                     s)
        assert tb.matrix_count == before  # the backward builds nothing more
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
        names = node_names(y)
        assert "BlurPlanesBackward" in names and "BlurSigmaBackward" not in names


class TestDispatch:
    def test_cpu_sigma_mode_launches_nothing(self):
        before = (blur_cuda.launch_count, blur_cuda.sigma_launch_count)
        x = torch.randn(4, 8, 8)
        sigma = torch.tensor(1.0)
        torch.testing.assert_close(blur_cuda.blur_sigma(x, sigma, 8),
                                   blur_cuda.blur_sigma_reference(x, sigma, 8))
        assert (blur_cuda.launch_count, blur_cuda.sigma_launch_count) == before

    def test_sigma_mode_unless_sigma_requires_grad(self):
        xt = torch.randn(1, 2, 8, 8)
        assert tb.blur_images(xt, torch.tensor(1.0)).grad_fn is None
        via_t = node_names(tb.blur_images(xt, torch.tensor(1.0, requires_grad=True)))
        assert "BlurPlanesBackward" in via_t and "BlurSigmaBackward" not in via_t
        xt.requires_grad_(True)
        names = node_names(tb.blur_images(xt, 1.0))
        assert "BlurSigmaBackward" in names and "BlurPlanesBackward" not in names

    def test_matrix_count_counts_every_band_matrix(self):
        before = tb.matrix_count
        tb.blur_matrix(1.0, 8)
        tb.blur_images(torch.zeros(1, 1, 8, 6), 1.0, impl="torch")
        assert tb.matrix_count == before + 3

    def test_bad_planes_raise(self):
        with pytest.raises(ValueError):
            blur_cuda.blur_sigma_forward(torch.zeros(8, 8), torch.tensor(1.0), 8)
