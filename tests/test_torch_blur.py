"""Parity of the port's blur (blurred_gan_tpu_torch/ops) with the JAX package.

The same numpy inputs go through ``blurred_gan_tpu.ops`` and the port. The
port keeps images NCHW, so inputs are transposed at the boundary. On the CPU
the port's ``BlurPlanes`` runs its plain version; the JAX side runs the
``blur_planes`` primitive as its own tests do (its CPU lowering, and the Pallas
kernel body in TPU interpret mode). The CUDA kernel itself is held against the
plain version on a card by tests/test_torch_cuda.py.

Tolerances: forward rtol 1e-5 / atol 1e-6 (float32 on both sides, only the
summation order differs); gradients and grad-of-grad rtol 1e-4 / atol 1e-5
(as tests/test_blur_pallas.py). The sizing policy is compared exactly: both
sides compute ``floor(6σ)`` in float32.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from blurred_gan_tpu.models import GaussianBlur as JaxGaussianBlur
from blurred_gan_tpu.ops import blur as jb
from blurred_gan_tpu.ops.blur_pallas import _pallas_impl, blur_images_pallas
from blurred_gan_tpu_torch.models.layers import GaussianBlur
from blurred_gan_tpu_torch.ops import blur as tb
from blurred_gan_tpu_torch.ops import blur_cuda
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)

SIGMAS = [0.01, 0.2, 0.33, 0.34, 0.5, 1.0, 2.5, 5.0, 23.5, 100.0]


def images(shape, seed=0):
    """(NHWC numpy for JAX, NCHW torch for the port) of the same values."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def to_nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


class TestPolicy:
    @pytest.mark.parametrize("res", [16, 28, 128])
    def test_effective_params_exact(self, res):
        for s in SIGMAS:
            js, jh = jb.effective_blur_params(s, res)
            ts, th = tb.effective_blur_params(s, res)
            assert float(ts) == float(js) and float(th) == float(jh), (s, res)

    def test_clip_regime_at_16(self):
        # σ=100 at 16²: the kernel is clipped to the resolution (16 -> 17 taps).
        sigma, half = tb.effective_blur_params(100.0, 16)
        assert float(half) == 8.0
        assert float(sigma) == pytest.approx(15.0 / 6.0)

    def test_three_tap_floor(self):
        for s in (0.01, 0.2, 0.33):
            sigma, half = tb.effective_blur_params(s, 28)
            assert float(half) == 1.0 and float(sigma) == pytest.approx(2.0 / 6.0)
        assert float(tb.effective_blur_params(0.34, 28)[1]) == 1.0
        assert float(tb.effective_blur_params(0.5, 28)[1]) == 2.0

    @pytest.mark.parametrize("res", [16, 28, 64])
    def test_taps_and_matrix_match(self, res):
        for s in SIGMAS:
            np.testing.assert_allclose(
                tb.masked_gaussian_taps(s, res).numpy(),
                np.asarray(jb.masked_gaussian_taps(s, res)), **FWD)
            np.testing.assert_allclose(
                tb.blur_matrix(s, res).numpy(), np.asarray(jb.blur_matrix(s, res)), **FWD)
        np.testing.assert_allclose(
            tb.blur_matrix(1.5, 16, 32).numpy(), np.asarray(jb.blur_matrix(1.5, 16, 32)),
            **FWD)

    def test_border_rows_not_renormalised(self):
        t = tb.blur_matrix(2.0, 32).numpy()
        assert t[0].sum() < 0.99 and t[16].sum() == pytest.approx(1.0, abs=1e-6)

    def test_gaussian_kernel_1d(self):
        np.testing.assert_allclose(tb.gaussian_kernel_1d(2.0, 13).numpy(),
                                   np.asarray(jb.gaussian_kernel_1d(2.0, 13)), **FWD)


class TestForward:
    @pytest.mark.parametrize("shape", [(2, 32, 32, 3), (2, 28, 28, 1), (1, 16, 32, 1),
                                       (1, 24, 32, 3)])
    @pytest.mark.parametrize("impl", ["auto", "torch"])
    def test_matches_jax(self, shape, impl):
        x, xt = images(shape)
        for s in (0.2, 1.3, 5.0):
            want = np.asarray(jb.blur_images(jnp.asarray(x), jnp.float32(s), impl="pallas"))
            got = tb.blur_images(xt, s, impl=impl)
            np.testing.assert_allclose(to_nhwc(got), want, **FWD)

    def test_sigma_sweep_one_set_of_tensors(self):
        # One image tensor and one σ tensor serve every σ: σ is read on the
        # device, no shape depends on it, so nothing is rebuilt as it moves.
        x, xt = images((1, 16, 16, 2), seed=4)
        sigma = torch.zeros(())
        shapes = set()
        for s in SIGMAS:
            sigma.fill_(s)
            shapes.add(tuple(tb.blur_matrix(sigma, 16).shape))
            want = np.asarray(jb.blur_images(jnp.asarray(x), jnp.float32(s), impl="einsum"))
            np.testing.assert_allclose(to_nhwc(tb.blur_images(xt, sigma)), want, **FWD)
        assert shapes == {(16, 16)}

    def test_kernel_body_interpret_mode(self):
        x, xt = images((2, 32, 32, 3))
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(blur_images_pallas(jnp.asarray(x), jnp.float32(1.3)))
        np.testing.assert_allclose(to_nhwc(tb.blur_images(xt, 1.3)), want, **FWD)

    def test_pallas_impl_interpret_mode_nonsymmetric(self):
        # The kernel takes arbitrary T_h, T_w (the transpose passes Tᵀ).
        rng = np.random.RandomState(5)
        planes = rng.randn(3, 16, 24).astype(np.float32)
        t_h = rng.randn(16, 16).astype(np.float32)
        t_w = rng.randn(24, 24).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(_pallas_impl(jnp.asarray(planes), jnp.asarray(t_h),
                                           jnp.asarray(t_w)))
        got = blur_cuda.blur_planes(*map(torch.from_numpy, (planes, t_h, t_w)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("scale", [0.05, 0.8, 2.0, 6.0])
    def test_depthwise_oracle(self, scale):
        x, xt = images((2, 28, 28, 3))
        k = int(np.clip(np.floor(6.0 * np.float32(scale)) + 1, 3, 28))
        std = max((k - 1) / 6.0, 0.01)
        want = np.asarray(jb.gaussian_blur_depthwise(jnp.asarray(x), std, k))
        np.testing.assert_allclose(to_nhwc(tb.gaussian_blur_depthwise(xt, std, k)),
                                   want, **FWD)
        np.testing.assert_allclose(to_nhwc(tb.blur_images(xt, scale)), want,
                                   rtol=1e-4, atol=1e-5)

    def test_gaussian_blur_layer(self):
        x, xt = images((1, 16, 16, 3))
        layer = JaxGaussianBlur(initial_std=2.0)
        variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
        for sigma in (None, 0.7):
            want = np.asarray(layer.apply(variables, jnp.asarray(x), sigma))
            got = GaussianBlur(initial_std=2.0)(xt, sigma)
            np.testing.assert_allclose(to_nhwc(got), want, **FWD)

    def test_bad_impl_raises(self):
        with pytest.raises(ValueError):
            tb.blur_images(torch.zeros(1, 1, 8, 8), 1.0, impl="pallas")


class TestAutodiff:
    def test_first_order_grad_matches_jax(self):
        x, xt = images((2, 32, 32, 3))
        want = jax.grad(lambda im: jnp.sum(jb.blur_images(im, 2.0, impl="pallas") ** 2))(
            jnp.asarray(x))
        xt.requires_grad_(True)
        (got,) = torch.autograd.grad(torch.sum(tb.blur_images(xt, 2.0) ** 2), xt)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GRAD)

    def test_grad_of_grad_matches_jax(self):
        # The WGAN-GP pattern: differentiate a gradient-norm penalty.
        x, xt = images((2, 32, 32, 3))

        def jgp(im):
            g = jax.grad(lambda y: jnp.sum(jb.blur_images(y, 2.0, impl="pallas") ** 2))(im)
            return jnp.sum(jnp.sqrt(jnp.sum(g.reshape(im.shape[0], -1) ** 2, axis=1)))

        want = jax.grad(jgp)(jnp.asarray(x))
        xt.requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(tb.blur_images(xt, 2.0) ** 2), xt,
                                   create_graph=True)
        gp = torch.sum(torch.sqrt(torch.sum(g.reshape(2, -1) ** 2, dim=1)))
        (got,) = torch.autograd.grad(gp, xt)
        np.testing.assert_allclose(to_nhwc(got), np.asarray(want), **GRAD)

    def test_band_matrix_grads_match_jax(self):
        # The σ terms of the primitive's JVP, as plain einsums in the port.
        rng = np.random.RandomState(6)
        # Unit-scale products (T / sqrt(dim)) keep the gradients O(1).
        planes, t_h, t_w = (rng.randn(3, 8, 12).astype(np.float32),
                            (rng.randn(8, 8) / np.sqrt(8)).astype(np.float32),
                            (rng.randn(12, 12) / np.sqrt(12)).astype(np.float32))
        from blurred_gan_tpu.ops.blur_pallas import blur_planes as jax_blur_planes

        want = jax.grad(lambda *a: jnp.sum(jax_blur_planes(*a) ** 2), argnums=(0, 1, 2))(
            *map(jnp.asarray, (planes, t_h, t_w)))
        args = [torch.from_numpy(a).requires_grad_(True) for a in (planes, t_h, t_w)]
        got = torch.autograd.grad(torch.sum(blur_cuda.blur_planes(*args) ** 2), args)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD)

    def test_gradgradcheck_float64(self):
        gen = torch.Generator().manual_seed(0)
        args = [torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
                for s in ((2, 4, 5), (4, 4), (5, 5))]
        assert torch.autograd.gradcheck(blur_cuda.BlurPlanes.apply, args)
        assert torch.autograd.gradgradcheck(blur_cuda.BlurPlanes.apply, args)


class TestDispatch:
    def test_cpu_uses_plain_version_and_launches_nothing(self):
        before = blur_cuda.launch_count
        x = torch.randn(4, 8, 8)
        t = tb.blur_matrix(1.0, 8)
        torch.testing.assert_close(blur_cuda.blur_planes(x, t, t),
                                   blur_cuda.blur_planes_reference(x, t, t))
        assert blur_cuda.launch_count == before

    def test_shape_mismatch_raises(self):
        with pytest.raises(ValueError):
            blur_cuda.blur_planes(torch.zeros(2, 8, 8), torch.zeros(8, 8), torch.zeros(7, 7))

    def test_port_never_imports_jax(self):
        code = ("import sys, blurred_gan_tpu_torch.ops.blur as b, "
                "blurred_gan_tpu_torch.ops.blur_cuda, blurred_gan_tpu_torch.models; "
                "import torch; b.blur_images(torch.zeros(1, 3, 8, 8), 1.0); "
                "assert 'jax' not in sys.modules, 'jax imported'")
        subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
