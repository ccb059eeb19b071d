"""Separable 2-D Gaussian blur with a runtime σ (port of ``blurred_gan_tpu/ops/blur.py``).

Same sizing policy as the JAX package, computed in float32 tensors exactly as
JAX does so that ``floor(6σ)`` lands on the same side of every step:

    kernel_size = floor(6*std) + 1
    kernel_size = clip(kernel_size, 3, res)
    std         = max((kernel_size-1)/6, .01)
    taps        = 2*floor(kernel_size/2) + 1

σ is a tensor and no shape depends on it: the band matrices always have the
full ``(dim, dim)`` shape, and taps beyond the σ-dependent half-width are
masked to zero before normalisation. Nothing here reads σ back to the host, so
a σ held in a device tensor can change between calls without any rebuild.

Images are NCHW. The blur is ``out[p] = T_h @ X[p] @ T_w`` for every
``(N·C)`` plane, which the hand-written kernel in ``ops/blur_cuda.py`` computes
on the GPU. On the main path it takes σ itself and builds the taps of ``T``
(:func:`band_taps`) on the device, so no band matrix is built; only a σ that
requires grad goes through :func:`blur_matrix` and the kernel's T mode, so that
σ's gradient flows through the matrices. The arithmetic is float32 whatever the images' dtype, and the
result takes the images' dtype (bfloat16 fakes under ``--fast_gen``), as the
JAX package's casts around its kernel do. Zero-padded SAME borders: border rows of ``T`` sum to less than 1
(normalised by the full kernel sum, not per row).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from blurred_gan_tpu_torch.ops.blur_cuda import (
    blur_images_fused, blur_images_sigma, blur_planes_reference)

# Calls of :func:`blur_matrix` since the last reset (the band matrices built).
# Read and reset it as ``blur.matrix_count``.
matrix_count = 0


def appropriate_kernel_size(std):
    """``floor(6*std) + 1`` in the dtype of ``std``."""
    return torch.floor(6.0 * std) + 1.0


def appropriate_std(kernel_size):
    """Sigma that fills a kernel of the given size: ``(k - 1) / 6``."""
    return (kernel_size - 1.0) / 6.0


def maximum_reasonable_std(image_resolution: int) -> float:
    """Largest σ worth using at a resolution: the σ that fills a kernel of
    ``image_resolution - 1`` taps."""
    return float(image_resolution - 1 - 1) / 6.0


def max_taps(resolution: int) -> int:
    """Static tap-buffer size: the largest odd tap count the policy can produce."""
    return 2 * (resolution // 2) + 1


def _sigma_tensor(scale, device=None) -> torch.Tensor:
    if isinstance(scale, torch.Tensor):
        return scale.to(device=device if device is not None else scale.device,
                        dtype=torch.float32)
    return torch.tensor(float(scale), dtype=torch.float32, device=device)


def gaussian_kernel_1d(std, kernel_size: int, device=None) -> torch.Tensor:
    """Sum-normalised taps at offsets ``-(k//2) .. k//2`` (``kernel_size`` static)."""
    half = kernel_size // 2
    x = torch.arange(-half, half + 1, dtype=torch.float32, device=device)
    std = _sigma_tensor(std, device)
    g = torch.exp(-(x ** 2) / (2.0 * std ** 2)) / (math.sqrt(2.0 * math.pi) * std)
    return g / torch.sum(g)


def effective_blur_params(scale, resolution: int, device=None):
    """``(sigma_eff, half_width)`` as float32 tensors after the clip-then-rederive
    policy. Taps with ``|offset| > half_width`` are exactly zero."""
    scale = _sigma_tensor(scale, device)
    kernel_size = appropriate_kernel_size(scale)
    kernel_size = torch.clamp(kernel_size, 3.0, float(resolution))
    sigma_eff = torch.clamp(appropriate_std(kernel_size), min=0.01)
    half_width = torch.floor(kernel_size / 2.0)
    return sigma_eff, half_width


def masked_gaussian_taps(scale, resolution: int, device=None) -> torch.Tensor:
    """``(max_taps(resolution),)`` taps, zero past the active half-width,
    normalised over the active taps only."""
    sigma, half = effective_blur_params(scale, resolution, device)
    k = max_taps(resolution)
    x = torch.arange(-(k // 2), k // 2 + 1, dtype=torch.float32, device=sigma.device)
    g = torch.exp(-(x ** 2) / (2.0 * sigma ** 2))
    g = torch.where(torch.abs(x) <= half, g, torch.zeros_like(g))
    return g / torch.sum(g)


def band_taps(scale, resolution: int):
    """``(half, taps)``: the half-width as an int and the ``2·half + 1`` taps
    at offsets ``-half .. half``, normalised by their sum, as the blur
    kernel's σ mode builds them on the device from the same float32 policy
    (``T[i, j] = taps[half + j - i]``, zero off the band). Reads σ back to the
    host; nothing on the main path calls it."""
    sigma, half = effective_blur_params(scale, resolution)
    n = int(half)
    d = torch.arange(-n, n + 1, dtype=torch.float32)
    g = torch.exp(-(d ** 2) / (2.0 * sigma ** 2))
    return n, g / torch.sum(g)


def blur_matrix(scale, dim: int, resolution: int | None = None,
                device=None) -> torch.Tensor:
    """Banded Toeplitz ``T`` with ``T[i, j] = taps[j - i]``, shape ``(dim, dim)``.

    ``resolution`` is the policy resolution (the kernel is clipped to
    ``max(h, w)``); it defaults to ``dim``.
    """
    global matrix_count
    matrix_count += 1
    resolution = dim if resolution is None else resolution
    sigma, half = effective_blur_params(scale, resolution, device)
    idx = torch.arange(dim, dtype=torch.float32, device=sigma.device)
    d = idx[None, :] - idx[:, None]
    g = torch.exp(-(d ** 2) / (2.0 * sigma ** 2))
    band = torch.where(torch.abs(d) <= half, g, torch.zeros_like(g))
    # Normalise by the *full kernel* sum (not per row): zero-padding SAME.
    k = max_taps(resolution)
    offs = torch.arange(-(k // 2), k // 2 + 1, dtype=torch.float32,
                        device=sigma.device)
    taps = torch.exp(-(offs ** 2) / (2.0 * sigma ** 2))
    norm = torch.sum(torch.where(torch.abs(offs) <= half, taps,
                                 torch.zeros_like(taps)))
    return band / norm


def blur_images(images: torch.Tensor, scale, *, impl: str = "auto") -> torch.Tensor:
    """Gaussian-blur an NCHW batch with σ ``scale`` (float or tensor).

    ``impl``: ``"auto"``/``"cuda"`` go through the kernel's σ mode (the
    ``BlurSigma`` autograd Function: one launch a call, forward or backward, on
    a CUDA tensor, and its plain version on a CPU tensor), or through its T
    mode on the band matrices where σ requires grad. ``"torch"`` is the plain
    two-``matmul`` version on any device (the A/B baseline).
    """
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"impl must be 'auto', 'cuda' or 'torch', got {impl!r}")
    n, c, h, w = images.shape
    resolution = max(h, w)
    if impl == "torch":
        t_h = blur_matrix(scale, h, resolution, device=images.device)
        t_w = blur_matrix(scale, w, resolution, device=images.device)
        x = images.to(torch.float32).reshape(n * c, h, w)
        out = blur_planes_reference(x, t_h, t_w)
        return out.reshape(n, c, h, w).to(images.dtype)
    sigma = _sigma_tensor(scale, images.device)
    if sigma.requires_grad:
        return blur_images_fused(images, blur_matrix(sigma, h, resolution),
                                 blur_matrix(sigma, w, resolution))
    return blur_images_sigma(images, sigma)


def gaussian_blur_depthwise(images: torch.Tensor, std, kernel_size: int) -> torch.Tensor:
    """Separable depthwise-conv blur with a static kernel size (the oracle).

    Two grouped convolutions with zero SAME padding, NCHW.
    """
    n, c, h, w = images.shape
    g = gaussian_kernel_1d(std, kernel_size, device=images.device)
    taps = g.shape[0]
    x = images.to(torch.float32)
    k_row = g.reshape(1, 1, 1, taps).expand(c, 1, 1, taps)
    k_col = g.reshape(1, 1, taps, 1).expand(c, 1, taps, 1)
    y = F.conv2d(x, k_row, padding=(0, taps // 2), groups=c)
    z = F.conv2d(y, k_col, padding=(taps // 2, 0), groups=c)
    return z.to(images.dtype)
