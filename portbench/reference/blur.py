"""The separable Gaussian blur from σ, with the kernel-size policy of the
blurred-GAN reference (``gaussian_blur.py``), in float32:

    kernel_size = floor(6σ) + 1, clipped to [3, resolution]
    σ_eff       = max((kernel_size − 1) / 6, 0.01)
    half        = floor(kernel_size / 2)

Taps ``exp(−d² / 2σ_eff²)`` for ``|d| ≤ half``, normalised by their sum;
zero-padded SAME borders. Applied to every (N·C) plane as ``T_h @ X @ T_w``
with the band matrices ``T[i, j] = taps[j − i]``.
"""

from __future__ import annotations

import torch


def policy(sigma: float, resolution: int):
    """``(σ_eff, half)`` of the policy, computed in float32."""
    s = torch.tensor(sigma, dtype=torch.float32)
    k = torch.clamp(torch.floor(6.0 * s) + 1.0, 3.0, float(resolution))
    sigma_eff = torch.clamp((k - 1.0) / 6.0, min=0.01)
    return float(sigma_eff), int(torch.floor(k / 2.0))


def taps(sigma: float, resolution: int) -> torch.Tensor:
    """The ``2·half + 1`` normalised float32 taps at offsets ``−half .. half``."""
    sigma_eff, half = policy(sigma, resolution)
    d = torch.arange(-half, half + 1, dtype=torch.float32)
    g = torch.exp(-(d ** 2) / (2.0 * torch.tensor(sigma_eff, dtype=torch.float32) ** 2))
    return g / g.sum()


def band_matrix(sigma: float, dim: int, resolution: int, device=None) -> torch.Tensor:
    """``(dim, dim)`` with ``T[i, j] = taps[j − i]`` inside the band, else 0."""
    t = taps(sigma, resolution)
    half = (t.numel() - 1) // 2
    d = torch.arange(dim)[None, :] - torch.arange(dim)[:, None]
    inside = d.abs() <= half
    out = torch.where(inside, t[(d + half).clamp(0, 2 * half)], torch.zeros(()))
    return out.to(device)


def blur(images: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur an NCHW float32 batch."""
    n, c, h, w = images.shape
    resolution = max(h, w)
    t_h = band_matrix(sigma, h, resolution, images.device)
    t_w = band_matrix(sigma, w, resolution, images.device)
    planes = images.reshape(n * c, h, w)
    return torch.matmul(torch.matmul(t_h, planes), t_w).reshape(n, c, h, w)
