"""Kernel Inception Distance: unbiased MMD² between feature sets (port of
``blurred_gan_tpu/metrics/kid.py``).

Bińkowski et al., "Demystifying MMD GANs" (ICLR 2018): the squared Maximum
Mean Discrepancy under the cubic polynomial kernel

    k(x, y) = (xᵀy / d + 1)³        (d = feature dimension)

with the unbiased U-statistic estimator, so its expectation does not depend
on the sample count. Reported as mean ± std over ``n_subsets`` random subsets
of ``subset_size`` rows (100 × 1000 by default, clamped to the rows there
are). Each subset's estimate is three m×m Gram matmuls in float32 on the
features' device. The subsets are drawn with ``np.random.RandomState(seed)``
in the JAX package's order, so both packages pick the same rows.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from blurred_gan_tpu_torch.metrics.fid import random_conv_features


def _mmd2_poly3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Unbiased MMD² with the cubic polynomial kernel over (m, D) subsets."""
    m, d = x.shape
    kxx = (x @ x.T / d + 1.0) ** 3
    kyy = (y @ y.T / d + 1.0) ** 3
    kxy = (x @ y.T / d + 1.0) ** 3
    offdiag = 1.0 - torch.eye(m, dtype=x.dtype, device=x.device)
    denom = m * (m - 1)
    return (torch.sum(kxx * offdiag) / denom + torch.sum(kyy * offdiag) / denom
            - 2.0 * torch.mean(kxy))


def as_features(x) -> torch.Tensor:
    """A feature matrix (tensor or array) as a float32 tensor, on its device."""
    return torch.as_tensor(x).to(torch.float32)


def kid(real_features, fake_features, n_subsets: int = 100, subset_size: int = 1000,
        seed: int = 0) -> Dict[str, float]:
    """KID over (N, D) and (M, D) features (tensors or arrays).

    Returns ``{"kid": mean, "kid_std": std}`` over ``n_subsets`` subsets of
    ``subset_size`` rows, each side drawn without replacement per subset
    from a fixed ``seed``, so calls repeat. ``subset_size`` is clamped to
    ``min(N, M)``; where that takes every row of both sides, every subset is
    the whole set and the one exact estimate is returned (std 0).
    """
    real, fake = as_features(real_features), as_features(fake_features)
    if real.dim() != 2 or fake.dim() != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"expected (N, D)/(M, D) feature matrices with "
                         f"equal D, got {tuple(real.shape)} / {tuple(fake.shape)}")
    if min(real.shape[0], fake.shape[0]) < 2:
        raise ValueError("KID needs at least 2 samples per side "
                         f"(got {real.shape[0]} / {fake.shape[0]})")
    if subset_size < 2:
        raise ValueError("KID's unbiased U-statistic divides by m(m-1): "
                         f"subset_size must be >= 2, got {subset_size}")
    fake = fake.to(real.device)
    m = int(min(subset_size, real.shape[0], fake.shape[0]))
    if m == real.shape[0] and m == fake.shape[0]:
        n_subsets = 1
    rng = np.random.RandomState(seed)
    vals = []
    for _ in range(int(n_subsets)):
        ri = torch.from_numpy(rng.choice(real.shape[0], m, replace=False)).to(real.device)
        fi = torch.from_numpy(rng.choice(fake.shape[0], m, replace=False)).to(real.device)
        vals.append(_mmd2_poly3(real[ri], fake[fi]))
    vals = torch.stack(vals).cpu().numpy().astype(np.float64)
    return {"kid": float(vals.mean()), "kid_std": float(vals.std())}


def extract_features(images: torch.Tensor, feature_fn: Callable, batch: int) -> torch.Tensor:
    """``feature_fn`` over ``images`` in batches of ``batch``, concatenated."""
    return torch.cat([feature_fn(images[i:i + batch]) for i in range(0, len(images), batch)])


def kid_from_images(reals: torch.Tensor, fakes: torch.Tensor,
                    feature_fn: Optional[Callable] = None, n_subsets: int = 100,
                    subset_size: int = 1000, batch: int = 100, feature_dim: int = 2048,
                    seed: int = 0) -> Dict[str, float]:
    """KID over NCHW image sets in [-1, 1], through FID's extractors: the
    fixed-seed random-conv embedding on the images' device by default, or
    ``feature_fn`` (e.g. ``inception_feature_fn(...)``)."""
    if feature_fn is None:
        feature_fn = random_conv_features(tuple(reals.shape[1:]), dim=feature_dim,
                                          device=reals.device)
    return kid(extract_features(reals, feature_fn, batch),
               extract_features(fakes, feature_fn, batch),
               n_subsets=n_subsets, subset_size=subset_size, seed=seed)
