"""Precision, recall, density and coverage of a generative model (port of
``blurred_gan_tpu/metrics/prdc.py``).

Naeem et al., "Reliable Fidelity and Diversity Metrics for Generative
Models" (ICML 2020), after Kynkäänniemi et al.'s improved precision and
recall (NeurIPS 2019). Precision and density measure fidelity (do the fakes
lie on the real manifold?), recall and coverage diversity (is the real
manifold covered?). The manifold is estimated by k-NN balls; squared
distances ‖a‖² + ‖b‖² − 2abᵀ (clipped at 0) are compared directly, on the
features' device in float32; the four scores are exact ratios of the counts.

With the real set R (N rows), the fake set F (M rows) and r_k(x) the
distance from x to the k-th nearest *other* member of its own set:

    precision = (1/M) Σ_j 1[ ∃i: d(f_j, r_i) ≤ r_k(r_i) ]
    recall    = (1/N) Σ_i 1[ ∃j: d(r_i, f_j) ≤ r_k(f_j) ]
    density   = (1/(kM)) Σ_j Σ_i 1[ d(f_j, r_i) ≤ r_k(r_i) ]
    coverage  = (1/N) Σ_i 1[ min_j d(r_i, f_j) ≤ r_k(r_i) ]

Memory is O(N·M + N² + M²) floats.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from blurred_gan_tpu_torch.metrics.fid import random_conv_features
from blurred_gan_tpu_torch.metrics.kid import as_features, extract_features


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D) × (M, D) → (N, M) squared euclidean distances."""
    a2 = torch.sum(a * a, dim=1)[:, None]
    b2 = torch.sum(b * b, dim=1)[None, :]
    return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


def _knn_sq_radii(x: torch.Tensor, k: int) -> torch.Tensor:
    """Squared distance from each row to its k-th nearest other row."""
    d = _pairwise_sq_dists(x, x)
    d = d + torch.diag(torch.full((x.shape[0],), float("inf"), dtype=x.dtype, device=x.device))
    return torch.sort(d, dim=1).values[:, k - 1]


def prdc(real_features, fake_features, k: int = 5) -> Dict[str, float]:
    """PRDC over (N, D) and (M, D) features (tensors or arrays); ``k``: the
    manifold's nearest neighbours."""
    real, fake = as_features(real_features), as_features(fake_features)
    if real.dim() != 2 or fake.dim() != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"expected (N, D)/(M, D) feature matrices with "
                         f"equal D, got {tuple(real.shape)} / {tuple(fake.shape)}")
    if not (0 < k < real.shape[0] and k < fake.shape[0]):
        raise ValueError(f"k={k} must be in [1, min(N, M) - 1] "
                         f"(N={real.shape[0]}, M={fake.shape[0]})")
    fake = fake.to(real.device)
    radii_r = _knn_sq_radii(real, k)           # (N,)
    radii_f = _knn_sq_radii(fake, k)           # (M,)
    d_fr = _pairwise_sq_dists(fake, real)      # (M, N)
    in_real_ball = d_fr <= radii_r[None, :]    # fake j within real i's ball
    counts = torch.stack([torch.any(in_real_ball, dim=1).sum(),
                          torch.any(d_fr <= radii_f[:, None], dim=0).sum(),
                          in_real_ball.sum(),
                          (torch.min(d_fr, dim=0).values <= radii_r).sum()]).tolist()
    m, n = fake.shape[0], real.shape[0]
    return {"precision": counts[0] / m, "recall": counts[1] / n,
            "density": counts[2] / (k * m), "coverage": counts[3] / n}


def prdc_from_images(reals: torch.Tensor, fakes: torch.Tensor,
                     feature_fn: Optional[Callable] = None, k: int = 5, batch: int = 100,
                     feature_dim: int = 2048) -> Dict[str, float]:
    """PRDC over NCHW image sets in [-1, 1], through FID's extractors: the
    fixed-seed random-conv embedding on the images' device by default, or
    ``feature_fn`` (e.g. ``inception_feature_fn(...)``)."""
    if feature_fn is None:
        feature_fn = random_conv_features(tuple(reals.shape[1:]), dim=feature_dim,
                                          device=reals.device)
    return prdc(extract_features(reals, feature_fn, batch),
                extract_features(fakes, feature_fn, batch), k=k)
