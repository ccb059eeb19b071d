"""Fréchet distance between feature distributions, streaming (port of
``blurred_gan_tpu/metrics/fid.py``).

Images are NCHW float tensors in [-1, 1]. Features are reduced on the device
to running moments in float32, shifted by the first batch's mean (``n``,
``Σ(x−c)``, ``Σ(x−c)(x−c)ᵀ``), so memory is O(D²) whatever the sample count;
only the (D,) mean and (D, D) covariance cross to the host, where the
distance is taken in float64 with ``scipy.linalg.sqrtm``, as in the JAX
package.

The default feature extractor is :func:`random_conv_features`, a fixed-seed
random strided-conv embedding. Its weights come from a seeded
``torch.Generator`` and so differ from the JAX package's ``jax.random``
draws: random-feature FIDs of the two packages are comparable only when the
weights are carried across (``convert.random_conv_weights_to_torch``).
InceptionV3 features plug in through ``FIDMetric(feature_fn=...)``
(``metrics/inception.py``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import scipy.linalg
import torch
import torch.nn.functional as F

from blurred_gan_tpu_torch.models.dcgan import _same_pads

RANDOM_CONV_WIDTHS = (64, 128, 256, 256)
RANDOM_CONV_KERNEL = 5


# ---------------------------------------------------------------------------
# Fréchet distance (host, float64)
# ---------------------------------------------------------------------------


def calculate_fid(features_x, features_y) -> float:
    """One-shot FID between two (N, D) feature arrays."""
    x = np.asarray(features_x, np.float64)
    y = np.asarray(features_y, np.float64)
    return frechet_distance(x.mean(0), np.cov(x, rowvar=False),
                            y.mean(0), np.cov(y, rowvar=False))


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """``‖μ₁−μ₂‖² + Tr(Σ₁+Σ₂−2√(Σ₁Σ₂))``, with an ``eps`` jitter when the
    product's square root is not finite and a guard on its imaginary part."""
    mu1 = np.atleast_1d(np.asarray(mu1, np.float64))
    mu2 = np.atleast_1d(np.asarray(mu2, np.float64))
    sigma1 = np.atleast_2d(np.asarray(sigma1, np.float64))
    sigma2 = np.atleast_2d(np.asarray(sigma2, np.float64))
    if mu1.shape != mu2.shape or sigma1.shape != sigma2.shape:
        raise ValueError(f"moments of different sizes: {mu1.shape}/{mu2.shape}, "
                         f"{sigma1.shape}/{sigma2.shape}")
    diff = mu1 - mu2
    covmean = scipy.linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(f"Imaginary component {np.max(np.abs(covmean.imag))}")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * np.trace(covmean))


# ---------------------------------------------------------------------------
# Streaming feature moments (device)
# ---------------------------------------------------------------------------


class FeatureStats:
    """Running shifted moments over feature batches, on the features' device
    in float32; ``finalize`` gives (μ, Σ) in float64 on the host.

    The shift ``c`` is the first batch's mean, so the sums stay O(n·var)
    instead of O(n·μ²) and float32 keeps its digits. Σ uses the unbiased
    (n − 1) normaliser, as ``np.cov``.
    """

    def __init__(self, dim: int):
        self.dim = dim
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.shift = self.s = self.ss = None

    def update(self, feats: torch.Tensor) -> None:
        if feats.dim() != 2 or feats.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) features, got {tuple(feats.shape)}")
        feats = feats.to(torch.float32)
        if self.shift is None:
            self.shift = feats.mean(0)
            self.s = torch.zeros_like(self.shift)
            self.ss = feats.new_zeros((self.dim, self.dim))
        x = feats - self.shift
        self.n += feats.shape[0]
        self.s += x.sum(0)
        self.ss += x.T @ x

    def _host(self):
        if self.n < 2:
            raise ValueError("need at least 2 samples for a covariance")
        m = self.s.double().cpu().numpy() / self.n
        mu = self.shift.double().cpu().numpy() + m
        m2 = self.ss.double().cpu().numpy() - self.n * np.outer(m, m)
        return mu, m2

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        mu, m2 = self._host()
        return mu, m2 / (self.n - 1.0)

    def moments(self):
        """(n, μ, M2) with M2 = Σ(x−μ)(x−μ)ᵀ, float64: the mergeable form."""
        mu, m2 = self._host()
        return float(self.n), mu, m2


def merge_feature_moments(moments: Sequence):
    """Pool (n, μ, M2) triples into global (n, μ, Σ): the exact parallel
    combine, so the FID of merged parts equals that of their union."""
    n = sum(m[0] for m in moments)
    mu = sum(m[0] * m[1] for m in moments) / n
    m2 = sum(m[2] for m in moments)
    m2 = m2 + sum(m[0] * np.outer(m[1] - mu, m[1] - mu) for m in moments)
    return n, mu, m2 / (n - 1.0)


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------


def _conv_same(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Convolution with XLA's SAME padding for this input's shape: at stride
    2 and a 5-wide kernel, (1, 2) on an even side and (2, 2) on an odd one."""
    kh, kw = w.shape[2:]
    ph = _same_pads(x.shape[2], kh, stride)
    pw = _same_pads(x.shape[3], kw, stride)
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def random_conv_features(image_shape, dim: int = 2048, seed: int = 0, *,
                         weights: Optional[Tuple[Sequence[torch.Tensor], torch.Tensor]] = None,
                         device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed-seed random strided-conv embedding ``(N, C, H, W) -> (N, dim)``.

    Four stride-2 5×5 convolutions (64, 128, 256, 256 channels, He-normal,
    no bias) with LeakyReLU 0.2, a global mean over space, then a fixed
    random projection to ``dim`` (normal / √256). ``image_shape`` is
    ``(C, H, W)``. ``weights``: ``(kernels (OIHW), projection (256, dim))``
    in place of the seeded draws.
    """
    c = image_shape[0]
    if weights is None:
        gen = torch.Generator().manual_seed(seed)
        kernels, in_c = [], c
        for out_c in RANDOM_CONV_WIDTHS:
            fan_in = RANDOM_CONV_KERNEL * RANDOM_CONV_KERNEL * in_c
            k = torch.randn((out_c, in_c, RANDOM_CONV_KERNEL, RANDOM_CONV_KERNEL),
                            generator=gen)
            kernels.append(k * math.sqrt(2.0 / fan_in))
            in_c = out_c
        proj = torch.randn((in_c, dim), generator=gen) / math.sqrt(in_c)
    else:
        kernels, proj = weights
    kernels = [k.to(device=device, dtype=torch.float32) for k in kernels]
    proj = proj.to(device=device, dtype=torch.float32)

    @torch.no_grad()
    def extract(images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        for k in kernels:
            x = F.leaky_relu(_conv_same(x, k, 2), 0.2)
        return x.mean(dim=(2, 3)) @ proj

    return extract


def inception_preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """Resize an NCHW batch to ``size``² (bilinear, half-pixel centres,
    antialiased when shrinking, as ``jax.image.resize``) and tile grey to
    three channels."""
    x = images.to(torch.float32)
    if x.shape[2:] != (size, size):
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=True)
    if x.shape[1] == 1:
        x = x.repeat(1, 3, 1, 1)
    return x


# ---------------------------------------------------------------------------
# Streaming metric
# ---------------------------------------------------------------------------


class FIDMetric:
    """Streaming FID: ``update_state(reals, fakes)`` per minibatch (NCHW),
    ``result()`` the scalar, ``reset_states()`` to start again.

    ``feature_fn`` maps an NCHW batch to (N, D) features; if None it is built
    from the first batch's shape and device by :func:`random_conv_features`.
    """

    name = "FID"

    def __init__(self, feature_fn: Optional[Callable] = None, feature_dim: int = 2048,
                 seed: int = 0):
        self.feature_fn = feature_fn
        self.feature_dim = feature_dim
        self.seed = seed
        self._real: Optional[FeatureStats] = None
        self._fake: Optional[FeatureStats] = None
        self._merged: Optional[Tuple[np.ndarray, ...]] = None

    def _build(self, batch: torch.Tensor) -> None:
        if self.feature_fn is None:
            self.feature_fn = random_conv_features(tuple(batch.shape[1:]), dim=self.feature_dim,
                                                   seed=self.seed, device=batch.device)
        dim = int(self.feature_fn(batch[:1]).shape[1])
        self._real = FeatureStats(dim)
        self._fake = FeatureStats(dim)

    def update_state(self, real_minibatch: torch.Tensor, fake_minibatch: torch.Tensor) -> None:
        if self._real is None:
            self._build(real_minibatch)
        self._real.update(self.feature_fn(real_minibatch))
        self._fake.update(self.feature_fn(fake_minibatch))

    def reset_states(self) -> None:
        self._merged = None
        if self._real is not None:
            self._real.reset()
            self._fake.reset()

    def cross_process_merge(self, allgather) -> None:
        """Pool this process's feature moments with every other process's, so
        that ``result()`` is the FID over all processes' pairs: an exact merge
        (:func:`merge_feature_moments`) of two (D,) and two (D, D) arrays a
        side. ``allgather(array) -> [each process's array]``
        (``parallel.allgather``)."""

        def pooled(stats: FeatureStats):
            n, mu, m2 = stats.moments()
            triples = [(float(a[0]), b, c) for a, b, c in zip(
                allgather(np.float64([n])), allgather(mu), allgather(m2))]
            _, mu_g, sig_g = merge_feature_moments(triples)
            return mu_g, sig_g

        self._merged = (*pooled(self._real), *pooled(self._fake))

    def result(self) -> float:
        if self._merged is not None:
            return frechet_distance(*self._merged)
        mu_r, sig_r = self._real.finalize()
        mu_f, sig_f = self._fake.finalize()
        return frechet_distance(mu_r, sig_r, mu_f, sig_f)
