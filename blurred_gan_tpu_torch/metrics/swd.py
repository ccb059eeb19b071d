"""Multi-scale sliced Wasserstein distance (SWD), on the device (port of
``blurred_gan_tpu/metrics/swd.py``).

The ProGAN evaluation protocol, on NCHW float tensors in [-1, 1]:

- a Laplacian pyramid from full resolution down to 16 px, built with a 5×5
  binomial filter and reflect padding;
- per level, 128 random 7×7 patches per image, flattened in (C, y, x) order;
- descriptors normalised per channel over the whole set (population std);
- projected onto 4 repeats × 128 random unit directions, sorted over the
  patches, mean |Δ|; reported per level ×1e3 as ``SWDx1e3_<res>`` plus their
  average.

Patch positions and projection directions come from seeded
``torch.Generator``\\ s on the images' device, so the values are not those of
the JAX package (``jax.random``) on the same images unless the draws are
pinned: the functions take positions and directions explicitly, and
``SWDMetric.draw_positions`` / ``draw_directions`` can be overridden.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

_BINOMIAL_1D = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)

NHOOD_SIZE = 7
NHOODS_PER_IMAGE = 128
DIR_REPEATS = 4
DIRS_PER_REPEAT = 128
MIN_RESOLUTION = 16
_RESULTS_STREAM = 10_000  # seed offset of the directions drawn by SWDMetric.results
_API_STREAM = 20_000      # and by SWDAPI.end


def swd_resolutions(resolution: int) -> List[int]:
    """Pyramid level resolutions: full res halved down to 16; below 16² one
    level at the native resolution."""
    out = []
    res = resolution
    while res >= MIN_RESOLUTION:
        out.append(res)
        res //= 2
    return out or [resolution]


# ---------------------------------------------------------------------------
# Laplacian pyramid (NCHW)
# ---------------------------------------------------------------------------


def _binomial_blur(x: torch.Tensor, gain: float = 1.0) -> torch.Tensor:
    """Separable 5×5 binomial depthwise blur with reflect padding: along W
    (with ``gain``), then along H."""
    c = x.shape[1]
    x = F.pad(x, (2, 2, 2, 2), mode="reflect")
    taps = torch.tensor(_BINOMIAL_1D, dtype=x.dtype, device=x.device)
    k_row = (taps * gain).reshape(1, 1, 1, 5).expand(c, 1, 1, 5)
    k_col = taps.reshape(1, 1, 5, 1).expand(c, 1, 5, 1)
    return F.conv2d(F.conv2d(x, k_row, groups=c), k_col, groups=c)


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """Blur, then keep the even rows and columns (cv2.pyrDown)."""
    return _binomial_blur(x)[:, :, ::2, ::2]


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff to twice the size, then blur with gain 4 (cv2.pyrUp)."""
    n, c, h, w = x.shape
    up = x.new_zeros((n, c, 2 * h, 2 * w))
    up[:, :, ::2, ::2] = x
    return _binomial_blur(up, gain=4.0)


def laplacian_pyramid(images: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """Laplacian pyramid, coarsest level last."""
    pyramid = [images.to(torch.float32)]
    for _ in range(1, num_levels):
        down = pyr_down(pyramid[-1])
        pyramid[-1] = pyramid[-1] - pyr_up(down)
        pyramid.append(down)
    return pyramid


def reconstruct_laplacian_pyramid(pyramid: Sequence[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`laplacian_pyramid`."""
    x = pyramid[-1]
    for level in pyramid[-2::-1]:
        x = pyr_up(x) + level
    return x


def downscale_minibatch(images: torch.Tensor, lod: int) -> torch.Tensor:
    """Average-pool 2× per level of detail (NCHW, float32 out; ``lod`` 0
    returns ``images`` as they are)."""
    if lod == 0:
        return images
    x = images.to(torch.float32)
    for _ in range(lod):
        x = (x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
             + x[:, :, 1::2, 0::2] + x[:, :, 1::2, 1::2]) * 0.25
    return x


# ---------------------------------------------------------------------------
# Patch descriptors
# ---------------------------------------------------------------------------


def random_positions(level_shape, nhoods_per_image: int, generator: torch.Generator,
                     nhood_size: int = NHOOD_SIZE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-left corners ``(y0, x0)`` of ``nhoods_per_image`` patches per image,
    uniform over patches that lie inside the image."""
    n_img, _, s_h, s_w = level_shape
    half = nhood_size // 2
    n = n_img * nhoods_per_image
    device = generator.device
    x0 = torch.randint(half, s_w - half, (n,), generator=generator, device=device) - half
    y0 = torch.randint(half, s_h - half, (n,), generator=generator, device=device) - half
    return y0, x0


def patch_descriptors(level: torch.Tensor, positions: Tuple[torch.Tensor, torch.Tensor],
                      nhood_size: int = NHOOD_SIZE,
                      nhoods_per_image: int = NHOODS_PER_IMAGE) -> torch.Tensor:
    """The ``nhood_size``² patches at ``positions`` (``(y0, x0)``, one per patch,
    ``nhoods_per_image`` consecutive patches per image) as
    ``(N_img * nhoods, C * k * k)`` in (C, y, x) order."""
    n_img, c = level.shape[:2]
    y0, x0 = (p.to(device=level.device, dtype=torch.long) for p in positions)
    n = n_img * nhoods_per_image
    k = torch.arange(nhood_size, device=level.device)
    img = torch.arange(n, device=level.device) // nhoods_per_image
    chan = torch.arange(c, device=level.device)
    patches = level[img[:, None, None, None], chan[None, :, None, None],
                    (y0[:, None] + k)[:, None, :, None], (x0[:, None] + k)[:, None, None, :]]
    return patches.reshape(n, c * nhood_size * nhood_size)


def finalize_descriptors(desc: torch.Tensor, channels: int) -> torch.Tensor:
    """Normalise per channel over all patches and positions (mean, population std)."""
    n = desc.shape[0]
    d = desc.reshape(n, channels, -1)
    std, mean = torch.std_mean(d, dim=(0, 2), keepdim=True, correction=0)
    return ((d - mean) / (std + 1e-12)).reshape(n, -1)


# ---------------------------------------------------------------------------
# Sliced Wasserstein distance
# ---------------------------------------------------------------------------


def random_directions(dim: int, generator: torch.Generator, dir_repeats: int = DIR_REPEATS,
                      dirs_per_repeat: int = DIRS_PER_REPEAT) -> torch.Tensor:
    """``(dir_repeats, dim, dirs_per_repeat)`` standard normal draws."""
    return torch.randn((dir_repeats, dim, dirs_per_repeat), generator=generator,
                       device=generator.device)


def sliced_wasserstein_distance(a: torch.Tensor, b: torch.Tensor,
                                directions: torch.Tensor) -> torch.Tensor:
    """Mean 1-D Wasserstein distance between descriptor sets ``a`` and ``b``
    (both (N, D)) over the columns of each ``directions[r]`` (D, K), each
    normalised to unit length: project, sort over the patches, mean |Δ|,
    then the mean over repeats. A 0-d tensor."""
    dists = []
    for dirs in directions.to(device=a.device, dtype=torch.float32):
        dirs = dirs / torch.sqrt(torch.sum(dirs ** 2, dim=0, keepdim=True))
        pa = torch.sort(a @ dirs, dim=0).values
        pb = torch.sort(b @ dirs, dim=0).values
        dists.append(torch.mean(torch.abs(pa - pb)))
    return torch.stack(dists).mean()


# ---------------------------------------------------------------------------
# Streaming metric
# ---------------------------------------------------------------------------


class SWDMetric:
    """Streaming multi-scale SWD: ``update_state(reals, fakes)`` per NCHW
    minibatch pair, then ``results()`` gives ``{'SWDx1e3_<res>': v, ...,
    'SWDx1e3_avg': v}``.

    Descriptors are extracted per minibatch and kept on the device in float32
    (about 75 MB per level per side at 1000 images of 128²) until
    ``reset_states``. Patch positions come from one generator seeded with
    ``seed`` that advances over the updates; the directions of level ``lod``
    from a generator seeded with ``seed + 10000 + lod`` at every ``results``.
    """

    name = "SWDx1e3_avg"

    def __init__(self, nhood_size: int = NHOOD_SIZE, nhoods_per_image: int = NHOODS_PER_IMAGE,
                 dir_repeats: int = DIR_REPEATS, dirs_per_repeat: int = DIRS_PER_REPEAT,
                 seed: int = 0):
        self.nhood_size = nhood_size
        self.nhoods_per_image = nhoods_per_image
        self.dir_repeats = dir_repeats
        self.dirs_per_repeat = dirs_per_repeat
        self.seed = seed
        self.resolutions: List[int] = []
        self._channels = 0
        self._n_updates = 0
        self._positions_rng: Optional[torch.Generator] = None
        self.real_descriptors: List[List[torch.Tensor]] = []
        self.fake_descriptors: List[List[torch.Tensor]] = []

    def _build(self, resolution: int, channels: int, device) -> None:
        self.resolutions = swd_resolutions(resolution)
        self._channels = channels
        self.real_descriptors = [[] for _ in self.resolutions]
        self.fake_descriptors = [[] for _ in self.resolutions]
        self._positions_rng = torch.Generator(device=device).manual_seed(self.seed)

    def draw_positions(self, update: int, side: int, lod: int, level_shape):
        """``(y0, x0)`` of the patches of one pyramid level of one minibatch:
        ``update`` counts from 1, ``side`` is 0 for reals and 1 for fakes."""
        return random_positions(level_shape, self.nhoods_per_image, self._positions_rng,
                                self.nhood_size)

    def draw_directions(self, lod: int, dim: int, stream: int = _RESULTS_STREAM):
        """Raw (unnormalised) directions ``(dir_repeats, dim, dirs_per_repeat)``."""
        gen = torch.Generator(device=self._positions_rng.device)
        gen.manual_seed(self.seed + stream + lod)
        return random_directions(dim, gen, self.dir_repeats, self.dirs_per_repeat)

    def _extract(self, batch: torch.Tensor, update: int, side: int) -> List[torch.Tensor]:
        levels = laplacian_pyramid(batch, len(self.resolutions))
        return [patch_descriptors(level, self.draw_positions(update, side, lod, level.shape),
                                  self.nhood_size, self.nhoods_per_image)
                for lod, level in enumerate(levels)]

    @torch.no_grad()
    def update_state(self, real_minibatch: torch.Tensor, fake_minibatch: torch.Tensor) -> None:
        if not self.resolutions:
            self._build(real_minibatch.shape[2], real_minibatch.shape[1], real_minibatch.device)
        self._n_updates += 1
        for side, (batch, bank) in enumerate(((real_minibatch, self.real_descriptors),
                                              (fake_minibatch, self.fake_descriptors))):
            for lod, desc in enumerate(self._extract(batch, self._n_updates, side)):
                bank[lod].append(desc)

    def reset_states(self) -> None:
        for bank in (self.real_descriptors, self.fake_descriptors):
            for d in bank:
                d.clear()

    def cross_process_merge(self, allgather) -> None:
        """Replace each level's descriptor banks with their union over the
        processes, in rank order, so that ``results()`` is the SWD over all
        processes' pairs (the descriptors are raw; ``finalize_descriptors``
        normalises the union). ``allgather(array) -> [each process's
        array]`` (``parallel.allgather``)."""
        for bank in (self.real_descriptors, self.fake_descriptors):
            for lod, parts in enumerate(bank):
                local = torch.cat(parts)
                union = [torch.from_numpy(a).to(local.device)
                         for a in allgather(local.cpu().numpy())]
                bank[lod] = [torch.cat(union)]

    def get_metric_names(self) -> List[str]:
        return [f"SWDx1e3_{res}" for res in self.resolutions] + ["SWDx1e3_avg"]

    @torch.no_grad()
    def results(self) -> Dict[str, float]:
        dists = []
        for lod in range(len(self.resolutions)):
            dr = finalize_descriptors(torch.cat(self.real_descriptors[lod]), self._channels)
            df = finalize_descriptors(torch.cat(self.fake_descriptors[lod]), self._channels)
            dirs = self.draw_directions(lod, dr.shape[1])
            dists.append(float(sliced_wasserstein_distance(dr, df, dirs)) * 1e3)
        dists.append(sum(dists) / len(dists))
        return dict(zip(self.get_metric_names(), dists))

    def result(self) -> float:
        return self.results()["SWDx1e3_avg"]


class SWDAPI:
    """The standalone protocol: ``begin(mode)``, ``feed(mode, batch)``...,
    ``end(mode)``. 'warmup'/'reals' set the real-descriptor bank; every
    ``end`` returns ``[SWD×1e3 per level..., average]`` against it. NCHW
    batches; ``image_shape`` is (C, H, W)."""

    def __init__(self, image_shape, seed: int = 0, device=None):
        c, res = image_shape[0], image_shape[1]
        self._metric = SWDMetric(seed=seed)
        self._metric._build(res, c, device if device is not None else "cpu")
        self.resolutions = self._metric.resolutions
        self.desc_real: Optional[List[torch.Tensor]] = None
        self._descriptors: Optional[List[List[torch.Tensor]]] = None
        self._n = 0

    def get_metric_names(self) -> List[str]:
        return self._metric.get_metric_names()

    def begin(self, mode: str) -> None:
        if mode not in ("warmup", "reals", "fakes"):
            raise ValueError(f"mode must be warmup, reals or fakes, got {mode!r}")
        self._descriptors = [[] for _ in self.resolutions]

    @torch.no_grad()
    def feed(self, mode: str, minibatch: torch.Tensor) -> None:
        self._n += 1
        for lod, desc in enumerate(self._metric._extract(minibatch, self._n, 0)):
            self._descriptors[lod].append(desc)

    @torch.no_grad()
    def end(self, mode: str) -> List[float]:
        desc = [finalize_descriptors(torch.cat(d), self._metric._channels)
                for d in self._descriptors]
        self._descriptors = None
        if mode in ("warmup", "reals"):
            self.desc_real = desc
        dist = []
        for lod, (dr, df) in enumerate(zip(self.desc_real, desc)):
            dirs = self._metric.draw_directions(lod, dr.shape[1], stream=_API_STREAM)
            dist.append(float(sliced_wasserstein_distance(dr, df, dirs)) * 1e3)
        return dist + [sum(dist) / len(dist)]
