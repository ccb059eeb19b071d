"""Diagnose GAN sample sets: pixel statistics, spectrum bands and the blurred
objective (the port's counterpart of the repo root's
``tools/diagnose_samples.py``).

For each quality-parity sample set (``<side>_samples_s<seed>.npz`` with a
``samples`` array in [-1, 1] NHWC) it prints one JSON line with

- pixel statistics: mean, std and the tanh-saturation fraction (|x| > 0.98);
- radial power-spectrum band energies against the held-out reals (low r < 4,
  mid 4-12, hi 12-24, vhi 24+ cycles an image);
- with ``--sigma``, the blurred objective: SWD and random-conv FID between
  the σ-blurred fakes and the σ-blurred reals, the distribution the critic
  saw. The blur runs through ``ops.blur.blur_images``, hence the blur kernel
  on the card, in chunks of 100 images, and so do SWD and FID.

The reals are the quality-parity protocol's: the last 1000 images of the
fixed ``RandomState(10_000)`` shuffle of the configuration's synthetic corpus.
``--grids_from <dir>`` scores sides whose npz is missing from their 8x8 grid
PNGs (``g_<side>_s<seed>.png``); every side, the reals included, then moves to
the grids' clip(x, 0, 1) domain at the 64 tiles' count. The rows, keys and
rounding are the root tool's.

    python -m blurred_gan_tpu_torch.tools.diagnose_samples --dir runs/qp \\
        --config celeba64 --seeds 6,7,8 --sides ref,ours --sigma 4.94
    python -m blurred_gan_tpu_torch.tools.diagnose_samples --dir results/quality/heavy64/work \\
        --config celeba64 --seeds 6 --sides ref,ours \\
        --grids_from results/quality/heavy64/grids --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch import quality
from blurred_gan_tpu_torch.data.pipeline import synthetic_images
from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.ops.blur import blur_images
from blurred_gan_tpu_torch.utils.images import NHWC_to_NCHW, save_image_grid

N_EVAL = quality.N_EVAL
CHUNK = 100  # images a blur call and a metric update take
BANDS = (("low_r<4", 0, 4), ("mid_4-12", 4, 12),
         ("hi_12-24", 12, 24), ("vhi_24+", 24, 10 ** 9))
# The corpus of each quality-check configuration, (image_shape, corpus_n).
CONFIGS = {name: (cfg.image_shape, cfg.corpus_n) for name, cfg in quality.CONFIGS.items()}


def spectrum_bands(x: np.ndarray) -> dict:
    """Radial power-spectrum energy per band of a [-1, 1] NHWC image set."""
    g = x.mean(axis=-1)
    g = g - g.mean(axis=(1, 2), keepdims=True)
    power = (np.abs(np.fft.fftshift(np.fft.fft2(g), axes=(1, 2))) ** 2).mean(axis=0)
    h, w = power.shape
    yy, xx = np.mgrid[0:h, 0:w]
    r = np.sqrt((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
    return {name: float(power[(r >= lo) & (r < hi)].sum()) for name, lo, hi in BANDS}


def pixel_stats(x: np.ndarray, clip_domain: bool = False) -> dict:
    """Mean, std and the saturated share; in the clip(x, 0, 1) domain the
    shares at each rail, whose sum is the saturated share."""
    stats = {"mean": round(float(x.mean()), 4),
             "std": round(float(x.std()), 4),
             "sat": round(float((np.abs(x) > 0.98).mean()), 4)}
    if clip_domain:
        stats["rail0"] = round(float((x < 0.01).mean()), 4)
        stats["rail1"] = round(float((x > 0.99).mean()), 4)
        stats["sat"] = round(stats["rail0"] + stats["rail1"], 4)
    return stats


def load_grid_samples(path: str, res: int, pad: int = 2, grid=(8, 8)) -> np.ndarray:
    """The 64 tiles of a ``samples_grid`` PNG as a clip-domain set: the PNG
    holds clip(x, 0, 1) of the [-1, 1] samples, and the values stay in
    [0, 1]. Pillow reads the PNG (imported here only)."""
    from PIL import Image

    img = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    rows, cols = grid
    tiles = []
    for i in range(rows):
        for j in range(cols):
            y, x = pad + i * (res + pad), pad + j * (res + pad)
            tiles.append(img[y:y + res, x:x + res])
    return np.stack(tiles)


def to_clip_domain(x: np.ndarray) -> np.ndarray:
    """The ``samples_grid`` render transform: [-1, 1] -> clip(x, 0, 1)."""
    return np.clip(x, 0.0, 1.0)


def held_out_images(image_shape, corpus_n: int, n: int = N_EVAL) -> np.ndarray:
    """The last ``n`` images of the ``RandomState(10_000)`` shuffle of the
    synthetic corpus of ``corpus_n`` images, uint8 NHWC. Only those images
    are rendered."""
    order = np.random.RandomState(10_000).permutation(corpus_n)
    return synthetic_images(tuple(image_shape), order[-n:])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def blur_set(x: torch.Tensor, sigma: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """σ-blur an NCHW set in chunks of ``CHUNK`` images (one kernel launch a
    chunk on the card)."""
    return torch.cat([blur_images(x[i:i + CHUNK], sigma, impl=impl)
                      for i in range(0, len(x), CHUNK)])


def blurred_objective(reals_blur: torch.Tensor, fakes: torch.Tensor, sigma: torch.Tensor,
                      swd: SWDMetric, fid: FIDMetric, *, impl: str = "auto",
                      timings: Optional[Dict[str, float]] = None) -> dict:
    """SWD (x1e3, per level and the average) and random-conv FID (``fid_rc``)
    between the σ-blurred ``fakes`` and ``reals_blur``, both NCHW on one
    device, fed pairwise in chunks of ``CHUNK``; rounded to 2 places.
    ``swd`` and ``fid`` are fresh metric instances. ``timings``, if given,
    collects the seconds of the blur, SWD and FID (the card synchronised
    around each)."""
    device = fakes.device
    clock = {}

    def timed(name, fn):
        _sync(device)
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        clock[name] = time.perf_counter() - t0
        return out

    fakes_blur = timed("blur_s", lambda: blur_set(fakes, sigma, impl))
    pairs = [(reals_blur[i:i + CHUNK], fakes_blur[i:i + CHUNK])
             for i in range(0, len(fakes_blur), CHUNK)]

    def swd_results():
        for r, f in pairs:
            swd.update_state(r, f)
        return swd.results()

    def fid_result():
        for r, f in pairs:
            fid.update_state(r, f)
        return fid.result()

    out = {k: round(float(v), 2) for k, v in timed("swd_s", swd_results).items()}
    out["fid_rc"] = round(float(timed("fid_s", fid_result)), 2)
    if timings is not None:
        timings.update(clock)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pixel stats, spectrum bands and the blurred "
                                            "objective of sample sets")
    p.add_argument("--dir", required=True,
                   help="quality_parity --out directory with *_samples_s*.npz")
    p.add_argument("--config", default="celeba64", choices=sorted(CONFIGS),
                   help="quality_parity config name (corpus identity)")
    p.add_argument("--seeds", default="0")
    p.add_argument("--sides", default="ref,ours")
    p.add_argument("--sigma", type=float, default=0.0,
                   help="> 0: also score the blurred objective (SWD + random-conv FID "
                        "between sigma-blurred fakes and sigma-blurred reals; the "
                        "end-of-run sigma of the runs being diagnosed, e.g. 4.94 for "
                        "the 60k-example heavy-blur CelebA protocol)")
    p.add_argument("--save_grids", default="",
                   help="directory: also write 8x8 sample grids per set")
    p.add_argument("--grids_from", default="",
                   help="directory with g_<side>_s<seed>.png grids: fall back to grid "
                        "tiles for sides whose npz is missing; switches EVERY side to "
                        "the paired clip(x,0,1) domain at n=64 (see module doc)")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None, *, blur_impl: str = "auto",
         timings: Optional[Dict[str, Dict[str, float]]] = None) -> List[dict]:
    """Print the rows; returns them. ``blur_impl`` is ``blur_images``'
    ``impl`` (``"torch"``: the plain blur on the card); ``timings``, if
    given, gets the seconds of the reals' blur (``"reals"``) and of each
    set's blurred objective (by the set's name)."""
    args = build_parser().parse_args(argv)
    device = setup_device(args.device)
    image_shape, corpus_n = CONFIGS[args.config]
    res = image_shape[0]
    clip = bool(args.grids_from)
    reals = held_out_images(image_shape, corpus_n).astype(np.float32) / 127.5 - 1.0
    if clip:
        reals = to_clip_domain(reals[:64])
    n_eval = len(reals)
    reals_bands = spectrum_bands(reals)
    rows = [{"set": "reals", "n": n_eval, "domain": "clip01" if clip else "pm1",
             **pixel_stats(reals, clip_domain=clip),
             "bands": {k: round(v, 1) for k, v in reals_bands.items()}}]
    print(json.dumps(rows[0]), flush=True)

    if args.sigma > 0:
        sigma = torch.tensor(args.sigma, dtype=torch.float32, device=device)
        x = NHWC_to_NCHW(torch.from_numpy(reals)).contiguous().to(device)
        _sync(device)
        t0 = time.perf_counter()
        reals_blur = blur_set(x, sigma, blur_impl)
        _sync(device)
        if timings is not None:
            timings["reals"] = {"blur_s": time.perf_counter() - t0}

    for seed in [int(s) for s in args.seeds.split(",")]:
        for side in args.sides.split(","):
            path = os.path.join(args.dir, f"{side}_samples_s{seed}.npz")
            source = "npz"
            if os.path.exists(path):
                with np.load(path) as d:
                    fakes = d["samples"]
                if clip:
                    fakes = to_clip_domain(fakes[:n_eval])
            elif clip:
                gpath = os.path.join(args.grids_from, f"g_{side}_s{seed}.png")
                if not os.path.exists(gpath):
                    print(f"[skip] {path} and {gpath} missing", flush=True)
                    continue
                fakes = load_grid_samples(gpath, res)
                source = "grid_png"
            else:
                print(f"[skip] {path} missing", flush=True)
                continue
            row = {"set": f"{side}_s{seed}", "n": len(fakes), "source": source,
                   **pixel_stats(fakes, clip_domain=clip)}
            bands = spectrum_bands(fakes)
            # Bands past the Nyquist radius are empty at small resolutions
            # (vhi_24+ at 28x28): no ratio there.
            row["band_ratio_vs_reals"] = {k: round(bands[k] / reals_bands[k], 3)
                                          for k in bands if reals_bands[k] > 0}
            if args.sigma > 0:
                clock = {}
                x = NHWC_to_NCHW(torch.from_numpy(np.asarray(fakes, np.float32)))
                row["blurred_objective"] = blurred_objective(
                    reals_blur, x.contiguous().to(device), sigma, SWDMetric(), FIDMetric(),
                    impl=blur_impl, timings=clock)
                if timings is not None:
                    timings[row["set"]] = clock
            rows.append(row)
            print(json.dumps(row), flush=True)
            if args.save_grids:
                os.makedirs(args.save_grids, exist_ok=True)
                save_image_grid(fakes[:64], os.path.join(args.save_grids, f"{side}_s{seed}.png"))
    return rows


if __name__ == "__main__":
    main()
