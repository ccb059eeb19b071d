"""Score two sample sets against each other: SWD, FID and, on request, PRDC
and KID (the port's counterpart of the repo root's ``tools/score.py``).

Inputs (either side): an ``.npz`` with a ``samples`` array (else its first
array), an ``.npy`` array, NHWC or grayscale NHW, uint8 [0, 255] or float
[-1, 1], or a directory of images (``--resolution`` required), decoded,
centre-cropped and resized as the CelebA pipeline does.

    python -m blurred_gan_tpu_torch.tools.score --real reals.npz --fake samples.npz
    python -m blurred_gan_tpu_torch.tools.score --real a.npz --fake b.npz --kid --prdc \\
        --inception --inception_size 299 --limit 5000

Prints one JSON object: the per-level SWD (x1e3) and its average (3 places),
FID (4 places; the fixed-seed random-conv extractor by default, the
InceptionV3 pool3 trunk with ``--inception``), and with ``--prdc``
precision / recall / density / coverage (4 places) and with ``--kid``
``kid`` / ``kid_std`` (6 places), both over FID's features.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch.data.pipeline import ImageFolderDataset
from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.kid import kid_from_images
from blurred_gan_tpu_torch.metrics.prdc import prdc_from_images
from blurred_gan_tpu_torch.metrics.swd import SWDMetric


def _load(path: str, resolution: Optional[int], limit: Optional[int]) -> np.ndarray:
    """An input file as float32 NHWC in [-1, 1]."""
    if os.path.isdir(path):
        if resolution is None:
            raise SystemExit("--resolution is required with directory inputs")
        # Decoded in chunks with progress on stderr: a full CelebA folder is
        # ~10 GB of uint8.
        x = ImageFolderDataset(path, resolution, num_examples=limit).materialize().images
    elif path.endswith(".npz"):
        with np.load(path) as d:
            key = "samples" if "samples" in d else list(d.keys())[0]
            x = d[key]
    elif path.endswith(".npy"):
        x = np.load(path)
    else:
        raise SystemExit(f"unsupported input {path!r} (npz/npy/dir)")
    if x.ndim == 3:  # (N, H, W) grayscale
        x = x[..., None]
    if x.ndim != 4:
        raise SystemExit(f"{path}: expected (N,H,W,C) images, got {x.shape}")
    if limit:
        x = x[:limit]
    if x.dtype == np.uint8:
        x = x.astype(np.float32) / 127.5 - 1.0
    return np.asarray(x, np.float32)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="SWD + FID between two sample sets (npz/npy/image dir)")
    parser.add_argument("--real", required=True, help="reference-side samples")
    parser.add_argument("--fake", required=True, help="candidate-side samples")
    parser.add_argument("--resolution", type=int, default=None,
                        help="decode resolution for directory inputs")
    parser.add_argument("--limit", type=int, default=None,
                        help="score at most N images per side")
    parser.add_argument("--batch", type=int, default=100, help="metric update batch size")
    parser.add_argument("--inception", action="store_true",
                        help="FID on the InceptionV3 pool3 trunk instead of the "
                             "fixed-seed random-conv extractor")
    parser.add_argument("--inception_size", type=int, default=75,
                        help="InceptionV3 input resize (299 = the reference's FID "
                             "protocol; 75 = the smallest the stem accepts, ~16x "
                             "cheaper, preserves relative gaps)")
    parser.add_argument("--no_swd", action="store_true", help="skip SWD")
    parser.add_argument("--prdc", action="store_true",
                        help="also report precision/recall/density/coverage "
                             "(Naeem et al. 2020) over the same features as FID")
    parser.add_argument("--prdc_k", type=int, default=5,
                        help="k-NN manifold size for --prdc (paper default 5)")
    parser.add_argument("--kid", action="store_true",
                        help="also report Kernel Inception Distance (Bińkowski "
                             "et al. 2018) over the same features as FID")
    parser.add_argument("--kid_subsets", type=int, default=100,
                        help="--kid: number of MMD subsets (paper default 100)")
    parser.add_argument("--kid_subset_size", type=int, default=1000,
                        help="--kid: samples per subset (paper default 1000; "
                             "clamped to the available count)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the scores' JSON line; returns it as a dict."""
    args = build_parser().parse_args(argv)
    device = setup_device(args.device)
    reals = _load(args.real, args.resolution, args.limit)
    fakes = _load(args.fake, args.resolution, args.limit)
    if reals.shape[1:] != fakes.shape[1:]:
        raise SystemExit(f"shape mismatch: real {reals.shape[1:]} vs "
                         f"fake {fakes.shape[1:]}")
    n = min(len(reals), len(fakes))
    out = {"n_images": int(n), "image_shape": list(reals.shape[1:])}
    reals, fakes = (torch.from_numpy(x[:n]).permute(0, 3, 1, 2).contiguous().to(device)
                    for x in (reals, fakes))

    if not args.no_swd:
        if reals.shape[2] >= 16:
            swd = SWDMetric()
            for i in range(0, n, args.batch):
                swd.update_state(reals[i:i + args.batch], fakes[i:i + args.batch])
            out.update({k: round(float(v), 3) for k, v in swd.results().items()})
        else:
            out["swd"] = None  # the pyramid needs >= 16 px

    feature_fn = (inception_feature_fn(resize_to=args.inception_size, device=device)
                  if args.inception else None)
    fid = FIDMetric(feature_fn=feature_fn)
    for i in range(0, n, args.batch):
        fid.update_state(reals[i:i + args.batch], fakes[i:i + args.batch])
    out["fid_inception" if args.inception else "fid_randconv"] = round(float(fid.result()), 4)

    # fid.feature_fn exists after the first update (the random-conv default is
    # built from the first batch): PRDC and KID see FID's feature space.
    if args.prdc:
        out.update({k: round(v, 4) for k, v in prdc_from_images(
            reals, fakes, feature_fn=fid.feature_fn, k=args.prdc_k,
            batch=args.batch).items()})
    if args.kid:
        out.update({k: round(v, 6) for k, v in kid_from_images(
            reals, fakes, feature_fn=fid.feature_fn, n_subsets=args.kid_subsets,
            subset_size=args.kid_subset_size, batch=args.batch).items()})
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
