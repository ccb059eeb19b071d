"""Sample a trained CelebA run's generator with its BatchNorm's running
statistics and then with each batch's own, and diagnose both sets (the port's
counterpart of the repo root's ``tools/bn_stats_ab.py``).

Training normalises with each batch's statistics; sampling for evaluation
uses the running averages. Under heavy blur the two can part: the critic
never sees pixel-scale structure, so activation statistics drift and the
averages lag. This tool restores a run directory's latest checkpoint
(through ``Trainer``), generates the quality-parity eval latents
(``RandomState(123).rand(1000, 100)``) both ways, the batch statistics over
windows of ``--batch`` latents, and prints ``diagnose_samples``' rows for each
against the held-out reals. The batch-statistics pass runs a copy of the
generator, so the restored running statistics stay as they were.

    python -m blurred_gan_tpu_torch.tools.bn_stats_ab --log_dir runs/ours_refscale_log_s6 \\
        [--n 1000] [--batch 100] [--out_npz_dir DIR] [--device cpu]

A run directory whose name contains ``resize`` is restored with the resize
upsampler, any other with the transposed convolutions.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch.data.pipeline import ArrayDataset
from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.generate_samples import restore_error
from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
from blurred_gan_tpu_torch.tools.diagnose_samples import (
    held_out_images, pixel_stats, spectrum_bands)
from blurred_gan_tpu_torch.train.checkpoint import load_sidecar
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN
from blurred_gan_tpu_torch.utils.rundir import resolve_model_identity

EVAL_LATENTS, LATENT = 1000, 100


def eval_latents(seed: int = 123) -> np.ndarray:
    """The quality-parity protocol's eval latents: uniform [0, 1), float32."""
    return np.random.RandomState(seed).rand(EVAL_LATENTS, LATENT).astype(np.float32)


@torch.no_grad()
def sample(generator: torch.nn.Module, latents: torch.Tensor, batch: int,
           train: bool) -> np.ndarray:
    """NHWC float32 samples of ``latents`` in windows of ``batch``: with
    ``train`` each window normalised by its own statistics, on a copy of
    the generator (whose running statistics absorb the windows'), else by
    the running statistics."""
    g = copy.deepcopy(generator) if train else generator
    was_training = g.training
    g.train(train)
    try:
        outs = [g(latents[i:i + batch]).float().permute(0, 2, 3, 1).cpu().numpy()
                for i in range(0, len(latents), batch)]
    finally:
        g.train(was_training)
    return np.concatenate(outs)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="BN batch-vs-running statistics sampling A/B")
    p.add_argument("--log_dir", required=True)
    p.add_argument("--n", type=int, default=1000)
    p.add_argument("--batch", type=int, default=100,
                   help="generation minibatch = the BN statistics window in train=True mode")
    p.add_argument("--corpus_n", type=int, default=20_000,
                   help="synthetic corpus size of the run's config "
                        "(quality_parity celeba configs use 20k)")
    p.add_argument("--out_npz_dir", default="", help="optionally save both sample sets as npz")
    p.add_argument("--device", type=str, default="cuda")
    return p


def main(argv: Optional[Sequence[str]] = None) -> List[dict]:
    """Print the rows (the reals, then running and batch statistics); returns them."""
    args = build_parser().parse_args(argv)
    device = setup_device(args.device)
    dataset_kind, resolution = resolve_model_identity(args.log_dir, None, None)
    if dataset_kind != "celeba":
        raise SystemExit("BN A/B targets the CelebA family runs")
    # The upsampler is the one generator knob that changes the parameters'
    # layout; quality-parity arms name it in the directory (ours_resize_*).
    name = os.path.basename(args.log_dir.rstrip("/"))
    upsample = "resize" if "resize" in name else "transpose"
    gan = GAN(celeba_generator(resolution, upsample=upsample),
              celeba_discriminator(resolution), blurred=True)
    images = held_out_images((resolution, resolution, 3), args.corpus_n, args.n)
    hp = (load_sidecar(args.log_dir, BlurredWGANGPHyperParameters, "hyper_parameters.json")
          or BlurredWGANGPHyperParameters())
    try:
        # The trainer only restores: the held-out reals stand for its dataset.
        tr = Trainer(gan, hp, ArrayDataset(images), device=device,
                     trainer_config=TrainerConfig(log_dir=args.log_dir,
                                                  sample_grid_every_n_examples=0,
                                                  checkpoint_every_n_examples=0,
                                                  image_summaries_interval_batches=0))
    except (RuntimeError, ValueError, KeyError) as e:
        raise restore_error(dataset_kind, resolution, e) from e
    if tr.restored_examples == 0:
        raise SystemExit(f"no checkpoint under {args.log_dir}/checkpoints")
    latents = torch.from_numpy(eval_latents()[:args.n]).to(device)

    reals = images.astype(np.float32) / 127.5 - 1.0
    ref_bands = spectrum_bands(reals)
    rows = [{"set": "reals", "n": int(args.n), **pixel_stats(reals),
             "bands": {k: round(v, 1) for k, v in ref_bands.items()}}]
    print(json.dumps(rows[0]), flush=True)
    for mode, train in (("bn_running", False), ("bn_batch", True)):
        x = sample(tr.state.generator, latents, args.batch, train)
        bands = spectrum_bands(x)
        # Bands past the Nyquist radius are empty below 48² (the root tool
        # divides by their zero there): no ratio for them, as diagnose_samples.
        row = {"set": f"{name}:{mode}", "n": int(args.n),
               "bn_window": args.batch if train else "running", **pixel_stats(x),
               "band_ratio_vs_reals": {k: round(bands[k] / ref_bands[k], 3)
                                       for k in bands if ref_bands[k] > 0}}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out_npz_dir:
            os.makedirs(args.out_npz_dir, exist_ok=True)
            np.savez(os.path.join(args.out_npz_dir, f"{name}_{mode}.npz"), samples=x)
    tr.close()
    return rows


if __name__ == "__main__":
    main()
