"""Sample a grid from a trained run's latest checkpoint (the port's
counterpart of the repo root's ``generate_samples.py``).

Restores the latest checkpoint of a run directory (the model from its
``run_manifest.json``, the state's layout from its ``hyper_parameters.json``)
and writes an image grid PNG: ``--n`` random samples, or with
``--interpolate`` ``--rows`` rows that each walk linearly in ``--steps``
steps between two random latents. ``--blur_std`` blurs the samples as the
critic would see them (the blur kernel on the card). ``--ema`` samples the
generator's average. A run trained under ``--bf16`` is sampled in float32.

Latents are drawn on the CPU from ``torch.Generator().manual_seed(--seed)``,
so a seed gives the same grid on any device, but not the JAX script's grid:
that one draws with ``jax.random.PRNGKey(--seed)``.

    python -m blurred_gan_tpu_torch.generate_samples --log_dir results/01-mnist
    python -m blurred_gan_tpu_torch.generate_samples --log_dir results/02-celeba \\
        --out samples.png --blur_std 0.5
    python -m blurred_gan_tpu_torch.generate_samples --log_dir runs/x --device cpu --interpolate
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Optional, Sequence

import torch

from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.models.dcgan import (
    celeba_discriminator, celeba_generator, mnist_discriminator, mnist_generator)
from blurred_gan_tpu_torch.ops.blur import blur_images
from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager, load_sidecar
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, TrainState, create_train_state
from blurred_gan_tpu_torch.train.step import make_sample_fn
from blurred_gan_tpu_torch.utils.images import normalize_images, save_image_grid
from blurred_gan_tpu_torch.utils.rundir import resolve_model_identity


def add_model_arguments(parser: argparse.ArgumentParser) -> None:
    """``--log_dir``, ``--dataset``, ``--resolution`` and ``--device``: what
    every tool that restores a run takes."""
    parser.add_argument("--log_dir", required=True)
    parser.add_argument("--dataset", choices=["mnist", "celeba"], default=None,
                        help="model family; default: inferred from the run's "
                             "run_manifest.json (1-channel → mnist, 3 → celeba)")
    parser.add_argument("--resolution", type=int, default=None,
                        help="celeba resolution (must match the trained model; "
                             "default: inferred from run_manifest.json)")
    parser.add_argument("--device", type=str, default="cuda")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_arguments(parser)
    parser.add_argument("--out", default=None, help="output PNG path")
    parser.add_argument("--n", type=int, default=64)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--blur_std", type=float, default=None,
                        help="also blur the samples (view as the critic would)")
    parser.add_argument("--ema", action="store_true",
                        help="sample from the EMA generator weights (requires a "
                             "run trained with --ema_decay > 0)")
    parser.add_argument("--interpolate", action="store_true",
                        help="latent-space interpolation grid instead of random samples: "
                             "each row walks evenly between two random latents (linear: "
                             "the prior is uniform)")
    parser.add_argument("--rows", type=int, default=8,
                        help="interpolation rows (independent endpoint pairs)")
    parser.add_argument("--steps", type=int, default=8,
                        help="interpolation steps per row (grid columns)")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def run_gan(dataset: str, resolution: int) -> GAN:
    """The float32 networks of a ``dataset`` run at ``resolution``."""
    if dataset == "mnist":
        return GAN(mnist_generator(), mnist_discriminator(), blurred=True)
    return GAN(celeba_generator(resolution), celeba_discriminator(resolution), blurred=True)


def restore_error(dataset: str, resolution: int, e: Exception) -> SystemExit:
    """The exit for a checkpoint that does not fit the model, with the usual cause."""
    return SystemExit(
        f"checkpoint restore failed for a {dataset}@{resolution} model — if this run "
        f"was trained with a different --dataset/--resolution, pass the matching ones "
        f"(original error: {type(e).__name__}: {e})")


def restore_run(log_dir: str, dataset: str, resolution: int, device):
    """(gan, state, examples) of the latest checkpoint under
    ``log_dir/checkpoints``, the state built from the run's sidecar
    hyperparameters so that its layout (optimizer, average) is the
    checkpoint's."""
    gan = run_gan(dataset, resolution)
    hp = (load_sidecar(log_dir, BlurredWGANGPHyperParameters, "hyper_parameters.json")
          or BlurredWGANGPHyperParameters())
    state = create_train_state(gan, hp, device=device)
    ckpt = CheckpointManager(os.path.join(log_dir, "checkpoints"))
    try:
        restored = ckpt.restore_latest(state)
    except (RuntimeError, ValueError, KeyError) as e:
        raise restore_error(dataset, resolution, e) from e
    if restored is None:
        raise SystemExit(f"no checkpoint under {log_dir}/checkpoints")
    return gan, state, restored[1]


def interpolate_latents(za: torch.Tensor, zb: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` evenly spaced latents from ``za[r]`` to ``zb[r]`` for each
    row r, row after row."""
    t = torch.linspace(0.0, 1.0, steps)[None, :, None]
    return (za[:, None, :] * (1.0 - t) + zb[:, None, :] * t).reshape(za.shape[0] * steps, -1)


def grid_latents(gan: GAN, args: argparse.Namespace):
    """(latents on the CPU, grid (rows, columns), file name stem) of the
    grid ``args`` ask for."""
    rng = torch.Generator().manual_seed(args.seed)
    if args.interpolate:
        z2 = gan.sample_latents(2 * args.rows, rng, "cpu")
        z = interpolate_latents(z2[:args.rows], z2[args.rows:], args.steps)
        return z, (args.rows, args.steps), "interpolate"
    side = int(math.ceil(math.sqrt(args.n)))
    return gan.sample_latents(args.n, rng, "cpu"), (side, side), "generated"


def sample_images(gan: GAN, state: TrainState, latents: torch.Tensor, *, ema: bool = False,
                  blur_std: Optional[float] = None, blur_impl: str = "auto") -> torch.Tensor:
    """NCHW samples in [-1, 1] of the eval-mode generator (its average with
    ``ema``), blurred at σ ``blur_std`` if given."""
    images = make_sample_fn(gan, use_ema=ema)(state, latents)
    if blur_std is not None:
        images = blur_images(images, blur_std, impl=blur_impl)
    return images


def main(argv: Optional[Sequence[str]] = None) -> torch.Tensor:
    """Write the grid; returns its NCHW samples."""
    args = parse_args(argv)
    device = setup_device(args.device)
    args.dataset, args.resolution = resolve_model_identity(
        args.log_dir, args.dataset, args.resolution)
    gan, state, step = restore_run(args.log_dir, args.dataset, args.resolution, device)
    print(f"restored checkpoint @ {step} examples")
    if args.ema and state.g_ema is None:
        raise SystemExit("--ema: this run has no EMA weights "
                         "(train with --ema_decay > 0)")
    latents, grid, stem = grid_latents(gan, args)
    images = sample_images(gan, state, latents.to(device), ema=args.ema,
                           blur_std=args.blur_std)
    out = args.out or f"{args.log_dir}/{stem}_{step:08d}.png"
    save_image_grid(normalize_images(images.permute(0, 2, 3, 1).cpu().numpy()), out, grid=grid)
    print(f"wrote {out}")
    return images


if __name__ == "__main__":
    main()
