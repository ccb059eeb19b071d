"""Train the blurred WGAN-GP on CelebA with PyTorch on a CUDA GPU.

The port's counterpart of the repo root's ``train_celeba.py`` (its host path):
the DCGAN pair at the chosen resolution, σ₀ = 5 decaying open-loop
over ``--epochs`` (or the closed-loop controller with ``--adaptive``), SWD
(1000 samples) and FID (100 samples) every 50,000 examples, a sample grid
every 5,000, a checkpoint every 10,000 and on SIGINT / SIGTERM, and an
automatic resume from the latest checkpoint in the run directory. TF32 is off
in both matmuls and cuDNN convolutions. ``--bf16`` runs both networks'
convolutions and Dense layers in bfloat16 at the JAX package's dtype
boundaries (``models/dcgan.py``; the blur stays float32), ``--fast_gen`` with
it also the generator's BatchNorm outputs and its tanh. Data comes from a
local CelebA shard store or, without one, the deterministic synthetic
128x128x3 corpus.
``--device_resident`` parks the dataset on the card and trains in chunks of
``--chunk_steps`` steps, each a replay of the captured train step
(``train/fast.py``).

    python -m blurred_gan_tpu_torch.train_celeba --epochs 10 --log_dir results/celeba128
    python -m blurred_gan_tpu_torch.train_celeba --device_resident --chunk_steps 100
    python -m blurred_gan_tpu_torch.train_celeba --bf16 --fast_gen --device_resident
    python -m blurred_gan_tpu_torch.train_celeba --resolution 64 --device cpu --max_steps 3
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from blurred_gan_tpu_torch.data.pipeline import load_celeba
from blurred_gan_tpu_torch.entry import (
    add_common_arguments, entry_point_feeders, make_trainer, run, setup)
from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.loop import Trainer
from blurred_gan_tpu_torch.train.state import GAN


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_arguments(parser)
    parser.add_argument("--resolution", type=int, default=128,
                        choices=[8, 16, 32, 64, 128, 256, 512])
    parser.add_argument("--celeba_path", type=str, default=None)
    parser.add_argument("--max_blur_std", type=float, default=5.0, help="sigma_0")
    parser.add_argument("--num_examples", type=int, default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 activations in the convolutions and Dense layers "
                             "(tensor cores); parameters, BatchNorm statistics, the blur "
                             "and the critic's last Dense stay float32")
    parser.add_argument("--fast_gen", action="store_true",
                        help="with --bf16: keep the generator's BatchNorm outputs and its "
                             "final tanh in bfloat16 instead of float32 round-trips (BN "
                             "statistics and arithmetic still float32); ignored without "
                             "--bf16")
    parser.add_argument("--gen_upsample", default="transpose", choices=["transpose", "resize"])
    parser.add_argument("--sample_grid_every", type=int, default=5_000,
                        help="examples between fixed-latent sample grids")
    parser.add_argument("--checkpoint_every", type=int, default=10_000,
                        help="examples between checkpoints")
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def network_dtypes(args: argparse.Namespace) -> dict:
    """The networks' dtype arguments for ``--bf16`` and ``--fast_gen``: the
    root script's rule, ``--fast_gen`` only together with ``--bf16``."""
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    gen = {"compute_dtype": dtype}
    if args.fast_gen and args.bf16:
        gen.update(bn_dtype=dtype, output_f32=False)
    return {"generator": gen, "discriminator": {"compute_dtype": dtype}}


def build_trainer(args: argparse.Namespace, feeders: Optional[list] = None):
    """(trainer, total_examples) for parsed ``args``; ``feeders`` default to
    :func:`entry_point_feeders`."""
    device, hparams, config = setup(args)
    dataset = load_celeba(path=args.celeba_path, resolution=args.resolution,
                          num_examples=args.num_examples)
    if args.device_resident and not hasattr(dataset, "images"):
        gb = dataset.num_examples * args.resolution ** 2 * 3 / 1e9
        print(f"[train_celeba] materializing {dataset.num_examples} images for "
              f"--device_resident (~{gb:.1f} GB uint8)", flush=True)
        dataset = dataset.materialize()
    total_examples = dataset.num_examples * args.epochs
    if args.gen_upsample == "transpose" and args.max_blur_std >= 1.0:
        # A heavily blurred critic never sees pixel-scale structure, so the
        # transposed convolutions' checkerboard goes unpenalised.
        print(f"[train_celeba] note: max_blur_std {args.max_blur_std:g} >= 1 with the "
              f"'transpose' upsampler - heavy-blur runs leave the transposed "
              f"convolutions' checkerboard unpenalised and score markedly better with "
              f"--gen_upsample resize (see BASELINE.md)", flush=True)
    dtypes = network_dtypes(args)
    gan = GAN(celeba_generator(args.resolution, upsample=args.gen_upsample, **dtypes["generator"]),
              celeba_discriminator(args.resolution, **dtypes["discriminator"]), blurred=True)
    blur_ctrl = adaptive = None
    if args.adaptive:
        adaptive = AdaptiveBlurController(max_value=args.max_blur_std)
    else:
        blur_ctrl = BlurDecayController(total_n_training_examples=total_examples,
                                        max_value=args.max_blur_std)
    trainer = make_trainer(
        args, device, hparams, config, dataset, gan,
        blur_controller=blur_ctrl, adaptive_controller=adaptive,
        feeders=entry_point_feeders(args.inception_fid, device) if feeders is None else feeders,
        sample_grid_every_n_examples=args.sample_grid_every,
        checkpoint_every_n_examples=args.checkpoint_every)
    return trainer, total_examples


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    args = parse_args(argv)
    trainer, total_examples = build_trainer(args)
    compute = "bfloat16" if args.bf16 else "float32"
    if args.bf16 and args.fast_gen:
        compute += "+fast_gen"
    print(f"[train_celeba] res={args.resolution} bs={trainer.hparams.global_batch_size} "
          f"device={trainer.device} compute={compute} dataset={trainer.dataset.name} "
          f"log_dir={trainer.cfg.log_dir}", flush=True)
    run(trainer, args, total_examples, "train_celeba")
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
