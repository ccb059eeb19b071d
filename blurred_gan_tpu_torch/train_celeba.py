"""Train the blurred WGAN-GP on CelebA with PyTorch on a CUDA GPU.

The port's counterpart of the repo root's ``train_celeba.py`` (its host path,
float32): the DCGAN pair at the chosen resolution, σ₀ = 5 decaying open-loop
over ``--epochs`` (or the closed-loop controller with ``--adaptive``), SWD
(1000 samples) and FID (100 samples) every 50,000 examples, a sample grid
every 5,000, a checkpoint every 10,000 and on SIGINT / SIGTERM, and an
automatic resume from the latest checkpoint in the run directory. TF32 is off
in both matmuls and cuDNN convolutions. Data comes from a local CelebA shard
store or, without one, the deterministic synthetic 128x128x3 corpus.

    python -m blurred_gan_tpu_torch.train_celeba --epochs 10 --log_dir results/celeba128
    python -m blurred_gan_tpu_torch.train_celeba --resolution 64 --device cpu --max_steps 3
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from blurred_gan_tpu_torch.data.pipeline import load_celeba
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters, TrainingConfig
from blurred_gan_tpu_torch.train.loop import MetricFeeder, Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN
from blurred_gan_tpu_torch.utils.rundir import create_result_subdir


def set_float32_precision() -> None:
    """True float32 everywhere: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    BlurredWGANGPHyperParameters.add_arguments(parser)
    TrainingConfig.add_arguments(parser)
    parser.add_argument("--resolution", type=int, default=128,
                        choices=[8, 16, 32, 64, 128, 256, 512])
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--adaptive", action="store_true",
                        help="closed-loop σ controller instead of the open-loop decay")
    parser.add_argument("--celeba_path", type=str, default=None)
    parser.add_argument("--max_blur_std", type=float, default=5.0, help="sigma_0")
    parser.add_argument("--num_examples", type=int, default=None)
    parser.add_argument("--inception_fid", action="store_true",
                        help="score FID on the InceptionV3 pool3 trunk (local weights; "
                             "see metrics/inception.py)")
    parser.add_argument("--gen_upsample", default="transpose", choices=["transpose", "resize"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_name", type=str, default=None,
                        help="create an auto-numbered results/NN-<name> run dir")
    parser.add_argument("--sample_grid_every", type=int, default=5_000,
                        help="examples between fixed-latent sample grids")
    parser.add_argument("--checkpoint_every", type=int, default=10_000,
                        help="examples between checkpoints")
    parser.add_argument("--fetch_timeout_s", type=float, default=0.0,
                        help="device-hang watchdog: per-step budget (seconds) for the "
                             "metric fetch, failing with DeviceHangError instead of "
                             "hanging (0 = off; resume from the latest checkpoint)")
    parser.add_argument("--device", type=str, default="cuda")
    return parser.parse_args(argv)


def entry_point_feeders(inception_fid: bool, device) -> list:
    """SWD over 1000 samples and FID over 100, each every 50,000 examples."""
    fid = (FIDMetric(feature_fn=inception_feature_fn(device=device)) if inception_fid
           else FIDMetric())
    return [MetricFeeder(SWDMetric(), every_n_examples=50_000, num_samples=1000, name="swd"),
            MetricFeeder(fid, every_n_examples=50_000, num_samples=100, name="fid")]


def build_trainer(args: argparse.Namespace, feeders: Optional[list] = None):
    """(trainer, total_examples) for parsed ``args``; ``feeders`` default to
    :func:`entry_point_feeders`."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device")
    set_float32_precision()
    hparams = BlurredWGANGPHyperParameters.from_args(args)
    hparams.global_batch_size = hparams.batch_size  # one device
    config = TrainingConfig.from_args(args)
    if args.run_name:
        config.log_dir = create_result_subdir("results", args.run_name)
        config.checkpoint_dir = ""
    dataset = load_celeba(path=args.celeba_path, resolution=args.resolution,
                          num_examples=args.num_examples)
    total_examples = dataset.num_examples * args.epochs
    gan = GAN(celeba_generator(args.resolution, upsample=args.gen_upsample),
              celeba_discriminator(args.resolution), blurred=True)
    blur_ctrl = adaptive = None
    if args.adaptive:
        adaptive = AdaptiveBlurController(max_value=args.max_blur_std)
    else:
        blur_ctrl = BlurDecayController(total_n_training_examples=total_examples,
                                        max_value=args.max_blur_std)
    trainer = Trainer(
        gan, hparams, dataset, device=device,
        trainer_config=TrainerConfig(
            log_dir=config.log_dir,
            checkpoint_dir=config.checkpoint_dir,
            image_summaries_interval_batches=config.save_image_summaries_interval,
            sample_grid_every_n_examples=args.sample_grid_every,
            checkpoint_every_n_examples=args.checkpoint_every,
            device_fetch_timeout_s=args.fetch_timeout_s,
            seed=args.seed),
        blur_controller=blur_ctrl, adaptive_controller=adaptive,
        metric_feeders=(entry_point_feeders(args.inception_fid, device) if feeders is None
                        else feeders),
        config_sidecars={"hparams": hparams, "config": config})
    return trainer, total_examples


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    args = parse_args(argv)
    trainer, total_examples = build_trainer(args)
    print(f"[train_celeba] res={args.resolution} bs={trainer.hparams.global_batch_size} "
          f"device={trainer.device} dataset={trainer.dataset.name} "
          f"log_dir={trainer.cfg.log_dir}", flush=True)
    trainer.fit(total_examples=total_examples, max_steps=args.max_steps)
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
