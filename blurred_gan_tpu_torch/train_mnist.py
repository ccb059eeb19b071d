"""Train the blurred WGAN-GP on MNIST 28x28 with PyTorch on a CUDA GPU.

The port's counterpart of the repo root's ``train_mnist.py``, float32: the
MNIST DCGAN pair, σ decaying open-loop from ``--initial_blur_std`` over
``--epochs`` (or the closed-loop controller with ``--adaptive``, from
``--initial_blur_std`` if it is above 1, else from 23.5), SWD (1000 samples)
and FID (100 samples) every 50,000 examples, a sample grid every 5,000, a
checkpoint every 10,000 and on SIGINT / SIGTERM, and an automatic resume from
the latest checkpoint in the run directory. Data comes from a local
``mnist.npz`` or, without one, the deterministic synthetic 28x28x1 corpus.
``--device_resident`` parks the dataset on the card and trains in chunks of
``--chunk_steps`` steps, each a replay of the captured train step.

    python -m blurred_gan_tpu_torch.train_mnist --epochs 10
    python -m blurred_gan_tpu_torch.train_mnist --device_resident --adaptive
    python -m blurred_gan_tpu_torch.train_mnist --device cpu --max_steps 3 --log_dir /tmp/mnist
    python -m torch.distributed.run --nproc_per_node 2 -m blurred_gan_tpu_torch.train_mnist

The last trains data-parallel, one process per card (``--batch_size`` each;
``--device cpu`` runs the processes on the CPU over gloo).
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from blurred_gan_tpu_torch.data.pipeline import load_mnist
from blurred_gan_tpu_torch.entry import (
    add_common_arguments, entry_point_feeders, make_trainer, run, setup, shutdown, start_line)
from blurred_gan_tpu_torch.models.dcgan import mnist_discriminator, mnist_generator
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train.loop import Trainer
from blurred_gan_tpu_torch.train.state import GAN

# The adaptive controller's σ₀ when --initial_blur_std is 1 or less.
ADAPTIVE_DEFAULT_MAX = 23.5


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_arguments(parser)
    parser.add_argument("--mnist_path", type=str, default=None)
    return parser


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def build_trainer(args: argparse.Namespace, feeders: Optional[list] = None):
    """(trainer, total_examples) for parsed ``args``; ``feeders`` default to
    the entry point's SWD and FID."""
    device, hparams, config = setup(args)
    dataset = load_mnist(path=args.mnist_path)
    total_examples = dataset.num_examples * args.epochs
    gan = GAN(mnist_generator(), mnist_discriminator(), blurred=True)
    blur_ctrl = adaptive = None
    if args.adaptive:
        adaptive = AdaptiveBlurController(
            max_value=hparams.initial_blur_std if hparams.initial_blur_std > 1
            else ADAPTIVE_DEFAULT_MAX)
    else:
        blur_ctrl = BlurDecayController(total_n_training_examples=total_examples,
                                        max_value=hparams.initial_blur_std)
    trainer = make_trainer(
        args, device, hparams, config, dataset, gan,
        blur_controller=blur_ctrl, adaptive_controller=adaptive,
        feeders=entry_point_feeders(args.inception_fid, device) if feeders is None else feeders)
    return trainer, total_examples


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    args = parse_args(argv)
    trainer, total_examples = build_trainer(args)
    start_line("train_mnist", trainer, bs=trainer.hparams.batch_size, device=trainer.device,
               dataset=trainer.dataset.name, total_examples=total_examples,
               log_dir=trainer.cfg.log_dir)
    run(trainer, args, total_examples, "train_mnist")
    trainer.close()
    shutdown()
    return trainer


if __name__ == "__main__":
    main()
