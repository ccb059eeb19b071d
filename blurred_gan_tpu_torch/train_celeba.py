"""Train the blurred WGAN-GP on CelebA with PyTorch on a CUDA GPU.

The port's counterpart of the repo root's ``train_celeba.py``, with the flags
the port supports so far. Runs float32 with TF32 off in both matmuls and cuDNN
convolutions. Data comes from a local CelebA directory or, without one, the
deterministic synthetic 128x128x3 corpus.

    python -m blurred_gan_tpu_torch.train_celeba --max_steps 10
    python -m blurred_gan_tpu_torch.train_celeba --resolution 64 --device cpu --max_steps 3
"""

from __future__ import annotations

import argparse

import torch

EPOCHS = 10  # the JAX entry point's default; sets the σ decay horizon


def set_float32_precision() -> None:
    """True float32 everywhere: no TF32 in matmuls or cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build_trainer(args):
    from blurred_gan_tpu_torch.data.pipeline import load_celeba
    from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
    from blurred_gan_tpu_torch.sched.blur import BlurDecayController
    from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
    from blurred_gan_tpu_torch.train.loop import Trainer
    from blurred_gan_tpu_torch.train.state import GAN

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda, but torch finds no CUDA device")
    set_float32_precision()
    hparams = BlurredWGANGPHyperParameters(batch_size=args.batch_size,
                                           global_batch_size=args.batch_size)
    dataset = load_celeba(resolution=args.resolution, num_examples=args.num_examples)
    gan = GAN(celeba_generator(args.resolution, upsample=args.gen_upsample),
              celeba_discriminator(args.resolution), blurred=True)
    total_examples = dataset.num_examples * EPOCHS
    ctrl = BlurDecayController(total_n_training_examples=total_examples,
                               max_value=args.max_blur_std)
    trainer = Trainer(gan, hparams, dataset, device=device, seed=args.seed,
                      log_dir=args.log_dir, blur_controller=ctrl)
    return trainer, total_examples


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--resolution", type=int, default=128,
                        choices=[8, 16, 32, 64, 128, 256, 512])
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--max_blur_std", type=float, default=5.0, help="sigma_0")
    parser.add_argument("--num_examples", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gen_upsample", default="transpose",
                        choices=["transpose", "resize"])
    parser.add_argument("--log_dir", type=str, default="results/torch_log")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    trainer, total_examples = build_trainer(args)
    print(f"[train_celeba] res={args.resolution} bs={args.batch_size} "
          f"device={trainer.device} dataset={trainer.dataset.name}", flush=True)
    return trainer.fit(total_examples=total_examples, max_steps=args.max_steps)


if __name__ == "__main__":
    main()
