"""Score a run directory's latest checkpoint: SWD and FID between dataset
reals and fresh generator samples, through ``Trainer.evaluate`` (the port's
counterpart of the repo root's ``tools/evaluate_run.py``).

    python -m blurred_gan_tpu_torch.tools.evaluate_run --log_dir results/02-celeba \\
        [--num_samples 1000] [--inception] [--ema]

Prints one JSON object: the per-level SWD, its average and FID (random-conv
features, or InceptionV3's pool3 with ``--inception``), rounded to 4
places, and ``examples_seen``. The run's manifest is read, never written.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from blurred_gan_tpu_torch.data.pipeline import load_celeba, load_mnist
from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.generate_samples import add_model_arguments, restore_error, run_gan
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.inception import inception_feature_fn
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.train.checkpoint import load_sidecar
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.utils.rundir import resolve_model_identity


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="score a run dir's latest checkpoint (SWD + FID)")
    add_model_arguments(parser)
    parser.add_argument("--data_path", type=str, default=None,
                        help="dataset location (defaults to the standard search "
                             "paths; synthetic fallback if absent)")
    parser.add_argument("--num_samples", type=int, default=1000)
    parser.add_argument("--seed", type=int, default=1234)
    parser.add_argument("--inception", action="store_true",
                        help="FID on the InceptionV3 pool3 trunk")
    parser.add_argument("--ema", action="store_true",
                        help="sample from the EMA generator weights")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Print the scores' JSON line; returns it as a dict."""
    args = build_parser().parse_args(argv)
    device = setup_device(args.device)
    args.dataset, args.resolution = resolve_model_identity(
        args.log_dir, args.dataset, args.resolution)
    gan = run_gan(args.dataset, args.resolution)
    if args.dataset == "mnist":
        dataset = load_mnist(path=args.data_path)
    else:
        dataset = load_celeba(path=args.data_path, resolution=args.resolution)

    hp = (load_sidecar(args.log_dir, BlurredWGANGPHyperParameters, "hyper_parameters.json")
          or BlurredWGANGPHyperParameters())
    try:
        tr = Trainer(gan, hp, dataset, device=device,
                     trainer_config=TrainerConfig(
                         log_dir=args.log_dir,
                         sample_grid_every_n_examples=0,
                         checkpoint_every_n_examples=0,
                         image_summaries_interval_batches=0,
                         sample_with_ema=args.ema))
    except (RuntimeError, ValueError, KeyError) as e:
        raise restore_error(args.dataset, args.resolution, e) from e
    if tr.restored_examples == 0:
        raise SystemExit(f"no checkpoint under {args.log_dir}/checkpoints")
    if args.ema and tr.state.g_ema is None:
        raise SystemExit("--ema: this run has no EMA weights "
                         "(train with --ema_decay > 0)")

    fid = (FIDMetric(feature_fn=inception_feature_fn(device=device)) if args.inception
           else FIDMetric())
    out = tr.evaluate(num_samples=args.num_samples, metrics=[SWDMetric(), fid],
                      seed=args.seed)
    out = {k: round(float(v), 4) for k, v in out.items()}
    out["examples_seen"] = int(tr.restored_examples)
    tr.close()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
