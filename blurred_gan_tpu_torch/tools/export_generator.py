"""Export a trained generator checkpoint as a ``torch.export`` serving
artifact (see ``blurred_gan_tpu_torch/serving.py``; the port's counterpart of
the repo root's ``tools/export_generator.py``, whose ``--platforms`` is
``--device`` here: the device the artifact's tensors live on).

    python -m blurred_gan_tpu_torch.tools.export_generator --log_dir results/01-mnist \\
        --out generator.pt2
    python -m blurred_gan_tpu_torch.tools.export_generator --log_dir results/02-celeba \\
        --ema --out generator_ema.pt2

Each batch of ``--verify_batches`` goes through the written artifact and is
held against the live generator (rtol = atol = 1e-5). Serve it from any
process with torch, without this package:

    program = torch.export.load("generator.pt2")
    images = program.module()(latents)   # (B, latent_size) float32, any B >= 1
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import torch

from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.generate_samples import add_model_arguments, restore_run
from blurred_gan_tpu_torch.serving import export_generator, load_generator
from blurred_gan_tpu_torch.train.step import make_sample_fn
from blurred_gan_tpu_torch.utils.rundir import resolve_model_identity

VERIFY_TOL = dict(rtol=1e-5, atol=1e-5)
VERIFY_SEED = 123


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_arguments(parser)
    parser.add_argument("--out", required=True, help="output artifact path")
    parser.add_argument("--ema", action="store_true",
                        help="bake the EMA generator weights")
    parser.add_argument("--verify_batches", default="1,7",
                        help="batch sizes round-tripped through the artifact "
                             "against the live generator ('' skips)")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    device = setup_device(args.device)
    args.dataset, args.resolution = resolve_model_identity(
        args.log_dir, args.dataset, args.resolution)
    gan, state, step = restore_run(args.log_dir, args.dataset, args.resolution, device)
    print(f"restored checkpoint @ {step} examples")

    blob = export_generator(gan, state, use_ema=args.ema, device=device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"wrote {args.out} ({len(blob) / 1e6:.2f} MB, device={device}, "
          f"weights={'ema' if args.ema else 'live'})")

    batches = [int(b) for b in args.verify_batches.split(",") if b]
    if batches:
        serve = load_generator(args.out)
        sample = make_sample_fn(gan, use_ema=args.ema)
        for bsz in batches:
            z = gan.sample_latents(bsz, torch.Generator().manual_seed(VERIFY_SEED),
                                   "cpu").to(device)
            got = serve(z)
            torch.testing.assert_close(got, sample(state, z), **VERIFY_TOL)
            print(f"verified batch {bsz}: artifact == live generator "
                  f"(shape {tuple(got.shape)})")


if __name__ == "__main__":
    main()
