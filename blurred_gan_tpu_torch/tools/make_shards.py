"""Convert a directory of images (or an ``mnist.npz``) into a memory-mappable
``shard-*.npy`` store (the port's counterpart of the repo root's
``tools/make_shards.py``).

    python -m blurred_gan_tpu_torch.tools.make_shards <image_dir> <out_dir> \\
        [--resolution 128] [--shard_size 4096] [--num_examples N]

Images are decoded once (the native loader, or Pillow where it does not
build), centre-cropped and resized, one shard at a time, so the conversion
runs in bounded memory. Training then reads the store with no decoding:
``--celeba_path <out_dir>``, or ``$DATASETS_DIR/celeba_shards_<res>``, which
``load_celeba`` finds by itself.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from blurred_gan_tpu_torch.data.pipeline import (
    ArrayDataset, ImageFolderDataset, load_mnist, write_shards)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("source", help="directory of images, or an mnist.npz")
    parser.add_argument("out_dir", help="empty output directory for shard-*.npy")
    # None = unset: an image directory defaults to 128 below, and an explicit
    # value other than 28 is refused for mnist.npz (argparse also accepts a
    # prefix such as --res, so the flag is never sniffed from argv).
    parser.add_argument("--resolution", type=int, default=None,
                        help="centre-crop + resize target for image dirs "
                             "(default 128; unsupported for mnist.npz)")
    parser.add_argument("--shard_size", type=int, default=4096,
                        help="examples per shard file")
    parser.add_argument("--num_examples", type=int, default=None,
                        help="cap the number of source images")
    return parser


def main(argv: Optional[Sequence[str]] = None):
    """Write the store; returns it as a ``ShardedArrayDataset``."""
    args = build_parser().parse_args(argv)
    if os.path.isdir(args.source):
        src = ImageFolderDataset(args.source,
                                 128 if args.resolution is None else args.resolution,
                                 num_examples=args.num_examples)
    elif args.source.endswith(".npz"):
        if args.resolution is not None and args.resolution != 28:
            raise SystemExit(
                f"--resolution {args.resolution} is unsupported for mnist.npz sources "
                f"(images are stored at their native 28x28); omit the flag")
        src = load_mnist(args.source, allow_synthetic_fallback=False)
        if args.num_examples:
            src = ArrayDataset(src.images[:args.num_examples], name=src.name)
    else:
        raise SystemExit(f"unsupported source: {args.source}")

    ds = write_shards(src, args.out_dir, shard_size=args.shard_size)
    print(f"[make_shards] wrote {ds.num_examples} examples "
          f"({ds.image_shape[0]}x{ds.image_shape[1]}x{ds.image_shape[2]}) "
          f"to {args.out_dir}")
    return ds


if __name__ == "__main__":
    main()
