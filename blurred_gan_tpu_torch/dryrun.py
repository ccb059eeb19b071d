"""A data-parallel dry run on the CPU: N gloo processes against one process.

    python -m blurred_gan_tpu_torch.dryrun --n 2

The counterpart of the JAX package's multi-chip dry run. It spawns ``--n``
processes, each of which joins a gloo group on this machine and takes one
full train step (the critic step with the penalty's double backward, then
the generator step) at tiny shapes on its 1/N of a global batch, with dropout
on and the generator's BatchNorm over the global batch. This process then
takes the same step alone at the global batch, from the same weights, seed
and reals, and compares: the losses, every parameter and the BatchNorm
running statistics, at ``TOL``. The optimizer is SGD, whose update is the
gradient itself, so the parameters hold the summed gradients to account (an
Adam first step moves every parameter by about its learning rate whatever
the gradient's size). It prints a line per process and one of the losses,
and exits 1 if any array differs, 0 otherwise.
"""

from __future__ import annotations

import argparse
import datetime
import os
import socket
import sys
import tempfile
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step

LOCAL_BATCH, LATENT, RES, SIGMA, SEED = 2, 8, 16, 1.5, 0
TOL = dict(rtol=2e-4, atol=2e-5)
TIMEOUT_S = 120


def tiny_gan() -> GAN:
    """A 16x16x3 pair: the generator's three BatchNorm'd stages and the
    critic's two convolutions with dropout 0.3."""
    return GAN(DCGANGenerator(latent_size=LATENT, init_hw=(4, 4), init_features=32,
                              blocks=((32, 1), (16, 2), (8, 2)), out_channels=3),
               DCGANDiscriminator(channels=(8, 16), dropout_rate=0.3, in_channels=3,
                                  image_hw=(RES, RES)),
               latent_size=LATENT)


def one_step(global_bs: int, world: int, rank: int) -> Dict[str, np.ndarray]:
    """One step of process ``rank`` of ``world`` on its rows of a global
    batch of ``global_bs``: the step's metrics, the parameters and the
    BatchNorm buffers."""
    gan = tiny_gan()
    hp = BlurredWGANGPHyperParameters(batch_size=global_bs // world,
                                      global_batch_size=global_bs, optimizer="sgd",
                                      learning_rate=0.1)
    state = create_train_state(gan, hp, device="cpu", seed=SEED)
    reals = np.random.RandomState(SEED).randint(0, 256, (global_bs, RES, RES, 3)).astype(np.uint8)
    b = global_bs // world
    metrics, _ = make_train_step(gan, hp, seed=SEED)(
        state, torch.from_numpy(reals[rank * b:(rank + 1) * b]), SIGMA)
    out = {f"metric/{k}": v.numpy() for k, v in metrics.items()}
    for prefix, module in (("generator", state.generator), ("critic", state.discriminator)):
        for name, t in module.state_dict().items():
            out[f"{prefix}/{name}"] = t.detach().numpy().copy()
    return out


def _worker(rank: int, n: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)  # the processes share this machine's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=n, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **one_step(LOCAL_BATCH * n, n, rank))
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def compare(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]) -> Dict[str, float]:
    """{name: max |got - want|} of every array that is not within ``TOL``."""
    bad = {}
    for name, w in want.items():
        if not np.allclose(got[name], w, **TOL):
            bad[name] = float(np.max(np.abs(got[name] - w)))
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=2, help="processes in the gloo group")
    args = parser.parse_args(argv)
    if args.n < 2:
        parser.error("--n must be at least 2")
    with tempfile.TemporaryDirectory(prefix="dryrun_") as out_dir:
        torch.multiprocessing.start_processes(
            _worker, args=(args.n, _free_port(), out_dir), nprocs=args.n, join=True,
            start_method="spawn")
        ranks = [dict(np.load(os.path.join(out_dir, f"rank{r}.npz"))) for r in range(args.n)]
    want = one_step(LOCAL_BATCH * args.n, 1, 0)
    failed = False
    for r, got in enumerate(ranks):
        bad = compare(got, want)
        failed |= bool(bad)
        print(f"[dryrun] rank {r} of {args.n}: {len(want)} arrays against one process at "
              f"batch {LOCAL_BATCH * args.n}: "
              + ("all within rtol 2e-4 / atol 2e-5" if not bad else f"DIFFER {bad}"), flush=True)
    print(f"[dryrun] disc_loss {float(ranks[0]['metric/disc_loss']):+.6f} "
          f"(one process {float(want['metric/disc_loss']):+.6f}), "
          f"gen_loss {float(ranks[0]['metric/gen_loss']):+.6f} "
          f"(one process {float(want['metric/gen_loss']):+.6f})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
