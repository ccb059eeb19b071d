"""Data parallelism over the default process group (port of the data-parallel
part of ``blurred_gan_tpu/parallel.py``).

The JAX package shards the global batch over a mesh's ``data`` axis and lets
XLA insert the reductions. Here each process holds 1/N of the global batch
and a whole replica of the state, and the step reduces explicitly:

- :func:`all_reduce_grads` sums each network's gradients over the processes
  in one flat buffer. The losses are ``sum(...) / global_batch_size`` and the
  batch means carry each process's share (``losses/wgan.py``), so the sum is
  the global batch's gradient. ``DistributedDataParallel`` is not used: the
  step takes its gradients with ``torch.autograd.grad``, which its reducer
  never sees (it hands back each process's own gradient), and its
  ``.backward()`` averages, which is the wrong scale for this contract.
- :func:`all_reduce_metrics` makes the step's scalars global: sums summed,
  means averaged.
- :func:`all_reduce_sum` is differentiable (its backward is the same
  all-reduce): the generator's cross-replica BatchNorm statistics.
- :func:`allgather` gathers a host array from every process, in rank order,
  for the metrics' cross-process merges.
- :func:`check_replicas_equal` compares a digest of every process's train
  state, so a run whose processes start apart fails at once.

Not ported: ``make_mesh``'s model axis and ``state_shardings`` (tensor
parallelism and FSDP). The CelebA-128 state, Adam moments included, is a
193.6 MB checkpoint, which one card holds whole.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from blurred_gan_tpu_torch.runtime import process_count, process_index

# Step metrics that are batch means (averaged over processes); the others
# that vary by process are sums, and "std" and "did_gen_step" are the same on
# every process.
MEAN_METRICS = ("fake_scores", "real_scores")
REPLICATED_METRICS = ("std", "did_gen_step")


def all_reduce_grads(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise sum of ``grads`` over the processes, through one
    flattened buffer and one all-reduce; ``grads`` as given with one process."""
    if process_count() == 1:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    return [part.view_as(g) for part, g in zip(flat.split([g.numel() for g in grads]), grads)]


def all_reduce_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The step's 0-d metrics over the global batch: one all-reduce of the
    stacked values, :data:`MEAN_METRICS` divided by the process count,
    :data:`REPLICATED_METRICS` left as they are."""
    world = process_count()
    if world == 1:
        return metrics
    names = sorted(k for k in metrics if k not in REPLICATED_METRICS)
    packed = torch.stack([metrics[k].to(torch.float32) for k in names])
    dist.all_reduce(packed, op=dist.ReduceOp.SUM)
    out = dict(metrics)
    for k, v in zip(names, packed.unbind()):
        out[k] = v / world if k in MEAN_METRICS else v
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes; its backward is the same sum of the incoming
    gradients (each process's loss depends on every process's input)."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the processes, differentiable: the gradient that
    flows back is summed over the processes too."""
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` concatenated along dim 0 in rank order (not
    differentiable)."""
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def allgather(x) -> List[np.ndarray]:
    """Every process's host array ``x``, in rank order; ``[x]`` with one process."""
    x = np.asarray(x)
    if process_count() == 1:
        return [x]
    out: List = [None] * process_count()
    dist.all_gather_object(out, x)
    return [np.asarray(a) for a in out]


def replica_rows(per: int, part: int) -> torch.Tensor:
    """This process's rows of a batch of two stacked parts of ``part`` rows
    each (the critic's ``cat([fakes, reals])``): ``per`` rows of each part,
    at its rank's offset."""
    start = process_index() * per
    return torch.cat([torch.arange(start, start + per),
                      torch.arange(part + start, part + start + per)])


def state_digest(state) -> str:
    """SHA-256 over a train state's counters, parameters, buffers, average
    and optimizer slots, in a fixed order."""
    h = hashlib.sha256(f"{state.n_img} {state.n_batches}".encode())
    tensors = [*state.generator.state_dict().values(),
               *state.discriminator.state_dict().values(), *(state.g_ema or [])]
    for opt in (state.g_opt, state.d_opt):
        for slots in opt.state_dict()["state"].values():
            tensors += [v for _, v in sorted(slots.items()) if torch.is_tensor(v)]
    for t in tensors:
        h.update(t.detach().to("cpu").reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def check_replicas_equal(state) -> None:
    """Raise ``RuntimeError`` unless every process holds the same train
    state, by :func:`state_digest`; a no-op with one process."""
    if process_count() == 1:
        return
    digests = allgather(np.frombuffer(bytes.fromhex(state_digest(state)), np.uint8))
    differ = [r for r, d in enumerate(digests) if not np.array_equal(d, digests[0])]
    if differ:
        raise RuntimeError(f"the train state of rank(s) {differ} differs from rank 0's: "
                           f"every process must start from the same state")
