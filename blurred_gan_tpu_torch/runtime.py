"""The process group of a data-parallel run (port of ``blurred_gan_tpu/runtime.py``).

A run of N processes, each with 1/N of the global batch, is started by
``python -m torch.distributed.run --nproc_per_node N -m <entry point> ...``,
which sets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` in each process. ``BLURRED_GAN_MULTIHOST=1`` starts a group from
those variables too (the JAX package's trigger), for a launcher that sets
them itself.

The backend is ``nccl`` on a CUDA device and ``gloo`` on the CPU, unless the
caller names one; nothing falls back to another backend or device when the
group fails to start. :func:`process_count` and :func:`process_index` are the
seams the rest of the port reads the topology through: 1 and 0 without a
group.

Not ported: ``enable_fast_prng`` (it selects a TPU random-number generator).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# How long a collective waits for a rank that never arrives before it raises.
TIMEOUT = datetime.timedelta(minutes=10)


def local_device(name) -> torch.device:
    """The device of this process for a ``--device`` of ``name``: a bare
    ``cuda`` in a process started with ``LOCAL_RANK`` is ``cuda:<LOCAL_RANK>``;
    anything else, an indexed CUDA device included, is taken as given."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return device


def maybe_initialize_distributed(device, backend: Optional[str] = None) -> int:
    """Start the default process group when the environment asks for one
    (``WORLD_SIZE > 1``, set by ``torch.distributed.run``, or
    ``BLURRED_GAN_MULTIHOST=1``), on ``device`` (made the current CUDA device
    first) with ``backend`` (default: ``nccl`` for CUDA, ``gloo`` for the
    CPU), from the environment's ``env://`` variables, and return the process
    count. A no-op returning the count when a group is already up, and 1 when
    none is asked for."""
    if dist.is_initialized():
        return dist.get_world_size()
    if (int(os.environ.get("WORLD_SIZE", "1")) <= 1
            and os.environ.get("BLURRED_GAN_MULTIHOST") != "1"):
        return 1
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return dist.get_world_size()


def process_count() -> int:
    """Processes in the default group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
