"""Device traces and an images/s meter (port of ``blurred_gan_tpu/utils/profiling.py``).

- :func:`trace`: ``torch.profiler`` over a block, written as a Chrome trace
  (``trace.json`` under ``log_dir``) that Perfetto and TensorBoard's
  profile plugin read;
- :class:`StepTimer`: images/s that synchronises the card only when a reading
  is taken, not every step.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(log_dir: str, *, file_name: str = "trace.json"):
    """Profile the enclosed block on the host and, where there is one, on the
    card; yields the profiler (``key_averages()`` for sums by kernel) and
    writes ``log_dir/file_name`` when the block ends::

        with profiling.trace(log_dir):
            for _ in range(10):
                metrics, _ = step(state, reals, sigma)
            torch.cuda.synchronize()
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, file_name))


class StepTimer:
    """Images/s of an asynchronous training loop.

    ``tick(batch_size)`` each step is O(1); ``rate(sync=...)`` returns the
    images/s since the previous reading (None before any image). With
    ``sync`` (a tensor or a dict of them, typically the latest step's
    metrics), the reading first waits for the card that holds them, so it
    counts finished work rather than the launch queue.
    """

    def __init__(self):
        self._t = time.perf_counter()
        self._images = 0

    def tick(self, batch_size: int) -> None:
        self._images += int(batch_size)

    def rate(self, sync=None) -> Optional[float]:
        if sync is not None:
            tensors = sync.values() if isinstance(sync, dict) else [sync]
            for device in {t.device for t in tensors if t.device.type == "cuda"}:
                torch.cuda.synchronize(device)
        now = time.perf_counter()
        dt = now - self._t
        if dt <= 0 or self._images == 0:
            return None
        r = self._images / dt
        self._t = now
        self._images = 0
        return r
