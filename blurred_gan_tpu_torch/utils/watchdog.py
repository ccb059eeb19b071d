"""Device-hang watchdog: bounded-time device-to-host copies (port of
``blurred_gan_tpu/utils/watchdog.py``).

``fetch(x, timeout_s, what=)`` copies a tensor to the host in a daemon thread
and joins it with a deadline; past it, it raises :class:`DeviceHangError`. The
thread cannot be cancelled and is abandoned. After the error the process
should exit and resume from its latest checkpoint: saving would read from the
same wedged device. With ``timeout_s`` falsy the copy runs directly on the
calling thread.

``ready``: a CUDA event recorded after an asynchronous copy of ``x`` into
host memory (``x.to("cpu", non_blocking=True)``); the fetch then waits for
that event instead of making a copy of its own, so a copy issued right after
a step waits for that step only, not for steps enqueued after it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch


class DeviceHangError(RuntimeError):
    """A device fetch exceeded its watchdog deadline."""


def _materialize(x: torch.Tensor, ready) -> np.ndarray:
    """The blocking operation, isolated so tests can stub it."""
    if ready is not None:
        ready.synchronize()
    return x.detach().cpu().numpy()


def fetch(x: torch.Tensor, timeout_s: Optional[float] = None, *,
          what: str = "device fetch", ready=None) -> np.ndarray:
    """``x`` as a numpy array, copied to the host within ``timeout_s``
    seconds (``None``/0: no deadline)."""
    if not timeout_s or timeout_s <= 0:
        return _materialize(x, ready)

    result: list = []
    error: list = []

    def _run() -> None:
        try:
            result.append(_materialize(x, ready))
        except Exception as e:  # noqa: BLE001 — re-raised on the caller
            error.append(e)

    worker = threading.Thread(target=_run, daemon=True, name=f"fetch-watchdog[{what}]")
    worker.start()
    worker.join(timeout_s)
    if worker.is_alive():
        raise DeviceHangError(
            f"{what} did not complete within {timeout_s:.0f}s - the device is "
            "likely wedged, not merely slow. The fetch thread is abandoned; do "
            "NOT checkpoint from this process (saving would read from the same "
            "device). Restart and resume from the latest checkpoint.")
    if error:
        raise error[0]
    return result[0]
