"""Scalar, image and hyperparameter logging (port of ``blurred_gan_tpu/utils/logging.py``).

Every record goes to ``<log_dir>/events.jsonl``, one JSON object per line,
with ``"step"`` = images seen, so runs compare across batch sizes. TensorBoard
is an optional second sink, ``torch.utils.tensorboard``, used where it
imports (it needs the ``tensorboard`` package); images go only there, since
the sample-grid hook writes its own PNGs. A logger made with
``enabled=False`` writes nothing (a data-parallel run's processes other than
rank 0, so one ``events.jsonl`` holds the run).
"""

from __future__ import annotations

import json
import numbers
import os
import time
from typing import Dict

import numpy as np


def _summary_writer(log_dir: str):
    """torch's TensorBoard writer on ``log_dir``, or None where it does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        return None
    return SummaryWriter(log_dir)


class MetricsLogger:
    def __init__(self, log_dir: str, enabled: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.enabled = enabled
        self._jsonl = (open(os.path.join(log_dir, "events.jsonl"), "a", buffering=1)
                       if enabled else None)
        self._tb = _summary_writer(log_dir) if enabled else None

    def scalars(self, step: int, values: Dict[str, float], prefix: str = "") -> None:
        """One record of the real-valued entries of ``values``; others are dropped."""
        if not self.enabled:
            return
        clean = {prefix + k: float(v) for k, v in values.items()
                 if isinstance(v, numbers.Real)}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(), **clean}) + "\n")
        if self._tb is not None:
            for k, v in clean.items():
                self._tb.add_scalar(k, v, int(step))

    def image(self, step: int, tag: str, image_hwc_uint8: np.ndarray) -> None:
        """One HWC uint8 image (TensorBoard only)."""
        if self._tb is not None:
            self._tb.add_image(tag, image_hwc_uint8, int(step), dataformats="HWC")

    def hparams(self, hparams: Dict) -> None:
        if not self.enabled:
            return
        self._jsonl.write(json.dumps({"hparams": hparams}) + "\n")
        if self._tb is not None:
            self._tb.add_hparams({k: v for k, v in hparams.items()
                                  if isinstance(v, (int, float, str, bool))}, {})

    def text(self, step: int, tag: str, text: str) -> None:
        """One record ``{"step": step, tag: text}`` (and a TensorBoard text summary)."""
        if not self.enabled:
            return
        self._jsonl.write(json.dumps({"step": int(step), tag: text}) + "\n")
        if self._tb is not None:
            self._tb.add_text(tag, text, int(step))

    def flush(self) -> None:
        if not self.enabled:
            return
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
