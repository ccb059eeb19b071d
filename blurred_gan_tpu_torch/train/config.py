"""Hyperparameter dataclasses (copy of ``blurred_gan_tpu/train/config.py``).

Copied rather than imported because importing the JAX package's ``train``
subpackage loads jax. Same classes, fields and defaults, and the JSON sidecar
writer; the command line declares its flags itself. The step accepts the default values of the fields the port does
not implement yet and raises on any other (``train/step.py``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict


class JsonSerializable:
    """JSON round-trip for config dataclasses."""

    def asdict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def save_json(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            json.dump(self.asdict(), f, indent=1)


@dataclass
class WGANHyperParameters(JsonSerializable):
    learning_rate: float = 0.001
    g_learning_rate: float = 0.0  # TTUR; 0.0 shares learning_rate
    d_steps_per_g_step: int = 1
    batch_size: int = 32           # per replica
    global_batch_size: int = 32    # batch_size * num replicas
    optimizer: str = "adam"
    ema_decay: float = 0.0
    grad_accumulation_steps: int = 1
    flip_augment: bool = False


@dataclass
class WGANGPHyperParameters(WGANHyperParameters):
    e_drift: float = 1e-4
    gp_coefficient: float = 10.0
    reference_grad_scale: bool = False
    gp_every_n_steps: int = 1


@dataclass
class BlurredWGANGPHyperParameters(WGANGPHyperParameters):
    initial_blur_std: float = 0.05
