"""Run configuration and hyperparameter dataclasses (copy of
``blurred_gan_tpu/train/config.py``).

Copied rather than imported because importing the JAX package's ``train``
subpackage loads jax. Same classes, fields and defaults; flags and JSON
sidecars through the mixins of ``utils.config``. Every field is implemented
(``train/step.py``, ``train/state.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

from blurred_gan_tpu_torch.utils.config import JsonSerializable, ParseableFromCommandLine


@dataclass
class TrainingConfig(JsonSerializable, ParseableFromCommandLine):
    """Run-level configuration."""

    log_dir: str = "results/log"
    checkpoint_dir: str = ""  # empty -> <log_dir>/checkpoints
    save_image_summaries_interval: int = 50


@dataclass
class WGANHyperParameters(JsonSerializable, ParseableFromCommandLine):
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
