"""The train package's public names, as the JAX package's ``train`` exports
them. Left out: ``make_chunked_train_fn``, whose place ``train.fast.ChunkRunner``
takes, and the wide counters (``wide_counter``, ``wide_add``, ``wide_value``),
an int32 guard that the port's Python-int counters do not need."""

from blurred_gan_tpu_torch.train.config import (
    TrainingConfig,
    WGANHyperParameters,
    WGANGPHyperParameters,
    BlurredWGANGPHyperParameters,
)
from blurred_gan_tpu_torch.train.state import TrainState, GAN, create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step, make_sample_fn
from blurred_gan_tpu_torch.train.hooks import EveryNExamples, HookList
from blurred_gan_tpu_torch.train.checkpoint import (
    CheckpointManager,
    save_on_interrupt,
    save_sidecars,
    load_sidecar,
)
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig, MetricFeeder
from blurred_gan_tpu_torch.train.fast import AdaptiveState, adaptive_update, chunk_indices

__all__ = [
    "EveryNExamples",
    "HookList",
    "CheckpointManager",
    "save_on_interrupt",
    "save_sidecars",
    "load_sidecar",
    "Trainer",
    "TrainerConfig",
    "MetricFeeder",
    "AdaptiveState",
    "adaptive_update",
    "chunk_indices",
    "TrainingConfig",
    "WGANHyperParameters",
    "WGANGPHyperParameters",
    "BlurredWGANGPHyperParameters",
    "TrainState",
    "GAN",
    "create_train_state",
    "make_train_step",
    "make_sample_fn",
]
