"""The sched package's public names, as the JAX package's ``sched`` exports
them."""

from blurred_gan_tpu_torch.sched.blur import (
    ExponentialDecaySchedule,
    BlurDecayController,
    AdaptiveBlurController,
    AdaptiveBlurState,
)

__all__ = [
    "ExponentialDecaySchedule",
    "BlurDecayController",
    "AdaptiveBlurController",
    "AdaptiveBlurState",
]
