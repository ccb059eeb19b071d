"""The open-loop blur-σ schedule (copy of ``blurred_gan_tpu/sched/blur.py``).

σ is a host-side float fed to the train step every batch; nothing here touches
a device. Only the open-loop controller is copied so far: the adaptive
controller comes with the device-resident chunked mode (ROADMAP queue 1,
item 8). The names are the reference's, so its counterpart is easy to find.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ExponentialDecaySchedule:
    """``value(step) = initial * rate^(step / decay_steps)``, continuous, as
    ``tf.keras.optimizers.schedules.ExponentialDecay`` without ``staircase``.
    """

    initial_value: float
    decay_steps: float
    decay_rate: float = 0.96

    def __call__(self, step) -> float:
        p = float(step) / float(self.decay_steps)
        return self.initial_value * (self.decay_rate ** p)


@dataclass
class BlurDecayController:
    """Open-loop σ schedule evaluated at the batch counter.

    ``ExponentialDecay(max_value, decay_steps=total_examples/10, rate=0.96)``
    evaluated at the pre-step batch counter: σ decays per *batch* with a period
    derived from *examples*, as in the reference. ``min_value`` floors it.
    """

    total_n_training_examples: int
    max_value: float = 23.5
    min_value: float = 0.01

    def __post_init__(self):
        self.schedule = ExponentialDecaySchedule(
            initial_value=float(self.max_value),
            decay_steps=self.total_n_training_examples / 10,
            decay_rate=0.96,
        )

    def sigma(self, n_batches) -> float:
        """σ to feed the train step whose pre-step batch counter is ``n_batches``."""
        return max(self.schedule(n_batches), self.min_value)
