"""The blur-σ controllers (copy of ``blurred_gan_tpu/sched/blur.py``).

σ is a host-side float fed to the train step every batch; nothing here touches
a device. Two controllers, with the reference's names:

- :class:`BlurDecayController`: open-loop exponential decay evaluated at the
  batch counter;
- :class:`AdaptiveBlurController`: closed loop on the critic's smoothed
  fake/(real+fake) score ratio, a pure transition function over an immutable
  :class:`AdaptiveBlurState` that checkpoints as a dict.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Dict, Tuple


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


@dataclass(frozen=True)
class AdaptiveBlurState:
    """Immutable controller state threaded by the host loop (checkpointable)."""

    std: float
    score_ratio: float = 0.5
    last_modification_batch: int = 0
    stop_training: bool = False


@dataclass(frozen=True)
class AdaptiveBlurController:
    """Closed-loop σ controller, as a pure transition function.

    Per batch: ``ratio = fake/(real+fake)`` from that batch's mean scores;
    ``score_ratio <- smoothing*score_ratio + (1-smoothing)*ratio``. After
    ``warmup_n_batches``, if the smoothed ratio is within ``0.5 ± threshold``
    the critic is not discriminating, so σ is multiplied by ``smoothing``, at
    most once every ``delay_between_modifications`` batches. Once σ falls below
    ``min_value`` the state's ``stop_training`` flag is raised.
    ``apply_changes=False`` only logs what it would do.
    """

    smoothing: float = 0.99
    warmup_n_batches: int = 100
    threshold: float = 0.05
    min_value: float = 0.01
    max_value: float = 23.5
    delay_between_modifications: int = 100
    apply_changes: bool = True

    def init(self) -> AdaptiveBlurState:
        return AdaptiveBlurState(std=float(self.max_value))

    def problem_is_stable(self, score_ratio: float) -> bool:
        return (0.5 - self.threshold) <= score_ratio <= (0.5 + self.threshold)

    def update(self, state: AdaptiveBlurState, batch: int, fake_scores: float,
               real_scores: float) -> Tuple[AdaptiveBlurState, Dict[str, float]]:
        """One transition. ``fake_scores``/``real_scores`` are the batch means of
        the step that just finished; the returned ``state.std`` is the σ for
        the *next* step."""
        fake_scores = float(fake_scores)
        real_scores = float(real_scores)
        denom = real_scores + fake_scores
        ratio = fake_scores / denom if denom != 0.0 else 0.5
        smoothed = self.smoothing * state.score_ratio + (1 - self.smoothing) * ratio
        state = replace(state, score_ratio=smoothed)
        telemetry = {"blur_controller/ratio": ratio,
                     "blur_controller/smoothed_ratio": smoothed}
        if batch < self.warmup_n_batches:
            return state, telemetry

        stable = self.problem_is_stable(smoothed)
        telemetry["blur_controller/stable"] = float(stable)
        if stable:
            if batch - state.last_modification_batch >= self.delay_between_modifications:
                telemetry["blur_controller/would_modify"] = 1.0
                state = replace(
                    state,
                    std=self.smoothing * state.std if self.apply_changes else state.std,
                    last_modification_batch=batch)
            else:
                telemetry["blur_controller/would_modify"] = 0.0

        if state.std < self.min_value:
            state = replace(state, stop_training=True)
        telemetry["blur_controller/std"] = state.std
        return state, telemetry

    @staticmethod
    def state_to_dict(state: AdaptiveBlurState) -> Dict:
        return dataclasses.asdict(state)

    @staticmethod
    def state_from_dict(d: Dict) -> AdaptiveBlurState:
        return AdaptiveBlurState(**d)
