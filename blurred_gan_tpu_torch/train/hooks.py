"""Example-count-triggered hooks for the host loop (copy of
``blurred_gan_tpu/train/hooks.py``).

Firing rule: after each batch, ``i = (samples_seen - starting_from) // period``;
the hook fires if ``i >= num_invocations``. So the very first batch fires an
offset-0 hook, and a negative ``starting_from`` pre-arms one (the metric
feeders' recording window). A period <= 0 never fires.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional


class EveryNExamples:
    """Fires ``fn(samples_seen, logs)`` approximately every ``n`` examples."""

    def __init__(self, n: int, fn: Callable[[int, Dict], None],
                 starting_from: int = 0, name: Optional[str] = None):
        self.period = int(n)
        self.fn = fn
        self.starting_from = int(starting_from)
        self.num_invocations = 0
        self.samples_seen = 0
        self.name = name or getattr(fn, "__name__", "hook")

    def after_step(self, batch_size: int, logs: Dict) -> bool:
        """Advance by one batch; returns True if the hook fired."""
        self.samples_seen += int(batch_size)
        if self.period <= 0 or self.samples_seen < self.starting_from:
            return False
        i = (self.samples_seen - self.starting_from) // self.period
        if i >= self.num_invocations:
            self.num_invocations += 1
            self.fn(self.samples_seen, logs)
            return True
        return False

    def restore(self, samples_seen: int) -> None:
        """Resume the hook's phase from a checkpointed example counter."""
        self.samples_seen = int(samples_seen)
        if self.period > 0 and self.samples_seen >= self.starting_from:
            self.num_invocations = (
                (self.samples_seen - self.starting_from) // self.period + 1)


class HookList:
    """A bag of :class:`EveryNExamples` hooks advanced together each step."""

    def __init__(self, hooks=()):
        self.hooks = list(hooks)

    def add(self, hook: EveryNExamples) -> "HookList":
        self.hooks.append(hook)
        return self

    def after_step(self, batch_size: int, logs: Dict) -> None:
        for h in self.hooks:
            h.after_step(batch_size, logs)

    def restore(self, samples_seen: int) -> None:
        for h in self.hooks:
            h.restore(samples_seen)
