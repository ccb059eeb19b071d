"""The numbers that decide ``correct``: gaps between what the program
produced and what the plain reference computes from the same inputs, each
held to a limit from the cell's file; a number the file gives no limit is
printed as a reading and not compared.

A gap of norms is taken leaf by leaf: ``|‖p‖ − ‖r‖|`` over the reference's
norm of that leaf or of its network's median leaf, whichever is larger (some
leaves' gradients are all but zero), and the worst leaf is the number.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              leaves: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Every leaf's gap (names ``<network>/<name>``); the median leaf is
    its network's."""
    leaves = list(reference if leaves is None else leaves)
    medians = {net: statistics.median(v for k, v in reference.items()
                                      if k.startswith(net + "/"))
               for net in {k.split("/", 1)[0] for k in reference}}
    out = {}
    for k in leaves:
        scale = max(reference[k], medians[k.split("/", 1)[0]])
        gap = abs(program[k] - reference[k]) / scale if scale > 0 else math.inf
        out[k] = gap if math.isfinite(program[k]) else math.inf
    return out


def moved_leaves(reference_grads: Dict[str, float], share: float = 1e-3) -> List[str]:
    """The leaves whose reference gradient is more than ``share`` of their
    network's median leaf: the others move under Adam by round-off alone."""
    out = []
    for net in {k.split("/", 1)[0] for k in reference_grads}:
        mine = {k: v for k, v in reference_grads.items() if k.startswith(net + "/")}
        median = statistics.median(mine.values())
        out += [k for k, v in mine.items() if v > share * median]
    return sorted(out)


class Checks:
    """Named numbers with their limits, in the order they were added."""

    def __init__(self, limits: Dict[str, float]):
        self.limits = limits
        self.values: Dict[str, float] = {}
        self.notes: Dict[str, str] = {}
        self.readings: Dict[str, Tuple[float, str]] = {}

    def add(self, name: str, value: float, note: str = "") -> None:
        """A number; one without a limit in the cell's file is read and
        printed but not compared (``readings``)."""
        if name not in self.limits:
            self.readings[name] = (float(value), note)
            return
        self.values[name] = float(value)
        if note:
            self.notes[name] = note

    def fail(self, name: str, why: str) -> None:
        """A number that could not be read: it fails."""
        self.values[name] = math.inf
        self.notes[name] = why

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits)
                and all(v <= self.limits[k] for k, v in self.values.items()))

    def as_dict(self) -> Dict[str, dict]:
        out = {}
        for k in self.limits:
            v = self.values.get(k, math.inf)
            out[k] = {"value": v if math.isfinite(v) else None, "limit": self.limits[k]}
            if k in self.notes:
                out[k]["at"] = self.notes[k]
        return out

    def lines(self) -> List[str]:
        read = [f"reading {k}: {v:.6g} (not compared" + (f"; {n})" if n else ")")
                for k, (v, n) in self.readings.items()]
        return read + [f"check {k}: {self.values.get(k, math.inf):.6g} limit {self.limits[k]:.6g}"
                       + (f" ({self.notes[k]})" if k in self.notes else "") for k in self.limits]
