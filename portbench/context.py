"""What a traffic kind is given (:class:`Context`) and what it returns
(:class:`Outcome`)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from portbench.checks import Checks
from portbench.trace import Trace


@dataclass
class Context:
    cell: dict                 # the cell's file; its configuration under "config"
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    process_start: float       # time.perf_counter() as the process started
    timeline: List[Tuple[str, float]] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)   # printed on standard error

    @property
    def config(self) -> dict:
        return self.cell["config"]

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def phase(self, name: str) -> None:
        """Mark the end of a phase of the run (printed on standard error)."""
        self.timeline.append((name, time.perf_counter()))

    def phase_lines(self) -> List[str]:
        out, at = [], self.process_start
        for name, t in self.timeline:
            out.append(f"phase {name}: {t - at:.3f} s")
            at = t
        return out + self.notes

    def checks(self) -> Checks:
        return Checks(self.cell["limits"])


@dataclass
class Outcome:
    setup_s: float                         # process start to the window's start
    metrics: Dict[str, float]              # the cell's end-to-end metrics but setup_s
    attempted: int
    failed: int
    checks: Checks
    memory_peak_bytes: int
    trace: Optional[Trace] = None
    facts: Dict[str, float] = field(default_factory=dict)  # counts the readers use
