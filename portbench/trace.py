"""The device trace of a ``--trace 1`` run and what is read from it.

``capture()`` runs ``torch.profiler`` over the host and the card and keeps,
as plain tuples ``(name, start_ns, end_ns)``, every device operation
(kernels, copies, sets), every host operation, and the benchmark's own
marks: ``record_function`` spans named ``portbench.*`` that the traffic
kinds open around their calls into the port (:func:`mark`). All share the
profiler's clock. A :class:`Trace` also reads and writes JSON, so readers
can be tested on a small stored one.
"""

from __future__ import annotations

import bisect
import contextlib
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

Op = Tuple[str, int, int]
MARK_PREFIX = "portbench."
WINDOW_START, WINDOW_END = "portbench.window_start", "portbench.window_end"


class Trace:
    def __init__(self, device_ops: List[Op], host_ops: List[Op], marks: List[Op]):
        self.device_ops = sorted(device_ops, key=lambda o: o[1])
        self.host_ops = sorted(host_ops, key=lambda o: o[1])
        self.marks = sorted(marks, key=lambda o: o[1])
        self._host_starts = [o[1] for o in self.host_ops]

    def marks_named(self, name: str) -> List[Op]:
        return [m for m in self.marks if m[0] == name]

    def window(self) -> Tuple[int, int]:
        """``(start_ns, end_ns)``: from the window's start mark to its end mark."""
        starts, ends = self.marks_named(WINDOW_START), self.marks_named(WINDOW_END)
        if not starts or not ends:
            raise ValueError("the trace holds no window marks")
        return starts[0][1], ends[-1][1]

    def window_ops(self) -> List[Op]:
        lo, hi = self.window()
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.device_ops if e > lo and s < hi]

    def busy_ns(self) -> int:
        """Nanoseconds of the window in which some device operation ran."""
        return sum(e - s for s, e in _union(self.window_ops()))

    def idle_gaps(self) -> List[Tuple[int, int]]:
        lo, hi = self.window()
        gaps, at = [], lo
        for s, e in _union(self.window_ops()):
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if hi > at:
            gaps.append((at, hi))
        return gaps

    def host_label(self, t: int, lookback: int = 5000) -> str:
        """The innermost host operation running at ``t``: of the operations
        that began before it, the latest that has not ended (host
        operations of one thread nest). Looks back over ``lookback`` of
        them at most."""
        i = bisect.bisect_right(self._host_starts, t)
        for op in reversed(self.host_ops[max(0, i - lookback):i]):
            if op[2] >= t:
                return op[0]
        return "host: no traced operation"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the window, and the
        idle time by what the host was doing, each summed by name."""
        by_op: Dict[str, int] = defaultdict(int)
        for n, s, e in self.window_ops():
            by_op[n] += e - s
        by_host: Dict[str, int] = defaultdict(int)
        for s, e in self.idle_gaps():
            by_host[self.host_label((s + e) // 2)] += e - s
        rank = lambda d: [[k, v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}

    def to_json(self) -> str:
        return json.dumps({"device_ops": self.device_ops, "host_ops": self.host_ops,
                           "marks": self.marks})

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        d = json.loads(text)
        return cls(*([tuple(o) for o in d[k]] for k in ("device_ops", "host_ops", "marks")))


def _union(ops) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def mark(name: str):
    """A ``portbench.<name>`` span in the trace (a no-op when none is taken)."""
    return torch.profiler.record_function(MARK_PREFIX + name)


def instant(name: str) -> None:
    """A zero-length ``portbench.<name>`` mark at this moment."""
    with mark(name):
        pass


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    return int(fn()) if fn is not None else int(getattr(e, f"{which}_us")() * 1000)


def _is_annotation(e) -> bool:
    fn = getattr(e, "is_user_annotation", None)
    return bool(fn()) if fn is not None else False


class Capture:
    """Holds the :class:`Trace` once the ``capture()`` block has ended."""

    trace: Optional[Trace] = None


@contextlib.contextmanager
def capture(enabled: bool = True):
    """Profile the block on the host and, where there is one, the card."""
    out = Capture()
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield out
    device, host, marks = [], [], []
    for e in prof.profiler.kineto_results.events():
        op = (e.name(), _ns(e, "start"), _ns(e, "end"))
        if e.device_type() != torch.autograd.DeviceType.CPU:
            # A span's shadow on the device's timeline is no device work.
            if not (op[0].startswith(MARK_PREFIX) or _is_annotation(e)):
                device.append(op)
        elif op[0].startswith(MARK_PREFIX):
            marks.append(op)
        else:
            host.append(op)
    out.trace = Trace(device, host, marks)
