"""Run one cell of ``BENCHMARK.json`` once and print its result as the last
line of standard output:

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the metrics are the cell's end-to-end ones, with
``--trace 1`` its per-layer ones (read by ``portbench/metrics/<name>.py``
from the profiler's trace of the window and the run's counts), and
``device`` then holds ``busy_s`` and ``window_s``. ``correct`` is decided by
the traffic kind's comparison with the plain reference; each number
compared is printed beside its limit, as the last lines of standard error
and as the result's last key, ``checks``.

A run measures on a CUDA card only: without one, or with fewer than the cell
asks for, it exits 2 and prints no result. It exits 1, printing no result,
if JAX or the JAX package was loaded by the time the window closed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import torch

from portbench.context import Context
from portbench.peaks import peak
from portbench.spec import Spec

# The host's cores are shared with other machines' work: one intra-op thread
# keeps the process's CPU work (weight initialisation, the hook replay, the
# copies to pageable memory) from waiting on preempted worker threads.
TORCH_THREADS = 1
# TensorBoard is kept out of a run's process, so the port's logger writes
# its events.jsonl alone, as on a machine without tensorboard installed: on
# the benchmark's H100 hosts its sink took 60-84 ms for each chunk's 32 log
# calls and set runs of the MNIST cell apart by 15 % (PERF.md). Each
# configuration's ``assumed`` and each training cell's ``why`` say so.
ABSENT_MODULES = ("tensorboard", "torch.utils.tensorboard")
# Top-level module names that no run may load (the JAX package is the
# reference of the port's tests, never measured).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "blurred_gan_tpu")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def quantity(name: str) -> str:
    """The quantity an end-to-end metric reports: its name up to the first
    dot (``train_img_s.mnist28`` is a cell's own ``train_img_s``, under a
    bound of its own)."""
    return name.split(".", 1)[0]


def forbidden_modules() -> list:
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


class Reader:
    """What a per-layer metric reads: the trace, the run's counts, the
    configuration and the card's peaks."""

    def __init__(self, outcome, config: dict, device_name: Optional[str]):
        self.trace = outcome.trace
        self.facts = outcome.facts
        self.config = config
        self.device_name = device_name

    def peak(self, what: str) -> Optional[float]:
        return peak(self.device_name, what)


def main(argv: Optional[Sequence[str]] = None, *, process_start: Optional[float] = None,
         root=None, device: Optional[str] = None) -> int:
    """``device`` (tests only) runs on that device without the card check;
    its result is no measurement of the card."""
    process_start = time.perf_counter() if process_start is None else process_start
    args = parse_args(argv)
    torch.set_num_threads(TORCH_THREADS)
    for name in ABSENT_MODULES:
        sys.modules.setdefault(name, None)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA card(s), "
                  f"found {found}; no result", file=sys.stderr)
            return 2
        device = "cuda"
    from portbench import port

    dev = port.device(device)
    traffic = spec.traffic(cell["traffic"])
    e2e, per_layer = spec.cell_metrics(args.workload)
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=dev, process_start=process_start)
    ctx.phase("imports")
    outcome = traffic.run(ctx)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}; no result", file=sys.stderr)
        return 1

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu", "kind": name,
                   "count": cell["chips"], "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    result = {"correct": outcome.checks.correct and outcome.failed == 0,
              "attempted": outcome.attempted, "failed": outcome.failed}
    if args.trace:
        reader = Reader(outcome, cell["config"], name if dev.type == "cuda" else None)
        metrics = {}
        for m in per_layer:
            value = spec.metric(m["name"]).read(reader)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        lo, hi = outcome.trace.window()
        device_info.update(busy_s=outcome.trace.busy_ns() / 1e9, window_s=(hi - lo) / 1e9)
        result.update(metrics=metrics, device=device_info, breakdown=outcome.trace.breakdown())
    else:
        values = dict(outcome.metrics, setup_s=outcome.setup_s)
        result.update(metrics={m["name"]: {"value": values[quantity(m["name"])],
                                           "unit": m["unit"]} for m in e2e},
                      device=device_info)
    result["checks"] = outcome.checks.as_dict()
    for line in ctx.phase_lines() + outcome.checks.lines():
        print(line, file=sys.stderr)
    print(json.dumps(result, allow_nan=False))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
