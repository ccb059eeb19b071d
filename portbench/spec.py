"""Where the benchmark's files are, found by name under a checkout's root:

- ``BENCHMARK.json``: the cells, metrics and bounds;
- ``portbench/configs/<config>.json``: a configuration's sizes, dtype,
  schedule, corpus, ``reduced`` and ``assumed``;
- ``portbench/workloads/<cell>.json``: a cell's configuration, traffic kind
  and its parameters, chips, the limits of its correctness check, and why;
- ``portbench/traffic/<kind>.py``: a traffic kind, ``run(ctx) -> Outcome``;
- ``portbench/metrics/<metric>.py``: a per-layer metric,
  ``read(ctx) -> float | None``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

DEFAULT_ROOT = Path(__file__).resolve().parents[1]
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def check_name(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Spec:
    """The benchmark's files under ``root``."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else DEFAULT_ROOT
        self.dir = self.root / "portbench"

    def _json(self, path: Path) -> dict:
        with open(path) as f:
            return json.load(f)

    def benchmark(self) -> dict:
        return self._json(self.root / "BENCHMARK.json")

    def config(self, name: str) -> dict:
        return dict(self._json(self.dir / "configs" / f"{check_name(name)}.json"), name=name)

    def cell(self, name: str) -> dict:
        """The cell's file, with its configuration loaded under ``config``."""
        cell = dict(self._json(self.dir / "workloads" / f"{check_name(name)}.json"), name=name)
        cell["config"] = self.config(cell["config"])
        return cell

    def _module(self, kind: str, name: str) -> ModuleType:
        path = self.dir / kind / f"{check_name(name)}.py"
        if not path.is_file():
            raise FileNotFoundError(path)
        spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def traffic(self, kind: str) -> ModuleType:
        return self._module("traffic", kind)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def cell_metrics(self, cell: str):
        """``(end_to_end, per_layer)``: the entries of ``BENCHMARK.json``
        that the cell reports. An end-to-end metric without ``workloads`` is
        every cell's; a per-layer one without it is every cell's that
        reports the metric it moves."""
        bench = self.benchmark()
        e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
        names = {m["name"] for m in e2e}
        per_layer = [m for m in bench["per_layer"]
                     if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
        return e2e, per_layer
