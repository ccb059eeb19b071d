"""The harness on the card (marked ``cuda``; skipped without one, decided
inside each test). On the chip:

    python -m pytest -p no:cacheprovider portbench/tests -m cuda -q
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.spec import Spec

pytestmark = pytest.mark.cuda
ROOT = Spec().root


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def bench(*args, timeout=600):
    out = subprocess.run([sys.executable, "-m", "portbench", *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("cell", [w["name"] for w in Spec().benchmark()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(cell, trace):
    need_card()
    rc, out, err = bench("--workload", cell, "--seed", "2147483659", "--seconds", "3",
                         "--trace", str(trace))
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
    e2e, per_layer = Spec().cell_metrics(cell)
    want = per_layer if trace else e2e
    assert set(result["metrics"]) <= {m["name"] for m in want}
    if trace:
        assert result["device"]["busy_s"] > 0 and result["breakdown"]["device_ops"]
    else:
        assert set(result["metrics"]) == {m["name"] for m in e2e}
