"""Auto-numbered run directories and the run manifest (port of
``blurred_gan_tpu/utils/rundir.py``)."""

from __future__ import annotations

import glob
import json
import os


def create_result_subdir(result_dir: str, run_name: str) -> str:
    """Create ``result_dir/NN-run_name`` with NN = the largest existing + 1."""
    run_ids = []
    for p in glob.glob(os.path.join(result_dir, f"*-{run_name}")):
        base = os.path.basename(p).split("-")[0]
        if base.isdigit():
            run_ids.append(int(base))
    path = os.path.join(result_dir, f"{max(run_ids, default=0) + 1:02d}-{run_name}")
    os.makedirs(path)
    return path


def load_run_manifest(log_dir: str) -> dict | None:
    """The run's ``run_manifest.json`` (dataset, image shape, example count,
    latent size, EMA), or None."""
    path = os.path.join(log_dir, "run_manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
