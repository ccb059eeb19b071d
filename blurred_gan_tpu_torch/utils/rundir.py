"""Auto-numbered run directories, the run manifest, and what post-hoc tools
read from them: the model a run trained and its latest checkpoint directory
(port of ``blurred_gan_tpu/utils/rundir.py``)."""

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


def resolve_model_identity(log_dir: str, dataset: str | None,
                           resolution: int | None) -> tuple[str, int]:
    """Fill an unset ``dataset`` or ``resolution`` from the run's manifest:
    a one-channel image shape is the MNIST family, three channels the CelebA
    family at the manifest's resolution. Without a manifest ``dataset`` must
    be given (``SystemExit`` otherwise) and ``resolution`` defaults to 128."""
    if dataset is None or resolution is None:
        shape = (load_run_manifest(log_dir) or {}).get("image_shape")
        if shape:
            if dataset is None:
                dataset = "mnist" if shape[-1] == 1 else "celeba"
            if resolution is None:
                resolution = int(shape[0])
    if dataset is None:
        raise SystemExit(
            f"no {os.path.join(log_dir, 'run_manifest.json')} (pre-manifest "
            "run dir): pass --dataset (and --resolution for celeba)")
    if resolution is None:
        resolution = 128
    return dataset, resolution


def locate_latest_checkpoint_dir(result_dir: str, run_name: str) -> str | None:
    """``checkpoints/`` of the highest-numbered ``result_dir/NN-run_name``, or
    None when there is no such run or it has no checkpoint directory."""
    best, best_id = None, -1
    for p in glob.glob(os.path.join(result_dir, f"*-{run_name}")):
        base = os.path.basename(p).split("-")[0]
        if base.isdigit() and int(base) > best_id:
            best, best_id = p, int(base)
    if best is None:
        return None
    ckpt = os.path.join(best, "checkpoints")
    return ckpt if os.path.isdir(ckpt) else None
