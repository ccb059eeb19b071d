#!/usr/bin/env python3
"""Score the PyTorch port's quality-check sample sets with the JAX package's
metrics, and pool them against the recorded JAX arms.

``python -m blurred_gan_tpu_torch.quality train`` writes
``torch[_<arm>]_samples_s<seed>.npz`` (1000 samples, NHWC float32 in [-1, 1]).
This script scores each with the row of ``benchmarks/quality_parity.py
evaluate`` (SWD levels and average, random-conv FID, Inception FID, PRDC with
k = 5, KID over subsets of 500, the same rounding) against the same held-out
reals (the last 1000 of the ``RandomState(10_000)`` shuffle of the synthetic
corpus; the first 1000 are the reals-vs-reals floor), merges the recorded JAX
rows (``--rows_from``), and prints per-seed relative gaps and the pooled
statistics of ``quality_parity._pooled_stats`` for

- ``(ours, torch)``: the port against the JAX package;
- ``(ours_bf16, torch_bf16)``, ``(torch, torch_bf16)`` and ``(ours,
  ours_bf16)``: the port's bfloat16 gap beside the JAX package's;
- the same three pairs for every other arm scored.

One metric implementation scores both sides, so the port's own draws (its
``torch.Generator`` streams in SWD and the random-conv extractor) do not
enter. Everything is printed as JSON lines on stdout; the first line is the
Inception note when no weights are found. ``--pool_only`` scores nothing and
pools the rows of earlier runs (a 64² row takes minutes here, so sets are
scored in batches as they arrive and pooled once). It imports jax and runs on
the CPU:

    JAX_PLATFORMS=cpu python quality_torch_score.py --config mnist \\
        --dir runs/quality/mnist --seeds 0,1,2 \\
        --rows_from results/quality/mnist/eval_seeds012.jsonl \\
        | tee results/quality/torch/mnist/eval_torch_s012.jsonl
    JAX_PLATFORMS=cpu python quality_torch_score.py --pool_only --seeds 0,1,2 \\
        --rows_from results/quality/sharp64/eval_seeds012.jsonl,eval_torch_s0.jsonl,...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import quality_parity as qp  # noqa: E402

# The port's arms, in quality_parity.evaluate's order of its own.
ARMS = ("torch", "torch_bf16", "torch_ema", "torch_adaptive", "torch_refscale",
        "torch_resize", "torch_ttur", "torch_d2")


# held_out_reals and make_scorer copy evaluate's held-out reals and its nested
# score (benchmarks/quality_parity.py:399-440): score is local to evaluate and
# benchmarks/ stays as it is. tests/test_torch_quality.py holds the two rows
# equal.
def held_out_reals(cfg: qp.ParityConfig):
    """(reals, floor reals): the last and the first ``N_EVAL`` images of the
    corpus's fixed shuffle, in [-1, 1]."""
    ds = qp._corpus(cfg)
    order = np.random.RandomState(10_000).permutation(ds.num_examples)
    reals = ds.images[order[-qp.N_EVAL:]].astype(np.float32) / 127.5 - 1.0
    reals_b = ds.images[order[:qp.N_EVAL]].astype(np.float32) / 127.5 - 1.0
    return reals, reals_b


def make_scorer(reals: np.ndarray, use_inception: bool):
    """``score(name, fakes) -> row``: ``quality_parity.evaluate``'s row
    (Inception FID at 75², the recorded rows' size)."""
    from blurred_gan_tpu.metrics import (FIDMetric, SWDMetric, kid_from_images,
                                         prdc_from_images)

    feature_fns = {"fid_randconv": None}
    if use_inception:
        from blurred_gan_tpu.metrics import inception_feature_fn

        feature_fns["fid_inception"] = inception_feature_fn(resize_to=75)
    n = qp.N_EVAL

    def score(name: str, fakes: np.ndarray) -> dict:
        row = {"samples": name}
        swd = SWDMetric()
        for i in range(0, n, 100):
            swd.update_state(reals[i:i + 100], fakes[i:i + 100])
        row.update({k: round(float(v), 3) for k, v in swd.results().items()})
        for fid_name, fn in feature_fns.items():
            fid = FIDMetric(feature_fn=fn)
            for i in range(0, n, 100):
                fid.update_state(reals[i:i + 100], fakes[i:i + 100])
            row[fid_name] = round(float(fid.result()), 3)
        row.update({k: round(v, 4) for k, v in
                    prdc_from_images(reals, fakes, k=5, batch=100).items()})
        row.update({k: round(v, 5) for k, v in
                    kid_from_images(reals, fakes, subset_size=500).items()})
        row["stack"] = "jax"  # the metric implementation that scored the row
        print(json.dumps(row), flush=True)
        return row

    return score


def rel_gaps(a: dict, b: dict) -> Dict[str, float]:
    """(b − a) / |a| for each quality metric (positive: b worse)."""
    return {k: round((b[k] - a[k]) / abs(a[k]), 4)
            for k in a if qp._is_quality_metric(k) and k in b and a[k] != 0}


def pairs(arms: Sequence[str]):
    """The pooled comparisons: the port against the JAX package for each
    arm, and each other arm against the plain run within each framework."""
    out = [("ours", "torch")]
    for arm in arms:
        if arm == "torch":
            continue
        jax_arm = "ours" + arm[len("torch"):]
        out += [(jax_arm, arm), ("torch", arm), ("ours", jax_arm)]
    return out


def score_dir(cfg: qp.ParityConfig, directory: str, seeds: Sequence[int], *,
              use_inception: bool = True, rows_from=()) -> dict:
    """Score every port sample set of ``seeds`` in ``directory``, merge the
    recorded rows and print the gaps and pooled statistics; returns the rows."""
    reals, reals_b = held_out_reals(cfg)
    score = make_scorer(reals, use_inception)
    rows = {"reals_floor": score("reals_vs_reals", reals_b)}
    scored = []
    for seed in seeds:
        for arm in ARMS:
            path = os.path.join(directory, f"{arm}_samples_s{seed}.npz")
            if not os.path.exists(path):
                if arm == "torch":
                    print(f"[skip] {path} missing", flush=True)
                continue
            with np.load(path) as d:
                rows[f"{arm}_s{seed}"] = score(f"{arm}_s{seed}", d["samples"])
            if arm not in scored:
                scored.append(arm)
    if rows_from:
        qp._merge_recorded_rows(rows, rows_from)
    report(rows, seeds, scored)
    return rows


def pool_recorded(seeds: Sequence[int], rows_from) -> dict:
    """Score nothing: merge the rows of ``rows_from`` (earlier runs of this
    script and the recorded JAX rows) and report on the port's arms among
    them; returns the rows."""
    rows: dict = {}
    qp._merge_recorded_rows(rows, rows_from)
    arms = [arm for arm in ARMS if any(k.rsplit("_s", 1)[0] == arm for k in rows)]
    report(rows, seeds, arms)
    return rows


def report(rows: dict, seeds: Sequence[int], arms: Sequence[str]) -> None:
    """Print the per-seed relative gaps of ``seeds`` and the pooled statistics
    over every seed of ``rows`` for the pairs ``arms`` imply."""
    for seed in seeds:
        for a, b in pairs(arms):
            if f"{a}_s{seed}" in rows and f"{b}_s{seed}" in rows:
                print(json.dumps({f"rel_gap_{b}_vs_{a}": rel_gaps(rows[f"{a}_s{seed}"],
                                                                  rows[f"{b}_s{seed}"]),
                                  "seed": seed}), flush=True)
    all_seeds = sorted({int(k.rsplit("_s", 1)[1]) for k in rows
                        if k.rsplit("_s", 1)[-1].isdigit()})
    for a, b in pairs(arms):
        stats = qp._pooled_stats(rows, all_seeds, a, b)
        if stats:
            print(json.dumps(stats), flush=True)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", default="mnist", choices=sorted(qp.CONFIGS))
    p.add_argument("--dir", help="where the port's sample sets are")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--rows_from", default="",
                   help="comma-separated JSONL files of recorded rows to pool against")
    p.add_argument("--pool_only", action="store_true",
                   help="score nothing: pool the --rows_from rows (the port's rows "
                        "from earlier runs of this script among them)")
    args = p.parse_args(argv)
    rows_from = [f for f in args.rows_from.split(",") if f]
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.pool_only:
        return pool_recorded(seeds, rows_from)
    if not args.dir:
        p.error("--dir is needed unless --pool_only")
    return score_dir(qp.CONFIGS[args.config], args.dir, seeds, rows_from=rows_from)


if __name__ == "__main__":
    main()
