"""Read quality-check rows and put the figures and the verdicts of the
port's open quality items on one JSON line each. It scores nothing: it reads
the JSONL files that ``quality evaluate``, ``quality_torch_score.py``,
``benchmarks/quality_parity.py evaluate`` and ``tools.diagnose_samples``
wrote (the first file holding a row wins).

    # an arm against the plain run, seed by seed, beside the JAX package's gaps
    PYTHONPATH=. python tests/torch_quality_verdicts.py arms --seeds 6-11 \\
        --rows <port-stack JSONL>,... --jax <recorded JAX JSONL>,... \\
        [--diag <diagnose_samples JSONL>,...]
    # two sets of rows of one stack: medians, ranges, Mann-Whitney U per metric
    PYTHONPATH=. python tests/torch_quality_verdicts.py spread --rows <JSONL>,... \\
        --a ours --a_seeds 0-5 --b torch --b_seeds 0-5
    # an arm against the plain run over paired seeds, with the collapses
    PYTHONPATH=. python tests/torch_quality_verdicts.py pairs --rows <JSONL>,... \\
        --b torch_bf16 --seeds 0-11

``arms``: for each of ``resize``, ``ttur`` and ``adaptive`` with rows, the
per-seed gaps ``(arm − plain) / |plain|`` of ``torch_<arm>_s<S>`` against
``torch_s<S>``, their median, and the pooled statistics of
``quality.pooled_stats`` (its ``rel_gap_median`` is the gap of the medians);
the JAX package's recorded per-seed gaps (``rel_gap_<arm>_vs_...`` lines) and
their mean; and the verdict:

- ``resize`` reproduces when its gap of the medians is ≤ −50% on
  fid_randconv and on KID and, on at least 5 of 6 seeds, its ``hi_12-24`` and
  ``vhi_24+`` band ratios against the reals are within 3× (``--diag``);
- ``ttur`` and ``adaptive`` reproduce when, on fid_randconv and on KID each,
  the port's gap of the medians has the sign of JAX's mean gap, or JAX's
  seeds disagree in sign and the port's seeds do too.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence

import numpy as np

from blurred_gan_tpu_torch import quality

METRICS = ("SWDx1e3_avg", "fid_randconv", "kid")
VERDICT_METRICS = ("fid_randconv", "kid")
# The recorded JAX gap lines of each arm (benchmarks/quality_parity.py evaluate).
JAX_GAP_KEYS = {"resize": "rel_gap_resize_vs_transpose", "ttur": "rel_gap_ttur_vs_sharedlr",
                "adaptive": "rel_gap_adaptive_vs_openloop"}
BANDS = ("hi_12-24", "vhi_24+")
# A set whose fid_randconv is past this has collapsed (a collapsed sharp-64 set read 253).
COLLAPSE = ("fid_randconv", 100.0)


def seeds_of(text: str) -> List[int]:
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(s) for s in text.split(",")]


def json_lines(paths: Sequence[str]) -> List[dict]:
    out = []
    for path in filter(None, paths):
        with open(path) as f:
            for line in f:
                if line.startswith("{"):
                    out.append(json.loads(line))
    return out


def load_rows(paths: Sequence[str]) -> Dict[str, dict]:
    """Rows by sample-set name; the first file holding a row wins."""
    rows = {}
    for line in json_lines(paths):
        name = line.get("samples")
        if name and name not in rows:
            rows[name] = line
    return rows


def sign_set(values) -> set:
    return {int(np.sign(v)) for v in values if v != 0}


def arm_verdict(arm: str, port_gaps: Dict[int, dict], pooled: dict, jax_gaps: Dict[int, dict],
                bands: Dict[int, dict]) -> dict:
    out = {"arm": arm, "rule": {}}
    if arm == "resize":
        medians_ok = all(pooled["stats"][m]["rel_gap_median"] <= -0.5 for m in VERDICT_METRICS)
        within = {s: all(1 / 3 <= b[k] <= 3 for k in BANDS) for s, b in bands.items()}
        bands_ok = len(within) >= 6 and sum(within.values()) >= 5
        out["rule"] = {"gap_of_medians_le_-50%": medians_ok,
                       "bands_within_3x_by_seed": within, "bands_ok": bands_ok}
        out["reproduces"] = bool(medians_ok and bands_ok)
        return out
    ok = True
    for m in VERDICT_METRICS:
        jax_values = [g[m] for g in jax_gaps.values()]
        port_values = [g[m] for g in port_gaps.values()]
        jax_mean = float(np.mean(jax_values))
        port_median = pooled["stats"][m]["rel_gap_median"]
        jax_disagree = len(sign_set(jax_values)) > 1
        port_disagree = len(sign_set(port_values)) > 1
        same_sign = np.sign(port_median) == np.sign(jax_mean)
        hold = bool(same_sign or (jax_disagree and port_disagree))
        out["rule"][m] = {"jax_mean_gap": round(jax_mean, 4), "port_gap_of_medians": port_median,
                          "jax_seeds_disagree": jax_disagree, "port_seeds_disagree": port_disagree,
                          "same_sign": bool(same_sign), "holds": hold}
        ok = ok and hold
    out["reproduces"] = ok
    return out


def cmd_arms(args) -> List[dict]:
    seeds = seeds_of(args.seeds)
    rows = load_rows(args.rows.split(","))
    jax_lines = json_lines(args.jax.split(",")) if args.jax else []
    diag = {line["set"]: line for line in json_lines(args.diag.split(","))} if args.diag else {}
    out = []
    for arm in ("resize", "ttur", "adaptive"):
        side = f"torch_{arm}"
        paired = [s for s in seeds if f"torch_s{s}" in rows and f"{side}_s{s}" in rows]
        if not paired:
            continue
        gaps = {s: quality.rel_gaps(rows[f"torch_s{s}"], rows[f"{side}_s{s}"]) for s in paired}
        pooled = quality.pooled_stats(rows, paired, "torch", side)
        jax_gaps = {}
        for line in jax_lines:
            if JAX_GAP_KEYS[arm] in line:
                jax_gaps.setdefault(line["seed"], line[JAX_GAP_KEYS[arm]])
        bands = {s: diag[f"{side}_s{s}"]["band_ratio_vs_reals"] for s in paired
                 if f"{side}_s{s}" in diag}
        line = {"arm": arm, "seeds": paired,
                "port_gaps": {m: {s: g[m] for s, g in gaps.items()} for m in METRICS},
                "port_median_of_gaps": {m: round(float(np.median([g[m] for g in gaps.values()])), 4)
                                        for m in METRICS},
                "port_gap_of_medians": {m: pooled["stats"][m]["rel_gap_median"] for m in METRICS},
                "port_wins": {m: pooled["stats"][m]["wins"] for m in METRICS},
                "jax_gaps": {m: {s: g[m] for s, g in sorted(jax_gaps.items())} for m in METRICS},
                "jax_mean_gap": {m: round(float(np.mean([g[m] for g in jax_gaps.values()])), 4)
                                 for m in METRICS} if jax_gaps else None}
        if bands:
            line["band_ratios"] = {s: {k: b[k] for k in BANDS} for s, b in bands.items()}
            line["saturation"] = {s: diag[f"{side}_s{s}"]["sat"] for s in bands}
        line["verdict"] = arm_verdict(arm, gaps, pooled, jax_gaps, bands)
        out.append(line)
    return out


def cmd_spread(args) -> List[dict]:
    from scipy.stats import mannwhitneyu

    rows = load_rows(args.rows.split(","))
    a = [rows[f"{args.a}_s{s}"] for s in seeds_of(args.a_seeds)]
    b = [rows[f"{args.b}_s{s}"] for s in seeds_of(args.b_seeds)]
    stacks = {quality.row_stack(r) for r in a + b}
    if len(stacks) > 1:
        raise SystemExit(f"rows of different stacks: {sorted(stacks)}")
    stack = stacks.pop()
    out = []
    for m in METRICS:
        va, vb = [r[m] for r in a], [r[m] for r in b]
        test = mannwhitneyu(va, vb, alternative="two-sided")
        out.append({"spread": m, "stack": stack,
                    args.a: {"seeds": seeds_of(args.a_seeds), "median": float(np.median(va)),
                             "range": [min(va), max(va)], "values": va},
                    args.b: {"seeds": seeds_of(args.b_seeds), "median": float(np.median(vb)),
                             "range": [min(vb), max(vb)], "values": vb},
                    "mann_whitney_u": float(test.statistic), "p_two_sided": float(test.pvalue)})
    return out


def cmd_pairs(args) -> List[dict]:
    rows = load_rows(args.rows.split(","))
    seeds = seeds_of(args.seeds)
    plain = "torch"
    pooled = quality.pooled_stats(rows, seeds, plain, args.b)
    key, limit = COLLAPSE
    collapses = {side: [s for s in pooled["seeds"] if rows[f"{side}_s{s}"][key] > limit]
                 for side in (plain, args.b)}
    gaps = {s: quality.rel_gaps(rows[f"{plain}_s{s}"], rows[f"{args.b}_s{s}"])
            for s in pooled["seeds"]}
    return [{"pairs": f"{args.b}_vs_{plain}", "seeds": pooled["seeds"],
             "gap_of_medians": {m: pooled["stats"][m]["rel_gap_median"] for m in METRICS},
             "median_of_gaps": {m: round(float(np.median([g[m] for g in gaps.values()])), 4)
                                for m in METRICS},
             "wins": {m: pooled["stats"][m]["wins"] for m in METRICS},
             "values": {side: {s: rows[f"{side}_s{s}"][key] for s in pooled["seeds"]}
                        for side in (plain, args.b)},
             f"collapses_{key}_gt_{limit:g}": collapses}]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    a = sub.add_parser("arms")
    a.add_argument("--rows", required=True)
    a.add_argument("--jax", default="")
    a.add_argument("--diag", default="")
    a.add_argument("--seeds", default="6-11")
    s = sub.add_parser("spread")
    s.add_argument("--rows", required=True)
    s.add_argument("--a", required=True)
    s.add_argument("--a_seeds", required=True)
    s.add_argument("--b", required=True)
    s.add_argument("--b_seeds", required=True)
    r = sub.add_parser("pairs")
    r.add_argument("--rows", required=True)
    r.add_argument("--b", required=True, help="the arm's prefix (e.g. torch_bf16)")
    r.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    for line in {"arms": cmd_arms, "spread": cmd_spread, "pairs": cmd_pairs}[args.cmd](args):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
