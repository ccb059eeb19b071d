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
    # an arm against a base arm over paired seeds, with the collapses
    PYTHONPATH=. python tests/torch_quality_verdicts.py pairs --seeds 0-11 \\
        --arm torch=torch@<JSONL>,... --arm torch_bf16=torch_bf16@<JSONL>,...
    # collapses of two arms over the same seeds, two-sided Fisher exact p
    PYTHONPATH=. python tests/torch_quality_verdicts.py collapse --seeds 0-23 \\
        --arm f32=torch@<JSONL>,... --arm tpu=torch@<JSONL>,...
    # where JAX's per-seed gaps of an arm fall among the port's
    PYTHONPATH=. python tests/torch_quality_verdicts.py rank --arms d2,refscale \\
        --seeds 6-23 --rows <JSONL>,... --jax <recorded JAX JSONL>,...

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

``--arm <label>=<prefix>@<JSONL>,...`` reads the rows named
``<prefix>_s<seed>`` of those files alone, under the label: the TPU
precision harness's files reuse the plain arms' names, so an arm trained
under it is read from its own directory.

``collapse``: the sets of each of two arms whose fid_randconv exceeds 100
(:data:`COLLAPSE`), and the two-sided Fisher exact p of the two counts,
computed exactly; ``second_fewer_p_lt_0.05`` says whether the second arm
collapses in fewer seeds than the first at p < 0.05.

``rank``: for each arm and each of fid_randconv and KID, the port's
per-seed gaps against the plain run, JAX's recorded per-seed gaps, and how
many of the port's lie below each of JAX's. The arm *differs* on a metric
when JAX's gaps all lie below all of the port's, or all above; if the
values are exchangeable, either happens by chance with probability
``1 / C(n + j, j)`` (n port seeds, j JAX seeds: 1/190 for 18 and 2). It
*reproduces* on a metric otherwise; the arm's verdict is ``reproduces``
(both metrics), ``differs`` (both) or ``undecided``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

from blurred_gan_tpu_torch import quality

METRICS = ("SWDx1e3_avg", "fid_randconv", "kid")
VERDICT_METRICS = ("fid_randconv", "kid")
# The recorded JAX gap lines of each arm (benchmarks/quality_parity.py evaluate).
JAX_GAP_KEYS = {"resize": "rel_gap_resize_vs_transpose", "ttur": "rel_gap_ttur_vs_sharedlr",
                "adaptive": "rel_gap_adaptive_vs_openloop", "d2": "rel_gap_d2_vs_d1",
                "refscale": "rel_gap_refscale_vs_default"}
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


def arm_rows(spec: str) -> Tuple[str, Dict[int, dict]]:
    """``<label>=<prefix>@<JSONL>,...``: the label and the rows named
    ``<prefix>_s<seed>`` of those files, by seed."""
    label, rest = spec.split("=", 1)
    prefix, files = rest.split("@", 1)
    out = {}
    for name, r in load_rows(files.split(",")).items():
        head, _, seed = name.rpartition("_s")
        if head == prefix and seed.isdigit():
            out[int(seed)] = r
    return label, out


def labelled(label: str, by_seed: Dict[int, dict]) -> Dict[str, dict]:
    """Rows by seed renamed ``<label>_s<seed>``, as ``quality.pooled_stats``
    reads them."""
    return {f"{label}_s{s}": dict(r, samples=f"{label}_s{s}") for s, r in by_seed.items()}


def fisher_exact(a: int, n_a: int, b: int, n_b: int) -> float:
    """Two-sided Fisher exact p of ``a`` of ``n_a`` against ``b`` of
    ``n_b``: with the margins fixed, the hypergeometric probability of every
    table no likelier than the observed one, summed in exact fractions."""
    k, n = a + b, n_a + n_b

    def prob(x):
        return Fraction(math.comb(n_a, x) * math.comb(n_b, k - x), math.comb(n, k))

    observed = prob(a)
    tables = range(max(0, k - n_b), min(k, n_a) + 1)
    return float(sum(q for q in map(prob, tables) if q <= observed))


def exchangeable_p(n: int, j: int) -> float:
    """The chance that ``j`` given values of ``n + j`` exchangeable ones are
    the ``j`` lowest (or, alike, the ``j`` highest): ``1 / C(n + j, j)``."""
    return 1.0 / math.comb(n + j, j)


def recorded_gaps(jax_lines: Sequence[dict], arm: str) -> Dict[int, dict]:
    """The JAX package's recorded per-seed gaps of ``arm`` against its plain
    run, by seed (the first line of a seed wins)."""
    out = {}
    for line in jax_lines:
        if JAX_GAP_KEYS[arm] in line:
            out.setdefault(line["seed"], line[JAX_GAP_KEYS[arm]])
    return out


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
        jax_gaps = recorded_gaps(jax_lines, arm)
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
    (plain, a), (side, b) = map(arm_rows, args.arm)
    rows = {**labelled(plain, a), **labelled(side, b)}
    seeds = seeds_of(args.seeds)
    pooled = quality.pooled_stats(rows, seeds, plain, side)
    key, limit = COLLAPSE
    collapses = {x: [s for s in pooled["seeds"] if rows[f"{x}_s{s}"][key] > limit]
                 for x in (plain, side)}
    gaps = {s: quality.rel_gaps(rows[f"{plain}_s{s}"], rows[f"{side}_s{s}"])
            for s in pooled["seeds"]}
    return [{"pairs": f"{side}_vs_{plain}", "seeds": pooled["seeds"],
             "gap_of_medians": {m: pooled["stats"][m]["rel_gap_median"] for m in METRICS},
             "median_of_gaps": {m: round(float(np.median([g[m] for g in gaps.values()])), 4)
                                for m in METRICS},
             "wins": {m: pooled["stats"][m]["wins"] for m in METRICS},
             "values": {x: {s: rows[f"{x}_s{s}"][key] for s in pooled["seeds"]}
                        for x in (plain, side)},
             f"collapses_{key}_gt_{limit:g}": collapses}]


def cmd_collapse(args) -> List[dict]:
    seeds = seeds_of(args.seeds)
    key, limit = COLLAPSE
    arms = {}
    for label, by_seed in map(arm_rows, args.arm):
        missing = [s for s in seeds if s not in by_seed]
        if missing:
            raise SystemExit(f"arm {label}: no rows for seeds {missing}")
        values = {s: by_seed[s][key] for s in seeds}
        arms[label] = {"n": len(seeds), "collapsed": sum(v > limit for v in values.values()),
                       "seeds": [s for s, v in values.items() if v > limit], "values": values}
    (_, a), (_, b) = arms.items()
    p = fisher_exact(a["collapsed"], a["n"], b["collapsed"], b["n"])
    return [{"collapse": f"{key}_gt_{limit:g}", "seeds": seeds, "arms": arms,
             "fisher_p_two_sided": round(p, 6),
             "second_fewer_p_lt_0.05": bool(b["collapsed"] < a["collapsed"] and p < 0.05)}]


def cmd_rank(args) -> List[dict]:
    seeds = seeds_of(args.seeds)
    rows = load_rows(args.rows.split(","))
    jax_lines = json_lines(args.jax.split(","))
    out = []
    for arm in args.arms.split(","):
        side = f"torch_{arm}"
        paired = [s for s in seeds if f"torch_s{s}" in rows and f"{side}_s{s}" in rows]
        if paired != seeds:
            raise SystemExit(f"{side}: no pair for seeds {sorted(set(seeds) - set(paired))}")
        gaps = {s: quality.rel_gaps(rows[f"torch_s{s}"], rows[f"{side}_s{s}"]) for s in seeds}
        jax_gaps = recorded_gaps(jax_lines, arm)
        line = {"rank": arm, "seeds": seeds, "jax_seeds": sorted(jax_gaps),
                "p_one_side": round(exchangeable_p(len(seeds), len(jax_gaps)), 6),
                "metrics": {}}
        differs = []
        for m in VERDICT_METRICS:
            port = [gaps[s][m] for s in seeds]
            jax = {s: g[m] for s, g in sorted(jax_gaps.items())}
            below = all(v < min(port) for v in jax.values())
            above = all(v > max(port) for v in jax.values())
            line["metrics"][m] = {
                "port_gaps": {s: gaps[s][m] for s in seeds}, "jax_gaps": jax,
                "port_below_each_jax": {s: sum(x < v for x in port) for s, v in jax.items()},
                "jax_below_all": below, "jax_above_all": above, "differs": below or above}
            differs.append(below or above)
        line["verdict"] = ("differs" if all(differs) else
                           "undecided" if any(differs) else "reproduces")
        out.append(line)
    return out


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
    r.add_argument("--arm", action="append", required=True,
                   help="<label>=<prefix>@<JSONL>,... twice: the base arm, then the other")
    r.add_argument("--seeds", required=True)
    c = sub.add_parser("collapse")
    c.add_argument("--arm", action="append", required=True,
                   help="<label>=<prefix>@<JSONL>,... twice: the reference, then the other")
    c.add_argument("--seeds", required=True)
    k = sub.add_parser("rank")
    k.add_argument("--rows", required=True)
    k.add_argument("--jax", required=True)
    k.add_argument("--arms", default="d2,refscale")
    k.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    if args.cmd in ("pairs", "collapse") and len(args.arm) != 2:
        p.error("--arm takes two arms")
    commands = {"arms": cmd_arms, "spread": cmd_spread, "pairs": cmd_pairs,
                "collapse": cmd_collapse, "rank": cmd_rank}
    for line in commands[args.cmd](args):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
