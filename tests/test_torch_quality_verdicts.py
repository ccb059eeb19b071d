"""The quality check's verdicts and sweeps: ``tests/torch_quality_verdicts.py``'s
rules on made-up rows, its figures recomputed from the committed rows, and
``tests/torch_quality_sweep.py``'s run specs. Nothing here scores or trains."""

import argparse
import json
import os

import pytest

import torch_quality_sweep as sweep
import torch_quality_verdicts as verdicts
from blurred_gan_tpu_torch import quality
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD = os.path.join(ROOT, "results", "quality", "torch", "celeba64", "card")
HEAVY = os.path.join(ROOT, "results", "quality", "heavy64")
BF16 = os.path.join(ROOT, "results", "quality", "torch", "backward_f32", "celeba64_sharp")
SHARP = os.path.join(ROOT, "results", "quality", "torch", "celeba64_sharp", "card")
MNIST = os.path.join(ROOT, "results", "quality", "torch", "mnist")
JAX_CPU = os.path.join(ROOT, "results", "quality", "torch", "jax_cpu", "mnist")


def row(name, fid, kid, swd=100.0, stack="torch-cuda"):
    return {"samples": name, "SWDx1e3_avg": swd, "fid_randconv": fid, "kid": kid,
            "stack": stack}


def arm_inputs(arm, plain, other):
    """(per-seed gaps, pooled statistics) of ``torch_<arm>`` rows against
    ``torch`` rows, one (fid, kid) pair of each a seed."""
    seeds = list(range(len(plain)))
    rows = {}
    for s, (p, o) in enumerate(zip(plain, other)):
        rows[f"torch_s{s}"] = row(f"torch_s{s}", *p)
        rows[f"torch_{arm}_s{s}"] = row(f"torch_{arm}_s{s}", *o)
    gaps = {s: quality.rel_gaps(rows[f"torch_s{s}"], rows[f"torch_{arm}_s{s}"]) for s in seeds}
    return gaps, quality.pooled_stats(rows, seeds, "torch", f"torch_{arm}")


def bands(*pairs):
    return {s: {"hi_12-24": hi, "vhi_24+": vhi} for s, (hi, vhi) in enumerate(pairs)}


@pytest.mark.parametrize("fid_gain, band_pairs, want", [
    (0.3, [(1.0, 1.0)] * 6, True),
    (0.3, [(1.0, 1.0)] * 5 + [(4.0, 1.0)], True),       # one seed's bands outside 3x
    (0.3, [(1.0, 1.0)] * 4 + [(4.0, 1.0), (1.0, 0.2)], False),
    (0.6, [(1.0, 1.0)] * 6, False),                       # fid's gap of the medians -40%
])
def test_resize_rule(fid_gain, band_pairs, want):
    plain = [(100.0 + s, 0.2) for s in range(6)]
    other = [(fid_gain * (100.0 + s), 0.05) for s in range(6)]
    gaps, pooled = arm_inputs("resize", plain, other)
    out = verdicts.arm_verdict("resize", gaps, pooled, {}, bands(*band_pairs))
    assert out["reproduces"] is want


@pytest.mark.parametrize("jax_fid, port_fid, want", [
    ([-0.2, -0.1], [0.9] * 6, True),          # same sign as JAX's mean
    ([-0.2, -0.1], [1.1] * 6, False),         # the other sign, JAX's seeds agree
    ([-0.2, 0.1], [1.1] * 3 + [0.9] * 3, True),  # both sides split in sign
    ([-0.2, 0.1], [1.1] * 6, False),          # JAX split, the port not, other sign
])
def test_sign_rule(jax_fid, port_fid, want):
    plain = [(100.0 + s, 0.2) for s in range(6)]
    other = [(f * (100.0 + s), 0.1) for s, f in enumerate(port_fid)]
    gaps, pooled = arm_inputs("ttur", plain, other)
    jax_gaps = {6 + i: {"fid_randconv": g, "kid": -0.3} for i, g in enumerate(jax_fid)}
    out = verdicts.arm_verdict("ttur", gaps, pooled, jax_gaps, {})
    assert out["rule"]["kid"]["holds"]
    assert out["rule"]["fid_randconv"]["holds"] is want
    assert out["reproduces"] is want


def test_committed_heavy64_verdicts():
    """``verdicts arms`` over the committed heavy-64 rows gives the committed
    verdict lines."""
    h = os.path.join(CARD, "heavy64")
    rows = ([os.path.join(h, "pool_heavy64.jsonl")]
            + [os.path.join(h, f"eval_heavy64_s{s}.jsonl") for s in range(6, 12)]
            + [os.path.join(CARD, f"eval_torch_d2_s{s}.jsonl") for s in ("678", "91011")])
    jax = [os.path.join(HEAVY, f) for f in ("eval_arms_s6.jsonl", "eval_arms_s7.jsonl",
                                            "eval_seeds678_cpu.jsonl")]
    args = argparse.Namespace(
        rows=",".join(rows), jax=",".join(jax), diag=os.path.join(h, "diag_heavy64.jsonl"),
        seeds="6-11")
    got = [json.loads(json.dumps(line)) for line in verdicts.cmd_arms(args)]
    with open(os.path.join(CARD, "verdicts_s6-11.jsonl")) as f:
        want = [json.loads(line) for line in f]
    assert got == want
    assert [(v["arm"], v["verdict"]["reproduces"]) for v in got] == [
        ("resize", True), ("ttur", True), ("adaptive", True)]


def test_pairs_match_the_pooled_file():
    """``verdicts pairs`` over sharp-64's six bf16 pairs gives the pooled
    file's gaps of the medians and wins."""
    files = [os.path.join(BF16, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    files += [os.path.join(SHARP, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    args = argparse.Namespace(
        rows=",".join(files), b="torch_bf16", seeds="0-5")
    (got,) = verdicts.cmd_pairs(args)
    with open(os.path.join(BF16, "pool_s0-5.jsonl")) as f:
        pooled = next(json.loads(line) for line in f if line.startswith('{"pooled"'))
    for m in verdicts.METRICS:
        assert got["gap_of_medians"][m] == pooled["stats"][m]["rel_gap_median"]
        assert got["wins"][m] == pooled["stats"][m]["wins"]
    assert got["collapses_fid_randconv_gt_100"] == {"torch": [2, 5], "torch_bf16": []}


def test_committed_sharp_pairs():
    """``verdicts pairs`` over the twelve sharp-64 pairs gives the committed
    line: the bf16 gap stays negative on fid_randconv, float32 collapses."""
    new = os.path.join(SHARP, "s6-11")
    files = [os.path.join(new, f"eval_sharp64_s{s}.jsonl") for s in range(6, 12)]
    files += [os.path.join(BF16, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    files += [os.path.join(SHARP, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    args = argparse.Namespace(rows=",".join(files), b="torch_bf16", seeds="0-11")
    (got,) = verdicts.cmd_pairs(args)
    with open(os.path.join(SHARP, "pairs_s0-11.jsonl")) as f:
        want = json.loads(f.read())
    assert json.loads(json.dumps(got)) == want
    assert got["seeds"] == list(range(12)) and got["gap_of_medians"]["fid_randconv"] < 0
    assert got["collapses_fid_randconv_gt_100"] == {"torch": [2, 5, 6, 9], "torch_bf16": []}


def test_committed_mnist_spread(capsys):
    """``verdicts spread`` of JAX's float32 MNIST rows (this CPU, s0-5)
    against the port's six JAX-stack rows gives the committed lines; the
    SWD's p is at least 0.05."""
    files = [os.path.join(JAX_CPU, f"eval_ours_s{s}.jsonl") for s in ("0", "12", "34", "5")]
    files += [os.path.join(MNIST, f"eval_torch_s{s}.jsonl") for s in ("012", "345")]
    verdicts.main(["spread", "--rows", ",".join(files), "--a", "ours", "--a_seeds", "0-5",
                   "--b", "torch", "--b_seeds", "0-5"])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    with open(os.path.join(JAX_CPU, "spread_s0-5.jsonl")) as f:
        assert got == [json.loads(line) for line in f]
    assert got[0]["spread"] == "SWDx1e3_avg" and got[0]["p_two_sided"] >= 0.05


def test_spread_refuses_two_stacks(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in [
        row("ours_s0", 5.0, 0.001, stack="jax"), row("ours_s1", 6.0, 0.002, stack="jax"),
        row("torch_s0", 5.5, 0.001, stack="torch-cuda"), row("torch_s1", 7.0, 0.003,
                                                              stack="torch-cuda")]) + "\n")
    argv = ["spread", "--rows", str(path), "--a", "ours", "--a_seeds", "0-1", "--b", "torch",
            "--b_seeds", "0,1"]
    with pytest.raises(SystemExit, match="different stacks"):
        verdicts.main(argv)


def test_spread_mann_whitney(tmp_path, capsys):
    from scipy.stats import mannwhitneyu

    a, b = [1.0, 2.0, 3.0], [2.5, 4.0, 5.0, 6.0]
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(
        [json.dumps(row(f"ours_s{i}", v, v, v, "jax")) for i, v in enumerate(a)]
        + [json.dumps(row(f"torch_s{i}", v, v, v, "jax")) for i, v in enumerate(b)]) + "\n")
    verdicts.main(["spread", "--rows", str(path), "--a", "ours", "--a_seeds", "0-2",
                   "--b", "torch", "--b_seeds", "0-3"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["spread"] for x in lines] == list(verdicts.METRICS)
    want = mannwhitneyu(a, b, alternative="two-sided")
    for x in lines:
        assert x["p_two_sided"] == pytest.approx(want.pvalue)
        assert x["ours"]["median"] == 2.0 and x["torch"]["range"] == [2.5, 6.0]


def test_sweep_run_specs():
    runs = sweep.parse_runs(["h:celeba64:resize,ttur:6-8", "m:mnist:plain:0,2:64"])
    assert runs == {"h": ("celeba64", ["resize", "ttur"], [6, 7, 8], 60_000),
                    "m": ("mnist", ["plain"], [0, 2], 64)}
    for arm, flags in sweep.ARM_FLAGS.items():
        a = quality.parse_args(["train", *flags])
        assert quality.arm_prefix(
            ema_decay=a.ema_decay, bf16=a.bf16, adaptive=a.adaptive,
            ref_grad_scale=a.ref_grad_scale, gen_upsample=a.gen_upsample,
            ttur_g_lr=a.ttur_g_lr, d_steps=a.d_steps) == sweep.PREFIX[arm]
    assert quality.parse_args(["train", *sweep.ARM_FLAGS["ttur"]]).ttur_g_lr == 0.002
    with pytest.raises(SystemExit, match="unknown arms"):
        sweep.parse_runs(["h:celeba64:d3:6"])
