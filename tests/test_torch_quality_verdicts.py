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


def pair_specs(files, side):
    """``--arm`` specs of the plain ``torch`` rows and the ``side`` rows of
    the same files, each labelled by its prefix."""
    joined = ",".join(files)
    return [f"torch=torch@{joined}", f"{side}={side}@{joined}"]


def test_pairs_match_the_pooled_file():
    """``verdicts pairs`` over sharp-64's six bf16 pairs gives the pooled
    file's gaps of the medians and wins."""
    files = [os.path.join(BF16, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    files += [os.path.join(SHARP, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    args = argparse.Namespace(arm=pair_specs(files, "torch_bf16"), seeds="0-5")
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
    args = argparse.Namespace(arm=pair_specs(files, "torch_bf16"), seeds="0-11")
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
    assert runs == {"h": ("celeba64", ["resize", "ttur"], [6, 7, 8], 60_000, False),
                    "m": ("mnist", ["plain"], [0, 2], 64, False)}
    for arm, flags in sweep.ARM_FLAGS.items():
        a = quality.parse_args(["train", *flags])
        assert quality.arm_prefix(
            ema_decay=a.ema_decay, bf16=a.bf16, adaptive=a.adaptive,
            ref_grad_scale=a.ref_grad_scale, gen_upsample=a.gen_upsample,
            ttur_g_lr=a.ttur_g_lr, d_steps=a.d_steps) == sweep.PREFIX[arm]
    assert quality.parse_args(["train", *sweep.ARM_FLAGS["ttur"]]).ttur_g_lr == 0.002
    with pytest.raises(SystemExit, match="unknown arms"):
        sweep.parse_runs(["h:celeba64:d3:6"])


def write_rows(path, rows):
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return str(path)


@pytest.mark.parametrize("counts, want", [
    ((4, 12, 0, 3), 0.516484),    # the port's 4 of 12 against JAX's 0 of 3
    ((8, 24, 1, 24), 0.022609),
    ((8, 24, 2, 24), 0.072265),
    ((5, 24, 0, 24), 0.049645),
    ((0, 24, 0, 24), 1.0),
])
def test_fisher_exact(counts, want):
    from scipy.stats import fisher_exact

    a, n_a, b, n_b = counts
    got = verdicts.fisher_exact(a, n_a, b, n_b)
    assert round(got, 6) == want
    assert got == pytest.approx(fisher_exact([[a, n_a - a], [b, n_b - b]])[1], rel=1e-12)


@pytest.mark.parametrize("n, j, want", [(6, 2, 1 / 28), (18, 2, 1 / 190), (12, 3, 1 / 455)])
def test_exchangeable_p(n, j, want):
    assert verdicts.exchangeable_p(n, j) == pytest.approx(want, rel=1e-15)


def test_arm_rows_read_one_prefix(tmp_path):
    """An arm's rows come from its own files: the harness's ``torch_s<S>``
    and the plain run's ``torch_s<S>`` stay apart under their labels."""
    plain = write_rows(tmp_path / "plain.jsonl", [row("torch_s0", 5.0, 0.1),
                                                  row("torch_bf16_s0", 9.0, 0.3)])
    tpu = write_rows(tmp_path / "tpu.jsonl", [row("torch_s0", 7.0, 0.2),
                                              row("reals_vs_reals", 0.1, 0.0)])
    assert verdicts.arm_rows(f"f32=torch@{plain}") == ("f32", {0: row("torch_s0", 5.0, 0.1)})
    label, got = verdicts.arm_rows(f"tpu=torch@{tpu},{plain}")  # the first file wins
    assert (label, got[0]["fid_randconv"]) == ("tpu", 7.0)
    assert verdicts.arm_rows(f"bf16=torch_bf16@{plain}")[1][0]["fid_randconv"] == 9.0


@pytest.mark.parametrize("f32_fids, tpu_fids, collapsed, want", [
    ([150.0] * 8 + [10.0] * 16, [150.0] + [10.0] * 23, (8, 1), True),
    ([150.0] * 8 + [10.0] * 16, [150.0] * 2 + [10.0] * 22, (8, 2), False),  # p 0.072
    ([10.0] * 24, [150.0] * 8 + [10.0] * 16, (0, 8), False),                # more, not fewer
    ([100.0] * 24, [10.0] * 24, (0, 0), False),                             # 100 is no collapse
])
def test_collapse_rule(tmp_path, capsys, f32_fids, tpu_fids, collapsed, want):
    a = write_rows(tmp_path / "a.jsonl", [row(f"torch_s{s}", v, 0.1) for s, v in enumerate(f32_fids)])
    b = write_rows(tmp_path / "b.jsonl", [row(f"torch_s{s}", v, 0.1) for s, v in enumerate(tpu_fids)])
    verdicts.main(["collapse", "--seeds", "0-23", "--arm", f"f32=torch@{a}",
                   "--arm", f"tpu=torch@{b}"])
    (got,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert (got["arms"]["f32"]["collapsed"], got["arms"]["tpu"]["collapsed"]) == collapsed
    assert got["second_fewer_p_lt_0.05"] is want
    assert got["arms"]["tpu"]["seeds"] == [s for s, v in enumerate(tpu_fids) if v > 100]


def test_collapse_refuses_missing_seeds(tmp_path):
    a = write_rows(tmp_path / "a.jsonl", [row(f"torch_s{s}", 5.0, 0.1) for s in range(3)])
    with pytest.raises(SystemExit, match=r"no rows for seeds \[3\]"):
        verdicts.main(["collapse", "--seeds", "0-3", "--arm", f"x=torch@{a}",
                       "--arm", f"y=torch@{a}"])


def test_pairs_over_two_arms(tmp_path, capsys):
    """``pairs --arm`` gaps the second arm against the first, each read from
    its own files under one prefix."""
    tpu = write_rows(tmp_path / "tpu.jsonl",
                     [row(f"torch_s{s}", 10.0 + s, 0.01 * (s + 1)) for s in range(4)])
    bf16 = write_rows(tmp_path / "bf16.jsonl",
                      [row(f"torch_bf16_s{s}", 20.0 + s, 0.03 * (s + 1)) for s in range(4)]
                      + [row(f"torch_s{s}", 500.0, 0.9) for s in range(4)])
    verdicts.main(["pairs", "--seeds", "0-3", "--arm", f"tpu=torch@{tpu}",
                   "--arm", f"bf16=torch_bf16@{bf16}"])
    (got,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got["pairs"] == "bf16_vs_tpu"
    assert got["gap_of_medians"]["fid_randconv"] == round((21.5 - 11.5) / 11.5, 4)
    assert got["gap_of_medians"]["kid"] == pytest.approx(2.0, abs=1e-4)
    assert got["collapses_fid_randconv_gt_100"] == {"tpu": [], "bf16": []}
    with pytest.raises(SystemExit):
        verdicts.main(["pairs", "--seeds", "0-3", "--arm", f"tpu=torch@{tpu}"])


def heavy_rows(fid_gaps, kid_gaps, arm="d2"):
    """Plain and arm rows whose per-seed gaps are the given ones, s6 on."""
    out = []
    for i, (f, k) in enumerate(zip(fid_gaps, kid_gaps)):
        s = 6 + i
        out += [row(f"torch_s{s}", 100.0, 0.2), row(f"torch_{arm}_s{s}", 100.0 * (1 + f),
                                                    0.2 * (1 + k))]
    return out


JAX_D2 = [{"rel_gap_d2_vs_d1": {"fid_randconv": -0.8357, "kid": -0.9065}, "seed": 6},
          {"rel_gap_d2_vs_d1": {"fid_randconv": -0.6405, "kid": -0.8912}, "seed": 7}]


@pytest.mark.parametrize("fid_low, kid_low, verdict", [
    (-0.5, -0.6, "differs"),       # JAX's two below all 18 on both
    (-0.7, -0.6, "undecided"),     # a port seed below JAX's s7 on fid
    (-0.9, -0.95, "reproduces"),   # JAX's inside the port's spread on both
])
def test_rank_rule(tmp_path, capsys, fid_low, kid_low, verdict):
    fids = [fid_low] + [0.1 * i for i in range(17)]
    kids = [kid_low] + [0.05 * i for i in range(17)]
    rows = write_rows(tmp_path / "rows.jsonl", heavy_rows(fids, kids))
    jax = write_rows(tmp_path / "jax.jsonl", JAX_D2)
    verdicts.main(["rank", "--arms", "d2", "--seeds", "6-23", "--rows", rows, "--jax", jax])
    (got,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got["verdict"] == verdict
    assert got["p_one_side"] == round(1 / 190, 6) and got["jax_seeds"] == [6, 7]
    fid = got["metrics"]["fid_randconv"]
    assert fid["differs"] is (fid_low > -0.6405)
    assert fid["port_below_each_jax"] == {"6": int(fid_low < -0.8357),
                                          "7": int(fid_low < -0.6405)}


def test_rank_above_all(tmp_path, capsys):
    """JAX's gaps both above every port gap differ too."""
    rows = write_rows(tmp_path / "rows.jsonl", heavy_rows([-1.0 + 0.01 * i for i in range(6)],
                                                          [-1.0 + 0.01 * i for i in range(6)],
                                                          arm="refscale"))
    jax = write_rows(tmp_path / "jax.jsonl", [
        {"rel_gap_refscale_vs_default": {"fid_randconv": -0.3, "kid": -0.4}, "seed": 6},
        {"rel_gap_refscale_vs_default": {"fid_randconv": -0.4, "kid": -0.5}, "seed": 7}])
    verdicts.main(["rank", "--arms", "refscale", "--seeds", "6-11", "--rows", rows,
                   "--jax", jax])
    (got,) = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got["verdict"] == "differs" and got["p_one_side"] == round(1 / 28, 6)
    assert all(m["jax_above_all"] and not m["jax_below_all"] for m in got["metrics"].values())


def test_rank_on_the_recorded_jax_gaps():
    """The recorded JAX per-seed gaps that the fault B rule reads."""
    files = [os.path.join(HEAVY, f"eval_arms_s{s}.jsonl") for s in (6, 7)]
    lines = verdicts.json_lines(files)
    for arm, want in {"d2": {6: (-0.8357, -0.9065), 7: (-0.6405, -0.8912)},
                      "refscale": {6: (-0.3094, -0.4609), 7: (-0.4517, -0.5275)}}.items():
        got = {x["seed"]: x[verdicts.JAX_GAP_KEYS[arm]] for x in lines
               if verdicts.JAX_GAP_KEYS[arm] in x}
        assert {s: (g["fid_randconv"], g["kid"]) for s, g in got.items()} == pytest.approx(
            want, abs=1e-9)


TPU_HEAVY = os.path.join(ROOT, "results", "quality", "torch", "tpu_precision", "celeba64")


def tpu_heavy_rows():
    """The heavy-64 rows under the TPU precision harness, s6-23."""
    files = [os.path.join(TPU_HEAVY, f"eval_torch{arm}_s{s}.jsonl")
             for arm in ("", "_d2_refscale") for s in ("678", "91011")]
    return ",".join(files + [os.path.join(TPU_HEAVY, "s12-23", f"eval_heavy64_tpu_s{s}.jsonl")
                             for s in range(12, 24)])


def test_committed_heavy64_rank(capsys):
    """``verdicts rank`` over the committed heavy-64 harness rows gives the
    committed lines: d2 differs from JAX's gaps on KID alone (undecided),
    refscale on neither metric (reproduces)."""
    jax = ",".join(os.path.join(HEAVY, f"eval_arms_s{s}.jsonl") for s in (6, 7))
    verdicts.main(["rank", "--arms", "d2,refscale", "--seeds", "6-23", "--rows",
                   tpu_heavy_rows(), "--jax", jax])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    with open(os.path.join(TPU_HEAVY, "rank_s6-23.jsonl")) as f:
        assert got == [json.loads(line) for line in f]
    assert [(x["rank"], x["verdict"]) for x in got] == [("d2", "undecided"),
                                                        ("refscale", "reproduces")]
    assert [m["differs"] for m in got[0]["metrics"].values()] == [False, True]


def test_committed_heavy64_pairs(capsys):
    """``verdicts pairs`` of d2 and refscale over the eighteen pairs s6-23
    gives the committed pooled lines."""
    for arm in ("d2", "refscale"):
        plain, side = pair_specs([tpu_heavy_rows()], f"torch_{arm}")
        verdicts.main(["pairs", "--seeds", "6-23", "--arm", plain, "--arm", side])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    with open(os.path.join(TPU_HEAVY, "pairs_s6-23.jsonl")) as f:
        assert got == [json.loads(line) for line in f]
    assert [x["seeds"] for x in got] == [list(range(6, 24))] * 2


TPU_SHARP = os.path.join(ROOT, "results", "quality", "torch", "tpu_precision", "celeba64_sharp")


def sharp_arms():
    """``--arm`` specs of sharp-64's true float32 (s0-23), its float32
    under the TPU precision harness (s0-23) and its bf16 (s0-11)."""
    f32 = [os.path.join(SHARP, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    f32 += [os.path.join(SHARP, "s6-11", f"eval_sharp64_s{s}.jsonl") for s in range(6, 12)]
    f32 += [os.path.join(SHARP, "s12-23", f"eval_sharp64_f32_s{s}.jsonl") for s in range(12, 24)]
    tpu = [os.path.join(TPU_SHARP, f"eval_sharp64_tpu_s{s}.jsonl") for s in range(24)]
    bf16 = [os.path.join(BF16, f"eval_torch_bf16_s{s}.jsonl") for s in ("012", "345")]
    bf16 += [os.path.join(SHARP, "s6-11", f"eval_sharp64_s{s}.jsonl") for s in range(6, 12)]
    return {"f32": "f32=torch@" + ",".join(f32), "tpu": "tpu=torch@" + ",".join(tpu),
            "bf16": "bf16=torch_bf16@" + ",".join(bf16)}


def committed(name):
    with open(os.path.join(TPU_SHARP, name)) as f:
        return [json.loads(line) for line in f]


def test_committed_sharp_collapse(capsys):
    """``verdicts collapse`` over the committed sharp-64 rows gives the
    committed line: 4 of 24 true float32 sets collapse, 2 of 24 under the
    harness, p 0.67, so fault A's rule (i) does not hold."""
    arms = sharp_arms()
    verdicts.main(["collapse", "--seeds", "0-23", "--arm", arms["f32"], "--arm", arms["tpu"]])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == committed("collapse_s0-23.jsonl")
    assert [got[0]["arms"][a]["seeds"] for a in ("f32", "tpu")] == [[2, 5, 6, 9], [18, 21]]
    assert got[0]["second_fewer_p_lt_0.05"] is False


def test_committed_sharp_tpu_pairs(capsys):
    """``verdicts pairs`` of bf16 against the harness's float32 (s0-11) and
    of the harness against true float32 (s0-23) give the committed lines;
    the bf16 gap of the medians is negative on fid_randconv and KID."""
    arms = sharp_arms()
    verdicts.main(["pairs", "--seeds", "0-11", "--arm", arms["tpu"], "--arm", arms["bf16"]])
    verdicts.main(["pairs", "--seeds", "0-23", "--arm", arms["f32"], "--arm", arms["tpu"]])
    got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert got == (committed("pairs_bf16_vs_tpu_s0-11.jsonl")
                   + committed("pairs_tpu_vs_f32_s0-23.jsonl"))
    assert got[0]["pairs"] == "bf16_vs_tpu"
    assert got[0]["gap_of_medians"]["fid_randconv"] < 0 and got[0]["gap_of_medians"]["kid"] < 0
