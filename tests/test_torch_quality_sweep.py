"""``tests/torch_quality_sweep.py``'s run specs, the command line it builds
for each arm with and without the TPU precision harness, and its check of a
harness run's meta. Nothing here trains or scores."""

import json
import os
import sys

import pytest

import torch_quality_sweep as sweep
import torch_tpu_precision
from blurred_gan_tpu_torch import quality
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.mark.parametrize("spec, want", [
    ("h:celeba64:plain,d2,refscale:12-23:tpu",
     ("celeba64", ["plain", "d2", "refscale"], list(range(12, 24)), 60_000, True)),
    ("s:celeba64_sharp:plain:0-23", ("celeba64_sharp", ["plain"], list(range(24)), 60_000, False)),
    ("m:mnist:plain,bf16:0,2:64:tpu", ("mnist", ["plain", "bf16"], [0, 2], 64, True)),
    ("m:mnist:d2:5:64", ("mnist", ["d2"], [5], 64, False)),
])
def test_parse_runs(spec, want):
    name = spec.split(":")[0]
    assert sweep.parse_runs([spec]) == {name: want}


def test_parse_runs_refuses_unknown_arms():
    with pytest.raises(SystemExit, match="unknown arms"):
        sweep.parse_runs(["h:celeba64:d2,tpu:6"])


@pytest.mark.parametrize("arm", sorted(sweep.ARM_FLAGS))
@pytest.mark.parametrize("tpu", [False, True])
def test_train_cmd(arm, tpu):
    """Each arm's command line: ``quality train``, or the harness's ``train``
    with the same flags; the flags select the arm's prefix."""
    cmd = sweep.train_cmd("celeba64", arm, 7, 60_000, "/w/h", tpu=tpu, concurrent=6)
    head = ([sys.executable, sweep.HARNESS] if tpu
            else [sys.executable, "-m", "blurred_gan_tpu_torch.quality"])
    assert cmd[:len(head)] == head
    rest = cmd[len(head):]
    assert rest == ["train", "--config", "celeba64", "--examples", "60000", "--seed", "7",
                    "--out", "/w/h", "--concurrent_runs", "6", "--device", "cuda",
                    *sweep.ARM_FLAGS[arm]]
    a = quality.parse_args(rest)
    assert quality.arm_prefix(
        ema_decay=a.ema_decay, bf16=a.bf16, adaptive=a.adaptive,
        ref_grad_scale=a.ref_grad_scale, gen_upsample=a.gen_upsample,
        ttur_g_lr=a.ttur_g_lr, d_steps=a.d_steps) == sweep.PREFIX[arm]


def test_harness_path():
    """The harness the sweep runs is the one beside it, and its ``main``
    reads ``quality``'s flags."""
    assert os.path.samefile(sweep.HARNESS, torch_tpu_precision.__file__)
    assert quality.parse_args(["train", *sweep.ARM_FLAGS["d2"]]).d_steps == 2
    assert quality.parse_args(["train", *sweep.ARM_FLAGS["refscale"]]).ref_grad_scale


@pytest.mark.parametrize("meta, tpu, fault", [
    (None, False, "no meta"),
    (None, True, "no meta"),
    ({"seed": 0}, False, None),
    ({"seed": 0}, True, "no products"),
    ({"seed": 0, "tpu_precision": {"products": 0}}, True, "no products"),
    ({"seed": 0, "tpu_precision": {"operands": "bfloat16", "products": 147}}, True, None),
    ({"seed": 0, "tpu_precision": {"products": 147}}, False, None),
])
def test_meta_fault(tmp_path, meta, tpu, fault):
    path = tmp_path / "torch_meta_s0.json"
    if meta is not None:
        path.write_text(json.dumps(meta))
    got = sweep.meta_fault(str(path), tpu)
    if fault is None:
        assert got is None
    else:
        assert fault in got and str(path) in got


def test_a_failed_harness_run_fails_the_sweep(tmp_path, monkeypatch):
    """A harness run that exits 0 but writes a meta without its count fails
    the sweep; the training command is the harness's."""
    ran = []

    def fake_pool(jobs, workers):
        for cmd, *_ in jobs:
            ran.append(cmd)
            if "train" in cmd:
                out, seed = cmd[cmd.index("--out") + 1], cmd[cmd.index("--seed") + 1]
                with open(os.path.join(out, f"torch_meta_s{seed}.json"), "w") as f:
                    json.dump({"seed": int(seed)}, f)
        return []

    monkeypatch.setattr(sweep, "in_pool", fake_pool)
    out = tmp_path / "out"
    rc = sweep.main(["--runs", "t:mnist:plain:0:64:tpu", "--out", str(out),
                     "--work", str(tmp_path / "work"), "--device", "cpu"])
    assert rc == 1
    report = json.loads((out / "sweep.json").read_text())
    assert len(report["failed"]) == 1 and "no products" in report["failed"][0]
    assert report["runs"]["t"]["tpu_precision"] is True
    assert ran[0][:2] == [sys.executable, sweep.HARNESS]
