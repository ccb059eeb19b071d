"""``python -m blurred_gan_tpu_torch.bench --blur_ab`` (the port of
``benchmarks/blur_ab.py``) on the CPU.

The JAX script is read with ``ast``, never imported (it imports the JAX
package and configures a compilation cache): the mode's flags and defaults
are the script's, and each line carries the script's keys plus the card's
fields. A run at 16² prints one line per arm, its ``gflops`` the script's
``2·planes·R³·2`` over the median round; a kernel that disagrees with the
plain blur exits 1 before any timing.
"""

import ast
import json
import pathlib
import statistics

import pytest

from blurred_gan_tpu_torch import bench
from blurred_gan_tpu_torch.ops import blur_cuda
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

JAX_SCRIPT = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" / "blur_ab.py"
# The port's keys beyond the script's: the backend and the card's power limit
# (its "device" is the card's name), each round's time, the check.
ADDED = {"backend", "power_limit_w", "us_per_blur_rounds", "max_abs_err", "correct"}
ARGV = ["--blur_ab", "--device", "cpu", "--resolutions", "16", "--min-seconds", "0.01"]


def jax_functions():
    tree = ast.parse(JAX_SCRIPT.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def run(capsys, argv):
    """bench.main in this process: (its exit code, the parsed lines)."""
    code = 0
    try:
        bench.main(argv)
    except SystemExit as e:
        code = e.code
    return code, [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_flags_and_defaults_are_the_jax_scripts():
    calls = [node for node in ast.walk(jax_functions()["main"])
             if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"]
    flags = {c.args[0].value: next(k.value.value for k in c.keywords if k.arg == "default")
             for c in calls}
    assert flags == {"--resolutions": "128,256", "--batch": 32, "--min-seconds": 0.5}
    args = bench.parse_args(["--blur_ab"])
    assert (args.resolutions, args.min_seconds, args.device) == ("128,256", 0.5, "cuda")
    # --batch is the train modes' too (default None there); --blur_ab reads None as 32.
    assert args.batch is None


def test_a_cpu_run_prints_the_jax_scripts_keys(capsys):
    row = next(node for node in ast.walk(jax_functions()["time_impl"])
               if isinstance(node, ast.Dict)
               and "us_per_blur" in {k.value for k in node.keys if isinstance(k, ast.Constant)})
    jax_keys = {k.value for k in row.keys}
    code, lines = run(capsys, ARGV)
    assert code == 0 and [line["impl"] for line in lines] == list(bench.BLUR_AB_IMPLS)
    for line in lines:
        assert set(line) == jax_keys | ADDED
        assert line["correct"] is True and line["device"] == "cpu"
        assert (line["resolution"], line["batch"], line["backend"]) == (16, 32, "torch-cpu")
        assert line["iters"] % bench.BLUR_AB_CHUNK == 0 and line["max_abs_err"] <= 1e-5
        assert len(line["us_per_blur_rounds"]) == bench.WINDOWS
        assert line["us_per_blur"] == round(statistics.median(line["us_per_blur_rounds"]), 2)
        want = 2 * 32 * 3 * 16 ** 3 * 2 / (line["us_per_blur"] * 1e-6) / 1e9
        assert line["gflops"] == pytest.approx(want, rel=1e-3, abs=0.06)


def test_a_kernel_that_disagrees_with_the_plain_blur_exits_1(capsys, monkeypatch):
    plain = blur_cuda.blur_planes_reference
    # The kernel's path on the CPU goes through this name; the plain arm
    # (impl="torch") through ops.blur's own import of it.
    monkeypatch.setattr(blur_cuda, "blur_planes_reference",
                        lambda p, th, tw: plain(p, th, tw) * 1.05)
    code, lines = run(capsys, ARGV)
    assert code == 1 and len(lines) == 1
    assert lines[0]["correct"] is False and lines[0]["max_abs_err"] > 1e-3
    assert "us_per_blur" not in lines[0]


@pytest.mark.parametrize("other", ["--chunked", "--infer", "--infer_export", "--ablation"])
def test_blur_ab_takes_no_other_mode(other):
    with pytest.raises(SystemExit):
        bench.parse_args(["--blur_ab", other])
