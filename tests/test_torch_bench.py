"""``python -m blurred_gan_tpu_torch.bench`` on the CPU, against the root
``bench.py``.

The root script is read with ``ast``, never imported (importing it switches
this worker's JAX PRNG to ``rbg``). Each mode runs in-process at 8², batch 2,
2 steps a window and 2 timed windows, on the CelebA networks' layout at
narrow widths (the 512-channel stacks cost minutes on a test worker that
shares the CPU with five others): one JSON line with the root script's keys
(its ``mfu_vs_bf16_peak`` is the port's ``mfu``) and its flags less
``--gen_gate``. The FLOP counter is held to XLA's cost analysis of the JAX
modules at their published widths.
"""

import ast
import json
import math
import pathlib
import statistics

import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch

from blurred_gan_tpu_torch import bench
from blurred_gan_tpu_torch.models.dcgan import (
    DCGANDiscriminator, DCGANGenerator, SameConv2d, SameConvTranspose2d)
from blurred_gan_tpu_torch.ops import blur_cuda
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import make_train_step
from torch_flop_gap import port_forwards, xla_flops, xla_forwards
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

ROOT_BENCH = pathlib.Path(__file__).resolve().parents[1] / "bench.py"
RES, BATCH, STEPS = 8, 2, 2
# Keys the root script writes that the port does not: the TPU-relative MFU
# (the port's is "mfu"), the best-effort peak's error (a failing peak fails
# the port's run) and the --gen_gate echo (not ported).
NOT_PORTED = {"mfu_vs_bf16_peak", "peak_error", "gen_gate"}
PEAK_KEYS = {"peak_images_per_sec", "peak_batch", "peak_ms_per_step"}
ADDED = {"backend", "device", "power_limit_w", "windows", "blur_launches_per_step", "correct",
         "mfu", "peak_flops_per_sec", "compute_dtype", "flops_per_step"}


def root_functions():
    tree = ast.parse(ROOT_BENCH.read_text())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def output_keys(fn):
    """The keys of the dict literal holding "metric" in ``fn``, and the keys
    ``out[...] = `` sets."""
    literal, assigned = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Dict):
            keys = {k.value for k in node.keys if isinstance(k, ast.Constant)}
            if "metric" in keys:
                literal |= keys
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == "out" and isinstance(t.slice, ast.Constant)):
                    assigned.add(t.slice.value)
    return literal, assigned


def narrow_generator(resolution, latent_size=100, upsample="transpose",
                     compute_dtype=torch.float32, bn_dtype=None, output_f32=True):
    """``celeba_generator``'s layout at 8² (4x4 Dense, a stride-1 and a
    stride-2 up-stage, Conv tanh) at 16 and 8 channels."""
    assert resolution == RES
    return DCGANGenerator(latent_size=latent_size, init_features=16,
                          blocks=((16, 1), (8, 2)), upsample=upsample,
                          compute_dtype=compute_dtype, bn_dtype=bn_dtype,
                          output_f32=output_f32)


def narrow_discriminator(resolution, compute_dtype=torch.float32):
    """``celeba_discriminator``'s layout at 8² (two stride-2 convolutions)
    at 8 and 16 channels."""
    return DCGANDiscriminator(channels=(8, 16), image_hw=(resolution, resolution),
                              compute_dtype=compute_dtype)


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench, "celeba_generator", narrow_generator)
    monkeypatch.setattr(bench, "celeba_discriminator", narrow_discriminator)
    monkeypatch.setattr(bench, "CPU_DEFAULTS", (RES, BATCH, STEPS))
    monkeypatch.setattr(bench, "WINDOWS", 2)
    monkeypatch.setitem(bench.INFER_BATCH, "cpu", BATCH)


def run(capsys, *argv):
    """bench.main in this process: (its exit code, the parsed line)."""
    code = 0
    try:
        bench.main([*argv, "--device", "cpu"])
    except SystemExit as e:
        code = e.code
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return code, json.loads(lines[0])


def test_flags_are_the_root_scripts():
    root = {a.value for node in ast.walk(root_functions()["main"])
            if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
            for a in node.args[:1]}
    assert "--gen_gate" in root and len(root) > 10
    args = bench.parse_args([])
    parser_flags = {f"--{k}" for k in vars(args)}
    # --ablation: benchmarks/step_ablation.py, a mode here, not a second script.
    assert parser_flags == (root - {"--gen_gate"}) | {"--device", "--ablation"}
    assert args.device == "cuda" and args.blur_impl == "auto"
    with pytest.raises(SystemExit):  # the port's names: cuda / torch for pallas / einsum
        bench.parse_args(["--blur_impl", "pallas"])


@pytest.mark.parametrize("mode, argv, root_fn", [
    ("default", [], "main"),
    ("chunked", ["--chunked"], "bench_chunked"),
    ("infer", ["--infer"], "bench_infer"),
    ("infer_export", ["--infer_export"], "bench_infer"),
])
def test_each_mode_prints_one_line_with_the_root_keys(small, capsys, mode, argv, root_fn):
    code, out = run(capsys, *argv)
    assert code == 0 and out["correct"] is True, out
    literal, _ = output_keys(root_functions()[root_fn])
    assert literal and (literal - NOT_PORTED) | ADDED <= set(out), sorted(literal - set(out))
    assert out["backend"] == "torch-cpu" and out["device"] == "cpu"
    assert out["power_limit_w"] is None and out["mfu"] is None  # no card: no peak
    assert len(out["windows"]) == 2
    assert out["value"] == pytest.approx(statistics.median(out["windows"]), abs=0.01)
    assert out["batch"] == BATCH and out["compute_dtype"] == "float32"
    assert out["blur_launches_per_step"] == 0  # the CPU runs the plain version
    suffix = {"default": "_wgangp_blur", "chunked": "_wgangp_blur_chunked",
              "infer": "", "infer_export": "_exported"}[mode]
    kind = "infer" if mode.startswith("infer") else "train"
    assert out["metric"] == f"{kind}_images_per_sec_celeba{RES}{suffix}"
    if mode == "chunked":
        assert out["chunk_steps"] == STEPS and math.isfinite(out["last_disc_loss"])
    if kind == "infer":
        assert out["exported"] is (mode == "infer_export") and "ms_per_batch" in out
        assert out["flops_per_step"] == round(
            bench.generator_flops_per_image(RES) * BATCH)
    else:
        assert out["step_check_max_rel_diff"] < 1e-3
        assert "peak_images_per_sec" not in out  # not the card's default invocation


def test_echoed_flags_and_peak_fields(small, capsys, monkeypatch):
    monkeypatch.setattr(bench, "wants_peak", lambda args, device: True)
    monkeypatch.setattr(bench, "PEAK_BATCH", 4)
    code, out = run(capsys, "--gen_upsample", "resize", "--blur_impl", "torch", "--fast_gen",
                    "--gp_every", "2", "--grad_accum", "2", "--ema_decay", "0.99")
    assert code == 0 and out["correct"] is True, out
    _, assigned = output_keys(root_functions()["main"])
    assert (assigned - NOT_PORTED) <= set(out), sorted(assigned - set(out))
    assert {k: out[k] for k in ("gen_upsample", "blur_impl", "fast_gen", "gp_every",
                                "grad_accum", "ema_decay")} == {
        "gen_upsample": "resize", "blur_impl": "torch", "fast_gen": True, "gp_every": 2,
        "grad_accum": 2, "ema_decay": 0.99}
    rate = out["peak_images_per_sec"]  # rounded to 0.01
    assert PEAK_KEYS <= set(out) and out["peak_batch"] == 4 and rate > 0.005
    assert 4e3 / (rate + 0.005) - 1e-3 <= out["peak_ms_per_step"] <= 4e3 / (rate - 0.005) + 1e-3
    assert len(out["peak_windows"]) == 2


def test_a_kernel_that_disagrees_with_the_plain_blur_exits_1(small, capsys, monkeypatch):
    plain = blur_cuda.blur_planes_reference
    # The "kernel" path on the CPU (BlurPlanes) goes through this name; the
    # plain path (impl="torch") through ops.blur's own import of it.
    monkeypatch.setattr(blur_cuda, "blur_planes_reference",
                        lambda p, th, tw: plain(p, th, tw) * 1.05)
    code, out = run(capsys)
    assert code == 1 and out["correct"] is False
    assert any(p.startswith("step check:") for p in out["problems"]), out["problems"]


def test_without_a_card_the_default_device_raises(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main([])
    assert capsys.readouterr().out == ""


def test_flops_do_not_depend_on_blur_or_dtype(small, capsys):
    """The bench's count for --blur_impl torch and the default is one number,
    and a bfloat16 step through the kernel path counted directly at batch 4
    reads what train_step_flops gives for float32 and the plain blur."""
    counts = {impl: run(capsys, "--blur_impl", impl)[1]["flops_per_step"]
              for impl in ("cuda", "torch")}
    assert counts["cuda"] == counts["torch"] > 0
    hp = bench.make_hparams(bench.parse_args([]), 4)
    gan = bench.make_gan(bench.parse_args([]), RES, torch.bfloat16, "auto")
    state = create_train_state(gan, hp, device="cpu")
    step = make_train_step(gan, hp)
    reals = bench.uniform_reals(4, RES, "cpu")
    direct = sum(bench.flop_counts(lambda: step(state, reals, torch.tensor(2.5)),
                                   gan.generator, gan.discriminator).values())
    assert direct == bench.train_step_flops(RES, hp)
    assert counts["torch"] == round(bench.train_step_flops(RES, bench.make_hparams(
        bench.parse_args([]), BATCH)))


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [4, 8])
def test_a_layers_taps_are_xlas(transposed, stride, size):
    """One bias-free 5x5 SAME layer: 2·MACs over the taps that read an input,
    exactly XLA's count of the flax layer (SAME padding and the transposed
    convolution's holes uncounted by both)."""
    cin, cout, n = 8, 16, 2
    layer = (SameConvTranspose2d(cin, cout, stride) if transposed
             else SameConv2d(cin, cout, stride, bias=False))
    torch.nn.init.zeros_(layer.weight)
    with torch.no_grad():
        port = sum(bench.flop_counts(lambda: layer(torch.zeros(n, cin, size, size)),
                                     layer).values())
    cls = fnn.ConvTranspose if transposed else fnn.Conv
    flax_layer = cls(cout, (5, 5), strides=(stride, stride), padding="SAME", use_bias=False)
    x = jnp.zeros((n, size, size, cin))
    params = flax_layer.init(jax.random.PRNGKey(0), x)
    assert port == xla_flops(flax_layer.apply, params, x)


@pytest.mark.parametrize("network", ["generator", "critic"])
def test_forward_flops_within_2pct_of_xla(network):
    """The CelebA networks' eval-mode forward at 16², batch 2. Both sides count
    convolutions as 2·MACs over the taps that read an input (the test above);
    XLA's cost analysis also counts the elementwise work (bias, BatchNorm,
    activations, tanh) that torch.utils.flop_counter leaves out, 0.15% of
    XLA's count here, so the port's is at most XLA's and within 2% of it."""
    port, xla = port_forwards(16, 2)[network], xla_forwards(16, 2)[network]
    assert port <= xla and (xla - port) / xla < 0.02, (port, xla)
