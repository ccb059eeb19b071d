#!/usr/bin/env python3
"""Drive the PyTorch port's CelebA-128 blurred WGAN-GP training path on one CUDA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure:

1. require a CUDA device; print the card's name and power limit (nvidia-smi);
2. build the blur kernel from ``blurred_gan_tpu_torch/csrc`` with nvcc;
3. hold the kernel against its plain PyTorch version (forward, backward and
   the penalty's double backward) at 28², 64², 128² (192 planes), 256²,
   16x32 and 36x30, then at 192 planes of 128² with band matrices across the σ range
   (the 3-tap floor, σ = 5, the clip at σ = 100), a random dense T and a T
   with an all-zero row tile and column tile, then at MNIST's shapes (64 and
   32 planes of 28²) at its σ of phase 11 (0.05 and 23.5);
4. the slice: ``Trainer.fit`` at the full CelebA-128 widths, batch 32, float32,
   σ₀ = 5, on the synthetic corpus, for 12 steps; losses finite, σ from
   ``BlurDecayController``, the kernel launched the same positive number of
   times every step, neither jax nor the JAX package ever imported;
5. one step with the kernel against one step with the plain blur from the same
   weights and draws; then the step's images/s with each, and the kernel's
   time per call against the plain version's and its bound at σ = 5 and
   σ = 100, for 192 and 96 planes; a profile of a few steps; then ``fit`` and
   the fixed-batch step with Adam as ``fit`` runs it (non-capturable) and as
   the chunked mode does (capturable), in turns;
6. the kernel's occupancy;
7. the full run: a ``Trainer`` with the entry point's SWD and FID feeders at
   small cadences, a checkpoint and a sample grid every 192 examples and
   image summaries every 4 batches, for 12 steps; SWD and FID in
   ``events.jsonl``, checkpoints within ``max_to_keep``, the grid PNG's size,
   the kernel's launches per step as in phase 4;
8. resume: a fresh ``Trainer`` on the same run directory restores the latest
   checkpoint bit for bit, and its next step's losses equal the live state's;
9. evaluation at the users' protocol: SWD over 1000 pairs, random-conv FID
   and Inception FID (random weights) over 100 pairs, ``Trainer.evaluate``
   over 1000, each against a reference on a small input and as a share of the
   50,000-example interval;
10. the chunked mode: ``Trainer.fit_device_resident`` from phase 4's weights,
    data stream and seed, 2 chunks of 6 steps, each step a replay of the
    captured train step: per-step losses equal to those of ``fit`` from the
    same start with the chunked mode's capturable Adam, both with
    deterministic cuDNN, and phase 4's first step; σ
    bit-equal to ``fit``'s and on the schedule; the kernel launched 6 times per
    replayed step (counted by the
    profiler: a replay launches nothing from the host), two replays with
    different seeds drawing different latents and a replay drawing what the
    eager step draws; then chunked images/s beside phase 4's ``fit`` and phase
    5's fixed-batch step, the capture's seconds and the device's busy share
    during a chunk;
11. MNIST at its published widths, batch 32: ``python -m
    blurred_gan_tpu_torch.train_mnist --device_resident`` for 3 chunks (its
    SWD and FID at the first chunk boundary), 2 chunks of 25 against 50 steps
    of ``fit`` (capturable Adam, deterministic cuDNN: every step's losses and
    σ), chunked against ``fit`` images/s, an adaptive chunked run whose
    controller stops inside a chunk against the run that stopped there, and
    the kernel's time at 28² (calls replayed from a CUDA graph, so the host's
    launch time is not counted) against its plain version's output, beside its
    bound;
    then one JSON line describing the kernel and the result line.

The last line of output is ``{"ok": true, "device": {...}}``; nothing is
printed there on failure, and the exit code is then non-zero.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch  # noqa: E402

RES, BATCH, SIGMA0, STEPS, NUM_EXAMPLES = 128, 32, 5.0, 12, 2048
# (planes, H, W): the three orders of the blur at the shapes the tests use;
# 192 planes at 128² is the critic's call on cat([fakes, reals]) at batch 32.
# 6x36x30 takes the kernel's scalar path (a width that is no multiple of 4).
KERNEL_SHAPES = [(192, 28, 28), (192, 64, 64), (192, 128, 128), (24, 256, 256), (6, 16, 32),
                 (6, 36, 30)]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)   # float32 both sides, another summation order
# σ of the band cases: the 3-tap floor, the run's σ₀, the clip to 128 taps.
SIGMA_SWEEP = (0.1, SIGMA0, 100.0)
# The card's published peaks (H100 SXM, 700 W): float32 off the tensor cores,
# and device memory.
PEAK_F32_FLOPS, PEAK_BYTES_PER_S = 67e12, 3.35e12
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)  # as the CPU parity tests
STEP_TOL = dict(rtol=1e-3, atol=1e-4)  # one full step, kernel vs plain blur
# Phase 7's cadences (examples, batches) and retention.
FULL_EVERY, FULL_SWD_SAMPLES, FULL_FID_SAMPLES, FULL_SUMMARIES, FULL_KEEP = 192, 128, 64, 4, 2
# Phase 9: the entry point's protocol, and its interval in examples.
EVAL_SWD, EVAL_FID, EVAL_INTERVAL = 1000, 100, 50_000
METRIC_TOL = dict(rtol=1e-3, atol=1e-3)  # a metric on the card vs on the CPU
# Phase 10: chunks of the comparison with phase 4, then of the timed run.
CHUNK, TIMED_CHUNK, TIMED_CHUNKS = 6, 25, 4
PARAM_TOL = dict(rtol=5e-4, atol=5e-5)  # chunked vs host-loop state (tests/test_fast.py)
# Phase 11: MNIST steps, chunk and chunks; its σ at the timings (the 3-tap
# floor of --initial_blur_std 0.05, and the adaptive controller's σ₀).
MNIST_RES, MNIST_FIT_STEPS, MNIST_CHUNK, MNIST_CHUNKS = 28, 200, 100, 4
MNIST_SIGMAS = (0.05, 23.5)
MNIST_CMP_CHUNK, MNIST_CMP_CHUNKS = 25, 2  # chunked against fit, step by step
# Phase 5e: fit's steps per run, and the fixed-batch step's.
ADAM_FIT_STEPS, ADAM_STEPS = 24, 10


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    yield
    log(f"[phase] {name}: {time.perf_counter() - t0:.1f} s")


def non_jax_check() -> None:
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    reference = sorted(m for m in sys.modules
                       if m == "blurred_gan_tpu" or m.startswith("blurred_gan_tpu."))
    if reference:
        raise RuntimeError(f"the JAX package was imported: {reference}")


def smoke_args(log_dir: str, **flags):
    """The entry point's arguments for the smoke configuration."""
    from blurred_gan_tpu_torch.train_celeba import parse_args

    argv = ["--resolution", str(RES), "--batch_size", str(BATCH), "--max_steps", str(STEPS),
            "--max_blur_std", str(SIGMA0), "--num_examples", str(NUM_EXAMPLES), "--seed", "0",
            "--device", "cuda", "--log_dir", log_dir]
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return parse_args(argv)


def count_step_launches(blur_cuda, trainer):
    """Wrap the trainer's step so each call records the kernel launches made
    inside it; returns that list."""
    per_step = []
    step = trainer.step_fn

    def counted(*a, **k):
        before = blur_cuda.launch_count
        out = step(*a, **k)
        per_step.append(blur_cuda.launch_count - before)
        return out

    trainer.step_fn = counted
    return per_step


def adam_steps(step, capturable: bool):
    """``step`` with both Adams switched to ``capturable`` (or back) first."""
    from blurred_gan_tpu_torch.train.state import set_capturable

    def run(state, *a, **k):
        set_capturable(state.g_opt, capturable)
        set_capturable(state.d_opt, capturable)
        return step(state, *a, **k)
    return run


def capturable_adam(trainer):
    """The trainer, its eager steps run with capturable Adam: the chunked
    mode's arithmetic (``fit`` itself runs Adam non-capturable, which rounds
    the bias correction differently), so ``fit`` computes what a replay does."""
    trainer.step_fn = adam_steps(trainer.step_fn, True)
    return trainer


def check_history(trainer, history, what: str) -> None:
    if len(history) != STEPS:
        raise RuntimeError(f"{what}: fit took {len(history)} steps, not {STEPS}")
    for n, logs in enumerate(history):
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss"):
            if not math.isfinite(logs[k]):
                raise RuntimeError(f"{what}, step {n + 1}: {k} = {logs[k]}")
        want = trainer.blur_controller.sigma(n)
        if not math.isclose(logs["std"], want, rel_tol=1e-6):
            raise RuntimeError(f"{what}, step {n + 1}: sigma {logs['std']} != schedule {want}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_cases(blur_matrix, device):
    """(label, planes, t_h, t_w) for phase 3."""
    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for p, h, w in KERNEL_SHAPES:
        cases.append((f"{p}x{h}x{w} sigma 2", torch.randn(p, h, w, device=device, generator=gen),
                      blur_matrix(2.0, h, max(h, w), device=device),
                      blur_matrix(2.0, w, max(h, w), device=device)))
    p = 2 * BATCH * 3

    def planes():
        return torch.randn(p, RES, RES, device=device, generator=gen)

    for sigma in SIGMA_SWEEP:
        t = blur_matrix(sigma, RES, device=device)
        cases.append((f"{p}x{RES}x{RES} sigma {sigma}", planes(), t, t))
    dense = torch.randn(RES, RES, device=device, generator=gen) / RES ** 0.5
    cases.append((f"{p}x{RES}x{RES} random dense T", planes(), dense, dense))
    zero_tile = blur_matrix(SIGMA0, RES, device=device)
    zero_tile[32:64, :] = 0   # an empty row tile of T_h
    zero_tile[:, 64:96] = 0   # an empty column tile of T_w
    cases.append((f"{p}x{RES}x{RES} zero-tile T", planes(), zero_tile, zero_tile))
    # MNIST b32: the critic on cat([fakes, reals]) and the other five calls.
    for sigma in MNIST_SIGMAS:
        t = blur_matrix(sigma, MNIST_RES, device=device)
        for p in (2 * BATCH, BATCH):
            cases.append((f"{p}x{MNIST_RES}x{MNIST_RES} sigma {sigma}",
                          torch.randn(p, MNIST_RES, MNIST_RES, device=device, generator=gen),
                          t, t))
    return cases


def check_kernel(blur_cuda, blur_matrix, device):
    """Phase 3. Returns the largest absolute error seen."""
    worst = 0.0
    for label, x, t_h, t_w in kernel_cases(blur_matrix, device):
        p = x.shape[0]
        x.requires_grad_(True)
        pairs = []
        outs = {}
        for name, fn in (("cuda", blur_cuda.blur_planes),
                         ("plain", blur_cuda.blur_planes_reference)):
            y = fn(x, t_h, t_w)
            (g,) = torch.autograd.grad(torch.sum(y ** 2), x, create_graph=True)
            penalty = torch.sum(torch.sqrt(torch.sum(g.reshape(p, -1) ** 2, 1)))
            (gg,) = torch.autograd.grad(penalty, x)
            outs[name] = (y.detach(), g.detach(), gg)
        torch.cuda.synchronize()
        errs = []
        for order, tol, a, b in zip(("forward", "backward", "double backward"),
                                    (FWD_TOL, GRAD_TOL, GRAD_TOL), outs["cuda"], outs["plain"]):
            torch.testing.assert_close(a, b, **tol, msg=lambda m: f"{order} {label}: {m}")
            errs.append(float((a - b).abs().max()))
            pairs.append(f"{order} {errs[-1]:.3e}")
        worst = max(worst, *errs)
        log(f"[kernel] {label}: max |cuda - plain|: " + ", ".join(pairs))
    return worst


def run_slice(blur_cuda, workdir):
    """Phase 4: the plain fit (no hooks, no feeders). Returns (trainer,
    history, launches, launches per step)."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    args = smoke_args(os.path.join(workdir, "slice"), sample_grid_every=0, checkpoint_every=0,
                      save_image_summaries_interval=0)
    trainer, total = build_trainer(args, feeders=[])
    per_step = count_step_launches(blur_cuda, trainer)
    blur_cuda.launch_count = 0
    trainer.fit(total_examples=total, max_steps=STEPS)
    torch.cuda.synchronize()
    launches = blur_cuda.launch_count
    history = list(trainer.history)
    check_history(trainer, history, "phase 4")
    if len(set(per_step)) != 1 or per_step[0] < 3:
        raise RuntimeError(f"kernel launches per step {per_step}: expected the same "
                           f"number, at least 3, every step")
    if launches != sum(per_step):
        raise RuntimeError(f"{launches} launches, {sum(per_step)} counted by step")
    non_jax_check()
    return trainer, history, launches, per_step


def step_ab(workdir, reals, card):
    """Phase 5a/b: same first step with the kernel and the plain blur, then
    images/s of each (fixed device batch, no data loading). Returns the
    kernel's trainer and its images/s."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    trainers = {}
    for impl in ("cuda", "torch"):
        trainers[impl], _ = build_trainer(smoke_args(os.path.join(workdir, f"ab_{impl}")),
                                          feeders=[])
        trainers[impl].gan.blur_impl = impl
    sigma = SIGMA0
    first = {impl: {k: float(v) for k, v in t.step_fn(t.state, reals, sigma)[0].items()}
             for impl, t in trainers.items()}
    for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores"):
        a, b = first["cuda"][k], first["torch"][k]
        if not math.isclose(a, b, rel_tol=STEP_TOL["rtol"], abs_tol=STEP_TOL["atol"]):
            raise RuntimeError(f"first step {k}: kernel {a} vs plain {b}")
    log("[step A/B] first step, kernel vs plain blur: " + ", ".join(
        f"{k} {first['cuda'][k]:+.6f}/{first['torch'][k]:+.6f}"
        for k in ("disc_loss", "gen_loss", "gp_term")))

    def timed(impl, n=10):
        t = trainers[impl]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            t.step_fn(t.state, reals, sigma)
        torch.cuda.synchronize()
        return n * reals.shape[0] / (time.perf_counter() - t0)

    for impl in trainers:
        timed(impl, 3)  # warm-up
    rates = {"cuda": [], "torch": []}
    for impl in ("torch", "cuda", "cuda", "torch"):
        rates[impl].append(timed(impl))
    for impl, name in (("cuda", "kernel"), ("torch", "plain")):
        log(f"[step] CelebA-128 b{BATCH} f32 train step, {name} blur: "
            f"{statistics.mean(rates[impl]):.1f} img/s "
            f"(runs {', '.join(f'{r:.1f}' for r in rates[impl])}) on {card}")
    return trainers["cuda"], statistics.mean(rates["cuda"])


def adam_ab(trainer, reals, total, card):
    """Phase 5e: ``Trainer.fit`` (median img/s of each run's steps 3 on) and
    the fixed-batch step, each with Adam non-capturable (``fit``'s setting)
    and capturable (the chunked mode's), in turns."""
    base = trainer.step_fn
    fit_rates = {False: [], True: []}
    step_rates = {False: [], True: []}
    for cap in (False, True, True, False):
        trainer.step_fn = adam_steps(base, cap)
        trainer.fit(total_examples=total, max_steps=ADAM_FIT_STEPS)
        fit_rates[cap].append(statistics.median(
            h["images_per_sec"] for h in list(trainer.history)[-ADAM_FIT_STEPS + 2:]))
    for cap in (False, True, True, False):
        step = adam_steps(base, cap)
        step(trainer.state, reals, SIGMA0)  # the switch, outside the timing
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ADAM_STEPS):
            step(trainer.state, reals, SIGMA0)
        torch.cuda.synchronize()
        step_rates[cap].append(ADAM_STEPS * reals.shape[0] / (time.perf_counter() - t0))
    trainer.step_fn = base
    for cap, name in ((False, "non-capturable (fit's)"), (True, "capturable (chunked's)")):
        log(f"[adam A/B] CelebA-128 b{BATCH} f32, Adam {name}: fit "
            f"{statistics.mean(fit_rates[cap]):.1f} img/s (runs "
            f"{', '.join(f'{r:.1f}' for r in fit_rates[cap])}), fixed-batch step "
            f"{statistics.mean(step_rates[cap]):.1f} img/s (runs "
            f"{', '.join(f'{r:.1f}' for r in step_rates[cap])}) on {card}")


def blur_bound(planes, t_h, t_w):
    """(bound in ms, "bytes" or "operations") of one blur call on these inputs:
    each input read once and the output written once, over the memory rate;
    the products with a non-zero entry of T, over the float32 rate."""
    h, w = t_h.shape[0], t_w.shape[0]
    nbytes = 4 * (2 * planes * h * w + h * h + w * w)
    flops = 2 * planes * (w * int(torch.count_nonzero(t_h)) + h * int(torch.count_nonzero(t_w)))
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_blur(blur_cuda, blur_matrix, device, planes, sigma, card, n=200):
    """Phase 5c: ms per blur call, kernel and plain (two cuBLAS float32
    matmuls), by CUDA events, in turns; and the call's bound."""
    x = torch.randn(planes, RES, RES, device=device)
    t = blur_matrix(sigma, RES, device=device)

    def per_call(fn):
        for _ in range(10):
            fn(x, t, t)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(x, t, t)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    runs = {"cuda": [], "plain": []}
    for name in ("plain", "cuda", "cuda", "plain"):
        fn = blur_cuda.blur_planes_forward if name == "cuda" else blur_cuda.blur_planes_reference
        runs[name].append(per_call(fn))
    ms = {k: min(v) for k, v in runs.items()}
    bound_ms, bound_by = blur_bound(planes, t, t)
    log(f"[blur] {planes}x{RES}x{RES} sigma {sigma}: kernel {ms['cuda'] * 1e3:.1f} us/call "
        f"(runs {', '.join(f'{v * 1e3:.1f}' for v in runs['cuda'])}), plain "
        f"{ms['plain'] * 1e3:.1f} us/call (runs {', '.join(f'{v * 1e3:.1f}' for v in runs['plain'])}), "
        f"bound {bound_ms * 1e3:.1f} us by {bound_by}: kernel at "
        f"{100 * bound_ms / ms['cuda']:.0f}% of its bound, "
        f"{ms['plain'] / ms['cuda']:.2f}x the plain version's speed on {card}")
    return {"planes": planes, "sigma": sigma, "ms": ms["cuda"], "plain_ms": ms["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by}


def time_blur_graphed(blur_cuda, blur_matrix, device, planes, res, sigma, card, calls=50,
                      replays=4):
    """Phase 11: ms per blur call at a small plane, kernel and plain, each
    timed as ``calls`` calls captured in a CUDA graph and replayed, so that
    the host's launch time (tens of µs a call from Python, more than the
    device's work at 28²) is not counted; in turns; and the call's bound."""
    x = torch.randn(planes, res, res, device=device)
    t = blur_matrix(sigma, res, device=device)
    fns = {"cuda": blur_cuda.blur_planes_forward, "plain": blur_cuda.blur_planes_reference}
    torch.testing.assert_close(
        fns["cuda"](x, t, t), fns["plain"](x, t, t), **FWD_TOL,
        msg=lambda m: f"{planes}x{res}x{res} sigma {sigma}, kernel vs plain: {m}")
    graphs = {}
    for name, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn(x, t, t)
        torch.cuda.current_stream().wait_stream(side)
        graphs[name] = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graphs[name]):
            for _ in range(calls):
                fn(x, t, t)

    def per_call(name):
        graphs[name].replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graphs[name].replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (calls * replays)

    runs = {"cuda": [], "plain": []}
    for name in ("plain", "cuda", "cuda", "plain"):
        runs[name].append(per_call(name))
    ms = {k: min(v) for k, v in runs.items()}
    bound_ms, bound_by = blur_bound(planes, t, t)
    log(f"[blur] {planes}x{res}x{res} sigma {sigma}, {calls} calls in a CUDA graph: kernel "
        f"{ms['cuda'] * 1e3:.2f} us/call (runs {', '.join(f'{v * 1e3:.2f}' for v in runs['cuda'])}), "
        f"plain {ms['plain'] * 1e3:.2f} us/call (runs "
        f"{', '.join(f'{v * 1e3:.2f}' for v in runs['plain'])}), bound {bound_ms * 1e3:.3f} us by "
        f"{bound_by}: kernel at {100 * bound_ms / ms['cuda']:.1f}% of its bound, "
        f"{ms['plain'] / ms['cuda']:.2f}x the plain version's speed on {card}")
    return {"planes": planes, "res": res, "sigma": sigma, "ms": ms["cuda"],
            "plain_ms": ms["plain"], "bound_ms": bound_ms, "bound_by": bound_by}


def profile_steps(trainer, reals, card, n=3):
    """Phase 5d: device time by kernel over a few steps (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.step_fn(trainer.state, reals, SIGMA0)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Kernels only: the operator rows above them carry their kernels' time too.
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        log("[profile] the profiler saw no device time: not measured")
        return
    total = sum(r[0] for r in rows)
    log(f"[profile] {n} steps: wall {wall_us / n / 1e3:.2f} ms/step, device busy "
        f"{total / n / 1e3:.2f} ms/step ({100 * total / wall_us:.1f}% of wall) on {card}")
    for dev, key, count in sorted(rows, reverse=True)[:12]:
        log(f"[profile]   {100 * dev / total:5.1f}%  {dev / n / 1e3:8.3f} ms/step  "
            f"x{count // n:<4d} {key[:90]}")


def png_size(path: str):
    """(width, height) from a PNG's IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise RuntimeError(f"{path} is not a PNG")
    return struct.unpack(">II", head[16:24])


def run_full(blur_cuda, workdir, slice_per_step, slice_rate, card):
    """Phase 7: the entry point's trainer with its feeders, grids,
    summaries and checkpoints at small cadences. Returns (trainer, args)."""
    from blurred_gan_tpu_torch.metrics.fid import FIDMetric
    from blurred_gan_tpu_torch.metrics.swd import SWDMetric, swd_resolutions
    from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager
    from blurred_gan_tpu_torch.train.loop import MetricFeeder
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    args = smoke_args(os.path.join(workdir, "full"), sample_grid_every=FULL_EVERY,
                      checkpoint_every=FULL_EVERY, save_image_summaries_interval=FULL_SUMMARIES)
    feeders = [MetricFeeder(SWDMetric(), every_n_examples=FULL_EVERY,
                            num_samples=FULL_SWD_SAMPLES, name="swd"),
               MetricFeeder(FIDMetric(), every_n_examples=FULL_EVERY,
                            num_samples=FULL_FID_SAMPLES, name="fid")]
    trainer, total = build_trainer(args, feeders=feeders)
    trainer.ckpt = CheckpointManager(trainer.ckpt.directory, max_to_keep=FULL_KEEP,
                                     keep_time_interval_hours=None)
    saved = []
    save = trainer.ckpt.save

    def recorded_save(samples_seen, *a, **k):
        saved.append(int(samples_seen))
        return save(samples_seen, *a, **k)

    trainer.ckpt.save = recorded_save
    host_s = {}

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            host_s[name] = host_s.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    for hook in trainer.hooks.hooks:
        hook.fn = timed(hook.name, hook.fn)
    trainer._image_summaries = timed("image_summaries", trainer._image_summaries)
    for feeder in feeders:
        feeder.feed = timed(f"{feeder.name} feed+result", feeder.feed)
    per_step = count_step_launches(blur_cuda, trainer)
    blur_cuda.launch_count = 0
    trainer.fit(total_examples=total, max_steps=STEPS)
    torch.cuda.synchronize()
    launches = blur_cuda.launch_count
    history = list(trainer.history)
    check_history(trainer, history, "phase 7")
    if set(per_step) != {slice_per_step}:
        raise RuntimeError(f"phase 7 kernel launches per step {per_step}, phase 4 "
                           f"{slice_per_step}")
    if launches <= sum(per_step):
        raise RuntimeError(f"phase 7: {launches} launches, none outside the steps "
                           f"({sum(per_step)}): the grids and summaries did not blur")

    with open(os.path.join(trainer.cfg.log_dir, "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    swd_keys = [f"swd/SWDx1e3_{r}" for r in swd_resolutions(RES)] + ["swd/SWDx1e3_avg"]
    swd_recs = [r for r in events if "swd/SWDx1e3_avg" in r]
    fid_recs = [r for r in events if "fid" in r]
    if not swd_recs or not fid_recs:
        raise RuntimeError(f"phase 7: {len(swd_recs)} SWD and {len(fid_recs)} FID records")
    for r in swd_recs:
        if not all(math.isfinite(r.get(k, math.nan)) for k in swd_keys):
            raise RuntimeError(f"phase 7: SWD record {r}")
    if not all(math.isfinite(r["fid"]) for r in fid_recs):
        raise RuntimeError(f"phase 7: FID records {fid_recs}")
    kept, want = trainer.ckpt.all_steps(), sorted(set(saved))[-FULL_KEEP:]
    if kept != want:
        raise RuntimeError(f"phase 7: checkpoints {kept}, saved {saved}, keep {FULL_KEEP}")
    pngs = sorted(n for n in os.listdir(trainer.cfg.log_dir) if n.startswith("samples_grid_"))
    side = 8 * (RES + 2) + 2
    sizes = {png_size(os.path.join(trainer.cfg.log_dir, n)) for n in pngs}
    if not pngs or sizes != {(side, side)}:
        raise RuntimeError(f"phase 7: grid PNGs {pngs} of sizes {sizes}, want {side}x{side}")
    for name in ("hyper_parameters.json", "train_config.json", "run_manifest.json"):
        if not os.path.exists(os.path.join(trainer.cfg.log_dir, name)):
            raise RuntimeError(f"phase 7: no {name}")
    non_jax_check()

    rates = [h["images_per_sec"] for h in history[2:]]
    log(f"[full] {STEPS} steps of Trainer.fit with SWD ({FULL_SWD_SAMPLES} samples) and FID "
        f"({FULL_FID_SAMPLES}) every {FULL_EVERY} examples, a grid and a checkpoint every "
        f"{FULL_EVERY}, summaries every {FULL_SUMMARIES} batches: median "
        f"{statistics.median(rates):.1f} img/s (phase 4 without hooks: {slice_rate:.1f}; "
        f"steps 1-{STEPS}: {', '.join(f'{h["images_per_sec"]:.0f}' for h in history)}); "
        f"host seconds by hook: {', '.join(f'{k} {v:.2f}' for k, v in host_s.items())}; "
        f"{launches} kernel launches ({per_step[0]} per step, {launches - sum(per_step)} in "
        f"grids and summaries); {len(swd_recs)} SWD records (last avg "
        f"{swd_recs[-1]['swd/SWDx1e3_avg']:.2f}), {len(fid_recs)} FID records (last "
        f"{fid_recs[-1]['fid']:.2f}); checkpoints kept {kept} of {sorted(set(saved))}; "
        f"{len(pngs)} grid PNGs of {side}x{side} on {card}")
    return trainer, args


def state_tensors(state):
    """Every tensor and counter a restore must reproduce."""
    out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.discriminator.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, slots in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in slots.items()})
    out["n_img"], out["n_batches"] = state.n_img, state.n_batches
    return out


def run_resume(live, args, workdir, card):
    """Phase 8: a fresh trainer on phase 7's run directory restores bit for
    bit and its next step matches the live state's."""
    from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    fresh, _ = build_trainer(args, feeders=[])
    if fresh.restored_examples != live.samples_seen:
        raise RuntimeError(f"restored @ {fresh.restored_examples}, live state at "
                           f"{live.samples_seen} examples")
    a, b = state_tensors(live.state), state_tensors(fresh.state)
    if a.keys() != b.keys():
        raise RuntimeError(f"restored state keys differ: {sorted(a.keys() ^ b.keys())}")
    for k in a:
        same = (a[k].device == b[k].device and torch.equal(a[k], b[k])
                if isinstance(a[k], torch.Tensor) else a[k] == b[k])
        if not same:
            raise RuntimeError(f"restore is not bit-exact at {k}")
    n_tensors = sum(isinstance(v, torch.Tensor) for v in a.values())
    reals = torch.from_numpy(next(live.dataset.batches(BATCH, seed=2))).to(live.device)
    sigma = live.sigma_for_step()
    losses = {name: {k: float(v) for k, v in t.step_fn(t.state, reals, sigma)[0].items()}
              for name, t in (("live", live), ("restored", fresh))}
    for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores"):
        x, y = losses["live"][k], losses["restored"][k]
        if not math.isclose(x, y, rel_tol=STEP_TOL["rtol"], abs_tol=STEP_TOL["atol"]):
            raise RuntimeError(f"step after restore, {k}: live {x} vs restored {y}")
    timing = CheckpointManager(os.path.join(workdir, "save_timing"),
                               keep_time_interval_hours=None)
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = timing.save(i, live.state)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    timing.restore_latest(fresh.state)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"[resume] restore @ {fresh.restored_examples} examples bit-exact over {n_tensors} "
        f"tensors (parameters, BatchNorm statistics, both Adam states) and the counters "
        f"(n_img {b['n_img']}, n_batches {b['n_batches']}); next step live/restored: "
        + ", ".join(f"{k} {losses['live'][k]:+.6f}/{losses['restored'][k]:+.6f}"
                    for k in ("disc_loss", "gen_loss", "gp_term"))
        + f"; save {min(times):.3f} s (runs {', '.join(f'{t:.3f}' for t in times)}), "
        f"restore {load_s:.3f} s, checkpoint {os.path.getsize(path) / 1e6:.1f} MB on {card}")


def run_eval(trainer, step_rate, card):
    """Phase 9: the metrics at the entry point's protocol, each first held
    against its CPU version on a small input."""
    from blurred_gan_tpu_torch.metrics.fid import (
        FIDMetric, inception_preprocess, random_conv_features)
    from blurred_gan_tpu_torch.metrics.inception import (
        inception_feature_fn, inception_features, random_inception_params)
    from blurred_gan_tpu_torch.metrics.swd import SWDMetric
    from blurred_gan_tpu_torch.train.loop import to_unit_range

    device = trainer.device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = trainer.dataset.batches(BATCH, seed=3)
    latent_rng = torch.Generator().manual_seed(3)
    reals, fakes = [], []
    for _ in range(-(-EVAL_SWD // BATCH)):
        reals.append(to_unit_range(torch.from_numpy(next(it)).to(device)))
        latents = trainer.gan.sample_latents(BATCH, latent_rng, "cpu").to(device)
        fakes.append(trainer.sample_fn(trainer.state, latents))
    reals, fakes = torch.cat(reals)[:EVAL_SWD], torch.cat(fakes)[:EVAL_SWD]

    # References on a small input: the same metric on the CPU.
    class Recording(SWDMetric):
        drawn = {}

        def draw_positions(self, update, side, lod, level_shape):
            out = super().draw_positions(update, side, lod, level_shape)
            self.drawn[(update, side, lod)] = out
            return out

        def draw_directions(self, lod, dim, **kw):
            out = super().draw_directions(lod, dim, **kw)
            self.drawn[("dirs", lod)] = out
            return out

    class Replay(SWDMetric):
        def draw_positions(self, update, side, lod, level_shape):
            return tuple(t.cpu() for t in Recording.drawn[(update, side, lod)])

        def draw_directions(self, lod, dim, **kw):
            return Recording.drawn[("dirs", lod)].cpu()

    n_ref = 2 * BATCH
    swd_ref = {}
    for name, m, dev in (("card", Recording(), device), ("cpu", Replay(), "cpu")):
        for i in range(0, n_ref, BATCH):
            m.update_state(reals[i:i + BATCH].to(dev), fakes[i:i + BATCH].to(dev))
        swd_ref[name] = m.results()
    for k, v in swd_ref["cpu"].items():
        if not math.isclose(swd_ref["card"][k], v, rel_tol=METRIC_TOL["rtol"],
                            abs_tol=METRIC_TOL["atol"]):
            raise RuntimeError(f"SWD {k}: card {swd_ref['card'][k]} vs CPU {v}")
    conv = {dev: random_conv_features((3, RES, RES), seed=0, device=dev)(reals[:8].to(dev))
            for dev in (device, "cpu")}
    torch.testing.assert_close(conv[device].cpu(), conv["cpu"], **METRIC_TOL,
                               msg=lambda m: f"random-conv features, card vs CPU: {m}")
    params = random_inception_params(0)
    x = inception_preprocess(reals[:2].cpu())
    inc = {"cpu": inception_features(params, x),
           "card": inception_features({s: {f: t.to(device) for f, t in u.items()}
                                       for s, u in params.items()}, x.to(device)).cpu()}
    torch.testing.assert_close(inc["card"], inc["cpu"], **METRIC_TOL,
                               msg=lambda m: f"Inception features, card vs CPU: {m}")
    inc_err = float((inc["card"] - inc["cpu"]).abs().max())
    log(f"[eval] card vs CPU on {n_ref} pairs: SWD avg {swd_ref['card']['SWDx1e3_avg']:.4f} / "
        f"{swd_ref['cpu']['SWDx1e3_avg']:.4f}; random-conv features max |diff| "
        f"{float((conv[device].cpu() - conv['cpu']).abs().max()):.2e}; Inception pool3 at "
        f"299 max |diff| {inc_err:.2e} on {card}")

    interval_s = EVAL_INTERVAL / step_rate

    def timed(label, metric, n):
        metric.update_state(reals[:2], fakes[:2])  # build and warm up
        metric.reset_states()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, n, BATCH):
            metric.update_state(reals[i:min(i + BATCH, n)], fakes[i:min(i + BATCH, n)])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = metric.results() if hasattr(metric, "results") else {"FID": metric.result()}
        t2 = time.perf_counter()
        metric.reset_states()
        if not all(math.isfinite(v) for v in out.values()):
            raise RuntimeError(f"{label}: {out}")
        log(f"[eval] {label}: {t2 - t0:.3f} s ({t1 - t0:.3f} s feeding, {t2 - t1:.3f} s in "
            f"the result), {100 * (t2 - t0) / interval_s:.2f}% of the {EVAL_INTERVAL}-example "
            f"interval at {step_rate:.1f} img/s "
            f"({', '.join(f'{k} {v:.3f}' for k, v in out.items())}) on {card}")

    timed(f"SWD over {EVAL_SWD} pairs at {RES}x{RES}", SWDMetric(), EVAL_SWD)
    timed(f"FID (random-conv features) over {EVAL_FID} pairs", FIDMetric(), EVAL_FID)
    timed(f"FID (InceptionV3 at 299x299, RANDOM weights) over {EVAL_FID} pairs",
          FIDMetric(feature_fn=inception_feature_fn(device=device)), EVAL_FID)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = trainer.evaluate(num_samples=EVAL_SWD)
    dt = time.perf_counter() - t0
    if not all(math.isfinite(v) for v in out.values()):
        raise RuntimeError(f"Trainer.evaluate: {out}")
    log(f"[eval] Trainer.evaluate(num_samples={EVAL_SWD}) (sampling, data, SWD and "
        f"random-conv FID): {dt:.3f} s, {100 * dt / interval_s:.2f}% of the interval "
        f"(SWDx1e3_avg {out['SWDx1e3_avg']:.3f}, FID {out['FID']:.3f}) on {card}")
    log(f"[eval] peak device memory in phase 9: "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    non_jax_check()


def blur_kernel_rows(prof):
    """(launches, device µs) of the blur kernel in a profile."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "blur_planes" in e.key]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)


def profile_chunk(trainer, card, what):
    """One more chunk of the trainer's runner under torch.profiler: the blur
    kernel's launches per replayed step, and the device's busy share (kernel
    time over wall time). Trains the state on: use it last."""
    from torch.profiler import ProfilerActivity, profile

    from blurred_gan_tpu_torch.train.fast import chunk_indices

    runner = trainer.chunk_runner
    n = trainer.state.n_batches
    idx = chunk_indices(trainer.dataset.num_examples, trainer.hparams.global_batch_size,
                        runner.chunk_steps, n, trainer.cfg.seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(idx, n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    launches, blur_us = blur_kernel_rows(prof)
    k = runner.chunk_steps
    if busy == 0:
        raise RuntimeError(f"{what}: the profiler saw no device time in a chunk")
    if launches % k:
        raise RuntimeError(f"{what}: {launches} blur launches in {k} replayed steps")
    log(f"[chunked] {what}, profiled chunk of {k} replayed steps: wall "
        f"{wall_us / k / 1e3:.2f} ms/step, device busy {busy / k / 1e3:.2f} ms/step "
        f"({100 * busy / wall_us:.1f}% of wall), blur_planes {launches // k} launches and "
        f"{blur_us / k:.1f} us per step on {card}")
    return launches // k, busy / wall_us


def chunk_rates(history, chunk_steps):
    """Images/s of each chunk (every step of a chunk logs its chunk's rate)."""
    return [h["images_per_sec"] for h in list(history)[chunk_steps - 1::chunk_steps]]


def check_draws(trainer):
    """Replays from one state: different seeds draw different latents (the
    critic step's fakes differ), the same seed the same ones, and a replay
    draws what the eager step draws for its seed. Restores the state."""
    from blurred_gan_tpu_torch.train.fast import state_tensors
    from blurred_gan_tpu_torch.train.step import make_step_body

    runner = trainer.chunk_runner
    tensors = state_tensors(trainer.state) + [runner.n_batches]
    with torch.no_grad():
        saved = [t.clone() for t in tensors]

    @torch.no_grad()
    def rewind():
        for t, v in zip(tensors, saved):
            t.copy_(v)
        runner.row.zero_()

    fakes = []
    for seed in (11, 12, 11):
        rewind()
        trainer.state.rng.manual_seed(seed)
        runner.graph.replay()
        fakes.append(runner.fakes.clone())
    rewind()
    trainer.state.rng.manual_seed(11)
    _, eager = make_step_body(trainer.gan, trainer.hparams)(
        trainer.state, runner.data.index_select(0, runner.idx[0]), SIGMA0)
    rewind()
    torch.cuda.synchronize()
    if torch.allclose(fakes[0], fakes[1]):
        raise RuntimeError("two replays with different seeds drew the same latents")
    if not torch.equal(fakes[0], fakes[2]):
        raise RuntimeError("two replays with the same seed drew different latents")
    torch.testing.assert_close(eager, fakes[0], rtol=1e-5, atol=1e-6,
                               msg=lambda m: f"replay vs eager step, same seed: {m}")
    return float((eager - fakes[0]).abs().max()), float((fakes[0] - fakes[1]).abs().max())


def relative_diffs(want, got):
    """Per step, the largest relative difference over the losses and scores."""
    keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores")
    return [max(abs(b[k] - a[k]) / max(abs(a[k]), 1e-12) for k in keys)
            for a, b in zip(want, got)]


def losses_close(a, b) -> bool:
    return all(math.isclose(b[k], a[k], rel_tol=STEP_TOL["rtol"], abs_tol=STEP_TOL["atol"])
               for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores",
                         "real_scores"))


def run_chunked(blur_cuda, workdir, slice_history, slice_rate, step_rate, card):
    """Phase 10: the chunked mode against the host loop, then its numbers."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    def trainer(name):
        return build_trainer(smoke_args(os.path.join(workdir, name), sample_grid_every=0,
                                        checkpoint_every=0, save_image_summaries_interval=0),
                             feeders=[])

    # cuDNN's default backward-filter algorithms sum with atomics, and Adam
    # turns such last-bit differences into whole steps, so two runs of the same
    # training part within a few steps. The chunked run and its `fit` reference
    # (phase 4's weights, stream and seed) run with deterministic algorithms.
    torch.backends.cudnn.deterministic = True
    try:
        ref, total = trainer("chunked_ref")
        capturable_adam(ref).fit(total_examples=total, max_steps=STEPS)
        chunked, _ = trainer("chunked")
        blur_cuda.launch_count = 0
        chunked.fit_device_resident(total_examples=total, chunk_steps=CHUNK,
                                    max_chunks=STEPS // CHUNK)
        torch.cuda.synchronize()
        host_launches = blur_cuda.launch_count
    finally:
        torch.backends.cudnn.deterministic = False
    runner = chunked.chunk_runner
    if runner.graph is None:
        raise RuntimeError("phase 10: the chunked run captured no CUDA graph")
    if host_launches == 0:
        raise RuntimeError("phase 10: the blur kernel was never launched")
    history, want = list(chunked.history), list(ref.history)
    check_history(chunked, history, "phase 10")
    for n, (a, b) in enumerate(zip(want, history)):
        if not losses_close(a, b):
            raise RuntimeError(f"phase 10, step {n + 1}: chunked {b} vs fit {a}")
        if a["std"] != b["std"]:
            raise RuntimeError(f"phase 10, step {n + 1}: sigma {b['std']!r} vs fit {a['std']!r}")
    # Phase 4 ran with cuDNN's default algorithms and non-capturable Adam: its
    # first step must agree, the later ones part as two default-algorithm
    # runs do (`fit` again).
    drift = relative_diffs(slice_history, history)
    if not losses_close(slice_history[0], history[0]):
        raise RuntimeError(f"phase 10, step 1: chunked {history[0]} vs phase 4 {slice_history[0]}")
    again, _ = trainer("fit_again")
    again.fit(total_examples=total, max_steps=STEPS)
    eager_drift = relative_diffs(slice_history, list(again.history))
    del again
    replay_err, seed_diff = check_draws(chunked)
    non_jax_check()
    log(f"[chunked] {STEPS} steps of fit_device_resident ({STEPS // CHUNK} chunks of {CHUNK}), "
        f"CelebA-128 full width b{BATCH} f32, deterministic cuDNN: losses equal to fit's from "
        f"the same weights, stream and seed (largest relative difference per step "
        f"{' '.join(f'{d:.1e}' for d in relative_diffs(want, history))}; fit with the "
        f"chunked mode's capturable Adam), sigma bit-equal; "
        f"against phase 4 (default cuDNN) {' '.join(f'{d:.1e}' for d in drift)}, as a second "
        f"default-cuDNN fit is ({' '.join(f'{d:.1e}' for d in eager_drift)}); capture "
        f"{runner.capture_seconds:.2f} s; blur launches from the host {host_launches} (warm-up "
        f"and capture only); replay vs eager step, same seed: fakes max |diff| "
        f"{replay_err:.2e}; seeds 11 vs 12: max |diff| {seed_diff:.3f} on {card}")
    del ref, runner  # the next call releases the runner before it builds one

    chunked.fit_device_resident(total_examples=total, chunk_steps=TIMED_CHUNK,
                                max_chunks=TIMED_CHUNKS)
    rates = chunk_rates(list(chunked.history)[STEPS:], TIMED_CHUNK)
    chunked_rate = statistics.median(rates[1:])
    per_step, busy = profile_chunk(chunked, card, "CelebA-128 b32")
    if per_step != 6:
        raise RuntimeError(f"phase 10: {per_step} blur launches per replayed step, not 6")
    log(f"[chunked] CelebA-128 b{BATCH} f32: chunked {chunked_rate:.1f} img/s (median of chunks "
        f"2-{TIMED_CHUNKS} of {TIMED_CHUNK} steps; chunks {', '.join(f'{r:.1f}' for r in rates)}, "
        f"the first with its capture of {chunked.chunk_runner.capture_seconds:.2f} s); fit "
        f"{slice_rate:.1f} img/s (phase 4), fixed-batch eager step {step_rate:.1f} img/s "
        f"(phase 5); device busy {100 * busy:.1f}% of a chunk's wall time on {card}")
    return host_launches


def run_mnist(blur_cuda, blur_matrix, device, workdir, card):
    """Phase 11: MNIST through its entry point, chunked against fit, the stop
    freeze on the card, and the kernel at 28²."""
    import numpy as np

    from blurred_gan_tpu_torch.data.pipeline import load_mnist
    from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController
    from blurred_gan_tpu_torch.train_mnist import build_trainer, parse_args

    dataset = load_mnist()  # the synthetic corpus without a local mnist.npz
    npz = os.path.join(workdir, "mnist.npz")
    np.savez(npz, x_train=dataset.images[..., 0])

    def argv(name, *extra):
        return ["--mnist_path", npz, "--batch_size", str(BATCH), "--seed", "0", "--log_dir",
                os.path.join(workdir, name), *extra]

    max_steps = 3 * MNIST_CHUNK // 2
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blurred_gan_tpu_torch.train_mnist", "--device_resident",
         "--chunk_steps", str(MNIST_CHUNK // 2), "--max_steps", str(max_steps),
         *argv("mnist_entry")],
        cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
        timeout=600)
    entry_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"train_mnist --device_resident failed ({proc.returncode}):\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    with open(os.path.join(workdir, "mnist_entry", "events.jsonl")) as f:
        events = [json.loads(line) for line in f]
    swd = [r for r in events if "swd/SWDx1e3_avg" in r]
    fid = [r for r in events if "fid" in r]
    losses = [r["batch_disc_loss"] for r in events if "batch_disc_loss" in r]
    if not (swd and fid and losses) or not all(
            math.isfinite(v) for v in losses + [swd[0]["swd/SWDx1e3_avg"], fid[0]["fid"]]):
        raise RuntimeError(f"train_mnist: {len(swd)} SWD, {len(fid)} FID, {len(losses)} loss "
                           f"records: {proc.stdout[-2000:]}")
    ckpts = sorted(os.listdir(os.path.join(workdir, "mnist_entry", "checkpoints")))
    if f"{max_steps * BATCH}.pt" not in ckpts:
        raise RuntimeError(f"train_mnist: checkpoints {ckpts}, want {max_steps * BATCH}.pt")
    log(f"[mnist] python -m blurred_gan_tpu_torch.train_mnist --device_resident: "
        f"{max_steps} steps in 3 chunks, {len(losses)} loss records (last d_loss "
        f"{losses[-1]:+.4f}), SWD avg {swd[0]['swd/SWDx1e3_avg']:.3f} and FID "
        f"{fid[0]['fid']:.3f} at {swd[0]['step']} examples, checkpoint {max_steps * BATCH}.pt; "
        f"{entry_s:.1f} s with start-up, feeders and build on {card}")

    # Chunked against fit from the same weights, data and draws, step by
    # step: deterministic cuDNN and the same Adam arithmetic (phase 10).
    torch.backends.cudnn.deterministic = True
    try:
        ref = capturable_adam(build_trainer(parse_args(argv("mnist_cmp_fit")), feeders=[])[0])
        ref.fit(total_examples=10 ** 9, max_steps=MNIST_CMP_CHUNK * MNIST_CMP_CHUNKS)
        cmp, _ = build_trainer(parse_args(argv("mnist_cmp_chunked")), feeders=[])
        cmp.fit_device_resident(total_examples=10 ** 9, chunk_steps=MNIST_CMP_CHUNK,
                                max_chunks=MNIST_CMP_CHUNKS)
    finally:
        torch.backends.cudnn.deterministic = False
    want, got = list(ref.history), list(cmp.history)
    if len(want) != len(got) or len(got) != MNIST_CMP_CHUNK * MNIST_CMP_CHUNKS:
        raise RuntimeError(f"phase 11: {len(got)} chunked steps, {len(want)} of fit")
    for n, (a, b) in enumerate(zip(want, got)):
        if not losses_close(a, b):
            raise RuntimeError(f"phase 11, step {n + 1}: chunked {b} vs fit {a}")
        if a["std"] != b["std"]:
            raise RuntimeError(f"phase 11, step {n + 1}: sigma {b['std']!r} vs fit {a['std']!r}")
    diffs = relative_diffs(want, got)
    log(f"[mnist] {len(got)} steps of fit_device_resident ({MNIST_CMP_CHUNKS} chunks of "
        f"{MNIST_CMP_CHUNK}) against fit (capturable Adam), deterministic cuDNN: every "
        f"step's losses within rtol {STEP_TOL['rtol']} (largest relative difference "
        f"{max(diffs):.1e}, {sum(d == 0 for d in diffs)} steps bit-equal), sigma bit-equal")
    del ref, cmp

    fit, _ = build_trainer(parse_args(argv("mnist_fit", "--max_steps", str(MNIST_FIT_STEPS))),
                           feeders=[])
    fit.fit(total_examples=10 ** 9, max_steps=MNIST_FIT_STEPS)
    fit_rate = statistics.median(h["images_per_sec"] for h in list(fit.history)[2:])
    chunked, _ = build_trainer(parse_args(argv("mnist_chunked")), feeders=[])
    blur_cuda.launch_count = 0
    chunked.fit_device_resident(total_examples=10 ** 9, chunk_steps=MNIST_CHUNK,
                                max_chunks=MNIST_CHUNKS)
    torch.cuda.synchronize()
    if blur_cuda.launch_count == 0 or chunked.chunk_runner.graph is None:
        raise RuntimeError("phase 11: the chunked MNIST run captured no graph or no kernel")
    rates = chunk_rates(chunked.history, MNIST_CHUNK)
    per_step, busy = profile_chunk(chunked, card, "MNIST-28 b32")
    if per_step != 6:
        raise RuntimeError(f"phase 11: {per_step} blur launches per replayed step, not 6")
    log(f"[mnist] MNIST-28 b{BATCH} f32: chunked {statistics.median(rates[1:]):.1f} img/s "
        f"(median of chunks 2-{MNIST_CHUNKS} of {MNIST_CHUNK}; chunks "
        f"{', '.join(f'{r:.1f}' for r in rates)}, capture "
        f"{chunked.chunk_runner.capture_seconds:.2f} s), fit {fit_rate:.1f} img/s (median of "
        f"steps 3-{MNIST_FIT_STEPS}); device busy {100 * busy:.1f}% of a chunk on {card}")

    # The stop freeze inside the graph: a controller that stops at its first
    # decay, against the host loop run for exactly the steps that executed.
    def stopping(name):
        tr, _ = build_trainer(parse_args(argv(name, "--adaptive")), feeders=[])
        tr.adaptive_controller = AdaptiveBlurController(
            warmup_n_batches=0, delay_between_modifications=1, max_value=1.0, min_value=0.995)
        tr.ada_state = tr.adaptive_controller.init()
        return tr

    frozen = stopping("mnist_stop")
    frozen.fit_device_resident(total_examples=10 ** 9, chunk_steps=CHUNK, max_chunks=2)
    n = frozen.state.n_batches
    if not (frozen.ada_state.stop_training and n == frozen.ada_state.last_modification_batch
            and n < CHUNK and int(frozen.chunk_runner.n_batches) == n):
        raise RuntimeError(f"phase 11: stop freeze: {frozen.ada_state}, {n} steps counted, "
                           f"device counter {int(frozen.chunk_runner.n_batches)}")
    ref = capturable_adam(stopping("mnist_stop_ref"))
    ref.fit(total_examples=10 ** 9, max_steps=n)
    worst = 0.0
    for m, m2 in ((ref.state.generator, frozen.state.generator),
                  (ref.state.discriminator, frozen.state.discriminator)):
        for (k, v), v2 in zip(m.state_dict().items(), m2.state_dict().values()):
            torch.testing.assert_close(v2, v, **PARAM_TOL,
                                       msg=lambda msg: f"stop freeze, {k}: {msg}")
            worst = max(worst, float((v2 - v).abs().max()))
    log(f"[mnist] stop freeze in the graph: the controller stopped at step {n} of a chunk of "
        f"{CHUNK}; the state after the chunk equals {n} steps of fit (max |diff| {worst:.2e})")

    timings = [time_blur_graphed(blur_cuda, blur_matrix, device, planes, MNIST_RES, sigma, card)
               for sigma in MNIST_SIGMAS for planes in (2 * BATCH, BATCH)]
    non_jax_check()
    return timings


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    card = card_line()
    log(card)
    device = torch.device("cuda:0")
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.ops.blur import blur_matrix
    from blurred_gan_tpu_torch.entry import set_float32_precision

    set_float32_precision()
    with phase("2 build"):
        t0 = time.perf_counter()
        blur_cuda.build(verbose=True)
        log(f"[build] {blur_cuda.SOURCE.name}: {time.perf_counter() - t0:.1f} s")

    with phase("3 kernel vs plain"):
        max_err = check_kernel(blur_cuda, blur_matrix, device)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        with phase("4 slice"):
            trainer, history, launches, per_step = run_slice(blur_cuda, workdir)
            rates = [h["images_per_sec"] for h in history[2:]]
            slice_rate = statistics.median(rates)
            log(f"[slice] {STEPS} steps of Trainer.fit, CelebA-128 full width b{BATCH} f32: "
                f"d_loss {history[0]['disc_loss']:+.4f} -> {history[-1]['disc_loss']:+.4f}, "
                f"sigma {history[0]['std']:.4f} -> {history[-1]['std']:.4f}, "
                f"{launches} kernel launches ({per_step[0]} per step), "
                f"median {slice_rate:.1f} img/s with data loading on {card}")

        with phase("5 step A/B, blur timings, profile"):
            reals = torch.from_numpy(next(trainer.dataset.batches(BATCH, seed=1))).to(device)
            kernel_trainer, step_rate = step_ab(workdir, reals, card)
            # 192 planes: the critic on cat([fakes, reals]); 96: the other five calls.
            timings = [time_blur(blur_cuda, blur_matrix, device, planes, sigma, card)
                       for sigma in (SIGMA0, 100.0) for planes in (2 * BATCH * 3, BATCH * 3)]
            profile_steps(kernel_trainer, reals, card)
            adam_ab(trainer, reals, 10 ** 9, card)

        with phase("6 occupancy"):
            blocks, smem = blur_cuda.occupancy(RES)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            grid = (RES // blur_cuda.ROW_TILE) * 2 * BATCH * 3
            log(f"[occupancy] blur_planes at {RES}x{RES}: {blocks} blocks per SM, {smem} bytes "
                f"of dynamic shared memory per block; {grid} blocks at {2 * BATCH * 3} planes "
                f"fill {grid / (blocks * sms):.2f} waves of {blocks * sms} slots on {sms} SMs")

        with phase("7 full run"):
            full, full_args = run_full(blur_cuda, workdir, per_step[0], slice_rate, card)
        with phase("8 resume"):
            run_resume(full, full_args, workdir, card)
        with phase("9 evaluation"):
            run_eval(full, step_rate, card)
        del full, kernel_trainer
        with phase("10 chunked"):
            run_chunked(blur_cuda, workdir, history, slice_rate, step_rate, card)
        with phase("11 MNIST"):
            mnist_timings = run_mnist(blur_cuda, blur_matrix, device, workdir, card)

    headline = timings[0]  # σ₀, 192 planes
    print(json.dumps({"kernels": [{
        "name": "blur_planes", "route": "cuda",
        "source": "blurred_gan_tpu_torch/csrc/blur_planes.cu",
        "replaces": "blurred_gan_tpu/ops/blur_pallas.py:54",
        "launches": launches, "max_abs_err": max_err,
        "ms": headline["ms"], "plain_ms": headline["plain_ms"],
        "bound_ms": headline["bound_ms"], "bound_by": headline["bound_by"],
        # The library call is the plain version itself: two cuBLAS matmuls.
        "library_ms": headline["plain_ms"], "sigma": headline["sigma"],
        "planes": headline["planes"], "cases": timings + mnist_timings}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
