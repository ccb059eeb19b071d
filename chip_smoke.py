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
   with an all-zero row tile and column tile;
4. the slice: ``Trainer.fit`` at the full CelebA-128 widths, batch 32, float32,
   σ₀ = 5, on the synthetic corpus, for 12 steps; losses finite, σ from
   ``BlurDecayController``, the kernel launched the same positive number of
   times every step, neither jax nor the JAX package ever imported;
5. one step with the kernel against one step with the plain blur from the same
   weights and draws; then the step's images/s with each, and the kernel's
   time per call against the plain version's and its bound at σ = 5 and
   σ = 100, for 192 and 96 planes; a profile of a few steps;
6. the kernel's occupancy, one JSON line describing the kernel, then the
   result line.

The last line of output is ``{"ok": true, "device": {...}}``; nothing is
printed there on failure, and the exit code is then non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
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


def log(msg: str) -> None:
    print(msg, flush=True)


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


def run_slice(blur_cuda, args):
    """Phase 4. Returns (trainer, history, launches, launches per step)."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    trainer, total = build_trainer(args)
    counts = []
    step = trainer.step_fn

    def counted(*a, **k):
        out = step(*a, **k)
        counts.append(blur_cuda.launch_count)
        return out

    trainer.step_fn = counted
    blur_cuda.launch_count = 0
    history = trainer.fit(total_examples=total, max_steps=STEPS)
    torch.cuda.synchronize()
    launches = blur_cuda.launch_count
    per_step = [b - a for a, b in zip([0] + counts[:-1], counts)]
    if len(history) != STEPS:
        raise RuntimeError(f"fit took {len(history)} steps, not {STEPS}")
    for n, logs in enumerate(history):
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss"):
            if not math.isfinite(logs[k]):
                raise RuntimeError(f"step {n + 1}: {k} = {logs[k]}")
        want = trainer.blur_controller.sigma(n)
        if not math.isclose(logs["std"], want, rel_tol=1e-6):
            raise RuntimeError(f"step {n + 1}: sigma {logs['std']} != schedule {want}")
    if len(set(per_step)) != 1 or per_step[0] < 3:
        raise RuntimeError(f"kernel launches per step {per_step}: expected the same "
                           f"number, at least 3, every step")
    if launches != sum(per_step):
        raise RuntimeError(f"{launches} launches, {sum(per_step)} counted by step")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    reference = sorted(m for m in sys.modules
                       if m == "blurred_gan_tpu" or m.startswith("blurred_gan_tpu."))
    if reference:
        raise RuntimeError(f"the JAX package was imported: {reference}")
    return trainer, history, launches, per_step


def step_ab(args, reals, card):
    """Phase 5a/b: same first step with the kernel and the plain blur, then
    images/s of each (fixed device batch, no data loading)."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    trainers = {}
    for impl in ("cuda", "torch"):
        trainers[impl], _ = build_trainer(args)
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
    return trainers["cuda"]


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
    from blurred_gan_tpu_torch.train_celeba import set_float32_precision

    set_float32_precision()
    t0 = time.perf_counter()
    blur_cuda.build(verbose=True)
    log(f"[build] {blur_cuda.SOURCE.name}: {time.perf_counter() - t0:.1f} s")

    max_err = check_kernel(blur_cuda, blur_matrix, device)

    args = argparse.Namespace(resolution=RES, batch_size=BATCH, max_steps=STEPS,
                              max_blur_std=SIGMA0, num_examples=NUM_EXAMPLES, seed=0,
                              gen_upsample="transpose", log_dir=None, device="cuda")
    trainer, history, launches, per_step = run_slice(blur_cuda, args)
    rates = [h["images_per_sec"] for h in history[2:]]
    log(f"[slice] {STEPS} steps of Trainer.fit, CelebA-128 full width b{BATCH} f32: "
        f"d_loss {history[0]['disc_loss']:+.4f} -> {history[-1]['disc_loss']:+.4f}, "
        f"sigma {history[0]['std']:.4f} -> {history[-1]['std']:.4f}, "
        f"{launches} kernel launches ({per_step[0]} per step), "
        f"median {statistics.median(rates):.1f} img/s with data loading on {card}")

    reals = torch.from_numpy(next(trainer.dataset.batches(BATCH, seed=1))).to(device)
    kernel_trainer = step_ab(args, reals, card)
    # 192 planes: the critic on cat([fakes, reals]); 96: the other five calls.
    timings = [time_blur(blur_cuda, blur_matrix, device, planes, sigma, card)
               for sigma in (SIGMA0, 100.0) for planes in (2 * BATCH * 3, BATCH * 3)]
    profile_steps(kernel_trainer, reals, card)

    blocks, smem = blur_cuda.occupancy(RES)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grid = (RES // blur_cuda.ROW_TILE) * 2 * BATCH * 3
    log(f"[occupancy] blur_planes at {RES}x{RES}: {blocks} blocks per SM, {smem} bytes of "
        f"dynamic shared memory per block; {grid} blocks at {2 * BATCH * 3} planes fill "
        f"{grid / (blocks * sms):.2f} waves of {blocks * sms} slots on {sms} SMs")
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
        "planes": headline["planes"], "cases": timings}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
