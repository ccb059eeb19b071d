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
   50,000-example interval; then one JSON line describing the kernel and the
   result line.

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
