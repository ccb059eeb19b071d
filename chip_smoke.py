#!/usr/bin/env python3
"""Drive the PyTorch port's CelebA-128 blurred WGAN-GP training and serving on one CUDA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

(Phase 16 runs this file again in processes of its own, with ``--dp_worker``
or ``--nccl_probe``. ``python3 chip_smoke.py --data_parallel`` runs the build,
phase 4 and phase 16 alone: on a machine with two cards or more, NCCL across
two of them as well; ``--quality`` the build and phase 19 alone.)

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
12. the train-step variants at phase 4's widths, batch, σ₀ and corpus: the
    penalty-free WGAN, RMSprop, TTUR (the generator at twice the rate), EMA
    0.999, flip augmentation, ``d_steps_per_g_step`` 5, ``gp_every_n_steps`` 4
    and ``grad_accumulation_steps`` 4, beside the default and lazy GP with
    ``d_steps_per_g_step`` (all four phases): for each, a chunk
    of 10 steps of ``fit_device_resident`` (one CUDA graph per phase the
    configuration reaches) against 10 steps of ``fit`` from the same weights,
    stream and seed (capturable Adam, deterministic cuDNN: every step's losses
    and σ); the kernel's launches in each step of ``fit`` and in each captured
    phase against those the step implies; chunked images/s replaying those
    graphs, then from graphs captured anew with cuDNN's default algorithms;
    the caching
    allocator's bytes before and after those captures; ``fit``'s peak memory;
    the bytes still allocated once each configuration's trainers are dropped;
    for accumulation one step with the kernel against one with the plain blur;
    for the default and EMA the chunked images/s with the adaptive
    controller's stop gate;
13. bfloat16 (``--bf16``, ``--bf16 --fast_gen``) at phase 4's widths, batch,
    σ₀ and corpus: 12 steps of ``fit`` through the entry point's
    ``build_trainer`` for each (losses finite, σ on the schedule, 6 kernel
    launches a step, the networks' dtypes read by forward hooks); one step
    with the kernel against one with the plain blur; the bfloat16 step
    against the float32 step from the same weights and draws (relative
    differences of the losses and of the critic's gradient norm), these
    first steps under deterministic cuDNN; 10 chunked
    steps against 10 of ``fit`` under deterministic cuDNN, bit-equal; then,
    in turns, chunked and ``fit`` images/s of float32, ``--bf16`` and
    ``--bf16 --fast_gen``, capture seconds, the graphs' pools and ``fit``'s
    peak; and a profile of a replayed chunk of each (top kernels, busy share,
    the blur's and the copies' share, TFLOP/s);
14. serving, on phase 7's run directory: ``generate_samples.main`` in this
    process writes the 64-image grid blurred at σ 0.5 with one kernel launch,
    held against the plain blur of the same samples, and the kernel is timed
    at that shape and σ; KID and PRDC on the card against the CPU on a small
    input; then, each in a process of its own and all at once, ``python -m
    blurred_gan_tpu_torch.generate_samples`` (the random grid, the
    ``--interpolate`` grid, ``--blur_std``, and ``--ema``, which must exit
    with its message), ``tools.export_generator`` (its own check at batches 1
    and 7), ``tools.evaluate_run`` at its defaults and ``tools.score --kid
    --prdc`` on 1000 samples against 1000 reals; a ``python -c`` that imports
    torch alone serves the artifact at batches 1, 7 and 128, held against the
    live generator, as is the artifact moved to the CPU; an EMA artifact of a
    2-step ``--ema_decay 0.999`` run against ``make_sample_fn(use_ema=True)``;
    the generator's FLOPs per image, and its images/s at batches 128 and 32,
    eager and the artifact in turns, with their peak memory;
15. the image folder: a probe line (nproc, Pillow, libjpeg's and libpng's
    headers, the native loader's build); 2,048 CelebA-shaped 178x218 JPEGs
    written to the temporary directory; ``materialize`` against the
    per-batch decode in file order, byte for byte; the ``make_shards`` CLI
    on the folder; the stream's first batches byte-equal across the folder,
    its array and its store; 12 steps of ``fit`` from each under
    deterministic cuDNN, the losses bit-equal, 6 blur launches a step; the
    native loader against Pillow where both exist; ``fit`` images/s from
    each in turns, two rounds, and the decode's seconds per batch on the
    pipeline's worker; ``--device_resident`` from the folder (materialized
    by the entry point), chunked images/s; ``tools.score`` on the folder
    against the npz of its decoded images. On a machine that decodes no
    image it says so and runs the store's half: the CLI on an mnist.npz,
    the store against the array in streams, losses and ``fit`` images/s,
    and ``--device_resident`` from the store;
16. data parallelism at phase 4's configuration under deterministic cuDNN,
    each run a process of its own (``chip_smoke.py --dp_worker <json>``,
    alone or under ``torch.distributed.run``): (a) a group of one over NCCL
    against no group, 12 steps of ``fit`` bit-equal, and phase 4's first
    step; (b) two ranks at b16 on ``cuda:0`` over gloo against one process at
    b32 on their concatenated reals (the losses at steps 1 and 3 within
    ``DP_LOSS_TOL``), 6 kernel launches a rank-step at 96 and 48 planes,
    ``evaluate``'s merged SWD and random-conv FID against one process over
    the same pairs, a 2-rank resume bit for bit, both runs' img/s and the
    gradients' all-reduce ms, and the kernel timed at 96 and 48 planes; what
    NCCL says to two ranks on one card; (c) with two cards or more, (b) over
    NCCL across two cards, else a line saying it was not run;
17. the diagnostic tools on what phase 7 left: (a) ``diagnose_samples.main``
    with ``--config celeba128 --sigma 5`` on 1000 samples of phase 7's
    generator, once through the kernel and once through the plain blur: 20
    kernel launches (10 chunks of 100 reals, 10 of the set) and none, the
    rows equal and the blurred objective within ``DIAG_TOL``, each run's
    seconds and its blur's, SWD's and FID's; the kernel timed at the
    objective's 300 planes; (b) ``bn_stats_ab.main`` on phase 7's run
    directory: the generator's buffers' digest the same before and after
    each pass, the running pass equal to the eval-mode generator; (c)
    ``convert_inception`` on a torchvision state dict made from
    ``random_inception_params``, its npz loaded on the card giving the source
    parameters' features;
18. the bench: ``python -m blurred_gan_tpu_torch.bench`` in a process of its
    own for each of the default (bfloat16, with the b128 peak), ``--f32
    --no_peak`` (its b128 peak cut to pay for ``--ablation``),
    ``--f32 --blur_impl torch --no_peak`` (the plain blur's A/B at b32; its
    b128 peak was cut to pay for phase 19's scoring), ``--f32 --chunked``,
    ``--infer`` and
    ``--infer_export``, one after another: each line printed, exit 0,
    ``correct`` true, the card's name as this script reads it, 6 blur
    launches a step and some in the timed runs with the kernel and none
    without, one ``flops_per_step`` for the train arms and one for the infer
    arms; ``--f32 --chunked``'s rate beside phase 10's; then ``--ablation
    --no_peak`` (bfloat16, b32): four arm lines (``full``, ``no_gen``,
    ``no_gp``, ``no_blur``), each correct with 6 / 4 / 3 / 0 blur launches an
    eager step, and the ``summary_ms`` line, its marginals ``full`` minus
    each arm;
19. the quality check's train side: ``quality.train`` in this process on
    ``mnist`` (3,200 examples, float32), ``celeba64_sharp --bf16`` (640) and
    the heavy-blur ``celeba64`` (640, float32, σ₀ 5, where the blur is no
    identity), seed 0: 6 kernel launches in every step, finite losses, σ on the
    schedule, the first step's losses within phase 4's tolerance (phase 13's
    for bfloat16) of a one-step run with the plain blur, which launches
    none; 1000 finite samples NHWC in [-1, 1] and a meta with
    ``train_ours``'s keys and the card; each run's img/s; the kernel at 64²
    (192 and 96 planes, σ 0.05 and 5) against its plain version and bound;
    the sharp run's 1000 samples scored on the card by
    ``quality.evaluate`` in this process (the other two runs' scoring cut to
    pay for phase 18's ``--ablation``): the reals floor row and the set's,
    finite, with ``evaluate``'s keys and ``"stack": "torch-cuda"``, the
    floor's SWD and both FIDs below the set's, each row and its seconds
    logged; the bfloat16 run and its plain run under deterministic cuDNN;
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

import numpy as np  # noqa: E402
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
# Phase 12: the variants as hyperparameters over the defaults (None: the
# penalty-free WGAN, WGANHyperParameters); the chunk of the comparison with
# fit, then the timed chunks of the same runner.
VARIANTS = (("default", {}), ("wgan", None), ("rmsprop", {"optimizer": "rmsprop"}),
            ("ttur", {"g_learning_rate": 2e-3}), ("ema", {"ema_decay": 0.999}),
            ("flip", {"flip_augment": True}), ("d_steps_5", {"d_steps_per_g_step": 5}),
            ("lazy_gp_4", {"gp_every_n_steps": 4}), ("accum_4", {"grad_accumulation_steps": 4}),
            ("lazy_gp_4_d_steps_5", {"gp_every_n_steps": 4, "d_steps_per_g_step": 5}))
VARIANT_CHUNK, VARIANT_TIMED_CHUNKS = 10, 2
# Phase 13: the entry point's flags of each configuration; a bfloat16 step
# with the kernel against one with the plain blur (float32 blur outputs that
# differ in the last bits round to bfloat16 differently at a few elements);
# the bound on a bfloat16 step against the float32 one, |bf16 − f32| <=
# GROSS_REL·|f32| + GROSS_ABS, which only a broken step exceeds (the JAX
# package's own gap at narrow widths is 3e-2 relative at most); fit's steps
# per timed run; the card's dense bf16 tensor-core peak.
PRECISIONS = (("float32", {}), ("bf16", {"bf16": True}),
              ("bf16_fast_gen", {"bf16": True, "fast_gen": True}))
BF16_STEP_TOL = dict(rtol=1e-2, atol=1e-3)
GROSS_REL, GROSS_ABS = 0.25, 1e-3
BF16_FIT_STEPS = 24
PEAK_BF16_FLOPS = 989e12


# Phase 14: the grid's σ (generate_samples --blur_std) and its sample count;
# the inference batches (bench.py --infer's 128, and the training batch) and
# calls per timing; the scoring CLIs' sample count; the artifact against the
# live generator (the export tool's own tolerance).
SERVE_SIGMA, SERVE_GRID = 0.5, 64
SERVE_BATCHES, SERVE_CALLS = (128, 32), 25
SERVE_SAMPLES = 1000
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)
# Phase 15: the folder's corpus (CelebA's aligned 178x218 JPEGs at quality 90,
# each one of the synthetic corpus's 32 bases under its own noise of ±12) and
# its make_shards store's shard size; the stream positions (seed, epoch,
# batch) compared across the folder, its array and its store, 8 batches each
# (the second crosses an epoch of 64 batches); fit's steps per timed run and
# its rounds of turns; the images scored by tools.score (FID over 64
# random-conv features: a 2048² sqrtm on the host is no part of the folder's
# branch); the full CelebA's image count; and the native loader against
# Pillow (tests/test_native.py's bound).
FOLDER_SIZE, FOLDER_IMAGES, FOLDER_BASES, FOLDER_SHARD = (178, 218), 2048, 32, 512
FOLDER_STREAMS, FOLDER_BATCHES = ((0, 0, 0), (3, 1, 60)), 8
FOLDER_STEPS, FOLDER_ROUNDS, FOLDER_CHUNKS = 24, 2, 3
FOLDER_SCORED, FOLDER_FID_DIM = 512, 64
CELEBA_IMAGES = 202_599
NATIVE_VS_PIL = dict(mean=1.5, p99=3)
# Phase 16: the processes of the data-parallel runs, the pairs each scores
# in evaluate and the FID's random-conv feature count (a 2048² sqrtm on the
# host is no part of the merge), the losses' relative tolerance of two ranks
# against one process by step, and the runs' time limit.
DP_WORLD, DP_EVAL, DP_FID_DIM = 2, 64, 64
DP_LOSS_TOL = {1: 1e-4, 3: 1e-3}
DP_TIMEOUT = 300.0
# Phase 17: the samples diagnosed and the σ of the blurred objective (the
# run's σ₀); the tool's chunk, so the blur launches the objective implies;
# its rows, kernel against plain blur: SWD and FID within rtol 1e-3 and one
# unit of the rows' 2-place rounding; the Inception trunk's inputs and
# tolerance (tests/test_torch_metrics.py's) for the converted weights.
DIAG_SAMPLES, DIAG_SIGMA, DIAG_CHUNK = 1000, SIGMA0, 100
DIAG_TOL = dict(rel_tol=1e-3, abs_tol=0.01)
DIAG_INCEPTION_BATCH, DIAG_INCEPTION_TOL = 8, dict(rtol=1e-4, atol=1e-4)
# Phase 18: the bench's invocations, each a process of its own, one after
# another, with the blur launches of one eager step each must read; a run's
# time limit.
BENCH_RUNS = (("default", [], 6), ("f32", ["--f32", "--no_peak"], 6),
              ("f32_torch", ["--f32", "--blur_impl", "torch", "--no_peak"], 0),
              ("f32_chunked", ["--f32", "--chunked"], 6), ("infer", ["--infer"], 0),
              ("infer_export", ["--infer_export"], 0))
BENCH_TIMEOUT = 300.0
# ``bench --ablation``'s arms and the blur launches of one eager step of each.
ABLATION_LAUNCHES = {"full": 6, "no_gen": 4, "no_gp": 3, "no_blur": 0}
# Phase 19: the quality check's runs (configuration, examples, arm), seed 0;
# the keys of the meta that benchmarks/quality_parity.py train_ours writes for
# a plain run, and the device's fields the port adds; the 64² blur timings'
# σ (the sharp and the heavy-blur surfaces' σ₀).
QUALITY_RUNS = (("mnist", 3200, {}), ("celeba64_sharp", 640, {"bf16": True}),
                ("celeba64", 640, {}))
# The run scored on the card (~50 s for its two rows, most of it the FIDs'
# host sqrtm; the MNIST and heavy-blur runs' scoring was cut to pay for phase
# 18's --ablation).
QUALITY_SCORED = ("celeba64_sharp",)
TRAIN_OURS_META = {"framework", "config", "seed", "examples", "backend", "ema_decay",
                   "compute_dtype", "images_per_sec", "elapsed_s"}
QUALITY_META = TRAIN_OURS_META | {"device", "power_limit_w"}
QUALITY_SIGMAS = (0.05, 5.0)


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
        argv += [f"--{k}"] if v is True else [f"--{k}", str(v)]
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
    time over wall time). The profiler has lost kernel records (148 blur
    launches of 25 replays of 6, once): a count that is no whole multiple of
    the replays is logged and the chunk profiled once more, and a second such
    count fails. Trains the state on: use it last."""
    from torch.profiler import ProfilerActivity, profile

    from blurred_gan_tpu_torch.train.fast import chunk_indices

    runner = trainer.chunk_runner
    k = runner.chunk_steps
    for attempt in (1, 2):
        n = trainer.state.n_batches
        idx = chunk_indices(trainer.dataset.num_examples, trainer.hparams.global_batch_size,
                            k, n, trainer.cfg.seed)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            runner.run(idx, n)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        trainer.state.n_batches += k
        trainer.state.n_img += k * trainer.hparams.global_batch_size
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        launches, blur_us = blur_kernel_rows(prof)
        if busy == 0:
            raise RuntimeError(f"{what}: the profiler saw no device time in a chunk")
        if launches % k == 0:
            break
        if attempt == 2:
            raise RuntimeError(f"{what}: {launches} blur launches in {k} replayed steps")
        log(f"[chunked] {what}: the profiler counted {launches} blur launches in {k} replayed "
            f"steps, no whole number per step; profiling another chunk")
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
    """Phase 10: the chunked mode against the host loop, then its numbers.
    Returns the chunked images/s."""
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
    return chunked_rate


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


def expected_launches(phase, accum: int) -> int:
    """Blur launches of one step of ``phase`` = (do_gp, do_gen): per
    microbatch the critic on cat([fakes, reals]); with the penalty its
    forward, backward and double backward on the interpolates; with the
    generator step the critic's forward on the fakes and its backward."""
    do_gp, do_gen = phase
    return accum * (1 + 3 * do_gp + 2 * do_gen)


def variant_trainer(template, dataset, workdir, name, flags, adaptive=False):
    """A trainer of phase 4's configuration with the variant's
    hyperparameters; its networks are copies of ``template``, initialised
    from the seed by the trainer."""
    import copy

    from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
    from blurred_gan_tpu_torch.train.config import (
        BlurredWGANGPHyperParameters, WGANHyperParameters)
    from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig

    hp = (WGANHyperParameters(batch_size=BATCH, global_batch_size=BATCH) if flags is None
          else BlurredWGANGPHyperParameters(batch_size=BATCH, global_batch_size=BATCH, **flags))
    cfg = TrainerConfig(log_dir=os.path.join(workdir, f"variant_{name}"),
                        sample_grid_every_n_examples=0, checkpoint_every_n_examples=0,
                        image_summaries_interval_batches=0, save_sample_pngs=False, seed=0)
    ctrl = ({"adaptive_controller": AdaptiveBlurController(max_value=SIGMA0)} if adaptive else
            {"blur_controller": BlurDecayController(total_n_training_examples=10 * NUM_EXAMPLES,
                                                    max_value=SIGMA0)})
    return Trainer(copy.deepcopy(template), hp, dataset, device="cuda", trainer_config=cfg,
                   **ctrl)


@contextlib.contextmanager
def captured_launches(blur_cuda):
    """Record the kernel launches of each phase's step as the runner
    captures it (a replay launches what was captured): yields the dict."""
    from blurred_gan_tpu_torch.train.fast import ChunkRunner

    counts = {}
    step = ChunkRunner._step

    def counted(self, phase):
        before = blur_cuda.launch_count
        out = step(self, phase)
        if torch.cuda.is_current_stream_capturing():
            counts[phase] = blur_cuda.launch_count - before
        return out

    ChunkRunner._step = counted
    try:
        yield counts
    finally:
        ChunkRunner._step = step


def run_variant(blur_cuda, template, dataset, workdir, name, flags, card, bit_equal=False):
    """Phase 12, one configuration (and phase 13's chunked check, which
    needs every step ``bit_equal``). Returns its record for the JSON line."""
    import shutil

    from blurred_gan_tpu_torch.train.fast import state_tensors
    from blurred_gan_tpu_torch.train.step import step_phase

    total = 10 * NUM_EXAMPLES
    torch.backends.cudnn.deterministic = True
    try:
        ref = capturable_adam(variant_trainer(template, dataset, workdir, f"{name}_fit", flags))
        accum = ref.hparams.grad_accumulation_steps
        with torch.no_grad():
            start = [t.clone() for t in state_tensors(ref.state)]
        per_step = count_step_launches(blur_cuda, ref)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        blur_cuda.launch_count = 0
        ref.fit(total_examples=total, max_steps=VARIANT_CHUNK)
        torch.cuda.synchronize()
        fit_launches = blur_cuda.launch_count
        fit_peak = torch.cuda.max_memory_allocated() - held
        chunked = variant_trainer(template, dataset, workdir, f"{name}_chunked", flags)
        with captured_launches(blur_cuda) as captured:
            chunked.fit_device_resident(total_examples=total, chunk_steps=VARIANT_CHUNK,
                                        max_chunks=1)
            torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    runner = chunked.chunk_runner
    phases = [step_phase(ref.hparams, n) for n in range(VARIANT_CHUNK)]
    want = [expected_launches(p, accum) for p in phases]
    if fit_launches == 0 or per_step != want:
        raise RuntimeError(f"phase 12 {name}: kernel launches per step of fit {per_step}, "
                           f"expected {want} for phases {phases}")
    if sorted(runner.graphs) != sorted(set(phases)) or captured != {
            p: expected_launches(p, accum) for p in runner.graphs}:
        raise RuntimeError(f"phase 12 {name}: graphs {sorted(runner.graphs)}, launches "
                           f"captured per phase {captured}, phases {sorted(set(phases))}")
    history, ref_history = list(chunked.history), list(ref.history)
    if len(history) != VARIANT_CHUNK or len(ref_history) != VARIANT_CHUNK:
        raise RuntimeError(f"phase 12 {name}: {len(history)} chunked, {len(ref_history)} "
                           f"fit steps")
    for n, (a, b) in enumerate(zip(ref_history, history)):
        if not losses_close(a, b) or a["did_gen_step"] != b["did_gen_step"]:
            raise RuntimeError(f"phase 12 {name}, step {n + 1}: chunked {b} vs fit {a}")
        if a["std"] != b["std"] or not math.isclose(a["std"], ref.blur_controller.sigma(n),
                                                    rel_tol=1e-6):
            raise RuntimeError(f"phase 12 {name}, step {n + 1}: sigma {b['std']!r} vs fit "
                               f"{a['std']!r}")
        if not all(math.isfinite(b[k]) for k in ("disc_loss", "gen_loss", "gp_term")):
            raise RuntimeError(f"phase 12 {name}, step {n + 1}: {b}")
    diffs = relative_diffs(ref_history, history)
    if bit_equal and any(diffs):
        raise RuntimeError(f"{name}: chunked steps part from fit's under deterministic cuDNN "
                           f"(largest relative difference per step {diffs})")
    # Timed twice: replaying the comparison's graphs (cuDNN's deterministic
    # algorithms), then graphs captured anew with the default ones, as a run
    # takes them.
    chunked.fit_device_resident(total_examples=total, chunk_steps=VARIANT_CHUNK,
                                max_chunks=VARIANT_TIMED_CHUNKS)
    if chunked.chunk_runner is not runner:
        raise RuntimeError(f"phase 12 {name}: the runner was not kept")
    det_rate = statistics.median(chunk_rates(list(chunked.history)[VARIANT_CHUNK:],
                                             VARIANT_CHUNK))
    chunked.chunk_runner = runner = None
    n_timed = len(chunked.history)
    chunked.fit_device_resident(total_examples=total, chunk_steps=VARIANT_CHUNK,
                                max_chunks=1 + VARIANT_TIMED_CHUNKS)
    runner = chunked.chunk_runner
    before, warmed, after = runner.capture_reserved
    rate = statistics.median(chunk_rates(list(chunked.history)[n_timed + VARIANT_CHUNK:],
                                         VARIANT_CHUNK))
    record = {"name": name, "phases": {f"{int(g)}{int(d)}": captured[(g, d)]
                                       for g, d in sorted(captured, reverse=True)},
              "graphs": len(runner.graphs), "chunked_img_per_s": rate,
              "capture_s": runner.capture_seconds, "bit_equal_steps": sum(d == 0 for d in diffs),
              "deterministic_img_per_s": det_rate,
              "graph_bytes": after - warmed, "fit_peak_bytes": fit_peak, "held_bytes": held}
    line = (f"[variants] {name}: {VARIANT_CHUNK} chunked steps equal fit's (largest relative "
            f"difference {max(diffs):.1e}, {sum(d == 0 for d in diffs)} steps bit-equal), sigma "
            f"bit-equal; blur launches per step of fit {per_step}, per captured phase "
            f"(gp, gen) {record['phases']}; chunked {rate:.1f} img/s (median of "
            f"{VARIANT_TIMED_CHUNKS} chunks of {VARIANT_CHUNK} after the capture chunk, "
            f"default cuDNN), {det_rate:.1f} replaying the comparison's deterministic-cuDNN "
            f"graphs; {len(runner.graphs)} graphs captured in "
            f"{runner.capture_seconds:.2f} s, reserved {before / 2**20:.0f} MiB before the "
            f"warm-up, {warmed / 2**20:.0f} MiB after it (cache emptied), "
            f"{after / 2**20:.0f} MiB after the captures (+{(after - warmed) / 2**20:.0f} MiB); "
            f"fit's peak allocated {fit_peak / 2**20:.0f} MiB over the "
            f"{held / 2**20:.0f} MiB held before it")
    if accum > 1:
        # The kernel against the plain blur at the microbatches' plane counts:
        # one step each from fit's starting state.
        first = {}
        for impl in ("cuda", "torch"):
            ref.state.g_opt.state.clear()
            ref.state.d_opt.state.clear()
            with torch.no_grad():
                for t, v in zip(state_tensors(ref.state), start):
                    t.copy_(v)
            ref.state.n_img = ref.state.n_batches = 0
            ref.gan.blur_impl = impl
            reals = torch.from_numpy(next(dataset.batches(BATCH, seed=1))).to(ref.device)
            first[impl] = {k: float(v) for k, v in
                           ref.step_fn(ref.state, reals, SIGMA0)[0].items()}
        if not losses_close(first["torch"], first["cuda"]):
            raise RuntimeError(f"phase 12 {name}: kernel {first['cuda']} vs plain "
                               f"{first['torch']}")
        line += ("; one step, kernel vs plain blur: " + ", ".join(
            f"{k} {first['cuda'][k]:+.6f}/{first['torch'][k]:+.6f}"
            for k in ("disc_loss", "gen_loss", "gp_term")))
    log(line + f" on {card}")
    ref.close()
    chunked.close()
    del ref, chunked, runner
    shutil.rmtree(os.path.join(workdir, f"variant_{name}_fit"), ignore_errors=True)
    shutil.rmtree(os.path.join(workdir, f"variant_{name}_chunked"), ignore_errors=True)
    return record


def gate_rate(template, dataset, workdir, name, flags, card):
    """Phase 12: chunked images/s with the adaptive controller, whose stop
    gate clones every state tensor each step. Returns (img/s, bytes cloned
    per step)."""
    from blurred_gan_tpu_torch.train.fast import state_tensors

    tr = variant_trainer(template, dataset, workdir, f"{name}_gate", flags, adaptive=True)
    tr.fit_device_resident(total_examples=10 ** 9, chunk_steps=VARIANT_CHUNK,
                           max_chunks=1 + VARIANT_TIMED_CHUNKS)
    tr.close()
    rate = statistics.median(chunk_rates(list(tr.history)[VARIANT_CHUNK:], VARIANT_CHUNK))
    cloned = sum(t.numel() * t.element_size() for t in state_tensors(tr.state))
    log(f"[variants] {name} with the adaptive controller: chunked {rate:.1f} img/s (median of "
        f"{VARIANT_TIMED_CHUNKS} chunks of {VARIANT_CHUNK}); its stop gate clones "
        f"{cloned / 2**20:.0f} MiB of state per step on {card}")
    return rate, cloned


def run_variants(blur_cuda, dataset, workdir, card):
    """Phase 12. Returns the variants' records."""
    import gc

    from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
    from blurred_gan_tpu_torch.train.state import GAN

    template = GAN(celeba_generator(RES), celeba_discriminator(RES), blurred=True)
    records = []
    for name, flags in VARIANTS:
        records.append(run_variant(blur_cuda, template, dataset, workdir, name, flags, card))
        gc.collect()
        torch.cuda.empty_cache()
        # What stays allocated once the configuration's trainers are gone
        # (flat from one configuration to the next since the runners share
        # one capture stream, train/fast.py).
        records[-1]["allocated_after_bytes"] = torch.cuda.memory_allocated()
        log(f"[variants] {name}: {records[-1]['allocated_after_bytes'] / 2**20:.1f} MiB "
            f"allocated once its trainers were dropped on {card}")
    by_name = {r["name"]: r for r in records}
    for name in ("default", "ema"):
        flags = dict(VARIANTS)[name]
        by_name[name]["gated_img_per_s"], by_name[name]["gate_bytes_per_step"] = gate_rate(
            template, dataset, workdir, name, flags, card)
        gc.collect()
        torch.cuda.empty_cache()
    base = by_name["default"]
    for key, what in (("chunked_img_per_s", "default"),
                      ("deterministic_img_per_s", "deterministic")):
        log(f"[variants] chunked img/s ({what} cuDNN) against the default's "
            f"{base[key]:.1f}: " + ", ".join(
                f"{r['name']} {r[key]:.1f} ({r[key] / base[key]:.2f}x)" for r in records)
            + f" on {card}")
    log(f"[variants] fit's peak allocated over what was held before it, accumulation of 4 "
        f"against 1: {by_name['accum_4']['fit_peak_bytes'] / 2**20:.0f} / "
        f"{base['fit_peak_bytes'] / 2**20:.0f} MiB on {card}")
    non_jax_check()
    return records


def precision_template(flags):
    """The CelebA-128 pair with the entry point's dtypes for ``flags``."""
    from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
    from blurred_gan_tpu_torch.train.state import GAN
    from blurred_gan_tpu_torch.train_celeba import network_dtypes, parse_args

    dtypes = network_dtypes(parse_args([f"--{k}" for k in flags]))
    return GAN(celeba_generator(RES, **dtypes["generator"]),
               celeba_discriminator(RES, **dtypes["discriminator"]), blurred=True)


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@contextlib.contextmanager
def recorded_dtypes(gan):
    """Forward hooks recording the output dtypes of the generator's first
    convolution, first BatchNorm and output (the fakes), and of the critic's
    first convolution and output (the scores): yields ``{what: set}``."""
    modules = {"first conv": gan.generator.ups[0].conv, "BatchNorm": gan.generator.bns[0],
               "fakes": gan.generator, "critic conv": gan.discriminator.convs[0],
               "scores": gan.discriminator}
    seen = {k: set() for k in modules}
    handles = [m.register_forward_hook(
        lambda mod, args, out, k=k: seen[k].add(dtype_name(out.dtype)))
        for k, m in modules.items()]
    try:
        yield seen
    finally:
        for h in handles:
            h.remove()


def expected_dtypes(flags):
    low = "bfloat16" if flags.get("bf16") else "float32"
    fast = "bfloat16" if flags.get("fast_gen") and flags.get("bf16") else "float32"
    # The generator's first convolution feeds a float32 BatchNorm: its sums
    # stay float32 under --bf16 (models/dcgan.py's f32_sums).
    return {"first conv": {"float32"}, "BatchNorm": {fast}, "fakes": {fast},
            "critic conv": {low}, "scores": {"float32"}}


@contextlib.contextmanager
def recorded_critic_grad_norms(state):
    """The norm of each critic gradient handed to its optimizer: yields the list."""
    from blurred_gan_tpu_torch.train import step as step_mod

    norms = []
    apply = step_mod._apply

    def recording(opt, params, grads):
        if opt is state.d_opt:
            norms.append(float(torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))))
        apply(opt, params, grads)

    step_mod._apply = recording
    try:
        yield norms
    finally:
        step_mod._apply = apply


class _Float32Sums:
    """``torch.nn.functional`` whose convolutions and dense product, given
    bfloat16 operands, return their float32 sums unrounded: a copy of the
    ``--mode generator_f32_sums`` harness of ``tests/torch_tpu_precision.py``
    that the card's ``celeba64_sharp --bf16`` quality runs trained under
    before ``--bf16`` kept those sums itself (``models/dcgan.py``'s
    ``f32_sums``)."""

    def __getattr__(self, name):
        return getattr(torch.nn.functional, name)

    @staticmethod
    def _f32(fn, x, w, *args, **kw):
        if x.dtype != torch.bfloat16:
            return fn(x, w, *args, **kw)
        return fn(x.float(), w.float(), *[a.float() if torch.is_tensor(a) else a for a in args],
                  **kw)

    def conv2d(self, x, w, bias=None, **kw):
        return self._f32(torch.nn.functional.conv2d, x, w, bias, **kw)

    def conv_transpose2d(self, x, w, *args, **kw):
        return self._f32(torch.nn.functional.conv_transpose2d, x, w, *args, **kw)

    def linear(self, x, w, bias=None):
        return self._f32(torch.nn.functional.linear, x, w, bias)


@contextlib.contextmanager
def harness_f32_sums():
    """Inside, every generator forward runs with :class:`_Float32Sums` (the
    harness's ``generator_f32_sums``; TF32 off, as the entry points run)."""
    from blurred_gan_tpu_torch.models import dcgan

    forward = dcgan.DCGANGenerator.forward

    def gen_forward(self, z):
        functional, dcgan.F = dcgan.F, _Float32Sums()
        try:
            return forward(self, z)
        finally:
            dcgan.F = functional

    dcgan.DCGANGenerator.forward = gen_forward
    try:
        yield
    finally:
        dcgan.DCGANGenerator.forward = forward


def rounding_generator(generator):
    """``generator`` as ``--bf16`` ran before its products kept their float32
    sums: every product's result rounded to bfloat16."""
    for m in generator.modules():
        if hasattr(m, "f32_sums"):
            m.f32_sums = False
    return generator


def bf16_landing_step(workdir, reals):
    """Phase 13g: one ``--bf16`` step through the entry point's trainer
    against the same step of a trainer whose generator rounds every product
    (:func:`rounding_generator`) run inside the harness the card's quality runs
    used (:func:`harness_f32_sums`), from the same weights, draws and reals
    under deterministic cuDNN: the losses and every state tensor bit-equal.
    The rounding generator outside the harness differs (the check can
    tell). Returns the largest loss difference of that one."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for name in ("landed", "harness", "rounding"):
            trainer, _ = build_trainer(smoke_args(os.path.join(workdir, f"landing_{name}"),
                                                  bf16=True), feeders=[])
            if name != "landed":
                rounding_generator(trainer.gan.generator)
            with harness_f32_sums() if name == "harness" else contextlib.nullcontext():
                metrics, _ = trainer.step_fn(trainer.state, reals, SIGMA0)
            torch.cuda.synchronize()
            out[name] = ({k: float(v) for k, v in metrics.items()},
                         {k: (v.clone() if torch.is_tensor(v) else v)
                          for k, v in state_tensors(trainer.state).items()})
            trainer.close()
    finally:
        torch.backends.cudnn.deterministic = False
    (landed, landed_state), (harness, harness_state) = out["landed"], out["harness"]
    unequal = [k for k in landed if landed[k] != harness[k]] + [
        k for k, v in landed_state.items()
        if not (torch.equal(v, harness_state[k]) if torch.is_tensor(v) else v == harness_state[k])]
    if unequal:
        raise RuntimeError(f"phase 13: the landed --bf16 step differs from the rounding "
                           f"generator's inside the harness in {unequal[:10]}")
    rounding = out["rounding"][0]
    apart = max(abs(rounding[k] - landed[k]) for k in ("disc_loss", "gen_loss"))
    if apart == 0.0:
        raise RuntimeError("phase 13: the rounding generator's step equals the landed one")
    log(f"[bf16] landed --bf16 step (the generator's float32 sums) against the rounding "
        f"generator inside tests/torch_tpu_precision.py's former generator_f32_sums harness, "
        f"deterministic cuDNN: losses and {len(landed_state)} state tensors bit-equal "
        f"(d_loss {landed['disc_loss']:+.8f}, gen_loss {landed['gen_loss']:+.8f}); the rounding "
        f"generator alone {apart:.3e} away")
    return apart


def bf16_landing_rates(card):
    """Phase 13h: bench's fixed-batch step (``bench.fixed_batch_window``:
    CelebA-128, b32, a CUDA graph replayed 50 steps a window) for ``--bf16``
    and ``--bf16 --fast_gen``, the generator with its float32 sums (landed)
    and rounding every product (before), one window of each in turns over
    ``bench.WINDOWS`` rounds after a warm-up. Returns the medians by
    configuration."""
    from blurred_gan_tpu_torch import bench

    device = torch.device("cuda", torch.cuda.current_device())
    res, batch, steps = bench.CARD_DEFAULTS
    make_gan, windows = bench.make_gan, {}

    def rounded(*args, **kw):
        gan = make_gan(*args, **kw)
        rounding_generator(gan.generator)
        return gan

    try:
        for flags in ([], ["--fast_gen"]):
            args = bench.parse_args(flags)
            for sums in (True, False):
                bench.make_gan = make_gan if sums else rounded
                windows[" ".join(["--bf16", *flags]), sums] = bench.fixed_batch_window(
                    args, device, torch.bfloat16, res, batch, steps)
    finally:
        bench.make_gan = make_gan
    for window in windows.values():
        window()
    order = list(windows)
    rates = {key: [] for key in order}
    for rep in range(bench.WINDOWS):
        for key in (order if rep % 2 == 0 else order[::-1]):
            rates[key].append(windows[key](rep)[0])
    out = {}
    for flags in dict.fromkeys(k[0] for k in order):
        landed, before = (statistics.median(rates[flags, s]) for s in (True, False))
        out[flags] = {"landed_img_per_s": landed, "before_img_per_s": before,
                      "landed_runs": rates[flags, True], "before_runs": rates[flags, False]}
        log(f"[bf16] bench {flags} (b{batch}, {res}², windows of {steps} replayed steps in "
            f"turns): the generator's float32 sums {landed:.2f} img/s "
            f"({batch / landed * 1e3:.3f} ms/step; runs "
            f"{', '.join(f'{r:.1f}' for r in rates[flags, True])}) against rounding "
            f"{before:.2f} img/s ({batch / before * 1e3:.3f} ms/step; runs "
            f"{', '.join(f'{r:.1f}' for r in rates[flags, False])}): "
            f"{landed / before:.3f}x on {card}")
    del windows
    return out


def bf16_fit(blur_cuda, workdir, name, flags):
    """Phase 13a: ``fit`` through the entry point with ``flags``. Returns the
    kernel's launches."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    trainer, total = build_trainer(
        smoke_args(os.path.join(workdir, f"bf16_{name}"), sample_grid_every=0,
                   checkpoint_every=0, save_image_summaries_interval=0, **flags), feeders=[])
    per_step = count_step_launches(blur_cuda, trainer)
    blur_cuda.launch_count = 0
    with recorded_dtypes(trainer.gan) as seen:
        trainer.fit(total_examples=total, max_steps=STEPS)
        torch.cuda.synchronize()
    launches = blur_cuda.launch_count
    history = list(trainer.history)
    check_history(trainer, history, f"phase 13 {name}")
    if per_step != [6] * STEPS or launches != 6 * STEPS:
        raise RuntimeError(f"phase 13 {name}: kernel launches per step {per_step}, {launches} "
                           f"in all; want 6 a step")
    want = expected_dtypes(flags)
    if seen != want:
        raise RuntimeError(f"phase 13 {name}: dtypes {seen}, want {want}")
    log(f"[bf16] {name}: {STEPS} steps of Trainer.fit through build_trainer: d_loss "
        f"{history[0]['disc_loss']:+.4f} -> {history[-1]['disc_loss']:+.4f}, sigma "
        f"{history[0]['std']:.4f} -> {history[-1]['std']:.4f}, {launches} kernel launches (6 per "
        f"step); dtypes " + ", ".join(f"{k} {'/'.join(sorted(v))}" for k, v in seen.items()))
    trainer.close()
    return launches


def bf16_first_steps(workdir, reals):
    """Phase 13b/c: the first step of fresh entry-point trainers from the
    same weights and draws, under deterministic cuDNN (the bfloat16 step's
    float32 generator products vary from run to run otherwise, and its
    bfloat16 critic turns that into a 2% spread of ``gen_loss`` between two
    runs of one path, PERF.md §6): each bfloat16 configuration with
    the kernel and with the plain blur, and float32 with the kernel.
    Returns ``{(name, impl): (losses, critic gradient norm)}``."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, flags in PRECISIONS:
            for impl in (("cuda",) if name == "float32" else ("cuda", "torch")):
                trainer, _ = build_trainer(smoke_args(
                    os.path.join(workdir, f"first_{name}_{impl}"), **flags), feeders=[])
                trainer.gan.blur_impl = impl
                with recorded_critic_grad_norms(trainer.state) as norms:
                    metrics, _ = trainer.step_fn(trainer.state, reals, SIGMA0)
                    out[name, impl] = ({k: float(v) for k, v in metrics.items()}, norms[0])
                trainer.close()
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def check_bf16_steps(first):
    """Phase 13b/c on :func:`bf16_first_steps`'s results."""
    keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores")
    f32, f32_norm = first["float32", "cuda"]
    for name, _ in PRECISIONS[1:]:
        (kern, kern_norm), (plain, plain_norm) = first[name, "cuda"], first[name, "torch"]
        for k in keys:
            if not math.isclose(kern[k], plain[k], rel_tol=BF16_STEP_TOL["rtol"],
                                abs_tol=BF16_STEP_TOL["atol"]):
                raise RuntimeError(f"phase 13 {name}, first step {k}: kernel {kern[k]} vs plain "
                                   f"{plain[k]}")
        rel = {k: abs(kern[k] - f32[k]) / max(abs(f32[k]), 1e-12) for k in keys}
        rel["critic grad norm"] = abs(kern_norm - f32_norm) / f32_norm
        pairs = dict({k: (kern[k], f32[k]) for k in keys},
                     **{"critic grad norm": (kern_norm, f32_norm)})
        for k, (a, b) in pairs.items():
            if not (math.isfinite(a) and abs(a - b) <= GROSS_REL * abs(b) + GROSS_ABS):
                raise RuntimeError(f"phase 13 {name}: {k} {a} against float32's {b}")
        log(f"[bf16] {name}, first step, kernel vs plain blur: " + ", ".join(
            f"{k} {kern[k]:+.6f}/{plain[k]:+.6f}" for k in ("disc_loss", "gen_loss", "gp_term"))
            + f", critic grad norm {kern_norm:.6f}/{plain_norm:.6f} (tolerance rtol "
            f"{BF16_STEP_TOL['rtol']}, atol {BF16_STEP_TOL['atol']})")
        log(f"[bf16] {name} against float32, first step from the same weights and draws, "
            f"relative difference: " + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
            + f" (float32: d_loss {f32['disc_loss']:+.6f}, gen_loss {f32['gen_loss']:+.6f}, "
            f"critic grad norm {f32_norm:.6f}; bound {GROSS_REL}·|f32| + {GROSS_ABS})")


def time_chunk(trainer):
    """Seconds of one more chunk of the trainer's runner, replayed and
    synchronised (the host launches only)."""
    from blurred_gan_tpu_torch.train.fast import chunk_indices

    runner = trainer.chunk_runner
    k, n = runner.chunk_steps, trainer.state.n_batches
    idx = chunk_indices(trainer.dataset.num_examples, trainer.hparams.global_batch_size, k, n,
                        trainer.cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.run(idx, n)
    torch.cuda.synchronize()
    trainer.state.n_batches += k
    trainer.state.n_img += k * trainer.hparams.global_batch_size
    return time.perf_counter() - t0


def profile_precision(trainer, name, step_flops, card):
    """Phase 13f: one replayed chunk under torch.profiler: the top kernels,
    the busy share, the blur's and the copy kernels' time (the dtype casts
    and the layout copies), TFLOP/s at ``step_flops`` a step. Trains the
    state on."""
    from torch.profiler import ProfilerActivity, profile

    from blurred_gan_tpu_torch.train.fast import chunk_indices

    runner = trainer.chunk_runner
    k, n = runner.chunk_steps, trainer.state.n_batches
    idx = chunk_indices(trainer.dataset.num_examples, trainer.hparams.global_batch_size, k, n,
                        trainer.cfg.seed)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.run(idx, n)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    trainer.state.n_batches += k
    trainer.state.n_img += k * trainer.hparams.global_batch_size
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    if not rows:
        raise RuntimeError(f"phase 13 {name}: the profiler saw no device time in a chunk")
    busy = sum(r[0] for r in rows)
    blur = sum(r[0] for r in rows if "blur_planes" in r[1])
    blur_n = sum(r[2] for r in rows if "blur_planes" in r[1])
    # PyTorch's copies (``.to``, ``.contiguous``): float32 has the layout
    # copies too; ``bfloat16_copy_kernel`` is the float32 -> bfloat16 cast.
    copies = sum(r[0] for r in rows if "copy_kernel" in r[1])
    casts = sum(r[0] for r in rows if "bfloat16_copy_kernel" in r[1])
    # cuDNN's own NCHW <-> NHWC transposes around its NHWC kernels.
    layout = sum(r[0] for r in rows if "nchwToNhwc" in r[1] or "nhwcToNchw" in r[1])
    step_s = wall_us / k / 1e6
    tflops = step_flops / step_s / 1e12
    log(f"[bf16] {name}, profiled chunk of {k} replayed steps: wall {wall_us / k / 1e3:.2f} "
        f"ms/step, device busy {busy / k / 1e3:.2f} ms/step ({100 * busy / wall_us:.1f}% of "
        f"wall); blur_planes {blur_n / k:.1f} launches, {blur / k:.1f} us/step "
        f"({100 * blur / busy:.2f}% of busy); copy kernels (dtype casts and layout copies) "
        f"{copies / k / 1e3:.3f} ms/step ({100 * copies / busy:.1f}%), of which float32 -> "
        f"bfloat16 casts {casts / k / 1e3:.3f} ms ({100 * casts / busy:.1f}%); cuDNN's NCHW/NHWC "
        f"transposes {layout / k / 1e3:.3f} ms/step ({100 * layout / busy:.1f}%); {tflops:.1f} "
        f"TFLOP/s at "
        f"{step_flops / 1e9:.1f} GFLOP/step = {100 * tflops * 1e12 / PEAK_BF16_FLOPS:.2f}% of the "
        f"dense bf16 peak, {100 * tflops * 1e12 / PEAK_F32_FLOPS:.1f}% of the float32 peak on "
        f"{card}")
    for dev, key, count in sorted(rows, reverse=True)[:10]:
        log(f"[bf16]   {name}: {100 * dev / busy:5.1f}%  {dev / k / 1e3:8.3f} ms/step  "
            f"x{count // k:<4d} {key[:110]}")
    return {"blur_us_per_step": blur / k, "blur_launches_per_step": blur_n / k,
            "blur_share": blur / busy, "copy_ms_per_step": copies / k / 1e3,
            "copy_share": copies / busy, "cast_ms_per_step": casts / k / 1e3,
            "cast_share": casts / busy, "layout_ms_per_step": layout / k / 1e3,
            "layout_share": layout / busy, "busy_ms_per_step": busy / k / 1e3,
            "busy_share": busy / wall_us, "tflops": tflops}


def run_bf16(blur_cuda, dataset, workdir, card, f32_default):
    """Phase 13. Returns its record for the JSON line."""
    import gc

    from blurred_gan_tpu_torch.bench import train_step_flops

    reals = torch.from_numpy(next(dataset.batches(BATCH, seed=1))).to("cuda")
    fit_launches = {name: bf16_fit(blur_cuda, workdir, name, flags)
                    for name, flags in PRECISIONS[1:]}
    check_bf16_steps(bf16_first_steps(workdir, reals))
    landing = {"rounding_loss_apart": bf16_landing_step(workdir, reals),
               "bench": bf16_landing_rates(card)}
    gc.collect()
    torch.cuda.empty_cache()
    templates = {name: precision_template(flags) for name, flags in PRECISIONS}
    records = {"float32": f32_default}
    for name, _ in PRECISIONS[1:]:
        records[name] = run_variant(blur_cuda, templates[name], dataset, workdir,
                                    f"{name}_chunked", {}, card, bit_equal=True)
        gc.collect()
        torch.cuda.empty_cache()

    # Chunked and fit images/s in turns, each configuration's graphs
    # captured anew with cuDNN's default algorithms.
    trainers = {name: variant_trainer(templates[name], dataset, workdir, f"{name}_turns", {})
                for name, _ in PRECISIONS}
    for tr in trainers.values():
        tr.fit_device_resident(total_examples=10 ** 9, chunk_steps=VARIANT_CHUNK, max_chunks=1)
    order = [name for name, _ in PRECISIONS]
    order += order[::-1]
    chunk_s = {name: [] for name in trainers}
    for name in order:
        chunk_s[name].append(time_chunk(trainers[name]))
    # The configuration's count (bench.train_step_flops), one for all three.
    step_flops = train_step_flops(RES, next(iter(trainers.values())).hparams)
    profiles = {name: profile_precision(tr, name, step_flops, card)
                for name, tr in trainers.items()}
    fit_rates = {name: [] for name in trainers}
    fit_peak = {}
    for name in order:
        tr = trainers[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        tr.fit(total_examples=10 ** 9, max_steps=BF16_FIT_STEPS)
        torch.cuda.synchronize()
        fit_peak.setdefault(name, torch.cuda.max_memory_allocated() - held)
        fit_rates[name].append(statistics.median(
            h["images_per_sec"] for h in list(tr.history)[-BF16_FIT_STEPS + 2:]))
    out = {}
    for name in trainers:
        runner_record = records[name]
        chunked = [VARIANT_CHUNK * BATCH / t for t in chunk_s[name]]
        out[name] = dict(profiles[name], chunked_img_per_s=statistics.mean(chunked),
                         chunked_runs=chunked, fit_img_per_s=statistics.mean(fit_rates[name]),
                         fit_runs=fit_rates[name], fit_peak_bytes=fit_peak[name],
                         capture_s=trainers[name].chunk_runner.capture_seconds,
                         graph_bytes=(trainers[name].chunk_runner.capture_reserved[2]
                                      - trainers[name].chunk_runner.capture_reserved[1]),
                         fit_launches=fit_launches.get(name),
                         deterministic_img_per_s=runner_record["deterministic_img_per_s"],
                         bit_equal_steps=runner_record.get("bit_equal_steps"))
    base = out["float32"]
    for name, r in out.items():
        log(f"[bf16] {name}: chunked {r['chunked_img_per_s']:.1f} img/s "
            f"({r['chunked_img_per_s'] / base['chunked_img_per_s']:.2f}x float32; runs "
            f"{', '.join(f'{v:.1f}' for v in r['chunked_runs'])}, chunks of {VARIANT_CHUNK} in "
            f"turns), fit {r['fit_img_per_s']:.1f} img/s "
            f"({r['fit_img_per_s'] / base['fit_img_per_s']:.2f}x; runs "
            f"{', '.join(f'{v:.1f}' for v in r['fit_runs'])}, median of steps 3-{BF16_FIT_STEPS}), "
            f"deterministic-cuDNN chunked {r['deterministic_img_per_s']:.1f}; capture "
            f"{r['capture_s']:.2f} s, graph pool +{r['graph_bytes'] / 2**20:.0f} MiB, fit's peak "
            f"allocated {r['fit_peak_bytes'] / 2**20:.0f} MiB over what was held on {card}")
    for tr in trainers.values():
        tr.close()
    del trainers
    gc.collect()
    torch.cuda.empty_cache()
    non_jax_check()
    out["landing"] = landing
    return out


SERVE_CHILD = """
import sys
import torch
# float32 as the port computes it: cuDNN's default allows TF32 in convolutions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
program = torch.export.load(sys.argv[1])
serve = program.module()
latents = torch.load(sys.argv[2])
with torch.no_grad():
    out = {b: serve(z.to("cuda")).cpu() for b, z in latents.items()}
torch.save(out, sys.argv[3])
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("blurred_gan_tpu_torch", "blurred_gan_tpu", "jax"))
if loaded:
    raise SystemExit(f"the serving process imported {loaded}")
print("served batches", sorted(out), "with torch alone")
"""


def run_processes(jobs, workdir, timeout=900.0, what="phase 14"):
    """Run each job, ``name: (python arguments, working directory, the job it
    waits for or None)``, in a process of its own with its output in
    ``workdir/<name>.log``: those that wait for none at once, each other one
    when the job it waits for has exited with 0. Returns {name: (exit code,
    or None if it never started; output; seconds)}. Every process has ended
    when it returns; ``what`` names the caller in the timeout's error."""
    procs, done = {}, {}

    def start(name):
        argv, cwd, _ = jobs[name]
        f = open(os.path.join(workdir, f"{name}.log"), "w")
        procs[name] = (subprocess.Popen([sys.executable, *argv], cwd=cwd, stdout=f,
                                        stderr=subprocess.STDOUT), f, time.perf_counter())

    try:
        for name, (_, _, after) in jobs.items():
            if after is None:
                start(name)
        deadline = time.perf_counter() + timeout
        while len(done) < len(jobs):
            if time.perf_counter() > deadline:
                raise RuntimeError(f"{what}: {sorted(set(jobs) - set(done))} not done "
                                   f"after {timeout:.0f} s")
            for name, (p, f, t0) in list(procs.items()):
                if name in done or p.poll() is None:
                    continue
                done[name] = (p.returncode, time.perf_counter() - t0)
                for waiting, (_, _, after) in jobs.items():
                    if after == name and p.returncode == 0:
                        start(waiting)
                    elif after == name:
                        done[waiting] = (None, 0.0)
            time.sleep(0.1)
    finally:
        for p, f, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
    out = {}
    for name, (rc, seconds) in done.items():
        output = f"not started: {jobs[name][2]} failed"
        if rc is not None:
            with open(os.path.join(workdir, f"{name}.log")) as f:
                output = f.read()
        out[name] = (rc, output, seconds)
    return out


def last_json(output: str) -> dict:
    return json.loads(output.strip().splitlines()[-1])


def serving_speed(gan, state, artifact, card):
    """Generator images/s at each of ``SERVE_BATCHES``, eager ``make_sample_fn``
    and the loaded artifact in turns: the median of ``SERVE_CALLS``
    synchronised calls, float32 without TF32; and each one's peak device
    memory over what was held."""
    from blurred_gan_tpu_torch.serving import load_generator
    from blurred_gan_tpu_torch.train.step import make_sample_fn

    sample = make_sample_fn(gan)
    fns = {"eager": lambda z: sample(state, z), "artifact": load_generator(artifact)}
    out = {}
    for b in SERVE_BATCHES:
        z = gan.sample_latents(b, torch.Generator().manual_seed(11), "cpu").to("cuda")
        runs, peaks = {name: [] for name in fns}, {}
        for name in ("eager", "artifact", "artifact", "eager"):
            for _ in range(3):
                fns[name](z)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            times = []
            for _ in range(SERVE_CALLS):
                t0 = time.perf_counter()
                fns[name](z)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            runs[name].append(b / statistics.median(times))
            peaks.setdefault(name, torch.cuda.max_memory_allocated() - held)
        out[f"b{b}"] = {f"{name}_img_per_s": statistics.mean(r) for name, r in runs.items()}
        out[f"b{b}"].update({f"{name}_runs": r for name, r in runs.items()})
        out[f"b{b}"].update({f"{name}_peak_bytes": v for name, v in peaks.items()})
    return out


def run_serving(blur_cuda, blur_matrix, full_args, dataset, workdir, card):
    """Phase 14: the serving side on phase 7's run directory. Returns its
    record for the JSON line."""
    import numpy as np

    from blurred_gan_tpu_torch import generate_samples
    from blurred_gan_tpu_torch.bench import generator_flops_per_image
    from blurred_gan_tpu_torch.metrics.fid import random_conv_features
    from blurred_gan_tpu_torch.metrics.kid import kid
    from blurred_gan_tpu_torch.metrics.prdc import prdc
    from blurred_gan_tpu_torch.serving import export_generator, load_generator
    from blurred_gan_tpu_torch.train.loop import to_unit_range
    from blurred_gan_tpu_torch.train.step import make_sample_fn
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    run_dir, device = full_args.log_dir, torch.device("cuda")
    side = 8 * (RES + 2) + 2

    # The sampling path through the entry point, its kernel launches counted,
    # then the same latents through the plain blur.
    grid_png = os.path.join(workdir, "serve_grid.png")
    argv = ["--log_dir", run_dir, "--device", "cuda", "--n", str(SERVE_GRID),
            "--blur_std", str(SERVE_SIGMA), "--out", grid_png]
    blur_cuda.launch_count = 0
    blurred = generate_samples.main(argv)
    torch.cuda.synchronize()
    launches = blur_cuda.launch_count
    if launches != 1:
        raise RuntimeError(f"phase 14: {launches} blur launches for one blurred grid")
    if png_size(grid_png) != (side, side):
        raise RuntimeError(f"phase 14: grid of {png_size(grid_png)}, want {side}x{side}")
    gan, state, step = generate_samples.restore_run(run_dir, "celeba", RES, device)
    latents = generate_samples.grid_latents(gan, generate_samples.parse_args(argv))[0].to(device)
    plain = generate_samples.sample_images(gan, state, latents, blur_std=SERVE_SIGMA,
                                           blur_impl="torch")
    torch.testing.assert_close(blurred, plain, **FWD_TOL,
                               msg=lambda m: f"phase 14, the grid's blur vs plain: {m}")
    grid_err = float((blurred - plain).abs().max())
    timing = time_blur(blur_cuda, blur_matrix, device, 3 * SERVE_GRID, SERVE_SIGMA, card)

    # KID and PRDC on the card against the CPU, on a small input: 200 reals
    # against 200 other reals with noise (the samples of a 12-step generator
    # lie off the reals' manifold, where PRDC is 0 on both).
    feature_fn = random_conv_features((3, RES, RES), dim=256, device=device)
    reals = to_unit_range(torch.from_numpy(dataset.images[:400]).to(device))
    noise = torch.randn(reals[200:].shape, generator=torch.Generator().manual_seed(5))
    fr, ff = feature_fn(reals[:200]), feature_fn(reals[200:] + 0.2 * noise.to(device))
    on = {dev: {**kid(fr.to(dev), ff.to(dev), n_subsets=10, subset_size=100),
                **prdc(fr.to(dev), ff.to(dev), k=5)} for dev in ("cuda", "cpu")}
    for k, v in on["cpu"].items():
        if not math.isclose(on["cuda"][k], v, rel_tol=METRIC_TOL["rtol"],
                            abs_tol=METRIC_TOL["atol"]):
            raise RuntimeError(f"phase 14: {k} on the card {on['cuda'][k]} vs the CPU {v}")

    # The CLIs, all at once, each in a process of its own.
    data_dir = os.path.join(workdir, "serve_data")
    os.makedirs(data_dir, exist_ok=True)
    np.save(os.path.join(data_dir, "shard-00000.npy"), dataset.images)
    rng = torch.Generator().manual_seed(7)
    fakes = torch.cat([generate_samples.sample_images(
        gan, state, gan.sample_latents(100, rng, "cpu").to(device))
        for _ in range(SERVE_SAMPLES // 100)])
    reals_npz, fakes_npz = (os.path.join(workdir, f"{n}.npz") for n in ("reals", "fakes"))
    np.savez(fakes_npz, samples=((fakes.permute(0, 2, 3, 1) + 1.0) * 127.5).round()
             .clamp(0, 255).to(torch.uint8).cpu().numpy())
    np.savez(reals_npz, samples=dataset.images[-SERVE_SAMPLES:])
    artifact = os.path.join(workdir, "generator.pt2")
    pngs = {name: os.path.join(workdir, f"serve_{name}.png")
            for name in ("random", "interpolate", "blur", "ema")}
    # Latents of the server that imports torch alone, started when the
    # export tool has written the artifact.
    lat = {b: gan.sample_latents(b, torch.Generator().manual_seed(b), "cpu") for b in (1, 7, 128)}
    lat_path, served_path = (os.path.join(workdir, n) for n in ("latents.pt", "served.pt"))
    torch.save(lat, lat_path)
    gs = ["-m", "blurred_gan_tpu_torch.generate_samples", "--log_dir", run_dir]
    results = run_processes({
        "sample_random": (gs + ["--out", pngs["random"]], HERE, None),
        "sample_interpolate": (gs + ["--interpolate", "--rows", "4", "--steps", "6",
                                     "--out", pngs["interpolate"]], HERE, None),
        "sample_blur": (gs + ["--blur_std", str(SERVE_SIGMA), "--out", pngs["blur"]], HERE,
                        None),
        "sample_ema": (gs + ["--ema", "--out", pngs["ema"]], HERE, None),
        "export": (["-m", "blurred_gan_tpu_torch.tools.export_generator", "--log_dir", run_dir,
                    "--out", artifact, "--verify_batches", "1,7"], HERE, None),
        "serve_torch_only": (["-c", SERVE_CHILD, artifact, lat_path, served_path], workdir,
                             "export"),
        "evaluate_run": (["-m", "blurred_gan_tpu_torch.tools.evaluate_run", "--log_dir",
                          run_dir, "--data_path", data_dir], HERE, None),
        "score": (["-m", "blurred_gan_tpu_torch.tools.score", "--real", reals_npz,
                   "--fake", fakes_npz, "--kid", "--prdc"], HERE, None),
    }, workdir)
    for name, (rc, output, _) in results.items():
        if (rc != 0) != (name == "sample_ema"):
            raise RuntimeError(f"phase 14, {name}: exit code {rc}\n{output[-3000:]}")
    ema_msg = "--ema: this run has no EMA weights (train with --ema_decay > 0)"
    if ema_msg not in results["sample_ema"][1] or os.path.exists(pngs["ema"]):
        raise RuntimeError(f"phase 14, sample_ema: {results['sample_ema'][1][-2000:]}")
    want_sizes = {"random": (side, side), "blur": (side, side),
                  "interpolate": (6 * (RES + 2) + 2, 4 * (RES + 2) + 2)}
    for name, size in want_sizes.items():
        if png_size(pngs[name]) != size:
            raise RuntimeError(f"phase 14: {name} grid of {png_size(pngs[name])}, want {size}")
    if not all(f"verified batch {b}:" in results["export"][1] for b in (1, 7)):
        raise RuntimeError(f"phase 14, export: {results['export'][1][-2000:]}")
    evaluated = last_json(results["evaluate_run"][1])
    scored = last_json(results["score"][1])
    if evaluated["examples_seen"] != step or not all(
            math.isfinite(v) for k, v in evaluated.items()):
        raise RuntimeError(f"phase 14, evaluate_run: {evaluated}")
    score_keys = ("fid_randconv", "SWDx1e3_avg", "precision", "recall", "density",
                  "coverage", "kid", "kid_std")
    if scored["n_images"] != SERVE_SAMPLES or not all(
            math.isfinite(scored[k]) for k in score_keys):
        raise RuntimeError(f"phase 14, score: {scored}")

    # The artifact as the process that imported torch alone served it.
    served = torch.load(served_path)
    sample = make_sample_fn(gan)
    serve_err = 0.0
    for b, z in lat.items():
        want = sample(state, z.to(device)).cpu()
        torch.testing.assert_close(served[b], want, **SERVE_TOL,
                                   msg=lambda m: f"phase 14, the artifact at batch {b}: {m}")
        serve_err = max(serve_err, float((served[b] - want).abs().max()))
    # The same artifact moved to the CPU and served there.
    moved = load_generator(artifact, device="cpu")(lat[7])
    want = sample(state, lat[7].to(device)).cpu()
    torch.testing.assert_close(moved, want, **SERVE_TOL,
                               msg=lambda m: f"phase 14, the artifact moved to the CPU: {m}")
    moved_err = float((moved - want).abs().max())

    # The average baked into an artifact: a 2-step --ema_decay 0.999 run.
    ema_args = smoke_args(os.path.join(workdir, "serve_ema"), ema_decay=0.999,
                          sample_grid_every=0, checkpoint_every=0,
                          save_image_summaries_interval=0)
    ema_trainer, total = build_trainer(ema_args, feeders=[])
    ema_trainer.fit(total_examples=total, max_steps=2)
    z7 = lat[7].to(device)
    got = load_generator(export_generator(ema_trainer.gan, ema_trainer.state, use_ema=True))(z7)
    want = make_sample_fn(ema_trainer.gan, use_ema=True)(ema_trainer.state, z7)
    live = make_sample_fn(ema_trainer.gan)(ema_trainer.state, z7)
    torch.testing.assert_close(got, want, **SERVE_TOL,
                               msg=lambda m: f"phase 14, the EMA artifact: {m}")
    if torch.allclose(got, live):
        raise RuntimeError("phase 14: the EMA artifact equals the live weights")
    ema_err, ema_gap = float((got - want).abs().max()), float((got - live).abs().max())
    ema_trainer.close()
    del ema_trainer

    flops = generator_flops_per_image(RES, gan.latent_size)
    speed = serving_speed(gan, state, artifact, card)
    non_jax_check()

    log(f"[serving] the entry point's {SERVE_GRID}-image grid at sigma {SERVE_SIGMA}: "
        f"{launches} kernel launch, max |kernel - plain| {grid_err:.2e}; card vs CPU on 200 "
        f"pairs of 256-d features: " + ", ".join(f"{k} {on['cuda'][k]:.6f}/{v:.6f}"
                                                  for k, v in on["cpu"].items())
        + f" on {card}")
    log(f"[serving] CLIs at once ({', '.join(f'{n} {r[2]:.1f} s' for n, r in results.items())}); "
        f"evaluate_run {json.dumps(evaluated)}; score {json.dumps(scored)}")
    log(f"[serving] artifact {os.path.getsize(artifact) / 1e6:.1f} MB, served with torch alone "
        f"at batches {sorted(lat)}, max |artifact - live| {serve_err:.2e} "
        f"(moved to the CPU, batch 7: {moved_err:.2e}); "
        f"EMA artifact vs make_sample_fn(use_ema=True) {ema_err:.2e}, vs the live weights "
        f"{ema_gap:.2e}")
    for b, r in speed.items():
        log(f"[serving] CelebA-{RES} generator {b} float32: eager {r['eager_img_per_s']:.1f} "
            f"img/s (runs {', '.join(f'{v:.1f}' for v in r['eager_runs'])}), artifact "
            f"{r['artifact_img_per_s']:.1f} (runs "
            f"{', '.join(f'{v:.1f}' for v in r['artifact_runs'])}); "
            f"{flops * r['eager_img_per_s'] / 1e12:.2f} / "
            f"{flops * r['artifact_img_per_s'] / 1e12:.2f} TFLOP/s at {flops / 1e9:.2f} "
            f"GFLOP/image = {100 * flops * r['eager_img_per_s'] / PEAK_F32_FLOPS:.1f} / "
            f"{100 * flops * r['artifact_img_per_s'] / PEAK_F32_FLOPS:.1f}% of the float32 "
            f"peak; peak allocated {r['eager_peak_bytes'] / 2**20:.0f} / "
            f"{r['artifact_peak_bytes'] / 2**20:.0f} MiB over what was held on {card}")
    return {"launches": launches, "max_abs_err": grid_err, "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["plain_ms"],
            "planes": timing["planes"], "sigma": SERVE_SIGMA,
            "flops_per_image": flops, "inference": speed,
            "artifact_max_abs_err": serve_err, "moved_to_cpu_max_abs_err": moved_err,
            "ema_artifact_max_abs_err": ema_err,
            "card_vs_cpu": on, "evaluate_run": evaluated, "score": scored,
            "cli_seconds": {n: r[2] for n, r in results.items()}}


def probe_decoders():
    """Phase 15a: (nproc, Pillow's version or None, whether g++ finds
    libjpeg's and libpng's headers, the native loader's build error or None)."""
    from importlib import metadata

    from blurred_gan_tpu_torch import native

    try:
        pillow = metadata.version("Pillow")
    except metadata.PackageNotFoundError:
        pillow = None
    try:
        headers = subprocess.run(
            ["g++", "-fsyntax-only", "-x", "c++", "-"], capture_output=True, text=True,
            timeout=60, input="#include <cstddef>\n#include <cstdio>\n"
                              "#include <jpeglib.h>\n#include <png.h>\n").returncode == 0
    except FileNotFoundError:
        headers = False
    return len(os.sched_getaffinity(0)), pillow, headers, native.build_error()


def write_corpus(folder: str, pillow) -> None:
    """CelebA-shaped JPEGs (PNGs through the port's writer where there is no
    Pillow to encode JPEG), each image a base under noise of its own."""
    import numpy as np

    from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
    from blurred_gan_tpu_torch.utils.images import write_png

    w, h = FOLDER_SIZE
    bases = synthetic_dataset((h, w, 3), FOLDER_BASES, seed=0).images.astype(np.int16)
    rng = np.random.RandomState(0)
    os.makedirs(folder)
    for i in range(FOLDER_IMAGES):
        noise = rng.randint(-12, 13, bases.shape[1:])
        img = np.clip(bases[i % FOLDER_BASES] + noise, 0, 255).astype(np.uint8)
        if pillow:
            from PIL import Image

            Image.fromarray(img).save(os.path.join(folder, f"{i + 1:06d}.jpg"), quality=90)
        else:
            write_png(os.path.join(folder, f"{i + 1:06d}.png"), img)


def timed_batches(dataset, seconds: list) -> None:
    """Record, on the pipeline's worker, the seconds each batch of
    ``dataset``'s stream takes to produce (the decode, for a folder)."""
    batches = dataset.batches

    def timed(*a, **k):
        it = batches(*a, **k)
        while True:
            t0 = time.perf_counter()
            batch = next(it)
            seconds.append(time.perf_counter() - t0)
            yield batch

    dataset.batches = timed


def folder_trainer(workdir, name, path, dataset=None, **flags):
    """The entry point's trainer on ``path`` (its hooks off); ``dataset``
    replaces what it loaded (the same corpus held in memory)."""
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    args = smoke_args(os.path.join(workdir, name), celeba_path=path, sample_grid_every=0,
                      checkpoint_every=0, save_image_summaries_interval=0, **flags)
    trainer, total = build_trainer(args, feeders=[])
    if dataset is not None:
        trainer.dataset = dataset
    return trainer, total


def folder_fit(blur_cuda, trainer, total, steps):
    """``steps`` steps of ``fit``; returns (history, blur launches per step)
    and removes the run directory (a checkpoint is ~190 MB)."""
    import shutil

    per_step = count_step_launches(blur_cuda, trainer)
    trainer.fit(total_examples=total, max_steps=steps)
    torch.cuda.synchronize()
    history = list(trainer.history)
    trainer.close()
    shutil.rmtree(trainer.cfg.log_dir, ignore_errors=True)
    for n, h in enumerate(history):
        if not all(math.isfinite(h[k]) for k in ("disc_loss", "gen_loss", "gp_term")):
            raise RuntimeError(f"phase 15, step {n + 1}: {h}")
    if len(history) != steps or per_step != [6] * steps:
        raise RuntimeError(f"phase 15: {len(history)} steps, blur launches per step "
                           f"{per_step}, want {steps} steps of 6")
    return history, per_step


def stream_bytes(dataset):
    """The first batches of ``dataset``'s stream at each of FOLDER_STREAMS."""
    out = []
    for seed, epoch, batch in FOLDER_STREAMS:
        it = dataset.batches(BATCH, seed=seed, start_epoch=epoch, start_batch=batch)
        out += [next(it).tobytes() for _ in range(FOLDER_BATCHES)]
    return out


def make_shards_cli(source, out_dir, *flags):
    """``python -m blurred_gan_tpu_torch.tools.make_shards`` in a process of
    its own; returns its seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "blurred_gan_tpu_torch.tools.make_shards", source, out_dir,
         "--shard_size", str(FOLDER_SHARD), *flags], cwd=HERE, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, PYTHONPATH=HERE))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0 or "[make_shards] wrote" not in proc.stdout:
        raise RuntimeError(f"phase 15, make_shards: {proc.returncode}\n{proc.stdout[-2000:]}"
                           f"\n{proc.stderr[-4000:]}")
    return seconds


def score_json(argv) -> str:
    """``tools.score``'s JSON line for ``argv`` on the card."""
    import functools
    import io

    from blurred_gan_tpu_torch.metrics.fid import FIDMetric
    from blurred_gan_tpu_torch.tools import score

    buf = io.StringIO()
    fid_metric = score.FIDMetric
    score.FIDMetric = functools.partial(FIDMetric, feature_dim=FOLDER_FID_DIM)
    try:
        with contextlib.redirect_stdout(buf):
            score.main([*argv, "--limit", str(FOLDER_SCORED), "--device", "cuda"])
    finally:
        score.FIDMetric = fid_metric
    return buf.getvalue().strip().splitlines()[-1]


def run_folder(blur_cuda, synthetic, workdir, card):
    """Phase 15: the image-folder path, or, on a machine that can decode no
    image, the shard store's half of it."""
    import numpy as np

    from blurred_gan_tpu_torch.data.pipeline import (
        ArrayDataset, ImageFolderDataset, ShardedArrayDataset, load_mnist, write_shards)

    nproc, pillow, headers, error = probe_decoders()
    log(f"[folder] probe: nproc {nproc}; Pillow {pillow or 'absent'}; libjpeg/libpng headers "
        f"{'present' if headers else 'absent'}; native loader "
        + ("built" if error is None else f"not built ({error})"))
    if error is not None and headers:
        raise RuntimeError(f"phase 15: the headers are present, yet the native loader did "
                           f"not build:\n{error}")
    out = {"nproc": nproc, "pillow": pillow, "headers": headers,
           "native_error": error}
    folder, store = os.path.join(workdir, "img_align_celeba"), os.path.join(workdir, "shards")
    decodes = error is None or pillow is not None

    if decodes:
        t0 = time.perf_counter()
        write_corpus(folder, pillow)
        corpus_s = time.perf_counter() - t0
        ds = ImageFolderDataset(folder, RES)
        t0 = time.perf_counter()
        array = ds.materialize(progress=False)
        materialize_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        in_order = np.concatenate([ds._decode_batch(ds.files[i:i + BATCH])
                                   for i in range(0, ds.num_examples, BATCH)])
        batch_decode_s = time.perf_counter() - t0
        if in_order.tobytes() != array.images.tobytes():
            raise RuntimeError("phase 15: materialize() differs from the per-batch decode")
        decode = {f"{ds.decoder}_materialize": FOLDER_IMAGES / materialize_s,
                  f"{ds.decoder}_batch_{BATCH}": FOLDER_IMAGES / batch_decode_s}
        if ds.decoder == "native":
            from blurred_gan_tpu_torch import native

            t0 = time.perf_counter()
            one = native.decode_batch(ds.files, RES, n_threads=1)
            decode["native_1_thread"] = FOLDER_IMAGES / (time.perf_counter() - t0)
            if one.tobytes() != array.images.tobytes():
                raise RuntimeError("phase 15: the native loader differs at one thread")
        if ds.decoder == "native" and pillow:
            t0 = time.perf_counter()
            pil = np.stack([ds._decode(f) for f in ds.files])
            decode["pil"] = FOLDER_IMAGES / (time.perf_counter() - t0)
            diff = np.abs(pil.astype(np.int16) - array.images.astype(np.int16))
            out["native_vs_pil"] = {"mean": float(diff.mean()),
                                    "p99": float(np.percentile(diff, 99))}
            if (out["native_vs_pil"]["mean"] >= NATIVE_VS_PIL["mean"]
                    or out["native_vs_pil"]["p99"] > NATIVE_VS_PIL["p99"]):
                raise RuntimeError(f"phase 15: native vs Pillow {out['native_vs_pil']}")
        shards_s = make_shards_cli(folder, store, "--resolution", str(RES))
        stores = {"folder": folder, "shards": store, "array": None}
        out.update(decoder=ds.decoder, corpus_s=corpus_s, materialize_s=materialize_s,
                   decode_img_per_s=decode, make_shards_s=shards_s,
                   jpeg_bytes=sum(os.path.getsize(f) for f in ds.files) / FOLDER_IMAGES)
    else:
        log(f"folder: no decoder on this machine (the native loader: {error}; "
            f"Pillow is not installed)")
        # The half that needs no decoder: the CLI on an mnist.npz, then the
        # CelebA-128 store written by the library from the synthetic corpus.
        from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset

        mnist = os.path.join(workdir, "mnist.npz")
        digits = synthetic_dataset((28, 28, 1), FOLDER_IMAGES, seed=0).images[..., 0]
        np.savez(mnist, x_train=digits, x_test=digits[:BATCH])
        shards_s = make_shards_cli(mnist, os.path.join(workdir, "mnist_shards"))
        if (stream_bytes(ShardedArrayDataset(os.path.join(workdir, "mnist_shards")))
                != stream_bytes(load_mnist(mnist))):
            raise RuntimeError("phase 15: the MNIST store's stream differs from its array's")
        array = ArrayDataset(synthetic.images, name="synthetic")
        write_shards(array, store, shard_size=FOLDER_SHARD, progress=False)
        stores = {"shards": store, "array": None}
        out.update(decoder=None, make_shards_s=shards_s)
    shards = ShardedArrayDataset(store)

    # The same stream, byte for byte, from every storage of the corpus.
    streams = {name: stream_bytes(d) for name, d in (
        ("folder", ImageFolderDataset(folder, RES) if decodes else None),
        ("shards", shards), ("array", array)) if d is not None}
    if any(v != streams["array"] for v in streams.values()):
        raise RuntimeError(f"phase 15: the streams differ across {sorted(streams)}")

    # 12 steps from each storage, the same weights and seed, deterministic
    # cuDNN: the losses are bit-equal.
    keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss")
    torch.backends.cudnn.deterministic = True
    try:
        det, launches = {}, {}
        for name, path in stores.items():
            trainer, total = folder_trainer(workdir, f"det_{name}", path or store,
                                            dataset=array if path is None else None)
            det[name], per_step = folder_fit(blur_cuda, trainer, total, STEPS)
            launches[name] = sum(per_step)
    finally:
        torch.backends.cudnn.deterministic = False
    losses = {name: [[h[k] for k in keys] for h in hist] for name, hist in det.items()}
    if any(v != losses["array"] for v in losses.values()):
        raise RuntimeError(f"phase 15: the losses differ across {sorted(losses)}: {losses}")

    # fit images/s from each storage in turns (ABC, CBA), default cuDNN.
    order = list(stores) + list(stores)[::-1]
    rates = {name: [] for name in stores}
    worker_s = []
    for name in order:
        path = stores[name]
        trainer, total = folder_trainer(workdir, f"fit_{name}", path or store,
                                        dataset=array if path is None else None)
        if name == "folder" and not worker_s:
            timed_batches(trainer.dataset, worker_s)
        hist, _ = folder_fit(blur_cuda, trainer, total, FOLDER_STEPS)
        rates[name].append(statistics.median(h["images_per_sec"] for h in hist[2:]))

    # The device-resident mode from the folder (or the store), materialized
    # by the entry point.
    t0 = time.perf_counter()
    chunked, total = folder_trainer(workdir, "resident", folder if decodes else store,
                                    device_resident=True, chunk_steps=TIMED_CHUNK)
    resident_build_s = time.perf_counter() - t0
    chunked.fit_device_resident(total_examples=total, chunk_steps=TIMED_CHUNK,
                                max_chunks=FOLDER_CHUNKS)
    torch.cuda.synchronize()
    if chunked.chunk_runner.data.cpu().numpy().tobytes() != array.images.tobytes():
        raise RuntimeError("phase 15: the device-resident copy differs from the array")
    chunk_list = chunk_rates(chunked.history, TIMED_CHUNK)
    chunked.close()
    del chunked
    torch.cuda.empty_cache()

    scored = None
    if decodes:
        real, fake = os.path.join(workdir, "real.npz"), os.path.join(workdir, "fake.npz")
        np.savez(real, samples=array.images[:FOLDER_SCORED])
        np.savez(fake, samples=synthetic.images[:FOLDER_SCORED])
        torch.backends.cudnn.deterministic = True
        try:
            scored = score_json(["--real", folder, "--fake", fake, "--resolution", str(RES)])
            from_npz = score_json(["--real", real, "--fake", fake])
        finally:
            torch.backends.cudnn.deterministic = False
        if scored != from_npz:
            raise RuntimeError(f"phase 15, score: folder {scored} vs npz {from_npz}")
    non_jax_check()

    gb = CELEBA_IMAGES * RES * RES * 3 / 1e9
    out.update(
        streams=sorted(streams), fit_img_per_s=rates,
        worker_batch_s=statistics.median(worker_s) if worker_s else None,
        chunked_img_per_s=statistics.median(chunk_list[1:]), chunk_img_per_s=chunk_list,
        resident_build_s=resident_build_s, launches=launches,
        score=json.loads(scored) if scored else None,
        full_celeba_gb=gb)
    if decodes:
        out["materialize_full_s"] = materialize_s * CELEBA_IMAGES / FOLDER_IMAGES
        log(f"[folder] {FOLDER_IMAGES} JPEGs of {FOLDER_SIZE[0]}x{FOLDER_SIZE[1]} "
            f"({out['jpeg_bytes'] / 1e3:.1f} KB each, written in {corpus_s:.1f} s) decoded to "
            f"{RES}^2 by {out['decoder']}: "
            + ", ".join(f"{k} {v:.1f} img/s" for k, v in decode.items())
            + f"; materialize {materialize_s:.2f} s, {out['materialize_full_s']:.0f} s scaled "
            f"to {CELEBA_IMAGES:,} images ({gb:.2f} GB uint8 on the card); make_shards CLI "
            f"{shards_s:.1f} s; decode per batch of {BATCH} on the worker "
            f"{1e3 * out['worker_batch_s']:.1f} ms (median of {len(worker_s)})")
        if "native_vs_pil" in out:
            log(f"[folder] native vs Pillow: mean |diff| {out['native_vs_pil']['mean']:.3f}, "
                f"99th percentile {out['native_vs_pil']['p99']:.0f}")
        log(f"[folder] tools.score on the folder = on the npz of its decoded images: {scored}")
    log(f"[folder] streams byte-equal across {', '.join(sorted(streams))} at (seed, epoch, "
        f"batch) {FOLDER_STREAMS}, {FOLDER_BATCHES} batches each; {STEPS} steps of fit from "
        f"each, deterministic cuDNN: losses bit-equal, 6 blur launches a step")
    log(f"[folder] CelebA-{RES} b{BATCH} f32 fit img/s (median of steps 3-{FOLDER_STEPS}, "
        f"runs in turns {' '.join(order)}): "
        + "; ".join(f"{k} {statistics.mean(v):.1f} ({', '.join(f'{r:.1f}' for r in v)})"
                    for k, v in rates.items())
        + f"; --device_resident from the {'folder' if decodes else 'store'}: chunked "
        f"{out['chunked_img_per_s']:.1f} img/s (median of chunks 2-{FOLDER_CHUNKS} of "
        f"{TIMED_CHUNK}; chunks {', '.join(f'{r:.1f}' for r in chunk_list)}), trainer with "
        f"its materialize {resident_build_s:.1f} s on {card}")
    return out


# ---------------------------------------------------------------------------
# Phase 16: data parallelism
# ---------------------------------------------------------------------------


class ConcatShards:
    """A dataset whose batch of B is its ``n`` shards' batches of B / n
    concatenated in shard order: what ``n`` data-parallel processes hold
    together, so one process can train on the global batches they do."""

    def __init__(self, dataset, n: int):
        self.dataset, self.n = dataset, n
        self.name = f"{dataset.name}:concat{n}"

    @property
    def num_examples(self):
        return self.dataset.num_examples

    @property
    def image_shape(self):
        return self.dataset.image_shape

    def batches(self, batch_size, *, seed=0, start_epoch=0, start_batch=0, shard_index=0,
                shard_count=1):
        if shard_count != 1:
            raise ValueError("ConcatShards is the whole of its shards")
        streams = [self.dataset.batches(batch_size // self.n, seed=seed,
                                        start_epoch=start_epoch, start_batch=start_batch,
                                        shard_index=r, shard_count=self.n)
                   for r in range(self.n)]
        for parts in zip(*streams):
            yield np.concatenate(parts)


class PairRecorder:
    """A metric for ``Trainer.evaluate`` that keeps the (reals, fakes) pairs
    it is fed, on the host; it has no cross-process merge."""

    name = "pairs"

    def __init__(self):
        self.reals, self.fakes = [], []

    def update_state(self, reals, fakes):
        self.reals.append(reals.cpu().numpy())
        self.fakes.append(fakes.cpu().numpy())

    def result(self):
        return float(sum(len(r) for r in self.reals))

    def reset_states(self):
        pass


def dp_worker(cfg: dict) -> None:
    """One process of a phase 16 run (``chip_smoke.py --dp_worker <json>``,
    alone or under ``torch.distributed.run``): ``fit`` at the smoke
    configuration with the local batch, backend and device of ``cfg``,
    deterministic cuDNN, the kernel's launches per step and their plane
    counts; then, as ``cfg`` asks, ``evaluate`` (SWD and random-conv FID
    merged, the pairs kept) and a resume. Writes its results as JSON."""
    import torch.distributed as dist

    from blurred_gan_tpu_torch import parallel
    from blurred_gan_tpu_torch.entry import shutdown
    from blurred_gan_tpu_torch.metrics.fid import FIDMetric
    from blurred_gan_tpu_torch.metrics.swd import SWDMetric
    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.runtime import process_index
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    torch.backends.cudnn.deterministic = True
    if cfg.get("group"):
        # torch.distributed.run sets WORLD_SIZE=1 for one process, which asks
        # for no group; the JAX package's trigger asks for a group of one.
        os.environ["BLURRED_GAN_MULTIHOST"] = "1"
    flags = dict(batch_size=cfg["batch"], device=cfg["device"], sample_grid_every=0,
                 checkpoint_every=0, save_image_summaries_interval=0)
    if cfg.get("backend"):
        flags["dist_backend"] = cfg["backend"]
    args = smoke_args(cfg["log_dir"], **flags)
    trainer, total = build_trainer(args, feeders=[])
    if cfg.get("concat"):
        trainer.dataset = ConcatShards(trainer.dataset, cfg["concat"])
    per_step = count_step_launches(blur_cuda, trainer)
    planes, launch = [], blur_cuda._launch

    def recording_launch(x, t_h, t_w):
        planes.append(int(x.shape[0]))
        return launch(x, t_h, t_w)

    blur_cuda._launch = recording_launch
    # The gradients' all-reduce of each step, timed between synchronisations.
    reduce_s, all_reduce_grads = [], parallel.all_reduce_grads

    def timed_all_reduce(grads):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = all_reduce_grads(grads)
        torch.cuda.synchronize()
        reduce_s.append(time.perf_counter() - t)
        return out

    parallel.all_reduce_grads = timed_all_reduce
    t0 = time.perf_counter()
    trainer.fit(total_examples=total, max_steps=STEPS)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    blur_cuda._launch, parallel.all_reduce_grads = launch, all_reduce_grads
    history = list(trainer.history)
    rank = process_index()
    out = {"rank": rank, "world": trainer.world, "device": str(trainer.device),
           "backend": dist.get_backend() if dist.is_initialized() else None,
           "per_step": per_step, "planes": sorted(set(planes)), "fit_s": seconds,
           "history": [{k: v for k, v in h.items() if k != "images_per_sec"} for h in history],
           "img_s": statistics.median(h["images_per_sec"] for h in history[2:]),
           "digest": parallel.state_digest(trainer.state),
           # critic's and generator's all-reduces summed per step, steps 3 on
           "all_reduce_ms": 1e3 * statistics.median(
               a + b for a, b in zip(reduce_s[4::2], reduce_s[5::2]))}
    if cfg.get("eval"):
        pairs = PairRecorder()
        out["eval"] = trainer.evaluate(num_samples=DP_EVAL, metrics=[
            SWDMetric(), FIDMetric(feature_dim=DP_FID_DIM), pairs])
        np.savez(os.path.join(cfg["out"], f"{cfg['name']}_pairs{rank}.npz"),
                 reals=np.concatenate(pairs.reals),
                 fakes=np.concatenate(pairs.fakes))
    if cfg.get("resume"):
        again, _ = build_trainer(args, feeders=[])
        out["resume"] = {"restored": again.restored_examples,
                         "digest": parallel.state_digest(again.state)}
    with open(os.path.join(cfg["out"], f"{cfg['name']}{rank}.json"), "w") as f:
        json.dump(out, f)
    shutdown()


def nccl_probe() -> None:
    """Two ranks of an NCCL group on ``cuda:0`` (``torch.distributed.run``):
    one all-reduce, whose error is the point."""
    import datetime

    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="env://",
                            timeout=datetime.timedelta(seconds=60))
    x = torch.ones(4, device="cuda:0")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    print(f"[nccl probe] rank {dist.get_rank()}: all_reduce gave {x.tolist()}", flush=True)
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun(n: int, *args) -> list:
    """``python -m torch.distributed.run`` arguments for ``n`` processes of
    this script."""
    return ["-m", "torch.distributed.run", "--nproc_per_node", str(n), "--master_port",
            str(free_port()), os.path.abspath(__file__), *args]


def worker_job(cfg: dict, n: int = 0) -> list:
    """The python arguments of a ``dp_worker`` run: under ``torchrun`` with
    ``n`` processes, or alone (``n`` = 0: no group)."""
    argv = ["--dp_worker", json.dumps(cfg)]
    return torchrun(n, *argv) if n else [os.path.abspath(__file__), *argv]


def loss_diffs(want, got, steps=(1, 3, 10)):
    """{step: largest relative difference of the four losses} at ``steps``."""
    keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss")
    return {n: max(abs(got[n - 1][k] - want[n - 1][k]) / max(abs(want[n - 1][k]), 1e-12)
                   for k in keys) for n in steps}


def merged_reference(pair_files, device):
    """SWD and random-conv FID of one process over the ranks' pairs: one FID
    fed every pair in rank order, and each rank's SWD banks (its own patch
    stream, as that rank drew) merged in rank order."""
    from blurred_gan_tpu_torch.metrics.fid import FIDMetric
    from blurred_gan_tpu_torch.metrics.swd import SWDMetric

    fid, swds = FIDMetric(feature_dim=DP_FID_DIM), []
    local_bs = BATCH // len(pair_files)
    for path in pair_files:
        with np.load(path) as z:
            reals, fakes = torch.from_numpy(z["reals"]).to(device), torch.from_numpy(
                z["fakes"]).to(device)
        swd = SWDMetric()
        for i in range(0, reals.shape[0], local_bs):
            fid.update_state(reals[i:i + local_bs], fakes[i:i + local_bs])
            swd.update_state(reals[i:i + local_bs], fakes[i:i + local_bs])
        swds.append(swd)
    banks = [torch.cat(d).cpu().numpy() for s in swds[1:]
             for bank in (s.real_descriptors, s.fake_descriptors) for d in bank]
    swds[0].cross_process_merge(lambda x: [np.asarray(x), banks.pop(0)])
    return {"FID": fid.result(), **swds[0].results()}


def check_ranks(tag, name, read, out_dir, concat, local_planes, device, what):
    """Phase 16's checks of a two-rank run ``name`` against one process on
    the ranks' concatenated reals: 6 launches a rank-step at the local
    planes, the ranks equal, the losses at ``DP_LOSS_TOL``, the resume bit
    for bit, ``evaluate``'s merged scores equal on the ranks and to one
    process over the same pairs. Returns (ranks, loss diffs, merged scores,
    one process's scores)."""
    ranks = [read(name, r) for r in range(DP_WORLD)]
    for r, got in enumerate(ranks):
        if got["per_step"] != [6] * STEPS or got["planes"] != local_planes:
            raise RuntimeError(f"phase 16 {tag} rank {r}: launches per step {got['per_step']}, "
                               f"planes {got['planes']}, want 6 a step at {local_planes}")
        if got["history"] != ranks[0]["history"] or got["digest"] != ranks[0]["digest"]:
            raise RuntimeError(f"phase 16 {tag}: rank {r} differs from rank 0")
        if got["resume"]["restored"] != STEPS * BATCH or got["resume"]["digest"] != got["digest"]:
            raise RuntimeError(f"phase 16 {tag} rank {r}: resume {got['resume']} against the "
                               f"live state {got['digest']}")
    diffs = loss_diffs(concat["history"], ranks[0]["history"])
    log(f"[dp] {tag} {what} against one process at b{BATCH} on their concatenated reals, "
        f"same weights and draws: largest relative difference of the losses at steps 1, 3, "
        f"10: {', '.join(f'{d:.2e}' for d in diffs.values())}")
    for step, tol in DP_LOSS_TOL.items():
        want, got = concat["history"][step - 1], ranks[0]["history"][step - 1]
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss"):
            if not math.isclose(got[k], want[k], rel_tol=tol, abs_tol=tol * 1e-2):
                raise RuntimeError(f"phase 16 {tag}, step {step}: {k} {got[k]!r} vs one "
                                   f"process {want[k]!r} (rtol {tol})")
    evaluated = ranks[0]["eval"]
    if any(g["eval"] != evaluated for g in ranks) or evaluated["pairs"] != float(DP_EVAL):
        raise RuntimeError(f"phase 16 {tag}: the ranks' scores {[g['eval'] for g in ranks]}")
    want = merged_reference([os.path.join(out_dir, f"{name}_pairs{r}.npz")
                             for r in range(DP_WORLD)], device)
    for k in ("FID", "SWDx1e3_avg"):
        if not math.isclose(evaluated[k], want[k], rel_tol=METRIC_TOL["rtol"],
                            abs_tol=METRIC_TOL["atol"]):
            raise RuntimeError(f"phase 16 {tag}: merged {k} {evaluated[k]} vs one process over "
                               f"the same pairs {want[k]}")
    log(f"[dp] {tag} evaluate over {DP_EVAL} pairs a rank, merged: SWDx1e3_avg "
        f"{evaluated['SWDx1e3_avg']:.4f} (one process over the same pairs "
        f"{want['SWDx1e3_avg']:.4f}), random-conv FID ({DP_FID_DIM} features) "
        f"{evaluated['FID']:.4f} ({want['FID']:.4f}); the recorder without a merge logged as "
        f"eval_localshard_pairs; a 2-rank checkpoint restored bit for bit on both ranks; "
        f"blur launches 6 a step on each rank at {local_planes} planes")
    return ranks, diffs, evaluated, want


# ---------------------------------------------------------------------------
# Phase 17: the diagnostic tools
# ---------------------------------------------------------------------------


def buffers_digest(module) -> str:
    """SHA-256 of a module's buffers (BatchNorm's running statistics)."""
    import hashlib

    h = hashlib.sha256()
    for name, t in module.named_buffers():
        h.update(name.encode() + t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def run_diagnose(blur_cuda, state, gan, workdir, card):
    """Phase 17 (a): ``diagnose_samples --sigma`` on 1000 samples of phase
    7's generator, once through the kernel and once through the plain blur.
    Returns the runs' records."""
    import numpy as np

    from blurred_gan_tpu_torch.tools import bn_stats_ab, diagnose_samples
    from blurred_gan_tpu_torch.train.step import make_sample_fn

    set_dir = os.path.join(workdir, "diagnose")
    os.makedirs(set_dir, exist_ok=True)
    latents = torch.from_numpy(bn_stats_ab.eval_latents()[:DIAG_SAMPLES]).to("cuda")
    sample = make_sample_fn(gan)
    fakes = torch.cat([sample(state, latents[i:i + DIAG_CHUNK])
                       for i in range(0, DIAG_SAMPLES, DIAG_CHUNK)])
    np.savez(os.path.join(set_dir, "ours_samples_s0.npz"),
             samples=fakes.permute(0, 2, 3, 1).cpu().numpy())
    argv = ["--dir", set_dir, "--config", f"celeba{RES}", "--seeds", "0", "--sides", "ours",
            "--sigma", str(DIAG_SIGMA), "--device", "cuda"]
    runs = {}
    for name, impl in (("kernel", "auto"), ("plain", "torch")):
        timings = {}
        torch.cuda.synchronize()
        blur_cuda.launch_count = 0
        t0 = time.perf_counter()
        rows = diagnose_samples.main(argv, blur_impl=impl, timings=timings)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = blur_cuda.launch_count
        parts = {k: sum(t.get(k, 0.0) for t in timings.values())
                 for k in ("blur_s", "swd_s", "fid_s")}
        runs[name] = {"rows": rows, "launches": launches, "seconds": seconds, **parts}
        log(f"[diagnose] diagnose_samples --config celeba{RES} --sigma {DIAG_SIGMA} on "
            f"{DIAG_SAMPLES} samples, {name} blur: {seconds:.1f} s, of which blur "
            f"{parts['blur_s']:.3f} s, SWD {parts['swd_s']:.2f} s, FID {parts['fid_s']:.2f} s; "
            f"{launches} kernel launches; {json.dumps(rows[-1])} on {card}")
    # 10 chunks of 100 for the reals and 10 for the set, one launch each.
    want = 2 * DIAG_SAMPLES // DIAG_CHUNK
    if runs["kernel"]["launches"] != want or runs["plain"]["launches"] != 0:
        raise RuntimeError(f"phase 17: blur launches {runs['kernel']['launches']} with the "
                           f"kernel (want {want}), {runs['plain']['launches']} with the plain "
                           f"blur (want 0)")
    # Pixel statistics and bands equal; the objective within DIAG_TOL.
    kernel, plain = ([{k: v for k, v in r.items() if k != "blurred_objective"}
                      for r in runs[name]["rows"]] for name in ("kernel", "plain"))
    objective = runs["kernel"]["rows"][-1]["blurred_objective"]
    plain_objective = runs["plain"]["rows"][-1]["blurred_objective"]
    if kernel != plain or list(objective) != list(plain_objective) or not all(
            math.isclose(objective[k], v, **DIAG_TOL) for k, v in plain_objective.items()):
        raise RuntimeError(f"phase 17: the kernel's rows {runs['kernel']['rows']} against "
                           f"the plain blur's {runs['plain']['rows']}")
    if not all(math.isfinite(v) for v in objective.values()):
        raise RuntimeError(f"phase 17: blurred objective {objective}")
    return runs


def run_bn_ab(state, gan, run_dir, workdir, card):
    """Phase 17 (b): ``bn_stats_ab`` on phase 7's run directory; the batch
    pass leaves the restored generator's buffers as they were, and the
    running pass equals the eval-mode generator. Returns its record."""
    import numpy as np

    from blurred_gan_tpu_torch.tools import bn_stats_ab
    from blurred_gan_tpu_torch.train.step import make_sample_fn

    digests = []
    sample = bn_stats_ab.sample

    def recorded(generator, *args, **kwargs):
        before = buffers_digest(generator)
        out = sample(generator, *args, **kwargs)
        digests.append((before, buffers_digest(generator)))
        return out

    out_dir = os.path.join(workdir, "bn_ab")
    bn_stats_ab.sample = recorded
    try:
        t0 = time.perf_counter()
        rows = bn_stats_ab.main(["--log_dir", run_dir, "--corpus_n", str(NUM_EXAMPLES),
                                 "--out_npz_dir", out_dir, "--device", "cuda"])
        seconds = time.perf_counter() - t0
    finally:
        bn_stats_ab.sample = sample
    name = os.path.basename(run_dir.rstrip("/"))
    if [r["set"] for r in rows] != ["reals", f"{name}:bn_running", f"{name}:bn_batch"] or any(
            r["n"] != DIAG_SAMPLES for r in rows):
        raise RuntimeError(f"phase 17, bn_stats_ab: rows {rows}")
    if len(digests) != 2 or any(a != b for a, b in digests):
        raise RuntimeError(f"phase 17, bn_stats_ab: the generator's buffers before and after "
                           f"each pass {digests}")
    with np.load(os.path.join(out_dir, f"{name}_bn_running.npz")) as d:
        running = torch.from_numpy(d["samples"]).permute(0, 3, 1, 2)
    latents = torch.from_numpy(bn_stats_ab.eval_latents()).to("cuda")
    want = torch.cat([make_sample_fn(gan)(state, latents[i:i + DIAG_CHUNK]).cpu()
                      for i in range(0, DIAG_SAMPLES, DIAG_CHUNK)])
    torch.testing.assert_close(running, want, **FWD_TOL,
                               msg=lambda m: f"phase 17, bn_stats_ab's running pass: {m}")
    log(f"[diagnose] bn_stats_ab on phase 7's run directory: {seconds:.1f} s; the generator's "
        f"buffers {digests[1][0][:12]}... before and after the batch pass; running pass equal "
        f"to the eval-mode generator (max |diff| {float((running - want).abs().max()):.2e}); "
        + "; ".join(json.dumps(r) for r in rows[1:]) + f" on {card}")
    return {"rows": rows, "seconds": seconds, "buffers_digest": digests[1][0]}


def run_convert(workdir, card):
    """Phase 17 (c): ``convert_inception`` on a torchvision state dict made
    from ``random_inception_params`` with a random γ folded out; the npz on
    the card gives the source parameters' features. Returns its record."""
    from blurred_gan_tpu_torch.metrics.inception import (
        MIN_INPUT_HW, inception_features, load_inception_weights, random_inception_params)
    from blurred_gan_tpu_torch.tools import convert_inception

    params = random_inception_params(0)
    gen = torch.Generator().manual_seed(1)
    sd = {}
    for scope, unit in params.items():
        mod = scope.replace("/", ".")
        g = 0.5 + torch.rand(unit["beta"].shape, generator=gen)
        sd[f"{mod}.conv.weight"] = unit["w"] / g[:, None, None, None]
        sd[f"{mod}.bn.weight"], sd[f"{mod}.bn.bias"] = g, unit["beta"]
        sd[f"{mod}.bn.running_mean"], sd[f"{mod}.bn.running_var"] = unit["mean"] / g, unit["var"]
    src, out = (os.path.join(workdir, n) for n in ("inception_v3.pth", "inception_v3.npz"))
    torch.save(sd, src)
    t0 = time.perf_counter()
    convert_inception.main([src, out])
    seconds = time.perf_counter() - t0
    device = torch.device("cuda:0")
    loaded = load_inception_weights(out, device=device)
    x = torch.rand((DIAG_INCEPTION_BATCH, 3, MIN_INPUT_HW, MIN_INPUT_HW),
                   generator=gen).to(device) * 2 - 1
    with torch.no_grad():
        got = inception_features(loaded, x)
        want = inception_features({s: {f: t.to(device) for f, t in u.items()}
                                   for s, u in params.items()}, x)
    torch.testing.assert_close(got, want, **DIAG_INCEPTION_TOL,
                               msg=lambda m: f"phase 17, the converted weights' features: {m}")
    err = float((got - want).abs().max())
    log(f"[diagnose] convert_inception: a torchvision state dict to "
        f"{os.path.getsize(out) / 1e6:.1f} MB of npz in {seconds:.1f} s; loaded on {device}, its "
        f"features of "
        f"{DIAG_INCEPTION_BATCH} images at {MIN_INPUT_HW}² within {err:.2e} of the source "
        f"parameters' on {card}")
    return {"seconds": seconds, "features_max_abs_err": err}


def run_diagnostics(blur_cuda, blur_matrix, full_args, workdir, card):
    """Phase 17: the three diagnostic tools on what phase 7 left. Returns the
    record for the JSON line."""
    from blurred_gan_tpu_torch import generate_samples

    run_dir = full_args.log_dir
    gan, state, _ = generate_samples.restore_run(run_dir, "celeba", RES, torch.device("cuda"))
    runs = run_diagnose(blur_cuda, state, gan, workdir, card)
    # The kernel at the objective's chunk: 100 images of 3 planes.
    timing = time_blur(blur_cuda, blur_matrix, torch.device("cuda"), 3 * DIAG_CHUNK,
                       DIAG_SIGMA, card)
    bn = run_bn_ab(state, gan, run_dir, workdir, card)
    converted = run_convert(workdir, card)
    non_jax_check()
    return {"launches": runs["kernel"]["launches"], "ms": timing["ms"],
            "plain_ms": timing["plain_ms"], "bound_ms": timing["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": timing["plain_ms"],
            "planes": timing["planes"], "sigma": DIAG_SIGMA,
            "diagnose": {name: {k: v for k, v in r.items() if k != "rows"}
                         for name, r in runs.items()},
            "objective": runs["kernel"]["rows"][-1]["blurred_objective"],
            "bn_stats_ab": bn, "convert_inception": converted}


def run_data_parallel(blur_cuda, blur_matrix, device, workdir, slice_history, card):
    """Phase 16: the data-parallel path (``runtime``, ``parallel``, the
    step's and the Trainer's multi-process paths) on this card."""
    out_dir = os.path.join(workdir, "dp")
    os.makedirs(out_dir)

    def cfg(name, batch, **kw):
        return dict(name=name, batch=batch, out=out_dir, log_dir=os.path.join(out_dir, name),
                    **kw)

    jobs = {
        # (a) a group of one over NCCL, and no group, at the smoke batch.
        "nogroup": (worker_job(cfg("nogroup", BATCH, device="cuda:0")), HERE, None),
        "one": (worker_job(cfg("one", BATCH, device="cuda", group=True), 1), HERE, None),
        # (b) one process on the two ranks' concatenated reals, then the two
        # ranks on the one card over gloo.
        "concat": (worker_job(cfg("concat", BATCH, device="cuda:0", concat=DP_WORLD)), HERE,
                   "one"),
        "gloo": (worker_job(cfg("gloo", BATCH // DP_WORLD, device="cuda:0", backend="gloo",
                                eval=True, resume=True), DP_WORLD), HERE, "concat"),
        # NCCL refuses two ranks on one device (a probe that must fail).
        "nccl_one_card": (torchrun(DP_WORLD, "--nccl_probe"), HERE, "gloo"),
    }
    two_cards = torch.cuda.device_count() >= DP_WORLD
    if two_cards:  # (c) NCCL across two cards
        jobs["nccl"] = (worker_job(cfg("nccl", BATCH // DP_WORLD, device="cuda", eval=True,
                                       resume=True), DP_WORLD), HERE, "gloo")
    results = run_processes(jobs, out_dir, timeout=DP_TIMEOUT, what="phase 16")
    for name, (rc, output, seconds) in results.items():
        log(f"[dp] {name}: exit {rc} in {seconds:.1f} s")
        if name != "nccl_one_card" and rc != 0:
            raise RuntimeError(f"phase 16 {name} exited {rc}:\n{output[-4000:]}")

    def read(name, rank=0):
        with open(os.path.join(out_dir, f"{name}{rank}.json")) as f:
            return json.load(f)

    # (a) the group of one is the plain path, to the bit.
    nogroup, one = read("nogroup"), read("one")
    if (one["world"], one["backend"], nogroup["world"], nogroup["backend"]) != (1, "nccl", 1, None):
        raise RuntimeError(f"phase 16 (a): a group of {one['world']} over {one['backend']}, "
                           f"no group: {nogroup['world']}, {nogroup['backend']}")
    if one["history"] != nogroup["history"] or one["digest"] != nogroup["digest"]:
        raise RuntimeError(f"phase 16 (a): a group of one differs from no group: "
                           f"{relative_diffs(nogroup['history'], one['history'])}")
    if not losses_close(slice_history[0], one["history"][0]):
        raise RuntimeError(f"phase 16 (a), step 1: {one['history'][0]} vs phase 4 "
                           f"{slice_history[0]}")
    log(f"[dp] (a) torch.distributed.run --nproc_per_node 1 over NCCL, {STEPS} steps of fit at "
        f"b{BATCH}, deterministic cuDNN: losses and state bit-equal to a run without a group "
        f"(state digest {one['digest'][:16]}); against phase 4 (default cuDNN) "
        f"{' '.join(f'{d:.1e}' for d in relative_diffs(slice_history, one['history']))}")

    # (b) two ranks sharing the card over gloo against one process.
    concat = read("concat")
    local_planes = sorted({3 * BATCH // DP_WORLD, 6 * BATCH // DP_WORLD})
    ranks, diffs, evaluated, want = check_ranks(
        "(b)", "gloo", read, out_dir, concat, local_planes, device,
        f"2 ranks at b{BATCH // DP_WORLD} on cuda:0 over gloo")
    log(f"[dp] (b) img/s: 2 processes sharing one card through gloo, not a DP speed: "
        f"{ranks[0]['img_s']:.1f} global img/s ({ranks[0]['fit_s']:.1f} s for {STEPS} steps; "
        f"the gradients' all-reduce {ranks[0]['all_reduce_ms']:.1f} ms a step, median of steps "
        f"3-{STEPS}, between synchronisations); "
        f"one process at b{BATCH}: {concat['img_s']:.1f} img/s ({concat['fit_s']:.1f} s) on {card}")
    timings = [time_blur(blur_cuda, blur_matrix, device, planes, SIGMA0, card)
               for planes in reversed(local_planes)]

    rc, output, _ = results["nccl_one_card"]
    said = [ln for ln in output.splitlines() if "uplicate" in ln or "Error" in ln][:3]
    log(f"[dp] NCCL with two ranks on cuda:0: exit {rc}; it says: "
        + (" | ".join(ln.strip()[:300] for ln in said) or output.strip()[-600:]))
    nccl = None
    if two_cards:
        nccl, ndiffs, _, _ = check_ranks("(c)", "nccl", read, out_dir, concat, local_planes,
                                         device, f"2 ranks at b{BATCH // DP_WORLD} on cuda:0 "
                                         f"and cuda:1 over NCCL")
        log(f"[dp] (c) NCCL across two cards: {nccl[0]['img_s']:.1f} global img/s against one "
            f"process's {concat['img_s']:.1f} at b{BATCH} (the gradients' all-reduce "
            f"{nccl[0]['all_reduce_ms']:.1f} ms a step) on {card} x{torch.cuda.device_count()}")
    else:
        log(f"[dp] (c) NCCL across two cards: not run, this machine has "
            f"{torch.cuda.device_count()} card")
    non_jax_check()
    return {"world": DP_WORLD, "backend": "gloo on one card", "loss_rel_diffs": diffs,
            "launches_per_rank_step": ranks[0]["per_step"][0], "planes": local_planes,
            "group_of_one_bit_equal": True, "eval": evaluated, "eval_one_process": want,
            "img_s_two_processes": ranks[0]["img_s"], "img_s_one_process": concat["img_s"],
            "all_reduce_ms": ranks[0]["all_reduce_ms"],
            "blur": timings, "nccl_one_card_rc": rc,
            "nccl_two_cards": None if nccl is None else {
                "loss_rel_diffs": ndiffs, "img_s": nccl[0]["img_s"],
                "all_reduce_ms": nccl[0]["all_reduce_ms"]}}


def bench_line(output: str) -> dict:
    """The bench's JSON line in a process's output (its stderr interleaved)."""
    for line in reversed(output.splitlines()):
        if line.startswith('{"backend"'):
            return json.loads(line)
    raise RuntimeError(f"phase 18: no bench line in\n{output[-3000:]}")


def run_bench(workdir, chunked_rate, card):
    """Phase 18: ``python -m blurred_gan_tpu_torch.bench`` as a user runs it,
    once for each of ``BENCH_RUNS``. Returns the lines by run."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, for the bench's
    lines = {}
    for name, argv, per_step in BENCH_RUNS:
        job = {name: (["-m", "blurred_gan_tpu_torch.bench", *argv], HERE, None)}
        rc, output, seconds = run_processes(job, workdir, timeout=BENCH_TIMEOUT,
                                            what="phase 18")[name]
        if rc != 0:
            raise RuntimeError(f"phase 18, bench {' '.join(argv)}: exit code {rc}\n"
                               f"{output[-3000:]}")
        line = bench_line(output)
        log(f"[bench] {' '.join(argv) or '(no flags)'}, {seconds:.1f} s: {json.dumps(line)}")
        missing = [k for k in ("device", "power_limit_w", "flops_per_step", "mfu")
                   if k not in line]
        if line["correct"] is not True or missing or not card.startswith(line["device"]):
            raise RuntimeError(f"phase 18, bench {name}: correct {line['correct']}, missing "
                               f"{missing}, device {line['device']!r} on {card}")
        # The kernel in the eager step and in the timed runs' warm-up and
        # capture, or in neither.
        if line["blur_launches_per_step"] != per_step or (line["blur_launches"] > 0) != (
                per_step > 0):
            raise RuntimeError(f"phase 18, bench {name}: {line['blur_launches_per_step']} "
                               f"blur launches a step, {line['blur_launches']} in the timed "
                               f"runs; want {per_step} a step")
        lines[name] = dict(line, seconds=seconds)
    # One count for one configuration, whatever blur, dtype or mode runs it.
    for group in (("default", "f32", "f32_torch", "f32_chunked"), ("infer", "infer_export")):
        counts = {lines[n]["flops_per_step"] for n in group}
        if len(counts) != 1:
            raise RuntimeError(f"phase 18: flops_per_step {counts} across {group}")
    log(f"[bench] --f32 --chunked {lines['f32_chunked']['value']:.1f} img/s (median of "
        f"{len(lines['f32_chunked']['windows'])} chunks of {lines['f32_chunked']['chunk_steps']}, "
        f"its own process) beside phase 10's chunked {chunked_rate:.1f} img/s (median of chunks "
        f"2-{TIMED_CHUNKS} of {TIMED_CHUNK}) on {card}")
    return lines


def run_ablation(workdir, card):
    """Phase 18 (b): ``python -m blurred_gan_tpu_torch.bench --ablation
    --no_peak`` (bfloat16, b32) in a process of its own: four arm lines,
    each correct (its kernel step against the plain blur's) with
    ``ABLATION_LAUNCHES`` blur launches an eager step on this card, then the
    ``summary_ms`` line, whose marginals are ``full`` minus each arm.
    Returns the lines."""
    argv = ["-m", "blurred_gan_tpu_torch.bench", "--ablation", "--no_peak"]
    rc, output, seconds = run_processes({"ablation": (argv, HERE, None)}, workdir,
                                        timeout=BENCH_TIMEOUT, what="phase 18")["ablation"]
    if rc != 0:
        raise RuntimeError(f"phase 18, bench --ablation: exit code {rc}\n{output[-3000:]}")
    lines = [json.loads(line) for line in output.splitlines()
             if line.startswith(('{"variant"', '{"summary_ms"'))]
    arms, summary = lines[:-1], lines[-1]
    for line in lines:
        log(f"[bench] --ablation: {json.dumps(line)}")
    got = {a["variant"]: a["blur_launches_per_step"] for a in arms}
    bad = [a["variant"] for a in arms
           if a["correct"] is not True or not card.startswith(a["device"])]
    if got != ABLATION_LAUNCHES or bad or "summary_ms" not in summary or not summary["correct"]:
        raise RuntimeError(f"phase 18, bench --ablation: launches {got} (want "
                           f"{ABLATION_LAUNCHES}), arms not correct or off {card}: {bad}, "
                           f"summary {summary}")
    ms = {a["variant"]: a["ms_per_step"] for a in arms}
    s = summary["summary_ms"]
    for key, arm in (("gen_step_marginal", "no_gen"), ("gp_marginal", "no_gp"),
                     ("blur_marginal", "no_blur")):
        if s[key] != round(ms["full"] - ms[arm], 3):
            raise RuntimeError(f"phase 18, bench --ablation: {key} {s[key]} is not full "
                               f"{ms['full']} minus {arm} {ms[arm]}")
    log(f"[bench] --ablation, {seconds:.1f} s: full {s['full']:.3f} ms/step; marginal ms of "
        f"the generator step {s['gen_step_marginal']:.3f}, the penalty {s['gp_marginal']:.3f}, "
        f"the blur {s['blur_marginal']:.3f} (medians of {s['rounds']} rounds in turns; rounds' "
        f"spread {json.dumps(s['spread_ms'])}) on {card}")
    return {"arms": arms, "summary": summary, "seconds": seconds}


def quality_run(blur_cuda, workdir, config, examples, flags, plain=False):
    """One ``quality.train`` run in this process, seed 0, with the blur
    kernel's launches counted by step (``plain``: the plain blur). Returns
    (meta, trainer, launches per step, launches, seconds)."""
    from blurred_gan_tpu_torch import quality

    trainers, per_step = [], []

    def hook(trainer):
        trainers.append(trainer)
        per_step.append(count_step_launches(blur_cuda, trainer))
        if plain:
            trainer.gan.blur_impl = "torch"

    out = os.path.join(workdir, "quality_plain" if plain else "quality", config)
    blur_cuda.launch_count = 0
    t0 = time.perf_counter()
    meta = quality.train(quality.CONFIGS[config], examples, out, 0, device="cuda",
                         on_trainer=hook, **flags)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return meta, trainers[0], per_step[0], blur_cuda.launch_count, seconds


def check_quality_outputs(out_dir, prefix, cfg, meta, card, what):
    """The run's sample set (finite, NHWC, in [-1, 1], 1000 of the
    configuration's shape, float32) and meta (train_ours's keys, the card)."""
    with np.load(os.path.join(out_dir, f"{prefix}_samples_s0.npz")) as d:
        samples = d["samples"]
    if (samples.shape != (1000, *cfg.image_shape) or samples.dtype != np.float32
            or not np.isfinite(samples).all() or samples.min() < -1 or samples.max() > 1):
        raise RuntimeError(f"{what}: samples {samples.shape} {samples.dtype} in "
                           f"[{samples.min()}, {samples.max()}]")
    with open(os.path.join(out_dir, f"{prefix}_meta_s0.json")) as f:
        written = json.load(f)
    if (written != meta or set(meta) != QUALITY_META or not card.startswith(meta["device"])
            or meta["compute_dtype"] != ("bfloat16" if prefix.endswith("bf16") else "float32")):
        raise RuntimeError(f"{what}: meta {meta}, want the keys {sorted(QUALITY_META)} "
                           f"and {card}")
    return float(samples.std())


def score_quality_set(quality, cfg, out_dir, prefix, what, card):
    """``quality.evaluate`` on the card over the run's sample set: the floor
    row and the set's, each finite with ``evaluate``'s keys and the card's
    stack, the floor's SWD and FIDs below the set's. Returns both rows and
    the seconds."""
    from blurred_gan_tpu_torch.metrics.swd import swd_resolutions

    t0 = time.perf_counter()
    rows = quality.evaluate(cfg, out_dir, [0], device="cuda")
    seconds = time.perf_counter() - t0
    keys = ({"samples", "stack", "SWDx1e3_avg", "fid_randconv", "fid_inception", "precision",
             "recall", "density", "coverage", "kid", "kid_std"}
            | {f"SWDx1e3_{r}" for r in swd_resolutions(cfg.image_shape[0])})
    floor, row = rows["reals_floor"], rows.get(f"{prefix}_s0")
    for r in (floor, row):
        if (r is None or set(r) != keys or r["stack"] != "torch-cuda"
                or not all(math.isfinite(v) for k, v in r.items()
                           if k not in ("samples", "stack"))):
            raise RuntimeError(f"{what}: evaluate's rows {rows}, want finite rows with the "
                               f"keys {sorted(keys)} and stack torch-cuda")
    above = [k for k in ("SWDx1e3_avg", "fid_randconv", "fid_inception") if floor[k] >= row[k]]
    if above:
        raise RuntimeError(f"{what}: the reals floor {floor} is not below the set {row} "
                           f"in {above}")
    log(f"[quality] {cfg.name} {prefix}: scored on the card in {seconds:.1f} s (2 rows): "
        f"floor {json.dumps(floor)}; set {json.dumps(row)} on {card}")
    return {"floor": floor, "row": row, "seconds": seconds}


def run_quality(blur_cuda, blur_matrix, device, workdir, card):
    """Phase 19: ``quality.train`` (the quality check's train side) in this
    process for each of ``QUALITY_RUNS``; each run's first step against a
    one-step run with the plain blur; the kernel at 64²."""
    from blurred_gan_tpu_torch import quality

    runs = []
    for config, examples, flags in QUALITY_RUNS:
        cfg, what = quality.CONFIGS[config], f"phase 19, {config} {flags}"
        # A bfloat16 run and its one-step plain run under deterministic cuDNN,
        # as phase 13's first steps (bf16_first_steps).
        torch.backends.cudnn.deterministic = bool(flags.get("bf16"))
        meta, trainer, per_step, launches, seconds = quality_run(
            blur_cuda, workdir, config, examples, flags)
        steps = examples // BATCH
        if per_step != [6] * steps or launches != 6 * steps:
            raise RuntimeError(f"{what}: kernel launches by step {per_step}, {launches} in "
                               f"the run; want 6 in each of {steps} steps")
        history = list(trainer.history)
        for n, logs in enumerate(history):
            bad = [k for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss")
                   if not math.isfinite(logs[k])]
            if bad or logs["std"] != np.float32(trainer.blur_controller.sigma(n)):
                raise RuntimeError(f"{what}, step {n + 1}: {bad} not finite or sigma "
                                   f"{logs['std']} off the schedule")
        prefix = quality.arm_prefix(**flags)
        spread = check_quality_outputs(os.path.join(workdir, "quality", config), prefix, cfg,
                                       meta, card, what)
        _, plain_trainer, plain_steps, plain_launches, _ = quality_run(
            blur_cuda, workdir, config, BATCH, flags, plain=True)
        torch.backends.cudnn.deterministic = False
        if plain_steps != [0] or plain_launches != 0:
            raise RuntimeError(f"{what}: the plain run launched the kernel {plain_launches} "
                               f"times")
        tol = BF16_STEP_TOL if flags.get("bf16") else STEP_TOL
        first, plain_first = history[0], plain_trainer.history[0]
        keys = ("disc_loss", "gen_loss", "gp_term", "wgan_loss", "fake_scores", "real_scores")
        far = [k for k in keys if not math.isclose(first[k], plain_first[k],
                                                   rel_tol=tol["rtol"], abs_tol=tol["atol"])]
        if far:
            raise RuntimeError(f"{what}: first step, kernel vs plain blur: "
                               f"{ {k: (first[k], plain_first[k]) for k in far} }")
        rel = relative_diffs([plain_first], [first])[0]
        log(f"[quality] {config} {prefix}: {steps} steps of Trainer.fit, 6 kernel launches "
            f"a step ({launches}), d_loss {history[0]['disc_loss']:+.4f} -> "
            f"{history[-1]['disc_loss']:+.4f}, sigma {history[0]['std']:.4f} -> "
            f"{history[-1]['std']:.4f}; first step vs the plain blur within rtol "
            f"{tol['rtol']} (largest relative difference {rel:.2e}); 1000 samples "
            f"{cfg.image_shape} in [-1, 1], std {spread:.4f}; "
            f"{meta['images_per_sec']:.1f} img/s in fit, the run {seconds:.1f} s on {card}")
        score = (score_quality_set(quality, cfg, os.path.join(workdir, "quality", config),
                                   prefix, what, card) if config in QUALITY_SCORED else None)
        runs.append({"config": config, "prefix": prefix, "examples": examples,
                     "launches": launches, "launches_per_step": 6,
                     "images_per_sec": meta["images_per_sec"], "seconds": seconds,
                     "first_step_rel_diff": rel, "score": score})
    # 192 planes: the critic on cat([fakes, reals]) at 64², b32; 96: the other calls.
    timings = [time_blur_graphed(blur_cuda, blur_matrix, device, planes, 64, sigma, card)
               for sigma in QUALITY_SIGMAS for planes in (2 * BATCH * 3, BATCH * 3)]
    non_jax_check()
    return {"runs": runs, "cases": timings}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from blurred_gan_tpu_torch.entry import card_line

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
            chunked_rate = run_chunked(blur_cuda, workdir, history, slice_rate, step_rate, card)
        with phase("11 MNIST"):
            mnist_timings = run_mnist(blur_cuda, blur_matrix, device, workdir, card)
        with phase("12 variants"):
            variants = run_variants(blur_cuda, trainer.dataset, workdir, card)
        with phase("13 bf16"):
            bf16 = run_bf16(blur_cuda, trainer.dataset, workdir, card,
                            next(v for v in variants if v["name"] == "default"))
        with phase("14 serving"):
            serving = run_serving(blur_cuda, blur_matrix, full_args, trainer.dataset,
                                  workdir, card)
        with phase("15 image folder"):
            folder = run_folder(blur_cuda, trainer.dataset, workdir, card)
        with phase("16 data parallelism"):
            parallel = run_data_parallel(blur_cuda, blur_matrix, device, workdir, history, card)
        with phase("17 diagnostic tools"):
            diagnostics = run_diagnostics(blur_cuda, blur_matrix, full_args, workdir, card)
        with phase("18 bench"):
            bench = run_bench(workdir, chunked_rate, card)
            bench["ablation"] = run_ablation(workdir, card)
        with phase("19 quality"):
            quality = run_quality(blur_cuda, blur_matrix, device, workdir, card)

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
        "planes": headline["planes"], "cases": timings + mnist_timings,
        "variants": variants, "bf16": bf16, "serving": serving, "folder": folder,
        "parallel": parallel, "diagnostics": diagnostics, "bench": bench,
        "quality": quality}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def data_parallel_only():
    """``chip_smoke.py --data_parallel``: the build, phase 4 and phase 16
    alone, for a machine with two cards or more, where phase 16 runs (c)."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from blurred_gan_tpu_torch.entry import card_line

    card = card_line()
    log(f"{card} x{torch.cuda.device_count()}")
    from blurred_gan_tpu_torch.entry import set_float32_precision
    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.ops.blur import blur_matrix

    set_float32_precision()
    blur_cuda.build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        with phase("4 slice"):
            _, history, _, _ = run_slice(blur_cuda, workdir)
        with phase("16 data parallelism"):
            parallel = run_data_parallel(blur_cuda, blur_matrix, torch.device("cuda:0"),
                                         workdir, history, card)
    print(json.dumps({"parallel": parallel}), flush=True)


def bf16_ablation_only():
    """``chip_smoke.py --bf16_ablation``: the build, phase 13's landed --bf16
    step and its bench timings, and phase 18's ``bench --ablation`` alone."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
    from blurred_gan_tpu_torch.entry import card_line, set_float32_precision
    from blurred_gan_tpu_torch.ops import blur_cuda

    card = card_line()
    log(card)
    set_float32_precision()
    blur_cuda.build()
    dataset = synthetic_dataset((RES, RES, 3), num_examples=NUM_EXAMPLES)
    reals = torch.from_numpy(next(dataset.batches(BATCH, seed=1))).to("cuda")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        with phase("13 landed bf16"):
            landing = {"rounding_loss_apart": bf16_landing_step(workdir, reals),
                       "bench": bf16_landing_rates(card)}
        with phase("18 bench --ablation"):
            ablation = run_ablation(workdir, card)
    print(json.dumps({"landing": landing, "ablation": ablation}), flush=True)


def first_step_only(root):
    """``chip_smoke.py --first_step <root>``: the build and phase 4's first
    float32 step through the entry point's trainer, from the package under
    ``root`` (another checkout, to hold two trees to the same step in one
    call), under deterministic cuDNN: one JSON line of its losses (as
    float.hex) and a SHA-256 of every state tensor after it."""
    import hashlib

    sys.path.insert(0, os.path.abspath(root))
    import blurred_gan_tpu_torch
    from blurred_gan_tpu_torch.entry import set_float32_precision
    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.train_celeba import build_trainer

    set_float32_precision()
    blur_cuda.build()
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        trainer, _ = build_trainer(smoke_args(os.path.join(workdir, "first"), sample_grid_every=0,
                                              checkpoint_every=0, save_image_summaries_interval=0),
                                   feeders=[])
        reals = torch.from_numpy(next(trainer.dataset.batches(BATCH, seed=1))).to("cuda")
        metrics, _ = trainer.step_fn(trainer.state, reals, SIGMA0)
        digest = hashlib.sha256()
        for k, v in sorted(state_tensors(trainer.state).items()):
            digest.update(k.encode())
            digest.update(v.detach().cpu().numpy().tobytes() if torch.is_tensor(v)
                          else str(v).encode())
        trainer.close()
    print(json.dumps({"package": os.path.dirname(blurred_gan_tpu_torch.__file__),
                      "losses": {k: float(v).hex() for k, v in sorted(metrics.items())},
                      "state_sha256": digest.hexdigest()}), flush=True)


def quality_only():
    """``chip_smoke.py --quality``: the build and phase 19 alone."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    from blurred_gan_tpu_torch.entry import card_line, set_float32_precision
    from blurred_gan_tpu_torch.ops import blur_cuda
    from blurred_gan_tpu_torch.ops.blur import blur_matrix

    card = card_line()
    log(card)
    set_float32_precision()
    blur_cuda.build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        with phase("19 quality"):
            quality = run_quality(blur_cuda, blur_matrix, torch.device("cuda:0"), workdir, card)
    print(json.dumps({"quality": quality}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp_worker"]:
        dp_worker(json.loads(sys.argv[2]))
    elif sys.argv[1:] == ["--nccl_probe"]:
        nccl_probe()
    elif sys.argv[1:] == ["--data_parallel"]:
        data_parallel_only()
    elif sys.argv[1:] == ["--quality"]:
        quality_only()
    elif sys.argv[1:] == ["--bf16_ablation"]:
        bf16_ablation_only()
    elif sys.argv[1:2] == ["--first_step"] and len(sys.argv) == 3:
        first_step_only(sys.argv[2])
    else:
        main()
