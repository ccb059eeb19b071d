"""``python -m blurred_gan_tpu_torch.bench --ablation`` (the port of
``benchmarks/step_ablation.py``) and the closed-form step phases it needs.

- ``train.step.reachable_phases`` and ``phase_shares`` in closed form against
  the brute force over one period of counters, for every ``gp_every_n_steps``
  and ``d_steps_per_g_step`` in 1..12 with and without the penalty, and at
  ``d_steps_per_g_step = 10**9`` (the ``no_gen`` arm's), where the brute
  force would walk a billion counters: under a second, as is a
  ``ChunkRunner``'s construction, whose first chunk equals ``fit``'s steps
  bit for bit on the CPU.
- ``bench.train_step_flops`` weights one step of each phase by its share:
  equal to the average over a period's steps, and under a second at
  ``10**9``.
- Each arm's first two steps against the JAX package's ``make_train_step``
  with the same hyperparameters and ``GAN(blurred=...)``
  (``torch_variant_harness``: flax weights carried over, the JAX step's draws
  pinned, float32), each from the JAX state before it at
  ``test_torch_variants.py``'s one-step tolerances: losses rtol 1e-5 / atol
  1e-6 (the generator's through JAX's updated critic), post-step parameters
  atol 1e-6 where ``|g| >= 1e-4``, BatchNorm statistics rtol 1e-5 / atol
  1e-6.
- ``--ablation --device cpu`` prints four arm lines and the ``summary_ms``
  line, whose marginals are ``full`` minus each arm.
"""

import json
import math
import time
from collections import Counter
from fractions import Fraction

import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch import bench
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters, WGANHyperParameters
from blurred_gan_tpu_torch.train.fast import ChunkRunner
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import (
    make_train_step, phase_shares, reachable_phases, step_phase, step_seed)
from test_torch_bench import RES, small  # noqa: F401  (the bench at 8², narrow networks)
from test_torch_fast import micro_gan
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)
from torch_variant_harness import (
    LOSS, assert_bn_stats_close, assert_params_close, assert_post_step_close, jax_run,
    port_run)

GRID = range(1, 13)


def hp(penalty: bool, batch: int = 4, **kw):
    cls = BlurredWGANGPHyperParameters if penalty else WGANHyperParameters
    return cls(batch_size=batch, global_batch_size=batch, **kw)


@pytest.mark.parametrize("penalty", [True, False], ids=["wgan_gp", "wgan"])
def test_phases_in_closed_form_are_the_brute_force(penalty):
    for g in GRID if penalty else [1]:
        for d in GRID:
            kw = dict(d_steps_per_g_step=d, **({"gp_every_n_steps": g} if penalty else {}))
            h = hp(penalty, **kw)
            period = math.lcm(g, d)
            seen = Counter(step_phase(h, n) for n in range(period))
            assert reachable_phases(h) == sorted(seen, reverse=True), (g, d)
            assert {p: s for p, s in phase_shares(h).items() if s} == {
                p: Fraction(k, period) for p, k in seen.items()}, (g, d)
            assert sum(phase_shares(h).values()) == 1


def test_a_billion_d_steps_take_no_time():
    h = hp(True, d_steps_per_g_step=10 ** 9, gp_every_n_steps=3)
    t0 = time.perf_counter()
    phases = reachable_phases(h)
    assert time.perf_counter() - t0 < 1.0
    assert phases == [(True, True), (True, False), (False, True), (False, False)]
    assert phase_shares(h)[(True, True)] == Fraction(1, 3 * 10 ** 9)


def test_chunk_runner_with_a_billion_d_steps_builds_at_once_and_matches_fit():
    """The runner's first chunk on the CPU (the step body run eagerly) against
    ``fit``'s step function from the same state and seeds: the same bits."""
    h = hp(True, batch=8, d_steps_per_g_step=10 ** 9)
    images = np.random.RandomState(0).randint(0, 256, (16, 16, 16, 1)).astype(np.uint8)
    idx = np.stack([np.arange(8), np.arange(8, 16), np.arange(8)]).astype(np.int32)
    torch.manual_seed(0)
    gan_a = micro_gan()
    torch.manual_seed(0)
    gan_b = micro_gan()
    state_a = create_train_state(gan_a, h, device="cpu")
    t0 = time.perf_counter()
    runner = ChunkRunner(gan_a, h, state_a, images, 3)
    assert time.perf_counter() - t0 < 1.0
    assert runner.phases == [(True, True), (True, False)]
    out = runner.run(idx, 0).clone()
    state_b = create_train_state(gan_b, h, device="cpu")
    step = make_train_step(gan_b, h)
    for i in range(3):
        assert step_seed(0, i) == step_seed(runner.seed, i)
        metrics, _ = step(state_b, torch.from_numpy(images[idx[i]]), h.initial_blur_std)
        row = {k: out[i, runner.names.index(k)] for k in runner.names}
        assert row["did_gen_step"] == float(i == 0)
        for k, v in metrics.items():
            assert torch.equal(v.to(torch.float32), row[k]), (i, k)
    for a, b in zip(state_a.generator.state_dict().values(),
                    state_b.generator.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state_a.discriminator.parameters(), state_b.discriminator.parameters()):
        assert torch.equal(a, b)


def test_train_step_flops_weights_each_phase_by_its_share(small):
    """Against the average over one period's steps, each step counted
    (the count before the closed form), and at ``10**9`` in under a
    second."""
    h = hp(True, batch=4, gp_every_n_steps=2, d_steps_per_g_step=3)
    small_h = hp(True, batch=bench.FLOP_BATCH, gp_every_n_steps=2, d_steps_per_g_step=3)
    gan = bench.make_gan(bench.parse_args([]), RES, torch.float32, "torch")
    state = create_train_state(gan, small_h, device="cpu")
    step = make_train_step(gan, small_h)
    reals = torch.zeros((bench.FLOP_BATCH, RES, RES, 3))
    period = math.lcm(2, 3)
    total = sum(bench.flop_counts(
        lambda: [step(state, reals, torch.tensor(bench.SIGMA0)) for _ in range(period)],
        gan.generator, gan.discriminator).values())
    want = total / period * 4 / bench.FLOP_BATCH
    assert bench.train_step_flops(RES, h) == pytest.approx(want, rel=1e-12)
    t0 = time.perf_counter()
    flops = bench.train_step_flops(RES, hp(True, d_steps_per_g_step=10 ** 9))
    assert time.perf_counter() - t0 < 1.0
    critic_only = bench.train_step_flops(RES, hp(True, d_steps_per_g_step=2)) * 2 - \
        bench.train_step_flops(RES, hp(True))
    assert flops == pytest.approx(critic_only, rel=1e-6)


@pytest.mark.parametrize("name", list(bench.ABLATION))
def test_arm_steps_are_the_jax_steps(name):
    arm = bench.ABLATION[name]
    kw = dict(n0=arm.start, penalty_free=not arm.penalty, blurred=arm.blurred, **arm.hparams)
    states, jmetrics, _ = jax_run(2, **kw)
    for i in range(2):
        gan, state, metrics, grads = port_run(1, first=i, total=2, **kw)
        assert state.n_batches == arm.start + i + 1
        assert_post_step_close(gan.discriminator, states[i + 1].d_params, grads[0]["d"])
        # The generator step through JAX's updated critic (port_run's
        # pin_critic): the no_blur arm's critic has a gradient within
        # rounding of 0 (the Dense bias's, 3e-8), which Adam turns into a
        # 2e-4 difference of its update.
        gen, _, pinned, gen_grads = port_run(1, first=i, total=2, pin_critic=True, **kw)
        got, want = metrics[0], jmetrics[i]
        assert got.keys() == want.keys()
        for k in want:
            value = pinned[0][k] if k == "gen_loss" else got[k]
            np.testing.assert_allclose(value, want[k], err_msg=f"step {i}: {k}", **LOSS)
        assert got["did_gen_step"] == (0.0 if name == "no_gen" else 1.0)
        assert (got["gp_term"] == 0.0) == (name == "no_gp")
        if name == "no_gen":
            assert "g" not in grads[0]
            assert_params_close(gen.generator, states[i].g_params, rtol=0, atol=0)
        else:
            assert_post_step_close(gen.generator, states[i + 1].g_params, gen_grads[0]["g"])
            assert_bn_stats_close(gen.generator, states[i + 1].g_stats)


def test_ablation_prints_four_arms_then_the_summary(small, capsys):
    out = bench.main(["--ablation", "--device", "cpu"])
    lines = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 5 and lines[-1] == out
    arms, summary = lines[:4], lines[4]
    assert [a["variant"] for a in arms] == list(bench.ABLATION)
    for a in arms:
        assert {"variant", "batch", "resolution", "steps", "ms_per_step", "images_per_sec",
                "device", "backend", "compute_dtype", "power_limit_w",
                "blur_launches_per_step", "correct"} <= set(a)
        assert a["correct"] is True and a["device"] == "cpu" and a["resolution"] == RES
        assert a["blur_launches_per_step"] == 0  # the CPU runs the plain version
        assert len(a["windows"]) == bench.WINDOWS
    ms = {a["variant"]: a["ms_per_step"] for a in arms}
    s = summary["summary_ms"]
    assert summary["correct"] is True and s["full"] == ms["full"] and s["median_ms"] == ms
    for key, arm in (("gen_step_marginal", "no_gen"), ("gp_marginal", "no_gp"),
                     ("blur_marginal", "no_blur")):
        assert s[key] == round(ms["full"] - ms[arm], 3)
    assert set(s["spread_ms"]) == set(ms) and min(s["spread_ms"].values()) >= 0


def test_ablation_takes_no_other_mode(capsys):
    with pytest.raises(SystemExit):
        bench.parse_args(["--ablation", "--chunked"])
