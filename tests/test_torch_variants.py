"""The port's train-step variants against the JAX package's step: the
penalty-free WGAN, lazy GP (``gp_every_n_steps``), ``d_steps_per_g_step`` and
flip augmentation; the mirror of tests/test_lazy_gp.py and
tests/test_flip_augment.py, and of the generator gate in tests/test_ema.py.

One step of each, port against JAX, from the same flax weights and with the
JAX step's own draws (``torch_variant_harness``): losses rtol 1e-5 / atol
1e-6, gradients rtol 1e-4 / atol 1e-5, post-step parameters atol 1e-6 with
the ``|g| < 1e-4`` exemption of tests/test_torch_step.py. A phase that starts
mid-cycle (lazy GP's skipped penalty, the skipped generator step) starts from
the initial state with its batch counter set. Four steps of
``d_steps_per_g_step = 2`` and of ``gp_every_n_steps = 2``: the port's own
run, each step's losses at ``PARAM_TOL`` (rtol 5e-4 / atol 5e-5); and each
step from the JAX state before it, its parameters at the one-step tolerance.
Then ``Trainer.fit`` against the chunked mode on the
CPU, the logged ``gen_loss`` and ``did_gen_step``, the flip's draws, and the
entry point's heavy-blur advisory.
"""

import json
import os

import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import (
    make_train_step, random_hflip, reachable_phases, step_phase, step_seed)
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_fast import assert_params_close as assert_states_close, micro_gan
from torch_variant_harness import (
    B, LATENT, LOSS, PARAM_TOL, RES, SIGMA, assert_bn_stats_close, assert_grads_close,
    assert_params_close, assert_post_step_close, jax_grads, jax_run, port_run, reals_batches,
    torch_gan)
from torch_variant_harness import hparams as port_hparams

# name: (port_run / jax_run arguments, the step's GP coefficient or None, GP applied)
SINGLE = {
    "wgan": (dict(penalty_free=True), None, False),
    "lazy_gp_applied": (dict(gp_every_n_steps=2), 20.0, True),
    "lazy_gp_skipped": (dict(gp_every_n_steps=2, n0=1), 20.0, False),
    "flip": (dict(flip_augment=True), 10.0, True),
    "gen_skipped": (dict(d_steps_per_g_step=2, n0=1), 10.0, True),
}


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


@pytest.fixture(scope="module", params=list(SINGLE))
def single(request):
    kw, gp_coefficient, with_gp = SINGLE[request.param]
    states, jmetrics, draws = jax_run(1, **kw)
    gan, state, metrics, grads = port_run(1, **kw)
    gen = "g" in grads[0]
    jgrads = jax_grads(states[0], states[1], reals_batches(1)[0], draws[0],
                       gp_coefficient=gp_coefficient, with_gp=with_gp, gen=gen)
    return dict(name=request.param, gan=gan, state=state, metrics=metrics[0],
                jmetrics=jmetrics[0], grads=grads[0], jgrads=jgrads, jstates=states)


def test_variant_step_metrics(single):
    got, want = single["metrics"], single["jmetrics"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS)
    if single["name"] in ("wgan", "lazy_gp_skipped"):
        assert got["gp_term"] == 0.0
    if single["name"] == "wgan":
        assert got["norm_term"] == 0.0
    assert got["did_gen_step"] == (0.0 if single["name"] == "gen_skipped" else 1.0)
    if single["name"] == "gen_skipped":
        assert got["gen_loss"] == 0.0


def test_variant_step_gradients(single):
    gan = single["gan"]
    assert single["grads"].keys() == single["jgrads"].keys()
    assert_grads_close(gan.discriminator, single["grads"]["d"], single["jgrads"]["d"])
    if "g" in single["jgrads"]:
        assert_grads_close(gan.generator, single["grads"]["g"], single["jgrads"]["g"])


def test_variant_step_parameters(single):
    gan, (s0, s1) = single["gan"], single["jstates"]
    assert_post_step_close(gan.discriminator, s1.d_params, single["jgrads"]["d"])
    if "g" in single["jgrads"]:
        assert_post_step_close(gan.generator, s1.g_params, single["jgrads"]["g"])
        assert_bn_stats_close(gan.generator, s1.g_stats)
    else:  # the generator, its statistics and its optimizer were left alone
        assert_params_close(gan.generator, s0.g_params, rtol=0, atol=0)
        assert_bn_stats_close(gan.generator, s0.g_stats)
        assert not single["state"].g_opt.state


@pytest.mark.parametrize("kw,gp_pattern,gen_pattern", [
    (dict(d_steps_per_g_step=2), [1, 1, 1, 1], [1, 0, 1, 0]),
    (dict(gp_every_n_steps=2), [1, 0, 1, 0], [1, 1, 1, 1])], ids=["d_steps", "lazy_gp"])
def test_four_steps_match_jax(kw, gp_pattern, gen_pattern):
    states, jmetrics, _ = jax_run(4, **kw)
    # The port's own four steps: each step's losses.
    _, state, metrics, _ = port_run(4, **kw)
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"step {i}: {k}", **PARAM_TOL)
    assert [int(m["gp_term"] > 0) for m in metrics] == gp_pattern
    assert [int(m["did_gen_step"]) for m in metrics] == gen_pattern
    assert state.n_batches == 4 and state.n_img == 4 * B
    # Each step from the JAX state before it (weights, Adam moments, counter):
    # its parameters at the one-step tolerance. (Free-running, the two sides'
    # near-zero gradients part them by more than PARAM_TOL in a few elements
    # within four Adam steps.)
    for i in range(4):
        gan, state, _, grads = port_run(1, first=i, total=4, **kw)
        assert_post_step_close(gan.discriminator, states[i + 1].d_params, grads[0]["d"])
        if gen_pattern[i]:
            assert_post_step_close(gan.generator, states[i + 1].g_params, grads[0]["g"])
        else:
            assert_params_close(gan.generator, states[i].g_params, rtol=0, atol=0)
        assert state.n_batches == i + 1


def test_phases():
    hp = port_hparams()
    assert reachable_phases(hp) == [(True, True)] and step_phase(hp, 7) == (True, True)
    hp = port_hparams(gp_every_n_steps=4, d_steps_per_g_step=5)
    assert reachable_phases(hp) == [(True, True), (True, False), (False, True), (False, False)]
    assert [step_phase(hp, n) for n in (0, 4, 5, 6)] == [
        (True, True), (True, False), (False, True), (False, False)]
    assert reachable_phases(port_hparams(gp_every_n_steps=2, d_steps_per_g_step=2)) == [
        (True, True), (False, False)]
    assert reachable_phases(port_hparams(penalty_free=True, d_steps_per_g_step=5)) == [
        (False, True), (False, False)]


def test_default_step_reports_did_gen_step():
    gan = torch_gan()
    hp = port_hparams()
    state = create_train_state(gan, hp, device="cpu")
    metrics, _ = make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]), SIGMA)
    assert metrics["did_gen_step"].item() == 1.0
    assert sorted(metrics) == ["did_gen_step", "disc_loss", "fake_scores", "gen_loss",
                               "gp_term", "norm_term", "real_scores", "std", "wgan_loss"]


# ---------------------------------------------------------------------------
# Flip augmentation (tests/test_flip_augment.py)
# ---------------------------------------------------------------------------


class TestRandomHflip:
    def test_flips_are_exact_mirrors(self):
        x = torch.rand(16, 3, 5, 7, generator=torch.Generator().manual_seed(0))
        out = random_hflip(x, torch.Generator().manual_seed(1))
        kinds = []
        for a, b in zip(out, x):
            if torch.equal(a, b):
                kinds.append(0)
            else:
                assert torch.equal(a, b.flip(2))
                kinds.append(1)
        assert 0 < sum(kinds) < 16

    def test_roughly_half_flip(self):
        x = torch.arange(2.0).reshape(1, 1, 1, 2).expand(4096, 1, 1, 2)
        out = random_hflip(x, torch.Generator().manual_seed(2))
        rate = float((out[:, 0, 0, 0] == 1.0).float().mean())
        assert 0.45 < rate < 0.55

    def test_deterministic_per_seed(self):
        x = torch.rand(32, 1, 2, 3)
        a, b, c = (random_hflip(x, torch.Generator().manual_seed(s)) for s in (5, 5, 6))
        assert torch.equal(a, b) and not torch.equal(a, c)


def _fakes_of_first_step(flip: bool):
    gan = torch_gan()
    hp = port_hparams(flip_augment=flip)
    state = create_train_state(gan, hp, device="cpu")
    with torch.no_grad():
        init = {k: v.clone() for k, v in gan.generator.state_dict().items()}
    _, fakes = make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]), SIGMA)
    rng = torch.Generator().manual_seed(step_seed(0, 0))
    if flip:
        torch.rand((B,), generator=rng)  # the mask comes first
    z_d = torch.rand((B, LATENT), generator=rng)
    gan.generator.load_state_dict(init)
    with torch.no_grad():
        want = gan.generate(z_d, train=False)
    return fakes, want


@pytest.mark.parametrize("flip", [False, True])
def test_flip_draws_before_z_d_and_only_when_on(flip):
    # Without the flip the step's first draw is z_d, as before the variant
    # existed: the default stream, and a resume's, is unchanged.
    fakes, want = _fakes_of_first_step(flip)
    assert torch.equal(fakes, want)


def test_flip_mask_is_the_mirror_of_the_input():
    # A step that flips every real equals a step on the mirrored batch that
    # flips none, to the bit.
    reals = reals_batches(1)[0]
    out = []
    for batch, flip in ((reals, True), (reals[:, :, ::-1].copy(), False)):
        gan = torch_gan()
        hp = port_hparams(flip_augment=True)
        state = create_train_state(gan, hp, device="cpu")
        m, _ = make_train_step(gan, hp)(state, torch.from_numpy(batch), SIGMA,
                                        noise={"flip": torch.full((B,), flip)})
        out.append((m, [p.detach().clone() for p in gan.discriminator.parameters()]))
    (ma, pa), (mb, pb) = out
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    assert all(torch.equal(a, b) for a, b in zip(pa, pb))


# ---------------------------------------------------------------------------
# fit against the chunked mode, logs
# ---------------------------------------------------------------------------


def mk_trainer(tmp_path, subdir, **hp_kw):
    cfg = TrainerConfig(log_dir=str(tmp_path / subdir), log_metrics_every_n_examples=8,
                        checkpoint_every_n_examples=1_000_000,
                        sample_grid_every_n_examples=1_000_000,
                        image_summaries_interval_batches=0, save_sample_pngs=False, seed=0)
    hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8, **hp_kw)
    return Trainer(micro_gan(), hp, synthetic_dataset((16, 16, 1), num_examples=64),
                   device="cpu", trainer_config=cfg,
                   blur_controller=BlurDecayController(640, max_value=1.0))


@pytest.mark.parametrize("kw", [dict(gp_every_n_steps=2), dict(d_steps_per_g_step=2),
                                dict(gp_every_n_steps=2, d_steps_per_g_step=3,
                                     flip_augment=True)],
                         ids=["lazy_gp", "d_steps", "lazy_gp_d_steps_flip"])
def test_chunked_matches_fit(tmp_path, kw):
    a = mk_trainer(tmp_path, "host", **kw)
    a.fit(total_examples=10_000, max_steps=6)
    b = mk_trainer(tmp_path, "chunked", **kw)
    b.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=2)
    assert a.state.n_batches == b.state.n_batches == 6
    assert_states_close(a.state, b.state, **PARAM_TOL)
    for ha, hb in zip(a.history, b.history):
        for k in ("disc_loss", "gen_loss", "gp_term", "did_gen_step", "std"):
            assert hb[k] == pytest.approx(ha[k], rel=1e-4, abs=1e-5), k
    assert b.chunk_runner.phases == reachable_phases(b.hparams)
    a.close()
    b.close()


def test_logged_gen_loss_is_carried_over_skipped_steps(tmp_path):
    tr = mk_trainer(tmp_path, "fill", d_steps_per_g_step=2)
    tr.fit(total_examples=10_000, max_steps=4)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=4, max_chunks=1)
    tr.close()
    hist = list(tr.history)
    assert [h["did_gen_step"] for h in hist] == [1.0, 0.0] * 4
    for prev, cur in zip(hist[::2], hist[1::2]):
        assert cur["gen_loss"] == prev["gen_loss"] != 0.0
    with open(os.path.join(tr.cfg.log_dir, "events.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "batch_disc_loss" in r]
    assert [r["batch_did_gen_step"] for r in rows] == [1.0, 0.0] * 4
    assert [r["batch_gen_loss"] for r in rows] == [h["gen_loss"] for h in hist]


def test_entry_point_prints_the_heavy_blur_advisory(tmp_path, capsys):
    from blurred_gan_tpu_torch.train_celeba import build_trainer, parse_args

    def build(*flags):
        tr, _ = build_trainer(parse_args(
            ["--resolution", "8", "--num_examples", "64", "--device", "cpu", "--log_dir",
             str(tmp_path / "_".join(("run",) + flags)), *flags]), feeders=[])
        tr.close()
        return capsys.readouterr().out

    assert "max_blur_std 5 >= 1 with the 'transpose' upsampler" in build()
    assert "upsampler" not in build("--gen_upsample", "resize")
    assert "upsampler" not in build("--max_blur_std", "0.5")
