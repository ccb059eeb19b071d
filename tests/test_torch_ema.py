"""The generator's EMA in the port (``ema_decay``): the mirror of
tests/test_ema.py. Three steps against the JAX step at ``PARAM_TOL`` (rtol
5e-4 / atol 5e-5) through ``torch_variant_harness``; the recursion against a
host replay and its freeze on skipped generator steps; sampling with the
average and the live BatchNorm statistics; the checkpoint round trip and both
migrations; the trainer's choice of sampler; ``export_weights``; and the
chunked mode against ``fit`` on the CPU.
"""

import copy
import json
import os

import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.fast import state_tensors
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import make_sample_fn, make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_fast import micro_gan
from torch_variant_harness import (
    PARAM_TOL, SIGMA, assert_params_close, jax_run, named, port_run, reals_batches, torch_gan)
from torch_variant_harness import hparams as port_hparams

DECAY = 0.9  # aggressive, so that a few steps move the average measurably


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


def test_three_steps_match_jax():
    states, jmetrics, _ = jax_run(3, ema_decay=DECAY)
    assert states[-1].g_ema  # the JAX state keeps an average
    gan, state, metrics, _ = port_run(3, ema_decay=DECAY)
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"step {i}: {k}", **PARAM_TOL)
    ema = copy.deepcopy(gan.generator)
    with torch.no_grad():
        for p, e in zip(ema.parameters(), state.g_ema):
            p.copy_(e)
    assert_params_close(ema, states[-1].g_ema)
    # The average is not the weights.
    assert any(not torch.equal(p, e) for p, e in zip(gan.generator.parameters(), state.g_ema))


def test_carried_from_a_jax_state():
    # convert.flax_state_to_torch carries a JAX state's average.
    states, _, _ = jax_run(3, ema_decay=DECAY)
    gan, state, _, _ = port_run(0, first=3, total=3, ema_decay=DECAY)
    ema = copy.deepcopy(gan.generator)
    with torch.no_grad():
        for p, e in zip(ema.parameters(), state.g_ema):
            p.copy_(e)
    assert_params_close(ema, states[-1].g_ema, rtol=0, atol=0)


def _run(n_steps, **kw):
    gan = torch_gan()
    hp = port_hparams(**kw)
    state = create_train_state(gan, hp, device="cpu")
    step = make_train_step(gan, hp)
    trajectory = []
    for reals in reals_batches(n_steps):
        metrics, _ = step(state, torch.from_numpy(reals), SIGMA)
        trajectory.append(([p.detach().clone() for p in gan.generator.parameters()],
                           [e.clone() for e in state.g_ema or ()],
                           bool(metrics["did_gen_step"])))
    return gan, state, trajectory


class TestEMAStep:
    def test_disabled_by_default_no_extra_state(self):
        gan, state, _ = _run(1)
        assert state.g_ema is None
        n_params = sum(1 for _ in gan.generator.parameters())
        _, with_ema, _ = _run(1, ema_decay=DECAY)
        assert len(state_tensors(with_ema)) == len(state_tensors(state)) + n_params

    def test_starts_at_the_initial_weights(self):
        gan = torch_gan()
        state = create_train_state(gan, port_hparams(ema_decay=DECAY), device="cpu")
        for p, e in zip(gan.generator.parameters(), state.g_ema):
            assert torch.equal(p, e) and p.data_ptr() != e.data_ptr()

    def test_matches_host_replay(self):
        gan = torch_gan()
        init = [p.detach().clone() for p in create_train_state(
            gan, port_hparams(ema_decay=DECAY), device="cpu").generator.parameters()]
        _, _, trajectory = _run(4, ema_decay=DECAY)
        ema = init
        for params, got, _ in trajectory:
            ema = [e * DECAY + p * (1.0 - DECAY) for e, p in zip(ema, params)]
            for a, b in zip(got, ema):
                assert torch.equal(a, b)

    def test_frozen_on_skipped_generator_steps(self):
        _, _, trajectory = _run(4, ema_decay=DECAY, d_steps_per_g_step=2)
        assert [t[2] for t in trajectory] == [True, False, True, False]
        for before, after in zip(trajectory, trajectory[1:]):
            same = all(torch.equal(a, b) for a, b in zip(before[1], after[1]))
            assert same == (not after[2])

    def test_sample_fn_uses_ema_weights_and_live_statistics(self):
        gan, state, _ = _run(3, ema_decay=DECAY)
        z = torch.rand(4, gan.latent_size, generator=torch.Generator().manual_seed(0))
        got = make_sample_fn(gan, use_ema=True)(state, z)
        ema = copy.deepcopy(gan.generator)
        with torch.no_grad():
            for p, e in zip(ema.parameters(), state.g_ema):
                p.copy_(e)
        ema.eval()
        with torch.no_grad():
            want = ema(z)
        assert torch.equal(got, want)
        live = make_sample_fn(gan)(state, z)
        assert (got - live).abs().max() > 0
        assert not gan.generator.training
        # The statistics are the live ones: the module's own buffers were used.
        for a, b in zip(gan.generator.buffers(), ema.buffers()):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _saved(tmp_path, **kw):
    _, state, _ = _run(2, **kw)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep_time_interval_hours=None)
    ckpt.save(8, state)
    return ckpt, state


class TestEMACheckpoint:
    def test_round_trip(self, tmp_path):
        ckpt, saved = _saved(tmp_path, ema_decay=DECAY)
        fresh = create_train_state(torch_gan(), port_hparams(ema_decay=DECAY), device="cpu")
        ptrs = [e.data_ptr() for e in fresh.g_ema]
        ckpt.restore_latest(fresh)
        assert [e.data_ptr() for e in fresh.g_ema] == ptrs  # in place, for the graphs
        for a, b in zip(fresh.g_ema, saved.g_ema):
            assert torch.equal(a, b)

    def test_emaless_checkpoint_seeds_the_average(self, tmp_path, capsys):
        ckpt, saved = _saved(tmp_path)
        assert "g_ema" not in torch.load(ckpt._path(8), weights_only=True)
        fresh = create_train_state(torch_gan(), port_hparams(ema_decay=DECAY), device="cpu")
        ckpt.restore_latest(fresh)
        assert "seeded g_ema" in capsys.readouterr().out
        for a, p, q in zip(fresh.g_ema, fresh.generator.parameters(),
                           saved.generator.parameters()):
            assert torch.equal(a, p) and torch.equal(a, q)

    def test_ema_checkpoint_restores_into_an_emaless_state(self, tmp_path):
        ckpt, saved = _saved(tmp_path, ema_decay=DECAY)
        fresh = create_train_state(torch_gan(), port_hparams(), device="cpu")
        ckpt.restore_latest(fresh)
        assert fresh.g_ema is not None
        for a, b in zip(fresh.g_ema, saved.g_ema):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def mk_trainer(tmp_path, subdir, **hp_kw):
    cfg = TrainerConfig(log_dir=str(tmp_path / subdir), checkpoint_every_n_examples=0,
                        sample_grid_every_n_examples=0, image_summaries_interval_batches=0,
                        save_sample_pngs=False, seed=0)
    hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8, **hp_kw)
    return Trainer(micro_gan(), hp, synthetic_dataset((16, 16, 1), num_examples=64),
                   device="cpu", trainer_config=cfg,
                   blur_controller=BlurDecayController(640, max_value=1.0))


class TestEMATrainer:
    def test_chunked_matches_fit_and_samples_with_ema(self, tmp_path):
        a = mk_trainer(tmp_path, "host", ema_decay=DECAY, d_steps_per_g_step=2)
        assert a._use_ema
        a.fit(total_examples=10_000, max_steps=6)
        b = mk_trainer(tmp_path, "chunked", ema_decay=DECAY, d_steps_per_g_step=2)
        b.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=2)
        for x, y in zip(a.state.g_ema, b.state.g_ema):
            np.testing.assert_allclose(x.numpy(), y.numpy(), **PARAM_TOL)
        z = a.grid_latents
        assert torch.equal(a.sample_fn(a.state, z), make_sample_fn(a.gan, True)(a.state, z))
        with open(os.path.join(a.cfg.log_dir, "run_manifest.json")) as f:
            assert json.load(f)["ema"] is True
        a.close()
        b.close()

    def test_restore_trusts_the_state_over_the_hparams(self, tmp_path):
        tr = mk_trainer(tmp_path, "run", ema_decay=DECAY)
        tr.fit(total_examples=10_000, max_steps=2)
        tr.close()
        # A trainer built with ema_decay 0 (say, without the sidecar) on the
        # same run directory samples the restored average.
        again = mk_trainer(tmp_path, "run")
        assert again._use_ema and again.state.g_ema is not None
        z = again.grid_latents
        got = again.sample_fn(again.state, z)
        assert torch.equal(got, make_sample_fn(again.gan, True)(again.state, z))
        assert (got - make_sample_fn(again.gan)(again.state, z)).abs().max() > 0
        again.close()

    def test_sample_with_ema_false_samples_the_live_weights(self, tmp_path):
        tr = mk_trainer(tmp_path, "live", ema_decay=DECAY)
        tr.cfg.sample_with_ema = False
        tr2 = Trainer(micro_gan(), tr.hparams, tr.dataset, device="cpu",
                      trainer_config=tr.cfg)
        assert not tr2._use_ema and tr2.state.g_ema is not None
        tr.close()
        tr2.close()

    def test_export_writes_the_average(self, tmp_path):
        tr = mk_trainer(tmp_path, "export", ema_decay=DECAY)
        tr.fit(total_examples=10_000, max_steps=2)
        tr.export_weights(str(tmp_path / "weights"))
        ema = torch.load(str(tmp_path / "weights" / "generator_ema.pt"), weights_only=True)
        live = torch.load(str(tmp_path / "weights" / "generator.pt"), weights_only=True)
        assert ema.keys() == live.keys()
        averaged = named(tr.state.generator, tr.state.g_ema)
        for k, v in ema.items():
            assert torch.equal(v, averaged[k] if k in averaged else live[k]), k
        tr.close()
        plain = mk_trainer(tmp_path, "export_plain")
        plain.export_weights(str(tmp_path / "plain"))
        assert sorted(os.listdir(tmp_path / "plain")) == ["discriminator.pt", "generator.pt"]
        plain.close()
