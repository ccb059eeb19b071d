"""The port's host loop and run plumbing on the CPU: the mirror of
tests/test_train_loop.py on the port's micro GAN (16², 1 channel, batch 8).

Short ``Trainer.fit`` runs check the counters, σ, the run directory
(``events.jsonl`` with step = images seen, sidecars, manifest, checkpoints,
sample-grid PNGs), resume (bit-exact on the CPU), the adaptive controller
through a checkpoint, the metric feeders and ``evaluate``. The numpy-only
pieces the port copies (``EveryNExamples``, ``AdaptiveBlurController``,
``samples_grid``) are held against the JAX modules themselves: the same fire
sequences, equal states, byte-equal grids.

TensorBoard's writer is off here (``_summary_writer`` returns None): where
TensorFlow is installed, ``torch.utils.tensorboard`` imports it. The sink is
checked with a recording stand-in.
"""

import argparse
import glob
import json
import os
import signal
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from blurred_gan_tpu.sched.blur import AdaptiveBlurController as JaxAdaptive
from blurred_gan_tpu.train.hooks import EveryNExamples as JaxEveryNExamples
from blurred_gan_tpu.utils.images import normalize_images as jax_normalize
from blurred_gan_tpu.utils.images import samples_grid as jax_samples_grid
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.sched.blur import AdaptiveBlurController, BlurDecayController
from blurred_gan_tpu_torch.train import checkpoint as ckpt_mod
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters, TrainingConfig
from blurred_gan_tpu_torch.train.hooks import EveryNExamples
from blurred_gan_tpu_torch.train.loop import MetricFeeder, Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN
from blurred_gan_tpu_torch.train.step import make_sample_fn
from blurred_gan_tpu_torch.utils import logging as logging_mod
from blurred_gan_tpu_torch.utils import watchdog
from blurred_gan_tpu_torch.utils.images import normalize_images, samples_grid
from blurred_gan_tpu_torch.utils.rundir import create_result_subdir, load_run_manifest
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


def micro_gan():
    g = DCGANGenerator(latent_size=16, init_hw=(4, 4), init_features=32,
                       blocks=((32, 2), (16, 2)), out_channels=1,
                       final_transpose=False, final_stride=1)
    d = DCGANDiscriminator(channels=(16, 32), in_channels=1, image_hw=(16, 16))
    return GAN(g, d, latent_size=16, blurred=True)


def micro_hparams():
    return BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8, learning_rate=1e-3)


def make_trainer(tmp_path, subdir="run", **kw):
    ds = synthetic_dataset((16, 16, 1), num_examples=64)
    cfg = TrainerConfig(
        log_dir=str(tmp_path / subdir),
        log_metrics_every_n_examples=16,
        sample_grid_every_n_examples=kw.pop("grid_every", 100_000),
        checkpoint_every_n_examples=kw.pop("ckpt_every", 64),
        save_sample_pngs=kw.pop("save_pngs", False),
        seed=0)
    hp = micro_hparams()
    return Trainer(micro_gan(), hp, ds, device="cpu", trainer_config=cfg,
                   blur_controller=kw.pop("blur_controller",
                                          BlurDecayController(640, max_value=1.0)),
                   config_sidecars={"hparams": hp,
                                    "config": TrainingConfig(log_dir=cfg.log_dir)},
                   **kw)


def read_events(trainer):
    with open(os.path.join(trainer.cfg.log_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def full_state(trainer):
    """Every tensor and counter a resume must reproduce."""
    s = trainer.state
    out = {f"g.{k}": v for k, v in s.generator.state_dict().items()}
    out.update({f"d.{k}": v for k, v in s.discriminator.state_dict().items()})
    for name, opt in (("g_opt", s.g_opt), ("d_opt", s.d_opt)):
        for i, slots in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in slots.items()})
    out["n_img"], out["n_batches"] = s.n_img, s.n_batches
    return out


def assert_states_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One short run shared by the cheap assertions below."""
    tmp_path = tmp_path_factory.mktemp("trainer")
    tr = make_trainer(tmp_path)
    state = tr.fit(total_examples=10_000, max_steps=12)
    yield tr, state, tmp_path
    tr.close()


class TestTrainingRun:
    def test_counters_advance(self, trained):
        tr, state, _ = trained
        assert state is tr.state
        assert state.n_batches == 12 and state.n_img == 96

    def test_losses_finite_and_logged(self, trained):
        tr, _, _ = trained
        logs = tr._last_metrics
        assert np.isfinite(logs["disc_loss"]) and np.isfinite(logs["gp_term"])
        assert logs["std"] <= 1.0

    def test_sigma_follows_schedule(self, trained):
        tr, _, _ = trained
        assert tr._last_metrics["std"] == pytest.approx(1.0 * 0.96 ** (11 / 64.0), rel=1e-4)
        for n, logs in enumerate(tr.history):
            assert logs["std"] == pytest.approx(tr.blur_controller.sigma(n), rel=1e-6)

    def test_history_per_step(self, trained):
        tr, _, _ = trained
        assert [h["n_batches"] for h in tr.history] == list(range(1, 13))
        assert [h["n_img"] for h in tr.history] == [8 * n for n in range(1, 13)]
        assert all(h["images_per_sec"] > 0 for h in tr.history)

    def test_events_step_is_images_seen(self, trained):
        tr, _, _ = trained
        steps = [r["step"] for r in read_events(tr) if "batch_disc_loss" in r]
        # The log hook fires every 16 examples, the first batch included.
        assert steps == [8, 16, 32, 48, 64, 80, 96]

    def test_checkpoint_written(self, trained):
        tr, _, _ = trained
        assert tr.ckpt.latest_step() == 96
        assert os.path.dirname(tr.ckpt.directory) == os.path.abspath(tr.cfg.log_dir)

    def test_run_manifest_written(self, trained):
        tr, _, _ = trained
        manifest = load_run_manifest(tr.cfg.log_dir)
        assert manifest["image_shape"] == list(tr.dataset.image_shape)
        assert manifest["dataset"] == tr.dataset.name
        assert manifest["latent_size"] == tr.gan.latent_size
        assert manifest["num_examples"] == 64 and manifest["ema"] is False

    def test_sidecars_written(self, trained):
        tr, _, _ = trained
        hp = ckpt_mod.load_sidecar(tr.cfg.log_dir, BlurredWGANGPHyperParameters,
                                   "hyper_parameters.json")
        assert hp == tr.hparams
        cfg = ckpt_mod.load_sidecar(tr.cfg.log_dir, TrainingConfig, "train_config.json")
        assert cfg.log_dir == tr.cfg.log_dir
        assert ckpt_mod.load_sidecar(tr.cfg.log_dir, TrainingConfig, "absent.json") is None
        assert read_events(tr)[0]["hparams"]["batch_size"] == 8

    def test_epoch_scalars_written(self, trained):
        # 64 examples at bs 8: an epoch boundary at step 8 of the 12.
        tr, _, _ = trained
        epoch_recs = [r for r in read_events(tr) if "epoch_disc_loss" in r]
        assert [r["step"] for r in epoch_recs] == [64]
        assert epoch_recs[0]["epoch_epoch"] == 1.0

    def test_image_summaries_include_blur_pairs(self, trained):
        tr, _, _ = trained
        tags = []
        orig = tr.logger.image
        tr.logger.image = lambda step, tag, img: tags.append((tag, img.shape))
        try:
            x = torch.zeros((4, 1, 16, 16))
            tr._image_summaries(x, x.clone(), 1.0)
        finally:
            tr.logger.image = orig
        assert {t for t, _ in tags} == {"train/reals", "train/reals_blurred",
                                        "train/fakes", "train/fakes_blurred"}
        assert all(shape == (4 * 18 + 2, 18 + 2, 3) for _, shape in tags)

    def test_export_weights(self, trained, tmp_path):
        tr, state, _ = trained
        tr.export_weights(str(tmp_path / "w"))
        g = torch.load(tmp_path / "w" / "generator.pt", weights_only=True)
        for k, v in state.generator.state_dict().items():
            assert torch.equal(g[k], v), k
        assert (tmp_path / "w" / "discriminator.pt").exists()

    def test_evaluate(self, trained):
        tr, _, _ = trained
        out = tr.evaluate(num_samples=16, metrics=[SWDMetric(nhoods_per_image=16)])
        assert set(out) == {"SWDx1e3_16", "SWDx1e3_avg"} and np.isfinite(out["SWDx1e3_avg"])
        assert "eval_SWDx1e3_avg" in read_events(tr)[-1]


def test_second_fit_continues(tmp_path):
    tr = make_trainer(tmp_path)
    tr.fit(total_examples=10_000, max_steps=3)
    tr.fit(total_examples=10_000, max_steps=2)
    assert [h["n_batches"] for h in tr.history] == [1, 2, 3, 4, 5]
    assert tr.history[3]["std"] == pytest.approx(tr.blur_controller.sigma(3), rel=1e-6)
    tr.close()


class TestCheckpointResume:
    def test_resume_bit_exact(self, tmp_path):
        tr_a = make_trainer(tmp_path, subdir="a", ckpt_every=100_000)
        tr_a.fit(total_examples=10_000, max_steps=8)
        tr_a.close()

        tr_b1 = make_trainer(tmp_path, subdir="b", ckpt_every=100_000)
        tr_b1.fit(total_examples=10_000, max_steps=4)
        tr_b1.close()
        tr_b2 = make_trainer(tmp_path, subdir="b", ckpt_every=100_000)
        assert tr_b2.state.n_batches == 4 and tr_b2.restored_examples == 32
        tr_b2.fit(total_examples=10_000, max_steps=4)
        tr_b2.close()

        a, b = full_state(tr_a), full_state(tr_b2)
        assert a["n_batches"] == 8 and a["n_img"] == 64
        assert any(k.startswith("g.bns.0.running_var") for k in a)
        assert any(k.endswith("exp_avg_sq") for k in a)
        assert_states_equal(a, b)

    def test_restore_is_exact(self, tmp_path):
        tr = make_trainer(tmp_path, subdir="r", ckpt_every=100_000)
        tr.fit(total_examples=10_000, max_steps=3)
        saved = full_state(tr)
        tr.close()
        again = make_trainer(tmp_path, subdir="r")
        assert_states_equal(saved, full_state(again))
        again.close()

    def test_adaptive_state_checkpoints(self, tmp_path):
        ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                     max_value=1.0)
        tr = make_trainer(tmp_path, subdir="ada", blur_controller=None,
                          adaptive_controller=ada, ckpt_every=32)
        tr.fit(total_examples=10_000, max_steps=6)
        saved = tr.ada_state
        tr.close()
        assert saved.std < 1.0  # decayed at least once
        tr2 = make_trainer(tmp_path, subdir="ada", blur_controller=None,
                           adaptive_controller=ada, ckpt_every=32)
        assert tr2.ada_state == saved
        tr2.close()

    def test_adaptive_sigma_is_in_step(self, tmp_path):
        """With the adaptive controller each step's σ follows from the scores
        of the step before it."""
        ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                     max_value=1.0)
        tr = make_trainer(tmp_path, subdir="step", blur_controller=None,
                          adaptive_controller=ada)
        tr.fit(total_examples=10_000, max_steps=5)
        state = ada.init()
        for logs in tr.history:
            assert logs["std"] == pytest.approx(state.std, rel=1e-6)
            state, _ = ada.update(state, logs["n_batches"], logs["fake_scores"],
                                  logs["real_scores"])
        assert tr.ada_state == state
        tr.close()


class TestCheckpointManager:
    def save_steps(self, directory, steps, **kw):
        tr_state = make_trainer(directory, subdir="src").state
        ckpt = ckpt_mod.CheckpointManager(str(directory / "ck"), **kw)
        for step in steps:
            ckpt.save(step, tr_state)
        return ckpt, tr_state

    def test_max_to_keep(self, tmp_path):
        ckpt, state = self.save_steps(tmp_path, range(100, 800, 100), max_to_keep=3,
                                      keep_time_interval_hours=None)
        assert ckpt.all_steps() == [500, 600, 700]
        assert ckpt.restore_latest(state) == ({}, 700)
        assert not glob.glob(str(tmp_path / "ck" / "*.tmp"))

    def test_hourly_keeper(self, tmp_path):
        ckpt, state = self.save_steps(tmp_path, [100, 200], max_to_keep=1,
                                      keep_time_interval_hours=1.0)
        assert ckpt.all_steps() == [100, 200]  # the first is the interval keeper
        hour = 3600.0
        now = time.time()
        os.utime(ckpt._path(100), (now - 3 * hour, now - 3 * hour))
        os.utime(ckpt._path(200), (now - 2.5 * hour, now - 2.5 * hour))
        ckpt.save(300, state)
        # 200 came half an hour after the keeper 100: not kept.
        assert ckpt.all_steps() == [100, 300]
        os.utime(ckpt._path(300), (now - hour, now - hour))
        ckpt.save(400, state)
        # 300 came two hours after the keeper 100: a keeper too.
        assert ckpt.all_steps() == [100, 300, 400]

    def test_weights_only_layout(self, tmp_path):
        ckpt, state = self.save_steps(tmp_path, [8], keep_time_interval_hours=None)
        payload = torch.load(ckpt._path(8), weights_only=True)
        assert set(payload) == {"generator", "discriminator", "g_opt", "d_opt", "n_img",
                                "n_batches", "aux"}
        assert json.loads(payload["aux"]) == {}
        assert ckpt_mod.CheckpointManager(str(tmp_path / "empty")).restore_latest(state) is None


def test_save_on_interrupt_defers_to_check():
    saved = []
    with pytest.raises(KeyboardInterrupt):
        with ckpt_mod.save_on_interrupt(lambda: saved.append(1), defer=True) as check:
            os.kill(os.getpid(), signal.SIGINT)
            time.sleep(0.05)
            assert saved == []  # recorded, not acted on
            check()
    assert saved == [1]
    assert signal.getsignal(signal.SIGINT) is signal.default_int_handler


class TestSampleGridAndFeeders:
    def test_sample_grid_png(self, tmp_path):
        tr = make_trainer(tmp_path, subdir="grid", save_pngs=True, grid_every=32)
        tr.fit(total_examples=10_000, max_steps=5)
        pngs = sorted(glob.glob(os.path.join(tr.cfg.log_dir, "samples_grid_*.png")))
        tr.close()
        assert [os.path.basename(p) for p in pngs] == [
            "samples_grid_00000008.png", "samples_grid_00000032.png"]
        img = np.asarray(Image.open(pngs[-1]))
        assert img.shape == (8 * 18 + 2, 8 * 18 + 2, 3) and img.dtype == np.uint8
        # The hook of step 4 runs once step 5 is dispatched, so the last grid
        # shows the fixed latents through the final state.
        samples = tr.sample_fn(tr.state, tr.grid_latents).permute(0, 2, 3, 1).numpy()
        assert np.array_equal(img, samples_grid(normalize_images(samples)))
        assert tr.grid_latents.shape == (64, 16)

    def test_swd_feeder_fires(self, tmp_path):
        feeder = MetricFeeder(SWDMetric(nhoods_per_image=16), every_n_examples=64,
                              num_samples=16, name="swd")
        tr = make_trainer(tmp_path, subdir="swd", metric_feeders=[feeder], ckpt_every=0)
        tr.fit(total_examples=10_000, max_steps=10)
        recs = [r for r in read_events(tr) if "swd/SWDx1e3_16" in r]
        tr.close()
        # Pre-armed 16 examples early, it fires on the first batch and at 48
        # examples, and records two batches each time.
        assert [r["step"] for r in recs] == [16, 56]
        assert all(np.isfinite(r["swd/SWDx1e3_avg"]) for r in recs)

    def test_fid_feeder_fires(self, tmp_path):
        feeder = MetricFeeder(FIDMetric(feature_dim=8), every_n_examples=1_000,
                              num_samples=24, name="fid")
        tr = make_trainer(tmp_path, subdir="fid", metric_feeders=[feeder], ckpt_every=0)
        tr.fit(total_examples=10_000, max_steps=4)
        recs = [r for r in read_events(tr) if "fid" in r]
        tr.close()
        assert [r["step"] for r in recs] == [24] and np.isfinite(recs[0]["fid"])
        assert not feeder.recording and feeder.metric._real.n == 0


# ---------------------------------------------------------------------------
# The numpy-only copies against the JAX modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,starting_from,batches,restore_at", [
    (16, 0, [8] * 12, None), (50, -20, [8, 8, 3, 8, 8, 8, 8, 1, 8] * 3, None),
    (64, 0, [8] * 20, 40), (0, 0, [8] * 4, None)])
def test_every_n_examples_matches_jax(n, starting_from, batches, restore_at):
    fired = {"port": [], "jax": []}
    hooks = {"port": EveryNExamples(n, lambda s, l: fired["port"].append(s), starting_from),
             "jax": JaxEveryNExamples(n, lambda s, l: fired["jax"].append(s), starting_from)}
    for h in hooks.values():
        if restore_at is not None:
            h.restore(restore_at)
        for b in batches:
            h.after_step(b, {})
    assert fired["port"] == fired["jax"]
    assert hooks["port"].num_invocations == hooks["jax"].num_invocations


@pytest.mark.parametrize("kw", [dict(warmup_n_batches=20, delay_between_modifications=10,
                                     max_value=2.0, threshold=0.1),
                                dict(warmup_n_batches=0, delay_between_modifications=1,
                                     max_value=0.05, smoothing=0.9, apply_changes=True),
                                dict(apply_changes=False, warmup_n_batches=5)])
def test_adaptive_controller_matches_jax(kw):
    rs = np.random.RandomState(0)
    fake = rs.normal(1.0, 0.3, 300)
    real = fake + rs.normal(0.0, 0.2, 300)
    port, ref = AdaptiveBlurController(**kw), JaxAdaptive(**kw)
    s, js = port.init(), ref.init()
    for batch in range(300):
        s, tele = port.update(s, batch, fake[batch], real[batch])
        js, jtele = ref.update(js, batch, fake[batch], real[batch])
        assert port.state_to_dict(s) == ref.state_to_dict(js)
        assert tele == jtele
    assert port.state_from_dict(port.state_to_dict(s)) == s


@pytest.mark.parametrize("shape,grid", [((64, 16, 16, 1), (8, 8)), ((10, 8, 12, 3), (8, 8)),
                                        ((16, 6, 6, 3), (4, 4)), ((70, 4, 4, 1), (8, 8))])
def test_samples_grid_byte_equal_to_jax(shape, grid):
    x = np.random.RandomState(1).uniform(-1.2, 1.2, shape).astype(np.float32)
    got = samples_grid(normalize_images(x), grid)
    want = jax_samples_grid(jax_normalize(x), grid)
    assert got.dtype == want.dtype == np.uint8
    assert got.tobytes() == want.tobytes() and got.shape == want.shape


# ---------------------------------------------------------------------------
# Small pieces
# ---------------------------------------------------------------------------


def test_config_flags_round_trip():
    parser = argparse.ArgumentParser()
    BlurredWGANGPHyperParameters.add_arguments(parser)
    TrainingConfig.add_arguments(parser)
    BlurredWGANGPHyperParameters.add_arguments(parser)  # a second claim is ignored
    args = parser.parse_args(["--batch_size", "16", "--flip_augment", "false",
                              "--reference_grad_scale", "yes", "--log_dir", "x",
                              "--initial_blur_std", "0.5"])
    hp = BlurredWGANGPHyperParameters.from_args(args)
    assert (hp.batch_size, hp.reference_grad_scale, hp.flip_augment,
            hp.initial_blur_std) == (16, True, False, 0.5)
    assert TrainingConfig.from_args(args) == TrainingConfig(log_dir="x")


def test_create_result_subdir(tmp_path):
    assert create_result_subdir(str(tmp_path), "celeba").endswith("01-celeba")
    os.makedirs(tmp_path / "07-celeba")
    assert create_result_subdir(str(tmp_path), "celeba").endswith("08-celeba")
    assert load_run_manifest(str(tmp_path)) is None


def test_tensorboard_sink(tmp_path, monkeypatch):
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return lambda *a, **k: calls.append(name)

    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: Recorder())
    logger = logging_mod.MetricsLogger(str(tmp_path))
    logger.scalars(8, {"a": 1.0, "b": "text", "c": np.float32(2)}, prefix="x_")
    logger.image(8, "grid", np.zeros((4, 4, 3), np.uint8))
    logger.hparams({"lr": 0.1})
    logger.close()
    assert calls == ["add_scalar", "add_scalar", "add_image", "add_hparams", "flush", "close"]
    recs = [json.loads(l) for l in open(tmp_path / "events.jsonl")]
    assert recs[0]["step"] == 8 and recs[0]["x_a"] == 1.0 and "x_b" not in recs[0]


def test_watchdog_fetch(monkeypatch):
    x = torch.arange(3.0)
    np.testing.assert_array_equal(watchdog.fetch(x), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(watchdog.fetch(x, 5.0, what="t"), [0.0, 1.0, 2.0])
    monkeypatch.setattr(watchdog, "_materialize", lambda x, ready: time.sleep(2.0))
    with pytest.raises(watchdog.DeviceHangError, match="wedged-op"):
        watchdog.fetch(x, 0.1, what="wedged-op")


def test_sample_fn_is_eval_mode_and_ema_waits():
    # The EMA sampler no longer waits: it needs a state with an average.
    gan = micro_gan()
    z = torch.rand(4, 16)
    out = make_sample_fn(gan)(None, z)
    assert out.shape == (4, 1, 16, 16) and not out.requires_grad
    assert not gan.generator.training
    with pytest.raises(ValueError, match="g_ema"):
        make_sample_fn(gan, use_ema=True)(SimpleNamespace(g_ema=None), z)
