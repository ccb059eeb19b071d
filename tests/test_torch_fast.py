"""The port's device-resident chunked mode (``blurred_gan_tpu_torch/train/fast.py``
and ``Trainer.fit_device_resident``) on the CPU: the mirror of
tests/test_fast.py on the same micro GAN (16², 1 channel, batch 8) and a
64-image synthetic corpus.

The numpy and controller pieces are held against the JAX module itself:
``chunk_indices`` byte-equal, ``adaptive_update`` equal to JAX's and to the
host controller, the closed-form σ equal to ``BlurDecayController.sigma``. The
chunked trainer is held against the port's own ``Trainer.fit`` (itself held
against the JAX step in tests/test_torch_step.py): on the CPU the chunk runs
the same per-step function eagerly, with the same draws. No JAX train step is
built here.
"""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.data import synthetic_dataset as jax_synthetic_dataset
from blurred_gan_tpu.sched.blur import AdaptiveBlurController as JaxAdaptive
from blurred_gan_tpu.train.fast import AdaptiveState as JaxAdaptiveState
from blurred_gan_tpu.train.fast import adaptive_update as jax_adaptive_update
from blurred_gan_tpu.train.fast import chunk_indices as jax_chunk_indices
from blurred_gan_tpu_torch.data.pipeline import ArrayDataset, synthetic_dataset
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.sched.blur import (
    AdaptiveBlurController, AdaptiveBlurState, BlurDecayController)
from blurred_gan_tpu_torch.train.checkpoint import _load_optimizer
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.fast import (
    AdaptiveState, ChunkRunner, adaptive_update, chunk_indices, chunk_plan, decayed_sigma,
    state_tensors)
from blurred_gan_tpu_torch.train.loop import MetricFeeder, Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN, create_train_state, set_capturable
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.utils import logging as logging_mod
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

PARAM_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_fast.py's chunked-vs-host tolerance


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


def hparams():
    return BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8)


def mk_trainer(tmp_path, subdir, **kw):
    cfg = TrainerConfig(log_dir=str(tmp_path / subdir),
                        log_metrics_every_n_examples=16,
                        checkpoint_every_n_examples=kw.pop("ckpt_every", 1_000_000),
                        sample_grid_every_n_examples=1_000_000,
                        image_summaries_interval_batches=0,
                        save_sample_pngs=False, seed=0)
    return Trainer(micro_gan(), hparams(), synthetic_dataset((16, 16, 1), num_examples=64),
                   device="cpu", trainer_config=cfg, **kw)


def decay():
    return BlurDecayController(640, max_value=1.0)


def stopping_controller():
    # min_value just below max: the first decay raises stop_training.
    return AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                  max_value=1.0, min_value=0.995)


def full_state(state):
    out = {f"g.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"d.{k}": v for k, v in state.discriminator.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, slots in opt.state_dict()["state"].items():
            out.update({f"{name}.{i}.{k}": v for k, v in slots.items()})
    return out


def assert_params_close(a, b, **tol):
    for (k, x), y in zip(a.discriminator.state_dict().items(),
                         b.discriminator.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=k, **tol)
    for (k, x), y in zip(a.generator.state_dict().items(), b.generator.state_dict().values()):
        np.testing.assert_allclose(x.numpy(), y.numpy(), err_msg=k, **tol)


# ---------------------------------------------------------------------------
# Pieces against the JAX module
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_examples,batch,steps,start,seed", [
    (64, 8, 10, 0, 5), (64, 8, 4, 6, 5), (100, 16, 13, 11, 0), (40, 40, 3, 2, 9)])
def test_chunk_indices_byte_equal_to_jax(num_examples, batch, steps, start, seed):
    got = chunk_indices(num_examples, batch, steps, start, seed)
    want = jax_chunk_indices(num_examples, batch, steps, start, seed)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_chunk_indices_continue_the_dataset_stream():
    ds = synthetic_dataset((8, 8, 1), num_examples=64, seed=1)
    direct = [b.copy() for _, b in zip(range(10), ds.batches(8, seed=5))]
    idx = chunk_indices(64, 8, 10, start_batch_counter=0, seed=5)
    for i in range(10):
        np.testing.assert_array_equal(ds.images[idx[i]], direct[i])
    # A resume mid-stream continues it.
    np.testing.assert_array_equal(idx[6:], chunk_indices(64, 8, 4, 6, seed=5))
    with pytest.raises(ValueError, match="exceeds"):
        chunk_indices(4, 8, 1, 0, 0)


@pytest.mark.parametrize("kw", [
    dict(warmup_n_batches=3, delay_between_modifications=2, max_value=5.0, threshold=0.05),
    dict(warmup_n_batches=0, delay_between_modifications=1, max_value=1.0, min_value=0.9,
         smoothing=0.9, threshold=0.2),
    dict(warmup_n_batches=5, delay_between_modifications=3, max_value=2.0, threshold=0.3,
         apply_changes=False)])
def test_adaptive_update_matches_jax_and_the_host_controller(kw):
    c, jc = AdaptiveBlurController(**kw), JaxAdaptive(**kw)
    host = c.init()
    dev = AdaptiveState.from_host(c.init(), "cpu")
    jdev = JaxAdaptiveState.init(jc)
    rng = np.random.RandomState(0)
    for b in range(1, 41):
        fake = float(abs(rng.randn()) + 0.5)
        real = float(abs(rng.randn()) + 0.5)
        host, _ = c.update(host, b, fake, real)
        dev = adaptive_update(c, dev, torch.tensor(b), torch.tensor(fake, dtype=torch.float32),
                              torch.tensor(real, dtype=torch.float32))
        jdev = jax_adaptive_update(jc, jdev, jnp.int32(b), jnp.float32(fake), jnp.float32(real))
        for want_std, want_ratio, want_last, want_stop in (
                (host.std, host.score_ratio, host.last_modification_batch, host.stop_training),
                (float(jdev.std), float(jdev.score_ratio), int(jdev.last_modification_batch),
                 bool(jdev.stop_training))):
            assert float(dev.std) == pytest.approx(want_std, rel=1e-5), b
            assert float(dev.score_ratio) == pytest.approx(want_ratio, rel=1e-4), b
            assert int(dev.last_modification_batch) == want_last, b
            assert bool(dev.stop_training) == want_stop, b
    assert dev.to_host().last_modification_batch == host.last_modification_batch


def test_adaptive_state_round_trips_the_host_state():
    s = AdaptiveBlurState(std=0.75, score_ratio=0.375, last_modification_batch=12,
                          stop_training=True)
    dev = AdaptiveState.from_host(s, "cpu")
    assert (dev.std.dtype, dev.last_modification_batch.dtype, dev.stop_training.dtype) == (
        torch.float32, torch.int64, torch.bool)
    assert dev.to_host() == s


@pytest.mark.parametrize("total,max_value,ns", [
    (2_025_990, 5.0, [0, 1, 1000, 63_312]),   # CelebA-128, 10 epochs at batch 32
    (600_000, 23.5, [0, 7, 18_750]),           # MNIST, 10 epochs
    (640, 1.0, [0, 5, 99]),                    # the micro run
    (1000, 5.0, [20_000, 10 ** 6])])           # clipped at min_value
def test_closed_form_sigma_equals_the_controller(total, max_value, ns):
    # Exactly the float32 σ that Trainer.fit feeds from the host controller.
    c = BlurDecayController(total_n_training_examples=total, max_value=max_value)
    got = decayed_sigma(c, torch.tensor(ns, dtype=torch.int64))
    assert got.dtype == torch.float32
    for n, g in zip(ns, got.tolist()):
        assert g == pytest.approx(c.sigma(n), rel=1e-6), n
        assert g == float(np.float32(c.sigma(n))), n


@pytest.mark.parametrize("chunk,max_steps,want", [
    (100, None, (100, None, False)), (100, 50, (50, 1, False)), (100, 150, (100, 2, True)),
    (6, 12, (6, 2, False)), (2, 1, (1, 1, False)), (4, 9, (4, 3, True))])
def test_chunk_plan_rounds_up_to_whole_chunks(chunk, max_steps, want):
    assert chunk_plan(chunk, max_steps) == want


# ---------------------------------------------------------------------------
# The chunked trainer against the host loop
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_and_chunked(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("fast")
    a = mk_trainer(tmp_path, "host", blur_controller=decay())
    a.fit(total_examples=10_000, max_steps=6)
    a.close()
    b = mk_trainer(tmp_path, "chunked", blur_controller=decay())
    b.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=2)
    b.close()
    return a, b


class TestChunkedFit:
    def test_matches_host_loop(self, host_and_chunked):
        a, b = host_and_chunked
        assert a.state.n_batches == b.state.n_batches == 6
        assert a.state.n_img == b.state.n_img == 48
        assert_params_close(a.state, b.state, **PARAM_TOL)

    def test_per_step_logs_match_host_loop(self, host_and_chunked):
        a, b = host_and_chunked
        assert [h["n_batches"] for h in b.history] == list(range(1, 7))
        assert [h["n_img"] for h in b.history] == [8 * n for n in range(1, 7)]
        for ha, hb in zip(a.history, b.history):
            for k in ("disc_loss", "gen_loss", "gp_term", "fake_scores", "real_scores"):
                assert hb[k] == pytest.approx(ha[k], rel=1e-4, abs=1e-5), k
        for n, h in enumerate(b.history):
            assert h["std"] == pytest.approx(b.blur_controller.sigma(n), rel=1e-6)
            assert h["images_per_sec"] > 0

    def test_metrics_buffer_is_key_sorted(self, host_and_chunked):
        _, b = host_and_chunked
        runner = b.chunk_runner
        assert runner.names == sorted(runner.names) and "disc_loss" in runner.names
        assert runner.graph is None  # the CPU runs the step eagerly
        out = runner.out.numpy()
        assert out.shape == (3, len(runner.names))
        for j, k in enumerate(runner.names):
            np.testing.assert_allclose(out[:, j], [h[k] for h in list(b.history)[3:]],
                                       rtol=1e-6)

    def test_hooks_replay_per_step_and_checkpoint_at_the_end(self, host_and_chunked):
        _, b = host_and_chunked
        with open(os.path.join(b.cfg.log_dir, "events.jsonl")) as f:
            steps = [r["step"] for r in map(json.loads, f) if "batch_disc_loss" in r]
        assert steps == [8, 16, 32, 48]  # the host loop's cadence
        assert b.ckpt.latest_step() == 48
        assert os.path.exists(os.path.join(b.cfg.log_dir, "run_manifest.json"))


def test_total_examples_is_quantised_to_chunks(tmp_path):
    tr = mk_trainer(tmp_path, "q", blur_controller=decay())
    tr.fit_device_resident(total_examples=40, chunk_steps=4)
    assert tr.state.n_batches == 8  # two chunks: 32 < 40, then 64
    tr.close()


def test_adaptive_chunked_runs_and_mirrors_state(tmp_path):
    ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                 max_value=1.0)
    tr = mk_trainer(tmp_path, "ada", adaptive_controller=ada)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=4, max_chunks=2)
    assert tr.ada_state is not None
    assert tr.ada_state.std < 1.0  # decayed on the device
    assert tr.ada_state.last_modification_batch > 0
    assert tr.ada_state == tr.chunk_runner.adaptive.to_host()
    # σ of each step is the controller's state before it, as in the host loop.
    host = ada.init()
    for logs in tr.history:
        assert logs["std"] == pytest.approx(host.std, rel=1e-5)
        host, _ = ada.update(host, logs["n_batches"], logs["fake_scores"], logs["real_scores"])
        assert logs["blur_controller/std"] == pytest.approx(host.std, rel=1e-5)
    tr.close()


def test_adaptive_chunked_equals_adaptive_fit(tmp_path):
    ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                 max_value=1.0)
    a = mk_trainer(tmp_path, "ada_host", adaptive_controller=ada)
    a.fit(total_examples=10_000, max_steps=4)
    b = mk_trainer(tmp_path, "ada_chunk", adaptive_controller=ada)
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    assert a.ada_state.last_modification_batch == b.ada_state.last_modification_batch
    assert b.ada_state.std == pytest.approx(a.ada_state.std, rel=1e-5)
    assert_params_close(a.state, b.state, **PARAM_TOL)
    a.close()
    b.close()


class TestChunkedStopFreeze:
    def test_steps_after_stop_are_noops(self, tmp_path):
        tr = mk_trainer(tmp_path, "stop", adaptive_controller=stopping_controller())
        state = tr.fit_device_resident(total_examples=10_000, chunk_steps=6, max_chunks=5)
        tr.close()
        assert tr.ada_state.stop_training
        # The device counter froze at the triggering step and the host
        # counters equal it; the final checkpoint is keyed by that count.
        assert state.n_batches == tr.ada_state.last_modification_batch
        assert state.n_batches <= 2
        assert int(tr.chunk_runner.n_batches) == state.n_batches
        assert tr.samples_seen == 8 * state.n_batches
        assert tr.ckpt.latest_step() == tr.samples_seen
        assert len(tr.history) == state.n_batches

    def test_frozen_state_equals_a_run_that_stopped_there(self, tmp_path):
        a = mk_trainer(tmp_path, "froze", adaptive_controller=stopping_controller())
        a.fit_device_resident(total_examples=10_000, chunk_steps=6, max_chunks=1)
        n = a.state.n_batches
        b = mk_trainer(tmp_path, "stopped_there", adaptive_controller=stopping_controller())
        b.fit(total_examples=10_000, max_steps=n)
        assert b.state.n_batches == n and b.ada_state.stop_training
        assert_params_close(a.state, b.state, **PARAM_TOL)
        a.close()
        b.close()

    def test_a_frozen_step_changes_nothing(self):
        gan, hp = micro_gan(), hparams()
        state = create_train_state(gan, hp, device="cpu", seed=0)
        images = synthetic_dataset((16, 16, 1), num_examples=64).images
        runner = ChunkRunner(gan, hp, state, images, 2, adaptive_controller=stopping_controller(),
                             adaptive_state=AdaptiveBlurState(std=0.5, stop_training=True))
        before = {k: v.clone() for k, v in full_state(state).items()}
        out = runner.run(chunk_indices(64, 8, 2, 0, 0), 0).clone()
        after = full_state(state)
        # Adam's fresh state (created by the frozen steps) is all zeros.
        for k, v in after.items():
            want = before.get(k, torch.zeros_like(v))
            assert torch.equal(v, want), k
        assert torch.equal(out, torch.zeros_like(out))
        assert int(runner.n_batches) == 0 and runner.adaptive.to_host().std == 0.5

    def test_resume_of_stopped_run_stays_stopped(self, tmp_path):
        tr = mk_trainer(tmp_path, "stop2", adaptive_controller=stopping_controller())
        tr.fit_device_resident(total_examples=10_000, chunk_steps=6, max_chunks=5)
        n = tr.state.n_batches
        tr.close()
        tr2 = mk_trainer(tmp_path, "stop2", adaptive_controller=stopping_controller())
        assert tr2._stop  # restored as complete
        tr2.fit_device_resident(total_examples=10_000, chunk_steps=6)
        assert tr2.state.n_batches == n  # no phantom chunks
        tr2.close()


# ---------------------------------------------------------------------------
# Checkpoints interchange between the two modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("first,second", [("fit", "chunked"), ("chunked", "fit")])
def test_checkpoint_resumes_across_modes(tmp_path, first, second, host_and_chunked):
    straight, _ = host_and_chunked  # 6 steps of fit

    def train(tr, mode):
        if mode == "fit":
            tr.fit(total_examples=10_000, max_steps=3)
        else:
            tr.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=1)

    tr = mk_trainer(tmp_path, "x", blur_controller=decay())
    train(tr, first)
    tr.close()
    resumed = mk_trainer(tmp_path, "x", blur_controller=decay())
    assert resumed.restored_examples == 24 and resumed.state.n_batches == 3
    train(resumed, second)
    resumed.close()
    assert resumed.state.n_batches == 6
    assert_params_close(straight.state, resumed.state, **PARAM_TOL)


def test_runner_is_kept_for_the_same_dataset_and_chunk(tmp_path, host_and_chunked):
    # Two calls of one chunk of 3 share a runner and together equal 6 steps
    # of the host loop; a call with another chunk builds a new runner.
    straight, _ = host_and_chunked  # 6 steps of fit
    tr = mk_trainer(tmp_path, "reuse", blur_controller=decay())
    tr.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=1)
    runner = tr.chunk_runner
    tr.fit_device_resident(total_examples=10_000, chunk_steps=3, max_chunks=1)
    assert tr.chunk_runner is runner and tr.state.n_batches == 6
    assert_params_close(straight.state, tr.state, **PARAM_TOL)
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    assert tr.chunk_runner is not runner and tr.chunk_runner.chunk_steps == 2
    assert tr.state.n_batches == 8
    tr.close()


def test_kept_runner_takes_the_hosts_adaptive_state(tmp_path):
    # chunked, fit, chunked (the runner kept, its controller state reloaded
    # from the host's after fit moved it) equals 6 steps of fit.
    ada = AdaptiveBlurController(warmup_n_batches=0, delay_between_modifications=1,
                                 max_value=1.0)
    a = mk_trainer(tmp_path, "ada_straight", adaptive_controller=ada)
    a.fit(total_examples=10_000, max_steps=6)
    b = mk_trainer(tmp_path, "ada_mixed", adaptive_controller=ada)
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    runner = b.chunk_runner
    b.fit(total_examples=10_000, max_steps=2)
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    assert b.chunk_runner is runner and b.state.n_batches == 6
    assert b.ada_state.last_modification_batch == a.ada_state.last_modification_batch
    assert b.ada_state.std == pytest.approx(a.ada_state.std, rel=1e-5)
    assert_params_close(a.state, b.state, **PARAM_TOL)
    a.close()
    b.close()


def test_set_capturable_moves_the_step_counters_and_keeps_their_values():
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    step = opt.state[p]["step"]
    set_capturable(opt, False)  # already so: left alone
    assert opt.state[p]["step"] is step
    set_capturable(opt, True)
    assert opt.param_groups[0]["capturable"] is True
    assert float(opt.state[p]["step"]) == 1.0
    assert opt.state[p]["step"].device == p.device
    set_capturable(opt, False)
    assert opt.param_groups[0]["capturable"] is False
    assert opt.state[p]["step"].device.type == "cpu"
    assert opt.state[p]["step"].dtype == torch.float32


def test_restore_keeps_the_live_optimizers_capturable_setting():
    # A checkpoint written by a capturable Adam (on the card: step counters on
    # the device) restores into a CPU run's Adam, which keeps its own setting.
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.Adam([p], lr=0.1)
    p.grad = torch.ones(3)
    opt.step()
    saved = copy.deepcopy(opt.state_dict())
    saved["param_groups"][0]["capturable"] = True
    fresh = torch.optim.Adam([torch.nn.Parameter(torch.ones(3))], lr=0.1)
    _load_optimizer(fresh, saved)
    assert fresh.param_groups[0]["capturable"] is False
    slots = next(iter(fresh.state.values()))
    assert slots["step"].device.type == "cpu" and float(slots["step"]) == 1.0
    assert slots["step"].dtype == torch.float32


# ---------------------------------------------------------------------------
# Feeders, data, state tensors
# ---------------------------------------------------------------------------


def test_feeder_is_measured_at_the_chunk_boundary(tmp_path):
    feeder = MetricFeeder(SWDMetric(nhoods_per_image=16), every_n_examples=1_000,
                          num_samples=16, name="swd")
    tr = mk_trainer(tmp_path, "swd", blur_controller=decay(), metric_feeders=[feeder])
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    with open(os.path.join(tr.cfg.log_dir, "events.jsonl")) as f:
        recs = [r for r in map(json.loads, f) if "swd/SWDx1e3_16" in r]
    tr.close()
    # Pre-armed, its hook fires on the first step; the measurement completes
    # at the end of the first chunk, two steps in.
    assert [r["step"] for r in recs] == [16]
    assert np.isfinite(recs[0]["swd/SWDx1e3_avg"]) and not feeder.recording


def test_device_resident_needs_an_in_memory_dataset(tmp_path):
    class Lazy:
        name, num_examples, image_shape = "lazy", 64, (16, 16, 1)

    tr = mk_trainer(tmp_path, "lazy", blur_controller=decay())
    tr.dataset = Lazy()
    with pytest.raises(ValueError, match="materialize"):
        tr.fit_device_resident(total_examples=100, chunk_steps=2)
    tr.close()


def test_runner_uses_the_datasets_bytes(tmp_path):
    # The same stream from the JAX package's corpus: the chunk's gather sees
    # the bytes the host pipeline would.
    images = jax_synthetic_dataset((16, 16, 1), num_examples=64).images
    tr = Trainer(micro_gan(), hparams(), ArrayDataset(images), device="cpu",
                 trainer_config=TrainerConfig(log_dir=str(tmp_path / "j"), seed=0,
                                              image_summaries_interval_batches=0),
                 blur_controller=decay())
    tr.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=1)
    runner = tr.chunk_runner
    assert runner.data.dtype == torch.uint8 and runner.data.shape == (64, 16, 16, 1)
    assert runner.data.numpy().tobytes() == images.tobytes()
    np.testing.assert_array_equal(runner.idx.numpy(), chunk_indices(64, 8, 2, 0, 0))
    tr.close()


def test_state_tensors_cover_modules_and_optimizers(host_and_chunked):
    a, _ = host_and_chunked
    tensors = state_tensors(a.state)
    n_module = sum(1 for m in (a.state.generator, a.state.discriminator)
                   for _ in list(m.parameters()) + list(m.buffers()))
    n_adam = sum(len(s) for o in (a.state.g_opt, a.state.d_opt) for s in o.state.values())
    assert len(tensors) == n_module + n_adam and n_adam == 3 * sum(
        1 for m in (a.state.generator, a.state.discriminator) for _ in m.parameters())
