"""The port's optimizers and TTUR against the JAX package: ``sgd`` and
``rmsprop`` against ``optax.sgd`` and ``optax.rmsprop`` on seeded gradients,
one train step with each and with ``g_learning_rate`` (TTUR) against the JAX
step (tolerances of tests/test_torch_step.py, through
``torch_variant_harness``), the mirror of tests/test_ttur.py; then what the
checkpoint restores of an optimizer: its moments and counters, never its
hyperparameters, and only into the same kind of optimizer.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.fast import state_tensors
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import (
    RMSprop, create_train_state, make_optimizer, set_capturable)
from blurred_gan_tpu_torch.train.step import make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_fast import assert_params_close as assert_states_close, micro_gan
from torch_variant_harness import (
    LOSS, PARAM_TOL, SIGMA, assert_bn_stats_close, assert_grads_close, assert_post_step_close,
    jax_grads, jax_run, port_run, reals_batches, torch_gan)
from torch_variant_harness import hparams as port_hparams

OPTAX_TOL = dict(rtol=1e-6, atol=1e-7)  # float32 both sides, one rounding apart


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


@pytest.mark.parametrize("name,lr,scale", [("sgd", 0.05, 1.0), ("rmsprop", 1e-3, 1.0),
                                           ("rmsprop", 1e-3, 1e-4)])
def test_optimizer_matches_optax(name, lr, scale):
    # Five steps on seeded gradients; at |g| ~ 1e-4 RMSprop's ε inside the
    # root is what torch.optim.RMSprop would get wrong.
    rng = np.random.RandomState(0)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [(scale * rng.randn(7, 5)).astype(np.float32) for _ in range(5)]
    tx = {"sgd": optax.sgd, "rmsprop": optax.rmsprop}[name](lr)
    want, opt_state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer(name, [p], lr)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, want)
        want = optax.apply_updates(want, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), **OPTAX_TOL)
    if name == "rmsprop":
        nu = np.asarray(opt_state[0].nu)
        np.testing.assert_allclose(opt.state[p]["nu"].numpy(), nu, **OPTAX_TOL)


def test_optimizer_kinds():
    p = [torch.nn.Parameter(torch.ones(2))]
    assert isinstance(make_optimizer("Adam", p, 1e-3), torch.optim.Adam)
    sgd = make_optimizer("sgd", p, 1e-3)
    assert isinstance(sgd, torch.optim.SGD) and sgd.param_groups[0]["momentum"] == 0
    rms = make_optimizer("rmsprop", p, 1e-3)
    assert isinstance(rms, RMSprop)
    assert (rms.param_groups[0]["decay"], rms.param_groups[0]["eps"]) == (0.9, 1e-8)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("adagrad", p, 1e-3)


@pytest.mark.parametrize("name", ["sgd", "rmsprop"])
def test_set_capturable_leaves_optimizers_without_a_step_counter_alone(name):
    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer(name, [p], 0.1)
    p.grad = torch.ones(3)
    opt.step()
    before = {k: v for k, v in opt.state[p].items()}
    set_capturable(opt, True)
    assert "capturable" not in opt.param_groups[0]
    assert opt.state[p].keys() == before.keys()
    assert all(opt.state[p][k] is v for k, v in before.items())


# ---------------------------------------------------------------------------
# One step against the JAX step
# ---------------------------------------------------------------------------

SINGLE = {"sgd": dict(optimizer="sgd", learning_rate=0.01),
          "rmsprop": dict(optimizer="rmsprop"),
          "ttur": dict(g_learning_rate=4e-3)}


@pytest.fixture(scope="module", params=list(SINGLE))
def single(request):
    kw = SINGLE[request.param]
    states, jmetrics, draws = jax_run(1, **kw)
    gan, state, metrics, grads = port_run(1, **kw)
    jgrads = jax_grads(states[0], states[1], reals_batches(1)[0], draws[0],
                       gp_coefficient=10.0, with_gp=True)
    return dict(gan=gan, state=state, metrics=metrics[0], jmetrics=jmetrics[0],
                grads=grads[0], jgrads=jgrads, jstate=states[1], kw=kw)


def test_optimizer_step_metrics(single):
    assert single["metrics"].keys() == single["jmetrics"].keys()
    for k, want in single["jmetrics"].items():
        np.testing.assert_allclose(single["metrics"][k], want, err_msg=k, **LOSS)


def test_optimizer_step_gradients(single):
    gan = single["gan"]
    assert_grads_close(gan.discriminator, single["grads"]["d"], single["jgrads"]["d"])
    assert_grads_close(gan.generator, single["grads"]["g"], single["jgrads"]["g"])


def test_optimizer_step_parameters(single):
    gan, s1 = single["gan"], single["jstate"]
    assert_post_step_close(gan.discriminator, s1.d_params, single["jgrads"]["d"])
    assert_post_step_close(gan.generator, s1.g_params, single["jgrads"]["g"])
    assert_bn_stats_close(gan.generator, s1.g_stats)


def test_ttur_learning_rates():
    state = create_train_state(torch_gan(), port_hparams(learning_rate=1e-3,
                                                         g_learning_rate=4e-3), device="cpu")
    assert state.g_opt.param_groups[0]["lr"] == 4e-3
    assert state.d_opt.param_groups[0]["lr"] == 1e-3
    state = create_train_state(torch_gan(), port_hparams(learning_rate=1e-3), device="cpu")
    assert state.g_opt.param_groups[0]["lr"] == state.d_opt.param_groups[0]["lr"] == 1e-3


def _two_steps(**kw):
    gan = torch_gan()
    hp = port_hparams(**kw)
    state = create_train_state(gan, hp, device="cpu")
    step = make_train_step(gan, hp)
    for reals in reals_batches(2):
        metrics, _ = step(state, torch.from_numpy(reals), SIGMA)
    return metrics, state


def test_explicit_equal_g_lr_is_identity():
    (ma, a), (mb, b) = _two_steps(), _two_steps(g_learning_rate=1e-3)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for x, y in zip(state_tensors(a), state_tensors(b)):
        assert torch.equal(x, y)


def test_different_g_lr_changes_only_the_generator():
    # The critic's first update does not depend on the generator's rate.
    gan_a, gan_b = torch_gan(), torch_gan()
    out = []
    for gan, kw in ((gan_a, {}), (gan_b, dict(g_learning_rate=1e-2))):
        hp = port_hparams(**kw)
        state = create_train_state(gan, hp, device="cpu")
        make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]), SIGMA)
        out.append(state)
    a, b = out
    for x, y in zip(a.discriminator.parameters(), b.discriminator.parameters()):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y)
               for x, y in zip(a.generator.parameters(), b.generator.parameters()))


# ---------------------------------------------------------------------------
# Restores: moments yes, hyperparameters no, another kind never
# ---------------------------------------------------------------------------


def _trained_state(tmp_path, **kw):
    gan = torch_gan()
    hp = port_hparams(**kw)
    state = create_train_state(gan, hp, device="cpu")
    step = make_train_step(gan, hp)
    for reals in reals_batches(2):
        step(state, torch.from_numpy(reals), SIGMA)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"), keep_time_interval_hours=None)
    ckpt.save(8, state)
    return ckpt, state


@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_resume_runs_at_the_new_learning_rate(tmp_path, optimizer):
    ckpt, saved = _trained_state(tmp_path, optimizer=optimizer, learning_rate=1e-3)
    fresh = create_train_state(torch_gan(), port_hparams(
        optimizer=optimizer, learning_rate=5e-4, g_learning_rate=2e-3), device="cpu")
    assert ckpt.restore_latest(fresh) == ({}, 8)
    assert fresh.d_opt.param_groups[0]["lr"] == 5e-4
    assert fresh.g_opt.param_groups[0]["lr"] == 2e-3
    for opt, want in ((fresh.g_opt, saved.g_opt), (fresh.d_opt, saved.d_opt)):
        got_slots, want_slots = list(opt.state.values()), list(want.state.values())
        assert len(got_slots) == len(want_slots) > 0
        for got, exp in zip(got_slots, want_slots):
            assert got.keys() == exp.keys()
            for k in got:
                assert torch.equal(got[k], exp[k]), k


def test_restore_into_another_optimizer_raises(tmp_path):
    ckpt, _ = _trained_state(tmp_path, optimizer="rmsprop")
    fresh = create_train_state(torch_gan(), port_hparams(), device="cpu")
    with pytest.raises(ValueError, match="RMSprop state, the run uses Adam"):
        ckpt.restore_latest(fresh)


def test_rmsprop_chunked_matches_fit(tmp_path):
    def mk(subdir):
        cfg = TrainerConfig(log_dir=str(tmp_path / subdir), checkpoint_every_n_examples=0,
                            sample_grid_every_n_examples=0,
                            image_summaries_interval_batches=0, save_sample_pngs=False)
        hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8,
                                          optimizer="rmsprop", g_learning_rate=2e-3)
        return Trainer(micro_gan(), hp, synthetic_dataset((16, 16, 1), num_examples=64),
                       device="cpu", trainer_config=cfg,
                       blur_controller=BlurDecayController(640, max_value=1.0))

    a, b = mk("host"), mk("chunked")
    a.fit(total_examples=10_000, max_steps=4)
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    assert_states_close(a.state, b.state, **PARAM_TOL)
    nus = [s["nu"] for s in b.state.g_opt.state.values()]
    ids = {id(t) for t in state_tensors(b.state)}
    assert nus and all(id(t) in ids for t in nus)
    a.close()
    b.close()
