"""Gradient accumulation in the port (``grad_accumulation_steps``): the
mirror of tests/test_grad_accum.py. One K = 2 step against the JAX step at the
tolerances of tests/test_torch_step.py (the JAX gradients summed over the
microbatches, the generator's BatchNorm per microbatch), through
``torch_variant_harness``; K = 2 against K = 1 in the port; the two
``ValueError``\\ s; accumulation composed with lazy GP, ``d_steps_per_g_step``,
flip and TTUR over four steps against JAX; and the chunked mode against
``fit`` on the CPU.
"""

import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train import step as step_mod
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import make_step_body, make_train_step
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_fast import assert_params_close as assert_states_close, micro_gan
from torch_variant_harness import (
    B, LOSS, PARAM_TOL, SIGMA, assert_bn_stats_close, assert_grads_close, assert_params_close,
    assert_post_step_close, jax_grads, jax_run, port_run, reals_batches, torch_gan)
from torch_variant_harness import hparams as port_hparams

K = 2


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
        yield


@pytest.fixture(scope="module")
def accum_step():
    states, jmetrics, draws = jax_run(1, grad_accumulation_steps=K)
    gan, state, metrics, grads = port_run(1, grad_accumulation_steps=K)
    jgrads = jax_grads(states[0], states[1], reals_batches(1)[0], draws[0],
                       gp_coefficient=10.0, with_gp=True, accum=K)
    return dict(gan=gan, metrics=metrics[0], jmetrics=jmetrics[0], grads=grads[0],
                jgrads=jgrads, jstate=states[1])


def test_accumulated_step_metrics(accum_step):
    got, want = accum_step["metrics"], accum_step["jmetrics"]
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **LOSS)


@pytest.mark.parametrize("net", ["d", "g"])
def test_accumulated_step_gradients(accum_step, net):
    module = accum_step["gan"].discriminator if net == "d" else accum_step["gan"].generator
    assert_grads_close(module, accum_step["grads"][net], accum_step["jgrads"][net])


def test_accumulated_step_parameters_and_statistics(accum_step):
    gan, s1 = accum_step["gan"], accum_step["jstate"]
    assert_post_step_close(gan.discriminator, s1.d_params, accum_step["jgrads"]["d"])
    assert_post_step_close(gan.generator, s1.g_params, accum_step["jgrads"]["g"])
    # The running statistics carried through both microbatches, as the JAX
    # step's scan carries them.
    assert_bn_stats_close(gan.generator, s1.g_stats)


def _one_port_step(accum, **kw):
    gan = torch_gan()
    hp = port_hparams(grad_accumulation_steps=accum, **kw)
    state = create_train_state(gan, hp, device="cpu")
    grads = {}
    real_apply = step_mod._apply

    def recording_apply(opt, params, gs):
        grads["g" if opt is state.g_opt else "d"] = [g.detach().clone() for g in gs]
        real_apply(opt, params, gs)

    step_mod._apply = recording_apply
    try:
        metrics, fakes = make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]),
                                                  SIGMA)
    finally:
        step_mod._apply = real_apply
    return gan, state, metrics, fakes, grads


def test_critic_update_equals_the_full_batch_update():
    # Same draws (z_d, α, z_g for the full batch, no dropout): the fakes (the
    # microbatches' fakes, concatenated), the critic's gradient and its update
    # are the full batch's up to float32 summation order.
    full = _one_port_step(1)
    acc = _one_port_step(K)
    torch.testing.assert_close(acc[3], full[3], rtol=1e-6, atol=1e-7)
    for key in ("disc_loss", "wgan_loss", "gp_term", "norm_term", "fake_scores",
                "real_scores"):
        np.testing.assert_allclose(float(acc[2][key]), float(full[2][key]), rtol=2e-5,
                                   atol=1e-8, err_msg=key)
    for a, b in zip(acc[4]["d"], full[4]["d"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6)
    for a, b in zip(acc[0].discriminator.parameters(), full[0].discriminator.parameters()):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=1e-5)
    assert acc[1].n_batches == 1 and acc[1].n_img == B


def test_indivisible_batch_raises():
    gan = torch_gan()
    hp = port_hparams(grad_accumulation_steps=3)
    state = create_train_state(gan, hp, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(gan, hp)(state, torch.from_numpy(reals_batches(1)[0]), SIGMA)


def test_reference_grad_scale_conflict_raises():
    with pytest.raises(ValueError, match="reference_grad_scale"):
        make_step_body(torch_gan(), port_hparams(grad_accumulation_steps=2,
                                                 reference_grad_scale=True))


COMPOSED = dict(grad_accumulation_steps=K, gp_every_n_steps=2, d_steps_per_g_step=3,
                flip_augment=True, g_learning_rate=2e-3)


def test_composes_with_lazy_gp_d_steps_flip_and_ttur():
    # Four steps reach all four phases: (gp, gen), (-, -), (gp, -), (-, gen).
    states, jmetrics, _ = jax_run(4, **COMPOSED)
    _, state, metrics, _ = port_run(4, **COMPOSED)
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=f"step {i}: {k}", **PARAM_TOL)
    assert [int(m["gp_term"] > 0) for m in metrics] == [1, 0, 1, 0]
    assert [int(m["did_gen_step"]) for m in metrics] == [1, 0, 0, 1]
    for i in range(4):
        gan, _, _, grads = port_run(1, first=i, total=4, **COMPOSED)
        assert_post_step_close(gan.discriminator, states[i + 1].d_params, grads[0]["d"])
        if "g" in grads[0]:
            assert_post_step_close(gan.generator, states[i + 1].g_params, grads[0]["g"])
        else:
            assert_params_close(gan.generator, states[i].g_params, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(), dict(gp_every_n_steps=2, d_steps_per_g_step=2)],
                         ids=["accum", "accum_lazy_gp_d_steps"])
def test_chunked_matches_fit(tmp_path, kw):
    def mk(subdir):
        cfg = TrainerConfig(log_dir=str(tmp_path / subdir), checkpoint_every_n_examples=0,
                            sample_grid_every_n_examples=0,
                            image_summaries_interval_batches=0, save_sample_pngs=False)
        hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8,
                                          grad_accumulation_steps=4, **kw)
        return Trainer(micro_gan(), hp, synthetic_dataset((16, 16, 1), num_examples=64),
                       device="cpu", trainer_config=cfg,
                       blur_controller=BlurDecayController(640, max_value=1.0))

    a, b = mk("host"), mk("chunked")
    a.fit(total_examples=10_000, max_steps=4)
    b.fit_device_resident(total_examples=10_000, chunk_steps=2, max_chunks=2)
    assert a.state.n_batches == b.state.n_batches == 4
    assert_states_close(a.state, b.state, **PARAM_TOL)
    for ha, hb in zip(a.history, b.history):
        for k in ("disc_loss", "gen_loss", "gp_term", "did_gen_step"):
            assert hb[k] == pytest.approx(ha[k], rel=1e-4, abs=1e-5), k
    assert b.chunk_runner.fakes.shape[0] == 8
    a.close()
    b.close()
