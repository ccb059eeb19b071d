"""The port's serving export (``blurred_gan_tpu_torch/serving.py``) against the JAX package.

A JAX state at tests/test_serving.py's ``micro_gan`` widths, with an average
and running BatchNorm statistics moved off their initial values, is carried
into the port (``convert.flax_state_to_torch``); the ``torch.export``
artifacts of its live and averaged weights must equal JAX
``gan.generate(train=False)`` on the same latents at rtol = atol = 1e-5, at
batches 1, 3 and 7, whatever the batch of the trace. Then tests/test_serving.py's
cases: any batch, the average differs from the weights, ``use_ema`` without
an average raises, and the artifact reloads in a process that imports torch
alone. ``python -m blurred_gan_tpu_torch.tools.export_generator`` on MNIST run
directories, and the profiling and logging utilities, on the CPU.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.models import DCGANDiscriminator as JaxD, DCGANGenerator as JaxG
from blurred_gan_tpu.train import BlurredWGANGPHyperParameters as JaxHP
from blurred_gan_tpu.train import GAN as JaxGAN
from blurred_gan_tpu.train import create_train_state as jax_create_train_state
from blurred_gan_tpu_torch.convert import flax_state_to_torch
from blurred_gan_tpu_torch.serving import EXAMPLE_BATCH, export_generator, load_generator
from blurred_gan_tpu_torch.tools import export_generator as export_tool
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.train.step import make_sample_fn
from blurred_gan_tpu_torch.utils import profiling
from blurred_gan_tpu_torch.utils.logging import MetricsLogger
from test_torch_fast import micro_gan
from test_torch_sampling import mnist_run, perturbed
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

TOL = dict(rtol=1e-5, atol=1e-5)
LATENT = 16


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    from blurred_gan_tpu_torch.utils import logging as logging_mod

    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


def jax_micro_gan():
    """tests/test_serving.py's ``micro_gan``."""
    g = JaxG(latent_size=LATENT, init_hw=(4, 4), init_features=32, blocks=((32, 2), (16, 2)),
             out_channels=1, final_transpose=False, final_stride=1)
    return JaxGAN(g, JaxD(channels=(16, 32)), latent_size=LATENT, blurred=True)


@pytest.fixture(scope="module")
def carried():
    jgan = jax_micro_gan()
    jstate = perturbed(jax_create_train_state(
        jgan, JaxHP(batch_size=8, global_batch_size=8, ema_decay=0.9), jax.random.PRNGKey(0),
        (16, 16, 1)))
    gan = micro_gan()
    state = create_train_state(gan, BlurredWGANGPHyperParameters(
        batch_size=8, global_batch_size=8, ema_decay=0.9), device="cpu")
    flax_state_to_torch(state, jstate)
    return jgan, jstate, gan, state


@pytest.fixture(scope="module")
def artifacts(carried):
    """{weights: (bytes, serve)} for the live and the averaged weights."""
    _, _, gan, state = carried
    out = {}
    for weights in ("live", "ema"):
        blob = export_generator(gan, state, use_ema=weights == "ema")
        out[weights] = (blob, load_generator(blob))
    return out


def latents(batch, seed=None):
    return np.random.RandomState(batch if seed is None else seed).rand(
        batch, LATENT).astype(np.float32)


@pytest.mark.parametrize("weights", ["live", "ema"])
@pytest.mark.parametrize("batch", [1, 3, 7])
def test_artifact_matches_jax_generate(carried, artifacts, weights, batch):
    jgan, jstate, _, _ = carried
    z = latents(batch)
    params = jstate.g_ema if weights == "ema" else jstate.g_params
    want, _ = jgan.generate(params, jstate.g_stats, jnp.asarray(z), train=False)
    got = artifacts[weights][1](z)
    assert got.shape == (batch, 1, 16, 16) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.transpose(np.asarray(want), (0, 3, 1, 2)), **TOL)


@pytest.mark.parametrize("weights", ["live", "ema"])
def test_artifact_equals_make_sample_fn(carried, artifacts, weights):
    _, _, gan, state = carried
    z = torch.from_numpy(latents(5))
    want = make_sample_fn(gan, use_ema=weights == "ema")(state, z)
    torch.testing.assert_close(artifacts[weights][1](z), want, **TOL)


def test_symbolic_batch_any_size(artifacts):
    serve = artifacts["live"][1]
    for bsz in (1, EXAMPLE_BATCH, 9, 33):
        assert serve(latents(bsz)).shape == (bsz, 1, 16, 16)


def test_ema_variant_differs_from_the_live_weights(artifacts):
    z = latents(4, seed=9)
    assert not np.allclose(artifacts["live"][1](z).numpy(), artifacts["ema"][1](z).numpy())


def test_use_ema_without_ema_state_raises():
    gan = micro_gan()
    state = create_train_state(gan, BlurredWGANGPHyperParameters(batch_size=8), device="cpu")
    assert state.g_ema is None
    with pytest.raises(ValueError, match="no EMA"):
        export_generator(gan, state, use_ema=True)


def test_export_leaves_the_live_generator_alone(carried):
    _, _, gan, state = carried
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    state.generator.train(True)
    export_generator(gan, state, use_ema=True)
    assert state.generator.training
    assert all(p.requires_grad for p in state.generator.parameters())
    for k, v in state.generator.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def test_artifact_holds_the_weights_and_statistics(carried, artifacts):
    # Baked in: a change to the live module after the export changes nothing.
    _, _, gan, state = carried
    serve = load_generator(artifacts["live"][0])
    z = latents(3)
    want = serve(z).clone()
    saved = {k: v.clone() for k, v in state.generator.state_dict().items()}
    try:
        with torch.no_grad():
            state.generator.dense_bn.running_mean.add_(1.0)
            next(state.generator.parameters()).mul_(2.0)
        torch.testing.assert_close(serve(z), want, rtol=0, atol=0)
    finally:
        state.generator.load_state_dict(saved)


SERVE_ONLY = """
import sys
import numpy as np
import torch
program = torch.export.load(sys.argv[1])
z = torch.from_numpy(np.load(sys.argv[2]))
with torch.no_grad():
    np.save(sys.argv[3], program.module()(z).numpy())
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("blurred_gan_tpu_torch", "blurred_gan_tpu", "jax"))
assert not loaded, loaded
"""


def test_file_round_trip_and_torch_only_reload(artifacts, tmp_path):
    """The artifact serves through ``torch.export.load`` alone: the consumer
    needs neither this package nor the checkpoint."""
    path = tmp_path / "gen.pt2"
    path.write_bytes(artifacts["ema"][0])
    serve = load_generator(str(path))
    z = latents(2, seed=11)
    np.save(tmp_path / "z.npy", z)
    out = subprocess.run([sys.executable, "-c", SERVE_ONLY, str(path), str(tmp_path / "z.npy"),
                          str(tmp_path / "out.npy")], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), serve(z).numpy())
    assert serve.exported.module()(torch.from_numpy(z)).shape == (2, 1, 16, 16)


def test_load_generator_moves_the_program(artifacts):
    z = latents(3)
    moved = load_generator(artifacts["live"][0], device="cpu")
    torch.testing.assert_close(moved(z), artifacts["live"][1](z), rtol=0, atol=0)
    assert all(t.device.type == "cpu" for t in moved.exported.state_dict.values())


# ---------------------------------------------------------------------------
# python -m blurred_gan_tpu_torch.tools.export_generator
# ---------------------------------------------------------------------------


def test_export_tool_writes_and_verifies(tmp_path, capsys):
    gan, state = mnist_run(tmp_path)
    out = tmp_path / "generator.pt2"
    export_tool.main(["--log_dir", str(tmp_path), "--out", str(out), "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "restored checkpoint @ 320 examples"
    assert lines[1].startswith(f"wrote {out} (") and "device=cpu, weights=live" in lines[1]
    assert lines[2:] == ["verified batch 1: artifact == live generator (shape (1, 1, 28, 28))",
                         "verified batch 7: artifact == live generator (shape (7, 1, 28, 28))"]
    z = torch.rand((4, 100), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(load_generator(str(out))(z), make_sample_fn(gan)(state, z), **TOL)


def test_export_tool_ema_from_the_sidecar(tmp_path, capsys):
    _, state = mnist_run(tmp_path, ema_decay=0.9)
    with torch.no_grad():
        for e in state.g_ema:
            e.mul_(0.5)
    from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager

    CheckpointManager(str(tmp_path / "checkpoints")).save(640, state)
    out = tmp_path / "ema.pt2"
    export_tool.main(["--log_dir", str(tmp_path), "--out", str(out), "--ema",
                      "--verify_batches", "3", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "weights=ema" in text and "verified batch 3:" in text


def test_export_tool_ema_without_an_average_raises(tmp_path):
    mnist_run(tmp_path)
    with pytest.raises(ValueError, match="no EMA"):
        export_tool.main(["--log_dir", str(tmp_path), "--out", str(tmp_path / "g.pt2"),
                          "--ema", "--verify_batches", "", "--device", "cpu"])
    assert not (tmp_path / "g.pt2").exists()


# ---------------------------------------------------------------------------
# utils.profiling and MetricsLogger.text
# ---------------------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")) as prof:
        (x @ x).sum()
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert any("mm" in e.key for e in prof.key_averages())


def test_step_timer_rate():
    timer = profiling.StepTimer()
    assert timer.rate() is None  # no image yet
    for _ in range(3):
        timer.tick(8)
    r = timer.rate(sync={"loss": torch.zeros(())})
    assert r is not None and r > 0
    assert timer.rate() is None  # the reading reset the count
    timer.tick(4)
    assert timer.rate(sync=torch.ones(2)) > 0


def test_logger_text(tmp_path):
    logger = MetricsLogger(str(tmp_path))
    logger.scalars(5, {"a": 1.0})
    logger.text(7, "note", "resumed from 5")
    logger.close()
    lines = [json.loads(line) for line in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert lines[-1] == {"step": 7, "note": "resumed from 5"}
