"""Sampling from a checkpoint and scoring a run with the port, against the JAX package.

- ``generate_samples``' images, blurred or not, live or averaged, from
  weights carried by ``convert.flax_state_to_torch`` and given latents,
  against the JAX pipeline (``make_sample_fn``, ``blur_images``,
  ``normalize_images``) at rtol = atol = 1e-5, at MNIST's published widths;
  its interpolation latents against the root script's formula;
- ``python -m blurred_gan_tpu_torch.generate_samples`` on port run
  directories: PNG sizes, the interpolation grid, the model from the
  manifest, the state's layout from the sidecar, and the root script's exits
  (tests/test_generate_samples.py's cases);
- ``python -m blurred_gan_tpu_torch.tools.evaluate_run``: the cases of
  tests/test_evaluate_run.py (FID over 32 random-conv features, not 2048: a
  2048² ``sqrtm`` takes ~20 s on the CPU and tests no more of the CLI);
- the four CLIs' flags against the root scripts' source text;
- ``utils.rundir.resolve_model_identity`` / ``locate_latest_checkpoint_dir``
  against the JAX package's on the same directories.
"""

import functools
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.models import mnist_discriminator as jax_mnist_d
from blurred_gan_tpu.models import mnist_generator as jax_mnist_g
from blurred_gan_tpu.ops.blur import blur_images as jax_blur_images
from blurred_gan_tpu.train import BlurredWGANGPHyperParameters as JaxHP
from blurred_gan_tpu.train import GAN as JaxGAN
from blurred_gan_tpu.train import create_train_state as jax_create_train_state
from blurred_gan_tpu.train import make_sample_fn as jax_make_sample_fn
from blurred_gan_tpu.utils import normalize_images as jax_normalize_images
from blurred_gan_tpu.utils import rundir as jax_rundir
from blurred_gan_tpu_torch import generate_samples
from blurred_gan_tpu_torch.convert import flax_state_to_torch
from blurred_gan_tpu_torch.metrics.fid import FIDMetric
from blurred_gan_tpu_torch.tools import evaluate_run, export_generator, score
from blurred_gan_tpu_torch.train.checkpoint import CheckpointManager
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import create_train_state
from blurred_gan_tpu_torch.utils import logging as logging_mod
from blurred_gan_tpu_torch.utils import rundir
from test_torch_mnist import parser_flags, script_flags, write_mnist_npz
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-5)
MNIST_SHAPE = [28, 28, 1]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


def perturbed(jax_state, seed=0):
    """``jax_state`` with an average away from the weights and running
    BatchNorm statistics away from (0, 1), so that both show in a sample."""
    rng = np.random.RandomState(seed)

    def stat(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (0.2 * rng.standard_normal(x.shape)).astype(np.float32)

    ema = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(p.shape).astype(np.float32),
        jax_state.g_params)
    return jax_state.replace(g_ema=ema,
                             g_stats=jax.tree_util.tree_map_with_path(stat, jax_state.g_stats))


def mnist_run(log_dir, examples=320, manifest=True, **hparams):
    """A port run directory holding one MNIST checkpoint at ``examples``;
    with ``hparams``, also their ``hyper_parameters.json``. Returns the GAN
    and the checkpointed state."""
    log_dir = pathlib.Path(log_dir)
    hp = BlurredWGANGPHyperParameters(**hparams)
    gan = generate_samples.run_gan("mnist", 28)
    state = create_train_state(gan, hp, device="cpu", seed=3)
    CheckpointManager(str(log_dir / "checkpoints")).save(examples, state)
    if hparams:
        hp.save_json(str(log_dir / "hyper_parameters.json"))
    if manifest:
        (log_dir / "run_manifest.json").write_text(
            json.dumps({"dataset": "synthetic28x28x1", "image_shape": MNIST_SHAPE}))
    return gan, state


def png_size(path):
    """(width, height) from a PNG's IHDR chunk."""
    head = pathlib.Path(path).read_bytes()[:24]
    assert head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR"
    return int.from_bytes(head[16:20], "big"), int.from_bytes(head[20:24], "big")


# ---------------------------------------------------------------------------
# The sampling path against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried_mnist():
    jgan = JaxGAN(jax_mnist_g(), jax_mnist_d(), blurred=True)
    jstate = perturbed(jax_create_train_state(jgan, JaxHP(ema_decay=0.9), jax.random.PRNGKey(3),
                                              (28, 28, 1)))
    gan = generate_samples.run_gan("mnist", 28)
    state = create_train_state(gan, BlurredWGANGPHyperParameters(ema_decay=0.9), device="cpu")
    flax_state_to_torch(state, jstate)
    return jgan, jstate, gan, state


@pytest.mark.parametrize("blur_std", [None, 1.5, 0.2])
@pytest.mark.parametrize("ema", [False, True])
def test_sampling_path_matches_jax(carried_mnist, blur_std, ema):
    jgan, jstate, gan, state = carried_mnist
    z = np.random.RandomState(0).rand(6, 100).astype(np.float32)
    images = jax_make_sample_fn(jgan, use_ema=ema)(jstate, jnp.asarray(z))
    if blur_std is not None:
        images = jax_blur_images(images, jnp.float32(blur_std))
    want = jax_normalize_images(np.asarray(images))
    got = generate_samples.sample_images(gan, state, torch.from_numpy(z), ema=ema,
                                         blur_std=blur_std)
    np.testing.assert_allclose(generate_samples.normalize_images(got.permute(0, 2, 3, 1).numpy()),
                               want, **TOL)


def test_interpolation_latents_match_the_root_formula():
    rng = np.random.RandomState(1)
    za, zb = rng.rand(3, 100).astype(np.float32), rng.rand(3, 100).astype(np.float32)
    t = jnp.linspace(0.0, 1.0, 5)[None, :, None]
    want = (za[:, None, :] * (1.0 - t) + zb[:, None, :] * t).reshape(15, -1)
    got = generate_samples.interpolate_latents(torch.from_numpy(za), torch.from_numpy(zb), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got[::5].numpy(), za)


def test_latents_come_from_the_seed_on_the_cpu():
    gan = generate_samples.run_gan("mnist", 28)
    args = generate_samples.parse_args(["--log_dir", "x", "--n", "10", "--seed", "4"])
    z, grid, stem = generate_samples.grid_latents(gan, args)
    assert grid == (4, 4) and stem == "generated" and z.device.type == "cpu"
    torch.testing.assert_close(z, torch.rand((10, 100), generator=torch.Generator().manual_seed(4)),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# python -m blurred_gan_tpu_torch.generate_samples (tests/test_generate_samples.py)
# ---------------------------------------------------------------------------


def test_mnist_checkpoint_to_png(tmp_path, capsys):
    mnist_run(tmp_path, manifest=False)
    out = tmp_path / "samples.png"
    images = generate_samples.main(["--log_dir", str(tmp_path), "--dataset", "mnist", "--n", "4",
                                    "--out", str(out), "--blur_std", "1.5", "--device", "cpu"])
    assert png_size(out) == (2 * 30 + 2, 2 * 30 + 2)
    assert images.shape == (4, 1, 28, 28)
    assert capsys.readouterr().out.splitlines() == ["restored checkpoint @ 320 examples",
                                                    f"wrote {out}"]


def test_interpolation_grid(tmp_path):
    gan, state = mnist_run(tmp_path, examples=128, manifest=False)
    out = tmp_path / "interp.png"
    images = generate_samples.main(["--log_dir", str(tmp_path), "--dataset", "mnist",
                                    "--interpolate", "--rows", "2", "--steps", "5",
                                    "--out", str(out), "--device", "cpu"])
    assert png_size(out) == (5 * 30 + 2, 2 * 30 + 2)  # 2 rows x 5 columns of 28² tiles
    # Each row starts at its first endpoint and ends at its second.
    z2 = torch.rand((4, 100), generator=torch.Generator().manual_seed(0))
    ends = generate_samples.sample_images(gan, state, z2)
    torch.testing.assert_close(images[[0, 5, 4, 9]], ends[[0, 1, 2, 3]], **TOL)


def test_default_names_and_the_model_from_the_manifest(tmp_path):
    mnist_run(tmp_path, examples=64)
    generate_samples.main(["--log_dir", str(tmp_path), "--n", "4", "--device", "cpu"])
    generate_samples.main(["--log_dir", str(tmp_path), "--interpolate", "--rows", "1",
                           "--steps", "2", "--device", "cpu"])
    assert png_size(tmp_path / "generated_00000064.png") == (62, 62)
    assert png_size(tmp_path / "interpolate_00000064.png") == (62, 32)


def test_sidecar_gives_the_state_layout(tmp_path):
    # An RMSprop run with an average restores only into a state built from
    # its sidecar; --ema then samples the average.
    _, state = mnist_run(tmp_path, optimizer="rmsprop", ema_decay=0.9)
    with torch.no_grad():
        for e in state.g_ema:
            e.mul_(0.5)
    CheckpointManager(str(tmp_path / "checkpoints")).save(640, state)
    got = {ema: generate_samples.main(["--log_dir", str(tmp_path), "--n", "2", "--device", "cpu",
                                       *(["--ema"] if ema else [])]) for ema in (False, True)}
    assert not torch.allclose(got[False], got[True])
    (tmp_path / "hyper_parameters.json").unlink()
    with pytest.raises(SystemExit, match="dataset/--resolution"):
        generate_samples.main(["--log_dir", str(tmp_path), "--device", "cpu"])


def test_ema_without_an_average_exits(tmp_path):
    mnist_run(tmp_path)
    with pytest.raises(SystemExit, match="--ema: this run has no EMA weights"):
        generate_samples.main(["--log_dir", str(tmp_path), "--ema", "--device", "cpu"])
    assert not list(tmp_path.glob("*.png"))


def test_model_mismatch_is_a_clear_error(tmp_path):
    mnist_run(tmp_path)
    with pytest.raises(SystemExit, match="celeba@16 model.*--dataset/--resolution"):
        generate_samples.main(["--log_dir", str(tmp_path), "--dataset", "celeba",
                               "--resolution", "16", "--device", "cpu"])


def test_no_manifest_and_no_dataset_exits(tmp_path):
    with pytest.raises(SystemExit, match="pre-manifest"):
        generate_samples.main(["--log_dir", str(tmp_path), "--n", "4", "--device", "cpu"])


def test_missing_checkpoint_exits_loudly(tmp_path):
    with pytest.raises(SystemExit, match="no checkpoint under"):
        generate_samples.main(["--log_dir", str(tmp_path), "--dataset", "mnist", "--n", "4",
                               "--device", "cpu"])


@pytest.mark.parametrize("module", [generate_samples, export_generator, evaluate_run, score])
def test_tools_refuse_a_missing_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = (["--real", "a.npz", "--fake", "b.npz"] if module is score
            else ["--log_dir", str(tmp_path)])
    if module is export_generator:
        argv += ["--out", str(tmp_path / "g.pt2")]
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main(argv)


# ---------------------------------------------------------------------------
# python -m blurred_gan_tpu_torch.tools.evaluate_run (tests/test_evaluate_run.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def small_fid(monkeypatch):
    monkeypatch.setattr(evaluate_run, "FIDMetric", functools.partial(FIDMetric, feature_dim=32))


@pytest.fixture
def mnist_data(tmp_path):
    return write_mnist_npz(tmp_path / "mnist.npz")


@pytest.fixture
def celeba64_shards(tmp_path):
    """A tiny 64² shard store, so a celeba@64 run needs no synthetic corpus."""
    d = tmp_path / "celeba64"
    d.mkdir()
    np.save(d / "shard-00000.npy", np.zeros((8, 64, 64, 3), np.uint8))
    return str(d)


def evaluate(capsys, *argv):
    out = evaluate_run.main([*argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    return out


def test_evaluate_scores_restored_checkpoint(tmp_path, mnist_data, small_fid, capsys):
    mnist_run(tmp_path / "run", manifest=False)
    out = evaluate(capsys, "--log_dir", str(tmp_path / "run"), "--dataset", "mnist",
                   "--num_samples", "64", "--data_path", mnist_data)
    assert out["examples_seen"] == 320
    assert np.isfinite(out["FID"]) and out["FID"] > 0
    assert any(k.startswith("SWD") for k in out)
    assert all(v == round(v, 4) for k, v in out.items())


def test_evaluate_infers_model_from_run_manifest(tmp_path, mnist_data, small_fid, capsys):
    mnist_run(tmp_path / "run")
    out = evaluate(capsys, "--log_dir", str(tmp_path / "run"), "--num_samples", "64",
                   "--data_path", mnist_data)
    assert out["examples_seen"] == 320


def test_evaluate_never_clobbers_the_manifest(tmp_path, celeba64_shards, capsys):
    mnist_run(tmp_path / "run")
    original = (tmp_path / "run" / "run_manifest.json").read_text()
    with pytest.raises(SystemExit):
        evaluate(capsys, "--log_dir", str(tmp_path / "run"), "--dataset", "celeba",
                 "--resolution", "64", "--num_samples", "32", "--data_path", celeba64_shards)
    assert (tmp_path / "run" / "run_manifest.json").read_text() == original


def test_evaluate_model_mismatch_is_a_clear_error(tmp_path, celeba64_shards, capsys):
    mnist_run(tmp_path / "run", manifest=False)
    with pytest.raises(SystemExit, match="dataset/--resolution"):
        evaluate(capsys, "--log_dir", str(tmp_path / "run"), "--dataset", "celeba",
                 "--resolution", "64", "--num_samples", "32", "--data_path", celeba64_shards)


def test_evaluate_no_manifest_and_no_dataset_exits(tmp_path, capsys):
    mnist_run(tmp_path / "run", manifest=False)
    with pytest.raises(SystemExit, match="pre-manifest"):
        evaluate(capsys, "--log_dir", str(tmp_path / "run"))


def test_evaluate_no_checkpoint_exits(tmp_path, mnist_data, capsys):
    with pytest.raises(SystemExit, match="no checkpoint"):
        evaluate(capsys, "--log_dir", str(tmp_path / "empty"), "--dataset", "mnist",
                 "--num_samples", "32", "--data_path", mnist_data)


def test_evaluate_ema_without_an_average_exits(tmp_path, mnist_data, capsys):
    mnist_run(tmp_path / "run")
    with pytest.raises(SystemExit, match="--ema: this run has no EMA weights"):
        evaluate(capsys, "--log_dir", str(tmp_path / "run"), "--ema", "--data_path", mnist_data)


# ---------------------------------------------------------------------------
# Flags, and the run-directory helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("module,script,renamed", [
    (generate_samples, "generate_samples.py", {}),
    (export_generator, "tools/export_generator.py", {"--platforms": "--device"}),
    (evaluate_run, "tools/evaluate_run.py", {}),
    (score, "tools/score.py", {})])
def test_flags_equal_the_root_scripts(module, script, renamed):
    want = {renamed.get(f, f) for f in script_flags(REPO / script)} | {"--device"}
    assert parser_flags(module.build_parser()) == want
    required = {score: ["--real", "a", "--fake", "b"],
                export_generator: ["--log_dir", "x", "--out", "y"]}.get(module, ["--log_dir", "x"])
    assert module.build_parser().parse_args(required).device == "cuda"


def test_resolve_model_identity_matches_jax(tmp_path):
    cases = {"none": None, "mnist": [28, 28, 1], "celeba64": [64, 64, 3], "empty": []}
    for name, shape in cases.items():
        d = tmp_path / name
        d.mkdir()
        if shape is not None:
            (d / "run_manifest.json").write_text(json.dumps({"image_shape": shape}))
        for dataset, resolution in ((None, None), ("celeba", None), ("mnist", 28),
                                    (None, 32), ("celeba", 16)):
            args = (str(d), dataset, resolution)
            try:
                want = jax_rundir.resolve_model_identity(*args)
            except SystemExit as e:
                with pytest.raises(SystemExit, match=str(e).replace("(", r"\(")
                                   .replace(")", r"\)")):
                    rundir.resolve_model_identity(*args)
                continue
            assert rundir.resolve_model_identity(*args) == want, (name, dataset, resolution)


def test_locate_latest_checkpoint_dir_matches_jax(tmp_path):
    for name in ("01-exp", "02-exp", "07-exp", "x-exp", "03-other", "10-exp"):
        (tmp_path / name).mkdir()
    for name in ("02-exp", "07-exp", "03-other"):
        (tmp_path / name / "checkpoints").mkdir()
    for run_name in ("exp", "other", "missing"):
        got = rundir.locate_latest_checkpoint_dir(str(tmp_path), run_name)
        assert got == jax_rundir.locate_latest_checkpoint_dir(str(tmp_path), run_name)
    # The latest run (10) has no checkpoint directory: None, as in JAX.
    assert rundir.locate_latest_checkpoint_dir(str(tmp_path), "exp") is None
    assert rundir.locate_latest_checkpoint_dir(str(tmp_path), "other").endswith(
        "03-other/checkpoints")
