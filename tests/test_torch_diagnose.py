"""The port's diagnostic tools, ``tools.diagnose_samples`` and
``tools.bn_stats_ab``, against the repo root's (``tools/diagnose_samples.py``,
``tools/bn_stats_ab.py``) and the JAX package, on inputs made from a seed.

- pixel statistics (both domains), spectrum bands and grid-tile recovery from
  the tracked grid PNGs against the root tool's functions: rows equal, raw
  band energies within rtol 1e-5;
- the blurred objective at 64 images of 32²·3 and σ = 2, on the port's plain
  blur, against the JAX package's ``blur_images``, ``SWDMetric`` (the draws
  pinned as tests/test_torch_metrics.py pins them) and ``FIDMetric`` (its
  random-conv weights carried across): the blurred reals atol 1e-5, SWD and
  FID rtol 1e-3 (test_torch_metrics.py's tolerances);
- the held-out reals, byte-equal to the root tool's on the same corpus; the
  CLI in-process on ``--config mnist``: its rows equal the root tool's
  functions applied to the same npz and reals, also with the grid fallback;
  ``--sigma`` on the CPU;
- ``bn_stats_ab``: the running- and batch-statistics sample sets of a CelebA
  16² pair carried from flax against ``GAN.generate(train=False/True)`` at
  rtol 1e-5 / atol 1e-5, the restored running buffers bit-equal after the
  batch pass; the CLI on a port run directory that a 1-step CPU run wrote
  (at 16², where the bands past the Nyquist radius are empty and have no
  ratio, as in diagnose_samples' rows; the root tool divides by zero there).
"""

import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.data.pipeline import synthetic_dataset as jax_synthetic_dataset
from blurred_gan_tpu.metrics import fid as jfid
from blurred_gan_tpu.metrics import swd as jswd
from blurred_gan_tpu.models import celeba_discriminator as jax_celeba_d
from blurred_gan_tpu.models import celeba_generator as jax_celeba_g
from blurred_gan_tpu.ops.blur import blur_images as jax_blur_images
from blurred_gan_tpu.train import BlurredWGANGPHyperParameters as JaxHP
from blurred_gan_tpu.train import GAN as JaxGAN
from blurred_gan_tpu.train import create_train_state as jax_create_train_state
from blurred_gan_tpu.utils.images import samples_grid as jax_samples_grid
from blurred_gan_tpu_torch import train_celeba
from blurred_gan_tpu_torch.convert import flax_state_to_torch, random_conv_weights_to_torch
from blurred_gan_tpu_torch.metrics import fid as pfid
from blurred_gan_tpu_torch.models.dcgan import celeba_discriminator, celeba_generator
from blurred_gan_tpu_torch.tools import bn_stats_ab
from blurred_gan_tpu_torch.tools import diagnose_samples as pds
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.state import GAN, create_train_state
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_metrics import PinnedSWD, jax_random_conv_weights, nchw
from test_torch_sampling import perturbed
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: the pinned SWD draws)

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO / "benchmarks"))

import diagnose_samples as jds  # noqa: E402  (the root tool)
import quality_parity as qp  # noqa: E402
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

GRIDS = REPO / "results" / "quality" / "heavy64" / "grids"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


def pm1(seed, shape):
    """float32 NHWC in [-1, 1] with some pixels on the rails."""
    return np.clip(np.random.RandomState(seed).uniform(-1.1, 1.1, shape), -1, 1).astype(np.float32)


def jax_reals(corpus, n):
    """The root tool's held-out reals of a uint8 corpus."""
    order = np.random.RandomState(10_000).permutation(len(corpus))
    return corpus[order[-n:]].astype(np.float32) / 127.5 - 1.0


def assert_bands_close(got, want):
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want], rtol=1e-5)


# ---------------------------------------------------------------------------
# diagnose_samples' functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_domain", [False, True])
@pytest.mark.parametrize("shape", [(8, 28, 28, 1), (6, 64, 64, 3)])
def test_pixel_stats_and_bands_equal_the_root_tool(shape, clip_domain):
    x = pm1(0, shape)
    if clip_domain:
        x = pds.to_clip_domain(x)
        np.testing.assert_array_equal(x, jds.to_clip_domain(pm1(0, shape)))
    assert pds.pixel_stats(x, clip_domain) == jds.pixel_stats(x, clip_domain)
    assert_bands_close(pds.spectrum_bands(x), jds.spectrum_bands(x))


@pytest.mark.parametrize("side", ["ref", "ours"])
def test_grid_tiles_equal_the_root_tool(side):
    path = str(GRIDS / f"g_{side}_s6.png")
    got, want = pds.load_grid_samples(path, 64), jds.load_grid_samples(path, 64)
    assert got.shape == (64, 64, 64, 3)
    np.testing.assert_array_equal(got, want)
    assert pds.pixel_stats(got, clip_domain=True) == jds.pixel_stats(want, clip_domain=True)
    assert_bands_close(pds.spectrum_bands(got), jds.spectrum_bands(want))


@pytest.mark.parametrize("shape", [(28, 28, 1), (16, 16, 3)])
def test_corpus_identity_is_quality_paritys(shape):
    assert pds.CONFIGS == {name: (cfg.image_shape, cfg.corpus_n)
                           for name, cfg in qp.CONFIGS.items()}
    corpus = jax_synthetic_dataset(shape, num_examples=300).images
    got = pds.held_out_images(shape, 300, 50).astype(np.float32) / 127.5 - 1.0
    np.testing.assert_array_equal(got, jax_reals(corpus, 50))
    assert pds.N_EVAL == jds.N_EVAL and pds.BANDS == jds.BANDS


def test_blurred_objective_matches_jax():
    reals, fakes = pm1(1, (64, 32, 32, 3)), pm1(2, (64, 32, 32, 3))
    reals = (reals + np.roll(reals, 1, 1) + np.roll(reals, 1, 2)) / 3  # smoother than fakes
    kw = dict(nhoods_per_image=32, dir_repeats=2, dirs_per_repeat=64, seed=3)
    rb = jax_blur_images(jnp.asarray(reals), jnp.float32(2.0))
    fb = jax_blur_images(jnp.asarray(fakes), jnp.float32(2.0))
    jswd_m = jswd.SWDMetric(**kw)
    jswd_m.update_state(rb, fb)
    jfid_m = jfid.FIDMetric(feature_fn=jfid.random_conv_features((32, 32, 3), dim=16, seed=1))
    jfid_m.update_state(rb, fb)

    sigma = torch.tensor(2.0)
    reals_blur = pds.blur_set(nchw(reals), sigma)
    np.testing.assert_allclose(reals_blur.permute(0, 2, 3, 1).numpy(), np.asarray(rb),
                               rtol=0, atol=1e-5)
    swd_m = PinnedSWD(**kw)
    weights = random_conv_weights_to_torch(*jax_random_conv_weights((32, 32, 3), 16, 1))
    fid_m = pfid.FIDMetric(feature_fn=pfid.random_conv_features((3, 32, 32), dim=16,
                                                                weights=weights))
    clock = {}
    got = pds.blurred_objective(reals_blur, nchw(fakes), sigma, swd_m, fid_m, timings=clock)
    assert set(clock) == {"blur_s", "swd_s", "fid_s"} and min(clock.values()) >= 0
    swd_want, swd_got = jswd_m.results(), swd_m.results()
    assert list(got) == list(swd_want) + ["fid_rc"]
    for k, v in swd_want.items():
        np.testing.assert_allclose(swd_got[k], v, rtol=1e-3, err_msg=k)
        assert got[k] == round(swd_got[k], 2)
    fid_want, fid_got = jfid_m.result(), fid_m.result()
    assert fid_want > 0
    np.testing.assert_allclose(fid_got, fid_want, rtol=1e-3)
    assert got["fid_rc"] == round(fid_got, 2)


# ---------------------------------------------------------------------------
# diagnose_samples' command line
# ---------------------------------------------------------------------------


def tool_reals(config):
    """The tool's held-out reals of ``config`` (held to the root tool's on the
    same corpus by test_corpus_identity_is_quality_paritys)."""
    return pds.held_out_images(*pds.CONFIGS[config]).astype(np.float32) / 127.5 - 1.0


def want_rows(reals, sets, clip_domain=False):
    """The root tool's rows for ``reals`` and ``[(name, fakes, source)]``."""
    bands = jds.spectrum_bands(reals)
    rows = [{"set": "reals", "n": len(reals), "domain": "clip01" if clip_domain else "pm1",
             **jds.pixel_stats(reals, clip_domain=clip_domain),
             "bands": {k: round(v, 1) for k, v in bands.items()}}]
    for name, fakes, source in sets:
        fb = jds.spectrum_bands(fakes)
        rows.append({"set": name, "n": len(fakes), "source": source,
                     **jds.pixel_stats(fakes, clip_domain=clip_domain),
                     "band_ratio_vs_reals": {k: round(fb[k] / bands[k], 3)
                                             for k in fb if bands[k] > 0}})
    return rows


def test_cli_rows_equal_the_root_tools_functions(tmp_path, monkeypatch, capsys):
    fakes = pm1(3, (200, 28, 28, 1))
    np.savez(tmp_path / "ours_samples_s0.npz", samples=fakes)
    rows = pds.main(["--dir", str(tmp_path), "--config", "mnist", "--seeds", "0",
                     "--sides", "ref,ours", "--save_grids", str(tmp_path / "grids"),
                     "--device", "cpu"])
    assert rows == want_rows(tool_reals("mnist"), [("ours_s0", fakes, "npz")])
    out = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in out if line.startswith("{")] == rows
    assert f"[skip] {tmp_path}/ref_samples_s0.npz missing" in out
    # 28x28 has no energy past r = 24: that band has no ratio.
    assert set(rows[1]["band_ratio_vs_reals"]) == {"low_r<4", "mid_4-12", "hi_12-24"}
    from PIL import Image

    grid = np.asarray(Image.open(tmp_path / "grids" / "ours_s0.png"))
    np.testing.assert_array_equal(grid, jax_samples_grid(fakes[:64]))


def test_cli_grid_fallback(tmp_path):
    # The root tool's grid case (tests/test_diagnose_grid.py): every side in
    # the clip domain at 64 tiles.
    fakes = pm1(4, (80, 28, 28, 1))
    np.savez(tmp_path / "ours_samples_s0.npz", samples=fakes)
    grids = tmp_path / "grids"
    grids.mkdir()
    ref = pm1(5, (64, 28, 28, 1))
    pds.save_image_grid(ref, str(grids / "g_ref_s0.png"))
    rows = pds.main(["--dir", str(tmp_path), "--config", "mnist", "--sides", "ref,ours,gone",
                     "--grids_from", str(grids), "--device", "cpu"])
    reals = jds.to_clip_domain(tool_reals("mnist")[:64])
    want = want_rows(reals, [("ref_s0", jds.load_grid_samples(str(grids / "g_ref_s0.png"), 28),
                              "grid_png"),
                             ("ours_s0", jds.to_clip_domain(fakes[:64]), "npz")],
                     clip_domain=True)
    assert rows == want
    assert rows[1]["rail0"] + rows[1]["rail1"] == pytest.approx(rows[1]["sat"])


def test_cli_sigma_scores_the_blurred_objective(tmp_path, monkeypatch):
    # --sigma on the CPU with FID over 32 random-conv features (a 2048² sqrtm
    # takes ~20 s here and tests no more of the CLI): the row's objective is
    # blurred_objective on the same sets.
    fakes = pm1(6, (300, 28, 28, 1))
    np.savez(tmp_path / "ours_samples_s0.npz", samples=fakes)
    monkeypatch.setattr(pds, "FIDMetric", lambda: pfid.FIDMetric(feature_dim=32))
    timings = {}
    rows = pds.main(["--dir", str(tmp_path), "--config", "mnist", "--sides", "ours",
                     "--sigma", "1.5", "--device", "cpu"], timings=timings)
    reals = tool_reals("mnist")
    sigma = torch.tensor(1.5)
    want = pds.blurred_objective(pds.blur_set(nchw(reals), sigma), nchw(fakes), sigma,
                                 pds.SWDMetric(), pfid.FIDMetric(feature_dim=32))
    assert rows[1]["blurred_objective"] == want
    assert list(want) == ["SWDx1e3_28", "SWDx1e3_avg", "fid_rc"]
    assert set(timings) == {"reals", "ours_s0"} and set(timings["ours_s0"]) == {
        "blur_s", "swd_s", "fid_s"}


def test_tools_refuse_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        pds.main(["--dir", str(tmp_path)])
    with pytest.raises(SystemExit, match="no CUDA device"):
        bn_stats_ab.main(["--log_dir", str(tmp_path)])


# ---------------------------------------------------------------------------
# bn_stats_ab
# ---------------------------------------------------------------------------


def test_eval_latents_are_quality_paritys():
    np.testing.assert_array_equal(bn_stats_ab.eval_latents(), qp._eval_latents())


def test_bn_sample_sets_match_jax_and_keep_the_running_buffers():
    jgan = JaxGAN(jax_celeba_g(16), jax_celeba_d(16), blurred=True)
    jstate = perturbed(jax_create_train_state(jgan, JaxHP(), jax.random.PRNGKey(3), (16, 16, 3)))
    gan = GAN(celeba_generator(16), celeba_discriminator(16))
    state = create_train_state(gan, BlurredWGANGPHyperParameters(), device="cpu")
    flax_state_to_torch(state, jstate)
    z = bn_stats_ab.eval_latents()[:16]
    before = {k: v.clone() for k, v in state.generator.named_buffers()}
    mode = state.generator.training
    for train in (False, True):
        want = np.concatenate([np.asarray(jgan.generate(jstate.g_params, jstate.g_stats,
                                                        jnp.asarray(z[i:i + 8]), train=train)[0])
                               for i in range(0, 16, 8)])
        got = bn_stats_ab.sample(state.generator, torch.from_numpy(z), 8, train)
        np.testing.assert_allclose(got, want, **TOL)
    for k, v in state.generator.named_buffers():
        assert torch.equal(v, before[k]), k
    assert state.generator.training == mode


@pytest.fixture(scope="module")
def celeba_run(tmp_path_factory):
    """A port run directory at CelebA 16² with one checkpoint, from one CPU
    step of the entry point."""
    log_dir = tmp_path_factory.mktemp("runs") / "ours_s0"
    writer = logging_mod._summary_writer
    logging_mod._summary_writer = lambda log_dir: None
    try:
        train_celeba.main(["--resolution", "16", "--batch_size", "4", "--num_examples", "32",
                           "--max_steps", "1", "--device", "cpu", "--log_dir", str(log_dir)])
    finally:
        logging_mod._summary_writer = writer
    assert (log_dir / "checkpoints" / "4.pt").exists()
    return log_dir


def test_bn_cli_on_a_port_run_directory(celeba_run, tmp_path, capsys):
    out_dir = tmp_path / "sets"
    rows = bn_stats_ab.main(["--log_dir", str(celeba_run), "--n", "16", "--batch", "8",
                             "--corpus_n", "64", "--out_npz_dir", str(out_dir),
                             "--device", "cpu"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == rows and [r["set"] for r in rows] == [
        "reals", "ours_s0:bn_running", "ours_s0:bn_batch"]
    reals = jax_reals(jax_synthetic_dataset((16, 16, 3), num_examples=64).images, 16)
    ref = jds.spectrum_bands(reals)
    assert rows[0] == {"set": "reals", "n": 16, **jds.pixel_stats(reals),
                       "bands": {k: round(v, 1) for k, v in ref.items()}}
    for row, mode, window in ((rows[1], "bn_running", "running"), (rows[2], "bn_batch", 8)):
        with np.load(out_dir / f"ours_s0_{mode}.npz") as d:
            x = d["samples"]
        assert x.shape == (16, 16, 16, 3)
        bands = jds.spectrum_bands(x)
        assert row == {"set": f"ours_s0:{mode}", "n": 16, "bn_window": window,
                       **jds.pixel_stats(x),
                       "band_ratio_vs_reals": {k: round(bands[k] / ref[k], 3)
                                               for k in bands if ref[k] > 0}}
        # At 16² the two outer bands are empty (the root tool would divide by 0).
        assert set(row["band_ratio_vs_reals"]) == {"low_r<4", "mid_4-12"}


def test_bn_cli_refusals(celeba_run, tmp_path):
    # A "resize" run name asks for the resize upsampler, whose parameters
    # this transpose run's checkpoint does not hold.
    resize = tmp_path / "ours_resize_s0"
    os.symlink(celeba_run, resize)
    with pytest.raises(SystemExit, match="checkpoint restore failed"):
        bn_stats_ab.main(["--log_dir", str(resize), "--corpus_n", "64", "--device", "cpu"])
    mnist = tmp_path / "mnist"
    mnist.mkdir()
    (mnist / "run_manifest.json").write_text(json.dumps({"image_shape": [28, 28, 1]}))
    with pytest.raises(SystemExit, match="CelebA family"):
        bn_stats_ab.main(["--log_dir", str(mnist), "--device", "cpu"])
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "run_manifest.json").write_text(json.dumps({"image_shape": [16, 16, 3]}))
    with pytest.raises(SystemExit, match="no checkpoint"):
        bn_stats_ab.main(["--log_dir", str(empty), "--corpus_n", "64", "--device", "cpu"])
