"""KID, PRDC and the scoring CLI of the port against the JAX package.

``metrics/kid.py`` and ``metrics/prdc.py`` on the same seeded numpy features
as the JAX ``kid`` / ``prdc``: KID at rtol 1e-5 (its std at 1e-4: a
difference of float32 estimates) on sets far enough apart that KID is not a
difference of nearly equal sums; precision, recall and coverage as equal
counts; density at rtol 1e-6. ``*_from_images`` through random-conv weights
carried by ``convert.random_conv_weights_to_torch``. The cases of
tests/test_kid.py and tests/test_prdc.py on the port's functions, and those of
tests/test_score_cli.py on ``python -m blurred_gan_tpu_torch.tools.score``
(a directory input scores as the npz of its decoded images). The CLI cases
score FID over 32 random-conv features, not 2048: a 2048² ``sqrtm`` takes
~20 s on the CPU and tests no more of the CLI.
"""

import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.metrics import fid as jfid
from blurred_gan_tpu.metrics import kid as jax_kid, kid_from_images as jax_kid_from_images
from blurred_gan_tpu.metrics import prdc as jax_prdc, prdc_from_images as jax_prdc_from_images
from blurred_gan_tpu_torch.convert import random_conv_weights_to_torch
from blurred_gan_tpu_torch.metrics import fid
from blurred_gan_tpu_torch.metrics.kid import kid, kid_from_images
from blurred_gan_tpu_torch.metrics.prdc import prdc, prdc_from_images
from blurred_gan_tpu_torch.tools import score
from test_torch_metrics import jax_random_conv_weights, nchw
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
KID_TOL = dict(rtol=1e-5)
KID_STD_TOL = dict(rtol=1e-4)
DENSITY_TOL = dict(rtol=1e-6)


def assert_prdc_equal(got, want, n_real, n_fake):
    """Precision and density over the fakes, recall and coverage over the
    reals: the counts equal, density within ``DENSITY_TOL``."""
    for key, n in (("precision", n_fake), ("recall", n_real), ("coverage", n_real)):
        assert round(got[key] * n) == round(want[key] * n), (key, got[key], want[key])
        assert got[key] == pytest.approx(want[key], rel=1e-6, abs=0)
    np.testing.assert_allclose(got["density"], want["density"], **DENSITY_TOL)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,n_real,n_fake,dim,subsets,m", [
    (0, 120, 150, 16, 8, 64), (1, 200, 90, 32, 5, 1000), (2, 40, 40, 8, 100, 64)])
def test_kid_matches_jax(seed, n_real, n_fake, dim, subsets, m):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_real, dim)).astype(np.float32)
    y = (rng.standard_normal((n_fake, dim)) + 0.5).astype(np.float32)
    got = kid(x, y, n_subsets=subsets, subset_size=m, seed=seed)
    want = jax_kid(x, y, n_subsets=subsets, subset_size=m, seed=seed)
    np.testing.assert_allclose(got["kid"], want["kid"], **KID_TOL)
    np.testing.assert_allclose(got["kid_std"], want["kid_std"], atol=1e-9, **KID_STD_TOL)


@pytest.mark.parametrize("seed,n_real,n_fake,dim,k,shift", [
    (0, 200, 200, 16, 5, 0.0), (1, 300, 100, 8, 3, 0.3), (2, 150, 250, 32, 5, 1.0),
    (3, 64, 64, 4, 1, 0.0)])
def test_prdc_matches_jax(seed, n_real, n_fake, dim, k, shift):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal((n_real, dim)).astype(np.float32)
    fake = (rng.standard_normal((n_fake, dim)) + shift).astype(np.float32)
    assert_prdc_equal(prdc(real, fake, k=k), jax_prdc(real, fake, k=k), n_real, n_fake)


def test_prdc_identical_sets_match_jax():
    # Every fake sits on a real: the k-th radii tie with fake-real distances.
    x = np.random.default_rng(9).standard_normal((100, 16)).astype(np.float32)
    assert_prdc_equal(prdc(x, x, k=5), jax_prdc(x, x, k=5), 100, 100)


def carried_features(shape, dim, seed):
    """The JAX random-conv extractor and the port's with its weights."""
    weights = random_conv_weights_to_torch(*jax_random_conv_weights(shape, dim, seed))
    return (jfid.random_conv_features(shape, dim=dim, seed=seed),
            fid.random_conv_features((shape[2], *shape[:2]), dim=dim, weights=weights))


def image_sets(seed, shape, n=48):
    """Reals and brighter fakes, whose random-conv KID (~0.03) is far above
    the ~1e-7 that float32 leaves of the kernel sums."""
    reals = np.random.default_rng(seed).uniform(-1, 1, (n, *shape)).astype(np.float32)
    return reals, np.clip(reals + 0.8, -1, 1)


@pytest.mark.parametrize("shape", [(16, 16, 3), (28, 28, 1)])
def test_from_images_match_jax_with_carried_weights(shape):
    jax_fn, port_fn = carried_features(shape, 64, 3)
    reals, fakes = image_sets(4, shape)
    got = kid_from_images(nchw(reals), nchw(fakes), feature_fn=port_fn, n_subsets=4,
                          subset_size=32, batch=16)
    want = jax_kid_from_images(reals, fakes, feature_fn=jax_fn, n_subsets=4,
                               subset_size=32, batch=16)
    np.testing.assert_allclose(got["kid"], want["kid"], **KID_TOL)
    got = prdc_from_images(nchw(reals), nchw(fakes), feature_fn=port_fn, k=3, batch=16)
    want = jax_prdc_from_images(reals, fakes, feature_fn=jax_fn, k=3, batch=16)
    assert_prdc_equal(got, want, len(reals), len(fakes))


# ---------------------------------------------------------------------------
# tests/test_kid.py's cases
# ---------------------------------------------------------------------------


def kid_oracle(x, y, n_subsets, m, seed):
    """The paper's estimator in numpy float64, subsets drawn as ``kid`` draws them."""
    rng = np.random.RandomState(seed)
    d = x.shape[1]
    vals = []
    for _ in range(n_subsets):
        xs = x[rng.choice(len(x), m, replace=False)].astype(np.float64)
        ys = y[rng.choice(len(y), m, replace=False)].astype(np.float64)
        kxx = (xs @ xs.T / d + 1.0) ** 3
        kyy = (ys @ ys.T / d + 1.0) ** 3
        kxy = (xs @ ys.T / d + 1.0) ** 3
        np.fill_diagonal(kxx, 0.0)
        np.fill_diagonal(kyy, 0.0)
        vals.append(kxx.sum() / (m * (m - 1)) + kyy.sum() / (m * (m - 1)) - 2.0 * kxy.mean())
    return float(np.mean(vals)), float(np.std(vals))


def test_kid_matches_numpy_oracle():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((120, 16)).astype(np.float32)
    y = (rng.standard_normal((150, 16)) + 0.5).astype(np.float32)
    out = kid(x, y, n_subsets=8, subset_size=64, seed=3)
    mean, std = kid_oracle(x, y, 8, 64, 3)
    assert out["kid"] == pytest.approx(mean, rel=1e-4, abs=1e-6)
    assert out["kid_std"] == pytest.approx(std, rel=1e-3, abs=1e-6)


def test_kid_identical_distribution_is_near_zero():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    y = rng.standard_normal((400, 32)).astype(np.float32)
    out = kid(x, y, n_subsets=20, subset_size=200)
    assert abs(out["kid"]) < 0.005
    z = (rng.standard_normal((400, 32)) + 1.0).astype(np.float32)
    assert kid(x, z, n_subsets=20, subset_size=200)["kid"] > 10 * abs(out["kid"])


def test_kid_monotone_in_shift():
    x = np.random.default_rng(2).standard_normal((300, 8)).astype(np.float32)
    scores = [kid(x, x + s, n_subsets=10, subset_size=128)["kid"] for s in (0.0, 0.5, 1.0, 2.0)]
    assert scores == sorted(scores)


def test_kid_subset_size_clamped_and_deterministic():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((50, 4)).astype(np.float32)
    y = rng.standard_normal((40, 4)).astype(np.float32)
    assert kid(x, y, n_subsets=5, subset_size=1000) == kid(x, y, n_subsets=5, subset_size=1000)


def test_kid_full_set_clamp_is_single_exact_estimate():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((30, 4)).astype(np.float32)
    y = rng.standard_normal((30, 4)).astype(np.float32)
    out = kid(x, y, n_subsets=100, subset_size=64)
    assert out["kid_std"] == 0.0
    assert out["kid"] == pytest.approx(kid(x, y, n_subsets=1, subset_size=30)["kid"], abs=1e-9)


@pytest.mark.parametrize("real,fake,kw", [
    ((10, 4), (10, 5), {}), ((10, 4), (1, 4), {}), ((10, 4, 2), (10, 4), {}),
    ((10, 4), (10, 4), {"subset_size": 1})])
def test_kid_input_validation(real, fake, kw):
    with pytest.raises(ValueError):
        kid(np.zeros(real, np.float32), np.zeros(fake, np.float32), **kw)


def test_kid_from_images_pipeline():
    rng = np.random.default_rng(4)
    reals = rng.uniform(-1, 1, (60, 16, 16, 3)).astype(np.float32)
    fakes = np.clip(reals + 0.5, -1, 1)
    same = kid_from_images(nchw(reals), nchw(reals.copy()), n_subsets=4, subset_size=32,
                           batch=20, feature_dim=64)
    diff = kid_from_images(nchw(reals), nchw(fakes), n_subsets=4, subset_size=32, batch=20,
                           feature_dim=64)
    assert abs(same["kid"]) < 1e-3
    assert diff["kid"] > same["kid"]


def test_kid_on_tensors_keeps_their_device_and_gives_floats():
    x = torch.randn(20, 4, generator=torch.Generator().manual_seed(0))
    out = kid(x, x + 1.0, n_subsets=2, subset_size=10)
    assert set(out) == {"kid", "kid_std"} and all(isinstance(v, float) for v in out.values())


# ---------------------------------------------------------------------------
# tests/test_prdc.py's cases
# ---------------------------------------------------------------------------


def blobs(rng, n, d, center, scale=1.0):
    return center + scale * rng.standard_normal((n, d)).astype(np.float32)


def test_prdc_identical_sets_are_perfect():
    x = blobs(np.random.default_rng(0), 200, 16, 0.0)
    out = prdc(x, x, k=5)
    assert out["precision"] == out["recall"] == out["coverage"] == 1.0
    assert out["density"] >= 1.0


def test_prdc_disjoint_clusters_are_zero():
    rng = np.random.default_rng(1)
    out = prdc(blobs(rng, 200, 16, 0.0), blobs(rng, 200, 16, 1000.0), k=5)
    assert out == {"precision": 0.0, "recall": 0.0, "density": 0.0, "coverage": 0.0}


def test_prdc_mode_collapse_signature():
    rng = np.random.default_rng(2)
    real = blobs(rng, 400, 8, 0.0, scale=5.0)
    out = prdc(real, blobs(rng, 400, 8, real[0], scale=0.05), k=5)
    assert out["precision"] > 0.9 and out["coverage"] < 0.2 and out["recall"] < 0.5


def test_prdc_same_distribution_scores_high():
    rng = np.random.default_rng(3)
    out = prdc(blobs(rng, 500, 8, 0.0), blobs(rng, 500, 8, 0.0), k=5)
    assert out["precision"] > 0.8 and out["recall"] > 0.8 and out["coverage"] > 0.8
    assert 0.5 < out["density"] < 2.0


def test_prdc_asymmetric_set_sizes():
    rng = np.random.default_rng(4)
    out = prdc(blobs(rng, 300, 8, 0.0), blobs(rng, 100, 8, 0.0), k=3)
    assert all(0.0 <= v for v in out.values())
    assert out["precision"] <= 1.0 and out["recall"] <= 1.0


def test_prdc_validation():
    rng = np.random.default_rng(5)
    x = blobs(rng, 10, 4, 0.0)
    with pytest.raises(ValueError, match="k="):
        prdc(x, x, k=10)
    with pytest.raises(ValueError, match="feature matrices"):
        prdc(x, blobs(rng, 10, 8, 0.0))


def test_prdc_from_images_via_shared_extractor():
    rng = np.random.default_rng(6)
    reals = rng.uniform(-1, 1, (64, 16, 16, 1)).astype(np.float32)
    same = prdc_from_images(nchw(reals), nchw(reals.copy()), k=3, batch=32, feature_dim=256)
    assert same["precision"] == 1.0 and same["recall"] == 1.0
    fakes = np.clip(reals + rng.normal(0, 2.0, reals.shape), -1, 1).astype(np.float32)
    noisy = prdc_from_images(nchw(reals), nchw(fakes), k=3, batch=32, feature_dim=256)
    assert noisy["recall"] <= same["recall"] and noisy["precision"] < 1.0


# ---------------------------------------------------------------------------
# python -m blurred_gan_tpu_torch.tools.score (tests/test_score_cli.py's cases)
# ---------------------------------------------------------------------------


@pytest.fixture
def small_fid(monkeypatch):
    monkeypatch.setattr(score, "FIDMetric", functools.partial(fid.FIDMetric, feature_dim=32))


@pytest.fixture(scope="module")
def sample_sets(tmp_path_factory):
    d = tmp_path_factory.mktemp("score")
    rs = np.random.RandomState(0)
    a = rs.randint(0, 256, (48, 32, 32, 3), np.uint8)
    b = np.clip(a.astype(np.int16) + rs.randint(-40, 40, a.shape), 0, 255).astype(np.uint8)
    pa, pb = str(d / "a.npz"), str(d / "b.npz")
    np.savez(pa, samples=a)
    np.savez(pb, samples=b)
    return pa, pb


def run_score(capsys, *argv):
    out = score.main([*argv, "--device", "cpu"])
    assert capsys.readouterr().out.strip().splitlines()[-1] == json.dumps(out)
    return out


def test_load_npz_uint8_to_unit_range(sample_sets):
    x = score._load(sample_sets[0], None, None)
    assert x.dtype == np.float32 and x.min() >= -1.0 and x.max() <= 1.0


def test_load_limit(sample_sets):
    assert len(score._load(sample_sets[0], None, 7)) == 7


def test_load_grayscale_npy_gains_channel(tmp_path):
    p = str(tmp_path / "g.npy")
    np.save(p, np.zeros((4, 16, 16), np.uint8))
    assert score._load(p, None, None).shape == (4, 16, 16, 1)


def test_load_equals_the_root_script(sample_sets, tmp_path):
    spec = importlib.util.spec_from_file_location("root_score", REPO / "tools" / "score.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    p = str(tmp_path / "f.npy")
    np.save(p, np.random.RandomState(1).uniform(-1, 1, (5, 8, 8)).astype(np.float32))
    for path, limit in ((sample_sets[0], None), (sample_sets[1], 9), (p, None)):
        assert score._load(path, None, limit).tobytes() == root._load(path, None, limit).tobytes()


def test_identical_sets_fid_zero(sample_sets, small_fid, capsys):
    out = run_score(capsys, "--real", sample_sets[0], "--fake", sample_sets[0], "--no_swd",
                    "--batch", "16")
    assert abs(out["fid_randconv"]) < 1e-3
    assert out["n_images"] == 48


def test_swd_and_fid_keys(sample_sets, small_fid, capsys):
    out = run_score(capsys, "--real", sample_sets[0], "--fake", sample_sets[1], "--batch", "16")
    assert "SWDx1e3_32" in out and "SWDx1e3_16" in out
    assert "SWDx1e3_avg" in out and out["fid_randconv"] > 0


def test_kid_and_prdc_keys_over_fid_features(sample_sets, small_fid, capsys):
    out = run_score(capsys, "--real", sample_sets[0], "--fake", sample_sets[1], "--no_swd",
                    "--batch", "16", "--prdc", "--prdc_k", "3", "--kid", "--kid_subsets", "5",
                    "--kid_subset_size", "24")
    for key in ("precision", "recall", "density", "coverage"):
        assert 0.0 <= out[key] and out[key] == round(out[key], 4)
    assert np.isfinite(out["kid"]) and out["kid_std"] > 0


def test_shape_mismatch_rejected(sample_sets, tmp_path, capsys):
    p = str(tmp_path / "small.npz")
    np.savez(p, samples=np.zeros((4, 16, 16, 3), np.uint8))
    with pytest.raises(SystemExit, match="shape mismatch"):
        run_score(capsys, "--real", sample_sets[0], "--fake", p)


def test_directory_input_is_item_9(sample_sets, small_fid, tmp_path, capsys, monkeypatch):
    # A directory of images scores as the npz of its images decoded by the
    # JAX package (centre crop, resize to --resolution); --resolution is
    # required with a directory. The JAX loader is built here if this
    # process lost its first-build race (tests/torch_jax_state.py), so both
    # sides decode with the same decoder.
    from PIL import Image

    from blurred_gan_tpu.data.pipeline import ImageFolderDataset as JaxImageFolderDataset
    from torch_jax_state import ensure_jax_native

    ensure_jax_native(monkeypatch)

    rs = np.random.RandomState(1)
    d = tmp_path / "imgs"
    d.mkdir()
    for i in range(20):
        Image.fromarray(rs.randint(0, 256, (40, 36, 3), np.uint8)).save(str(d / f"{i:02d}.png"))
    decoded = str(tmp_path / "decoded.npz")
    np.savez(decoded, samples=JaxImageFolderDataset(str(d), 32).materialize(progress=False).images)
    flags = ["--fake", sample_sets[1], "--resolution", "32", "--batch", "8", "--limit", "16",
             "--kid", "--kid_subsets", "3", "--kid_subset_size", "8"]
    from_folder = run_score(capsys, "--real", str(d), *flags)
    assert from_folder == run_score(capsys, "--real", decoded, *flags)
    assert from_folder["n_images"] == 16 and from_folder["image_shape"] == [32, 32, 3]
    with pytest.raises(SystemExit, match="--resolution is required"):
        run_score(capsys, "--real", str(d), "--fake", sample_sets[1])


def test_score_refuses_a_missing_card(sample_sets):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        score.main(["--real", sample_sets[0], "--fake", sample_sets[0]])


def test_kid_prdc_parity_through_jnp_inputs():
    # The JAX functions take jnp arrays too; the port's take tensors.
    rng = np.random.default_rng(11)
    x = rng.standard_normal((80, 8)).astype(np.float32)
    y = (rng.standard_normal((80, 8)) + 0.5).astype(np.float32)
    want = jax_kid(jnp.asarray(x), jnp.asarray(y), n_subsets=3, subset_size=40)
    got = kid(torch.from_numpy(x), torch.from_numpy(y), n_subsets=3, subset_size=40)
    np.testing.assert_allclose(got["kid"], want["kid"], **KID_TOL)
