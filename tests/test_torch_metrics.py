"""The port's metrics (``blurred_gan_tpu_torch/metrics``) against the JAX package's.

The same numpy inputs, made from a seed, go through both; the port takes
NCHW, the JAX package NHWC. Random draws are pinned where the two frameworks
cannot draw alike: SWD patch positions and projection directions, and the
random-conv and Inception weights, are drawn with the JAX package's own
``jax.random`` calls and handed to the port. JAX functions are called
un-jitted where a jit wrapper would only add a compile.

Tolerances (float32 on both sides, other summation orders): the pyramid atol
1e-5; descriptors exact (a gather); normalised descriptors rtol 1e-5; one
sliced Wasserstein distance rtol 1e-4; the SWD metric end to end rtol 1e-3;
the Fréchet distance in float64 rtol 1e-10; feature moments rtol 1e-5;
random-conv features rtol 1e-4; the FID metric rtol 1e-3; the Inception trunk
rtol 1e-4 / atol 1e-4; resizing atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.metrics import fid as jfid
from blurred_gan_tpu.metrics import inception as jinc
from blurred_gan_tpu.metrics import swd as jswd
from blurred_gan_tpu_torch.convert import inception_params_to_torch, random_conv_weights_to_torch
from blurred_gan_tpu_torch.metrics import fid, inception, swd
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: JAX's draws as pinned)
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(x), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.numpy(), (0, 2, 3, 1))


def images(seed, shape, smooth=False):
    """NHWC float32 in [-1, 1]; ``smooth`` low-passes the noise so the pyramid
    levels differ from white noise."""
    x = np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)
    if smooth:
        x = (x + np.roll(x, 1, 1) + np.roll(x, 1, 2) + np.roll(x, (1, 1), (1, 2))) / 4
    return x


def jax_positions(rng, level_shape, nhoods, nhood_size=swd.NHOOD_SIZE):
    """The draws of ``blurred_gan_tpu.metrics.swd.patch_descriptors``."""
    n_img, s_h, s_w = level_shape[0], level_shape[1], level_shape[2]
    half = nhood_size // 2
    n = n_img * nhoods
    kx, ky = jax.random.split(rng)
    x0 = jax.random.randint(kx, (n,), half, s_w - half) - half
    y0 = jax.random.randint(ky, (n,), half, s_h - half) - half
    return torch.from_numpy(np.asarray(y0)), torch.from_numpy(np.asarray(x0))


def jax_directions(rng, dim, repeats, per_repeat):
    """The draws of ``blurred_gan_tpu.metrics.swd.sliced_wasserstein_distance``."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (dim, per_repeat),
                                                                   jnp.float32))
                                      for k in jax.random.split(rng, repeats)]))


# ---------------------------------------------------------------------------
# SWD
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,levels", [((2, 32, 32, 3), 2), ((3, 64, 48, 1), 3)])
def test_laplacian_pyramid(shape, levels):
    x = images(0, shape)
    want = jswd.laplacian_pyramid(jnp.asarray(x), levels)
    got = swd.laplacian_pyramid(nchw(x), levels)
    assert len(got) == levels
    for g, w in zip(got, want):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=1e-5)


@pytest.mark.parametrize("res", [8, 16, 40, 128, 512])
def test_swd_resolutions(res):
    assert swd.swd_resolutions(res) == jswd.swd_resolutions(res)


def test_patch_descriptors_exact():
    level = images(1, (3, 16, 20, 3))
    rng = jax.random.PRNGKey(5)
    want = jswd.patch_descriptors(jnp.asarray(level), rng, 7, 16)
    got = swd.patch_descriptors(nchw(level), jax_positions(rng, level.shape, 16), 7, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_finalize_descriptors():
    desc = np.random.RandomState(2).normal(0.3, 2.0, (500, 3 * 49)).astype(np.float32)
    want = jswd.finalize_descriptors(jnp.asarray(desc), 3)
    got = swd.finalize_descriptors(torch.from_numpy(desc), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_sliced_wasserstein_distance_pinned_directions():
    rs = np.random.RandomState(3)
    a = rs.normal(0, 1, (512, 48)).astype(np.float32)
    b = rs.normal(0.2, 1.3, (512, 48)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    want = float(jswd.sliced_wasserstein_distance(jnp.asarray(a), jnp.asarray(b), rng, 4, 32))
    got = float(swd.sliced_wasserstein_distance(torch.from_numpy(a), torch.from_numpy(b),
                                                jax_directions(rng, 48, 4, 32)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


class PinnedSWD(swd.SWDMetric):
    """The port's SWDMetric drawing exactly what the JAX SWDMetric draws."""

    def draw_positions(self, update, side, lod, level_shape):
        k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(self.seed), update))[side]
        key = jax.random.split(k, len(self.resolutions))[lod]
        n, c, h, w = level_shape
        return jax_positions(key, (n, h, w, c), self.nhoods_per_image, self.nhood_size)

    def draw_directions(self, lod, dim, stream=10_000):
        rng = jax.random.fold_in(jax.random.PRNGKey(self.seed), stream + lod)
        return jax_directions(rng, dim, self.dir_repeats, self.dirs_per_repeat)


def swd_pairs(n_batches=2, batch=4, shape=(32, 32, 3)):
    return [(images(10 + i, (batch, *shape), smooth=True), images(20 + i, (batch, *shape)))
            for i in range(n_batches)]


def test_swd_metric_end_to_end_pinned():
    kw = dict(nhoods_per_image=16, dir_repeats=2, dirs_per_repeat=32, seed=3)
    jm, pm = jswd.SWDMetric(**kw), PinnedSWD(**kw)
    for r, f in swd_pairs():
        jm.update_state(jnp.asarray(r), jnp.asarray(f))
        pm.update_state(nchw(r), nchw(f))
    want, got = jm.results(), pm.results()
    assert list(got) == list(want) == ["SWDx1e3_32", "SWDx1e3_16", "SWDx1e3_avg"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_swd_own_draws_within_the_jax_seed_spread():
    """Unpinned, the port draws with torch.Generator: its SWD is another
    sample of the same estimator, so it lands within the spread the JAX
    metric shows over seeds on the same images."""
    kw = dict(nhoods_per_image=32, dir_repeats=2, dirs_per_repeat=64)
    pairs = swd_pairs(n_batches=2, batch=8)
    jax_values = []
    for seed in range(5):
        m = jswd.SWDMetric(seed=seed, **kw)
        for r, f in pairs:
            m.update_state(jnp.asarray(r), jnp.asarray(f))
        jax_values.append(m.result())
    m = swd.SWDMetric(seed=0, **kw)
    for r, f in pairs:
        m.update_state(nchw(r), nchw(f))
    spread = max(jax_values) - min(jax_values)
    assert spread > 0
    assert abs(m.result() - np.mean(jax_values)) <= spread, (m.result(), jax_values)


def test_swd_metric_reset_frees_the_banks():
    m = swd.SWDMetric(nhoods_per_image=8, dir_repeats=1, dirs_per_repeat=8)
    for r, f in swd_pairs(n_batches=1):
        m.update_state(nchw(r), nchw(f))
    first = m.results()
    assert all(len(b) == 1 for b in m.real_descriptors + m.fake_descriptors)
    m.reset_states()
    assert all(len(b) == 0 for b in m.real_descriptors + m.fake_descriptors)
    assert np.isfinite(list(first.values())).all()


def test_swdapi_protocol():
    api = swd.SWDAPI((3, 32, 32), seed=1)
    assert api.get_metric_names() == ["SWDx1e3_32", "SWDx1e3_16", "SWDx1e3_avg"]
    for mode, k in (("reals", 0), ("fakes", 1)):
        api.begin(mode)
        for r, f in swd_pairs():
            api.feed(mode, nchw((r, f)[k]))
        out = api.end(mode)
        assert len(out) == 3 and np.isfinite(out).all()
    assert out[-1] == pytest.approx(np.mean(out[:-1]))


# ---------------------------------------------------------------------------
# FID
# ---------------------------------------------------------------------------


def test_frechet_distance():
    rs = np.random.RandomState(4)
    a, b = rs.normal(0, 1, (40, 6)), rs.normal(0.5, 1.5, (40, 6))
    mu1, s1, mu2, s2 = a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False)
    np.testing.assert_allclose(fid.frechet_distance(mu1, s1, mu2, s2),
                               jfid.frechet_distance(mu1, s1, mu2, s2), rtol=1e-10)
    np.testing.assert_allclose(fid.calculate_fid(a, b), jfid.calculate_fid(a, b), rtol=1e-10)


def test_feature_stats():
    rs = np.random.RandomState(5)
    batches = [rs.normal(3.0, 0.5, (16, 8)).astype(np.float32) for _ in range(4)]
    mine, ref = fid.FeatureStats(8), jfid.FeatureStats(8)
    for b in batches:
        mine.update(torch.from_numpy(b))
        ref.update(jnp.asarray(b))
    (mu, sig), (jmu, jsig) = mine.finalize(), ref.finalize()
    np.testing.assert_allclose(mu, jmu, rtol=1e-5)
    np.testing.assert_allclose(sig, jsig, rtol=1e-5, atol=1e-7)
    allx = np.concatenate(batches).astype(np.float64)
    np.testing.assert_allclose(sig, np.cov(allx, rowvar=False), rtol=1e-4, atol=1e-6)


def test_merge_feature_moments_equals_the_union():
    rs = np.random.RandomState(6)
    parts = [rs.normal(1.0, 2.0, (n, 5)).astype(np.float32) for n in (10, 7, 13)]
    moments = []
    for p in parts:
        s = fid.FeatureStats(5)
        s.update(torch.from_numpy(p))
        moments.append(s.moments())
    n, mu, sig = fid.merge_feature_moments(moments)
    jn, jmu, jsig = jfid.merge_feature_moments(moments)
    assert n == jn == 30
    np.testing.assert_allclose(mu, jmu, rtol=1e-12)
    np.testing.assert_allclose(sig, jsig, rtol=1e-12)
    whole = np.concatenate(parts).astype(np.float64)
    np.testing.assert_allclose(sig, np.cov(whole, rowvar=False), rtol=1e-5, atol=1e-6)


def jax_random_conv_weights(image_shape, dim, seed):
    """The draws of ``blurred_gan_tpu.metrics.fid.random_conv_features``."""
    ks = jax.random.split(jax.random.PRNGKey(seed), 6)
    kernels, in_c = [], image_shape[2]
    for i, out_c in enumerate(fid.RANDOM_CONV_WIDTHS):
        k = jax.random.normal(ks[i], (5, 5, in_c, out_c), jnp.float32)
        kernels.append(np.asarray(k * np.sqrt(2.0 / (25 * in_c))))
        in_c = out_c
    proj = np.asarray(jax.random.normal(ks[5], (in_c, dim), jnp.float32) / np.sqrt(in_c))
    return kernels, proj


@pytest.mark.parametrize("shape", [(16, 16, 3), (28, 28, 1)])
def test_random_conv_features_with_carried_weights(shape):
    """At 28 the SAME padding of the stride-2 convs is (1, 2) on the even
    sides (28, 14) and (2, 2) on the odd one (7)."""
    x = images(7, (4, *shape))
    want = jfid.random_conv_features(shape, dim=256, seed=2)(jnp.asarray(x))
    weights = random_conv_weights_to_torch(*jax_random_conv_weights(shape, 256, 2))
    got = fid.random_conv_features((shape[2], *shape[:2]), dim=256, weights=weights)(nchw(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)


def test_random_conv_features_default_draws():
    f = fid.random_conv_features((3, 16, 16), dim=64, seed=0)
    x = nchw(images(8, (2, 16, 16, 3)))
    out = f(x)
    assert out.shape == (2, 64) and torch.isfinite(out).all()
    torch.testing.assert_close(fid.random_conv_features((3, 16, 16), dim=64, seed=0)(x), out,
                               rtol=0, atol=0)


def test_fid_metric():
    shape = (16, 16, 3)
    jm = jfid.FIDMetric(feature_fn=jfid.random_conv_features(shape, dim=16, seed=1))
    weights = random_conv_weights_to_torch(*jax_random_conv_weights(shape, 16, 1))
    pm = fid.FIDMetric(feature_fn=fid.random_conv_features((3, 16, 16), dim=16, weights=weights))
    for i in range(4):
        r, f = images(30 + i, (16, *shape), smooth=True), images(40 + i, (16, *shape))
        jm.update_state(jnp.asarray(r), jnp.asarray(f))
        pm.update_state(nchw(r), nchw(f))
    want, got = jm.result(), pm.result()
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-3)
    pm.reset_states()
    assert pm._real.n == 0


@pytest.mark.parametrize("shape,size", [((2, 16, 16, 3), 32), ((2, 17, 23, 1), 40),
                                        ((2, 64, 64, 3), 24), ((1, 50, 50, 3), 29)])
def test_inception_preprocess_enlarge_and_shrink(shape, size):
    x = images(9, shape)
    want = jfid.inception_preprocess(jnp.asarray(x), size)
    got = fid.inception_preprocess(nchw(x), size)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# Inception
# ---------------------------------------------------------------------------


def test_conv_specs_match():
    assert inception.conv_specs() == jinc.conv_specs()


def test_inception_trunk_with_carried_weights():
    jparams = jax.tree_util.tree_map(np.asarray, jinc.random_inception_params(0))
    x = images(11, (2, 75, 75, 3))
    want = jinc.inception_features(jparams, jnp.asarray(x))
    got = inception.inception_features(inception_params_to_torch(jparams), nchw(x))
    assert got.shape == (2, inception.FEATURE_DIM)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_inception_npz_round_trip(tmp_path):
    params = inception.random_inception_params(3)
    path = str(tmp_path / "inception_v3.npz")
    inception.save_inception_weights(params, path)
    # The file is in the JAX package's layout: its loader reads it.
    jparams = jinc.load_inception_weights(path)
    np.testing.assert_array_equal(np.asarray(jparams["Mixed_6b/branch7x7_2"]["w"]),
                                  params["Mixed_6b/branch7x7_2"]["w"].numpy()
                                  .transpose(2, 3, 1, 0))
    back = inception.load_inception_weights(path)
    assert back.keys() == params.keys()
    for scope, unit in params.items():
        for field, t in unit.items():
            torch.testing.assert_close(back[scope][field], t, rtol=0, atol=0)
    flat = dict(np.load(path))
    flat["Conv2d_1a_3x3/w"] = flat["Conv2d_1a_3x3/w"][:, :, :, :8]
    np.savez(tmp_path / "bad.npz", **flat)
    with pytest.raises(ValueError, match="Conv2d_1a_3x3/w"):
        inception.load_inception_weights(str(tmp_path / "bad.npz"))
    del flat["Conv2d_1a_3x3/w"]
    np.savez(tmp_path / "missing.npz", **flat)
    with pytest.raises(KeyError, match="missing"):
        inception.load_inception_weights(str(tmp_path / "missing.npz"))


def test_inception_feature_fn_says_it_uses_random_weights(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path))
    assert inception.find_local_weights() is None
    extract = inception.inception_feature_fn(resize_to=None)
    assert "FIXED-SEED RANDOM weights" in capsys.readouterr().out
    out = extract(nchw(images(12, (2, 75, 75, 1))))
    assert out.shape == (2, 2048) and torch.isfinite(out).all()
    with pytest.raises(FileNotFoundError):
        inception.inception_feature_fn(allow_random_fallback=False)
    path = tmp_path / "inception_v3.npz"
    path.write_bytes(b"")
    assert inception.find_local_weights() == str(path)
