"""``python -m blurred_gan_tpu_torch.quality evaluate`` against the scoring of
``benchmarks/quality_parity.py`` and the repo root's ``quality_torch_score.py``.

- The held-out reals are the JAX scorer's, byte for byte.
- The row's assembly: with every metric given the JAX package's draws (SWD's
  patch positions and projections through ``test_torch_metrics.PinnedSWD``,
  the random-conv extractors' weights through
  ``convert.random_conv_weights_to_torch``), the port's row equals
  ``quality_torch_score.make_scorer``'s on 100 samples of a 32² surface: the
  same keys (each row's ``stack`` its own), SWD and FID at rtol 1e-3 (the
  metrics' own tolerances in ``test_torch_metrics.py``) plus a unit of the
  row's rounding, PRDC and KID to the row's rounding
  (``test_torch_kid_prdc.py``: equal counts, KID at rtol 1e-5). Both sides
  at the reductions of ``test_torch_quality.py`` (SWD 16 patches an image, 8
  projections; FID over 32 features; PRDC and KID over 64); the Inception
  column's trunk is replaced on both sides by a second random-conv
  extractor (``test_torch_metrics.py`` holds the trunk itself to JAX's).
- The per-seed gaps and pooled statistics equal ``quality_parity``'s on the
  same rows, and the CLI prints them.
- Rows of two metric stacks are never merged, gapped or pooled.
"""

import functools
import json

import jax
import numpy as np
import pytest
import torch

import blurred_gan_tpu.metrics as jax_metrics
from blurred_gan_tpu.metrics import fid as jfid
from blurred_gan_tpu_torch import quality
from blurred_gan_tpu_torch.convert import random_conv_weights_to_torch
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.metrics.fid import random_conv_features
from test_torch_metrics import PinnedSWD, jax_random_conv_weights
from test_torch_quality import qp, qts
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: JAX's draws as pinned)

SHAPE = (32, 32, 3)
N = 100
SWD_KW = dict(nhoods_per_image=16, dir_repeats=1, dirs_per_repeat=8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def small_corpus(image_shape, n):
    return synthetic_dataset(image_shape, num_examples=n)


@pytest.fixture
def small_surface(monkeypatch):
    """A 32² surface of 300 images and 100 held-out reals on both sides."""
    cfg = quality.ParityConfig("tiny", SHAPE, 300, 5.0)
    monkeypatch.setattr(quality, "corpus", lambda c: small_corpus(c.image_shape, c.corpus_n))
    monkeypatch.setattr(quality, "N_EVAL", N)
    monkeypatch.setattr(qp, "N_EVAL", N)
    return cfg


def test_held_out_reals_are_the_jax_scorers(small_surface):
    for mine, theirs in zip(quality.held_out_reals(small_surface),
                            qts.held_out_reals(qp.ParityConfig("tiny", SHAPE, 300, 5.0))):
        assert mine.shape == (N, *SHAPE) and mine.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)


def carried(dim, seed):
    return random_conv_weights_to_torch(*jax_random_conv_weights(SHAPE, dim, seed))


def assert_rows_close(mine, theirs):
    assert mine.pop("stack") == "torch-cpu" and theirs.pop("stack") == "jax"
    assert set(mine) == set(theirs) and mine["samples"] == theirs["samples"]
    for k, want in theirs.items():
        got = mine[k]
        if k.startswith(("SWD", "fid")):
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=k)
        elif k in ("kid", "kid_std"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=k)
        elif k != "samples":  # PRDC, 4 places
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=k)


def test_row_is_the_jax_scorers_with_the_jax_draws(small_surface, monkeypatch, capsys):
    monkeypatch.setattr(jax_metrics, "FIDMetric",
                        functools.partial(jax_metrics.FIDMetric, feature_dim=32))
    monkeypatch.setattr(jax_metrics, "SWDMetric",
                        functools.partial(jax_metrics.SWDMetric, **SWD_KW))
    for name in ("kid_from_images", "prdc_from_images"):
        monkeypatch.setattr(jax_metrics, name,
                            functools.partial(getattr(jax_metrics, name), feature_dim=64))
    monkeypatch.setattr(jax_metrics, "inception_feature_fn",
                        lambda resize_to: jfid.random_conv_features(SHAPE, dim=32, seed=7))
    reals, reals_b = quality.held_out_reals(small_surface)
    fakes = np.tanh(np.random.RandomState(0).standard_normal((N, *SHAPE))).astype(np.float32)
    theirs = qts.make_scorer(reals, use_inception=True)
    shape = (SHAPE[2], *SHAPE[:2])
    mine = quality.make_scorer(
        reals, "cpu", swd_metric=functools.partial(PinnedSWD, **SWD_KW),
        extractor=random_conv_features(shape, dim=64, weights=carried(64, 0)),
        fid_extractors={
            "fid_randconv": random_conv_features(shape, dim=32, weights=carried(32, 0)),
            "fid_inception": random_conv_features(shape, dim=32, weights=carried(32, 7))})
    for name, images in (("reals_vs_reals", reals_b), ("torch_s0", fakes)):
        want = theirs(name, images)
        got = mine(name, images)
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == got
        assert len(want) == 13 and want["SWDx1e3_avg"] > 0 and want["fid_randconv"] > 0
        assert_rows_close(got, want)


def rows_of(seeds, arms, stack="torch-cpu"):
    rng = np.random.RandomState(3)
    return {f"{arm}_s{seed}": {"samples": f"{arm}_s{seed}", "SWDx1e3_32": rng.uniform(10, 90),
                               "SWDx1e3_avg": rng.uniform(10, 90), "fid_randconv": rng.uniform(1, 9),
                               "kid": float(rng.uniform(-1e-3, 1e-2)), "kid_std": 0.001,
                               "precision": 0.5, "stack": stack}
            for seed in seeds for arm in arms}


def test_gaps_and_pooled_statistics_are_quality_paritys():
    rows = rows_of(range(6), ("torch", "torch_d2", "torch_refscale"))
    rows["torch_d2_s2"]["fid_randconv"] = rows["torch_s2"]["fid_randconv"]  # a tie
    del rows["torch_refscale_s5"]
    for arm in ("torch_d2", "torch_refscale"):
        assert quality.pooled_stats(rows, range(6), "torch", arm) == qp._pooled_stats(
            rows, range(6), "torch", arm)
    assert quality.pooled_stats(rows, [0, 5], "torch", "torch_refscale") is None
    a, b = rows["torch_s1"], rows["torch_d2_s1"]
    want = {k: round((b[k] - a[k]) / abs(a[k]), 4) for k in a
            if qp._is_quality_metric(k) and a[k] != 0}
    assert quality.rel_gaps(a, b) == want == qts.rel_gaps(a, b)
    assert set(want) == {"SWDx1e3_32", "SWDx1e3_avg", "fid_randconv", "kid"}


def test_mixed_stacks_are_refused(tmp_path):
    rows = rows_of(range(3), ("torch", "torch_d2"))
    rows["torch_d2_s1"]["stack"] = "torch-cuda"
    with pytest.raises(ValueError, match="stacks"):
        quality.pooled_stats(rows, range(3), "torch", "torch_d2")
    with pytest.raises(ValueError, match="stacks"):
        quality.rel_gaps(rows["torch_s1"], rows["torch_d2_s1"])
    jax_row = dict(rows["torch_s2"], samples="torch_s2")
    del jax_row["stack"]  # a recorded JAX row carries no stack
    path = tmp_path / "recorded.jsonl"
    path.write_text("[fid] a note\n" + json.dumps(jax_row) + "\n")
    merged = {"reals_floor": rows["torch_s0"]}
    with pytest.raises(ValueError, match="'jax' stack"):
        quality.merge_recorded_rows(merged, [str(path)], "torch-cpu")
    quality.merge_recorded_rows(merged, [str(path)], "jax")
    assert quality.row_stack(merged["torch_s2"]) == "jax"


def test_cli_scores_every_arm_then_gaps_and_pools(tmp_path, small_surface, monkeypatch,
                                                    capsys):
    """``evaluate`` through ``main``: every arm's set of each seed scored
    (here by a stub row of the set's mean), a missing plain run reported,
    earlier rows merged, then the gaps and the pooled statistics."""
    monkeypatch.setattr(quality, "CONFIGS", {"tiny": small_surface})

    def stub_scorer(reals, device, **kw):
        assert device.type == "cpu" and kw == {"use_inception": False, "inception_size": 75}

        def score(name, fakes):
            v = float(np.abs(fakes - reals[:len(fakes)].mean()).mean())
            row = {"samples": name, "SWDx1e3_avg": 100 * v, "fid_randconv": 10 * v,
                   "kid": v / 10, "stack": "torch-cpu"}
            print(json.dumps(row))
            return row
        return score

    monkeypatch.setattr(quality, "make_scorer", stub_scorer)
    rng = np.random.RandomState(1)
    for seed in (0, 1):
        for arm in ("torch", "torch_d2"):
            np.savez(tmp_path / f"{arm}_samples_s{seed}.npz",
                     samples=rng.uniform(-1, 1, (N, *SHAPE)).astype(np.float32))
    earlier = rows_of([2], ("torch", "torch_d2"))
    (tmp_path / "earlier.jsonl").write_text("\n".join(json.dumps(r) for r in earlier.values()))
    rows = quality.main(["evaluate", "--config", "tiny", "--dir", str(tmp_path), "--seeds",
                         "0,1,2,3", "--device", "cpu", "--no-inception", "--pool",
                         "--rows_from", str(tmp_path / "earlier.jsonl")])
    assert list(rows) == ["reals_floor", "torch_s0", "torch_d2_s0", "torch_s1",
                          "torch_d2_s1", "torch_s2", "torch_d2_s2"]
    lines = [json.loads(x) if x.startswith("{") else x
             for x in capsys.readouterr().out.strip().splitlines()]
    assert any(isinstance(x, str) and "torch_samples_s3.npz missing" in x for x in lines)
    gaps = [x for x in lines if isinstance(x, dict) and "rel_gap_torch_d2_vs_torch" in x]
    assert [g["seed"] for g in gaps] == [0, 1, 2]
    assert gaps[0]["rel_gap_torch_d2_vs_torch"] == qts.rel_gaps(rows["torch_s0"],
                                                                rows["torch_d2_s0"])
    (pooled,) = [x for x in lines if isinstance(x, dict) and "pooled" in x]
    assert pooled == qp._pooled_stats(rows, [0, 1, 2, 3], "torch", "torch_d2")
    assert pooled["n_paired_seeds"] == 3
