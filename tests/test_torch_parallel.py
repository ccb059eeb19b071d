"""The port's data parallelism (``runtime.py``, ``parallel.py`` and the
multi-process paths of the step, the Trainer, the metrics, the checkpoints
and the entry points) on the CPU over gloo.

Two processes (``tests/torch_parallel_pool.py``, one group for the module)
run every case; this process runs the same case without a group as the
one-process reference at the global batch, and holds both against the JAX
package:

- shards: each store's ``batches`` and ``DataPipeline`` with
  ``shard_index`` / ``shard_count`` byte-equal to the JAX package's;
- two processes at batch 8 against one process at batch 16, from the same
  weights and seed, the processes' reals concatenated, dropout on: the
  default step, lazy GP with ``d_steps_per_g_step``, EMA, flip and
  ``grad_accumulation_steps`` 2. After one step the metrics, the gradients
  handed to the optimizers and the BatchNorm running statistics at
  ``tests/test_parallel.py``'s rtol 2e-4 / atol 2e-5, the parameters at the
  same tolerance where the gradient is at least ``GRAD_FLOOR`` (Adam's first
  update is ``-lr·g/(|g| + 1e-7)``, about ``-lr·sign(g)``, so an element
  whose gradient is within rounding of zero may move by ``lr`` either way,
  ``tests/test_torch_step.py``); after three steps the losses at rel 1e-3 /
  abs 1e-4 (``test_parallel.py``'s multi-step bound), and the statistics,
  the parameters and the average at rel 1e-3 / abs 1e-4 where every step's
  gradient is at least ``GRAD_FLOOR``;
- two processes against the JAX step sharded over a 2-device mesh, the
  weights carried by ``convert.flax_to_torch``, dropout off and the JAX
  step's draws pinned through ``noise`` (``tests/torch_variant_harness.py``),
  at ``tests/test_torch_step.py``'s tolerances;
- the FID and SWD merges across processes against one metric over the union
  (rtol 1e-6 and 1e-5), and the port's merges against the JAX package's on
  the same arrays (``tests/test_torch_metrics.py``'s rtol 1e-3);
- the Trainer: one checkpoint write per save, by rank 0; a two-process
  resume bit-equal on both; ``fit_device_resident`` refused; ``evaluate``
  merged;
- a group of one bit-equal to no group;
- ``train_mnist`` under ``torch.distributed.run --nproc_per_node 2 --device
  cpu``; ``python -m blurred_gan_tpu_torch.dryrun --n 2``.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from blurred_gan_tpu.data import pipeline as jpipe
from blurred_gan_tpu.metrics import fid as jfid
from blurred_gan_tpu.metrics import swd as jswd
from blurred_gan_tpu.train.state import create_train_state as jax_state
from blurred_gan_tpu.train.step import make_train_step as jax_step
from blurred_gan_tpu_torch.convert import flax_to_torch
from blurred_gan_tpu_torch.data import pipeline as ppipe
from blurred_gan_tpu_torch.metrics import fid as pfid
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from torch_parallel_pool import Pool, dp_run, free_port
from torch_variant_harness import (
    KEY0, LATENT, LOSS, RES, SIGMA, assert_bn_stats_close, assert_grads_close,
    assert_post_step_close, jax_draws, jax_gan, jax_grads, jax_hparams, reals_batches,
    torch_gan)
from test_torch_metrics import PinnedSWD, nchw, swd_pairs
from test_torch_step import D_CHANNELS, G_KW, GRAD_FLOOR
from torch_jax_state import threefry_prng  # noqa: F401  (autouse: JAX's draws as pinned)
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, GLOBAL_BATCH = 2, 16
ONE_STEP = dict(rtol=2e-4, atol=2e-5)    # tests/test_parallel.py
THREE_STEPS = dict(rtol=1e-3, atol=1e-4)  # test_parallel.py's multi-step bound
VARIANTS = {"default": {}, "lazy_gp_d_steps": {"gp_every_n_steps": 2, "d_steps_per_g_step": 2},
            "ema": {"ema_decay": 0.9}, "flip": {"flip_augment": True},
            "accum_2": {"grad_accumulation_steps": 2}}


@pytest.fixture(scope="module")
def pool():
    p = Pool(WORLD)
    yield p
    p.close()


# ---------------------------------------------------------------------------
# Shards
# ---------------------------------------------------------------------------

SHARDS = [(0, 2), (1, 2), (0, 3), (2, 3)]
POSITIONS = [(0, 0, 0), (3, 1, 2)]  # (seed, start_epoch, start_batch)


@functools.lru_cache(maxsize=None)
def stores(tmp: str):
    """(port store, JAX store) pairs over one 50-image corpus: the array,
    its shard store and a folder of its PNGs."""
    from PIL import Image

    images = np.random.RandomState(4).randint(0, 256, (50, 8, 8, 3)).astype(np.uint8)
    folder = os.path.join(tmp, "folder")
    os.makedirs(folder)
    for i, im in enumerate(images):
        Image.fromarray(im).save(os.path.join(folder, f"{i:04d}.png"))
    ppipe.write_shards(images, os.path.join(tmp, "pshards"), shard_size=16, progress=False)
    jpipe.write_shards(images, os.path.join(tmp, "jshards"), shard_size=16, progress=False)
    return {"array": (ppipe.ArrayDataset(images), jpipe.ArrayDataset(images)),
            "shards": (ppipe.ShardedArrayDataset(os.path.join(tmp, "pshards")),
                       jpipe.ShardedArrayDataset(os.path.join(tmp, "jshards"))),
            "folder": (ppipe.ImageFolderDataset(folder, 8), jpipe.ImageFolderDataset(folder, 8))}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return stores(str(tmp_path_factory.mktemp("corpus")))


@pytest.mark.parametrize("store", ["array", "shards", "folder", "pipeline"])
@pytest.mark.parametrize("shard_index,shard_count", SHARDS)
def test_shards_byte_equal_to_jax(corpus, store, shard_index, shard_count):
    for seed, epoch, batch in POSITIONS:
        kw = dict(seed=seed, start_epoch=epoch, start_batch=batch, shard_index=shard_index,
                  shard_count=shard_count)
        if store == "pipeline":
            port = iter(ppipe.DataPipeline(corpus["array"][0], 4, **kw))
            jax_ = iter(jpipe.DataPipeline(corpus["array"][1], 4, **kw))
        else:
            port = corpus[store][0].batches(4, **kw)
            jax_ = corpus[store][1].batches(4, **kw)
        for _ in range(6):  # crosses an epoch: each shard holds 3 or 4 batches
            assert next(port).tobytes() == next(jax_).tobytes(), (seed, epoch, batch)


def test_too_small_a_shard_raises_as_jax():
    images = np.zeros((10, 4, 4, 1), np.uint8)
    for batches in (ppipe.ArrayDataset(images).batches, jpipe.ArrayDataset(images).batches):
        with pytest.raises(ValueError, match=r"exceeds this shard's 3 examples \(num_examples=10, "
                                             r"shard_count=3\)"):
            next(batches(4, shard_index=1, shard_count=3))


# ---------------------------------------------------------------------------
# Two processes against one
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def runs(pool, name):
    """(each rank's run, the one-process run) of 3 steps of ``name``."""
    kw = dict(hparams=VARIANTS[name], steps=3, global_batch=GLOBAL_BATCH)
    return pool.run("dp_run", **kw), dp_run(**kw)


def check_state(got, want, grads_seen, tol, step):
    """Both networks' state after ``step`` (0-based): parameters where every
    gradient so far is at least GRAD_FLOOR, BatchNorm buffers whole."""
    checked = total = 0
    for net, key in (("generator", "g"), ("critic", "d")):
        for name, w in want[net][step].items():
            g = got[net][step][name]
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(g, w, err_msg=f"{net}.{name}", **tol)
                continue
            mask = np.ones(w.shape, bool)
            for grads in grads_seen:
                if key in grads:
                    idx = [n for n in want[net][step] if not n.endswith(("running_mean",
                                                                          "running_var"))]
                    mask &= np.abs(grads[key][idx.index(name)]) >= GRAD_FLOOR
            np.testing.assert_allclose(g[mask], w[mask], err_msg=f"{net}.{name}", **tol)
            checked += int(mask.sum())
            total += mask.size
    assert checked > 0.8 * total, (checked, total)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_two_processes_one_step_match_one_process(pool, name):
    ranks, want = runs(pool, name)
    for got in ranks:
        for k, v in want["metrics"][0].items():
            np.testing.assert_allclose(got["metrics"][0][k], v, err_msg=k, **ONE_STEP)
        for net in want["grads"][0]:
            for a, b in zip(got["grads"][0][net], want["grads"][0][net]):
                np.testing.assert_allclose(a, b, err_msg=net, **ONE_STEP)
        check_state(got, want, want["grads"][:1], ONE_STEP, 0)
    # Every process holds the same state, and fakes of its own rows.
    for net in ("generator", "critic"):
        for k, v in ranks[0][net][0].items():
            assert np.array_equal(ranks[1][net][0][k], v), k
    assert ranks[0]["fakes_rows"] == GLOBAL_BATCH // WORLD


@pytest.mark.parametrize("name", list(VARIANTS))
def test_two_processes_three_steps_match_one_process(pool, name):
    ranks, want = runs(pool, name)
    for got in ranks:
        for step in range(3):
            for k in ("disc_loss", "gen_loss", "wgan_loss", "gp_term", "did_gen_step", "std"):
                np.testing.assert_allclose(got["metrics"][step][k], want["metrics"][step][k],
                                           err_msg=f"step {step + 1} {k}", **THREE_STEPS)
        check_state(got, want, want["grads"], THREE_STEPS, 2)
        for a, b in zip(got["ema"][2], want["ema"][2]):
            np.testing.assert_allclose(a, b, **THREE_STEPS)
        assert (got["n_img"], got["n_batches"]) == (want["n_img"], want["n_batches"]) \
            == (3 * GLOBAL_BATCH, 3)


def test_a_group_of_one_is_bit_equal_to_no_group():
    kw = dict(hparams={}, steps=2, global_batch=8)
    want = dp_run(**kw)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        got = dp_run(**kw)
    finally:
        dist.destroy_process_group()
    assert got["metrics"] == want["metrics"]
    for net in ("generator", "critic"):
        for step in range(2):
            for k, v in want[net][step].items():
                assert np.array_equal(got[net][step][k], v), (net, step, k)


# ---------------------------------------------------------------------------
# Two processes against the JAX sharded step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_parity(pool):
    hp = jax_hparams()
    jgan = jax_gan()
    state0 = jax.tree_util.tree_map(
        np.asarray, jax_state(jgan, hp, jax.random.PRNGKey(3), (RES, RES, 3)))
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    key = jax.random.PRNGKey(KEY0)
    reals = reals_batches(1)[0]
    state1, jmetrics, _ = jax_step(jgan, hp, mesh=mesh, donate_state=False)(
        state0, jnp.asarray(reals), jnp.float32(SIGMA), key)
    state1 = jax.tree_util.tree_map(np.asarray, state1)
    draws = jax_draws(key, flip=False)
    port = torch_gan()
    flax_to_torch(port.generator, state0.g_params, state0.g_stats)
    flax_to_torch(port.discriminator, state0.d_params)
    ranks = pool.run("jax_parity_step", g_kw=G_KW, d_channels=D_CHANNELS, latent=LATENT,
                     generator={k: v.numpy() for k, v in port.generator.state_dict().items()},
                     critic={k: v.numpy() for k, v in port.discriminator.state_dict().items()},
                     reals=reals, noise=draws, sigma=SIGMA)
    return dict(ranks=ranks, jmetrics={k: float(v) for k, v in jmetrics.items()},
                state0=state0, state1=state1, reals=reals, draws=draws)


def _loaded(result):
    gan = torch_gan()
    gan.generator.load_state_dict({k: torch.from_numpy(v) for k, v in result["generator"].items()})
    gan.discriminator.load_state_dict({k: torch.from_numpy(v)
                                       for k, v in result["critic"].items()})
    return gan


@pytest.mark.parametrize("rank", range(WORLD))
def test_two_processes_match_the_jax_sharded_step(jax_parity, rank):
    got = jax_parity["ranks"][rank]
    for k in ("disc_loss", "gen_loss", "wgan_loss", "gp_term", "norm_term", "fake_scores",
              "real_scores", "std"):
        np.testing.assert_allclose(got["metrics"][k], jax_parity["jmetrics"][k], err_msg=k,
                                   **LOSS)
    want = jax_grads(jax_parity["state0"], jax_parity["state1"], jax_parity["reals"],
                     jax_parity["draws"], gp_coefficient=10.0, with_gp=True)
    gan = _loaded(got)
    assert_grads_close(gan.discriminator, got["grads"]["d"], want["d"])
    assert_grads_close(gan.generator, got["grads"]["g"], want["g"])
    assert_post_step_close(gan.discriminator, jax_parity["state1"].d_params, want["d"])
    assert_post_step_close(gan.generator, jax_parity["state1"].g_params, want["g"])
    assert_bn_stats_close(gan.generator, jax_parity["state1"].g_stats)


# ---------------------------------------------------------------------------
# Metric merges
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def merged(pool):
    rng = np.random.RandomState(1)
    real_feats = (rng.randn(128, 8)).astype(np.float32)
    fake_feats = (rng.randn(128, 8) + 0.7).astype(np.float32)
    pairs = swd_pairs(n_batches=WORLD)
    reals = np.concatenate([nchw(r).numpy() for r, _ in pairs])
    fakes = np.concatenate([nchw(f).numpy() for _, f in pairs])
    ranks = pool.run("metric_merge", real_feats=real_feats, fake_feats=fake_feats, reals=reals,
                     fakes=fakes)
    return dict(ranks=ranks, real_feats=real_feats, fake_feats=fake_feats, reals=reals,
                fakes=fakes)


def test_merged_fid_equals_the_union(merged):
    ident = lambda x: x.reshape(x.shape[0], -1)  # noqa: E731
    union = pfid.FIDMetric(feature_fn=ident)
    union.update_state(torch.from_numpy(merged["real_feats"])[:, :, None, None],
                       torch.from_numpy(merged["fake_feats"])[:, :, None, None])
    for got in merged["ranks"]:
        np.testing.assert_allclose(got["fid"], union.result(), rtol=1e-6)


def test_merged_swd_equals_the_union(merged):
    union = SWDMetric(nhoods_per_image=16, dir_repeats=2, dirs_per_repeat=32, seed=3)
    n = merged["reals"].shape[0] // WORLD
    for r in range(WORLD):
        union.update_state(torch.from_numpy(merged["reals"][r * n:(r + 1) * n]),
                           torch.from_numpy(merged["fakes"][r * n:(r + 1) * n]))
    want = union.results()
    for got in merged["ranks"]:
        assert list(got["swd"]) == list(want)
        for k, v in want.items():
            np.testing.assert_allclose(got["swd"][k], v, rtol=1e-5, err_msg=k)


def _fake_allgather(others):
    """A two-process allgather for one process: its own array, then the
    next of ``others``'s (in the order the merge asks for them)."""
    queue = list(others)
    return lambda x: [np.asarray(x), np.asarray(queue.pop(0))]


def test_fid_merge_equals_the_jax_merge():
    rng = np.random.RandomState(2)
    halves = [((rng.randn(48, 8) + i * 0.3).astype(np.float32),
               (rng.randn(48, 8) + 1.0 - i * 0.2).astype(np.float32)) for i in range(2)]
    results = []
    for mod, wrap in ((pfid, lambda x: torch.from_numpy(x)[:, :, None, None]),
                      (jfid, lambda x: jnp.asarray(x)[:, :, None, None])):
        procs = [mod.FIDMetric(feature_fn=lambda x: x.reshape(x.shape[0], -1)) for _ in halves]
        for m, (r, f) in zip(procs, halves):
            m.update_state(wrap(r), wrap(f))
        others = [a for stats in (procs[1]._real, procs[1]._fake)
                  for a in (np.float64([stats.moments()[0]]), *stats.moments()[1:])]
        procs[0].cross_process_merge(_fake_allgather(others))
        results.append(procs[0].result())
    np.testing.assert_allclose(results[0], results[1], rtol=1e-3)


def test_swd_merge_equals_the_jax_merge():
    kw = dict(nhoods_per_image=16, dir_repeats=2, dirs_per_repeat=32, seed=3)
    (r1, f1), (r2, f2) = swd_pairs(n_batches=2)
    results = []
    for cls, wrap in ((PinnedSWD, nchw), (jswd.SWDMetric, jnp.asarray)):
        a, b = cls(**kw), cls(**kw)
        a.update_state(wrap(r1), wrap(f1))
        b.update_state(wrap(r1), wrap(f1))  # the second process's draws continue the first's
        b.reset_states()
        b.update_state(wrap(r2), wrap(f2))
        others = [np.asarray(torch.cat(d) if cls is PinnedSWD else jnp.concatenate(d))
                  for bank in (b.real_descriptors, b.fake_descriptors) for d in bank]
        a.cross_process_merge(_fake_allgather(others))
        results.append(a.results())
    for k, v in results[1].items():
        np.testing.assert_allclose(results[0][k], v, rtol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------
# The Trainer: checkpoints, resume, the chunked mode, evaluate
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_runs(pool, tmp_path_factory):
    log_dir = str(tmp_path_factory.mktemp("dp_run"))
    return log_dir, pool.run("trainer_case", log_dir=log_dir)


def test_checkpoint_written_once_by_rank_0(trainer_runs):
    log_dir, ranks = trainer_runs
    assert ranks[0]["writes"] == ["16.pt"] and ranks[1]["writes"] == []
    assert sorted(os.listdir(os.path.join(log_dir, "checkpoints"))) == ["16.pt"]
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        records = [line for line in f if '"batch_disc_loss"' in line]
    assert len(records) == 2  # one per step, from rank 0 alone
    # The grid hook fires at the first step and at 16 examples.
    assert sorted(n for n in os.listdir(log_dir) if n.endswith(".png")) == [
        "samples_grid_00000008.png", "samples_grid_00000016.png"]


def test_two_process_resume_is_bit_equal(trainer_runs):
    _, ranks = trainer_runs
    assert ranks[0]["restored_examples"] == ranks[1]["restored_examples"] == 16
    assert ranks[0]["live"] == ranks[0]["restored"] == ranks[1]["live"] == ranks[1]["restored"]
    assert ranks[0]["history"] == ranks[1]["history"]


def test_device_resident_mode_refuses_two_processes(trainer_runs):
    _, ranks = trainer_runs
    for got in ranks:
        assert "single-process" in got["refused"]


def test_evaluate_merges_across_processes(trainer_runs):
    _, ranks = trainer_runs
    assert ranks[0]["scores"] == ranks[1]["scores"]
    assert {"FID", "SWDx1e3_avg"} <= set(ranks[0]["scores"])


# ---------------------------------------------------------------------------
# The entry point and the dry run, in processes of their own
# ---------------------------------------------------------------------------

ENTRY = """
import runpy, sys
import blurred_gan_tpu_torch.utils.logging as logging_mod
logging_mod._summary_writer = lambda log_dir: None
sys.argv = ["train_mnist", *sys.argv[1:]]
runpy.run_module("blurred_gan_tpu_torch.train_mnist", run_name="__main__", alter_sys=True)
"""


def test_train_mnist_under_torch_distributed_run(tmp_path):
    from test_torch_mnist import write_mnist_npz

    npz = write_mnist_npz(tmp_path / "mnist.npz", 64)
    script = tmp_path / "entry.py"
    script.write_text(ENTRY)
    log_dir = tmp_path / "log"
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "2",
         "--master_port", str(free_port()), str(script), "--device", "cpu", "--batch_size",
         "4", "--max_steps", "2", "--mnist_path", str(npz), "--log_dir", str(log_dir)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("[train_mnist] ")]
    assert len(lines) == 1 and "bs=4 " in lines[0] and lines[0].endswith(
        "processes=2 global_bs=8"), lines
    assert [p.name for p in log_dir.rglob("events.jsonl")] == ["events.jsonl"]
    assert (log_dir / "checkpoints" / "16.pt").exists()


def test_dryrun_two_processes():
    out = subprocess.run([sys.executable, "-m", "blurred_gan_tpu_torch.dryrun", "--n", "2"],
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.count("all within rtol 2e-4 / atol 2e-5") == 2
