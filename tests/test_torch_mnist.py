"""The port's MNIST path and the entry points' device-resident flags on the CPU.

``load_mnist`` and ``ShardedArrayDataset.materialize`` are copies of the JAX
package's, held byte-equal to them. ``python -m
blurred_gan_tpu_torch.train_mnist`` and the CelebA entry point run a step each
way (``fit`` and ``--device_resident``) at small sizes, and their flag sets
equal the root scripts' less what the port leaves out. The root scripts are
read as source text, never imported: at import they change JAX's
configuration for every later test in the process.
"""

import argparse
import ast
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from blurred_gan_tpu.data import pipeline as jp
from blurred_gan_tpu.train.config import BlurredWGANGPHyperParameters as JaxHParams
from blurred_gan_tpu.train.config import TrainingConfig as JaxTrainingConfig
from blurred_gan_tpu_torch import train_celeba, train_mnist
from blurred_gan_tpu_torch.data import pipeline as tp
from blurred_gan_tpu_torch.metrics.swd import SWDMetric
from blurred_gan_tpu_torch.train.loop import MetricFeeder
from blurred_gan_tpu_torch.utils import logging as logging_mod

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


def write_mnist_npz(path, n_train=64, n_test=16, seed=0):
    rng = np.random.RandomState(seed)
    np.savez(path, x_train=rng.randint(0, 256, (n_train, 28, 28), dtype=np.uint8),
             y_train=rng.randint(0, 10, n_train), x_test=rng.randint(0, 256, (n_test, 28, 28),
                                                                       dtype=np.uint8),
             y_test=rng.randint(0, 10, n_test))
    return str(path)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_mnist_byte_equal_to_jax(tmp_path, split):
    path = write_mnist_npz(tmp_path / "mnist.npz")
    got = tp.load_mnist(path, split=split)
    want = jp.load_mnist(path, split=split)
    assert got.images.shape == want.images.shape == ((64 if split == "train" else 16), 28, 28, 1)
    assert got.images.dtype == np.uint8 and got.images.tobytes() == want.images.tobytes()
    assert got.name == want.name == "mnist"


def test_load_mnist_searches_datasets_dir(tmp_path, monkeypatch):
    write_mnist_npz(tmp_path / "mnist.npz", seed=3)
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path))
    assert tp.load_mnist().images.tobytes() == jp.load_mnist().images.tobytes()


def test_synthetic_fallback_equals_jax(tmp_path, monkeypatch):
    # Building all 60,000 images takes seconds; both loaders' corpora are
    # compared on a prefix built with the same function for the same request.
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))  # no ~/.keras/datasets/mnist.npz
    requests = {}
    for name, module in (("port", tp), ("jax", jp)):
        def prefix(shape, num_examples, seed=0, name=name, build=module.synthetic_dataset):
            requests[name] = (shape, num_examples, seed)
            return build(shape, 48, seed)

        monkeypatch.setattr(module, "synthetic_dataset", prefix)
    got, want = tp.load_mnist(), jp.load_mnist()
    assert requests["port"] == requests["jax"] == ((28, 28, 1), 60_000, 0)
    assert got.images.tobytes() == want.images.tobytes() and got.name == want.name
    with pytest.raises(FileNotFoundError, match="mnist.npz"):
        tp.load_mnist(allow_synthetic_fallback=False)


@pytest.mark.parametrize("cap", [None, 12, 19])
def test_materialize_byte_equal_to_jax(tmp_path, cap):
    images = jp.synthetic_dataset((16, 16, 3), num_examples=20, seed=4).images
    jp.write_shards(images, str(tmp_path), shard_size=8, progress=False)
    got = tp.ShardedArrayDataset(str(tmp_path), num_examples=cap).materialize()
    want = jp.ShardedArrayDataset(str(tmp_path), num_examples=cap).materialize()
    assert isinstance(got, tp.ArrayDataset) and got.num_examples == (cap or 20)
    assert got.images.tobytes() == want.images.tobytes() == images[:cap or 20].tobytes()
    assert got.name == want.name
    # Its stream is the store's own.
    kw = dict(seed=3, start_epoch=0, start_batch=1)
    a = next(got.batches(4, **kw))
    b = next(tp.ShardedArrayDataset(str(tmp_path), num_examples=cap).batches(4, **kw))
    assert a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def small_feeders(inception_fid, device):
    return [MetricFeeder(SWDMetric(nhoods_per_image=16), every_n_examples=50_000,
                         num_samples=8, name="swd")]


def read_events(log_dir):
    with open(os.path.join(log_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("mode", ["fit", "device_resident"])
def test_mnist_entry_point_trains_on_the_cpu(tmp_path, monkeypatch, mode, capsys):
    monkeypatch.setattr(train_mnist, "entry_point_feeders", small_feeders)
    path = write_mnist_npz(tmp_path / "mnist.npz")
    argv = ["--mnist_path", path, "--batch_size", "4", "--device", "cpu", "--log_dir",
            str(tmp_path / "run"), "--max_steps", "2"]
    if mode == "device_resident":
        argv += ["--device_resident", "--chunk_steps", "2"]
    trainer = train_mnist.main(argv)
    assert f"[train_mnist] bs=4 device=cpu dataset=mnist" in capsys.readouterr().out
    assert trainer.state.n_batches == 2 and trainer.samples_seen == 8
    assert trainer.dataset.image_shape == (28, 28, 1)
    assert trainer.state.generator.dense.in_features == 100  # the published widths
    assert [m.weight.shape[0] for m in trainer.state.discriminator.convs] == [64, 128]
    logs = trainer.history[-1]
    assert np.isfinite(logs["disc_loss"]) and logs["std"] == pytest.approx(
        trainer.blur_controller.sigma(1), rel=1e-6)
    assert trainer.ckpt.latest_step() == 8
    events = read_events(trainer.cfg.log_dir)
    swd = [r for r in events if "swd/SWDx1e3_avg" in r]
    # Recording one batch per step in fit, or measured at the chunk boundary.
    assert [r["step"] for r in swd] == [8]
    assert all(np.isfinite(r["swd/SWDx1e3_avg"]) for r in swd)
    assert (chunked := trainer.chunk_runner is not None) == (mode == "device_resident")
    if chunked:
        assert trainer.chunk_runner.chunk_steps == 2


def test_mnist_entry_point_controllers(tmp_path):
    path = write_mnist_npz(tmp_path / "mnist.npz")
    base = ["--mnist_path", path, "--device", "cpu", "--epochs", "3"]
    for extra, want in ((["--adaptive"], 23.5), (["--adaptive", "--initial_blur_std", "3"], 3.0)):
        tr, total = train_mnist.build_trainer(
            train_mnist.parse_args(base + extra + ["--log_dir", str(tmp_path / str(want))]),
            feeders=[])
        assert tr.adaptive_controller.max_value == want and tr.blur_controller is None
        tr.close()
    tr, total = train_mnist.build_trainer(
        train_mnist.parse_args(base + ["--initial_blur_std", "2", "--log_dir",
                                       str(tmp_path / "open")]), feeders=[])
    assert total == 3 * 64 and tr.adaptive_controller is None
    assert tr.blur_controller.max_value == 2.0
    assert tr.blur_controller.total_n_training_examples == total
    tr.close()


def test_celeba_entry_point_device_resident_materializes_shards(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(train_celeba, "entry_point_feeders", lambda *a: [])
    images = jp.synthetic_dataset((16, 16, 3), num_examples=24, seed=2).images
    jp.write_shards(images, str(tmp_path / "shards"), shard_size=10, progress=False)
    trainer = train_celeba.main([
        "--resolution", "16", "--batch_size", "4", "--celeba_path", str(tmp_path / "shards"),
        "--device", "cpu", "--log_dir", str(tmp_path / "run"), "--device_resident",
        "--chunk_steps", "2", "--max_steps", "3", "--sample_grid_every", "0",
        "--checkpoint_every", "0"])
    out = capsys.readouterr().out
    assert "materializing 24 images" in out
    assert "--max_steps 3 rounds up to 4 (whole chunks of 2)" in out
    assert trainer.state.n_batches == 4
    assert trainer.dataset.name.endswith(":materialized")
    assert trainer.chunk_runner.data.numpy().tobytes() == images.tobytes()


def script_flags(path: pathlib.Path) -> set:
    """``--`` flags that a root script adds itself, read from its source."""
    flags = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument":
            flags |= {a.value for a in node.args
                      if isinstance(a, ast.Constant) and str(a.value).startswith("--")}
    return flags


def parser_flags(parser: argparse.ArgumentParser) -> set:
    return {o for a in parser._actions for o in a.option_strings if o.startswith("--")} - {
        "--help"}


def jax_dataclass_flags() -> set:
    parser = argparse.ArgumentParser()
    JaxHParams.add_arguments(parser)
    JaxTrainingConfig.add_arguments(parser)
    return parser_flags(parser)


@pytest.mark.parametrize("module,script,left_out", [
    (train_mnist, "train_mnist.py", set()),
    (train_celeba, "train_celeba.py", set())])
def test_flags_equal_the_root_scripts(module, script, left_out):
    want = (script_flags(REPO / script) | jax_dataclass_flags()) - left_out
    assert "--device_resident" in want and "--chunk_steps" in want
    assert parser_flags(module.build_parser()) == want | {"--device"}


@pytest.mark.parametrize("module", [train_mnist, train_celeba])
def test_entry_points_default_to_the_card(module):
    args = module.parse_args([])
    assert args.device == "cuda" and args.chunk_steps == 100 and not args.device_resident
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            module.build_trainer(args, feeders=[])
