"""The port's copies of the numpy data pipeline and the σ schedule against the
JAX package's modules: the same seeds give byte-equal batches and equal σ.

``blurred_gan_tpu_torch.data.pipeline`` and ``.sched.blur`` are copies, so the
port imports nothing of the JAX package; these tests keep the copies equal to
the reference (exact equality: both sides are the same numpy arithmetic).
"""

import os

import numpy as np
import pytest

from blurred_gan_tpu.data import pipeline as jp
from blurred_gan_tpu.sched.blur import BlurDecayController as JaxBlurDecayController
from blurred_gan_tpu.sched.blur import ExponentialDecaySchedule as JaxExponentialDecaySchedule
from blurred_gan_tpu_torch.data import pipeline as tp
from blurred_gan_tpu_torch.sched.blur import BlurDecayController, ExponentialDecaySchedule
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)


def take(pipe, n):
    out = []
    for batch in pipe:
        out.append(batch)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("shape,n", [((16, 16, 3), 24), ((28, 28, 1), 10)])
def test_synthetic_dataset_byte_equal(shape, n):
    a = tp.synthetic_dataset(shape, num_examples=n, seed=3)
    b = jp.synthetic_dataset(shape, num_examples=n, seed=3)
    assert a.images.dtype == np.uint8 and a.images.shape == (n, *shape)
    assert a.images.tobytes() == b.images.tobytes()
    assert a.name == b.name


@pytest.mark.parametrize("shape,n", [((16, 16, 3), 40), ((28, 28, 1), 40), ((12, 20, 3), 9)])
def test_synthetic_images_at_indices_byte_equal(shape, n):
    # Any images of the corpus, in any order, rendered alone.
    want = jp.synthetic_dataset(shape, num_examples=n, seed=5).images
    idx = np.random.RandomState(0).permutation(n)[: n // 2]
    assert tp.synthetic_images(shape, idx, seed=5).tobytes() == want[idx].tobytes()
    assert tp.synthetic_images(shape, [], seed=5).shape == (0, *shape)


@pytest.mark.parametrize("start_epoch,start_batch", [(0, 0), (1, 3)])
def test_pipeline_batches_byte_equal(start_epoch, start_batch):
    # 40 examples at batch 8: 5 batches an epoch, so 12 batches cross two
    # epoch boundaries (each with its own permutation).
    images = jp.synthetic_dataset((8, 8, 3), num_examples=40, seed=1).images
    kw = dict(seed=7, start_epoch=start_epoch, start_batch=start_batch)
    got = take(tp.DataPipeline(tp.ArrayDataset(images), 8, **kw), 12)
    want = take(jp.DataPipeline(jp.ArrayDataset(images), 8, **kw), 12)
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert g.shape == (8, 8, 8, 3) and g.tobytes() == w.tobytes()


def test_resume_equals_the_uninterrupted_stream():
    images = tp.synthetic_dataset((8, 8, 1), num_examples=40, seed=2).images
    full = take(tp.DataPipeline(tp.ArrayDataset(images), 8, seed=5), 9)
    resumed = take(tp.DataPipeline(tp.ArrayDataset(images), 8, seed=5,
                                   start_epoch=1, start_batch=2), 2)
    assert [b.tobytes() for b in resumed] == [b.tobytes() for b in full[7:9]]


def test_pipeline_surfaces_worker_errors():
    with pytest.raises(ValueError, match="exceeds"):
        take(tp.DataPipeline(tp.synthetic_dataset((4, 4, 1), num_examples=4), 8), 1)


@pytest.mark.parametrize("n_batches", [0, 1, 10 ** 3, 10 ** 6])
def test_blur_decay_sigma_equal(n_batches):
    for total, max_value in ((2_025_990, 5.0), (640, 23.5)):
        got = BlurDecayController(total_n_training_examples=total, max_value=max_value)
        want = JaxBlurDecayController(total_n_training_examples=total, max_value=max_value)
        assert got.sigma(n_batches) == want.sigma(n_batches)


def test_exponential_decay_equal():
    got = ExponentialDecaySchedule(4.0, 100.0, decay_rate=0.9)
    want = JaxExponentialDecaySchedule(4.0, 100.0, decay_rate=0.9)
    assert [got(s) for s in (0, 50, 150, 1234)] == [want(s) for s in (0, 50, 150, 1234)]


def test_load_celeba_raises_on_jpeg_directory(tmp_path, monkeypatch):
    # A directory of JPEGs loads as the JAX package's does (an image folder
    # with the same files, decoded to the same bytes); it raises only where
    # a file does not decode, and then names it. Both packages decode with
    # the same decoder: the JAX loader is built here if this process lost
    # its first-build race (tests/torch_jax_state.py).
    from PIL import Image

    from torch_jax_state import ensure_jax_native

    ensure_jax_native(monkeypatch)

    images = jp.synthetic_dataset((40, 32, 3), num_examples=5, seed=6).images
    for i, img in enumerate(images):
        Image.fromarray(img).save(tmp_path / f"{i:06d}.jpg", quality=90)
    got = tp.load_celeba(str(tmp_path), resolution=16)
    want = jp.load_celeba(str(tmp_path), resolution=16)
    assert isinstance(got, tp.ImageFolderDataset) and got.files == want.files
    assert got.name == want.name and got.image_shape == (16, 16, 3)
    kw = dict(seed=2, start_epoch=0, start_batch=1)
    assert [b.tobytes() for b in take(tp.DataPipeline(got, 2, **kw), 4)] == \
        [b.tobytes() for b in take(jp.DataPipeline(want, 2, **kw), 4)]
    (tmp_path / "000005.jpg").write_bytes(b"\xff\xd8\xff")
    broken = tp.load_celeba(str(tmp_path), resolution=16)
    with pytest.raises(OSError, match="failed to decode image: .*000005.jpg"):
        broken.materialize(progress=False)


def test_load_celeba_reads_jax_shard_store(tmp_path):
    images = jp.synthetic_dataset((16, 16, 3), num_examples=20, seed=4).images
    jp.write_shards(images, str(tmp_path), shard_size=8, progress=False)
    ds = tp.load_celeba(str(tmp_path), resolution=16)
    assert isinstance(ds, tp.ShardedArrayDataset) and ds.num_examples == 20
    want = jp.ShardedArrayDataset(str(tmp_path))
    kw = dict(seed=3, start_epoch=0, start_batch=1)
    got_batches = take(tp.DataPipeline(ds, 4, **kw), 6)
    want_batches = take(jp.DataPipeline(want, 4, **kw), 6)
    assert [b.tobytes() for b in got_batches] == [b.tobytes() for b in want_batches]
    capped = tp.load_celeba(str(tmp_path), resolution=16, num_examples=12)
    assert capped.num_examples == 12
    with pytest.raises(ValueError, match="resolution"):
        tp.load_celeba(str(tmp_path), resolution=32)


def test_load_celeba_synthetic_only_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path))
    ds = tp.load_celeba(resolution=16, num_examples=6)
    assert ds.name == "synthetic16x16x3" and ds.num_examples == 6
    assert ds.images.tobytes() == jp.synthetic_dataset((16, 16, 3), 6).images.tobytes()
    os.makedirs(tmp_path / "celeba")
    with pytest.raises(FileNotFoundError, match="no images"):
        tp.load_celeba(resolution=16)
