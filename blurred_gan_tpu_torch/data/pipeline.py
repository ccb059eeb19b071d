"""Host-side input pipeline (numpy only): a copy of the part of
``blurred_gan_tpu/data/pipeline.py`` that the CelebA training path uses.

Batches are uint8 NHWC numpy arrays; the train step moves them to the device
and normalises them there. Every epoch's permutation is
``RandomState(seed + epoch)``, so ``start_epoch``/``start_batch`` resume the
stream at the exact batch by index arithmetic alone, and the stream is
byte-equal to the JAX package's for the same dataset and seed.

Copied: ``ArrayDataset``, ``synthetic_dataset``, the ``shard-*.npy`` store
(``ShardedArrayDataset``, with ``materialize`` for the device-resident mode),
``DataPipeline``, ``load_mnist`` and ``load_celeba``, without the
multi-process sharding options (the port trains on one device). Not copied:
the JPEG / native-decoder folder path (``ImageFolderDataset``); ``load_celeba``
raises on a directory of images instead (ROADMAP queue 1, item 9). Convert such
a directory once with the JAX package's ``tools/make_shards.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

_SHARD_PREFIX = "shard-"
_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")
_PREFETCH = 2  # batches the pipeline's worker may run ahead


def _batch_indices(n: int, batch_size: int, *, seed: int, start_epoch: int,
                   start_batch: int) -> Iterator[np.ndarray]:
    """Infinite stream of example indices, one array per full batch: the
    reference's epoch permutation and resume arithmetic."""
    if batch_size > n:
        # Otherwise the stream yields nothing per epoch and a prefetching
        # consumer blocks forever on an empty queue.
        raise ValueError(f"batch_size {batch_size} exceeds the {n} examples")
    epoch = start_epoch
    first = start_batch * batch_size
    while True:
        order = np.random.RandomState(seed + epoch).permutation(n)
        for i in range(first, n - n % batch_size, batch_size):
            yield order[i:i + batch_size]
        epoch += 1
        first = 0


class ArrayDataset:
    """A memory-resident uint8 NHWC image store with epoch-seeded shuffling."""

    def __init__(self, images: np.ndarray, name: str = "array"):
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"expected uint8 NHWC, got {images.dtype} {images.shape}")
        self.images = images
        self.name = name

    @property
    def num_examples(self) -> int:
        return self.images.shape[0]

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self.images.shape[1:])

    def batches(self, batch_size: int, *, seed: int = 0, start_epoch: int = 0,
                start_batch: int = 0) -> Iterator[np.ndarray]:
        """Infinite epoch-shuffled uint8 batch stream; ``start_epoch`` and
        ``start_batch`` resume it mid-run."""
        for idx in _batch_indices(self.num_examples, batch_size, seed=seed,
                                  start_epoch=start_epoch, start_batch=start_batch):
            yield self.images[idx]


def synthetic_dataset(image_shape: Tuple[int, int, int] = (28, 28, 1),
                      num_examples: int = 4096, seed: int = 0) -> ArrayDataset:
    """Deterministic procedural images (blobs of varying position, scale and
    phase, plus a plane wave), with structure at several scales so the blur
    schedule has something to act on."""
    h, w, c = image_shape
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    out = np.empty((num_examples, h, w, c), np.uint8)
    for i in range(num_examples):
        img = np.zeros((h, w), np.float32)
        for _ in range(3):
            cy, cx = rng.rand(2)
            s = 0.03 + 0.12 * rng.rand()
            a = 0.4 + 0.6 * rng.rand()
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        fy, fx, ph = rng.rand(3)
        img += 0.2 * np.sin(2 * np.pi * (3 * fy * yy + 3 * fx * xx + ph))
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        for ch in range(c):
            gain = 1.0 if c == 1 else 0.6 + 0.4 * rng.rand()
            out[i, :, :, ch] = np.uint8(np.clip(img * gain * 255, 0, 255))
    return ArrayDataset(out, name=f"synthetic{h}x{w}x{c}")


class ShardedArrayDataset:
    """Memory-mapped uint8 NHWC shard store: a directory of ``shard-*.npy``.

    Its batch stream is byte-equal to an :class:`ArrayDataset` over the
    concatenated shards (the same permutation arithmetic and seed).
    ``num_examples`` caps the store to its first N examples in shard-name order.
    """

    def __init__(self, root: str, num_examples: Optional[int] = None):
        names = sorted(n for n in os.listdir(root)
                       if n.startswith(_SHARD_PREFIX) and n.endswith(".npy"))
        if not names:
            raise FileNotFoundError(f"no {_SHARD_PREFIX}*.npy under {root}")
        self.root = root
        self._shards = [np.load(os.path.join(root, n), mmap_mode="r") for n in names]
        shape0 = self._shards[0].shape[1:]
        for n, s in zip(names, self._shards):
            if s.ndim != 4 or s.dtype != np.uint8 or s.shape[1:] != shape0:
                raise ValueError(f"{n}: expected uint8 NHWC with image shape {shape0}, "
                                 f"got {s.dtype} {s.shape}")
        # _starts[i] = global index of shard i's first example.
        counts = [s.shape[0] for s in self._shards]
        self._starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self._total = int(sum(counts))
        if num_examples:
            self._total = min(self._total, int(num_examples))
        self.name = f"shards:{os.path.basename(os.path.abspath(root))}"

    @property
    def num_examples(self) -> int:
        return self._total

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return tuple(self._shards[0].shape[1:])

    def _gather(self, idx: np.ndarray) -> np.ndarray:
        """Fancy-index the virtual concatenation, one read per touched shard,
        in the requested order."""
        out = np.empty((len(idx), *self.image_shape), np.uint8)
        shard_ids = np.searchsorted(self._starts, idx, side="right") - 1
        for s in np.unique(shard_ids):
            mask = shard_ids == s
            out[mask] = self._shards[s][idx[mask] - self._starts[s]]
        return out

    def materialize(self) -> ArrayDataset:
        """The (capped) store concatenated into memory: the bridge to the
        device-resident chunked mode, which parks ``.images`` on the card.
        Only the shards inside the ``num_examples`` cap are read."""
        parts, remaining = [], self._total
        for s in self._shards:
            take = min(remaining, s.shape[0])
            if take <= 0:
                break
            parts.append(np.asarray(s[:take]))
            remaining -= take
        return ArrayDataset(np.concatenate(parts), name=f"{self.name}:materialized")

    def batches(self, batch_size: int, *, seed: int = 0, start_epoch: int = 0,
                start_batch: int = 0) -> Iterator[np.ndarray]:
        """The same stream contract (and values) as ``ArrayDataset.batches``."""
        for idx in _batch_indices(self.num_examples, batch_size, seed=seed,
                                  start_epoch=start_epoch, start_batch=start_batch):
            yield self._gather(idx)


def _datasets_dir() -> str:
    return os.environ.get("DATASETS_DIR", os.path.expanduser("~/datasets"))


def load_mnist(path: Optional[str] = None, split: str = "train",
               allow_synthetic_fallback: bool = True) -> ArrayDataset:
    """MNIST 28x28x1 from a local ``mnist.npz`` (Keras layout: x_train/x_test).

    Searches ``path``, then ``$DATASETS_DIR/mnist.npz`` and
    ``~/.keras/datasets/mnist.npz``, as the JAX package does; without one, the
    deterministic synthetic 28x28x1 corpus of 60,000 examples.
    """
    candidates = [path] if path else [
        os.path.join(_datasets_dir(), "mnist.npz"),
        os.path.expanduser("~/.keras/datasets/mnist.npz"),
    ]
    for cand in candidates:
        if cand and os.path.exists(cand):
            with np.load(cand) as d:
                x = d["x_train" if split == "train" else "x_test"]
            return ArrayDataset(x[..., None].astype(np.uint8), name="mnist")
    if not allow_synthetic_fallback:
        raise FileNotFoundError(
            f"mnist.npz not found in {candidates}; set $DATASETS_DIR or pass path=")
    print("[data] mnist.npz not found locally - using deterministic synthetic "
          "28x28x1 surrogate (60000 examples)")
    return synthetic_dataset((28, 28, 1), num_examples=60_000)


def load_celeba(path: Optional[str] = None, resolution: int = 128,
                num_examples: Optional[int] = None):
    """CelebA at ``resolution``² from a local ``shard-*.npy`` store.

    Searches ``path``, then ``$DATASETS_DIR`` (default ``~/datasets``) as the
    JAX package does. A directory of JPEGs raises ``NotImplementedError``:
    decoding them is not ported (ROADMAP queue 1, item 9). Only when no
    candidate directory exists does it fall back to the synthetic corpus.
    """
    candidates = [path] if path else [
        os.path.join(_datasets_dir(), f"celeba_shards_{resolution}"),
        os.path.join(_datasets_dir(), "celeba", "img_align_celeba"),
        os.path.join(_datasets_dir(), "celeb_a"),
        os.path.join(_datasets_dir(), "celeba"),
    ]
    for cand in candidates:
        if not (cand and os.path.isdir(cand)):
            continue
        names = os.listdir(cand)
        if any(n.startswith(_SHARD_PREFIX) and n.endswith(".npy") for n in names):
            ds = ShardedArrayDataset(cand, num_examples=num_examples)
            if ds.image_shape[:2] != (resolution, resolution):
                raise ValueError(
                    f"{cand} holds {ds.image_shape[0]}px shards but "
                    f"resolution={resolution} was requested; convert with "
                    f"tools/make_shards.py at the right resolution")
            return ds
        if any(n.lower().endswith(_IMAGE_EXTENSIONS) for n in names):
            raise NotImplementedError(
                f"{cand} is a directory of images; the PyTorch port reads only a "
                f"{_SHARD_PREFIX}*.npy store (ROADMAP queue 1, item 9). Convert it "
                f"once with tools/make_shards.py")
        raise FileNotFoundError(f"no images under {cand}")
    n = min(num_examples or 202_599, 20_000)  # cap the procedural corpus
    print(f"[data] CelebA not found locally - using deterministic synthetic "
          f"{resolution}x{resolution}x3 surrogate ({n} examples)")
    return synthetic_dataset((resolution, resolution, 3), num_examples=n)


class DataPipeline:
    """Background-thread prefetch over a dataset's batch stream.

    Iterating yields uint8 NHWC numpy batches while the next ones are gathered
    concurrently (a queue of ``_PREFETCH`` batches). An error in the worker is
    raised in the consumer.
    """

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 start_epoch: int = 0, start_batch: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.start_epoch = start_epoch
        self.start_batch = start_batch
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._queue: Optional[queue.Queue] = None

    def __iter__(self) -> Iterator[np.ndarray]:
        self._queue = queue.Queue(maxsize=_PREFETCH)
        self._stop.clear()

        def put(item) -> bool:
            while True:
                try:
                    self._queue.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    if self._stop.is_set():
                        return False

        def worker():
            # An error must surface in the consumer, not silently end this
            # thread (which would hang training on an untimed get()).
            try:
                it = self.dataset.batches(self.batch_size, seed=self.seed,
                                          start_epoch=self.start_epoch,
                                          start_batch=self.start_batch)
                for batch in it:
                    if self._stop.is_set() or not put(batch):
                        return
            except Exception as e:  # noqa: BLE001 — re-raised by the consumer
                put(e)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._queue.get()
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            self.close()

    def close(self) -> None:
        self._stop.set()
        if self._queue is not None:
            try:  # unblock a worker stuck on put()
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
