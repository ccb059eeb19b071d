"""Host-side input pipeline (numpy only): a copy of the JAX package's
``blurred_gan_tpu/data/pipeline.py``.

Batches are uint8 NHWC numpy arrays; the train step moves them to the device
and normalises them there. Every epoch's permutation is
``RandomState(seed + epoch)``, so ``start_epoch``/``start_batch`` resume the
stream at the exact batch by index arithmetic alone, and the stream is
byte-equal to the JAX package's for the same dataset and seed, whatever the
storage: an image folder, its materialized array or its shard store.

Copied: ``ArrayDataset``, ``synthetic_dataset`` (its images rendered by
``synthetic_images``, which renders any subset of them alone),
``ImageFolderDataset`` (a folder of JPEG / PNG files decoded per batch on the
pipeline's worker by the native loader, ``blurred_gan_tpu_torch/native``, or
by Pillow where that does not build), the ``shard-*.npy`` store (``ShardedArrayDataset``,
``write_shards``), ``materialize`` for the device-resident mode,
``DataPipeline``, ``load_mnist`` and ``load_celeba``, with the
multi-process sharding options: ``shard_index`` / ``shard_count`` give each
of a data-parallel run's processes a disjoint strided shard of the same epoch
permutation, ``order[:n - n % shard_count][shard_index::shard_count]``, so
each example appears once per global epoch.
"""

from __future__ import annotations

import importlib.util
import os
import queue
import sys
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_SHARD_PREFIX = "shard-"
_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png")
_PREFETCH = 2  # batches the pipeline's worker may run ahead


def _batch_indices(n: int, batch_size: int, *, seed: int, start_epoch: int,
                   start_batch: int, shard_index: int = 0,
                   shard_count: int = 1) -> Iterator[np.ndarray]:
    """Infinite stream of example indices, one array per full batch of this
    shard: the reference's epoch permutation and resume arithmetic, over the
    shard's strided slice of each permutation (truncated to a multiple of
    ``shard_count``, so every shard has the same length)."""
    m = (n - n % shard_count) // shard_count
    if batch_size > m:
        # Otherwise the stream yields nothing per epoch and a prefetching
        # consumer blocks forever on an empty queue.
        raise ValueError(f"batch_size {batch_size} exceeds this shard's {m} examples "
                         f"(num_examples={n}, shard_count={shard_count})")
    epoch = start_epoch
    first = start_batch * batch_size
    while True:
        order = np.random.RandomState(seed + epoch).permutation(n)
        order = order[:n - n % shard_count][shard_index::shard_count]
        for i in range(first, m - m % batch_size, batch_size):
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
                start_batch: int = 0, shard_index: int = 0,
                shard_count: int = 1) -> Iterator[np.ndarray]:
        """Infinite epoch-shuffled uint8 batch stream; ``start_epoch`` and
        ``start_batch`` resume it mid-run; ``shard_index`` / ``shard_count``
        give a data-parallel process its shard of each epoch."""
        for idx in _batch_indices(self.num_examples, batch_size, seed=seed,
                                  start_epoch=start_epoch, start_batch=start_batch,
                                  shard_index=shard_index, shard_count=shard_count):
            yield self.images[idx]


def synthetic_dataset(image_shape: Tuple[int, int, int] = (28, 28, 1),
                      num_examples: int = 4096, seed: int = 0) -> ArrayDataset:
    """Deterministic procedural images (blobs of varying position, scale and
    phase, plus a plane wave), with structure at several scales so the blur
    schedule has something to act on."""
    h, w, c = image_shape
    return ArrayDataset(synthetic_images(image_shape, range(num_examples), seed),
                        name=f"synthetic{h}x{w}x{c}")


def synthetic_images(image_shape: Tuple[int, int, int], indices: Sequence[int],
                     seed: int = 0) -> np.ndarray:
    """The images at ``indices`` (in that order) of every
    ``synthetic_dataset(image_shape, n, seed)`` with ``n`` above them, as a
    uint8 NHWC array. Each image's random numbers are drawn in the order the
    dataset draws them, but only these images are rendered."""
    h, w, c = image_shape
    indices = np.asarray(indices, np.int64)
    per_image = 15 + (c if c > 1 else 0)  # 3 blobs of 4, the wave's 3, the gains
    draws = np.random.RandomState(seed).rand(int(indices.max(initial=-1)) + 1, per_image)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    out = np.empty((len(indices), h, w, c), np.uint8)
    for j, i in enumerate(indices):
        # The scalars keep the types of the draws they stand for: numpy
        # float64 where the dataset unpacks an array (rand(2), rand(3)), a
        # Python float where it calls rand(), so the arithmetic promotes alike.
        u = draws[i]
        img = np.zeros((h, w), np.float32)
        for b in range(0, 12, 4):
            cy, cx = u[b], u[b + 1]
            s = 0.03 + 0.12 * float(u[b + 2])
            a = 0.4 + 0.6 * float(u[b + 3])
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        fy, fx, ph = u[12], u[13], u[14]
        img += 0.2 * np.sin(2 * np.pi * (3 * fy * yy + 3 * fx * xx + ph))
        img = (img - img.min()) / (np.ptp(img) + 1e-6)
        for ch in range(c):
            gain = 1.0 if c == 1 else 0.6 + 0.4 * float(u[15 + ch])
            out[j, :, :, ch] = np.uint8(np.clip(img * gain * 255, 0, 255))
    return out


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
                start_batch: int = 0, shard_index: int = 0,
                shard_count: int = 1) -> Iterator[np.ndarray]:
        """The same stream contract (and values) as ``ArrayDataset.batches``."""
        for idx in _batch_indices(self.num_examples, batch_size, seed=seed,
                                  start_epoch=start_epoch, start_batch=start_batch,
                                  shard_index=shard_index, shard_count=shard_count):
            yield self._gather(idx)


def _choose_decoder() -> Tuple[str, Optional[str]]:
    """``("native" | "pil", the native loader's build error or None)``, as
    the JAX package picks: the native loader where it builds, Pillow where it
    does not. Raises ``RuntimeError`` naming both reasons if neither exists."""
    from blurred_gan_tpu_torch import native

    if native.available():
        return "native", None
    error = native.build_error()
    if importlib.util.find_spec("PIL") is None:
        raise RuntimeError(f"no image decoder: the native loader did not build ({error}) "
                           f"and Pillow is not installed")
    return "pil", error


class ImageFolderDataset:
    """A directory of JPEG / PNG images, decoded per batch: only the sorted
    file list stays in memory, and each epoch draws a fresh permutation of it.

    Each image is centre-cropped to its largest square and resized to
    ``resolution``² (PIL's BILINEAR). ``decoder`` records which decoder runs:
    ``"native"`` (the parallel C++ loader) or ``"pil"`` (one image at a time,
    where the native loader does not build); construction says which on
    stderr, and raises if there is neither.
    """

    def __init__(self, root: str, resolution: int, num_examples: Optional[int] = None,
                 extensions: Sequence[str] = _IMAGE_EXTENSIONS):
        self.root = root
        self.resolution = resolution
        files: List[str] = []
        for name in sorted(os.listdir(root)):
            if name.lower().endswith(tuple(extensions)):
                files.append(os.path.join(root, name))
            if num_examples and len(files) >= num_examples:
                break
        if not files:
            raise FileNotFoundError(f"no images under {root}")
        self.files = files
        self.name = f"folder:{os.path.basename(root)}@{resolution}"
        self.decoder, error = _choose_decoder()
        how = ("the native loader" if self.decoder == "native" else
               f"Pillow, one image at a time (the native loader did not build: {error})")
        print(f"[data] {self.name}: {len(files)} images, decoded by {how}",
              file=sys.stderr, flush=True)

    @property
    def num_examples(self) -> int:
        return len(self.files)

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.resolution, self.resolution, 3)

    def _decode(self, fp: str) -> np.ndarray:
        """One image through Pillow: the JAX package's arithmetic."""
        from PIL import Image

        with Image.open(fp) as src:
            img = src.convert("RGB")
        w, h = img.size
        side = min(w, h)
        img = img.crop(((w - side) // 2, (h - side) // 2,
                        (w + side) // 2, (h + side) // 2))
        img = img.resize((self.resolution, self.resolution), Image.Resampling.BILINEAR)
        return np.asarray(img, np.uint8)

    def _decode_batch(self, paths: Sequence[str]) -> np.ndarray:
        """The native loader's parallel decode, or Pillow one image at a
        time on the calling thread (a pool of Python threads contends for the
        GIL with the thread that launches the step's kernels)."""
        if self.decoder == "native":
            from blurred_gan_tpu_torch import native

            return native.decode_batch(paths, self.resolution)
        out = np.empty((len(paths), *self.image_shape), np.uint8)
        for i, fp in enumerate(paths):
            try:
                out[i] = self._decode(fp)
            except OSError as e:  # as the native loader: name the file
                raise IOError(f"failed to decode image: {fp} ({e})") from e
        return out

    def materialize(self, decode_batch: int = 512, progress: bool = True) -> ArrayDataset:
        """The whole folder decoded into memory, in file order, ``decode_batch``
        images at a time: the bridge to the device-resident mode, which parks
        ``.images`` on the card. Progress goes to stderr (the CLIs keep stdout
        for their JSON)."""
        n = len(self.files)
        out = np.empty((n, self.resolution, self.resolution, 3), np.uint8)
        for i in range(0, n, decode_batch):
            out[i:i + decode_batch] = self._decode_batch(self.files[i:i + decode_batch])
            if progress and (i // decode_batch) % 20 == 0:
                print(f"[data] materializing {self.name}: {i}/{n}", file=sys.stderr,
                      flush=True)
        return ArrayDataset(out, name=f"{self.name}:materialized")

    def batches(self, batch_size: int, *, seed: int = 0, start_epoch: int = 0,
                start_batch: int = 0, shard_index: int = 0,
                shard_count: int = 1) -> Iterator[np.ndarray]:
        """The same stream contract (and values) as ``ArrayDataset.batches``
        over the materialized folder."""
        for idx in _batch_indices(self.num_examples, batch_size, seed=seed,
                                  start_epoch=start_epoch, start_batch=start_batch,
                                  shard_index=shard_index, shard_count=shard_count):
            yield self._decode_batch([self.files[j] for j in idx])


def image_folder_dataset(root: str, resolution: int = 128,
                         num_examples: Optional[int] = None) -> ImageFolderDataset:
    return ImageFolderDataset(root, resolution, num_examples)


def write_shards(source, root: str, shard_size: int = 4096,
                 progress: bool = True) -> ShardedArrayDataset:
    """Write ``source`` as a ``shard-*.npy`` directory and reopen it mmap'd.

    ``source`` is a uint8 NHWC array, an :class:`ArrayDataset` or an
    :class:`ImageFolderDataset`; a folder is decoded one shard at a time, so
    a corpus larger than memory converts in bounded memory. The store keeps
    the source's order. A directory that already holds shards is refused.
    """
    os.makedirs(root, exist_ok=True)
    stale = [n for n in os.listdir(root) if n.startswith(_SHARD_PREFIX) and n.endswith(".npy")]
    if stale:
        raise FileExistsError(
            f"{root} already holds {len(stale)} shard files; refusing to mix two "
            f"corpora - point write_shards at an empty directory")
    if isinstance(source, ImageFolderDataset):
        n = source.num_examples

        def chunk(i):
            return source._decode_batch(source.files[i:i + shard_size])
    else:
        images = source.images if isinstance(source, ArrayDataset) else np.asarray(source)
        if images.ndim != 4 or images.dtype != np.uint8:
            raise ValueError(f"expected uint8 NHWC, got {images.dtype} {images.shape}")
        n = images.shape[0]

        def chunk(i):
            return images[i:i + shard_size]

    for k, i in enumerate(range(0, n, shard_size)):
        np.save(os.path.join(root, f"{_SHARD_PREFIX}{k:05d}.npy"), chunk(i))
        if progress and k % 20 == 0:
            print(f"[data] writing shards: {i}/{n}", file=sys.stderr, flush=True)
    return ShardedArrayDataset(root)


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
                num_examples: Optional[int] = None, allow_synthetic_fallback: bool = True):
    """CelebA at ``resolution``² from a local ``shard-*.npy`` store or a
    directory of aligned JPEGs (centre-cropped, resized).

    Searches ``path``, then ``$DATASETS_DIR`` (default ``~/datasets``) as the
    JAX package does. In the first directory found, a shard store wins over
    images; a directory with neither raises ``FileNotFoundError``. Only when
    no candidate directory exists does it fall back to the synthetic corpus,
    and with ``allow_synthetic_fallback=False`` raises instead.
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
        if any(n.startswith(_SHARD_PREFIX) and n.endswith(".npy") for n in os.listdir(cand)):
            ds = ShardedArrayDataset(cand, num_examples=num_examples)
            if ds.image_shape[:2] != (resolution, resolution):
                raise ValueError(
                    f"{cand} holds {ds.image_shape[0]}px shards but "
                    f"resolution={resolution} was requested; convert with "
                    f"tools/make_shards.py at the right resolution")
            return ds
        return image_folder_dataset(cand, resolution=resolution, num_examples=num_examples)
    if not allow_synthetic_fallback:
        raise FileNotFoundError(f"no CelebA image dir found in {candidates}")
    n = min(num_examples or 202_599, 20_000)  # cap the procedural corpus
    print(f"[data] CelebA not found locally - using deterministic synthetic "
          f"{resolution}x{resolution}x3 surrogate ({n} examples)")
    return synthetic_dataset((resolution, resolution, 3), num_examples=n)


class DataPipeline:
    """Background-thread prefetch over a dataset's batch stream.

    Iterating yields uint8 NHWC numpy batches while the next ones are gathered
    concurrently (a queue of ``_PREFETCH`` batches). An error in the worker is
    raised in the consumer. ``shard_index`` / ``shard_count``: this process's
    shard of each epoch (``ArrayDataset.batches``).
    """

    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 start_epoch: int = 0, start_batch: int = 0,
                 shard_index: int = 0, shard_count: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.start_epoch = start_epoch
        self.start_batch = start_batch
        self.shard_index = shard_index
        self.shard_count = shard_count
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
                                          start_batch=self.start_batch,
                                          shard_index=self.shard_index,
                                          shard_count=self.shard_count)
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
