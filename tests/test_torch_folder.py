"""The port's image-folder path against the JAX package on the same files.

The files are written to a temporary directory with Pillow from seeded numpy.
The port's native loader (``blurred_gan_tpu_torch/native``) compiles the same
``loader.cc`` with the same flags as the JAX package's, so the two decode to
the same bytes; Pillow against Pillow is byte-equal too. Native against
Pillow may differ by a step or two of rounding (mean |diff| < 1.5, 99th
percentile <= 3, the JAX package's own bound in tests/test_native.py), so
every parity case puts both sides on the same decoder. Cases that need the
native loader skip where it does not build. Also held to the JAX package:
``ImageFolderDataset`` (file list, decodes, stream, ``materialize``),
``write_shards``, ``load_celeba``'s dispatch and the ``make_shards`` CLI
(its flags read from the root script's source text); and the CelebA entry
point takes a step from a folder in each mode.
"""

import importlib.util
import os
import pathlib
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from blurred_gan_tpu import native as jax_native
from blurred_gan_tpu.data import pipeline as jp
from blurred_gan_tpu_torch import native, train_celeba
from blurred_gan_tpu_torch.data import pipeline as tp
from blurred_gan_tpu_torch.tools import make_shards
from blurred_gan_tpu_torch.utils import logging as logging_mod
from test_torch_mnist import parser_flags, script_flags, write_mnist_npz
from torch_jax_state import ensure_jax_native
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
RES = 16
# (width, height) of the three orientations, and the two formats.
SIZES = {"landscape": (54, 44), "portrait": (44, 54), "square": (48, 48)}
FORMATS = {"jpeg": ("JPEG", ".jpg"), "png": ("PNG", ".png")}


def write_image(path, width, height, fmt, seed):
    """A structured image (the synthetic corpus's blobs) plus noise of ±12."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    base = jp.synthetic_dataset((height, width, 3), 1, seed=seed).images[0].astype(np.int16)
    arr = np.clip(base + rng.randint(-12, 13, base.shape), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path, fmt, quality=90)
    return str(path)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """18 images, every orientation in both formats, and a file that is no
    image (``ImageFolderDataset`` skips it by its extension)."""
    d = tmp_path_factory.mktemp("celeba")
    kinds = [(o, f) for o in SIZES for f in FORMATS]
    for i in range(18):
        orient, fmt = kinds[i % len(kinds)]
        write_image(d / f"{i:06d}{FORMATS[fmt][1]}", *SIZES[orient], FORMATS[fmt][0], seed=i)
    (d / "list_attr_celeba.txt").write_text("not an image")
    return str(d)


@pytest.fixture(autouse=True)
def jax_loader(monkeypatch):
    """Whether the JAX package's native loader is there. Every case holds the
    port's decode against the JAX package's, each on its default decoder
    unless it says otherwise, so the JAX loader is built here if this process
    lost its first-build race (tests/torch_jax_state.py)."""
    return ensure_jax_native(monkeypatch)


@pytest.fixture
def needs_native(jax_loader):
    if not native.available():
        pytest.skip(f"native loader unavailable: {native.build_error()}")
    if not jax_loader:
        pytest.skip(f"the JAX package's native loader unavailable: {jax_native.build_error()}")


@pytest.fixture
def pil_on_both(monkeypatch):
    """Both packages' folders decode with Pillow, as where nothing builds."""
    monkeypatch.setattr(jax_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


def take(pipe, n):
    out = []
    for batch in pipe:
        out.append(batch)
        if len(out) == n:
            break
    return out


# ---------------------------------------------------------------------------
# The native loader
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", sorted(FORMATS))
@pytest.mark.parametrize("orient", sorted(SIZES))
def test_native_decode_equals_jax(tmp_path, needs_native, orient, fmt):
    paths = [write_image(tmp_path / f"{k}{FORMATS[fmt][1]}", *SIZES[orient], FORMATS[fmt][0],
                         seed=k) for k in range(3)]
    for res in (RES, 40):
        got = native.decode_batch(paths, res)
        want = jax_native.decode_batch(paths, res)
        assert got.shape == (3, res, res, 3) and got.dtype == np.uint8
        assert got.tobytes() == want.tobytes()


def test_native_png_at_the_target_size_is_lossless(tmp_path, needs_native):
    from PIL import Image

    arr = np.random.RandomState(1).randint(0, 256, (32, 32, 3), np.uint8)
    Image.fromarray(arr).save(tmp_path / "x.png")
    assert native.decode_batch([str(tmp_path / "x.png")], 32)[0].tobytes() == arr.tobytes()


def test_native_bad_file_raises_naming_it(tmp_path, needs_native, folder):
    bad = tmp_path / "junk.jpg"
    bad.write_bytes(b"\xff\xd8 not an image")
    good = sorted(p for p in os.listdir(folder) if p.endswith(".jpg"))[0]
    with pytest.raises(IOError, match="junk.jpg"):
        native.decode_batch([os.path.join(folder, good), str(bad)], RES)


def test_native_gather_equals_fancy_indexing(needs_native):
    rng = np.random.RandomState(2)
    src = rng.randint(0, 256, (100, 16, 16, 3), np.uint8)
    idx = rng.permutation(100)[:32]
    assert native.gather_batch(src, idx).tobytes() == src[idx].tobytes()
    with pytest.raises(IndexError):
        native.gather_batch(src, np.array([0, 100]))


def test_native_builds_into_build_dir_never_at_import(needs_native):
    child = (
        "import subprocess\n"
        "calls = []\n"
        "run = subprocess.run\n"
        "subprocess.run = lambda *a, **k: calls.append(a) or run(*a, **k)\n"
        "from blurred_gan_tpu_torch import native\n"
        "import blurred_gan_tpu_torch.data.pipeline, blurred_gan_tpu_torch.tools.make_shards\n"
        "assert not calls and native._lib is None and native._build_error is None, calls\n"
        "print(native.build())\n")
    out = subprocess.run([sys.executable, "-c", child], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    built = pathlib.Path(out.stdout.strip())
    assert built.parent == REPO / "blurred_gan_tpu_torch" / "_build" and built.exists()
    assert built.name.startswith("loader-") and built.suffix == ".so"


def test_native_build_failure_is_one_line(tmp_path, monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "LIBS", ["-lno_such_library_anywhere"])
    with pytest.raises(RuntimeError, match=r"g\+\+ failed .*no_such_library_anywhere") as e:
        native.build()
    assert "\n" not in str(e.value) and list(tmp_path.iterdir()) == []


def test_native_first_load_from_many_threads_builds_once(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    calls = []
    build = native.build

    def counted():
        calls.append(threading.get_ident())
        return build()

    monkeypatch.setattr(native, "build", counted)
    results = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: results.append(native._load()))
                   for _ in range(4 * (os.cpu_count() or 1))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and len(results) == len(threads)
    assert len({id(r) for r in results}) == 1


def test_native_against_pil_within_rounding(folder, needs_native):
    ds = tp.ImageFolderDataset(folder, 40)
    got = native.decode_batch(ds.files, 40)
    for i, fp in enumerate(ds.files):
        diff = np.abs(got[i].astype(int) - ds._decode(fp).astype(int))
        assert diff.mean() < 1.5 and np.percentile(diff, 99) <= 3, (fp, diff.mean())


# ---------------------------------------------------------------------------
# ImageFolderDataset
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [None, 7])
def test_folder_dataset_attributes_equal_jax(folder, cap):
    got = tp.ImageFolderDataset(folder, RES, num_examples=cap)
    want = jp.ImageFolderDataset(folder, RES, num_examples=cap)
    assert got.files == want.files and len(got.files) == (cap or 18)
    assert got.name == want.name == f"folder:{os.path.basename(folder)}@{RES}"
    assert got.num_examples == want.num_examples and got.image_shape == want.image_shape
    assert got.decoder == ("native" if native.available() else "pil")


def test_folder_pil_decode_equals_jax(folder):
    got = tp.ImageFolderDataset(folder, RES)
    want = jp.ImageFolderDataset(folder, RES)
    for fp in got.files:
        assert got._decode(fp).tobytes() == want._decode(fp).tobytes()


@pytest.mark.parametrize("seed,start_epoch,start_batch", [(0, 0, 0), (3, 1, 2), (7, 2, 0)])
def test_folder_stream_equals_jax(folder, seed, start_epoch, start_batch):
    # 18 images at batch 4: 4 batches an epoch, so 6 batches cross an epoch.
    kw = dict(seed=seed, start_epoch=start_epoch, start_batch=start_batch)
    got = take(tp.DataPipeline(tp.ImageFolderDataset(folder, RES), 4, **kw), 6)
    want = take(jp.DataPipeline(jp.ImageFolderDataset(folder, RES), 4, **kw), 6)
    assert [b.shape for b in got] == [(4, RES, RES, 3)] * 6
    assert [b.tobytes() for b in got] == [b.tobytes() for b in want]


@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_folder_materialize_equals_jax(folder, decoder, request, capsys):
    request.getfixturevalue("needs_native" if decoder == "native" else "pil_on_both")
    ds = tp.ImageFolderDataset(folder, RES)
    assert ds.decoder == decoder
    assert ("Pillow" in capsys.readouterr().err) == (decoder == "pil")
    got = ds.materialize(decode_batch=5)
    want = jp.ImageFolderDataset(folder, RES).materialize(decode_batch=5, progress=False)
    assert got.name == want.name and got.images.tobytes() == want.images.tobytes()
    # The stream of the folder equals that of its materialized array.
    kw = dict(seed=5, start_epoch=1, start_batch=1)
    assert [b.tobytes() for b in take(ds.batches(4, **kw), 5)] == \
        [b.tobytes() for b in take(got.batches(4, **kw), 5)]


def test_folder_pil_bad_file_raises_naming_it(tmp_path, pil_on_both):
    write_image(tmp_path / "000000.jpg", 40, 40, "JPEG", seed=0)
    (tmp_path / "000001.jpg").write_bytes(b"\xff\xd8\xff\xe0 truncated")
    ds = tp.ImageFolderDataset(str(tmp_path), RES)
    assert ds.decoder == "pil"
    with pytest.raises(IOError, match="failed to decode image: .*000001.jpg"):
        ds.materialize(progress=False)


def test_folder_without_a_decoder_raises_naming_both(folder, monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "build_error", lambda: "jpeglib.h: No such file")
    find_spec = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "PIL" else find_spec(name, *a))
    with pytest.raises(RuntimeError, match="jpeglib.h: No such file.*Pillow is not installed"):
        tp.ImageFolderDataset(folder, RES)


# ---------------------------------------------------------------------------
# write_shards and load_celeba
# ---------------------------------------------------------------------------


def shard_contents(root):
    names = sorted(n for n in os.listdir(root) if n.startswith("shard-"))
    return names, [np.load(os.path.join(root, n)).tobytes() for n in names]


@pytest.mark.parametrize("kind", ["folder", "array", "array_dataset"])
def test_write_shards_equals_jax(folder, tmp_path, kind):
    images = jp.synthetic_dataset((RES, RES, 3), 11, seed=4).images
    source = {"folder": lambda m: m.ImageFolderDataset(folder, RES),
              "array": lambda m: images,
              "array_dataset": lambda m: m.ArrayDataset(images)}[kind]
    got = tp.write_shards(source(tp), str(tmp_path / "port"), shard_size=5, progress=False)
    jp.write_shards(source(jp), str(tmp_path / "jax"), shard_size=5, progress=False)
    names, contents = shard_contents(tmp_path / "port")
    assert (names, contents) == shard_contents(tmp_path / "jax")
    assert len(names) == (4 if kind == "folder" else 3)
    assert isinstance(got, tp.ShardedArrayDataset)


def test_write_shards_refuses_a_directory_with_shards(tmp_path):
    images = jp.synthetic_dataset((RES, RES, 3), 4, seed=0).images
    tp.write_shards(images, str(tmp_path), shard_size=4, progress=False)
    with pytest.raises(FileExistsError, match="refusing to mix"):
        tp.write_shards(images, str(tmp_path), progress=False)


def test_load_celeba_shards_win_over_images(folder, tmp_path):
    d = tmp_path / "both"
    d.mkdir()
    write_image(d / "000000.jpg", 40, 40, "JPEG", seed=0)
    images = jp.synthetic_dataset((RES, RES, 3), 6, seed=1).images
    tp.write_shards(images, str(d), shard_size=4, progress=False)
    got, want = tp.load_celeba(str(d), resolution=RES), jp.load_celeba(str(d), resolution=RES)
    assert type(got).__name__ == type(want).__name__ == "ShardedArrayDataset"
    assert got.materialize().images.tobytes() == images.tobytes()


def test_load_celeba_empty_directory_raises(tmp_path):
    for load in (tp.load_celeba, jp.load_celeba):
        with pytest.raises(FileNotFoundError, match="no images under"):
            load(str(tmp_path), resolution=RES)


def test_load_celeba_without_synthetic_fallback_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("DATASETS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="no CelebA image dir found"):
        tp.load_celeba(resolution=RES, allow_synthetic_fallback=False)
    # The default search finds the folder under $DATASETS_DIR/celeba/img_align_celeba.
    os.makedirs(tmp_path / "celeba" / "img_align_celeba")
    write_image(tmp_path / "celeba" / "img_align_celeba" / "000001.jpg", 40, 50, "JPEG", 3)
    got = tp.load_celeba(resolution=RES, allow_synthetic_fallback=False)
    assert isinstance(got, tp.ImageFolderDataset) and got.files == jp.load_celeba(
        resolution=RES, allow_synthetic_fallback=False).files


# ---------------------------------------------------------------------------
# The make_shards CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def root_make_shards():
    spec = importlib.util.spec_from_file_location("root_make_shards",
                                                  REPO / "tools" / "make_shards.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kind", ["folder", "npz"])
def test_make_shards_equals_the_root_script(folder, tmp_path, root_make_shards, monkeypatch,
                                            kind):
    source = folder if kind == "folder" else write_mnist_npz(tmp_path / "mnist.npz", 30, 5)
    flags = ["--shard_size", "8", "--num_examples", "13"]
    if kind == "folder":
        flags += ["--resolution", str(RES)]
    make_shards.main([source, str(tmp_path / "port"), *flags])
    monkeypatch.setattr(sys, "argv", ["make_shards.py", source, str(tmp_path / "jax"), *flags])
    root_make_shards.main()
    names, contents = shard_contents(tmp_path / "port")
    assert names == ["shard-00000.npy", "shard-00001.npy"]
    assert (names, contents) == shard_contents(tmp_path / "jax")


def test_make_shards_flags_equal_the_root_script():
    parser = make_shards.build_parser()
    assert parser_flags(parser) == script_flags(REPO / "tools" / "make_shards.py")
    assert [a.dest for a in parser._actions if not a.option_strings] == ["source", "out_dir"]
    args = parser.parse_args(["a", "b"])
    assert (args.resolution, args.shard_size, args.num_examples) == (None, 4096, None)


def test_make_shards_refuses_resolution_with_npz(tmp_path):
    npz = write_mnist_npz(tmp_path / "mnist.npz", 8, 2)
    with pytest.raises(SystemExit, match="unsupported for mnist.npz"):
        make_shards.main([npz, str(tmp_path / "out"), "--resolution", "64"])
    assert make_shards.main([npz, str(tmp_path / "out"), "--resolution", "28"]).num_examples == 8


# ---------------------------------------------------------------------------
# The CelebA entry point on a folder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fit", "device_resident"])
def test_train_celeba_on_a_folder(folder, tmp_path, monkeypatch, capsys, mode):
    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)
    monkeypatch.setattr(train_celeba, "entry_point_feeders", lambda *a: [])
    argv = ["--resolution", str(RES), "--batch_size", "4", "--celeba_path", folder,
            "--device", "cpu", "--log_dir", str(tmp_path / "run"), "--max_steps", "1",
            "--sample_grid_every", "0", "--checkpoint_every", "0"]
    if mode == "device_resident":
        argv += ["--device_resident", "--chunk_steps", "1"]
    trainer = train_celeba.main(argv)
    out = capsys.readouterr().out
    assert trainer.state.n_batches == 1 and np.isfinite(trainer.history[0]["disc_loss"])
    want = jp.ImageFolderDataset(folder, RES).materialize(progress=False).images
    if mode == "fit":
        assert f"dataset=folder:{os.path.basename(folder)}@{RES} " in out
        assert isinstance(trainer.dataset, tp.ImageFolderDataset)
    else:
        assert "materializing 18 images" in out
        assert trainer.dataset.name.endswith(":materialized")
        assert trainer.chunk_runner.data.numpy().tobytes() == want.tobytes()
