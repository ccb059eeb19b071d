"""The port imports neither jax nor anything of the JAX package.

A fresh interpreter (this test process imports jax itself, in
tests/conftest.py) imports every module of ``blurred_gan_tpu_torch``, runs one
CPU step of the entry point as ``python -m`` would, and imports
``chip_smoke``; then neither ``jax`` nor any ``blurred_gan_tpu`` module may be
in ``sys.modules``, nor Pillow, which the card's machine may lack, nor
``tensorflow``, which it lacks. Its own source files are checked the same
way. TensorBoard's writer is off in the
child (where TensorFlow is installed, ``torch.utils.tensorboard`` imports it,
which takes long and is beside the point here).
"""

import ast
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

CHILD = """
import importlib, pkgutil, runpy, sys
import blurred_gan_tpu_torch
names = [m.name for m in pkgutil.walk_packages(blurred_gan_tpu_torch.__path__,
                                               "blurred_gan_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert {"blurred_gan_tpu_torch.metrics.fid", "blurred_gan_tpu_torch.metrics.swd",
        "blurred_gan_tpu_torch.metrics.inception", "blurred_gan_tpu_torch.train.checkpoint",
        "blurred_gan_tpu_torch.train.hooks", "blurred_gan_tpu_torch.utils.config",
        "blurred_gan_tpu_torch.utils.images", "blurred_gan_tpu_torch.utils.logging",
        "blurred_gan_tpu_torch.utils.rundir", "blurred_gan_tpu_torch.utils.watchdog",
        "blurred_gan_tpu_torch.train.fast", "blurred_gan_tpu_torch.train_mnist",
        "blurred_gan_tpu_torch.entry", "blurred_gan_tpu_torch.serving",
        "blurred_gan_tpu_torch.generate_samples", "blurred_gan_tpu_torch.tools",
        "blurred_gan_tpu_torch.tools.export_generator", "blurred_gan_tpu_torch.tools.evaluate_run",
        "blurred_gan_tpu_torch.tools.score", "blurred_gan_tpu_torch.metrics.kid",
        "blurred_gan_tpu_torch.metrics.prdc", "blurred_gan_tpu_torch.utils.profiling",
        "blurred_gan_tpu_torch.native", "blurred_gan_tpu_torch.tools.make_shards",
        "blurred_gan_tpu_torch.runtime", "blurred_gan_tpu_torch.parallel",
        "blurred_gan_tpu_torch.dryrun", "blurred_gan_tpu_torch.tools.diagnose_samples",
        "blurred_gan_tpu_torch.tools.bn_stats_ab", "blurred_gan_tpu_torch.tools.convert_inception",
        "blurred_gan_tpu_torch.bench", "blurred_gan_tpu_torch.quality"} <= set(names), names
import blurred_gan_tpu_torch.utils.logging as logging_mod
logging_mod._summary_writer = lambda log_dir: None
sys.argv = ["train_celeba", "--resolution", "16", "--batch_size", "4", "--num_examples", "32",
            "--max_steps", "1", "--device", "cpu", "--log_dir", sys.argv[1]]
runpy.run_module("blurred_gan_tpu_torch.train_celeba", run_name="__main__", alter_sys=True)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "blurred_gan_tpu"
             or m.startswith("blurred_gan_tpu."))
assert not bad, bad
# The card's machine may have no Pillow: it is imported only to decode with it.
# Nor tensorflow: convert_inception imports it only to read a TF-slim checkpoint.
pil = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "tensorflow"))
assert not pil, pil
print("imported", len(names), "modules")
"""


def test_port_imports_nothing_of_jax(tmp_path):
    datasets = tmp_path / "datasets"  # no CelebA here: the synthetic corpus
    datasets.mkdir()
    env = dict(os.environ, DATASETS_DIR=str(datasets), PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path / "log")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "[train_celeba] res=16 bs=4 device=cpu" in out.stdout
    for name in ("events.jsonl", "hyper_parameters.json", "train_config.json",
                 "run_manifest.json", "checkpoints/4.pt"):
        assert (tmp_path / "log" / name).exists(), name


def test_no_source_file_names_the_jax_package():
    files = sorted((REPO / "blurred_gan_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "blurred_gan_tpu", "flax"), f"{path}: imports {mod}"
