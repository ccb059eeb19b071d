"""The port's subpackages export the JAX package's public names, and the
helpers behind the names the port lacked agree with the JAX package's.

Each subpackage's ``__all__`` equals the JAX one's, read from its
``__init__.py`` with ``ast``, less the names the port does not carry (named
once, in ``NOT_PORTED``). Importing the seven re-exporting packages in a
fresh interpreter builds or loads neither the blur kernel nor the native
image decoder, and imports neither Pillow, ``tensorflow`` nor ``jax``.
Tolerances: the pyramid and its inverse atol 1e-5 (test_torch_metrics.py's);
the average pooling atol 1e-6; the rest exact.
"""

import ast
import importlib
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blurred_gan_tpu.metrics import swd as jswd
from blurred_gan_tpu.models import celeba_discriminator as jax_celeba_d
from blurred_gan_tpu.models import celeba_generator as jax_celeba_g
from blurred_gan_tpu.models import mnist_generator as jax_mnist_g
from blurred_gan_tpu.ops.blur import maximum_reasonable_std as jax_maximum_reasonable_std
from blurred_gan_tpu.train.state import count_params as jax_count_params
from blurred_gan_tpu.utils import images as jimages
from blurred_gan_tpu_torch.metrics import swd
from blurred_gan_tpu_torch.models.dcgan import (
    celeba_discriminator, celeba_generator, mnist_generator)
from blurred_gan_tpu_torch.ops.blur import maximum_reasonable_std
from blurred_gan_tpu_torch.train.state import count_params
from blurred_gan_tpu_torch.utils import images
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

REPO = pathlib.Path(__file__).resolve().parents[1]
SUBPACKAGES = ("train", "metrics", "ops", "data", "sched", "utils", "losses")
# The JAX package's names the port does not carry: ChunkRunner takes
# make_chunked_train_fn's place (train/fast.py), and the wide counters guard
# an int32 counter that the port's Python ints do not need (ROADMAP "Not to
# port").
NOT_PORTED = {"train": {"make_chunked_train_fn", "wide_counter", "wide_add", "wide_value"}}


def jax_all(subpackage):
    tree = ast.parse((REPO / "blurred_gan_tpu" / subpackage / "__init__.py").read_text())
    (names,) = [node.value for node in tree.body if isinstance(node, ast.Assign)
                and [t.id for t in node.targets] == ["__all__"]]
    return [ast.literal_eval(e) for e in names.elts]


@pytest.mark.parametrize("subpackage", SUBPACKAGES)
def test_all_equals_the_jax_packages(subpackage):
    port = importlib.import_module(f"blurred_gan_tpu_torch.{subpackage}")
    want = [n for n in jax_all(subpackage) if n not in NOT_PORTED.get(subpackage, ())]
    assert port.__all__ == want
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def test_the_exceptions_are_jax_names():
    for subpackage, names in NOT_PORTED.items():
        assert names <= set(jax_all(subpackage))


CHILD = """
import sys
import blurred_gan_tpu_torch.train, blurred_gan_tpu_torch.metrics, blurred_gan_tpu_torch.ops
import blurred_gan_tpu_torch.data, blurred_gan_tpu_torch.sched, blurred_gan_tpu_torch.utils
import blurred_gan_tpu_torch.losses
from blurred_gan_tpu_torch import native
from blurred_gan_tpu_torch.ops import blur_cuda
assert blur_cuda._library.cache_info().currsize == 0
assert native._lib is None and native._build_error is None
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "tensorflow", "jax"))
assert not bad, bad
from blurred_gan_tpu_torch.train import Trainer
print(Trainer.__module__)
"""


def test_reexports_load_no_kernel_decoder_or_imaging():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split() == ["blurred_gan_tpu_torch.train.loop"]


@pytest.mark.parametrize("res", [8, 16, 28, 64, 128, 256])
def test_maximum_reasonable_std(res):
    assert maximum_reasonable_std(res) == jax_maximum_reasonable_std(res)


def test_reconstruct_laplacian_pyramid():
    x = np.random.RandomState(0).uniform(-1, 1, (1, 32, 24, 3)).astype(np.float32)
    want = jswd.reconstruct_laplacian_pyramid(jswd.laplacian_pyramid(jnp.asarray(x), 2))
    pyramid = swd.laplacian_pyramid(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    got = swd.reconstruct_laplacian_pyramid(pyramid)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), x, rtol=0, atol=1e-5)


@pytest.mark.parametrize("lod", [0, 1, 2])
def test_downscale_minibatch(lod):
    x = np.random.RandomState(1).uniform(-1, 1, (3, 32, 16, 2)).astype(np.float32)
    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = swd.downscale_minibatch(t, lod)
    want = np.asarray(jswd.downscale_minibatch(jnp.asarray(x), lod))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-6)
    if lod == 0:
        assert got is t


def test_layout_transposes():
    x = np.random.RandomState(2).rand(2, 5, 4, 3).astype(np.float32)
    nchw = images.NHWC_to_NCHW(torch.from_numpy(x))
    np.testing.assert_array_equal(nchw.numpy(), jimages.NHWC_to_NCHW(x))
    np.testing.assert_array_equal(images.NHWC_to_NCHW(x), jimages.NHWC_to_NCHW(x))
    np.testing.assert_array_equal(images.NCHW_to_NHWC(nchw).numpy(), x)
    y = jimages.NHWC_to_NCHW(x)
    np.testing.assert_array_equal(images.NCHW_to_NHWC(y), jimages.NCHW_to_NHWC(y))


@pytest.mark.parametrize("pair", ["celeba16_g", "celeba16_d", "mnist_g"])
def test_count_params(pair):
    port, jax_module, shape = {
        "celeba16_g": (celeba_generator(16), jax_celeba_g(16), (1, 100)),
        "celeba16_d": (celeba_discriminator(16), jax_celeba_d(16), (1, 16, 16, 3)),
        "mnist_g": (mnist_generator(), jax_mnist_g(), (1, 100)),
    }[pair]
    variables = jax.eval_shape(lambda: jax_module.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros(shape), train=False))
    assert count_params(port) == jax_count_params(variables["params"])
    assert count_params(port.state_dict()) == sum(t.numel() for t in port.state_dict().values())
