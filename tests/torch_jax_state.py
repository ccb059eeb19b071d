"""The JAX package's process-wide state that the port's tests compare against,
made what they assume, whatever an earlier test in the same worker left.

- The native image loader (``blurred_gan_tpu/native/__init__.py``) compiles to
  a temporary path that every process shares (``<so>.tmp``) and then renames
  it. When several test workers reach their first build together, the ones
  whose rename finds the file already moved get ``FileNotFoundError``, and
  the loader caches that error for the life of the process: the JAX package
  then decodes with Pillow while the port, whose build is safe for
  concurrent processes, decodes natively. :func:`ensure_jax_native` builds
  under a file lock that every caller shares, and where this process lost
  that race (an error cached while the library now exists) it clears the
  cached error for the test through ``monkeypatch`` and loads the library
  again.
- JAX's default random generator: the root ``train_celeba.py``,
  ``train_mnist.py`` and ``bench.py`` switch it to ``rbg`` when imported (the
  JAX package's tests import them), while the port's tests that pin draws
  repeat threefry's. A module that does imports :func:`threefry_prng`, an
  autouse fixture that sets threefry for the module and puts back what was
  there.
"""

from __future__ import annotations

import fcntl
import os
import tempfile

import jax
import pytest

from blurred_gan_tpu import native as jax_native

LOCK = os.path.join(tempfile.gettempdir(), "blurred_gan_tpu_native_build.lock")


def ensure_jax_native(monkeypatch) -> bool:
    """Whether the JAX package's native loader is available to this test,
    after building it under the shared lock and retrying a lost race."""
    with open(LOCK, "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if jax_native.available():
                return True
            if os.path.exists(jax_native._so_path()):
                # Lost the first-build race: the library is there, only the
                # cached error says otherwise. Both globals go back as they
                # were when the test ends.
                monkeypatch.setattr(jax_native, "_build_error", None)
                monkeypatch.setattr(jax_native, "_lib", None)
            return jax_native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


@pytest.fixture(scope="module", autouse=True)
def threefry_prng():
    """JAX's default generator set to threefry for the importing module."""
    impl = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", impl)
