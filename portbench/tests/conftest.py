import pytest


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """The port's logger writes no TensorBoard events here: where
    TensorFlow is installed its import is slow and loads JAX."""
    import blurred_gan_tpu_torch.utils.logging as logging

    monkeypatch.setattr(logging, "_summary_writer", lambda log_dir: None)
