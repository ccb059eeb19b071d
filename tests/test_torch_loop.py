"""The port's host loop and entry point on the CPU at a narrow size.

``Trainer.fit`` runs a few steps over the synthetic corpus with σ from
``BlurDecayController``; the entry point runs end to end; and a fresh
interpreter runs a step without ever importing jax (this test process
imports jax itself, in tests/conftest.py, hence the subprocess).
TensorBoard's writer is off (``_summary_writer`` returns None): where
TensorFlow is installed, ``torch.utils.tensorboard`` imports it.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from blurred_gan_tpu_torch import train_celeba
from blurred_gan_tpu_torch.data.pipeline import synthetic_dataset
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN
from blurred_gan_tpu_torch.utils import logging as logging_mod
from torch_threads import one_thread  # noqa: F401  (autouse: one intra-op thread)

NO_TENSORBOARD = """
import blurred_gan_tpu_torch.utils.logging as logging_mod
logging_mod._summary_writer = lambda log_dir: None
"""


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setattr(logging_mod, "_summary_writer", lambda log_dir: None)


def narrow_gan():
    return GAN(DCGANGenerator(latent_size=8, init_features=32,
                              blocks=((32, 1), (16, 2), (8, 2))),
               DCGANDiscriminator(channels=(8, 16), in_channels=3, image_hw=(16, 16)),
               latent_size=8)


def test_fit_three_steps(tmp_path):
    dataset = synthetic_dataset((16, 16, 3), num_examples=64)
    hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8)
    ctrl = BlurDecayController(total_n_training_examples=640, max_value=5.0)
    cfg = TrainerConfig(log_dir=str(tmp_path), log_metrics_every_n_examples=8, seed=0)
    trainer = Trainer(narrow_gan(), hp, dataset, device="cpu", trainer_config=cfg,
                      blur_controller=ctrl, config_sidecars={"hparams": hp})
    state = trainer.fit(total_examples=640, max_steps=3)
    assert state is trainer.state and state.n_batches == 3
    history = list(trainer.history)
    assert len(history) == 3
    for n, logs in enumerate(history):
        assert logs["std"] == pytest.approx(ctrl.sigma(n), rel=1e-6)
        assert logs["n_batches"] == n + 1 and logs["n_img"] == 8 * (n + 1)
        for k in ("disc_loss", "gen_loss", "gp_term", "wgan_loss"):
            assert np.isfinite(logs[k]), k
    lines = (tmp_path / "events.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines if "batch_disc_loss" in l] == [8, 16, 24]
    assert json.loads((tmp_path / "hyper_parameters.json").read_text())["batch_size"] == 8
    # A second call continues the counters, the data stream and the schedule.
    trainer.fit(total_examples=640, max_steps=2)
    more = list(trainer.history)[3:]
    assert [l["n_batches"] for l in more] == [4, 5]
    assert more[0]["std"] == pytest.approx(ctrl.sigma(3), rel=1e-6)


def test_fit_stops_at_total_examples(tmp_path):
    dataset = synthetic_dataset((16, 16, 3), num_examples=32)
    hp = BlurredWGANGPHyperParameters(batch_size=8, global_batch_size=8)
    trainer = Trainer(narrow_gan(), hp, dataset, device="cpu",
                      trainer_config=TrainerConfig(log_dir=str(tmp_path)))
    trainer.fit(total_examples=16)
    history = list(trainer.history)
    assert len(history) == 2
    assert all(l["std"] == pytest.approx(hp.initial_blur_std) for l in history)


def test_entry_point_cpu(tmp_path, capsys):
    trainer = train_celeba.main(["--resolution", "8", "--batch_size", "4", "--max_steps", "2",
                                 "--num_examples", "16", "--device", "cpu",
                                 "--gen_upsample", "resize", "--checkpoint_every", "0",
                                 "--log_dir", str(tmp_path)])
    history = list(trainer.history)
    assert len(history) == 2 and all(np.isfinite(l["disc_loss"]) for l in history)
    assert "[train_celeba] res=8 bs=4 device=cpu" in capsys.readouterr().out
    for name in ("hyper_parameters.json", "train_config.json", "run_manifest.json",
                 "events.jsonl", "samples_grid_00000004.png"):
        assert (tmp_path / name).exists(), name
    assert trainer.ckpt.all_steps() == [8]
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_entry_point_refuses_missing_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_celeba.main(["--resolution", "8", "--max_steps", "1", "--log_dir", str(tmp_path)])


def test_step_without_jax_in_a_fresh_process(tmp_path):
    code = NO_TENSORBOARD + f"""
import sys
import blurred_gan_tpu_torch
from blurred_gan_tpu_torch.train_celeba import main
trainer = main(["--resolution", "8", "--batch_size", "4", "--max_steps", "1",
                "--num_examples", "8", "--device", "cpu", "--checkpoint_every", "0",
                "--log_dir", {str(tmp_path)!r}])
assert len(trainer.history) == 1
assert "jax" not in sys.modules, "jax was imported"
assert not [m for m in sys.modules if m.split(".")[0] == "blurred_gan_tpu"]
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
