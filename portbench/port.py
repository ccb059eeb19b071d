"""The system under test: the port's objects built from a configuration
file, through the port's public API only. Nothing else in the benchmark
imports the port, except the traffic kinds that drive it."""

from __future__ import annotations

from typing import Dict

import torch

from blurred_gan_tpu_torch.entry import setup_device
from blurred_gan_tpu_torch.models.dcgan import DCGANDiscriminator, DCGANGenerator
from blurred_gan_tpu_torch.sched.blur import BlurDecayController
from blurred_gan_tpu_torch.train.config import BlurredWGANGPHyperParameters
from blurred_gan_tpu_torch.train.loop import Trainer, TrainerConfig
from blurred_gan_tpu_torch.train.state import GAN

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def device(name: str) -> torch.device:
    """The port's device set-up, as its entry points make it (TF32 off)."""
    return setup_device(name)


def gan(config: dict) -> GAN:
    """The generator and critic at the configuration's widths, in its compute
    dtype at the port's dtype boundaries (``train_celeba --bf16``)."""
    dtype = DTYPES[config["compute_dtype"]]
    g, d = config["generator"], config["critic"]
    h, w, c = config["image_shape"]
    generator = DCGANGenerator(
        latent_size=config["latent_size"], init_hw=tuple(g["init_hw"]),
        init_features=g["init_features"], blocks=tuple(tuple(b) for b in g["blocks"]),
        out_channels=c, final_transpose=g["final"] == "transpose",
        final_stride=g["final_stride"], compute_dtype=dtype)
    critic = DCGANDiscriminator(channels=tuple(d["channels"]), dropout_rate=d["dropout"],
                                in_channels=c, image_hw=(h, w), compute_dtype=dtype)
    return GAN(generator, critic, latent_size=config["latent_size"], blurred=True)


def hparams(config: dict) -> BlurredWGANGPHyperParameters:
    return BlurredWGANGPHyperParameters(
        learning_rate=config["learning_rate"], batch_size=config["batch_size"],
        global_batch_size=config["batch_size"], optimizer="adam",
        e_drift=config["e_drift"], gp_coefficient=config["gp_coefficient"],
        initial_blur_std=config["sigma0"])


def total_examples(config: dict) -> int:
    """The entry points' run length: the corpus times the epochs."""
    return config["corpus_size"] * config["epochs"]


def trainer(config: dict, dataset, dev: torch.device, log_dir: str, seed: int) -> Trainer:
    """The entry point's ``Trainer`` with the open-loop σ decay, its log
    cadence, and no sample grids, checkpoints or metric feeders on the way."""
    hp = hparams(config)
    return Trainer(
        gan(config), hp, dataset, device=dev,
        trainer_config=TrainerConfig(log_dir=log_dir, checkpoint_dir="",
                                     sample_grid_every_n_examples=0,
                                     checkpoint_every_n_examples=0, seed=seed),
        blur_controller=BlurDecayController(total_n_training_examples=total_examples(config),
                                            max_value=config["sigma0"]),
        config_sidecars={"hparams": hp})


@torch.no_grad()
def load(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]) -> None:
    """Every parameter and buffer of ``module`` set in place from ``tensors``."""
    module.load_state_dict(tensors, strict=True)


def sampler(config: dict, dev: torch.device, weights: Dict[str, torch.Tensor]):
    """``sample(latents) -> NCHW images``: ``train.step.make_sample_fn``'s
    eval-mode generator (running BatchNorm statistics), as
    ``generate_samples.sample_images`` calls it, on a train state holding
    ``weights``."""
    from blurred_gan_tpu_torch.train.state import create_train_state
    from blurred_gan_tpu_torch.train.step import make_sample_fn

    g = gan(config)
    state = create_train_state(g, hparams(config), device=dev)
    load(state.generator, weights)
    fn = make_sample_fn(g)
    return lambda latents: fn(state, latents)
