"""The GAN definition and its train state (port of ``blurred_gan_tpu/train/state.py``).

Modules and optimizers are updated in place; the progress counters are plain
Python ints (exact at any size, so the JAX package's two-word counter is not
needed). σ is a step input, never state. Adam is built non-capturable, its
step counters on the CPU, as ``Trainer.fit`` runs it; the chunked mode
(``train/fast.py``) switches it to ``capturable`` (:func:`set_capturable`:
step counters on the card, an update that reads nothing back to the host) so
the whole train step can be captured in a CUDA graph. The two settings round
Adam's bias correction differently, so the two modes agree to float32
rounding, not to the bit. The chunked runner keeps its own device copy of the
batch counter for σ and the adaptive controller; the ints here stay the
host's record, advanced per executed step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from blurred_gan_tpu_torch.models.dcgan import init_weights
from blurred_gan_tpu_torch.ops.blur import blur_images


@dataclass
class GAN:
    """The two networks and the blur composition.

    ``blurred=True`` puts the Gaussian blur in front of the critic: reals,
    fakes and the penalty's interpolates all pass through it.
    ``blur_impl``: ``"auto"``/``"cuda"`` (the kernel on a CUDA tensor) or
    ``"torch"`` (the plain version).
    """

    generator: nn.Module
    discriminator: nn.Module
    latent_size: int = 100
    blurred: bool = True
    blur_impl: str = "auto"

    def sample_latents(self, batch: int, generator: torch.Generator, device) -> torch.Tensor:
        """Uniform [0, 1) latents."""
        return torch.rand((batch, self.latent_size), generator=generator, device=device)

    def generate(self, z, *, train: bool):
        """Generator forward; ``train`` selects batch statistics (and updates
        the running ones) over running statistics."""
        self.generator.train(train)
        return self.generator(z)

    def critic(self, images, sigma, *, train: bool, generator=None):
        """Blur (if configured) then score. ``train`` turns dropout on."""
        x = blur_images(images, sigma, impl=self.blur_impl) if self.blurred else images
        self.discriminator.train(train)
        return self.discriminator(x, generator=generator)


def make_optimizer(name: str, params, learning_rate: float) -> torch.optim.Optimizer:
    """Adam with tf.keras's epsilon 1e-7 (the JAX package's ``optax.adam``)."""
    if name.lower() == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)
    raise NotImplementedError(
        f"optimizer {name!r} is not ported yet (ROADMAP queue 1, step variants)")


def set_capturable(opt: torch.optim.Optimizer, capturable: bool) -> None:
    """Switch ``opt`` to ``capturable`` or back, moving each step counter
    where the setting keeps it: on its parameter's device if capturable, else
    on the CPU. A group already so set is left alone. The step counters are
    new tensors afterwards, so a CUDA graph captured before the switch no
    longer updates them."""
    for group in opt.param_groups:
        if group.get("capturable", False) == capturable:
            continue
        group["capturable"] = capturable
        for p in group["params"]:
            slots = opt.state.get(p)
            if slots and "step" in slots:
                slots["step"] = slots["step"].to(device=p.device if capturable else "cpu",
                                                 dtype=torch.float32)


@dataclass
class TrainState:
    """Everything a step updates: modules, optimizers, counters, and the
    generator that the step reseeds for its random draws."""

    generator: nn.Module
    discriminator: nn.Module
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    rng: torch.Generator
    n_img: int = 0       # images seen: the global step
    n_batches: int = 0   # steps taken


def create_train_state(gan: GAN, hparams, *, device, seed: int = 0) -> TrainState:
    """Initialise both networks from ``seed`` (on the CPU, so the weights do
    not depend on the device), move them to ``device`` and build the
    optimizers."""
    device = torch.device(device)
    init_rng = torch.Generator().manual_seed(seed)
    init_weights(gan.generator, init_rng)
    init_weights(gan.discriminator, init_rng)
    gan.generator.to(device)
    gan.discriminator.to(device)
    lr = hparams.learning_rate
    return TrainState(
        generator=gan.generator,
        discriminator=gan.discriminator,
        g_opt=make_optimizer(hparams.optimizer, gan.generator.parameters(), lr),
        d_opt=make_optimizer(hparams.optimizer, gan.discriminator.parameters(), lr),
        rng=torch.Generator(device=device),
    )
