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

The optimizers are the JAX package's: Adam, plain SGD, and optax's RMSprop
(:class:`RMSprop`, whose arithmetic ``torch.optim.RMSprop`` does not share).
With ``g_learning_rate`` set (TTUR) the generator's optimizer takes it. With
``ema_decay > 0`` the state carries ``g_ema``, an exponential moving average of
the generator's parameters (not of its BatchNorm statistics), one tensor per
parameter in ``generator.parameters()`` order, starting at the initial weights.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

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

    def critic(self, images, sigma, *, train: bool, generator=None, rows=None):
        """Blur (if configured) then score. ``train`` turns dropout on;
        ``rows``: the dropout rows of a data-parallel process
        (``DCGANDiscriminator``)."""
        x = blur_images(images, sigma, impl=self.blur_impl) if self.blurred else images
        self.discriminator.train(train)
        return self.discriminator(x, generator=generator, rows=rows)


class RMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr)`` at its defaults: ``ν ← d·ν + (1−d)·g²`` from
    ``ν = 0``, then ``p ← p − lr·g/√(ν + ε)`` with ε inside the root; no
    momentum, no centring, no bias correction. ``torch.optim.RMSprop`` keeps ε
    outside the root and defaults to ``d = 0.99``. No step counter and no host
    read, so a CUDA graph can capture :meth:`step`."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            for p in params:
                if not self.state[p]:
                    self.state[p]["nu"] = torch.zeros_like(p)
            nus = [self.state[p]["nu"] for p in params]
            d = group["decay"]
            # optax's order: (1 − d)·g² + d·ν, then g·rsqrt(ν + ε) scaled by −lr.
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(sq, 1.0 - d)
            torch._foreach_mul_(nus, d)
            torch._foreach_add_(nus, sq)
            upd = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(upd)
            torch._foreach_mul_(upd, grads)
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(params, upd)


def make_optimizer(name: str, params, learning_rate: float) -> torch.optim.Optimizer:
    """The JAX package's ``make_optimizer``: Adam with tf.keras's epsilon 1e-7
    (``optax.adam``), plain SGD (``optax.sgd``), or :class:`RMSprop`
    (``optax.rmsprop``)."""
    name = name.lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-7)
    if name == "sgd":
        return torch.optim.SGD(params, lr=learning_rate)
    if name == "rmsprop":
        return RMSprop(params, lr=learning_rate)
    raise ValueError(f"unknown optimizer {name!r}")


def set_capturable(opt: torch.optim.Optimizer, capturable: bool) -> None:
    """Switch ``opt`` to ``capturable`` or back, moving each step counter
    where the setting keeps it: on its parameter's device if capturable, else
    on the CPU. A group already so set is left alone, and so is an optimizer
    without the setting (SGD, :class:`RMSprop`: they keep no step counter).
    The step counters are new tensors afterwards, so a CUDA graph captured
    before the switch no longer updates them."""
    if "capturable" not in opt.defaults:
        return
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
    g_ema: Optional[List[torch.Tensor]] = None  # with ema_decay > 0


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
    g_lr = float(getattr(hparams, "g_learning_rate", 0.0) or 0.0) or lr
    use_ema = float(getattr(hparams, "ema_decay", 0.0) or 0.0) > 0.0
    return TrainState(
        generator=gan.generator,
        discriminator=gan.discriminator,
        g_opt=make_optimizer(hparams.optimizer, gan.generator.parameters(), g_lr),
        d_opt=make_optimizer(hparams.optimizer, gan.discriminator.parameters(), lr),
        rng=torch.Generator(device=device),
        g_ema=([p.detach().clone() for p in gan.generator.parameters()] if use_ema else None),
    )


def count_params(tree) -> int:
    """Elements of a module's parameters, or of every tensor of a mapping
    (a state dict)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    return sum(t.numel() for t in tree.values())
