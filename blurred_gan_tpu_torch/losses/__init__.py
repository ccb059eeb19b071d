"""The losses package's public names, as the JAX package's ``losses`` exports
them."""

from blurred_gan_tpu_torch.losses.wgan import (
    wgan_discriminator_loss,
    wgan_generator_loss,
    gradient_penalty,
    wgangp_discriminator_loss,
)

__all__ = [
    "wgan_discriminator_loss",
    "wgan_generator_loss",
    "gradient_penalty",
    "wgangp_discriminator_loss",
]
