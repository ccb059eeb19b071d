from blurred_gan_tpu_torch.models.dcgan import (
    DCGANDiscriminator,
    DCGANGenerator,
    celeba_discriminator,
    celeba_generator,
    mnist_discriminator,
    mnist_generator,
)
from blurred_gan_tpu_torch.models.layers import GaussianBlur

__all__ = [
    "DCGANDiscriminator",
    "DCGANGenerator",
    "GaussianBlur",
    "celeba_discriminator",
    "celeba_generator",
    "mnist_discriminator",
    "mnist_generator",
]
