"""The standalone Gaussian-blur layer (port of ``blurred_gan_tpu/models/layers.py``).

σ enters through the call, or from the non-trainable ``blur_std`` buffer when
the call gives none. The training path composes the blur functionally
(``train/state.py:GAN.critic``); this layer is for models assembled by hand.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from blurred_gan_tpu_torch.ops.blur import blur_images


class GaussianBlur(nn.Module):
    """Separable Gaussian blur of an NCHW batch with a runtime σ."""

    def __init__(self, initial_std: float = 0.05, impl: str = "auto"):
        super().__init__()
        self.impl = impl
        self.register_buffer("blur_std", torch.tensor(initial_std, dtype=torch.float32))

    def forward(self, x, sigma=None):
        return blur_images(x, self.blur_std if sigma is None else sigma, impl=self.impl)
