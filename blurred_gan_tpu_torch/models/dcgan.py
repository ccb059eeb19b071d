"""DCGAN generator / critic pairs (port of ``blurred_gan_tpu/models/dcgan.py``).

NCHW throughout. The layers reproduce flax's numerics so that weights carried
over by ``blurred_gan_tpu_torch.convert`` give the JAX package's outputs:

- stride-2 SAME convolution pads (1, 2) on each spatial axis, not 2 / 2;
- SAME transposed convolution is a padding-0 ``conv_transpose2d`` cropped the
  way ``lax.conv_transpose`` pads (the kernel is stored flipped, in torch's
  ``(in, out, kh, kw)`` layout);
- the generator's Dense output is laid out (h, w, c) as flax's NHWC reshape,
  and the critic flattens NHWC before its Dense;
- BatchNorm: momentum 0.99, epsilon 1e-3, running variance updated with the
  *biased* batch variance (flax), unlike ``nn.BatchNorm2d``;
- LeakyReLU 0.3, glorot-uniform kernels, zero biases, bias-free generator convs,
  critic dropout 0.3.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LEAKY_SLOPE = 0.3  # tf.keras.layers.LeakyReLU default
KERNEL = 5


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's SAME for one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _conv_transpose_pad_lo(k: int, s: int) -> int:
    """Low-side padding ``lax.conv_transpose(..., 'SAME')`` applies to the
    stride-dilated input."""
    pad_len = k + s - 2
    return k - 1 if s > k - 1 else -(-pad_len // 2)


class SameConv2d(nn.Module):
    """flax ``nn.Conv(padding="SAME")``; weight (out, in, kh, kw)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bias: bool = True):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, KERNEL, KERNEL))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        ph = _same_pads(x.shape[2], KERNEL, self.stride)
        pw = _same_pads(x.shape[3], KERNEL, self.stride)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, stride=self.stride)


class SameConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(padding="SAME")``, bias-free; weight (in, out,
    kh, kw) holding the spatially flipped flax kernel. Output is ``stride``
    times the input size."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, KERNEL, KERNEL))
        self.register_parameter("bias", None)

    def forward(self, x):
        h, w = x.shape[2], x.shape[3]
        pad = KERNEL - 1 - _conv_transpose_pad_lo(KERNEL, self.stride)
        y = F.conv_transpose2d(x, self.weight, stride=self.stride, padding=pad)
        return y[:, :, :self.stride * h, :self.stride * w]


class BatchNorm(nn.Module):
    """flax/tf.keras BatchNorm over dim 1 (features or channels).

    Train mode normalises with the biased batch statistics and updates the
    running buffers as ``r = 0.99 r + 0.01 batch`` with the biased variance;
    eval mode uses the running buffers.
    """

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-3):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        if self.training:
            dims = [0, *range(2, x.dim())]
            var, mean = torch.var_mean(x, dim=dims, correction=0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    mean.detach(), alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(
                    var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.reshape(shape)) * scale.reshape(shape) + self.bias.reshape(shape)


def _leaky(x):
    return F.leaky_relu(x, LEAKY_SLOPE)


class Upsample(nn.Module):
    """One generator up-stage: ConvTranspose(5x5, s), or for ``resize`` with
    ``s > 1`` nearest-neighbour ``s``x then Conv(5x5, s1). Bias-free."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, mode: str):
        super().__init__()
        self.stride = stride
        self.resize = mode == "resize" and stride > 1
        self.conv = (SameConv2d(in_ch, out_ch, 1, bias=False) if self.resize
                     else SameConvTranspose2d(in_ch, out_ch, stride))

    @property
    def flax_kind(self) -> str:
        return "Conv" if self.resize else "ConvTranspose"

    def forward(self, x):
        if self.resize:
            x = x.repeat_interleave(self.stride, dim=2).repeat_interleave(
                self.stride, dim=3)
        return self.conv(x)


class DCGANGenerator(nn.Module):
    """Dense -> BN -> reshape -> [up + BN + LeakyReLU]* -> (up | Conv) tanh.

    Train/eval mode (``.train()`` / ``.eval()``) switches BatchNorm between
    batch and running statistics, as flax's ``train`` flag does.
    """

    def __init__(self, latent_size: int = 100, init_hw: Tuple[int, int] = (4, 4),
                 init_features: int = 512,
                 blocks: Sequence[Tuple[int, int]] = ((512, 1), (256, 2), (128, 2), (64, 2)),
                 out_channels: int = 3, final_transpose: bool = False,
                 final_stride: int = 1, upsample: str = "transpose",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if upsample not in ("transpose", "resize"):
            raise ValueError(f"upsample must be 'transpose' or 'resize', got {upsample!r}")
        self.latent_size = latent_size
        self.init_hw = tuple(init_hw)
        self.init_features = init_features
        h0, w0 = self.init_hw
        self.dense = nn.Linear(latent_size, h0 * w0 * init_features, bias=False)
        self.dense_bn = BatchNorm(h0 * w0 * init_features)
        ups, bns, ch = [], [], init_features
        for features, stride in blocks:
            ups.append(Upsample(ch, features, stride, upsample))
            bns.append(BatchNorm(features))
            ch = features
        self.ups = nn.ModuleList(ups)
        self.bns = nn.ModuleList(bns)
        self.final = (Upsample(ch, out_channels, final_stride, upsample) if final_transpose
                      else SameConv2d(ch, out_channels, final_stride, bias=False))
        init_weights(self, generator)

    def forward(self, z):
        h0, w0 = self.init_hw
        x = _leaky(self.dense_bn(self.dense(z)))
        # flax reshapes the Dense output as NHWC; NCHW from there on.
        x = x.reshape(x.shape[0], h0, w0, self.init_features).permute(0, 3, 1, 2)
        for up, bn in zip(self.ups, self.bns):
            x = _leaky(bn(up(x)))
        return torch.tanh(self.final(x))


class DCGANDiscriminator(nn.Module):
    """[Conv s2 + LeakyReLU + Dropout]* -> NHWC flatten -> Dense(1).

    Dropout is active in train mode and draws its masks from the
    ``generator`` passed to ``forward``.
    """

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dropout_rate: float = 0.3, in_channels: int = 3,
                 image_hw: Tuple[int, int] = (128, 128),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        convs, ch = [], in_channels
        h, w = image_hw
        for out_ch in channels:
            convs.append(SameConv2d(ch, out_ch, 2))
            ch, h, w = out_ch, -(-h // 2), -(-w // 2)
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(ch * h * w, 1)
        init_weights(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        keep = 1.0 - self.dropout_rate
        for conv in self.convs:
            x = _leaky(conv(x))
            if self.training and self.dropout_rate > 0:
                mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.dense(x.permute(0, 2, 3, 1).flatten(1))


def init_weights(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Glorot-uniform kernels and zero biases (tf.keras / flax defaults),
    drawn from ``generator`` (the global generator if None)."""
    for m in module.modules():
        if isinstance(m, (SameConv2d, SameConvTranspose2d, nn.Linear)):
            nn.init.xavier_uniform_(m.weight, generator=generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


# ---------------------------------------------------------------------------
# Named configurations matching the JAX package
# ---------------------------------------------------------------------------


def mnist_generator(latent_size: int = 100, upsample: str = "transpose", generator=None):
    """28x28x1 generator."""
    return DCGANGenerator(latent_size=latent_size, init_hw=(7, 7), init_features=256,
                          blocks=((128, 1), (64, 2)), out_channels=1,
                          final_transpose=True, final_stride=2, upsample=upsample,
                          generator=generator)


def mnist_discriminator(generator=None):
    """28x28x1 critic."""
    return DCGANDiscriminator(channels=(64, 128), in_channels=1, image_hw=(28, 28),
                              generator=generator)


def _check_resolution(resolution: int) -> None:
    if resolution < 8 or resolution & (resolution - 1):
        raise ValueError(f"resolution must be a power of two >= 8, got {resolution}")


def celeba_generator(resolution: int = 128, latent_size: int = 100,
                     upsample: str = "transpose", generator=None):
    """CelebA generator at a power-of-two resolution >= 8 (4x4x512 -> up-stages
    -> Conv tanh; at 128 the 512 -> 16 stack)."""
    _check_resolution(resolution)
    n_up = resolution.bit_length() - 3
    chans = [512, 256, 128, 64, 32, 16]
    blocks = [(512, 1)] + [(chans[min(i + 1, len(chans) - 1)], 2) for i in range(n_up)]
    return DCGANGenerator(latent_size=latent_size, init_hw=(4, 4), init_features=512,
                          blocks=tuple(blocks), out_channels=3, final_transpose=False,
                          final_stride=1, upsample=upsample, generator=generator)


def celeba_discriminator(resolution: int = 128, generator=None):
    """CelebA critic; at 128 the 16 -> 512 stride-2 stack (down to 2x2)."""
    _check_resolution(resolution)
    n_down = resolution.bit_length() - 2
    chans = [16, 32, 64, 128, 256, 512]
    channels = tuple(chans[max(0, len(chans) - n_down):])
    return DCGANDiscriminator(channels=channels, in_channels=3,
                              image_hw=(resolution, resolution), generator=generator)
