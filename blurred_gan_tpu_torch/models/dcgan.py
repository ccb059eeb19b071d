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

Parameters are float32. ``compute_dtype`` (bfloat16 for ``--bf16``) moves the
JAX package's dtype boundaries, not autocast's:

- each Dense, Conv and ConvTranspose casts its input and its float32 weight
  (and bias) to ``compute_dtype`` and returns that dtype (flax's
  ``promote_dtype``; a Conv's bias is added to the rounded product, as
  flax adds it), except the generator's products whose consumer
  computes in float32 (``f32_sums``: the Dense and every up-stage, which feed
  a float32 BatchNorm, and the last convolution when the tanh is float32):
  those return the float32 sums of their ``compute_dtype`` operands, as the
  JAX package's default compile keeps them (XLA's excess precision drops the
  round trip through bfloat16 before a float32 consumer). The product then
  runs in float32, exact for bfloat16 operands with TF32 off (the entry
  points turn it off); its input and weight gradients are rounded to
  ``compute_dtype`` as before;
- BatchNorm computes its statistics and its normalise / scale / shift in
  float32 and casts only the result to its ``dtype`` (flax's ``_normalize``);
  the generator's ``bn_dtype`` defaults to float32;
- the generator casts to float32 before its tanh unless ``output_f32`` is
  False;
- the critic casts its input to ``compute_dtype`` and its flattened features
  back to float32 before its float32 Dense.

At the defaults every cast is to the dtype a tensor already has, a no-op.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from blurred_gan_tpu_torch.parallel import all_reduce_sum
from blurred_gan_tpu_torch.runtime import process_count

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


def _cast(t: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    """``t`` in ``dtype`` (itself if it is already, or None)."""
    return t if t is None else t.to(dtype)


def _product(fn, x, w, *args, f32_sums: bool = False, **kw):
    """``fn(x, w, *args, **kw)`` for operands already in the compute dtype;
    with ``f32_sums`` and operands below float32, on their float32 values, so
    that the result is the unrounded float32 sums."""
    if f32_sums and x.dtype != torch.float32:
        x, w = x.float(), w.float()
        args = [_cast(a, torch.float32) if torch.is_tensor(a) else a for a in args]
    return fn(x, w, *args, **kw)


class SameConv2d(nn.Module):
    """flax ``nn.Conv(padding="SAME")``; weight (out, in, kh, kw). Computes
    in ``compute_dtype``; ``f32_sums``: returns float32 sums (module
    docstring)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, bias: bool = True,
                 compute_dtype: torch.dtype = torch.float32, f32_sums: bool = False):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.f32_sums = f32_sums
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, KERNEL, KERNEL))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if bias else None

    def forward(self, x):
        dt = self.compute_dtype
        ph = _same_pads(x.shape[2], KERNEL, self.stride)
        pw = _same_pads(x.shape[3], KERNEL, self.stride)
        x = F.pad(_cast(x, dt), (pw[0], pw[1], ph[0], ph[1]))
        w, b = _cast(self.weight, dt), _cast(self.bias, dt)
        if b is None or dt == torch.float32:
            return _product(F.conv2d, x, w, b, stride=self.stride, f32_sums=self.f32_sums)
        # flax adds the bias to the product's result, in the compute dtype:
        # below float32 that rounds twice, where a fused bias rounds once.
        y = _product(F.conv2d, x, w, stride=self.stride, f32_sums=self.f32_sums)
        return y + b.reshape(1, -1, 1, 1)


class SameConvTranspose2d(nn.Module):
    """flax ``nn.ConvTranspose(padding="SAME")``, bias-free; weight (in, out,
    kh, kw) holding the spatially flipped flax kernel. Output is ``stride``
    times the input size. Computes in ``compute_dtype``; ``f32_sums`` as
    :class:`SameConv2d`."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32, f32_sums: bool = False):
        super().__init__()
        self.stride = stride
        self.compute_dtype = compute_dtype
        self.f32_sums = f32_sums
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, KERNEL, KERNEL))
        self.register_parameter("bias", None)

    def forward(self, x):
        dt = self.compute_dtype
        h, w = x.shape[2], x.shape[3]
        pad = KERNEL - 1 - _conv_transpose_pad_lo(KERNEL, self.stride)
        y = _product(F.conv_transpose2d, _cast(x, dt), _cast(self.weight, dt),
                     stride=self.stride, padding=pad, f32_sums=self.f32_sums)
        return y[:, :, :self.stride * h, :self.stride * w]


class BatchNorm(nn.Module):
    """flax/tf.keras BatchNorm over dim 1 (features or channels).

    Train mode normalises with the biased batch statistics and updates the
    running buffers as ``r = 0.99 r + 0.01 batch`` with the biased variance;
    eval mode uses the running buffers. Statistics and arithmetic are float32
    whatever the input's dtype; the result is cast to ``dtype``.

    In a data-parallel run (a process group of more than one) the train-mode
    statistics are the global batch's (the JAX step's cross-replica
    BatchNorm): a differentiable all-reduce of the per-feature count and sum,
    then one of the squared deviations from the global mean (two passes, as
    ``torch.var_mean`` takes them in one process). Every process then holds
    the same running statistics.
    """

    def __init__(self, num_features: int, momentum: float = 0.99, eps: float = 1e-3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        # Two casts, one for the statistics and one for the normalisation, as
        # flax has: under bfloat16 the backward then rounds each path's
        # gradient to bfloat16 before their sum, as JAX's does.
        if self.training:
            dims = [0, *range(2, x.dim())]
            if process_count() > 1:
                mean, var = _global_moments(x.to(torch.float32), dims)
            else:
                var, mean = torch.var_mean(x.to(torch.float32), dim=dims, correction=0)
            with torch.no_grad():
                self.running_mean.mul_(self.momentum).add_(
                    mean.detach(), alpha=1.0 - self.momentum)
                self.running_var.mul_(self.momentum).add_(
                    var.detach(), alpha=1.0 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.dim() - 2)
        scale = self.weight * torch.rsqrt(var + self.eps)
        y = ((x.to(torch.float32) - mean.reshape(shape)) * scale.reshape(shape)
             + self.bias.reshape(shape))
        return y.to(self.dtype)


def _global_moments(x: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, biased variance) per feature over every process's ``x``, in
    two passes as ``torch.var_mean``: the mean from the summed counts and
    sums, then the variance from the summed squared deviations."""
    count = x.new_full((1,), x.numel() // x.shape[1])
    sums = all_reduce_sum(torch.cat([count, x.sum(dims)]))
    shape = (1, -1) + (1,) * (x.dim() - 2)
    mean = sums[1:] / sums[0]
    var = all_reduce_sum(((x - mean.reshape(shape)) ** 2).sum(dims)) / sums[0]
    return mean, var


@functools.lru_cache(maxsize=None)
def _weak(value: float, dtype: torch.dtype) -> float:
    """A Python constant rounded to ``dtype``, as JAX rounds a weakly typed
    scalar that meets an array of that dtype: the slope and the dropout
    scale of a bfloat16 activation are bfloat16 numbers there. At float32
    it is the float32 number PyTorch uses anyway."""
    return float(torch.tensor(value, dtype=dtype))


def _leaky(x):
    return F.leaky_relu(x, _weak(LEAKY_SLOPE, x.dtype))


class Upsample(nn.Module):
    """One generator up-stage: ConvTranspose(5x5, s), or for ``resize`` with
    ``s > 1`` nearest-neighbour ``s``x then Conv(5x5, s1). Bias-free; computes
    in ``compute_dtype``; ``f32_sums`` as :class:`SameConv2d`."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, mode: str,
                 compute_dtype: torch.dtype = torch.float32, f32_sums: bool = False):
        super().__init__()
        self.stride = stride
        self.resize = mode == "resize" and stride > 1
        kw = dict(compute_dtype=compute_dtype, f32_sums=f32_sums)
        self.conv = (SameConv2d(in_ch, out_ch, 1, bias=False, **kw) if self.resize
                     else SameConvTranspose2d(in_ch, out_ch, stride, **kw))

    @property
    def flax_kind(self) -> str:
        return "Conv" if self.resize else "ConvTranspose"

    def forward(self, x):
        if self.resize:
            # Cast before the repeat (the conv's own cast is then a no-op):
            # the same values, a quarter of the bytes.
            x = _cast(x, self.conv.compute_dtype).repeat_interleave(
                self.stride, dim=2).repeat_interleave(self.stride, dim=3)
        return self.conv(x)


class DCGANGenerator(nn.Module):
    """Dense -> BN -> reshape -> [up + BN + LeakyReLU]* -> (up | Conv) tanh.

    Train/eval mode (``.train()`` / ``.eval()``) switches BatchNorm between
    batch and running statistics, as flax's ``train`` flag does.
    ``compute_dtype``: the Dense's and the convolutions' operands;
    ``bn_dtype``: the BatchNorm outputs' (None: float32); ``output_f32``: tanh
    on a float32 cast of the last convolution (False: in ``compute_dtype``).
    The Dense and the up-stages feed a float32 BatchNorm and so return their
    float32 sums, and so does the last convolution under ``output_f32``
    (module docstring).
    """

    def __init__(self, latent_size: int = 100, init_hw: Tuple[int, int] = (4, 4),
                 init_features: int = 512,
                 blocks: Sequence[Tuple[int, int]] = ((512, 1), (256, 2), (128, 2), (64, 2)),
                 out_channels: int = 3, final_transpose: bool = False,
                 final_stride: int = 1, upsample: str = "transpose",
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 bn_dtype: Optional[torch.dtype] = None, output_f32: bool = True):
        super().__init__()
        if upsample not in ("transpose", "resize"):
            raise ValueError(f"upsample must be 'transpose' or 'resize', got {upsample!r}")
        self.latent_size = latent_size
        self.init_hw = tuple(init_hw)
        self.init_features = init_features
        self.compute_dtype = compute_dtype
        self.output_f32 = output_f32
        bn_dtype = bn_dtype or torch.float32
        h0, w0 = self.init_hw
        self.dense = nn.Linear(latent_size, h0 * w0 * init_features, bias=False)
        self.f32_sums = True  # the Dense's; each convolution has its own
        self.dense_bn = BatchNorm(h0 * w0 * init_features, dtype=bn_dtype)
        ups, bns, ch = [], [], init_features
        for features, stride in blocks:
            ups.append(Upsample(ch, features, stride, upsample, compute_dtype, f32_sums=True))
            bns.append(BatchNorm(features, dtype=bn_dtype))
            ch = features
        self.ups = nn.ModuleList(ups)
        self.bns = nn.ModuleList(bns)
        final_kw = dict(compute_dtype=compute_dtype, f32_sums=output_f32)
        self.final = (Upsample(ch, out_channels, final_stride, upsample, **final_kw)
                      if final_transpose
                      else SameConv2d(ch, out_channels, final_stride, bias=False, **final_kw))
        init_weights(self, generator)

    def forward(self, z):
        h0, w0 = self.init_hw
        dt = self.compute_dtype
        x = _leaky(self.dense_bn(_product(F.linear, _cast(z, dt), _cast(self.dense.weight, dt),
                                          f32_sums=self.f32_sums)))
        # flax reshapes the Dense output as NHWC; NCHW from there on.
        x = x.reshape(x.shape[0], h0, w0, self.init_features).permute(0, 3, 1, 2)
        for up, bn in zip(self.ups, self.bns):
            x = _leaky(bn(up(x)))
        x = self.final(x)
        return torch.tanh(x.to(torch.float32) if self.output_f32 else x)


class DCGANDiscriminator(nn.Module):
    """[Conv s2 + LeakyReLU + Dropout]* -> NHWC flatten -> Dense(1).

    Dropout is active in train mode and draws its masks from the
    ``generator`` passed to ``forward``. ``rows = (global_rows, index)``
    draws each mask for a batch of ``global_rows`` and keeps the rows
    ``index`` (a data-parallel process's share of the global critic input),
    so the processes together use the masks one process draws. The
    convolutions, LeakyReLUs and dropout run in ``compute_dtype``, the Dense
    in float32.
    """

    def __init__(self, channels: Sequence[int] = (16, 32, 64, 128, 256, 512),
                 dropout_rate: float = 0.3, in_channels: int = 3,
                 image_hw: Tuple[int, int] = (128, 128),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        convs, ch = [], in_channels
        h, w = image_hw
        for out_ch in channels:
            convs.append(SameConv2d(ch, out_ch, 2, compute_dtype=compute_dtype))
            ch, h, w = out_ch, -(-h // 2), -(-w // 2)
        self.convs = nn.ModuleList(convs)
        self.dense = nn.Linear(ch * h * w, 1)
        init_weights(self, generator)

    def forward(self, x, generator: Optional[torch.Generator] = None,
                rows: Optional[Tuple[int, torch.Tensor]] = None):
        keep = 1.0 - self.dropout_rate
        x = _cast(x, self.compute_dtype)
        for conv in self.convs:
            x = _leaky(conv(x))
            if self.training and self.dropout_rate > 0:
                if rows is None:
                    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
                else:
                    mask = (torch.rand((rows[0], *x.shape[1:]), generator=generator,
                                       device=x.device) < keep)[rows[1]]
                x = torch.where(mask, x / _weak(keep, x.dtype), torch.zeros_like(x))
        return self.dense(x.permute(0, 2, 3, 1).flatten(1).to(torch.float32))


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


def mnist_generator(latent_size: int = 100, upsample: str = "transpose", generator=None,
                    compute_dtype: torch.dtype = torch.float32):
    """28x28x1 generator."""
    return DCGANGenerator(latent_size=latent_size, init_hw=(7, 7), init_features=256,
                          blocks=((128, 1), (64, 2)), out_channels=1,
                          final_transpose=True, final_stride=2, upsample=upsample,
                          generator=generator, compute_dtype=compute_dtype)


def mnist_discriminator(generator=None, compute_dtype: torch.dtype = torch.float32):
    """28x28x1 critic."""
    return DCGANDiscriminator(channels=(64, 128), in_channels=1, image_hw=(28, 28),
                              generator=generator, compute_dtype=compute_dtype)


def _check_resolution(resolution: int) -> None:
    if resolution < 8 or resolution & (resolution - 1):
        raise ValueError(f"resolution must be a power of two >= 8, got {resolution}")


def celeba_generator(resolution: int = 128, latent_size: int = 100,
                     upsample: str = "transpose", generator=None,
                     compute_dtype: torch.dtype = torch.float32,
                     bn_dtype: Optional[torch.dtype] = None, output_f32: bool = True):
    """CelebA generator at a power-of-two resolution >= 8 (4x4x512 -> up-stages
    -> Conv tanh; at 128 the 512 -> 16 stack). ``compute_dtype``,
    ``bn_dtype``, ``output_f32``: see :class:`DCGANGenerator` (``--bf16``
    sets the first; ``--fast_gen`` the other two to bfloat16 and False)."""
    _check_resolution(resolution)
    n_up = resolution.bit_length() - 3
    chans = [512, 256, 128, 64, 32, 16]
    blocks = [(512, 1)] + [(chans[min(i + 1, len(chans) - 1)], 2) for i in range(n_up)]
    return DCGANGenerator(latent_size=latent_size, init_hw=(4, 4), init_features=512,
                          blocks=tuple(blocks), out_channels=3, final_transpose=False,
                          final_stride=1, upsample=upsample, generator=generator,
                          compute_dtype=compute_dtype, bn_dtype=bn_dtype, output_f32=output_f32)


def celeba_discriminator(resolution: int = 128, generator=None,
                         compute_dtype: torch.dtype = torch.float32):
    """CelebA critic; at 128 the 16 -> 512 stride-2 stack (down to 2x2)."""
    _check_resolution(resolution)
    n_down = resolution.bit_length() - 2
    chans = [16, 32, 64, 128, 256, 512]
    channels = tuple(chans[max(0, len(chans) - n_down):])
    return DCGANDiscriminator(channels=channels, in_channels=3,
                              image_hw=(resolution, resolution), generator=generator,
                              compute_dtype=compute_dtype)
