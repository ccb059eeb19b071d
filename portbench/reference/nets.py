"""The DCGAN generator and critic of the blurred-GAN demos (``demo_celeba.py``,
``demo_mnist.py``), functional and in float32, NCHW.

The layers are tf.keras's, as the demos build them:

- a SAME convolution of a 5x5 kernel pads ``(total // 2, total − total // 2)``
  on each spatial axis, ``total = max((ceil(n / s) − 1)·s + 5 − n, 0)``;
- a SAME transposed convolution of stride ``s`` maps ``n`` to ``s·n``
  positions: the stride-dilated input padded low by ``ceil((5 + s − 2) / 2)``
  (``4`` where ``s > 4``), cropped to ``s·n``; its kernel is stored
  ``(in, out, 5, 5)``;
- the generator's Dense output is laid out (h, w, c) before the first
  up-stage, and the critic flattens (h, w, c) before its Dense;
- BatchNorm with momentum 0.99 and epsilon 1e-3; train mode normalises by the
  biased batch statistics and moves the running ones by 1 % towards them
  (the biased variance); eval mode uses the running ones;
- LeakyReLU 0.3; tanh on the generator's output; the critic's dropout 0.3
  after every convolution, active in train mode, its masks drawn as
  ``rand(shape) < 0.7`` from the caller's generator, one draw per layer in
  order; generator convolutions carry no bias, the critic's do;
- under a compute dtype below float32 (``compute_dtype`` of the
  configuration) the critic's activations are in that dtype, and the
  constants that meet them, the LeakyReLU slope and the dropout's scale
  ``1 / 0.7``'s divisor, are that dtype's numbers (a mixed-precision policy
  casts them; bfloat16: 0.30078125 and 0.69921875). The generator's
  activations leave its BatchNorms in float32 and keep 0.3.

Parameters live in dicts keyed by the names :func:`generator_shapes` and
:func:`critic_shapes` give. ``precision`` (``precision.py``) rounds the
operands of every Dense and convolution.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.precision import round_gradient, round_operand

KERNEL = 5
LEAKY_SLOPE = 0.3
BN_MOMENTUM = 0.99
BN_EPS = 1e-3

Params = Dict[str, torch.Tensor]


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def transpose_pad_lo(k: int, s: int) -> int:
    return k - 1 if s > k - 1 else -(-(k + s - 2) // 2)


def _bn_names(prefix: str, features: int):
    return [(f"{prefix}.weight", (features,), "ones"), (f"{prefix}.bias", (features,), "zeros"),
            (f"{prefix}.running_mean", (features,), "zeros"),
            (f"{prefix}.running_var", (features,), "ones")]


def generator_shapes(cfg: dict, latent_size: int, out_channels: int):
    """``[(name, shape, init)]`` of the generator, ``init`` one of
    ``glorot``, ``ones``, ``zeros``; parameters and running statistics."""
    h0, w0 = cfg["init_hw"]
    f0 = cfg["init_features"]
    out = [("dense.weight", (h0 * w0 * f0, latent_size), "glorot")]
    out += _bn_names("dense_bn", h0 * w0 * f0)
    ch = f0
    for i, (features, _stride) in enumerate(cfg["blocks"]):
        out.append((f"ups.{i}.conv.weight", (ch, features, KERNEL, KERNEL), "glorot"))
        out += _bn_names(f"bns.{i}", features)
        ch = features
    if cfg["final"] == "transpose":
        out.append(("final.conv.weight", (ch, out_channels, KERNEL, KERNEL), "glorot"))
    else:
        out.append(("final.weight", (out_channels, ch, KERNEL, KERNEL), "glorot"))
    return out


def critic_shapes(cfg: dict, image_shape):
    """``[(name, shape, init)]`` of the critic."""
    h, w, ch = image_shape
    out = []
    for i, features in enumerate(cfg["channels"]):
        out.append((f"convs.{i}.weight", (features, ch, KERNEL, KERNEL), "glorot"))
        out.append((f"convs.{i}.bias", (features,), "zeros"))
        ch, h, w = features, -(-h // 2), -(-w // 2)
    out.append(("dense.weight", (1, ch * h * w), "glorot"))
    out.append(("dense.bias", (1,), "zeros"))
    return out


def glorot_limit(shape) -> float:
    """tf.keras's glorot-uniform bound for a Dense ``(out, in)`` or a 5x5
    kernel (either channel order: the bound uses their sum)."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return math.sqrt(6.0 / ((shape[0] + shape[1]) * receptive))


def linear(x, w, precision):
    y = F.linear(round_operand(x, precision), round_operand(w, precision))
    return round_gradient(y, precision)


def conv_same(x, w, stride: int, precision: str, bias=None):
    ph = same_pads(x.shape[2], KERNEL, stride)
    pw = same_pads(x.shape[3], KERNEL, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(round_operand(x, precision), round_operand(w, precision), stride=stride)
    y = round_gradient(y, precision)
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def conv_transpose_same(x, w, stride: int, precision: str):
    h, wd = x.shape[2], x.shape[3]
    pad = KERNEL - 1 - transpose_pad_lo(KERNEL, stride)
    y = F.conv_transpose2d(round_operand(x, precision), round_operand(w, precision),
                           stride=stride, padding=pad)
    return round_gradient(y, precision)[:, :, :stride * h, :stride * wd]


def batch_norm(x, p: Params, prefix: str, train: bool, new_stats: Optional[Params]):
    dims = [0, *range(2, x.dim())]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    if train:
        var, mean = torch.var_mean(x, dim=dims, correction=0)
        if new_stats is not None:
            for name, batch in (("running_mean", mean), ("running_var", var)):
                old = p[f"{prefix}.{name}"]
                new_stats[f"{prefix}.{name}"] = (old * BN_MOMENTUM
                                                 + batch.detach() * (1.0 - BN_MOMENTUM))
    else:
        mean, var = p[f"{prefix}.running_mean"], p[f"{prefix}.running_var"]
    scale = p[f"{prefix}.weight"] * torch.rsqrt(var + BN_EPS)
    return (x - mean.reshape(shape)) * scale.reshape(shape) + p[f"{prefix}.bias"].reshape(shape)


def in_dtype(value: float, dtype: str) -> float:
    """``value`` as a number of the compute dtype ``dtype``."""
    return float(torch.tensor(value, dtype=getattr(torch, dtype)))


def leaky(x, slope: float = LEAKY_SLOPE):
    return F.leaky_relu(x, slope)


def generate(p: Params, z: torch.Tensor, cfg: dict, *, train: bool, precision: str = "float32",
             new_stats: Optional[Params] = None) -> torch.Tensor:
    """NCHW images in [-1, 1]. In train mode the moved running statistics
    are written into ``new_stats`` when it is given."""
    h0, w0 = cfg["init_hw"]
    f0 = cfg["init_features"]
    x = leaky(batch_norm(linear(z, p["dense.weight"], precision), p, "dense_bn", train,
                         new_stats))
    x = x.reshape(x.shape[0], h0, w0, f0).permute(0, 3, 1, 2)
    for i, (_features, stride) in enumerate(cfg["blocks"]):
        x = conv_transpose_same(x, p[f"ups.{i}.conv.weight"], stride, precision)
        x = leaky(batch_norm(x, p, f"bns.{i}", train, new_stats))
    if cfg["final"] == "transpose":
        x = conv_transpose_same(x, p["final.conv.weight"], cfg["final_stride"], precision)
    else:
        x = conv_same(x, p["final.weight"], cfg["final_stride"], precision)
    return torch.tanh(x)


def critic(p: Params, x: torch.Tensor, cfg: dict, *, train: bool, precision: str = "float32",
           rng: Optional[torch.Generator] = None, compute_dtype: str = "float32") -> torch.Tensor:
    """``(N, 1)`` scores of NCHW images; in train mode the dropout masks come
    from ``rng``."""
    keep = 1.0 - cfg["dropout"]
    slope, scale = in_dtype(LEAKY_SLOPE, compute_dtype), in_dtype(keep, compute_dtype)
    for i in range(len(cfg["channels"])):
        x = leaky(conv_same(x, p[f"convs.{i}.weight"], 2, precision, p[f"convs.{i}.bias"]),
                  slope)
        if train and cfg["dropout"] > 0:
            mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
            x = torch.where(mask, x / scale, torch.zeros_like(x))
    x = x.permute(0, 2, 3, 1).flatten(1)
    return linear(x, p["dense.weight"], precision) + p["dense.bias"]


def parameter_names(shapes) -> List[str]:
    """The trained leaves (running statistics are not)."""
    return [n for n, _, _ in shapes if "running_" not in n]
