"""The work of a configuration, counted from its shapes, not from the
program that runs it, so the count stays put whatever implements the step.

The convention is the one the port's bench settled (its ``flops_per_step``):
a convolution costs ``2 · C_in · C_out`` per (output position, tap) pair of
its forward that reads an input, not SAME padding nor the rows a transposed
convolution computes and crops; its input and its weight gradient each cost
that again; a backward that autograd runs on an all-zero gradient (the
penalty's LeakyReLU second derivative) costs nothing.

One train step of the reference (``reference/train.py``) at batch ``B``
runs, counted in images through each network:

=========================  =====================================================
critic convolution L       forward 2B (train) + B (penalty) + B (generator
                           step); penalty input gradient B; the critic
                           update's weight gradients 2B and input gradients
                           2B for L > 1; the penalty's double backward 2B
                           (weight and upstream gradient); the generator
                           step's input gradient B: ``(10 + 2·[L > 1]) B``
critic Dense               ``11 B`` products of its width
generator convolution      forward 2B (critic step, eval; generator step,
                           train), weight and input gradients 2B: ``4 B``
generator Dense            forward 2B and weight gradient B: ``3 B``
blur                       7 applications of B images: forward 2B + B + B,
                           backward B (penalty), B (double backward), B
                           (generator step)
=========================  =====================================================

The blur's work is counted two ways: ``blur_taps`` (the configuration's:
each plane through the ``2·half + 1`` taps of the step's σ along each axis,
the work a roofline of the blur is held to) and ``blur_dense`` (the band
matrices multiplied in full, as the bench counted it through the plain
path). ``step_flops`` uses the taps; ``step_flops_dense`` reproduces the
bench's count (126,521,505,792 at CelebA-128 b32).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

from portbench.reference import blur as ref_blur
from portbench.reference import nets

K = nets.KERNEL
BLUR_APPLICATIONS = 7  # images of the batch, per image of the batch (table above)
BLUR_BYTES_PER_PIXEL = 8  # float32 read once and written once


@functools.cache
def conv_taps(n: int, k: int, s: int) -> int:
    """(output position, tap) pairs of a SAME convolution along one axis that
    read an input."""
    lo = nets.same_pads(n, k, s)[0]
    return sum(1 for o in range(-(-n // s)) for t in range(k) if 0 <= o * s + t - lo < n)


@functools.cache
def conv_transpose_taps(n: int, k: int, s: int) -> int:
    """The same for a SAME transposed convolution from ``n`` to ``s·n``
    positions: the pairs that read an input, not a hole or padding."""
    lo = nets.transpose_pad_lo(k, s)
    return sum(1 for o in range(s * n) for t in range(k)
               if o + t - lo >= 0 and (o + t - lo) % s == 0 and (o + t - lo) // s < n)


def critic_layers(config: dict) -> Tuple[List[int], int]:
    """(forward FLOPs per image of each convolution, the Dense's width)."""
    h, w, ch = config["image_shape"]
    out = []
    for features in config["critic"]["channels"]:
        out.append(2 * ch * features * conv_taps(h, K, 2) * conv_taps(w, K, 2))
        ch, h, w = features, -(-h // 2), -(-w // 2)
    return out, ch * h * w


def generator_layers(config: dict) -> Tuple[List[int], int]:
    """(forward FLOPs per image of each convolution, the Dense's FLOPs per image)."""
    g = config["generator"]
    h, w = g["init_hw"]
    ch = g["init_features"]
    dense = 2 * config["latent_size"] * h * w * ch
    out = []
    for features, stride in g["blocks"]:
        out.append(2 * ch * features * conv_transpose_taps(h, K, stride)
                   * conv_transpose_taps(w, K, stride))
        ch, h, w = features, h * stride, w * stride
    c_out, s = config["image_shape"][2], g["final_stride"]
    if g["final"] == "transpose":
        out.append(2 * ch * c_out * conv_transpose_taps(h, K, s) * conv_transpose_taps(w, K, s))
    else:
        out.append(2 * ch * c_out * conv_taps(h, K, s) * conv_taps(w, K, s))
    return out, dense


def generator_forward_per_image(config: dict) -> int:
    convs, dense = generator_layers(config)
    return sum(convs) + dense


def networks_per_step(config: dict) -> int:
    """FLOPs of one step's networks at the configuration's batch."""
    b = config["batch_size"]
    d_convs, d_width = critic_layers(config)
    g_convs, g_dense = generator_layers(config)
    critic = sum((10 + 2 * (i > 0)) * f for i, f in enumerate(d_convs)) + 11 * 2 * d_width
    generator = 4 * sum(g_convs) + 3 * g_dense
    return b * (critic + generator)


def blur_planes_per_step(config: dict) -> int:
    return BLUR_APPLICATIONS * config["batch_size"] * config["image_shape"][2]


def blur_taps(config: dict, sigma: float) -> int:
    """FLOPs of one step's blurs through their taps (a multiply and an add
    per tap, output pixel and axis)."""
    h, w, _ = config["image_shape"]
    taps = 2 * ref_blur.policy(sigma, max(h, w))[1] + 1
    return blur_planes_per_step(config) * 2 * taps * h * w * 2


def blur_dense(config: dict) -> int:
    """FLOPs of one step's blurs as two full band-matrix products a plane."""
    h, w, _ = config["image_shape"]
    return blur_planes_per_step(config) * 2 * h * w * (h + w)


def blur_bytes(config: dict) -> int:
    """Bytes of one step's blurs: each float32 plane read once, written once."""
    h, w, _ = config["image_shape"]
    return blur_planes_per_step(config) * h * w * BLUR_BYTES_PER_PIXEL


def step_flops(config: dict, sigma: float) -> int:
    return networks_per_step(config) + blur_taps(config, sigma)


def step_flops_dense(config: dict) -> int:
    return networks_per_step(config) + blur_dense(config)
