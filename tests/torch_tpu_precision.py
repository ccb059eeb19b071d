"""Train the port's float32 networks as a TPU computes them at XLA's DEFAULT
precision: an experiment harness, not a feature of the port.

The JAX package's quality arms ran on a TPU, where a float32 convolution or
dot at DEFAULT precision rounds both operands to bfloat16 and accumulates
in float32 (the package asks for more only in its blur). Inside
:func:`tpu_default_precision` every convolution and dense product of
``blurred_gan_tpu_torch/models/dcgan.py`` does the same:

- the products: ``SameConv2d``'s convolution, ``SameConvTranspose2d``'s
  transposed convolution, the generator's ``F.linear`` and the critic's
  ``dense``;
- both operands are rounded to bfloat16 and the product runs as a float32
  product with TF32 off (the product of two bfloat16 values is exact in
  float32; the sums are float32);
- in the forward, in both backward products (the incoming gradient is
  rounded too) and in every higher derivative (the penalty's double
  backward): each backward product is again a rounded product;
- the blur, BatchNorm and everything elementwise stay float32, as in JAX.

(Its second experiment, a ``--bf16`` generator whose products keep their
float32 sums as the JAX package's default compile does, is what ``--bf16``
computes now: ``models/dcgan.py``'s ``f32_sums``.)

The CLI runs ``python -m blurred_gan_tpu_torch.quality`` (``train`` or
``evaluate``, the same flags) inside the mode's context; ``train`` checks
through the ``on_trainer`` hook that the networks' products go through it and
adds ``"tpu_precision"`` with the count of products to the meta. Write its runs to their own ``--out``: their files
have the plain arms' names.

    PYTHONPATH=. python tests/torch_tpu_precision.py train --config mnist \\
        --examples 180000 --seed 0 --out runs/quality/tpu_precision/mnist

It imports torch and the port only, so it runs on the card's machine.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from blurred_gan_tpu_torch.models import dcgan

COUNT = {"products": 0}


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the nearest bfloat16 value, in its own dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def _conv(x, w, meta):
    stride, padding, _, _ = meta
    return F.conv2d(x, w, stride=stride, padding=padding)


def _conv_input(g, w, meta):
    stride, padding, x_shape, _ = meta
    return torch.nn.grad.conv2d_input(x_shape, w, g, stride=stride, padding=padding)


def _conv_weight(x, g, meta):
    stride, padding, _, w_shape = meta
    return torch.nn.grad.conv2d_weight(x, w_shape, g, stride=stride, padding=padding)


def _mm(a, b, meta):
    return a @ b


_OPS = {"conv": _conv, "conv_input": _conv_input, "conv_weight": _conv_weight, "mm": _mm}


class _RoundedProduct(torch.autograd.Function):
    """``op(round(a), round(b))`` for a bilinear ``op``; each of its two
    backward products is a ``_RoundedProduct`` of the incoming gradient, so
    every derivative rounds its operands too. The three convolution ops
    (``conv``: y = conv(x, w); ``conv_input``: ∂/∂x of it, bilinear in (g, w);
    ``conv_weight``: ∂/∂w, bilinear in (x, g)) are each other's transposes;
    ``mm`` is its own."""

    @staticmethod
    def forward(ctx, a, b, op, meta):
        ctx.save_for_backward(a, b)
        ctx.op, ctx.meta = op, meta
        COUNT["products"] += 1
        return _OPS[op](round_bf16(a), round_bf16(b), meta)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        op, meta = ctx.op, ctx.meta
        need_a, need_b = ctx.needs_input_grad[:2]
        ga = gb = None
        if op == "mm":
            ga = product("mm", g, b.transpose(-1, -2)) if need_a else None
            gb = product("mm", a.transpose(-1, -2), g) if need_b else None
        elif op == "conv":  # a = x, b = w
            ga = product("conv_input", g, b, meta) if need_a else None
            gb = product("conv_weight", a, g, meta) if need_b else None
        elif op == "conv_input":  # a = g_y, b = w; the cotangent has x's shape
            ga = product("conv", g, b, meta) if need_a else None
            gb = product("conv_weight", g, a, meta) if need_b else None
        else:  # conv_weight: a = x, b = g_y; the cotangent has w's shape
            ga = product("conv_input", b, g, meta) if need_a else None
            gb = product("conv", a, g, meta) if need_b else None
        return ga, gb, None, None


def product(op: str, a: torch.Tensor, b: torch.Tensor, meta=None) -> torch.Tensor:
    return _RoundedProduct.apply(a, b, op, meta)


def conv2d(x, w, bias=None, stride=1, padding=0):
    """``F.conv2d`` (groups 1, no dilation) at DEFAULT precision; the bias is
    added in float32 after the product."""
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
    y = product("conv", x, w, (stride, padding, tuple(x.shape), tuple(w.shape)))
    return y if bias is None else y + bias.reshape(1, -1, 1, 1)


def conv_transpose2d(x, w, stride=1, padding=0):
    """``F.conv_transpose2d`` (no output padding, groups 1) at DEFAULT
    precision: the input-gradient of the convolution whose weight is ``w``."""
    stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
    padding = (padding, padding) if isinstance(padding, int) else tuple(padding)
    k = w.shape[2:]
    out_hw = tuple((x.shape[2 + i] - 1) * stride[i] - 2 * padding[i] + k[i] for i in range(2))
    out_shape = (x.shape[0], w.shape[1], *out_hw)
    return product("conv_input", x, w, (stride, padding, out_shape, tuple(w.shape)))


def linear(x, w, bias=None):
    """``F.linear`` at DEFAULT precision; the bias added in float32."""
    y = product("mm", x, w.transpose(0, 1))
    return y if bias is None else y + bias


class _Functional:
    """``torch.nn.functional`` with the three products replaced."""

    conv2d = staticmethod(conv2d)
    conv_transpose2d = staticmethod(conv_transpose2d)
    linear = staticmethod(linear)

    def __getattr__(self, name):
        return getattr(F, name)


def _dense_forward(self, x):
    return linear(x, self.weight, self.bias)


@contextlib.contextmanager
def tpu_default_precision():
    """Inside, ``models/dcgan.py``'s convolutions and dense products round
    their operands to bfloat16 (module docstring) and TF32 is off; the
    critic's ``dense`` is an ``nn.Linear``, so every ``nn.Linear`` does.
    Leaving restores the exact float32 products and the TF32 settings."""
    saved = (dcgan.F, torch.nn.Linear.forward, torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    dcgan.F = _Functional()
    torch.nn.Linear.forward = _dense_forward
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield COUNT
    finally:
        (dcgan.F, torch.nn.Linear.forward, torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _products(module) -> int:
    """The convolutions and dense products of one forward of ``module``."""
    return (sum(isinstance(m, (dcgan.SameConv2d, dcgan.SameConvTranspose2d))
                for m in module.modules()) + 1)


def main(argv: Optional[Sequence[str]] = None):
    from blurred_gan_tpu_torch import quality

    args = quality.parse_args(argv)
    with tpu_default_precision() as count:
        if args.cmd != "train":
            return quality.main(argv)

        def check(trainer):
            # An eval-mode forward of both networks on a fixed latent (no
            # draw, no BatchNorm update) counts their products.
            gan, before = trainer.gan, count["products"]
            modes = gan.generator.training, gan.discriminator.training
            gan.generator.eval()
            gan.discriminator.eval()
            with torch.no_grad():
                z = torch.full((2, gan.latent_size), 0.5, device=trainer.device)
                gan.discriminator(gan.generator(z))
            gan.generator.train(modes[0])
            gan.discriminator.train(modes[1])
            want = _products(gan.generator) + _products(gan.discriminator)
            if count["products"] - before != want:
                raise SystemExit(f"{count['products'] - before} of the networks' {want} "
                                 "products went through the harness")

        count["products"] = 0
        meta = quality.train(quality.CONFIGS[args.config], args.examples, args.out, args.seed,
                             ema_decay=args.ema_decay, bf16=args.bf16, adaptive=args.adaptive,
                             ref_grad_scale=args.ref_grad_scale,
                             gen_upsample=args.gen_upsample, ttur_g_lr=args.ttur_g_lr,
                             d_steps=args.d_steps, device=args.device,
                             concurrent_runs=args.concurrent_runs, on_trainer=check)
    meta["tpu_precision"] = {"operands": "bfloat16", "accumulation": "float32",
                             "products": count["products"]}
    prefix = quality.arm_prefix(ema_decay=args.ema_decay, bf16=args.bf16,
                                adaptive=args.adaptive, ref_grad_scale=args.ref_grad_scale,
                                gen_upsample=args.gen_upsample, ttur_g_lr=args.ttur_g_lr,
                                d_steps=args.d_steps)
    with open(os.path.join(args.out, f"{prefix}_meta_s{args.seed}.json"), "w") as f:
        json.dump(meta, f)
    print(json.dumps(meta), flush=True)
    return meta


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
