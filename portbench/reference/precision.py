"""Operand rounding of the networks' products.

``float32`` leaves them alone. The two lower precisions are the controls
that the correctness comparison has to reject:

- ``tf32``: each operand rounded to TF32's 10-bit mantissa (round to
  nearest even), the step a float32 configuration would take with TF32 on;
- ``fp8``: each operand scaled per tensor to float8 e4m3's largest value
  (448), rounded to e4m3 and scaled back, and each gradient that enters a
  product's backward to e5m2 the same way (57344): the step a bfloat16
  configuration would take to fp8 products, as fp8 training takes it.

:func:`round_operand` rounds a product's operands and passes their
gradients straight through, so the backward products read the rounded
operands; :func:`round_gradient` marks a product's result, whose gradient
is rounded before the backward products read it (under ``tf32`` to TF32,
as its backward products take their operands). Both stay differentiable,
for the penalty's double backward.
"""

from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "fp8")
FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    shift = 23 - bits
    i = x.detach().to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> shift) & 1
    i = (i + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return i.view(torch.float32)


def _round_fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    x = x.detach().to(torch.float32)
    amax = x.abs().max()
    scale = torch.where(amax > 0, FP8_MAX[dtype] / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(torch.float32) / scale


def round_operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    """``x`` with its values rounded to ``precision``; the gradient passes
    through unchanged."""
    if precision == "float32":
        return x
    if precision == "tf32":
        q = _round_mantissa(x, 10)
    elif precision == "fp8":
        q = _round_fp8(x)
    else:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return x + (q - x).detach()


class _RoundGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, precision):
        ctx.precision = precision
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if ctx.precision == "tf32":
            q = _round_mantissa(g, 10)
        else:
            q = _round_fp8(g, torch.float8_e5m2)
        return g + (q - g).detach(), None


def round_gradient(y: torch.Tensor, precision: str) -> torch.Tensor:
    """``y`` itself; the gradient that reaches it is rounded to
    ``precision`` on its way back into the product that made ``y``."""
    if precision == "float32" or not y.requires_grad:
        return y
    return _RoundGradient.apply(y, precision)
