"""The FLOP-count convention of the port's bench (``flops_per_step`` in
``blurred_gan_tpu_torch.bench``), as rules over ``torch.utils.flop_counter``
run on the benchmark's plain reference (the tests' witness for
``portbench/flops.py``'s closed forms):

- every convolution op of a layer (forward, input and weight gradients, the
  penalty's double backward) is counted over the (output position, tap)
  pairs of the layer's forward that read an input, not SAME padding nor the
  rows a transposed convolution computes and crops;
- a convolution backward whose output gradient is all zeros counts 0;
- matrix products as ``flop_counter`` counts them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from portbench.reference import nets


def conv_taps(n: int, k: int, s: int) -> int:
    lo = nets.same_pads(n, k, s)[0]
    return sum(1 for o in range(-(-n // s)) for t in range(k) if 0 <= o * s + t - lo < n)


def conv_transpose_taps(n: int, k: int, s: int) -> int:
    lo = nets.transpose_pad_lo(k, s)
    return sum(1 for o in range(s * n) for t in range(k)
               if o + t - lo >= 0 and (o + t - lo) % s == 0 and (o + t - lo) // s < n)


class _Rules:
    def __init__(self):
        self.active, self.ratios = [], {}

    @contextlib.contextmanager
    def layer(self, taps: int):
        self.active.append(taps)
        try:
            yield
        finally:
            self.active.pop()

    def ratio(self, x, w, out, transposed):
        key = tuple(sorted((tuple(x[2:]), tuple(w[2:]), tuple(out[2:]))))
        if self.active:
            dense = math.prod((x if transposed else out)[2:]) * math.prod(w[2:])
            r = (self.active[-1], dense)
            if self.ratios.setdefault(key, r) != r:
                raise RuntimeError(f"two layers of spatial shapes {key}")
        return self.ratios[key]

    def mapping(self):
        aten = torch.ops.aten

        def conv(x, w, _b, _s, _p, _d, transposed, *args, out_shape=None, **kw):
            taps, dense = self.ratio(x, w, out_shape, transposed)
            return conv_flop_count(x, w, out_shape, transposed) * taps // dense

        def conv_backward(grad_out, x, w, _b, _s, _p, _d, transposed, _op, _g, output_mask,
                          out_val=None, **kw):
            if not grad_out.any():
                return 0
            go, x, w = grad_out.shape, x.shape, w.shape
            taps, dense = self.ratio(x, w, go, transposed)
            forward = conv_flop_count(x, w, go, transposed) * taps // dense
            return forward * (bool(output_mask[0]) + bool(output_mask[1]))

        conv_backward._get_raw = True
        return {aten.convolution: conv, aten._convolution: conv,
                aten.convolution_backward: conv_backward}


@contextlib.contextmanager
def counting():
    """``FlopCounterMode`` with the rules, the reference's convolutions
    reporting their layer's taps while they run; yields the counter."""
    rules = _Rules()
    conv_same, conv_t = nets.conv_same, nets.conv_transpose_same

    def counted_conv_same(x, w, stride, precision, bias=None):
        t = conv_taps(x.shape[2], nets.KERNEL, stride) * conv_taps(x.shape[3], nets.KERNEL, stride)
        with rules.layer(t):
            return conv_same(x, w, stride, precision, bias)

    def counted_conv_t(x, w, stride, precision):
        t = (conv_transpose_taps(x.shape[2], nets.KERNEL, stride)
             * conv_transpose_taps(x.shape[3], nets.KERNEL, stride))
        with rules.layer(t):
            return conv_t(x, w, stride, precision)

    nets.conv_same, nets.conv_transpose_same = counted_conv_same, counted_conv_t
    try:
        with FlopCounterMode(display=False, custom_mapping=rules.mapping()) as counter:
            yield counter
    finally:
        nets.conv_same, nets.conv_transpose_same = conv_same, conv_t


def by_op(counter) -> Dict[str, int]:
    return {str(k): int(v) for k, v in counter.get_flop_counts()["Global"].items()}
