"""Carry the JAX package's weights into the port.

``flax_to_torch(module, params, batch_stats)`` takes the JAX package's nested
dicts (``Dense_0``, ``BatchNorm_k``, ``ConvTranspose_k``, ``Conv_k``; numpy or
jax arrays) and copies them into a ``DCGANGenerator`` or ``DCGANDiscriminator``:

- Dense kernel (in, out) -> Linear weight (out, in);
- Conv kernel (kh, kw, in, out) -> (out, in, kh, kw);
- ConvTranspose kernel (kh, kw, in, out) -> flipped spatially, (in, out, kh, kw);
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean / running_var.

Flax names its submodules per type in creation order, which is the order the
port's modules list them in.

For the metrics' feature extractors, given as numpy arrays:

- ``inception_params_to_torch``: the InceptionV3 trunk's npz-layout dict
  (``{scope: {w (HWIO), beta, mean, var}}``) into the port's (OIHW kernels);
- ``random_conv_weights_to_torch``: the random-conv FID embedding's four HWIO
  kernels and its ``(256, dim)`` projection, for
  ``random_conv_features(..., weights=...)``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from blurred_gan_tpu_torch.models.dcgan import (
    BatchNorm, DCGANDiscriminator, DCGANGenerator, SameConvTranspose2d, Upsample)


def _copy(dst: torch.Tensor, src, name: str) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a fresh, writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: flax shape {tuple(src.shape)} does not fit "
                         f"{tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _conv_kernel(kernel, transpose: bool) -> np.ndarray:
    k = np.asarray(kernel)
    if transpose:
        return k[::-1, ::-1].transpose(2, 3, 0, 1)
    return k.transpose(3, 2, 0, 1)


def _load_conv(conv, p: Mapping, name: str) -> None:
    transpose = isinstance(conv, SameConvTranspose2d)
    _copy(conv.weight, _conv_kernel(p["kernel"], transpose), f"{name}.kernel")
    bias = getattr(conv, "bias", None)
    if bias is not None:
        _copy(bias, p["bias"], f"{name}.bias")


def _load_bn(bn: BatchNorm, p: Mapping, stats: Optional[Mapping], name: str) -> None:
    _copy(bn.weight, p["scale"], f"{name}.scale")
    _copy(bn.bias, p["bias"], f"{name}.bias")
    if stats is not None:
        _copy(bn.running_mean, stats["mean"], f"{name}.mean")
        _copy(bn.running_var, stats["var"], f"{name}.var")


def flax_to_torch(module, params: Mapping, batch_stats: Optional[Mapping] = None):
    """Copy flax ``params`` (and the generator's ``batch_stats``) into
    ``module`` in place; returns ``module``."""
    if isinstance(module, DCGANGenerator):
        _copy(module.dense.weight, np.asarray(params["Dense_0"]["kernel"]).T,
              "Dense_0.kernel")
        bns = [module.dense_bn, *module.bns]
        for i, bn in enumerate(bns):
            name = f"BatchNorm_{i}"
            _load_bn(bn, params[name], batch_stats[name] if batch_stats else None, name)
        counts: Counter = Counter()
        for layer in [*module.ups, module.final]:
            kind = layer.flax_kind if isinstance(layer, Upsample) else "Conv"
            conv = layer.conv if isinstance(layer, Upsample) else layer
            name = f"{kind}_{counts[kind]}"
            counts[kind] += 1
            _load_conv(conv, params[name], name)
        return module
    if isinstance(module, DCGANDiscriminator):
        for i, conv in enumerate(module.convs):
            _load_conv(conv, params[f"Conv_{i}"], f"Conv_{i}")
        _copy(module.dense.weight, np.asarray(params["Dense_0"]["kernel"]).T,
              "Dense_0.kernel")
        _copy(module.dense.bias, params["Dense_0"]["bias"], "Dense_0.bias")
        return module
    raise TypeError(f"no flax mapping for {type(module).__name__}")


def _tensor(arr, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)


def inception_params_to_torch(params: Mapping, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{scope: {"w": HWIO, "beta", "mean", "var"}}`` numpy arrays -> the
    port's trunk parameters, kernels OIHW."""
    return {scope: {field: _tensor(np.asarray(arr).transpose(3, 2, 0, 1) if field == "w" else arr,
                                   device)
                    for field, arr in unit.items()}
            for scope, unit in params.items()}


def random_conv_weights_to_torch(kernels: Sequence, proj, device=None
                                 ) -> Tuple[list, torch.Tensor]:
    """The random-conv embedding's HWIO kernels and projection as
    ``(OIHW kernels, projection)`` tensors."""
    return ([_tensor(np.asarray(k).transpose(3, 2, 0, 1), device) for k in kernels],
            _tensor(proj, device))
