"""Convert InceptionV3 weights a user already has into the npz layout that
``metrics.inception.load_inception_weights`` and ``$INCEPTION_WEIGHTS`` read
(the port's counterpart of the repo root's ``tools/convert_inception.py``;
for the same input it writes the same bytes).

    python -m blurred_gan_tpu_torch.tools.convert_inception <checkpoint> <out.npz> \\
        [--format auto|torchvision|slim|npz]

Formats, detected from the path unless ``--format`` names one:

- **torchvision** ``inception_v3`` state dict (``.pth`` / ``.pt`` / ``.bin``,
  from ``torch.save(model.state_dict(), ...)`` or a whole saved module).
  torchvision's BatchNorm has a scale γ that the trunk's scale-free BatchNorm
  lacks; it is folded exactly: BN is ``γ·(conv(x) − μ)/σ + β`` and the conv is
  linear per output channel, so ``w[..., c] *= γ_c`` and ``mean_c *= γ_c``.
  Kernels go from OIHW to HWIO.
- **TF-slim** ``inception_v3.ckpt`` (a checkpoint prefix or its directory):
  slim's BatchNorm has no γ, and its kernels are HWIO already. Its branch
  scopes are mapped to the trunk's names, with the quirks every released
  checkpoint keeps (Mixed_5b's pool projection ``Conv2d_0b_1x1``, Mixed_5c's
  ``Conv2d_0b_1x1`` / ``Conv_1_0c_5x5``). This path needs ``tensorflow``,
  imported only here.
- **npz** in the layout already: validated and written again.

Every array is checked against ``conv_specs()`` before anything is written,
and the written file is read back through the strict loader. This is host
work on the CPU; it takes no device.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from blurred_gan_tpu_torch.convert import inception_params_to_torch
from blurred_gan_tpu_torch.metrics.inception import (
    Params, conv_specs, load_inception_weights, save_inception_weights)

NumpyParams = Dict[str, Dict[str, np.ndarray]]


# ---------------------------------------------------------------------------
# torchvision
# ---------------------------------------------------------------------------


def convert_torchvision_state_dict(sd) -> NumpyParams:
    """A torchvision ``inception_v3`` state dict -> ``{scope: {"w" (HWIO),
    "beta", "mean", "var"}}`` float32 arrays, γ folded."""
    params = {}
    for scope, (kh, kw), cin, cout in conv_specs():
        mod = scope.replace("/", ".")  # the trunk's scopes are torchvision's module paths
        try:
            w = np.asarray(sd[f"{mod}.conv.weight"], np.float32)  # OIHW
            gamma = np.asarray(sd[f"{mod}.bn.weight"], np.float32)
            beta = np.asarray(sd[f"{mod}.bn.bias"], np.float32)
            mean = np.asarray(sd[f"{mod}.bn.running_mean"], np.float32)
            var = np.asarray(sd[f"{mod}.bn.running_var"], np.float32)
        except KeyError as e:
            raise KeyError(f"missing torchvision key for scope '{scope}': {e} — is this "
                           f"a torchvision inception_v3 state dict?") from e
        if w.shape != (cout, cin, kh, kw):
            raise ValueError(f"{mod}.conv.weight: expected OIHW {(cout, cin, kh, kw)}, "
                             f"got {w.shape}")
        w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        # γ scales only the numerator, and both sides use eps 1e-3, so
        # w' = w·γ and mean' = mean·γ (β and var as they are) give the same
        # network.
        params[scope] = {"w": (w * gamma[None, None, None, :]).astype(np.float32),
                         "beta": beta.astype(np.float32),
                         "mean": (mean * gamma).astype(np.float32),
                         "var": var.astype(np.float32)}
    return params


def _load_torch_checkpoint(path: str) -> dict:
    """The state dict in ``path`` as numpy arrays. A whole saved module has
    to be unpickled, so only load a file you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "state_dict" in obj and not any(
            k.endswith(".conv.weight") for k in obj):
        obj = obj["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}


# ---------------------------------------------------------------------------
# TF-slim
# ---------------------------------------------------------------------------

_SLIM_STEM = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3", "Conv2d_3b_1x1",
              "Conv2d_4a_3x3")


def _slim_name(scope: str) -> str:
    """The trunk's ``<block>/<branch>`` scope -> slim's variable scope
    (tensorflow/models slim ``nets/inception_v3.py``, quirks included)."""
    if scope in _SLIM_STEM:
        return f"InceptionV3/{scope}"
    block, branch = scope.split("/")
    if block == "Mixed_6a":
        # The double-3x3 branch is Branch_1 here (Branch_2 in the 35x35
        # blocks), and the stride-2 3x3 convs are named "Conv2d_1a_1x1".
        table = {"branch3x3": "Branch_0/Conv2d_1a_1x1",
                 "branch3x3dbl_1": "Branch_1/Conv2d_0a_1x1",
                 "branch3x3dbl_2": "Branch_1/Conv2d_0b_3x3",
                 "branch3x3dbl_3": "Branch_1/Conv2d_1a_1x1"}
        return f"InceptionV3/{block}/{table[branch]}"
    if block in ("Mixed_7b", "Mixed_7c"):
        table = {"branch1x1": "Branch_0/Conv2d_0a_1x1",
                 "branch3x3_1": "Branch_1/Conv2d_0a_1x1",
                 "branch3x3_2a": "Branch_1/Conv2d_0b_1x3",
                 "branch3x3_2b": "Branch_1/Conv2d_0c_3x1",
                 "branch3x3dbl_1": "Branch_2/Conv2d_0a_1x1",
                 "branch3x3dbl_2": "Branch_2/Conv2d_0b_3x3",
                 "branch3x3dbl_3a": "Branch_2/Conv2d_0c_1x3",
                 "branch3x3dbl_3b": "Branch_2/Conv2d_0d_3x1",
                 "branch_pool": "Branch_3/Conv2d_0b_1x1"}
        return f"InceptionV3/{block}/{table[branch]}"
    in_5c = block == "Mixed_5c"
    table = {
        # 35x35 blocks (Mixed_5b/5c/5d); Mixed_5c renames Branch_1's convs.
        "branch1x1": "Branch_0/Conv2d_0a_1x1",
        "branch5x5_1": "Branch_1/Conv2d_0b_1x1" if in_5c else "Branch_1/Conv2d_0a_1x1",
        "branch5x5_2": "Branch_1/Conv_1_0c_5x5" if in_5c else "Branch_1/Conv2d_0b_5x5",
        "branch3x3dbl_1": "Branch_2/Conv2d_0a_1x1",
        "branch3x3dbl_2": "Branch_2/Conv2d_0b_3x3",
        "branch3x3dbl_3": "Branch_2/Conv2d_0c_3x3",
        "branch_pool": "Branch_3/Conv2d_0b_1x1",
        # 17x17 blocks (Mixed_6b..6e)
        "branch7x7_1": "Branch_1/Conv2d_0a_1x1",
        "branch7x7_2": "Branch_1/Conv2d_0b_1x7",
        "branch7x7_3": "Branch_1/Conv2d_0c_7x1",
        "branch7x7dbl_1": "Branch_2/Conv2d_0a_1x1",
        "branch7x7dbl_2": "Branch_2/Conv2d_0b_7x1",
        "branch7x7dbl_3": "Branch_2/Conv2d_0c_1x7",
        "branch7x7dbl_4": "Branch_2/Conv2d_0d_7x1",
        "branch7x7dbl_5": "Branch_2/Conv2d_0e_1x7",
        # Mixed_7a
        "branch3x3_1": "Branch_0/Conv2d_0a_1x1",
        "branch3x3_2": "Branch_0/Conv2d_1a_3x3",
        "branch7x7x3_1": "Branch_1/Conv2d_0a_1x1",
        "branch7x7x3_2": "Branch_1/Conv2d_0b_1x7",
        "branch7x7x3_3": "Branch_1/Conv2d_0c_7x1",
        "branch7x7x3_4": "Branch_1/Conv2d_1a_3x3",
    }
    return f"InceptionV3/{block}/{table[branch]}"


def convert_slim_checkpoint(ckpt_prefix: str) -> NumpyParams:
    """A TF-slim ``inception_v3`` checkpoint -> the trunk's arrays (no γ to
    fold: slim's BatchNorm has no scale)."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(f"reading a TF-slim checkpoint needs tensorflow, which is not "
                          f"installed ({e}); convert from a torchvision state dict or an "
                          f"npz instead") from e

    reader = tf.train.load_checkpoint(ckpt_prefix)
    params = {}
    for scope, (kh, kw), cin, cout in conv_specs():
        slim = _slim_name(scope)
        try:
            w = reader.get_tensor(f"{slim}/weights")  # HWIO already
            beta = reader.get_tensor(f"{slim}/BatchNorm/beta")
            mean = reader.get_tensor(f"{slim}/BatchNorm/moving_mean")
            var = reader.get_tensor(f"{slim}/BatchNorm/moving_variance")
        except Exception as e:  # TF raises its own NotFoundError types
            raise KeyError(f"missing slim variables under '{slim}' for scope "
                           f"'{scope}': {e}") from e
        if w.shape != (kh, kw, cin, cout):
            raise ValueError(f"{slim}/weights: expected HWIO {(kh, kw, cin, cout)}, "
                             f"got {w.shape}")
        params[scope] = {"w": np.asarray(w, np.float32), "beta": np.asarray(beta, np.float32),
                         "mean": np.asarray(mean, np.float32),
                         "var": np.asarray(var, np.float32)}
    return params


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def check_params(params: NumpyParams) -> NumpyParams:
    """Every scope of ``conv_specs()`` with its four arrays at their shapes,
    else ``KeyError`` / ``ValueError`` naming the array."""
    for scope, (kh, kw), cin, cout in conv_specs():
        for field, shape in (("w", (kh, kw, cin, cout)), ("beta", (cout,)),
                             ("mean", (cout,)), ("var", (cout,))):
            if field not in params.get(scope, {}):
                raise KeyError(f"'{scope}/{field}' is missing")
            if np.shape(params[scope][field]) != shape:
                raise ValueError(f"{scope}/{field}: expected shape {shape}, "
                                 f"got {np.shape(params[scope][field])}")
    return params


def detect_format(path: str) -> str:
    if os.path.isdir(path):
        return "slim"
    lower = path.lower()
    if lower.endswith(".npz"):
        return "npz"
    if lower.endswith((".pth", ".pt", ".bin")):
        return "torchvision"
    if os.path.exists(path + ".index") or ".ckpt" in os.path.basename(lower):
        return "slim"
    return "torchvision"


def convert(src: str, out: str, fmt: str = "auto") -> Params:
    """Convert ``src`` and write ``out``; returns the trunk's parameters
    (kernels OIHW, on the CPU)."""
    if fmt == "auto":
        fmt = detect_format(src)
        print(f"[convert] detected format: {fmt}")
    if fmt == "torchvision":
        params = inception_params_to_torch(
            check_params(convert_torchvision_state_dict(_load_torch_checkpoint(src))))
    elif fmt == "slim":
        prefix = src
        if os.path.isdir(src):  # a directory holding the checkpoint's files
            cands = [f[:-6] for f in os.listdir(src) if f.endswith(".index")]
            if not cands:
                raise FileNotFoundError(f"no *.index checkpoint under {src}")
            prefix = os.path.join(src, sorted(cands)[-1])
        params = inception_params_to_torch(check_params(convert_slim_checkpoint(prefix)))
    elif fmt == "npz":
        params = load_inception_weights(src)  # the loader checks every shape
    else:
        raise ValueError(f"unknown format {fmt!r}")
    save_inception_weights(params, out)
    load_inception_weights(out)  # read back through the strict loader
    n_params = sum(t.numel() for unit in params.values() for t in unit.values())
    print(f"[convert] wrote {out}: {len(params)} conv units, {n_params:,} parameters "
          f"(validated)")
    return params


def main(argv: Optional[Sequence[str]] = None) -> Params:
    p = argparse.ArgumentParser(
        description="InceptionV3 weights (torchvision, TF-slim or npz) into the npz layout")
    p.add_argument("src", help="torchvision .pth / slim ckpt prefix or dir / npz")
    p.add_argument("out", help="output .npz path (point $INCEPTION_WEIGHTS here)")
    p.add_argument("--format", default="auto", choices=["auto", "torchvision", "slim", "npz"])
    args = p.parse_args(argv)
    return convert(args.src, args.out, args.format)


if __name__ == "__main__":
    main()
