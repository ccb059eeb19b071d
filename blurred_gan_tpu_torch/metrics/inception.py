"""The InceptionV3 pool3 feature trunk (2048-d) over a parameter dict (port of
``blurred_gan_tpu/metrics/inception.py``).

Parameters are ``{scope: {"w", "beta", "mean", "var"}}`` with the JAX
package's scope names (``conv_specs``); here ``w`` is an OIHW tensor. On disk
they are the same ``.npz`` layout as the JAX package's, with HWIO kernels::

    <scope>/w      (kh, kw, cin, cout)  HWIO conv kernel
    <scope>/beta   (cout,)              BN shift (TF-slim BatchNorm has no scale)
    <scope>/mean   (cout,)              BN moving mean
    <scope>/var    (cout,)              BN moving variance

Every conv unit is conv, BatchNorm with inference statistics and eps 1e-3,
then ReLU. Inputs are NCHW in [-1, 1]; ``inception_feature_fn`` tiles grey to
RGB and resizes to 299² (bilinear). No weights file is in the repository and
none is fetched: without a local ``inception_v3.npz`` the trunk runs with
fixed-seed random weights (``random_inception_params``, a ``torch.Generator``
draw, so not the JAX package's random weights either), and says so loudly.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from blurred_gan_tpu_torch.convert import inception_params_to_torch
from blurred_gan_tpu_torch.metrics.fid import inception_preprocess

_MIXED_35 = [("Mixed_5b", 32), ("Mixed_5c", 64), ("Mixed_5d", 64)]
_MIXED_17 = [("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)]
_MIXED_8 = ["Mixed_7b", "Mixed_7c"]

FEATURE_DIM = 2048
MIN_INPUT_HW = 75  # smallest spatial size the valid-padded stem accepts
BN_EPS = 1e-3

Params = Dict[str, Dict[str, torch.Tensor]]


def conv_specs() -> List[Tuple[str, Tuple[int, int], int, int]]:
    """Every conv unit as (scope, (kh, kw), cin, cout), in forward order."""
    specs: List[Tuple[str, Tuple[int, int], int, int]] = [
        ("Conv2d_1a_3x3", (3, 3), 3, 32),
        ("Conv2d_2a_3x3", (3, 3), 32, 32),
        ("Conv2d_2b_3x3", (3, 3), 32, 64),
        ("Conv2d_3b_1x1", (1, 1), 64, 80),
        ("Conv2d_4a_3x3", (3, 3), 80, 192),
    ]
    cin = 192
    for name, pool_w in _MIXED_35:
        specs += [
            (f"{name}/branch1x1", (1, 1), cin, 64),
            (f"{name}/branch5x5_1", (1, 1), cin, 48),
            (f"{name}/branch5x5_2", (5, 5), 48, 64),
            (f"{name}/branch3x3dbl_1", (1, 1), cin, 64),
            (f"{name}/branch3x3dbl_2", (3, 3), 64, 96),
            (f"{name}/branch3x3dbl_3", (3, 3), 96, 96),
            (f"{name}/branch_pool", (1, 1), cin, pool_w),
        ]
        cin = 64 + 64 + 96 + pool_w
    specs += [
        ("Mixed_6a/branch3x3", (3, 3), cin, 384),
        ("Mixed_6a/branch3x3dbl_1", (1, 1), cin, 64),
        ("Mixed_6a/branch3x3dbl_2", (3, 3), 64, 96),
        ("Mixed_6a/branch3x3dbl_3", (3, 3), 96, 96),
    ]
    cin = 384 + 96 + cin  # + the passthrough max-pool branch
    for name, c7 in _MIXED_17:
        specs += [
            (f"{name}/branch1x1", (1, 1), cin, 192),
            (f"{name}/branch7x7_1", (1, 1), cin, c7),
            (f"{name}/branch7x7_2", (1, 7), c7, c7),
            (f"{name}/branch7x7_3", (7, 1), c7, 192),
            (f"{name}/branch7x7dbl_1", (1, 1), cin, c7),
            (f"{name}/branch7x7dbl_2", (7, 1), c7, c7),
            (f"{name}/branch7x7dbl_3", (1, 7), c7, c7),
            (f"{name}/branch7x7dbl_4", (7, 1), c7, c7),
            (f"{name}/branch7x7dbl_5", (1, 7), c7, 192),
            (f"{name}/branch_pool", (1, 1), cin, 192),
        ]
        cin = 192 * 4
    specs += [
        ("Mixed_7a/branch3x3_1", (1, 1), cin, 192),
        ("Mixed_7a/branch3x3_2", (3, 3), 192, 320),
        ("Mixed_7a/branch7x7x3_1", (1, 1), cin, 192),
        ("Mixed_7a/branch7x7x3_2", (1, 7), 192, 192),
        ("Mixed_7a/branch7x7x3_3", (7, 1), 192, 192),
        ("Mixed_7a/branch7x7x3_4", (3, 3), 192, 192),
    ]
    cin = 320 + 192 + cin
    for name in _MIXED_8:
        specs += [
            (f"{name}/branch1x1", (1, 1), cin, 320),
            (f"{name}/branch3x3_1", (1, 1), cin, 384),
            (f"{name}/branch3x3_2a", (1, 3), 384, 384),
            (f"{name}/branch3x3_2b", (3, 1), 384, 384),
            (f"{name}/branch3x3dbl_1", (1, 1), cin, 448),
            (f"{name}/branch3x3dbl_2", (3, 3), 448, 384),
            (f"{name}/branch3x3dbl_3a", (1, 3), 384, 384),
            (f"{name}/branch3x3dbl_3b", (3, 1), 384, 384),
            (f"{name}/branch_pool", (1, 1), cin, 192),
        ]
        cin = 320 + 2 * 384 + 2 * 384 + 192
    if cin != FEATURE_DIM:
        raise AssertionError(f"the spec ends at {cin} channels, not {FEATURE_DIM}")
    return specs


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def random_inception_params(seed: int = 0, device=None) -> Params:
    """Fixed-seed He-normal weights for the whole trunk, identity BatchNorm.
    FIDs from them are deterministic but not comparable to published ones."""
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for scope, (kh, kw), cin, cout in conv_specs():
        w = torch.randn((cout, cin, kh, kw), generator=gen) * math.sqrt(2.0 / (kh * kw * cin))
        params[scope] = {"w": w.to(device), "beta": torch.zeros(cout, device=device),
                         "mean": torch.zeros(cout, device=device),
                         "var": torch.ones(cout, device=device)}
    return params


def load_inception_weights(path: str, device=None) -> Params:
    """Trunk weights from an ``.npz`` with ``<scope>/{w,beta,mean,var}`` keys
    (HWIO kernels); every shape is checked against ``conv_specs``."""
    with np.load(path) as data:
        params = {}
        for scope, (kh, kw), cin, cout in conv_specs():
            unit = {}
            for field, shape in (("w", (kh, kw, cin, cout)), ("beta", (cout,)),
                                 ("mean", (cout,)), ("var", (cout,))):
                key = f"{scope}/{field}"
                if key not in data:
                    raise KeyError(f"{path} is missing '{key}' - not an InceptionV3 "
                                   f"weights file in this module's npz layout")
                # C order whatever order the file keeps, so that weights saved
                # again are laid out as the JAX package writes them.
                arr = np.ascontiguousarray(data[key], np.float32)
                if arr.shape != shape:
                    raise ValueError(f"{key}: expected shape {shape}, got {arr.shape}")
                unit[field] = arr
            params[scope] = unit
    return inception_params_to_torch(params, device=device)


def save_inception_weights(params: Params, path: str) -> None:
    """Write trunk parameters to the npz layout (kernels back to HWIO)."""
    flat = {}
    for scope, unit in params.items():
        for field, t in unit.items():
            arr = t.detach().cpu().numpy()
            flat[f"{scope}/{field}"] = arr.transpose(2, 3, 1, 0) if field == "w" else arr
    np.savez(path, **flat)


def find_local_weights(path: Optional[str] = None) -> Optional[str]:
    """A local weights file: the explicit path, ``$INCEPTION_WEIGHTS``, or
    ``$DATASETS_DIR/inception_v3.npz`` (``DATASETS_DIR`` defaults to ``~/datasets``)."""
    candidates = [path, os.environ.get("INCEPTION_WEIGHTS"),
                  os.path.join(os.environ.get("DATASETS_DIR", os.path.expanduser("~/datasets")),
                               "inception_v3.npz")]
    for cand in candidates:
        if cand and os.path.exists(cand):
            return cand
    return None


# ---------------------------------------------------------------------------
# Forward pass
# ---------------------------------------------------------------------------


def _conv_bn(params: Params, x: torch.Tensor, scope: str, stride: int = 1,
             padding: str = "SAME") -> torch.Tensor:
    p = params[scope]
    kh, kw = p["w"].shape[2:]
    pad = (kh // 2, kw // 2) if padding == "SAME" else (0, 0)  # odd kernels, stride 1
    x = F.conv2d(x, p["w"], stride=stride, padding=pad)
    shape = (1, -1, 1, 1)
    x = (x - p["mean"].reshape(shape)) * torch.rsqrt(p["var"] + BN_EPS).reshape(shape) \
        + p["beta"].reshape(shape)
    return F.relu(x)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2)


def _avg_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3×3 mean over the cells inside the image (SAME, padding not counted)."""
    return F.avg_pool2d(x, 3, 1, padding=1, count_include_pad=False)


def _mixed_35(params: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    b0 = _conv_bn(params, x, f"{name}/branch1x1")
    b1 = _conv_bn(params, _conv_bn(params, x, f"{name}/branch5x5_1"), f"{name}/branch5x5_2")
    b2 = _conv_bn(params, x, f"{name}/branch3x3dbl_1")
    b2 = _conv_bn(params, b2, f"{name}/branch3x3dbl_2")
    b2 = _conv_bn(params, b2, f"{name}/branch3x3dbl_3")
    b3 = _conv_bn(params, _avg_pool_3x3_same(x), f"{name}/branch_pool")
    return torch.cat([b0, b1, b2, b3], dim=1)


def _mixed_17(params: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    b0 = _conv_bn(params, x, f"{name}/branch1x1")
    b1 = x
    for unit in ("branch7x7_1", "branch7x7_2", "branch7x7_3"):
        b1 = _conv_bn(params, b1, f"{name}/{unit}")
    b2 = x
    for i in range(1, 6):
        b2 = _conv_bn(params, b2, f"{name}/branch7x7dbl_{i}")
    b3 = _conv_bn(params, _avg_pool_3x3_same(x), f"{name}/branch_pool")
    return torch.cat([b0, b1, b2, b3], dim=1)


def _mixed_8(params: Params, x: torch.Tensor, name: str) -> torch.Tensor:
    b0 = _conv_bn(params, x, f"{name}/branch1x1")
    b1 = _conv_bn(params, x, f"{name}/branch3x3_1")
    b1 = torch.cat([_conv_bn(params, b1, f"{name}/branch3x3_2a"),
                    _conv_bn(params, b1, f"{name}/branch3x3_2b")], dim=1)
    b2 = _conv_bn(params, x, f"{name}/branch3x3dbl_1")
    b2 = _conv_bn(params, b2, f"{name}/branch3x3dbl_2")
    b2 = torch.cat([_conv_bn(params, b2, f"{name}/branch3x3dbl_3a"),
                    _conv_bn(params, b2, f"{name}/branch3x3dbl_3b")], dim=1)
    b3 = _conv_bn(params, _avg_pool_3x3_same(x), f"{name}/branch_pool")
    return torch.cat([b0, b1, b2, b3], dim=1)


@torch.no_grad()
def inception_features(params: Params, images: torch.Tensor) -> torch.Tensor:
    """(N, 3, H, W) in [-1, 1], H = W >= 75 -> (N, 2048) pool3 features."""
    x = images.to(torch.float32)
    x = _conv_bn(params, x, "Conv2d_1a_3x3", stride=2, padding="VALID")
    x = _conv_bn(params, x, "Conv2d_2a_3x3", padding="VALID")
    x = _conv_bn(params, x, "Conv2d_2b_3x3")
    x = _max_pool(x)
    x = _conv_bn(params, x, "Conv2d_3b_1x1", padding="VALID")
    x = _conv_bn(params, x, "Conv2d_4a_3x3", padding="VALID")
    x = _max_pool(x)
    for name, _ in _MIXED_35:
        x = _mixed_35(params, x, name)
    # Mixed_6a: stride-2 reduction 35 -> 17.
    b0 = _conv_bn(params, x, "Mixed_6a/branch3x3", stride=2, padding="VALID")
    b1 = _conv_bn(params, x, "Mixed_6a/branch3x3dbl_1")
    b1 = _conv_bn(params, b1, "Mixed_6a/branch3x3dbl_2")
    b1 = _conv_bn(params, b1, "Mixed_6a/branch3x3dbl_3", stride=2, padding="VALID")
    x = torch.cat([b0, b1, _max_pool(x)], dim=1)
    for name, _ in _MIXED_17:
        x = _mixed_17(params, x, name)
    # Mixed_7a: stride-2 reduction 17 -> 8.
    b0 = _conv_bn(params, x, "Mixed_7a/branch3x3_1")
    b0 = _conv_bn(params, b0, "Mixed_7a/branch3x3_2", stride=2, padding="VALID")
    b1 = x
    for i in range(1, 4):
        b1 = _conv_bn(params, b1, f"Mixed_7a/branch7x7x3_{i}")
    b1 = _conv_bn(params, b1, "Mixed_7a/branch7x7x3_4", stride=2, padding="VALID")
    x = torch.cat([b0, b1, _max_pool(x)], dim=1)
    for name in _MIXED_8:
        x = _mixed_8(params, x, name)
    return x.mean(dim=(2, 3))


# ---------------------------------------------------------------------------
# FID-facing entry point
# ---------------------------------------------------------------------------


def inception_feature_fn(weights_path: Optional[str] = None, *,
                         resize_to: Optional[int] = 299,
                         allow_random_fallback: bool = True, seed: int = 0,
                         device=None) -> Callable[[torch.Tensor], torch.Tensor]:
    """An ``(N, C, H, W) -> (N, 2048)`` pool3 extractor for
    ``FIDMetric(feature_fn=...)``, on ``device``.

    Weights from :func:`find_local_weights`; with none found and
    ``allow_random_fallback``, fixed-seed random weights, with a loud message.
    """
    found = find_local_weights(weights_path)
    if found is not None:
        params = load_inception_weights(found, device=device)
        print(f"[fid] InceptionV3 weights: {found}")
    elif allow_random_fallback:
        params = random_inception_params(seed, device=device)
        print("[fid] no InceptionV3 weights found (set $INCEPTION_WEIGHTS or "
              "$DATASETS_DIR/inception_v3.npz) - using the real architecture "
              "with FIXED-SEED RANDOM weights; FID values are deterministic "
              "but NOT comparable to published numbers")
    else:
        raise FileNotFoundError(
            "no InceptionV3 weights file found (checked explicit path, "
            "$INCEPTION_WEIGHTS, $DATASETS_DIR/inception_v3.npz)")

    def extract(images: torch.Tensor) -> torch.Tensor:
        x = images.to(torch.float32)
        if resize_to is not None:
            x = inception_preprocess(x, resize_to)
        elif x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        return inception_features(params, x)

    return extract
