"""The fused separable blur: a hand-written CUDA kernel and its autograd Function.

Port of ``blurred_gan_tpu/ops/blur_pallas.py`` (the Pallas kernel
``_blur_plane_kernel`` bound as the primitive ``blur_planes_p``). For every
plane ``p`` of a ``(P, H, W)`` float32 stack it computes

    out[p] = T_h @ X[p] @ T_w

in one launch, with the intermediate ``T_h @ X[p]`` kept in shared memory
(``csrc/blur_planes.cu``). The kernel skips the zeros of band matrices: each
row tile of ``T_h`` and each column tile of ``T_w`` runs ``k`` only over the
range where the tile has non-zero entries, read from ``T`` on the device.
:func:`band_ranges` states those ranges where a CPU test can reach them.

The blur is linear in the planes, so its backward is the same kernel with
``T_hᵀ`` and ``T_wᵀ`` (the port of the primitive's transpose rule). The
backward calls ``BlurPlanes.apply`` again, so differentiating it a second time,
as the WGAN-GP penalty does, launches the kernel once more. Gradients for the
band matrices are plain einsums, taken only when asked for (the port of the
JVP's σ terms).

Dispatch is by device and nothing else: a CUDA tensor goes to the kernel or
raises; a CPU tensor goes to :func:`blur_planes_reference`, the plain
two-``matmul`` version. The kernel is compiled with ``nvcc`` at first use into
``blurred_gan_tpu_torch/_build/`` (keyed by a hash of the source) and bound
with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = _PKG_DIR / "csrc" / "blur_planes.cu"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# Widest plane the kernel takes: its shared-memory intermediate holds 32 rows
# of the (column-padded) plane, 1024 x 36 floats + staging = 154 KB of the
# 227 KB a block may use.
MAX_W = 1024
MAX_PLANES = 65535  # gridDim.y
# The kernel's tiles (kRows, kWarpCols in the source): a block owns ROW_TILE
# rows of T_h, a warp COL_TILE columns of T_w.
ROW_TILE = 32
COL_TILE = 32

# Kernel launches since the last reset; incremented only where a launch
# happens. Read and reset it as ``blur_cuda.launch_count``.
launch_count = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/blur_planes.cu`` (if not already built) and return the
    shared library's path. Raises ``RuntimeError`` if ``nvcc`` fails."""
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"blur_planes-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}); the blur kernel needs "
                           f"the CUDA toolkit") from e
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, flush=True)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.cache
def _library():
    lib = ctypes.CDLL(str(build()))
    lib.blur_planes_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.blur_planes_f32.restype = ctypes.c_int
    lib.blur_planes_occupancy.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.blur_planes_occupancy.restype = ctypes.c_int
    lib.blur_planes_error_string.argtypes = [ctypes.c_int]
    lib.blur_planes_error_string.restype = ctypes.c_char_p
    return lib


def occupancy(w: int) -> tuple[int, int]:
    """``(blocks per SM, dynamic shared memory bytes per block)`` of the kernel
    for ``w`` x ``w`` planes on the current CUDA device, from
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``."""
    lib = _library()
    blocks, smem = ctypes.c_int(), ctypes.c_int()
    err = lib.blur_planes_occupancy(w, torch.cuda.current_device(), ctypes.byref(blocks),
                                    ctypes.byref(smem))
    if err != 0:
        raise RuntimeError("blur kernel occupancy query failed: "
                           + lib.blur_planes_error_string(err).decode())
    return blocks.value, smem.value


def band_ranges(t: torch.Tensor, tile: int, axis: int) -> list:
    """Each tile's ``(first, last)`` index with a non-zero entry, as the kernel
    finds them, or ``None`` for a tile that is all zero.

    ``axis=0`` cuts ``t`` into tiles of ``tile`` rows and ranges over columns:
    the kernel's phase 1 on ``T_h`` (``tile = ROW_TILE``). ``axis=1`` cuts it
    into tiles of ``tile`` columns and ranges over rows: phase 2 on ``T_w``
    (``tile = COL_TILE``). The kernel runs ``k`` over
    ``[first & ~3, (last | 3) + 1)``, every term outside being an exact zero;
    an empty tile writes zeros. Nothing on the main path calls this.
    """
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 or 1, got {axis}")
    nz = (t != 0) if axis == 0 else (t != 0).t()
    ranges = []
    for start in range(0, nz.shape[0], tile):
        idx = torch.nonzero(nz[start:start + tile].any(0)).flatten()
        ranges.append((int(idx[0]), int(idx[-1])) if idx.numel() else None)
    return ranges


def blur_planes_reference(planes: torch.Tensor, t_h: torch.Tensor,
                          t_w: torch.Tensor) -> torch.Tensor:
    """The plain version: ``T_h @ planes[p] @ T_w`` as two ``torch.matmul``."""
    return torch.matmul(torch.matmul(t_h, planes), t_w)


def _launch(planes: torch.Tensor, t_h: torch.Tensor, t_w: torch.Tensor) -> torch.Tensor:
    global launch_count
    for name, t in (("planes", planes), ("t_h", t_h), ("t_w", t_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"blur kernel takes float32 {name}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"blur kernel takes contiguous {name}")
        if t.device != planes.device:
            raise ValueError(f"{name} is on {t.device}, planes on {planes.device}")
    p, h, w = planes.shape
    if w > MAX_W:
        raise ValueError(f"blur kernel takes planes up to {MAX_W} wide, got {w}")
    if p > MAX_PLANES:
        raise ValueError(f"blur kernel takes up to {MAX_PLANES} planes, got {p}")
    out = torch.empty_like(planes)
    lib = _library()
    err = lib.blur_planes_f32(
        planes.data_ptr(), t_h.data_ptr(), t_w.data_ptr(), out.data_ptr(),
        p, h, w, planes.device.index,
        torch.cuda.current_stream(planes.device).cuda_stream)
    if err != 0:
        raise RuntimeError("blur kernel launch failed: "
                           + lib.blur_planes_error_string(err).decode())
    launch_count += 1
    return out


def blur_planes_forward(planes: torch.Tensor, t_h: torch.Tensor,
                        t_w: torch.Tensor) -> torch.Tensor:
    """``out[p] = t_h @ planes[p] @ t_w`` without autograd: the kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if planes.dim() != 3 or t_h.shape != (planes.shape[1],) * 2 \
            or t_w.shape != (planes.shape[2],) * 2:
        raise ValueError(f"expected planes (P,H,W), t_h (H,H), t_w (W,W); got "
                         f"{tuple(planes.shape)}, {tuple(t_h.shape)}, "
                         f"{tuple(t_w.shape)}")
    if planes.is_cuda:
        return _launch(planes, t_h, t_w)
    if planes.device.type != "cpu":
        raise ValueError(f"blur kernel runs on CUDA; got {planes.device}")
    return blur_planes_reference(planes, t_h, t_w)


class BlurPlanes(torch.autograd.Function):
    """Differentiable to any order: the backward re-enters this Function."""

    @staticmethod
    def forward(ctx, planes, t_h, t_w):
        need_t = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(planes if need_t else None, t_h, t_w)
        return blur_planes_forward(planes, t_h, t_w)

    @staticmethod
    def backward(ctx, grad):
        planes, t_h, t_w = ctx.saved_tensors
        g_planes = g_th = g_tw = None
        if ctx.needs_input_grad[0]:
            # Transpose of x -> A x B is ct -> Aᵀ ct Bᵀ: the same kernel again.
            g_planes = BlurPlanes.apply(grad.contiguous(), t_h.t().contiguous(),
                                        t_w.t().contiguous())
        if ctx.needs_input_grad[1]:
            g_th = torch.einsum("phu,wu,pvw->hv", grad, t_w, planes)
        if ctx.needs_input_grad[2]:
            g_tw = torch.einsum("hv,pvw,phu->wu", t_h, planes, grad)
        return g_planes, g_th, g_tw


def blur_planes(planes: torch.Tensor, t_h: torch.Tensor, t_w: torch.Tensor) -> torch.Tensor:
    """``out[p] = t_h @ planes[p] @ t_w``, differentiable to any order."""
    return BlurPlanes.apply(planes, t_h, t_w)


def blur_images_fused(images: torch.Tensor, t_h: torch.Tensor,
                      t_w: torch.Tensor) -> torch.Tensor:
    """Blur an NCHW batch with prepared band matrices. The ``(N·C, H, W)``
    planes are a free view of a contiguous NCHW tensor."""
    n, c, h, w = images.shape
    x = images.to(torch.float32).contiguous().reshape(n * c, h, w)
    return blur_planes(x, t_h, t_w).reshape(n, c, h, w).to(images.dtype)
