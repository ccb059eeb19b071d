"""Image utilities: normalisation, layout transposes, sample grids and a PNG
writer (port of ``blurred_gan_tpu/utils/images.py``).

``samples_grid`` is a copy of the JAX package's numpy function, so a grid of
the same samples is byte-equal. PNGs are written with the standard library
(``zlib`` + ``struct``): the port needs no imaging package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> grey, RGB, RGBA


def normalize_images(images):
    """[-1, 1] -> [0, 1] (numpy arrays or tensors)."""
    return (images + 1.0) / 2.0


def NHWC_to_NCHW(images):
    """(N, H, W, C) -> (N, C, H, W): a view of a tensor, else a numpy array."""
    if isinstance(images, torch.Tensor):
        return images.permute(0, 3, 1, 2)
    return np.transpose(np.asarray(images), (0, 3, 1, 2))


def NCHW_to_NHWC(images):
    """(N, C, H, W) -> (N, H, W, C): a view of a tensor, else a numpy array."""
    if isinstance(images, torch.Tensor):
        return images.permute(0, 2, 3, 1)
    return np.transpose(np.asarray(images), (0, 2, 3, 1))


def samples_grid(samples, grid=(8, 8), pad: int = 2) -> np.ndarray:
    """Tile NHWC samples (values in [0, 1]) into one HWC uint8 image; missing
    tiles are black, one-channel samples become grey RGB."""
    samples = np.asarray(samples)
    rows, cols = grid
    n = rows * cols
    samples = samples[:n]
    b, h, w, c = samples.shape
    if b < n:  # pad with black tiles
        samples = np.concatenate(
            [samples, np.zeros((n - b, h, w, c), samples.dtype)], axis=0)
    img = np.ones((rows * (h + pad) + pad, cols * (w + pad) + pad, c),
                  dtype=np.float32)
    for i in range(rows):
        for j in range(cols):
            y, x = pad + i * (h + pad), pad + j * (w + pad)
            img[y:y + h, x:x + w] = samples[i * cols + j]
    img = np.clip(img, 0.0, 1.0)
    if c == 1:
        img = np.repeat(img, 3, axis=-1)
    return (img * 255.0 + 0.5).astype(np.uint8)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write an HWC (or HW) uint8 image as an 8-bit PNG, rows unfiltered."""
    img = np.asarray(image)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in _PNG_COLOR_TYPE:
        raise ValueError(f"expected HWC uint8 with 1, 3 or 4 channels, got "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR_TYPE[c], 0, 0, 0)
    # Each scanline starts with its filter type, 0 (none).
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def save_image_grid(samples, path: str, grid=(8, 8)) -> np.ndarray:
    """Render a grid and save it as PNG; returns the HWC uint8 array."""
    img = samples_grid(samples, grid=grid)
    write_png(path, img)
    return img
