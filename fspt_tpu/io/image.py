"""PNG/NPY image IO (replaces the reference's canvas.toBlob upload path,
reference main.js:859-867 + utility.js:46-53)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float [0,1] or uint8.  8-bit RGB, no filtering."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"write_png wants (H, W, 3), got {arr.shape}")
    h, w, _ = arr.shape
    # every scanline starts with filter type 0 (None)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1).tobytes()
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def pil_image_module():
    """PIL.Image, imported on first use: only reading PNG assets needs
    it, and rendering generated scenes does not."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("reading PNG files needs the Pillow package "
                          "(PIL), which is not installed") from e
    return Image


def read_png(path: str) -> np.ndarray:
    with pil_image_module().open(path) as im:
        return np.asarray(im.convert("RGB")).astype(np.float32) / 255.0


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img))
