"""Minimal dependency-free PNG writer (RGB8, zlib-compressed), a copy of
``gpu_physics_engine_tpu.utils.png``."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """image: (H, W, 3) uint8 or float in [0, 1] -> PNG bytes.
    ``level`` is the zlib effort; the web app streams at level 1 (encode
    speed over size on a local socket)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if not (img.ndim == 3 and img.shape[2] == 3):
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    """image: (H, W, 3) uint8 or float in [0, 1]."""
    with open(path, "wb") as f:
        f.write(encode_png(image))
