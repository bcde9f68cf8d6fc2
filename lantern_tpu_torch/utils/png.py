"""A PNG writer with no imaging library: RGB8, one IDAT chunk, filter 0
(none) on every row, zlib-compressed.

The JAX entry points save images through Pillow; the port's entry points
save them here, so that no path they run needs an imaging library.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> the bytes of a PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want a uint8 [H, W, 3] image, got {img.dtype} "
                         f"{img.shape}")
    h, w, _ = img.shape
    # colour type 2 (RGB), 8 bits a sample, deflate, filter method 0, no
    # interlace; each scanline starts with its filter byte 0
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)],
                          axis=1)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(image))
