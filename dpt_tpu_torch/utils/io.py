"""Image output: PNG (pure-python encoder, no deps) and .npy.

A copy of `dpt_tpu/utils/io.py` (numpy only).  Replaces the reference's
on-screen presentation path (fullscreen textured quad,
VulkanRenderer.cpp:712-866): headless, the render target is a file.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(img: np.ndarray, exposure: float = 1.0, gamma: float = 2.2):
    """Simple exposure+gamma to 8-bit (the reference displays raw radiance;
    we at least gamma-correct for files)."""
    x = np.clip(np.asarray(img, np.float64) * exposure, 0.0, None)
    x = np.clip(x, 0.0, 1.0) ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img_u8: np.ndarray):
    """Minimal RGB8 PNG writer."""
    h, w, c = img_u8.shape
    assert c == 3 and img_u8.dtype == np.uint8
    raw = b"".join(
        b"\x00" + img_u8[y].tobytes() for y in range(h)
    )

    def chunk(tag, data):
        block = tag + data
        return (
            struct.pack(">I", len(data))
            + block
            + struct.pack(">I", zlib.crc32(block) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def save_image(path: str, img, exposure: float = 1.0):
    """Save float radiance image as .png (tonemapped) or .npy (raw)."""
    img = np.asarray(img)
    if path.endswith(".npy"):
        np.save(path, img)
    elif path.endswith(".png"):
        write_png(path, tonemap(img, exposure))
    else:
        raise ValueError(f"unsupported image extension: {path}")
