"""PNG output, written with the standard library (``zlib``, ``struct``).

``save_png`` quantizes the tonemapped framebuffer once, as the JAX
package's ``io.image.save_png`` does, and writes an 8-bit RGB PNG with
filter type 0 on every row; ``load_png`` reads such files back (and
refuses other PNG variants).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img) -> None:
    """img: (H, W, 3) float in [0, 1] (already tonemapped), numpy or a
    torch tensor on any device."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    q = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    H, W, C = q.shape
    if C != 3:
        raise ValueError(f"save_png: expected (H, W, 3), got {q.shape}")
    raw = np.concatenate([np.zeros((H, 1), np.uint8), q.reshape(H, W * 3)], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def load_png(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] of an 8-bit RGB PNG whose rows all use
    filter type 0 (what :func:`save_png` writes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: only 8-bit RGB, non-interlaced PNGs are "
                         "read")
    W, H = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)),
                         np.uint8).reshape(H, 1 + W * 3)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows with a PNG filter are not read")
    return rows[:, 1:].reshape(H, W, 3).astype(np.float32) / 255.0
