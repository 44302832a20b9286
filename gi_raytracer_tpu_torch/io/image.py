"""PNG output and input, with the standard library (``zlib``, ``struct``).

``save_png`` quantizes the tonemapped framebuffer once, as the JAX
package's ``io.image.save_png`` does, and writes an 8-bit RGB PNG with
filter type 0 on every row.  ``load_png`` reads any non-interlaced 8-bit
PNG (grey, grey+alpha, RGB, RGBA or palette, any of the five row filters;
palettes also of 1, 2 or 4 bits) as RGB, and ``load_png_rgba`` as RGBA
with a ``tRNS`` chunk applied: what Pillow's ``convert("RGB")`` and
``convert("RGBA")`` give, without Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type: grey, RGB, palette, grey+alpha,
# RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


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


def is_png(path: str) -> bool:
    """Whether the file starts with the PNG signature."""
    with open(path, "rb") as f:
        return f.read(8) == _SIGNATURE


def _unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``rows`` ((H, 1 + W * bpp) uint8, the
    filter type first).  A byte depends on its left, upper and upper-left
    neighbours, so the pixels are reconstructed one anti-diagonal at a
    time, every filter type at once and the row's own selected."""
    H = rows.shape[0]
    W = (rows.shape[1] - 1) // bpp
    ftype = rows[:, 0].astype(np.int64)
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is not one "
                         "of the five")
    filt = rows[:, 1:].reshape(H, W, bpp).astype(np.int32)
    if not ftype.any():
        return filt.astype(np.uint8)
    # recon[y + 1, x + 1] is pixel (y, x); row 0 and column 0 are the zero
    # bytes the filters take outside the image
    recon = np.zeros((H + 1, W + 1, bpp), np.int32)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        x = d - y
        a = recon[y + 1, x]             # left
        b = recon[y, x + 1]             # up
        c = recon[y, x]                 # upper left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.stack([np.zeros_like(a), a, b, (a + b) >> 1, paeth])
        t = ftype[y]
        recon[y + 1, x + 1] = (filt[y, x] + pred[t, np.arange(y.size)]) & 255
    return recon[1:, 1:].astype(np.uint8)


def _decode(path: str):
    """(pixels (H, W, channels) uint8, colour type, palette (N, 3) uint8 or
    None, tRNS bytes or None) of a non-interlaced 8-bit PNG (or a palette
    PNG of 1, 2 or 4 bits)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, plte, trns = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = hdr
    # Pillow writes palettes of at most 16 colours with 1, 2 or 4 bits
    packed = ctype == 3 and depth in (1, 2, 4)
    if (depth != 8 and not packed) or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, grey+"
                         "alpha, RGB, RGBA and palette PNGs are read "
                         f"(bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    if ctype == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    bpp = _CHANNELS[ctype]
    row = -(-W * bpp * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + row):
        raise ValueError(f"{path}: {raw.size} image bytes for {W}x{H}")
    px = _unfilter(raw.reshape(H, 1 + row), -(-bpp * depth // 8))
    if packed:
        bits = np.unpackbits(px.reshape(H, row), axis=1)
        bits = bits[:, :W * depth].reshape(H, W, depth)
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[..., None]
    return px, ctype, plte, trns


def _rgba8(path: str):
    """((H, W, 4) uint8 RGBA, has_alpha): palette entries looked up, grey
    spread to RGB, and a ``tRNS`` chunk turned into alpha (palette alphas,
    or alpha 0 on the one transparent grey or RGB value).  ``has_alpha``
    is true for the colour types that carry an alpha channel."""
    px, ctype, plte, trns = _decode(path)
    H, W = px.shape[:2]
    alpha = np.full((H, W), 255, np.uint8)
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(plte), :3] = plte
        if trns is not None:
            a = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(a), 3] = a
        return pal[px[..., 0]], False
    if ctype in (0, 4):
        rgb = np.repeat(px[..., :1], 3, axis=2)
    else:
        rgb = px[..., :3]
    if ctype in (4, 6):
        alpha = px[..., -1]
    elif trns is not None:
        # the transparent value, as 16-bit samples of the image's depth
        key = np.asarray(struct.unpack(f">{len(trns) // 2}H", trns))
        alpha = np.where((px == key.astype(np.uint8)).all(-1), 0,
                         255).astype(np.uint8)
    return np.concatenate([rgb, alpha[..., None]], 2), ctype in (4, 6)


def load_png(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: the image's RGB, as Pillow's
    ``convert("RGB")`` gives it."""
    rgba, _ = _rgba8(path)
    return rgba[..., :3].astype(np.float32) / 255.0


def load_png_rgba(path: str) -> tuple[np.ndarray, bool]:
    """((H, W, 4) float32 RGBA in [0, 1], has_alpha), as Pillow's
    ``convert("RGBA")`` gives it; ``has_alpha`` is true for grey+alpha and
    RGBA images."""
    rgba, has_alpha = _rgba8(path)
    return rgba.astype(np.float32) / 255.0, has_alpha
