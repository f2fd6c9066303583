"""Host-side image utilities in numpy and the standard library.

``deprocess`` is a copy of the JAX package's ``data/image_utils.py``
function. ``encode_png`` and ``decode_png`` replace the PIL calls of the
JAX package's serving and evaluation scripts (``PIL.Image.save`` /
``PIL.Image.open``), so that neither path needs PIL; ``vis.py`` replaces
matplotlib.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

MEAN = 0.5
STD = 0.5


def deprocess(img: np.ndarray, rescale: bool = True) -> np.ndarray:
    """[-1, 1] float (one image, HWC) -> uint8; uint8 input passes through.

    ``rescale=True`` (the reference default, data/utils.py:17-28) min-max
    stretches the un-normalized image to the full [0, 255] range;
    ``rescale=False`` clips instead.
    """
    if img.dtype == np.uint8:
        return img
    arr = img * STD + MEAN
    if rescale:
        lo, hi = arr.min(), arr.max()
        # Guard the constant-image edge so the division cannot give NaN.
        arr = (arr - lo) / max(hi - lo, 1e-12)
    else:
        arr = np.clip(arr, 0.0, 1.0)
    return (arr * 255).astype(np.uint8)


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes (8-bit RGB, no interlace)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_png expects (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    # Filter type 0 (None) before every scanline.
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


# Channels of each 8-bit PNG colour type decode_png reads: grey, RGB,
# grey + alpha, RGBA.
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline (int32, filter byte removed) given the previous
    reconstructed one: the five PNG filter types (PNG spec §9.2)."""
    if kind == 0:
        return row
    if kind == 1:          # Sub: a running sum per channel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 255
    if kind == 2:          # Up
        return (row + prev) & 255
    if kind not in (3, 4):
        raise ValueError(f"PNG filter type {kind} does not exist")
    # Average and Paeth read the reconstructed pixel to the left: one
    # pixel (bpp bytes) at a time.
    out = np.empty_like(row)
    left = np.zeros(bpp, row.dtype)
    up_left = np.zeros(bpp, row.dtype)
    for x in range(0, row.size, bpp):
        up = prev[x:x + bpp]
        pred = (left + up) >> 1 if kind == 3 else _paeth(left, up, up_left)
        left = (row[x:x + bpp] + pred) & 255
        out[x:x + bpp] = left
        up_left = up
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8: 8-bit grey (C=1), RGB (3), grey with
    alpha (2) or RGBA (4), not interlaced, any of the five row filters;
    the standard library's ``zlib`` inflates. Other PNGs raise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"decode_png reads 8-bit grey, RGB, grey+alpha or "
                         f"RGBA without interlace; this file has bit depth "
                         f"{depth}, colour type {color}, interlace "
                         f"{interlace}")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data of {raw.size} bytes for {h} rows of "
                         f"{stride + 1}")
    rows = raw.reshape(h, stride + 1).astype(np.int32)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        prev = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp)
        out[y] = prev
    return out.reshape(h, w, bpp)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 from ``decode_png`` -> (H, W, 3): grey repeated,
    alpha dropped (``PIL.Image.convert("RGB")``)."""
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3]


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def read_png(path: str) -> np.ndarray:
    """A PNG file as (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        return to_rgb(decode_png(f.read()))
