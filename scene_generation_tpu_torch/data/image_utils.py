"""Host-side image utilities in numpy and the standard library.

``load_image``, ``normalize``, ``resize_mask`` and ``deprocess`` are the
JAX package's ``data/image_utils.py`` functions. ``encode_png`` and
``decode_png`` replace its PIL calls (``PIL.Image.save`` /
``PIL.Image.open``) and ``resize`` PIL's resampling (the same filter
coefficients and the same 8-bit fixed-point rounding), so that PNG
images and masks need no PIL; only a JPEG read imports it. ``vis.py``
replaces matplotlib.
"""
from __future__ import annotations

import functools
import io
import os
import struct
import zlib
from typing import Tuple

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


def normalize(img: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] on the host (reference data/utils.py:6-14;
    the device's twin is ``ops/images.wire_to_float``); float passes."""
    if img.dtype == np.uint8:
        return (np.asarray(img, np.float32) / 255.0 - MEAN) / STD
    return img


# --- PIL's resampling, rebuilt ---------------------------------------------

_PRECISION_BITS = 22          # PIL's 8-bit resample: 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    return np.maximum(1.0 - np.abs(x), 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic kernel (a = -0.5)."""
    a, x = -0.5, np.abs(x)
    return np.where(x < 1, ((a + 2) * x - (a + 3)) * x * x + 1,
                    np.where(x < 2, (((x - 5) * x + 8) * x - 4) * a, 0.0))


# name -> (kernel, support): PIL's ``filters`` table.
_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


@functools.lru_cache(maxsize=32)
def pil_weights(n_in: int, n_out: int, filter: str
                ) -> Tuple[np.ndarray, np.ndarray]:
    """One PIL resample pass (``precompute_coeffs`` +
    ``normalize_coeffs_8bpc``) as taps: (n_out, K) input indices and their
    (n_out, K) int64 fixed-point weights, zero past each output's
    support."""
    kernel, support = _FILTERS[filter]
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ss = 1.0 / filterscale
    spans = []
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        k = kernel((np.arange(lo, hi) - center + 0.5) * ss)
        spans.append((lo, k / k.sum() if k.sum() != 0 else k))
    width = max(len(k) for _, k in spans)
    index = np.zeros((n_out, width), np.int64)
    weights = np.zeros((n_out, width), np.float64)
    for xx, (lo, k) in enumerate(spans):
        index[xx] = np.minimum(lo + np.arange(width), n_in - 1)
        weights[xx, :len(k)] = k
    fixed = weights * (1 << _PRECISION_BITS)
    return index, np.trunc(np.where(fixed < 0, fixed - 0.5,
                                    fixed + 0.5)).astype(np.int64)


def _pass(img: np.ndarray, taps, axis: int) -> np.ndarray:
    index, weights = taps
    x = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((len(index),) + x.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    shape = (-1,) + (1,) * (x.ndim - 1)
    for k in range(index.shape[1]):
        acc += x[index[:, k]] * weights[:, k].reshape(shape)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(img: np.ndarray, size: Tuple[int, int],
           filter: str = "bicubic") -> np.ndarray:
    """(H, W[, C]) uint8 -> (size[0], size[1][, C]): ``PIL.Image.resize``
    with the ``filter`` ("bilinear" or "bicubic"), horizontal pass
    first."""
    h, w = size
    if img.shape[1] != w:
        img = _pass(img, pil_weights(img.shape[1], w, filter), 1)
    if img.shape[0] != h:
        img = _pass(img, pil_weights(img.shape[0], h, filter), 0)
    return img


def load_image(path: str, size) -> np.ndarray:
    """The image file at ``path`` as (size[0], size[1], 3) uint8 RGB,
    resized by PIL's bilinear filter (the JAX package's ``load_image``;
    uint8 is the host-to-device wire format). A PNG is read by
    ``decode_png`` and resized here; any other format (COCO's JPEGs) is
    read by PIL, imported here and only here."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return resize(to_rgb(decode_png(data)), tuple(size), "bilinear")
    try:
        import PIL.Image
    except ImportError as e:
        fmt = "JPEG" if data[:2] == b"\xff\xd8" else (
            os.path.splitext(path)[1].lstrip(".").upper() or "non-PNG")
        raise ImportError(f"{path} is a {fmt} image: reading it needs PIL, "
                          "which is not installed (PNG needs no PIL)") from e
    with PIL.Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB").resize((size[1], size[0]),
                                      PIL.Image.BILINEAR)
        return np.asarray(im, np.uint8)


def resize_mask(mask: np.ndarray, size: int,
                threshold: int = 128) -> np.ndarray:
    """A binary (0 / 1) mask resized to (size, size) by PIL's bilinear
    filter on 255 * mask, then re-binarized: ``> 128`` for instances
    (coco.py:308-309), ``> 127`` for panoptic (coco_panoptic.py:355)."""
    arr = resize((mask * 255).astype(np.uint8), (size, size), "bilinear")
    return (arr > threshold).astype(np.int64)


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
