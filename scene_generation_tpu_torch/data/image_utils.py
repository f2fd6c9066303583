"""Host-side image utilities in numpy and the standard library.

``deprocess`` is a copy of the JAX package's ``data/image_utils.py``
function. ``draw_layout`` and ``encode_png`` replace its matplotlib and PIL
calls, so that the serving path needs neither.
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


def rainbow(x: np.ndarray) -> np.ndarray:
    """matplotlib's 'rainbow' colormap: (K,) in [0, 1] -> (K, 3) RGB."""
    x = np.asarray(x, np.float64)
    rgb = np.stack([np.abs(2 * x - 0.5), np.sin(np.pi * x),
                    np.cos(np.pi * x / 2)], axis=-1)
    return np.clip(rgb, 0.0, 1.0)


def _resize_nearest(m: np.ndarray, h: int, w: int) -> np.ndarray:
    mh, mw = m.shape
    yy = np.minimum(np.arange(h) * mh // h, mh - 1)
    xx = np.minimum(np.arange(w) * mw // w, mw - 1)
    return m[np.ix_(yy, xx)]


def draw_layout(vocab, objs, boxes, masks=None, size: int = 256,
                bgcolor=(0, 0, 0)) -> np.ndarray:
    """Render object masks into an RGB uint8 canvas.

    The JAX package's ``vis.draw_layout`` with the same colors and box
    rounding; the mask is resized to its box by nearest neighbour instead
    of PIL's filter.
    """
    colors = rainbow(np.linspace(0, 1, len(objs)))
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:] = np.asarray(bgcolor, np.float32).reshape(1, 1, 3)
    names = vocab.get("my_idx_to_obj") or []
    for i, obj in enumerate(objs):
        if int(obj) < len(names) and names[int(obj)] == "__image__":
            continue
        x0, y0, x1, y1 = np.clip(np.asarray(boxes[i], np.float64), 0, 1)
        px0, py0 = int(x0 * size), int(y0 * size)
        px1 = min(max(int(x1 * size), px0 + 1), size)
        py1 = min(max(int(y1 * size), py0 + 1), size)
        if px0 >= size or py0 >= size:
            continue
        color = colors[i].astype(np.float32)
        if masks is None:
            canvas[py0:py1, px0:px1] = color
            continue
        m = _resize_nearest(np.asarray(masks[i], np.float32),
                            py1 - py0, px1 - px0)[..., None]
        region = canvas[py0:py1, px0:px1]
        canvas[py0:py1, px0:px1] = region * (1 - m) + m * color
    return (np.clip(canvas, 0, 1) * 255).astype(np.uint8)


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


def one_hot_to_rgb_compact(layout_one_hot) -> np.ndarray:
    """Layout channels (NHWC) -> random-colour RGB uint8 (a copy of the JAX
    package's ``vis.one_hot_to_rgb_compact``; reference trainer.py:394-397):
    the seed-0 palette contraction is done where the layout lies, so only
    the (N, H, W, 3) projection leaves the card."""
    import torch
    x = torch.as_tensor(layout_one_hot).float()
    colors = np.random.RandomState(0).randint(
        0, 256, (x.shape[-1], 3)).astype(np.float32)
    rgb = torch.einsum("nhwc,cd->nhwd", x,
                       torch.from_numpy(colors).to(x.device)).cpu().numpy()
    maxv = rgb.max() or 1.0
    return (rgb * (255.0 / maxv)).astype(np.uint8)
