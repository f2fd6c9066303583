"""COCO mask codec (port of the JAX package's ``data/rle.py``): the C++
helper ``native/rle.cpp`` decodes RLE and rasterizes polygons; the numpy
functions have the same semantics and are the tests' oracle.

The helper is compiled by ``g++`` at first use into ``build/native/``
beside the package (the file name carries a hash of the source and the
flags, so an edited source is rebuilt) and loaded with ``ctypes``.
Nothing is built when the module is imported. A failed build raises with
the compiler's output: the readers never fall back to numpy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "native" / "rle.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"librle-{digest[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"the COCO mask codec needs g++ to build "
                           f"{SRC}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
    # Rename into place: a concurrent build never loads a partial file.
    os.replace(tmp, target)


def load_library() -> ctypes.CDLL:
    """The loaded codec, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.rle_decode.argtypes = [ctypes.c_char_p, i32, i32, ptr]
            lib.rle_decode_counts.argtypes = [ptr, i32, i32, i32, ptr]
            lib.polygons_to_mask.argtypes = [ptr, ptr, i32, i32, i32, ptr]
            lib.rle_encode_counts.argtypes = [ptr, i32, i32, ptr, i32]
            for fn in (lib.rle_decode, lib.rle_decode_counts,
                       lib.polygons_to_mask, lib.rle_encode_counts):
                fn.restype = i32
            _lib = lib
        return _lib


# --- numpy versions (the tests' oracle) -----------------------------------

def rle_counts_from_string(s: Union[str, bytes]) -> List[int]:
    """Decode the compressed counts string (pycocotools rleFrString)."""
    if isinstance(s, str):
        s = s.encode("ascii")
    counts: List[int] = []
    p = 0
    while p < len(s):
        x, k, more = 0, 0, True
        while more:
            c = s[p] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def decode_counts_py(counts: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for run in counts:
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def polygons_to_mask_py(polys: Sequence[Sequence[float]], h: int,
                        w: int) -> np.ndarray:
    """Even-odd scanline fill at pixel centers; union over polygons."""
    out = np.zeros((h, w), np.uint8)
    for poly in polys:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        n = len(pts)
        for row in range(h):
            y = row + 0.5
            xs = []
            for i in range(n):
                x0, y0 = pts[i]
                x1, y1 = pts[(i + 1) % n]
                if (y0 <= y < y1) or (y1 <= y < y0):
                    t = (y - y0) / (y1 - y0)
                    xs.append(x0 + t * (x1 - x0))
            xs.sort()
            for i in range(0, len(xs) - 1, 2):
                c0 = max(int(np.ceil(xs[i] - 0.5)), 0)
                c1 = min(int(np.floor(xs[i + 1] - 0.5)), w - 1)
                if c1 >= c0:
                    out[row, c0:c1 + 1] = 1
    return out


def encode_counts_py(mask: np.ndarray) -> List[int]:
    flat = mask.T.reshape(-1).astype(np.uint8)
    changes = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat[0] == 1:
        runs = [0] + runs
    return runs


def seg_to_mask_py(seg, width: int, height: int) -> np.ndarray:
    """``seg_to_mask`` in numpy alone (the oracle)."""
    h, w = int(height), int(width)
    if isinstance(seg, list):
        polys = [p for p in seg if len(p) >= 6]
        return polygons_to_mask_py(polys, h, w) if polys \
            else np.zeros((h, w), np.uint8)
    counts = seg["counts"]
    sh, sw = (int(v) for v in seg.get("size", (h, w)))
    if not isinstance(counts, list):
        counts = rle_counts_from_string(counts)
    return decode_counts_py(counts, sh, sw)


# --- the readers' path ------------------------------------------------------

def seg_to_mask(seg, width: int, height: int) -> np.ndarray:
    """Decode any COCO segmentation to an (H, W) uint8 mask with the native
    codec (reference ``seg_to_mask``, coco.py:475-486): polygon lists are
    unioned; dicts hold uncompressed (list) or compressed (str / bytes)
    counts. Counts that do not cover the mask exactly raise."""
    lib = load_library()
    h, w = int(height), int(width)
    if isinstance(seg, list):
        polys = [p for p in seg if len(p) >= 6]
        out = np.zeros((h, w), np.uint8)
        if polys:
            xy = np.concatenate([np.asarray(p, np.float64) for p in polys])
            sizes = np.asarray([len(p) // 2 for p in polys], np.int32)
            lib.polygons_to_mask(xy.ctypes.data, sizes.ctypes.data,
                                 len(polys), h, w, out.ctypes.data)
        return out

    counts = seg["counts"]
    sh, sw = (int(v) for v in seg.get("size", (h, w)))
    out = np.zeros((sh, sw), np.uint8)
    if isinstance(counts, list):
        arr = np.asarray(counts, np.uint32)
        rc = lib.rle_decode_counts(arr.ctypes.data, len(arr), sh, sw,
                                   out.ctypes.data)
    else:
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        rc = lib.rle_decode(counts, sh, sw, out.ctypes.data)
    if rc != 0:
        raise ValueError(f"RLE counts do not cover a {sh}x{sw} mask")
    return out
