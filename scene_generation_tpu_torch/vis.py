"""Visualization (port of the JAX package's ``vis.py``; reference
``scene_generation/vis.py``), in numpy and torch: no matplotlib, no PIL.

``draw_layout`` renders masks into an RGB canvas with matplotlib's
'rainbow' colours, as the JAX package's does; each mask is resized to its
box by nearest neighbour where the JAX package uses PIL's filter.
``add_boxes_to_layout`` draws the box outlines in numpy and, unlike the JAX
package's, no name labels: there is no font rasterizer here. Scene graphs
are graphviz source, rendered by ``dot`` when it is installed.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from typing import List, Optional, Sequence

import numpy as np


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


def _obj_name(vocab, cls: int) -> str:
    table = vocab.get("my_idx_to_obj")
    if table and cls < len(table) and table[cls]:
        return table[cls]
    return str(cls)


def draw_layout(vocab, objs, boxes, masks=None, size: int = 256,
                show_boxes: bool = False, bgcolor=(0, 0, 0)) -> np.ndarray:
    """Render object masks (and, with ``show_boxes``, box outlines) into an
    RGB uint8 canvas (reference vis.py:31-60)."""
    colors = rainbow(np.linspace(0, 1, len(objs)))
    canvas = np.zeros((size, size, 3), np.float32)
    canvas[:] = np.asarray(bgcolor, np.float32).reshape(1, 1, 3)
    for i, obj in enumerate(objs):
        if _obj_name(vocab, int(obj)) == "__image__":
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
    out = (np.clip(canvas, 0, 1) * 255).astype(np.uint8)
    if show_boxes:
        out = add_boxes_to_layout(
            out, [_obj_name(vocab, int(o)) for o in objs], boxes, size)
    return out


def add_boxes_to_layout(canvas: np.ndarray, names: Sequence[str], boxes,
                        size: int) -> np.ndarray:
    """White one-pixel outlines of every box but ``__image__``'s on a copy
    of the uint8 canvas (reference vis.py:83-103, without its labels)."""
    out = np.array(canvas, np.uint8)
    for name, box in zip(names, boxes):
        if name == "__image__":
            continue
        x0, y0, x1, y1 = (np.clip(np.asarray(box, np.float64), 0, 1)
                          * (size - 1)).round().astype(int)
        out[y0:y1 + 1, [x0, x1]] = 255
        out[[y0, y1], x0:x1 + 1] = 255
    return out


def scene_graph_source(vocab, objs, triples,
                       vocab_pred: Optional[List[str]] = None) -> str:
    """Graphviz digraph text for a scene graph (reference vis.py:134-209)."""
    lines = ["digraph{", '  graph [ratio="compress", margin="0"];',
             "  node [shape=box, style=filled];"]
    for i, obj in enumerate(objs):
        name = _obj_name(vocab, int(obj))
        lines.append(f'  o{i} [label="{name}", fillcolor="lightblue"];')
    preds = vocab_pred or vocab["pred_idx_to_name"]
    for k, (s, p, o) in enumerate(triples):
        pname = preds[int(p)]
        if pname == "__in_image__":
            continue
        lines.append(f'  p{k} [label="{pname}", fillcolor="lightyellow"];')
        lines.append(f"  o{int(s)} -> p{k} -> o{int(o)};")
    lines.append("}")
    return "\n".join(lines)


def draw_scene_graph(vocab, objs, triples, output_path: Optional[str] = None):
    """Render the graph with ``dot`` if installed (reference
    vis.py:210-217); returns the png path, or the graphviz source when
    ``dot`` is not installed."""
    src = scene_graph_source(vocab, objs, triples)
    dot = shutil.which("dot")
    if dot is None:
        return src
    with tempfile.NamedTemporaryFile("w", suffix=".dot",
                                     delete=False) as f:
        f.write(src)
        dot_path = f.name
    png = output_path or dot_path.replace(".dot", ".png")
    try:
        subprocess.run([dot, "-Tpng", dot_path, "-o", png], check=True)
    finally:
        os.unlink(dot_path)
    return png


def _palette(c: int, colors: Optional[np.ndarray]) -> np.ndarray:
    """Seed-0 random palette shared by both one_hot_to_rgb variants."""
    if colors is not None:
        return colors
    return np.random.RandomState(0).randint(0, 256, (c, 3)).astype(np.float32)


def _normalize_rgb(rgb: np.ndarray) -> np.ndarray:
    maxv = rgb.max() or 1.0
    return (rgb * (255.0 / maxv)).astype(np.uint8)


def one_hot_to_rgb(layout_one_hot: np.ndarray,
                   colors: Optional[np.ndarray] = None) -> np.ndarray:
    """Layout channels (NHWC) -> random-colour RGB uint8 (reference
    trainer.py:394-397)."""
    colors = _palette(layout_one_hot.shape[-1], colors)
    rgb = np.einsum("nhwc,cd->nhwd", np.asarray(layout_one_hot, np.float32),
                    colors)
    return _normalize_rgb(rgb)


def one_hot_to_rgb_compact(layout_one_hot,
                           colors: Optional[np.ndarray] = None) -> np.ndarray:
    """``one_hot_to_rgb`` with the palette contraction done where the
    layout lies (the card), so only the (N, H, W, 3) projection leaves it."""
    import torch
    x = torch.as_tensor(layout_one_hot).float()
    colors = _palette(x.shape[-1], colors)
    rgb = torch.einsum("nhwc,cd->nhwd", x,
                       torch.from_numpy(colors).to(x.device)).cpu().numpy()
    return _normalize_rgb(rgb)
