"""The interactive scene-editing GUI's backend (port of the JAX package's
``scripts/gui/server.py``; reference ``scripts/gui/simple-server.py``).

    python -m scene_generation_tpu_torch.tools.gui_server \\
        --output_dir <run> [--features_path .../features_clustered_100.npy] \\
        [--port 8000] [--cpu]

The same HTTP contract, serving the repo's ``scripts/gui/index.html`` and
``index.js`` as they are:

  GET /                      -> index.html
  GET /get_data?data=<json>  -> {"img_pred": path, "img_layout": path}
  GET /vocab                 -> {"objects": [...], "groups": {...}}
  GET /images/outputs/...    -> the generated PNGs (``--images_dir``)
  GET /<file>                -> the GUI's static files

The scene JSON is the reference's (gui/model.py:111-180): objects with
left / top / width / height in [0, 1], ``size`` (0-9), ``location``
(0-24) and a ``feature`` cluster index, turned into a chain of relations
between consecutive objects by ``json_to_scene_graph``. The forward runs
on the card (``InferenceModel.forward_json``, batch 1); PNGs are written
by ``encode_png`` and the layout with box outlines by ``vis.draw_layout``
(no labels).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import urllib.parse
from http.server import HTTPServer, SimpleHTTPRequestHandler
from typing import Optional, Tuple


from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.data.image_utils import deprocess, write_png
from scene_generation_tpu_torch.tools import device_of
from scene_generation_tpu_torch.vis import draw_layout

GUI_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scripts", "gui")
OUTPUTS = "images/outputs"        # the URL prefix of the generated PNGs


def _predicate(s_box, o_box, theta: float) -> str:
    sx0, sy0, sx1, sy1 = s_box
    ox0, oy0, ox1, oy1 = o_box
    if sx0 < ox0 and sx1 > ox1 and sy0 < oy0 and sy1 > oy1:
        return "surrounding"
    if sx0 > ox0 and sx1 < ox1 and sy0 > oy0 and sy1 < oy1:
        return "inside"
    if theta >= 3 * math.pi / 4 or theta <= -3 * math.pi / 4:
        return "left of"
    if -3 * math.pi / 4 <= theta < -math.pi / 4:
        return "above"
    if -math.pi / 4 <= theta < math.pi / 4:
        return "right of"
    return "below"


def _margin_box(obj: dict):
    """The object's centre and its box shrunk to a square of half-side
    (size + 1) / 20 around it, clipped to [0, 1]."""
    x0, y0 = obj["left"], obj["top"]
    x1, y1 = x0 + obj["width"], y0 + obj["height"]
    margin = (obj["size"] + 1) / 10 / 2
    mx, my = 0.5 * (x0 + x1), 0.5 * (y0 + y1)
    return (mx, my), (max(0, mx - margin), max(0, my - margin),
                      min(1, mx + margin), min(1, my + margin))


def json_to_scene_graph(json_text: str):
    """The reference's ``json_to_scene_graph`` (gui/model.py:111-180): a
    chain of relations between consecutive objects, each predicate from
    the two margin boxes and the angle between the centres."""
    scene = json.loads(json_text)
    if not scene:
        return []
    objs = scene["objects"]
    relationships = []
    for i in range(len(objs) - 1):
        (mx, my), s_box = _margin_box(objs[i])
        (mxo, myo), o_box = _margin_box(objs[i + 1])
        theta = math.atan2(my - myo, mx - mxo)
        relationships.append([i, _predicate(s_box, o_box, theta), i + 1])
    return [{"objects": [o["text"] for o in objs],
             "relationships": relationships,
             "attributes": {"size": [o["size"] for o in objs],
                            "location": [o["location"] for o in objs]},
             "features": [o.get("feature", -1) for o in objs],
             "image_id": scene.get("image_id", 0)}]


class GuiBackend:
    def __init__(self, output_dir: str, checkpoint_name: str = "checkpoint",
                 features_path: Optional[str] = None,
                 images_dir: Optional[str] = None, device=None):
        self.model = InferenceModel.from_checkpoint(
            output_dir, checkpoint_name, features_path=features_path,
            device=device)
        self.images_dir = images_dir or os.path.join(GUI_DIR, OUTPUTS)
        os.makedirs(self.images_dir, exist_ok=True)

    def json_to_img(self, json_text: str
                    ) -> Tuple[Optional[str], Optional[str]]:
        """Generate the scene (reference gui/model.py:63-102), save the
        image and its layout; their URL paths, or (None, None) for an empty
        scene."""
        scene_graphs = json_to_scene_graph(json_text)
        if not scene_graphs:
            return None, None
        out, batch = self.model.forward_json(scene_graphs)
        stamp = time.strftime("%b%d_%H-%M-%S")
        write_png(os.path.join(self.images_dir, f"img{stamp}.png"),
                  deprocess(out.imgs_pred[0].cpu().numpy()))
        o_real = int(batch.obj_mask[0].sum())
        layout = draw_layout(self.model.vocab, batch.objs[0][:o_real],
                             out.boxes_pred[0].cpu().numpy()[:o_real],
                             out.masks_pred[0].cpu().numpy()[:o_real],
                             show_boxes=True)
        write_png(os.path.join(self.images_dir, f"img_layout{stamp}.png"),
                  layout)
        return f"{OUTPUTS}/img{stamp}.png", f"{OUTPUTS}/img_layout{stamp}.png"

    def vocab(self) -> dict:
        """The object menu, grouped into things / stuff / other when the
        vocab carries the split."""
        vocab = self.model.vocab
        names = [n for n in vocab["my_idx_to_obj"]
                 if n and n != "__image__"]
        payload = {"objects": names}
        things = set(vocab.get("instance") or [])
        stuff = set(vocab.get("stuff") or [])
        if things or stuff:
            payload["groups"] = {
                "things": sorted(n for n in names if n in things),
                "stuff": sorted(n for n in names if n in stuff),
                "other": sorted(n for n in names
                                if n not in things and n not in stuff),
            }
        return payload


def make_handler(backend: GuiBackend):
    class Handler(SimpleHTTPRequestHandler):
        def __init__(self, *a, **kw):
            super().__init__(*a, directory=GUI_DIR, **kw)

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def translate_path(self, path: str) -> str:
            rel = urllib.parse.urlparse(path).path.lstrip("/")
            if rel.startswith(OUTPUTS + "/"):
                name = os.path.basename(rel)
                return os.path.join(backend.images_dir, name)
            return super().translate_path(path)

        def do_GET(self):
            if self.path.startswith("/get_data"):
                query = urllib.parse.urlparse(self.path).query
                data = urllib.parse.parse_qs(query).get("data", [""])[0]
                try:
                    img, layout = backend.json_to_img(data)
                except Exception as e:  # the client shows the error
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, {"img_pred": img, "img_layout": layout})
                return
            if self.path == "/vocab":
                self._json(200, backend.vocab())
                return
            if self.path == "/":
                self.path = "/index.html"
            super().do_GET()

    return Handler


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--features_path", default=None)
    p.add_argument("--images_dir", default=None,
                   help="where the generated PNGs go (default: "
                        "scripts/gui/images/outputs)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    a = p.parse_args(argv)
    backend = GuiBackend(a.output_dir, a.checkpoint_name, a.features_path,
                         a.images_dir, device_of(a))
    server = HTTPServer(("0.0.0.0", a.port), make_handler(backend))
    print(f"GUI server on http://localhost:{a.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
