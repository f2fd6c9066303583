"""Batch inference server (port of the JAX package's ``serve.py``).

  POST /generate
    {"scene_graphs": [ {objects, relationships, attributes, features,
                        image_id}, ... ]}
  ->
    {"images": ["<base64 png>", ...], "layouts": ["<base64 png>", ...],
     "boxes_pred": [[[x0,y0,x1,y1], ...], ...]}

  GET /healthz   -> {"status": "ok", "device": "...", "num_classes": N}
  GET /vocab     -> {"objects": [...], "predicates": [...]}

Run: python -m scene_generation_tpu_torch.serve --output_dir <train output dir>
     [--checkpoint_name checkpoint] [--best 1] [--port 8001] [--device cpu]

PNGs are written by a standard-library encoder and layouts are drawn in
numpy, so serving needs neither PIL nor matplotlib.
"""
from __future__ import annotations

import argparse
import base64
import json
from http.server import BaseHTTPRequestHandler, HTTPServer
from typing import Optional

import numpy as np

from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.data.image_utils import deprocess, encode_png
from scene_generation_tpu_torch.vis import draw_layout


def _png_b64(arr_uint8: np.ndarray) -> str:
    return base64.b64encode(encode_png(arr_uint8)).decode("ascii")


class Server:
    def __init__(self, output_dir: str, checkpoint_name: str = "checkpoint",
                 features_path: Optional[str] = None, best: bool = False,
                 device: Optional[str] = None):
        self.model = InferenceModel.from_checkpoint(
            output_dir, checkpoint_name, best=best,
            features_path=features_path, device=device)

    def generate(self, payload: dict) -> dict:
        out, batch = self.model.forward_json(payload["scene_graphs"])
        imgs = out.imgs_pred.cpu().numpy()
        boxes_pred = out.boxes_pred.cpu().numpy()
        masks_pred = out.masks_pred.cpu().numpy()
        images, layouts, boxes = [], [], []
        for i in range(batch.num_images):
            images.append(_png_b64(deprocess(imgs[i])))
            o_real = int(batch.obj_mask[i].sum())
            layouts.append(_png_b64(draw_layout(
                self.model.vocab, batch.objs[i][:o_real],
                boxes_pred[i][:o_real], masks_pred[i][:o_real])))
            boxes.append(boxes_pred[i][:o_real].tolist())
        return {"images": images, "layouts": layouts, "boxes_pred": boxes}

    def vocab(self) -> dict:
        v = self.model.vocab
        return {"objects": [n for n in v["my_idx_to_obj"]
                            if n and n != "__image__"],
                "predicates": v["pred_idx_to_name"]}

    def healthz(self) -> dict:
        return {"status": "ok", "device": str(self.model.device),
                "num_classes": self.model.cfg.model.num_objs}


def make_handler(server: Server):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, server.healthz())
            if self.path == "/vocab":
                return self._send(200, server.vocab())
            return self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                return self._send(404, {"error": "not found"})
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                return self._send(200, server.generate(payload))
            except Exception as e:  # the server keeps serving; report it
                self.log_error("generate failed: %r", e)
                return self._send(500, {"error": str(e)})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--output_dir", required=True,
                   help="a train run's output dir (or save_checkpoint's)")
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--features_path", default=None)
    p.add_argument("--best", type=int, default=0,
                   help="1: serve best/ instead of last/")
    p.add_argument("--port", type=int, default=8001)
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    server = Server(a.output_dir, a.checkpoint_name, a.features_path,
                    bool(a.best), a.device)
    httpd = HTTPServer(("0.0.0.0", a.port), make_handler(server))
    print(f"serving on http://localhost:{a.port} "
          f"(POST /generate, GET /vocab, GET /healthz)")
    httpd.serve_forever()


if __name__ == "__main__":
    main()
