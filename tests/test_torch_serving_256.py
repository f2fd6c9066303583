"""The port at the paper's second COCO-Stuff resolution, 256x256.

On the CPU: the test-mode serving forward at ``image_size (256, 256)``,
small widths and the benchmark's seeded weights, against the plain
reference of ``port_bench/reference/scene_model.py``. On the card (marked
``cuda``, skipped without an NVIDIA GPU): a 256 px checkpoint served in
bf16 through ``Server.generate`` and ``sample_images``, whose stems run in
pixel bands (``stem_tc_banded``). This file imports no JAX, so the card
tests run where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_256.py
"""
import base64
import dataclasses
import json

import numpy as np
import pytest
import torch

from port_bench import serve
from port_bench.reference import scene_model as ref
from scene_generation_tpu_torch.api import InferenceModel
from scene_generation_tpu_torch.config import Config, tiny_config
from scene_generation_tpu_torch.convert import save_checkpoint
from scene_generation_tpu_torch.data import synthetic_batch, synthetic_vocab
from scene_generation_tpu_torch.data.image_utils import decode_png
from scene_generation_tpu_torch.entry import build_model
from scene_generation_tpu_torch.models import SceneModel
from scene_generation_tpu_torch.ops import _cuda
from scene_generation_tpu_torch.serve import Server
from scene_generation_tpu_torch.tools import sample_images

SIZE = (256, 256)
TRAFFIC = {"batch": 4, "min_objects": 2, "max_objects": 3,
           "pool_batches": 2, "clusters": 3}


def at_256(cfg: Config) -> Config:
    return cfg.replace(data=dataclasses.replace(cfg.data, image_size=SIZE),
                       model=dataclasses.replace(cfg.model, image_size=SIZE))


def test_serving_forward_at_256_px_matches_the_reference():
    """``tiny_config()`` at 256 px, f32, the benchmark's weights and
    traffic drawn from a seed: boxes, masks and every image that claims a
    pixel within the plain reference's f32 rounding."""
    cfg = at_256(tiny_config())
    cfg_d = dict(json.loads(cfg.to_json()), serve_compute_dtype="float32")
    mc = serve.model_config(cfg_d)
    model = SceneModel(cfg.model).eval()
    pool, feats = serve.draw_traffic(cfg_d, TRAFFIC, 5)
    probe = serve.ref_inputs(pool[0], feats[0],
                             torch.zeros(mc["mask_noise_dim"]), "cpu")
    P = serve.make_weights(model, mc, probe, 5, "cpu", torch.float32)
    im = InferenceModel(cfg, {}, model)
    for j in range(len(pool)):
        out = im.forward_batch(pool[j], use_gt_attributes=True,
                               features=feats[j][0],
                               features_mask=feats[j][1],
                               generator=serve.noise_of(7, j))
        noise = torch.randn(mc["mask_noise_dim"],
                            generator=serve.noise_of(7, j))
        inp = serve.ref_inputs(pool[j], feats[j], noise, "cpu")
        with torch.no_grad():
            r = ref.serve(P, mc, inp)
        assert out.imgs_pred.shape == (TRAFFIC["batch"], *SIZE, 3)
        valid = inp["obj_mask"] > 0
        assert (out.boxes_pred - r["boxes"]).abs()[valid].max() < 1e-5
        assert (out.masks_pred - r["masks"]).abs()[valid].max() < 1e-5
        nonempty = [k for k in range(r["imgs"].shape[0])
                    if float(ref.layout(r["boxes"], r["masks"], r["vecs"],
                                        inp["obj_mask"], *SIZE)
                             [k].abs().max()) > 0]
        assert nonempty
        assert (out.imgs_pred - r["imgs"])[nonempty].abs().max() < 1e-4


@pytest.fixture(scope="module")
def ckpt_256(tmp_path_factory):
    """The default Config() at 256 px with serving in bf16, seed weights
    and the mask head scaled (on the card, in f32) to unit logit spread
    (else bf16 rounds every mask to 0.5 and nothing is claimed), saved as
    a checkpoint; and a k=1 appearance table of every class."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the bf16 stem runs only on the "
                    "card")
    cfg = at_256(Config())
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                compute_dtype="bfloat16"))
    model = build_model(cfg, "cuda", seed=0).float()
    batch = synthetic_batch(cfg, seed=100, batch_size=8)
    out = InferenceModel(cfg, {}, model).forward_batch(
        batch, use_gt_attributes=True,
        features=np.zeros((8, cfg.data.max_objs, cfg.model.rep_size),
                          np.float32))
    spread = float(torch.logit(out.masks_pred.double()).std())
    with torch.no_grad():
        model.mask_net.out.weight.div_(spread)
        model.mask_net.out.bias.div_(spread)
    d = tmp_path_factory.mktemp("ckpt_256")
    save_checkpoint(str(d), model, cfg, synthetic_vocab(cfg.model.num_objs))
    rng = np.random.RandomState(0)
    table = {c: rng.randn(1, cfg.model.rep_size).astype(np.float32)
             for c in range(1, cfg.model.num_objs)}
    np.save(d / "features_clustered_001.npy", table, allow_pickle=True)
    return d


@pytest.mark.cuda
def test_server_generate_at_256_px(ckpt_256):
    scene = {"objects": ["class_1", "class_2", "class_3"],
             "relationships": [[0, "left of", 1], [1, "above", 2]],
             "attributes": {"size": [4, 5, 3], "location": [6, 12, 18]},
             "features": [-1, -1, -1], "image_id": 0}
    server = Server(str(ckpt_256))
    assert server.model.model.mask_net.out.weight.dtype == torch.bfloat16
    _cuda.LAUNCHES.clear()
    resp = server.generate({"scene_graphs": [scene, scene]})
    assert dict(_cuda.LAUNCHES) == {"stem": 1, "stem_tc_banded": 1}
    assert len(resp["images"]) == 2 and len(resp["boxes_pred"][0]) == 4
    img = decode_png(base64.b64decode(resp["images"][0]))
    assert img.shape == (256, 256, 3) and img.std() > 0


@pytest.mark.cuda
def test_sample_images_at_256_px(ckpt_256, tmp_path):
    """Two batches of 8 synthetic scenes with the k=1 table: 16 images of
    256 px written, both stems in bands, IoU and recalls finite."""
    _cuda.LAUNCHES.clear()
    results = sample_images.main([
        "--output_dir", str(ckpt_256), "--features_path",
        str(ckpt_256 / "features_clustered_001.npy"), "--synthetic",
        "--num_samples", "16", "--batch_size", "8", "--save_dir",
        str(tmp_path)])
    assert _cuda.LAUNCHES["stem_tc_banded"] == 2 == _cuda.LAUNCHES["stem"]
    assert results["num_images"] == 16
    assert all(np.isfinite(v) for v in results.values())
    img = decode_png((tmp_path / "img000000_pred.png").read_bytes())
    assert img.shape == (256, 256, 3)
