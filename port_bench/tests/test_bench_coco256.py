"""The cell ``coco256.serve_b16``: on the CPU, at ``tiny_config()``'s
widths and the cell's 256 px, a sound run is correct, the
``altered_answer`` fault is not, and the program's serving forward agrees
with the plain reference; on the card (``cuda``), at the cell's own size,
the fp8 control is not correct on three seeds, the fault is not correct
and a sound short run is. Run on a card with
``python3 -m pytest -m cuda port_bench/tests/test_bench_coco256.py``."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import control, faults, run, serve
from port_bench.reference import scene_model as ref
from port_bench.tests.bench_cells import full_cell, tiny_cell
from port_bench.tests.test_bench_cuda import SEEDS, card, outcome

CELL = "coco256.serve_b16"
CPU = torch.device("cpu")


def small_cell():
    """The cell's traffic and limits on ``tiny_config()`` at 256 px."""
    cell = tiny_cell(CELL)
    for section in ("data", "model"):
        cell.config[section]["image_size"] = [256, 256]
    return cell


def test_cell_is_the_128_px_cell_at_256_px():
    c256, c128 = full_cell(CELL), full_cell("coco128.serve_b16")
    assert c256.traffic == c128.traffic
    for section in ("data", "model"):
        assert c256.config[section]["image_size"] == [256, 256]
        assert {k: v for k, v in c256.config[section].items()
                if k != "image_size"} == {
            k: v for k, v in c128.config[section].items()
            if k != "image_size"}
    assert c256.config["serve_compute_dtype"] == "bfloat16"


def test_sound_run_is_correct_and_altered_answer_is_not():
    cell = small_cell()
    program = run.program_entries()
    for prog, want in ((program, True),
                       (faults.planted("altered_answer", program), False)):
        res = run.execute(cell, 9, 0.5, False, CPU, prog, 0.0,
                          readings=True)
        assert set(cell.limits["numbers"]) <= set(res["readings"])
        assert res["correct"] is want


def test_serving_forward_matches_the_reference():
    from scene_generation_tpu_torch.api import InferenceModel
    from scene_generation_tpu_torch.config import Config
    from scene_generation_tpu_torch.models import SceneModel
    cell = small_cell()
    mc = serve.model_config(cell.config)
    pc = Config.from_json(json.dumps(dict(cell.config, model=mc)))
    model = SceneModel(pc.model).eval()
    pool, feats = serve.draw_traffic(cell.config, cell.traffic, 3)
    probe = serve.ref_inputs(pool[0], feats[0],
                             torch.zeros(mc["mask_noise_dim"]), "cpu")
    P = serve.make_weights(model, mc, probe, 3, "cpu", torch.float32)
    im = InferenceModel(pc, {}, model)
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
            _, r["empty"] = ref.images_on(P, mc, r["vecs"], r["boxes"],
                                          r["masks"], inp["obj_mask"],
                                          torch.float32)
        assert not all(r["empty"])
        gaps = serve.compare_serve(out.imgs_pred, out.boxes_pred,
                                   out.masks_pred, r, inp["obj_mask"])
        assert out.imgs_pred.shape[1:3] == (256, 256)
        assert gaps.pop("_nonfinite") == 0
        assert all(v < 1e-4 for v in gaps.values()), gaps


@pytest.mark.cuda
def test_control_is_not_correct():
    device = card()
    cell = full_cell(CELL)
    c, prog = control.control_cell(cell, run.program_entries())
    for seed in SEEDS:
        assert not outcome(c, prog, seed, device), seed


@pytest.mark.cuda
def test_fault_is_not_correct():
    device = card()
    cell = full_cell(CELL)
    program = run.program_entries()
    assert outcome(cell, program, SEEDS[0], device)
    assert not outcome(cell, faults.planted("altered_answer", program),
                       SEEDS[0], device)
