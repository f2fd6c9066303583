"""The frozen plain reference agrees with the program's plain path at the
program's ``tiny_config()`` on the CPU: the serving forward, the test-mode
claims in bf16, and one train step (discriminators in f32)."""
from __future__ import annotations

import json

import pytest
import torch

from port_bench import serve, train
from port_bench.reference import scene_model as ref
from port_bench.tests.bench_cells import tiny_cell


def tiny_model(dtype=torch.float32, seed=3):
    from scene_generation_tpu_torch.config import Config
    from scene_generation_tpu_torch.models import SceneModel
    cell = tiny_cell("coco128.serve_b16")
    mc = serve.model_config(cell.config)
    pc = Config.from_json(json.dumps(dict(cell.config, model=mc)))
    model = SceneModel(pc.model).to(dtype).eval()
    pool, feats = serve.draw_traffic(cell.config, cell.traffic, seed)
    probe = serve.ref_inputs(pool[0], feats[0],
                             torch.zeros(mc["mask_noise_dim"]), "cpu")
    P = serve.make_weights(model, mc, probe, seed, "cpu", dtype)
    return model, mc, pool, feats, P


def test_serving_forward_matches_the_program():
    from scene_generation_tpu_torch.api import InferenceModel
    model, mc, pool, feats, P = tiny_model()
    im = InferenceModel(None, {}, model)
    im.cfg = type("C", (), {"model": model.cfg})
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
        valid = inp["obj_mask"] > 0
        assert (out.boxes_pred - r["boxes"]).abs()[valid].max() < 1e-5
        assert (out.masks_pred - r["masks"]).abs()[valid].max() < 1e-5
        nonempty = [k for k in range(r["imgs"].shape[0])
                    if float(ref.layout(r["boxes"], r["masks"], r["vecs"],
                                        inp["obj_mask"], *mc["image_size"])
                             [k].abs().max()) > 0]
        assert nonempty
        assert (out.imgs_pred - r["imgs"])[nonempty].abs().max() < 1e-4


def test_claims_in_bf16_are_the_programs():
    from scene_generation_tpu_torch.ops.layout import masks_to_layout_weights
    gen = torch.Generator().manual_seed(0)
    n, o, m = 3, 5, 8
    boxes = torch.rand(n, o, 2, generator=gen) * 0.5
    boxes = torch.cat([boxes, boxes + 0.2 + 0.3 * torch.rand(
        n, o, 2, generator=gen)], -1).to(torch.bfloat16).float()
    masks = torch.rand(n, o, m, m, generator=gen)
    vecs = torch.rand(n, o, 6, generator=gen)
    obj_mask = (torch.rand(n, o, generator=gen) > 0.2).float()
    want = masks_to_layout_weights(
        vecs.bfloat16(), boxes.bfloat16(), masks.bfloat16(), obj_mask, 32,
        32, test_mode=True) > 0
    sampled, got = ref.claims(boxes, masks, vecs, obj_mask, 32, 32,
                              torch.bfloat16)
    assert torch.equal(got, want)
    assert int(got.sum()) > 0


def test_train_step_matches_the_program():
    cell = tiny_cell("coco128.train_b12")
    from port_bench import run
    program = run.program_entries()
    pc, modules, trees, plan = train.build(cell, 11, torch.device("cpu"),
                                           program)
    state = program.TrainState(pc, *modules, device=torch.device("cpu"))
    pool, order, use_gt, noise, base = plan
    metrics = program.train_step(state, program.Batch(*pool[order[0]]),
                                 program.Draws(*(torch.as_tensor(t[0])
                                                 for t in (use_gt, noise,
                                                           base))))
    b1 = cell.config["train"]["beta1"]
    grads = train.leaf_norms(state, lambda n, k, p, st: st["mu"].norm()
                             / (1 - b1))
    losses, ref_grads, _ = train.reference_steps(cell.config, trees, plan, 1,
                                                 torch.device("cpu"))
    for k, v in losses[0].items():
        assert float(metrics[k]) == pytest.approx(v, rel=1e-4, abs=1e-6), k
    # Leaf by leaf, by the harness's own measure (leaves whose gradient
    # is nought to rounding left out).
    gaps = train.leaf_gaps(grads, ref_grads, ref_grads)
    assert max(v[-1][0] for v in gaps.values()) < 1e-4
