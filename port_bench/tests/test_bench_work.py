"""The frozen operation and byte counts against figures worked by hand."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from port_bench import scenes, work
from port_bench.peaks import bound
from port_bench.spec import ROOT

CFG = json.loads((ROOT / "port_bench/configs/coco128.json").read_text())
MC = CFG["model"]


def test_stem_bounds_at_b16():
    # 2 * 128 * 128 * 49 * 9 * 64 = 924.8 MFLOP an image; 16 images at
    # 989 TFLOP/s (bf16) and 495 (f32 counted once at the TF32 rate).
    assert work.stem_ops(MC, 9) == 2 * 128 * 128 * 49 * 9 * 64
    assert work.stem_bound_s(MC, 16, 9, "bfloat16") * 1e3 == pytest.approx(
        0.01496, abs=5e-6)
    assert work.stem_bound_s(MC, 16, 9, "float32") * 1e3 == pytest.approx(
        0.0299, abs=5e-5)


def test_generator_about_28_gflop_an_image():
    gen = work.generator_ops(MC)
    # 18 residual convolutions of 1024 channels at 8 x 8.
    assert gen["blocks"] == 18 * 2 * 1024 * 1024 * 9 * 64
    assert gen["blocks"] / 1e9 == pytest.approx(21.74, abs=0.01)
    total = sum(gen.values()) + work.stem_ops(MC, 9)
    assert total / 1e9 == pytest.approx(27.81, abs=0.01)


def test_served_image_counts_the_mask_head():
    parts = dict((n, ops) for n, ops, _ in
                 work.serve_parts(MC, 9, 16, "bfloat16"))
    # Five 3x3 convolutions of 192 channels at 2..32 px, 9 slots.
    assert parts["mask_head"] == pytest.approx(
        9 * (2 * 192 * 192 * 9 * (4 + 16 + 64 + 256 + 1024)
             + 2 * 192 * 1024), rel=1e-12)
    assert work.total_ops(work.serve_parts(MC, 9, 16, "bfloat16")) / 1e9 \
        == pytest.approx(36.2, abs=0.05)
    precisions = {p for _, _, p in work.serve_parts(MC, 9, 16, "float32")}
    assert precisions == {"f32", "tf32"}


def test_peaks_and_bound():
    assert bound(989e12, 0.0, "bf16") == (1.0, "operations")
    assert bound(0.0, 3.35e12, "f32") == (1.0, "bytes")


def test_crop_bound_of_a_step():
    # Four forwards (64 px appearance crops, three 32 px D_obj crops) and
    # one d_img backward, each bound by its bytes: 0.0130 ms a step at
    # batch 12 (PERF.md, crop kernels' bounds).
    b = scenes.batches(1, 1, 12, 128, 32, 172, 3, 8, 9, 16)[0]
    ms = work.crop_step_bound_s(CFG, torch.as_tensor(b.boxes)) * 1e3
    assert ms == pytest.approx(0.0130, abs=2e-4)


def test_train_step_parts():
    parts = work.train_parts(CFG, 12, 9, 16)
    names = [n for n, _, _ in parts]
    assert names == ["g_forward_backward", "g_products",
                     "wrong_texture_layout", "vgg", "d_obj", "d_mask",
                     "d_img"]
    assert work.vgg_ops(MC) / 1e9 == pytest.approx(11.83, abs=0.01)
    assert work.least_seconds(parts) * 1e3 == pytest.approx(4.16, abs=0.01)
    assert np.isfinite(work.total_ops(parts))
