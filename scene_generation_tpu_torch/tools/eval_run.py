"""One-command post-training evaluation (port of the JAX package's
``scripts/eval_run.py``): the protocol of RESULTS.md on a finished run.

    python -m scene_generation_tpu_torch.tools.eval_run --output_dir <run> \\
        --synthetic [--num_samples 512] [--accuracy_model_path f.pt] [--cpu]

  1. encode_features   -> per-class appearance clusters (k = 100 / 10 / 1)
  2. sample_images     -> GT-layout / GT-attribute / scene-graph-only modes
                          with the k = 1 table (IoU, recall, PNGs)
  3. compute_fid       -> real vs generated, GT-layout and scene-graph modes
  4. compute_diversity -> LPIPS between two k = 100 appearance draws
  4b. sample_images with --accuracy_model_path -> object accuracy
  5. grids and curves  -> ``scripts/make_grid.py`` and
                          ``scripts/plot_training.py`` (PIL / matplotlib;
                          skipped, and said so, where those are missing)

Each stage is skipped when its outputs exist (delete them to redo); the
stages run one after another in this process, on the card unless
``--cpu``. Each stage's batch is capped at its sample count, and the
loaders keep their last partial batch, so every requested sample is
generated (the JAX script could drop all of them).
"""
from __future__ import annotations

import argparse
import glob
import importlib.util
import json
import os
import shutil
import subprocess
import sys

from scene_generation_tpu_torch.tools import (compute_diversity, compute_fid,
                                              encode_features, sample_images)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODES = {"gtlayout": ["--use_gt_boxes", "1", "--use_gt_masks", "1"],
         "gtattr": ["--use_gt_attr", "1"],
         "sg": []}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--output_dir", required=True)
    p.add_argument("--checkpoint_name", default="checkpoint")
    p.add_argument("--log", default=None,
                   help="training log for the curves panel")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--coco_dir", default="datasets/coco")
    p.add_argument("--test_part", type=int, default=1,
                   help="COCO only: passed to sampling and diversity")
    p.add_argument("--num_samples", type=int, default=512)
    p.add_argument("--encode_samples", type=int, default=512)
    p.add_argument("--diversity_samples", type=int, default=32)
    p.add_argument("--stage_batch_size", type=int, default=64)
    p.add_argument("--skip_diversity", action="store_true")
    p.add_argument("--accuracy_model_path", default=None,
                   help="accuracy-net file (train_accuracy_net); adds the "
                        "object-accuracy stage")
    p.add_argument("--accuracy_tiny", type=int, default=1)
    p.add_argument("--cpu", action="store_true",
                   help="run every stage on the CPU")
    p.add_argument("--seed", type=int, default=0,
                   help="forwarded to every sampling stage (dataset draw)")
    p.add_argument("--save_root", default=None,
                   help="write all stage outputs here instead of into "
                        "--output_dir (the checkpoint is still read from "
                        "--output_dir)")
    return p.parse_args(argv)


def _stage(tool, args) -> None:
    print("+ " + tool.__name__.rsplit(".", 1)[1] + " " + " ".join(args),
          flush=True)
    tool.main(args)


def _script(name: str, needs: str, args) -> None:
    """A repo script that imports neither package, in a subprocess; said
    and skipped where the library it needs is not installed."""
    if importlib.util.find_spec(needs) is None:
        print(f"skipped scripts/{name}: it needs {needs}", flush=True)
        return
    cmd = [sys.executable, os.path.join("scripts", name)] + args
    print("+ " + " ".join(cmd), flush=True)
    subprocess.run(cmd, check=True, cwd=REPO)


def _copy_matching(src: str, dst: str, suffix: str) -> None:
    os.makedirs(dst)
    for f in sorted(os.listdir(src)):
        if f.endswith(suffix):
            shutil.copy(os.path.join(src, f), dst)


def main(argv=None) -> dict:
    a = parse_args(argv)
    ckpt = ["--output_dir", a.output_dir,
            "--checkpoint_name", a.checkpoint_name]
    out = a.save_root or a.output_dir
    os.makedirs(out, exist_ok=True)
    data = (["--synthetic"] if a.synthetic else ["--coco_dir", a.coco_dir])
    data += ["--seed", str(a.seed)] + (["--cpu"] if a.cpu else [])
    val = data + ([] if a.synthetic else ["--test_part", str(a.test_part)])

    def batch(n: int):
        return ["--batch_size", str(max(1, min(a.stage_batch_size, n)))]

    # 1. Appearance clusters (k = 100 / 10 / 1 tables).
    if not all(os.path.exists(os.path.join(
            out, f"features_clustered_{k}.npy")) for k in ("100", "001")):
        _stage(encode_features, ckpt + [
            "--num_samples", str(a.encode_samples), "--save_dir", out]
            + batch(a.encode_samples) + data)
    # The reference protocol samples with the k = 1 table (appearance the
    # class centre, deterministic); diversity needs variety: k = 100.
    feats = os.path.join(out, "features_clustered_001.npy")
    feats100 = os.path.join(out, "features_clustered_100.npy")

    # 2. Sampling modes (reference Figure-3 ablations).
    for name, flags in MODES.items():
        d = os.path.join(out, f"samples_{name}")
        if not os.path.exists(os.path.join(d, "results.json")):
            _stage(sample_images, ckpt + [
                "--features_path", feats, "--num_samples", str(a.num_samples),
                "--save_dir", d, "--save_layouts", "1"]
                + batch(a.num_samples) + flags + val)

    # 3. FID (the real images are the same in every mode).
    fid_real = os.path.join(out, "fid_real")
    if not os.path.isdir(fid_real):
        _copy_matching(os.path.join(out, "samples_gtattr"), fid_real,
                       "_gt.png")
    for name in ("gtlayout", "sg"):
        fake = os.path.join(out, f"fid_fake_{name}")
        if not os.path.isdir(fake):
            _copy_matching(os.path.join(out, f"samples_{name}"), fake,
                           "_pred.png")
        res = os.path.join(out, f"fid_{name}.json")
        if not os.path.exists(res):
            _stage(compute_fid, ["--real_dir", fid_real, "--fake_dir", fake,
                                 "--out_json", res]
                   + (["--cpu"] if a.cpu else []))

    # 4. Diversity.
    div = os.path.join(out, "diversity.json")
    if not a.skip_diversity and not os.path.exists(div):
        _stage(compute_diversity, ckpt + [
            "--features_path", feats100,
            "--num_samples", str(a.diversity_samples), "--out_json", div]
            + batch(a.diversity_samples) + val)

    # 4b. Object accuracy of generated crops (reference protocol #4).
    if a.accuracy_model_path:
        d = os.path.join(out, "samples_acc")
        if not os.path.exists(os.path.join(d, "results.json")):
            _stage(sample_images, ckpt + [
                "--features_path", feats, "--num_samples", str(a.num_samples),
                "--use_gt_attr", "1", "--use_gt_boxes", "1",
                "--accuracy_model_path", a.accuracy_model_path,
                "--accuracy_tiny", str(a.accuracy_tiny), "--save_dir", d,
                "--save_imgs", "0", "--save_layouts", "0"]
                + batch(a.num_samples) + val)

    # 5. Grids and curves.
    for name in ("gtlayout", "sg", "gtattr"):
        grid = os.path.join(out, f"grid_{name}.png")
        if not os.path.exists(grid):
            _script("make_grid.py", "PIL", [
                "--samples_dir", os.path.join(out, f"samples_{name}"),
                "--out", grid])
    curves = os.path.join(out, "curves.png")
    if not os.path.exists(curves):
        if a.log and os.path.exists(a.log):
            _script("plot_training.py", "matplotlib",
                    ["--log", a.log, "--out", curves])
        elif glob.glob(os.path.join(a.output_dir, "events.out.tfevents*")):
            _script("plot_training.py", "matplotlib",
                    ["--events", a.output_dir, "--out", curves])

    summary = {}
    acc_res = os.path.join(out, "samples_acc", "results.json")
    if os.path.exists(acc_res):
        with open(acc_res) as f:
            summary["object_accuracy"] = json.load(f).get("object_accuracy")
    for key, path in ([(f"samples_{m}", os.path.join(
            out, f"samples_{m}", "results.json")) for m in MODES]
            + [(f"fid_{m}", os.path.join(out, f"fid_{m}.json"))
               for m in ("gtlayout", "sg")] + [("diversity", div)]):
        if os.path.exists(path):
            with open(path) as f:
                summary[key] = json.load(f)
    print(json.dumps(summary, indent=1))
    with open(os.path.join(out, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
