"""Training CLI of the port (the JAX package's ``train.py``, flag for flag;
reference ``train.py:166-231``).

    python -m scene_generation_tpu_torch.train --synthetic --num_iterations 100
    python -m scene_generation_tpu_torch.train --synthetic --tiny --cpu \\
        --num_iterations 4 --checkpoint_every 2 --print_every 1
    ... --restore_from_checkpoint 1 --num_iterations 6     (resume)

Flow: datasets and loaders -> train state, restored from
``<output_dir>/<checkpoint_name>`` with ``--restore_from_checkpoint 1`` ->
the adversarial step over one data stream spanning every epoch -> loss
lines (and the NaN gate) every ``--print_every`` steps -> every
``--checkpoint_every`` steps the val-gt and val-sg sweeps, best
promotion and an asynchronous checkpoint -> a checkpoint on SIGTERM /
SIGINT and at the end.

It runs on the card unless ``--cpu`` (or ``--device cpu``) is given, on
``--coco_dir`` (instances + stuff, or ``--is_panoptic 1``; process
workers) or ``--synthetic`` data (thread workers). ``--scan_blocks`` (a
JAX compile strategy) is accepted at 0.

    torchrun --nproc_per_node N -m scene_generation_tpu_torch.train \
        --distributed --coco_dir <coco> ...

runs data parallel (``parallel/data_parallel.py``): each rank loads its
1/N slice of every global batch and the step is the global batch's;
NCCL when every rank has a card of its own, gloo otherwise; rank 0 alone
writes ``args.json``, TensorBoard and checkpoints, every rank restores,
and the printed losses, the val sweeps, the NaN gate and the SIGTERM stop
are agreed across ranks.

The data stream is the JAX CLI's: epoch ``e``'s order is
``default_rng((seed, e))`` over the dataset, so both CLIs train on the
same batches. A resume continues the stream after the last
batch the checkpoint consumed (meta ``counters["batch"]``); a checkpoint
without that counter (one exported from JAX) starts the next epoch, as
the JAX CLI does.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch

from scene_generation_tpu_torch import resolve_device
from scene_generation_tpu_torch.config import (Config, DataConfig, LossConfig,
                                               ModelConfig, TrainConfig,
                                               tiny_config)
from scene_generation_tpu_torch.data.coco import coco_split
from scene_generation_tpu_torch.data.loader import DataLoader, device_prefetch
from scene_generation_tpu_torch.data.synthetic import SyntheticDataset
from scene_generation_tpu_torch.parallel import data_parallel
from scene_generation_tpu_torch.trainer.checkpoint import CheckpointManager
from scene_generation_tpu_torch.trainer.evaluation import check_model
from scene_generation_tpu_torch.trainer.step import train_step
from scene_generation_tpu_torch.trainer.train_state import create_train_state

PRESETS = ["parity", "quality", "throughput"]


def parse_args(argv=None) -> argparse.Namespace:
    # --preset rewires flag DEFAULTS only (two-stage parse): any flag given
    # explicitly on the command line still wins.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--preset", choices=PRESETS, default="parity")
    preset = pre.parse_known_args(argv)[0].preset

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--preset", choices=PRESETS, default="parity",
                   help="'parity' (default): the reference's flag defaults. "
                        "'quality': box_net_final=none, box_loss_gated=0, "
                        "compute_dtype=bfloat16, synthetic_size=4096, bf16 "
                        "Adam mu. 'throughput': quality at batch 24 with "
                        "the learning rates scaled by sqrt(2). Explicit "
                        "flags override the preset.")
    # Optimization (args.py:13-16). None = the config's (12 full / 4 tiny).
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--num_iterations", type=int, default=1_000_000)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--mask_learning_rate", type=float, default=1e-5)
    # Dataset (args.py:18-47).
    p.add_argument("--image_size", type=str, default="128,128")
    p.add_argument("--num_train_samples", type=int, default=None)
    p.add_argument("--num_val_samples", type=int, default=1024)
    p.add_argument("--coco_dir", type=str, default="datasets/coco")
    p.add_argument("--synthetic", action="store_true",
                   help="procedural dataset instead of --coco_dir")
    p.add_argument("--is_panoptic", type=int, default=0)
    p.add_argument("--synthetic_size", type=int, default=512)
    p.add_argument("--tiny", action="store_true",
                   help="tiny architecture (CI/smoke)")
    # Generator (args.py:49-68).
    p.add_argument("--mask_size", type=int, default=32)
    p.add_argument("--embedding_dim", type=int, default=128)
    p.add_argument("--gconv_dim", type=int, default=128)
    p.add_argument("--gconv_num_layers", type=int, default=5)
    p.add_argument("--n_downsample_global", type=int, default=4)
    p.add_argument("--use_attributes", type=int, default=1)
    p.add_argument("--compute_dtype",
                   choices=["float32", "bfloat16", "float16"],
                   default="float32",
                   help="the generator's compute dtype (torch.autocast; "
                        "parameters and optimizer math stay f32); the "
                        "discriminators and VGG use DiscriminatorConfig's")
    p.add_argument("--layout_embed_dim", type=int, default=0)
    p.add_argument("--box_net_final", choices=["relu", "none"],
                   default="relu")
    p.add_argument("--scan_blocks", type=int, default=0,
                   help="JAX compile strategy; only 0 here")
    p.add_argument("--torch_deconv", type=int, default=0)
    # Loss weights (args.py:70-79).
    p.add_argument("--box_loss_gated", type=int, default=1)
    p.add_argument("--l1_pixel_loss_weight", type=float, default=0.0)
    p.add_argument("--bbox_pred_loss_weight", type=float, default=10.0)
    p.add_argument("--vgg_features_weight", type=float, default=10.0)
    p.add_argument("--d_img_weight", type=float, default=1.0)
    p.add_argument("--d_img_features_weight", type=float, default=10.0)
    p.add_argument("--d_mask_weight", type=float, default=1.0)
    p.add_argument("--d_mask_features_weight", type=float, default=10.0)
    p.add_argument("--d_obj_weight", type=float, default=0.1)
    p.add_argument("--ac_loss_weight", type=float, default=0.1)
    p.add_argument("--gan_loss_type", type=str, default="gan")
    # Output (args.py:102-109).
    p.add_argument("--print_every", type=int, default=100)
    p.add_argument("--checkpoint_every", type=int, default=10000)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--checkpoint_name", type=str, default="checkpoint")
    p.add_argument("--restore_from_checkpoint", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--adam_mu_dtype", choices=["", "bfloat16"], default="",
                   help="Adam first-moment storage dtype; '' = f32")
    p.add_argument("--adam_nu_dtype", choices=["", "float16", "bfloat16"],
                   default="",
                   help="Adam second-moment storage dtype; '' = f32. "
                        "bfloat16 freezes nu at b2=0.999; float16 "
                        "underflows for sustained |g| < ~2e-4")
    p.add_argument("--grads_dtype", choices=["", "bfloat16"], default="",
                   help="gradient dtype at the backward-to-optimizer "
                        "boundary; '' = f32")
    p.add_argument("--timing", action="store_true",
                   help="print the wall ms/step over each print window")
    # A torch.profiler trace of steps [profile_start, +profile_steps).
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--profile_start", type=int, default=10)
    p.add_argument("--profile_steps", type=int, default=5)
    p.add_argument("--distributed", action="store_true")
    # The reference runs a check_model before training (train.py:178-184).
    p.add_argument("--initial_eval", type=int, default=0)
    # Inception score in check_model (random-init InceptionV3 unless
    # torchvision weights are found; models/inception.py).
    p.add_argument("--eval_inception", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--device", type=str, default=None,
                   help="'cuda' (default) or 'cpu'")
    if preset in ("quality", "throughput"):
        p.set_defaults(box_net_final="none", box_loss_gated=0,
                       compute_dtype="bfloat16", synthetic_size=4096,
                       adam_mu_dtype="bfloat16")
    if preset == "throughput":
        p.set_defaults(batch_size=24, learning_rate=1.41e-4,
                       mask_learning_rate=1.41e-5)
    return p.parse_args(argv)


def _train_config(a: argparse.Namespace, base: TrainConfig) -> TrainConfig:
    return dataclasses.replace(
        base, num_iterations=a.num_iterations,
        learning_rate=a.learning_rate,
        mask_learning_rate=a.mask_learning_rate,
        print_every=a.print_every, checkpoint_every=a.checkpoint_every,
        output_dir=a.output_dir, checkpoint_name=a.checkpoint_name,
        restore_from_checkpoint=bool(a.restore_from_checkpoint),
        seed=a.seed, adam_mu_dtype=a.adam_mu_dtype,
        adam_nu_dtype=a.adam_nu_dtype, grads_dtype=a.grads_dtype)


def config_from_args(a: argparse.Namespace) -> Config:
    """The JAX CLI's ``config_from_args`` (its ``scan_blocks`` is not a
    field here)."""
    if a.tiny:
        cfg = tiny_config()
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model,
                                      compute_dtype=a.compute_dtype,
                                      layout_embed_dim=a.layout_embed_dim,
                                      box_net_final=a.box_net_final,
                                      torch_deconv=bool(a.torch_deconv)),
            loss=dataclasses.replace(cfg.loss,
                                     box_loss_gated=bool(a.box_loss_gated)))
        if a.batch_size is not None:
            cfg = cfg.replace(data=dataclasses.replace(
                cfg.data, batch_size=a.batch_size))
        return cfg.replace(train=_train_config(a, cfg.train))
    size = tuple(int(x) for x in a.image_size.split(","))
    return Config(
        data=DataConfig(image_size=size, mask_size=a.mask_size,
                        batch_size=12 if a.batch_size is None
                        else a.batch_size,
                        num_train_samples=a.num_train_samples,
                        num_val_samples=a.num_val_samples,
                        coco_dir=a.coco_dir),
        model=ModelConfig(image_size=size, mask_size=a.mask_size,
                          embedding_dim=a.embedding_dim,
                          gconv_dim=a.gconv_dim,
                          gconv_num_layers=a.gconv_num_layers,
                          n_downsample_global=a.n_downsample_global,
                          use_attributes=bool(a.use_attributes),
                          compute_dtype=a.compute_dtype,
                          layout_embed_dim=a.layout_embed_dim,
                          box_net_final=a.box_net_final,
                          torch_deconv=bool(a.torch_deconv)),
        loss=LossConfig(
            l1_pixel_loss_weight=a.l1_pixel_loss_weight,
            bbox_pred_loss_weight=a.bbox_pred_loss_weight,
            vgg_features_weight=a.vgg_features_weight,
            d_img_weight=a.d_img_weight,
            d_img_features_weight=a.d_img_features_weight,
            d_mask_weight=a.d_mask_weight,
            d_mask_features_weight=a.d_mask_features_weight,
            d_obj_weight=a.d_obj_weight, ac_loss_weight=a.ac_loss_weight,
            box_loss_gated=bool(a.box_loss_gated)),
        train=_train_config(a, TrainConfig()))


def check_supported(a: argparse.Namespace) -> None:
    if a.scan_blocks:
        raise NotImplementedError(
            "--scan_blocks 1 is a JAX compile strategy (nn.scan over the "
            "generator's blocks); the port runs them unrolled")


def coco_datasets(cfg: Config, coco_dir: str, panoptic: bool):
    """(train, val) COCO datasets of ``coco_dir`` in the layout of a COCO
    download, filtered by ``cfg.data`` (the JAX CLI's ``build_datasets``,
    train.py:274-323); their class mappings must agree."""
    d = cfg.data
    common = dict(image_size=d.image_size, mask_size=d.mask_size,
                  min_object_size=d.min_object_size,
                  min_objects_per_image=d.min_objects_per_image,
                  max_objects_per_image=d.max_objects_per_image,
                  instance_whitelist=d.instance_whitelist,
                  stuff_whitelist=d.stuff_whitelist,
                  include_other=d.include_other, seed=cfg.train.seed)
    train = coco_split(coco_dir, "train", panoptic,
                       max_samples=d.num_train_samples, **common)
    val = coco_split(coco_dir, "val", panoptic,
                     max_samples=d.num_val_samples, **common)
    if train.vocab["object_to_idx"] != val.vocab["object_to_idx"]:
        raise ValueError(f"{coco_dir}: the train and val splits observe "
                         "different classes")
    return train, val


def build_datasets(cfg: Config, a: argparse.Namespace):
    if a.synthetic:
        train = SyntheticDataset(cfg, size=a.synthetic_size,
                                 seed=cfg.train.seed)
        val = SyntheticDataset(cfg, size=max(8, a.synthetic_size // 8),
                               seed=cfg.train.seed + 1)
    else:
        train, val = coco_datasets(cfg, a.coco_dir, bool(a.is_panoptic))
    return train.vocab, train, val


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _scalars(metrics, comm: data_parallel.Collectives) -> dict:
    """Every logged scalar in one device-to-host transfer. Under data
    parallelism the ranks' loss shares are summed first (one all-reduce),
    so every rank logs, and gates on, the global losses."""
    keys = [k for k in metrics if not k.startswith("_")]
    vals = torch.stack([metrics[k].detach().float().reshape(())
                        for k in keys])
    shares = torch.tensor([k != "use_gt" for k in keys], device=vals.device)
    vals = torch.where(shares, comm.all_reduce_(vals.clone()), vals)
    return dict(zip(keys, vals.tolist()))


def _write_images(writer, batch, metrics, cfg: Config, index: int) -> None:
    """Image panels (reference write_images, trainer.py:370-392), CHW."""
    from scene_generation_tpu_torch.data.image_utils import deprocess
    from scene_generation_tpu_torch.vis import one_hot_to_rgb_compact
    real = deprocess(_host(batch.imgs[0]))
    pred = deprocess(_host(metrics["_imgs_pred"][0]))
    writer.add_image("img/real", real.transpose(2, 0, 1), index)
    writer.add_image("img/pred", pred.transpose(2, 0, 1), index)
    if cfg.model.layout_embed_dim == 0:
        # With a learned layout embedding the leading channels are not
        # class one-hots, so the layout panels are skipped.
        for tag, key in (("img/layout", "_layout_one_hot"),
                         ("img/layout_pred", "_layout_pred_one_hot")):
            lay = one_hot_to_rgb_compact(metrics[key][:1])[0]
            writer.add_image(tag, lay.transpose(2, 0, 1), index)


def main(argv=None, on_step: Optional[Callable] = None):
    """Train; returns ``(state, meta)``. ``on_step(t, batch, metrics)``, if
    given, runs after each step."""
    a = parse_args(argv)
    check_supported(a)
    device = "cpu" if a.cpu else a.device
    if not a.distributed:
        return _train(a, resolve_device(device), data_parallel.SINGLE,
                      on_step)
    comm, dev = data_parallel.init_process_group(device)
    try:
        return _train(a, dev, comm, on_step)
    finally:
        torch.distributed.destroy_process_group()


def _train(a: argparse.Namespace, dev: torch.device,
           comm: data_parallel.Collectives,
           on_step: Optional[Callable]):
    # One writer of record: args.json, TensorBoard and checkpoints come
    # from rank 0, whose replica every rank shares.
    rank, world = comm.rank, comm.world_size
    primary = rank == 0
    cfg = config_from_args(a)
    if cfg.data.batch_size % world:
        raise ValueError(f"--batch_size {cfg.data.batch_size} must be "
                         f"divisible by the {world} ranks")
    vocab, train_dset, val_dset = build_datasets(cfg, a)
    num_objs = len(vocab["object_to_idx"])
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, num_objs=num_objs))
    print(f"dataset: {len(train_dset)} train / {len(val_dset)} val images, "
          f"{num_objs} classes")

    os.makedirs(cfg.train.output_dir, exist_ok=True)
    writer = None
    if primary:
        with open(os.path.join(cfg.train.output_dir, "args.json"), "w") as f:
            json.dump(vars(a), f)
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(cfg.train.output_dir)
        except Exception:
            pass

    # Process workers for COCO (image decode and mask rasterization compete
    # with the training loop for the GIL; the reference uses 4 worker
    # processes, train.py:71-77); synthetic generation is cheap numpy, and
    # threads avoid the spawn and pickle overhead. Each rank computes the
    # same global order and loads its 1/world slice of every batch.
    dl_kwargs = dict(batch_size=cfg.data.batch_size,
                     max_objs=cfg.data.max_objs,
                     max_triples=cfg.data.max_triples, num_workers=4,
                     worker_type="thread" if a.synthetic else "process",
                     process_count=world, process_index=rank)
    train_loader = DataLoader(train_dset, shuffle=True,
                              seed=cfg.train.seed, **dl_kwargs)
    val_loader = DataLoader(val_dset, shuffle=cfg.data.shuffle_val,
                            seed=cfg.train.seed + 1, **dl_kwargs)
    if len(train_loader) == 0:
        raise ValueError(f"{len(train_dset)} training images make no batch "
                         f"of {cfg.data.batch_size}")

    state = create_train_state(cfg, dev, seed=cfg.train.seed, comm=comm)
    ckpt = CheckpointManager(cfg.train.output_dir, cfg.train.checkpoint_name,
                             writer=primary)
    meta = None
    if cfg.train.restore_from_checkpoint and ckpt.has_checkpoint():
        meta = ckpt.load_meta()
        state = ckpt.restore(state)
        print(f"restored checkpoint at t={meta['counters']['t']}")
    if meta is None:
        meta = ckpt.new_meta(cfg, vocab)
    data_parallel.verify_replicated(comm, state)
    t = meta["counters"]["t"]
    epoch = meta["counters"]["epoch"]
    consumed = meta["counters"].get("batch", 0)

    probs_fn = None
    inception_real = False
    if a.eval_inception:
        from scene_generation_tpu_torch.models.inception import (
            create_inception_probs_fn)
        probs_fn, loaded = create_inception_probs_fn(dev)
        inception_real = bool(loaded)
        if not loaded:
            print("WARNING: no InceptionV3 weights found; IS values are "
                  "relative-only (random-init classifier)")

    # Preemption: checkpoint on SIGTERM / SIGINT and exit cleanly;
    # --restore_from_checkpoint 1 resumes.
    stop_requested = {"flag": False}

    def _on_term(signum, frame):
        stop_requested["flag"] = True

    handlers = {s: signal.signal(s, _on_term)
                for s in (signal.SIGTERM, signal.SIGINT)}

    def val_sweep(use_gt: bool):
        return check_model(state.model, val_loader, use_gt=use_gt,
                           num_samples=cfg.data.num_val_samples,
                           probs_fn=probs_fn, comm=comm)

    if a.initial_eval:
        tr = val_sweep(use_gt=True)
        print(f"initial: val-gt iou {tr[0]:.4f} inception {tr[1]:.4f}")
        if writer:
            writer.add_scalar("checkpoint/val_gt_iou", tr[0], 0)
            writer.add_scalar("checkpoint/val_gt_inception_mean", tr[1], 0)

    print(f"training on {dev}" + ("" if world == 1 else
                                  f" (rank {rank} of {world}, "
                                  f"{comm.backend})")
          + f"; {cfg.train.num_iterations} iterations")

    t_start = time.time()
    timing_anchor = None  # (step, wall) of the previous print (--timing)
    prof = None

    # ONE stream spanning every epoch. Each epoch's order is a pure
    # function of (seed, epoch); epoch_q says which (epoch, batch) each
    # CONSUMED batch is (the prefetcher runs ahead of consumption, so a
    # plain variable would drift around epoch boundaries).
    epoch_q = collections.deque()

    def epoch_stream(e, skip):
        while True:
            train_loader.set_epoch(e, skip)
            for k, b in enumerate(train_loader, start=skip + 1):
                epoch_q.append((e, k))
                yield b
            e, skip = e + 1, 0

    if 0 < consumed < len(train_loader):     # resume mid-epoch
        stream = epoch_stream(epoch, consumed)
    else:
        stream = epoch_stream(epoch + 1, 0)
    prefetched = device_prefetch(stream, dev)
    try:
        for batch in prefetched:
            # Every rank stops at the same step (agreed on the host).
            stop = data_parallel.any_rank(comm, stop_requested["flag"])
            if t >= cfg.train.num_iterations or stop:
                break
            t += 1
            epoch, consumed = epoch_q.popleft()
            if a.profile_dir and t == a.profile_start:
                from torch.profiler import ProfilerActivity, profile
                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = profile(activities=acts)
                prof.start()
            metrics = train_step(state, batch)
            if on_step is not None:
                on_step(t, batch, metrics)
            if prof is not None and t == a.profile_start + a.profile_steps:
                prof.stop()
                os.makedirs(a.profile_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(a.profile_dir, "trace.json"))
                prof = None
                print(f"profiler trace written to {a.profile_dir}")

            if t % cfg.train.print_every == 0 or t == 1:
                index = t // cfg.train.print_every
                scalars = _scalars(metrics, comm)
                # NaN gate, on the print's readback (no extra sync): the
                # last good checkpoint is left alone, the poisoned state
                # is saved under <name>_nan_abort.
                bad = [k for k, v in scalars.items() if not math.isfinite(v)]
                if bad:
                    print(f"FATAL: non-finite losses at t={t}: {bad}")
                    nan_ckpt = CheckpointManager(
                        cfg.train.output_dir,
                        cfg.train.checkpoint_name + "_nan_abort",
                        writer=primary)
                    nan_meta = dict(meta)
                    nan_meta["counters"] = {"t": t, "epoch": epoch,
                                            "batch": consumed}
                    nan_meta["nan_abort"] = {"t": t, "keys": bad}
                    nan_ckpt.save(state, best=False)
                    nan_ckpt.save_meta(nan_meta)
                    nan_ckpt.close()
                    raise FloatingPointError(
                        f"non-finite losses at t={t}: {bad}; last good "
                        f"checkpoint preserved, poisoned state saved as "
                        f"{cfg.train.checkpoint_name}_nan_abort")
                now = time.time()
                rate = t / (now - t_start)
                print(f"t = {t} / {cfg.train.num_iterations} "
                      f"({rate:.2f} it/s)", flush=True)
                # --timing: wall ms/step over the window since the previous
                # print (loader, copy and compute; the readback above
                # drains the queue). The t=1 window is skipped.
                coll_s = comm.seconds
                if a.timing and t > 1 and timing_anchor is not None:
                    at, atime, acoll = timing_anchor
                    win = (now - atime) / (t - at)
                    print(f"  [timing] {win * 1e3:.1f} ms/step sustained "
                          f"over steps {at + 1}..{t}", flush=True)
                    if world > 1:
                        coll = (coll_s - acoll) / (t - at)
                        print(f"  [timing] {coll * 1e3:.1f} ms/step in "
                              f"collectives ({comm.backend})", flush=True)
                timing_anchor = (t, now, coll_s)
                for name, val in sorted(scalars.items()):
                    print(f"  [{name}]: {val:.4f}")
                    meta["losses"].setdefault(name, []).append(val)
                    if writer:
                        writer.add_scalar(f"g_loss/{name}", val, index)
                meta["losses_ts"].append(t)
                if writer:
                    _write_images(writer, batch, metrics, cfg, index)

            if t % cfg.train.checkpoint_every == 0:
                # Both sweeps run on the val loader, as the reference's do
                # (train.py:224-226); the rows are named for what they
                # are: val-gt (GT layout + attributes), val-sg (scene
                # graph only).
                print("checking on val (gt-layout + scene-graph-only)")
                tr, va = val_sweep(use_gt=True), val_sweep(use_gt=False)
                print(f"val-gt iou: {tr[0]:.4f}  val-sg iou: {va[0]:.4f}")
                meta["checkpoint_ts"].append(t)
                meta.setdefault("val_gt_inception", []).append(tr[1])
                meta.setdefault("val_gt_iou", []).append(tr[0])
                meta["counters"] = {"t": t, "epoch": epoch,
                                    "batch": consumed}
                # Best on val-sg inception with real Inception weights
                # (the reference's rule, trainer.py:188-197), else on
                # val-sg IoU: without weights the score is noise.
                if inception_real:
                    is_best = ckpt.maybe_promote_best(
                        meta, state, va[1], metric="val_inception")
                else:
                    is_best = ckpt.maybe_promote_best(
                        meta, state, va[0], metric="val_sg_iou")
                ckpt.save(state, best=False)
                ckpt.save_meta(meta)
                if writer:
                    writer.add_scalar("checkpoint/val_gt_iou", tr[0], t)
                    writer.add_scalar("checkpoint/val_sg_iou", va[0], t)
                print(f"saved checkpoint (best={is_best})")
    finally:
        prefetched.close()
        stream.close()
        train_loader.close()
        val_loader.close()
        for s, h in handlers.items():
            signal.signal(s, h)
        if prof is not None:
            prof.stop()

    meta["counters"] = {"t": t, "epoch": epoch, "batch": consumed}
    ckpt.save(state, best=False)
    ckpt.save_meta(meta)
    ckpt.close()  # the writes land before this returns
    if writer:
        writer.close()
    if stop_requested["flag"]:
        print(f"preempted: checkpointed at t={t}; resume with "
              f"--restore_from_checkpoint 1")
    else:
        print(f"done: {t} iterations in {time.time() - t_start:.1f}s")
    return state, meta


if __name__ == "__main__":
    main()
