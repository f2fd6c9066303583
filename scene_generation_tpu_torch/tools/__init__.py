"""The inference and evaluation tools of the JAX package's ``scripts/``,
ported: each runs as ``python -m scene_generation_tpu_torch.tools.<name>``
with the JAX script's name and flags, on the card unless ``--cpu`` is
given.

    encode_features       the appearance dictionary (features_clustered_*)
    sample_images         Figure-3 sampling, box IoU / recall, accuracy
    train_accuracy_net    the ResNet object classifier of the accuracy metric
    compute_fid           FID between two PNG directories
    compute_diversity     LPIPS between two appearance draws of a scene
    create_attributes_file  per-class size / location histograms
    eval_run              all of the above, one stage after another
    gui_server            the interactive GUI's HTTP backend

The synthetic dataset (``--synthetic``) is the only one ported; COCO
waits for its readers (ROADMAP.md §1).
"""


def require_synthetic(a) -> None:
    """Raise for the COCO mode of a tool: its readers are not ported."""
    if not a.synthetic:
        raise NotImplementedError(
            f"--coco_dir {a.coco_dir}: COCO data is not ported yet "
            "(ROADMAP.md §1: the COCO readers); pass --synthetic")


def device_of(a):
    """``"cpu"`` with ``--cpu``, else None: the card, or an error without
    one (``resolve_device``)."""
    return "cpu" if a.cpu else None
