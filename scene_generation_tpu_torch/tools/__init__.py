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

    make_fake_coco_dir    a fake COCO directory, as a COCO download lays out

Each tool reads ``--coco_dir`` (the JAX scripts' COCO datasets) or, with
``--synthetic``, the procedural dataset.
"""


def checkpoint_coco_dataset(model, a, split: str, mask_size=None,
                            sample_attributes: bool = False,
                            test_part: bool = False):
    """The ``split`` ("train" or "val") COCO dataset of ``a.coco_dir`` for a
    checkpoint: the panoptic family when its vocab says so (reference
    sample_images.py:179), filtered by its data config, at most
    ``a.num_samples`` images, and mapped onto its classes
    (``insert_pre_trained_vocab``); the JAX scripts' ``build_loader`` and
    ``build_coco_panoptic_dset`` (scripts/sample_images.py:68-110)."""
    from scene_generation_tpu_torch.data.coco import coco_split
    d = model.cfg.data
    dset = coco_split(
        a.coco_dir, split, bool(model.vocab.get("is_panoptic")),
        image_size=d.image_size,
        mask_size=d.mask_size if mask_size is None else mask_size,
        min_object_size=d.min_object_size,
        min_objects_per_image=d.min_objects_per_image,
        max_objects_per_image=d.max_objects_per_image,
        sample_attributes=sample_attributes, test_part=test_part,
        max_samples=a.num_samples, seed=a.seed)
    dset.insert_pre_trained_vocab(model.vocab["object_to_idx"])
    return dset


def device_of(a):
    """``"cpu"`` with ``--cpu``, else None: the card, or an error without
    one (``resolve_device``)."""
    return "cpu" if a.cpu else None
