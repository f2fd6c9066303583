"""The port's COCO readers (``data/coco.py``, ``coco_panoptic.py``,
``rle.py``, ``fake_coco.py``, ``image_utils``) against the JAX package's, on
the CPU, after ``tests/test_coco_data.py`` and ``tests/test_rle.py``:

- a fake COCO directory written by the JAX generator (JPEG) and one written
  by the port's (PNG, read without PIL) give the same vocabularies and
  bitwise the same ``Example``s in both packages, at epochs 0 and 1, for
  instances and panoptic;
- the port's generator writes the JAX generator's annotations and pixels;
- the native mask codec and its numpy oracle decode every segmentation of
  the fake annotations, and random compressed and uncompressed RLEs,
  bitwise as the JAX codec does; a failed build raises;
- the PIL-free PNG read and bilinear resize equal PIL's bitwise (480x360
  down to 128 and 64, and up from 48x36), and ``resize_mask`` the JAX
  ``resize_mask`` at both thresholds;
- a JPEG without PIL raises, naming the file and its format;
- the port's loader, with process and with thread workers, streams the
  JAX loader's batches for one epoch.
"""
import json
import os
import sys

import numpy as np
import PIL.Image
import pytest

from scene_generation_tpu.data import image_utils as jax_image_utils
from scene_generation_tpu.data import rle as jax_rle
from scene_generation_tpu.data.coco import \
    CocoSceneGraphDataset as JaxCocoDataset
from scene_generation_tpu.data.coco_panoptic import \
    CocoPanopticSceneGraphDataset as JaxPanopticDataset
from scene_generation_tpu.data.fake_coco import \
    make_fake_coco as jax_make_fake_coco
from scene_generation_tpu.data.loader import DataLoader as JaxDataLoader
from scene_generation_tpu_torch.data import image_utils, rle
from scene_generation_tpu_torch.data.coco import CocoSceneGraphDataset
from scene_generation_tpu_torch.data.coco_panoptic import \
    CocoPanopticSceneGraphDataset
from scene_generation_tpu_torch.data.fake_coco import make_fake_coco
from scene_generation_tpu_torch.data.loader import DataLoader

SIZE = (120, 90)        # on-disk W, H
INSTANCES = dict(image_size=(64, 64), mask_size=16, min_object_size=0.01,
                 min_objects_per_image=2, max_objects_per_image=8, seed=0)
PANOPTIC = dict(INSTANCES, min_object_size=0.005, min_objects_per_image=1)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{"jpg": the JAX generator's directory, "png": the port's}."""
    root = tmp_path_factory.mktemp("coco")
    return {"jpg": jax_make_fake_coco(str(root / "jpg"), num_images=8,
                                      image_size=SIZE),
            "png": make_fake_coco(str(root / "png"), num_images=8,
                                  image_size=SIZE, image_format="png")}


def datasets(paths, family: str):
    """(JAX dataset, port dataset) of one family over ``paths``."""
    if family == "instances":
        kw = dict(image_dir=paths["image_dir"],
                  instances_json=paths["instances_json"],
                  stuff_json=paths["stuff_json"], **INSTANCES)
        return JaxCocoDataset(**kw), CocoSceneGraphDataset(**kw)
    kw = dict(image_dir=paths["image_dir"], panoptic=paths["panoptic_json"],
              panoptic_segmentation=paths["panoptic_dir"],
              panoptic_categories=paths["panoptic_categories"], **PANOPTIC)
    return JaxPanopticDataset(**kw), CocoPanopticSceneGraphDataset(**kw)


@pytest.mark.parametrize("family", ["instances", "panoptic"])
@pytest.mark.parametrize("fmt", ["jpg", "png"])
def test_examples_equal_jax_bitwise(dirs, fmt, family):
    want, got = datasets(dirs[fmt], family)
    assert got.vocab == want.vocab
    assert got.vocab["is_panoptic"] == (family == "panoptic")
    assert len(got) == len(want) >= 6
    for epoch in (0, 1):
        for i in range(len(want)):
            a, b = want.get_example(i, epoch), got.get_example(i, epoch)
            for field in a._fields:
                x, y = getattr(a, field), getattr(b, field)
                assert x.dtype == y.dtype and x.shape == y.shape, field
                assert np.array_equal(x, y), (field, i, epoch)
    # A checkpoint's class mapping is adopted as the JAX dataset adopts it.
    mapping = {str(k): v for k, v in want.object_to_idx.items()}
    want.insert_pre_trained_vocab(mapping)
    got.insert_pre_trained_vocab(mapping)
    assert got.vocab == want.vocab


def test_generator_writes_the_jax_annotations_and_pixels(dirs, tmp_path):
    jpg = make_fake_coco(str(tmp_path / "jpg"), num_images=8,
                         image_size=SIZE)
    for key in ("instances_json", "stuff_json", "panoptic_json",
                "panoptic_categories"):
        with open(dirs["jpg"][key]) as f:
            want = f.read()
        with open(jpg[key]) as f:
            assert f.read() == want, key
        with open(dirs["png"][key]) as f:
            assert f.read() == want.replace(".jpg", ".png"), key
    for name in sorted(os.listdir(dirs["jpg"]["image_dir"])):
        with open(os.path.join(dirs["jpg"]["image_dir"], name), "rb") as f:
            want = f.read()
        with open(os.path.join(jpg["image_dir"], name), "rb") as f:
            assert f.read() == want, name
    # The PNGs hold the generator's pixels: the JAX generator's draw,
    # before JPEG coding.
    rng = np.random.RandomState(0)
    pixels = (rng.rand(SIZE[1], SIZE[0], 3) * 255).astype(np.uint8)
    png = os.path.join(dirs["png"]["image_dir"], "000001.png")
    assert np.array_equal(image_utils.read_png(png), pixels)
    assert np.array_equal(np.asarray(PIL.Image.open(png)), pixels)
    for name in sorted(os.listdir(dirs["jpg"]["panoptic_dir"])):
        a = np.asarray(PIL.Image.open(
            os.path.join(dirs["jpg"]["panoptic_dir"], name)))
        assert np.array_equal(image_utils.read_png(
            os.path.join(dirs["png"]["panoptic_dir"], name)), a), name


def _compress(counts):
    """Counts -> the compressed string (pycocotools rleToString)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _segmentations(paths):
    """(segmentation, width, height) of every annotation of the fake
    instances and stuff JSONs, and of random masks as uncompressed and
    compressed RLEs."""
    segs = []
    for key in ("instances_json", "stuff_json"):
        with open(paths[key]) as f:
            data = json.load(f)
        sizes = {im["id"]: (im["width"], im["height"])
                 for im in data["images"]}
        segs += [(a["segmentation"], *sizes[a["image_id"]])
                 for a in data["annotations"]]
    rng = np.random.RandomState(4)
    for _ in range(4):
        h, w = rng.randint(5, 40, size=2)
        mask = (rng.rand(h, w) > 0.6).astype(np.uint8)
        counts = jax_rle.encode_counts_py(mask)
        segs += [({"counts": counts, "size": [h, w]}, w, h),
                 ({"counts": _compress(counts), "size": [h, w]}, w, h)]
    polys = []
    for _ in range(3):
        cx, cy = rng.uniform(5, 25, 2)
        ang = np.linspace(0, 2 * np.pi, 9)[:-1]
        r = rng.uniform(2, 6)
        polys.append(np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)],
                              1).reshape(-1).tolist())
    segs.append((polys, 30, 30))
    return segs


def test_mask_codec_equals_jax_bitwise(dirs):
    segs = _segmentations(dirs["jpg"])
    kinds = {type(s).__name__ + (type(s.get("counts")).__name__
                                 if isinstance(s, dict) else "")
             for s, _, _ in segs}
    assert kinds == {"list", "dictlist", "dictstr"}
    for seg, w, h in segs:
        want = jax_rle.seg_to_mask(seg, w, h)
        assert want.any()
        for got in (rle.seg_to_mask(seg, w, h),
                    rle.seg_to_mask_py(seg, w, h)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
    assert rle.encode_counts_py(want) == jax_rle.encode_counts_py(want)
    s = segs[-2][0]["counts"]
    assert rle.rle_counts_from_string(s) == jax_rle.rle_counts_from_string(s)


def test_mask_codec_refuses_counts_that_do_not_cover_the_mask():
    with pytest.raises(ValueError, match="do not cover a 4x5 mask"):
        rle.seg_to_mask({"counts": [3, 4], "size": [4, 5]}, 5, 4)


def test_failed_codec_build_raises_with_the_compiler_error(tmp_path,
                                                          monkeypatch):
    bad = tmp_path / "rle.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(rle, "SRC", bad)
    monkeypatch.setattr(rle, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(rle, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        rle.seg_to_mask([[0, 0, 4, 0, 4, 4]], 5, 5)


def _png_file(tmp_path, img, name="img.png"):
    path = str(tmp_path / name)
    image_utils.write_png(path, img)
    return path


@pytest.mark.parametrize("src,size", [
    ((360, 480), (128, 128)), ((360, 480), (64, 64)),
    ((36, 48), (128, 128)), ((36, 48), (64, 64))],
    ids=["480x360-128", "480x360-64", "48x36-128", "48x36-64"])
def test_png_read_and_bilinear_resize_equal_pil(tmp_path, src, size):
    rng = np.random.RandomState(sum(src) + size[0])
    img = (rng.rand(*src, 3) * 255).astype(np.uint8)
    path = _png_file(tmp_path, img)
    got = image_utils.load_image(path, size)
    with PIL.Image.open(path) as im:
        want = np.asarray(im.convert("RGB").resize((size[1], size[0]),
                                                   PIL.Image.BILINEAR))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got, jax_image_utils.load_image(path, size))
    # Grey and RGBA PNGs convert as PIL's convert("RGB") does.
    for mode, arr in (("L", img[..., 0]), ("RGBA", np.concatenate(
            [img, img[..., :1]], -1))):
        p = str(tmp_path / f"{mode}.png")
        PIL.Image.fromarray(arr, mode).save(p)
        assert np.array_equal(image_utils.load_image(p, size),
                              jax_image_utils.load_image(p, size)), mode


@pytest.mark.parametrize("threshold", [128, 127])
def test_resize_mask_equals_jax(threshold):
    rng = np.random.RandomState(threshold)
    masks = [np.zeros((360, 480), np.uint8), np.zeros((7, 5), np.uint8),
             (rng.rand(45, 61) > 0.5).astype(np.uint8)]
    masks[0][40:300, 100:350] = 1
    masks[1][2:6, 1:4] = 1
    for mask in masks:
        for size in (16, 32):
            want = jax_image_utils.resize_mask(mask, size, threshold)
            got = image_utils.resize_mask(mask, size, threshold)
            assert got.dtype == want.dtype and np.array_equal(got, want)


def test_normalize_equals_jax():
    img = (np.random.RandomState(0).rand(5, 7, 3) * 255).astype(np.uint8)
    assert np.array_equal(image_utils.normalize(img),
                          jax_image_utils.normalize(img))


def test_jpeg_without_pil_names_the_file_and_format(dirs, monkeypatch):
    path = os.path.join(dirs["jpg"]["image_dir"], "000001.jpg")
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError) as e:
        image_utils.load_image(path, (64, 64))
    assert path in str(e.value) and "JPEG" in str(e.value)
    # PNGs need no PIL.
    png = os.path.join(dirs["png"]["image_dir"], "000001.png")
    assert image_utils.load_image(png, (64, 64)).shape == (64, 64, 3)


@pytest.mark.parametrize("worker_type", ["process", "thread"])
def test_loader_streams_equal_jax(dirs, worker_type):
    paths = dirs["png"]
    want_ds, got_ds = datasets(paths, "instances")
    kw = dict(batch_size=3, max_objs=9, max_triples=16, shuffle=True,
              seed=2, num_workers=2)
    want = list(JaxDataLoader(want_ds, **kw))
    loader = DataLoader(got_ds, worker_type=worker_type, **kw)
    try:
        got = list(loader)
    finally:
        loader.close()
    assert len(got) == len(want) == len(want_ds) // 3
    for a, b in zip(got, want):
        for field in b._fields:
            assert np.array_equal(getattr(a, field), getattr(b, field)), field
