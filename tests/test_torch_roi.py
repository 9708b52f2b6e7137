"""The port's box-aware transforms (``data/roi.py``) against the JAX
package's.

Every test of ``tests/test_roi_transforms.py``, re-pointed at the port: each
case runs once through the port's ``data.image_set``/``data.roi`` and once
through the JAX package's on the same seeded images, keeps the JAX test's
assertions on the port's result, and requires the two results to be equal
bitwise (images, rois, dtypes: the same numpy and OpenCV code on the same
draws). Then ``read_voc`` on ``tests/fixtures/voc_mini`` and the COCO
fixture tests (``tests/test_objectdetection.py``), bitwise against the JAX
readers, and the chain's ``to_detection_feature_set`` against the JAX one.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from analytics_zoo_tpu.data import image_set as jis
from analytics_zoo_tpu.data import roi as jroi
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data import image_set as tis
from analytics_zoo_tpu_torch.data import roi as troi

def _public(*modules):
    return SimpleNamespace(**{k: v for m in modules for k, v in vars(m).items()
                              if not k.startswith("_")})


J = _public(jis, jroi)
T = _public(tis, troi)


def _same(got, want):
    """Equal bitwise, recursively: arrays by dtype and value, dicts by keys
    (an ImageFeature's), sequences element by element."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _both(case):
    """``case(P)`` through the port and the JAX package, equal bitwise;
    returns the port's result."""
    got, want = case(T), case(J)
    _same(got, want)
    return got


def _feat(P, h=40, w=60, roi=None):
    rng = np.random.default_rng(0)
    f = P.ImageFeature(image=rng.integers(0, 255, (h, w, 3)).astype(np.uint8))
    if roi is not None:
        f["roi"] = np.asarray(roi, np.float32)
    return f


def test_roi_normalize_and_double_flip_identity():
    def case(P):
        f = P.ImageRoiNormalize()(_feat(P, roi=[[1, 6, 4, 30, 20]]))
        norm = f["roi"].copy()
        again = P.ImageRoiNormalize()(f)["roi"].copy()  # idempotent
        once = P.ImageRoiHFlip()(f)["roi"].copy()
        twice = P.ImageRoiHFlip()(f)["roi"]
        return norm, again, once, twice

    norm, again, once, twice = _both(case)
    np.testing.assert_allclose(norm[0, 1:], [0.1, 0.1, 0.5, 0.5])
    np.testing.assert_allclose(again[0, 1:], [0.1, 0.1, 0.5, 0.5])
    np.testing.assert_allclose(once[0, 1:], [0.5, 0.1, 0.9, 0.5])
    np.testing.assert_allclose(twice[0, 1:], [0.1, 0.1, 0.5, 0.5], atol=1e-6)


def test_roi_resize_pixel_coords():
    def case(P):
        f = P.ImageResize(80, 120)(_feat(P, h=40, w=60,
                                         roi=[[2, 6, 4, 30, 20]]))
        return P.ImageRoiResize(normalized=False)(f)

    f = _both(case)
    np.testing.assert_allclose(f["roi"][0], [2, 12, 8, 60, 40])


def test_roi_project_center_constraint_and_padding():
    def case(P):
        f = _feat(P, roi=[[1, 0.2, 0.2, 0.4, 0.4],     # fully inside
                          [2, -0.5, -0.5, 0.1, 0.1],   # center outside
                          [3, 0.8, 0.8, 1.1, 1.0]])    # center inside
        f["roi_normalized"] = True
        return P.ImageRoiProject()(f)

    r = _both(case)["roi"]
    assert list(r[:, 0]) == [1.0, 3.0, 0.0]      # compacted, padded
    np.testing.assert_allclose(r[1, 1:], [0.8, 0.8, 1.0, 1.0])


def test_expand_updates_roi_and_stays_in_bounds():
    def case(P):
        f = P.ImageRoiNormalize()(_feat(P, roi=[[1, 10, 10, 30, 30]]))
        before = f["roi"][0].copy()
        f = P.ImageRoiProject()(P.ImageExpand(max_ratio=3.0, seed=3)(f))
        return before, f

    before, f = _both(case)
    r = f["roi"][0]
    assert r[0] == 1.0
    assert (r[1:] >= 0).all() and (r[1:] <= 1).all()
    area = (r[3] - r[1]) * (r[4] - r[2])
    area0 = (before[3] - before[1]) * (before[4] - before[2])
    assert area < area0


def test_batch_sampler_iou_constraint():
    def case(P):
        rng = np.random.default_rng(0)
        gt = np.array([[0.2, 0.2, 0.8, 0.8]], np.float32)
        patch = P.BatchSampler(min_overlap=0.5, max_trials=200).sample(rng, gt)
        tiny_gt = np.array([[0.45, 0.45, 0.55, 0.55]], np.float32)
        gave_up = P.BatchSampler(min_overlap=0.9, max_trials=5).sample(
            rng, tiny_gt) is None
        return patch, gave_up, [vars(s) for s in P.ssd_default_samplers()]

    patch, gave_up, _ = _both(case)
    gt = np.array([0.2, 0.2, 0.8, 0.8], np.float32)
    lt = np.maximum(patch[:2], gt[:2])
    rb = np.minimum(patch[2:], gt[2:])
    inter = np.prod(np.clip(rb - lt, 0, None))
    union = (patch[2] - patch[0]) * (patch[3] - patch[1]) + 0.36 - inter
    assert inter / union >= 0.5
    assert gave_up  # infeasible constraint -> None, no exception


def test_random_sampler_crops_and_projects():
    def case(P):
        f = P.ImageRoiNormalize()(_feat(P, h=64, w=64,
                                        roi=[[1, 16, 16, 48, 48]]))
        return P.ImageRandomSampler(seed=1)(f)

    f = _both(case)
    img, r = f["image"], f["roi"]
    assert img.ndim == 3 and img.shape[0] >= 1 and img.shape[1] >= 1
    live = r[r[:, 0] > 0]
    assert (live[:, 1:] >= 0).all() and (live[:, 1:] <= 1).all()


def test_ssd_train_chain_static_shapes():
    """The full SSDDataSet.loadSSDTrainSet chain analogue ends statically
    shaped regardless of augmentation randomness, and the port's feature
    set is an ArrayFeatureSet of the port."""
    def case(P):
        rng = np.random.default_rng(0)
        feats = []
        for i in range(6):
            img = rng.integers(0, 255, (50 + 7 * i, 80 - 5 * i, 3)).astype(
                np.uint8)
            feats.append(P.ImageFeature(
                image=img, roi=np.array([[1, 5, 5, 30, 30]], np.float32)))
        s = P.ImageSet(feats)
        s.transform(P.ImageRoiNormalize())
        s.transform(P.ImageColorJitter(seed=0))
        s.transform(P.ImageRandomPreprocessing(
            P.ImageExpand(seed=0) | P.ImageRoiProject(), 0.5, seed=0))
        s.transform(P.ImageRandomSampler(seed=0))
        s.transform(P.ImageResize(32, 32))
        s.transform(P.ImageRandomPreprocessing(
            P.ImageHFlip() | P.ImageRoiHFlip(), 0.5, seed=0))
        s.transform(P.ImageChannelScaledNormalizer(123, 117, 104, 1 / 128.0))
        s.transform(P.ImageMatToFloats(valid_height=32, valid_width=32))
        return P.to_detection_feature_set(s, max_boxes=4)

    got, want = case(T), case(J)
    assert isinstance(got, tfs.ArrayFeatureSet)
    _same((got.xs, got.ys), (want.xs, want.ys))
    x, y = got.xs[0], got.ys[0]
    assert x.shape == (6, 32, 32, 3) and y.shape == (6, 4, 5)
    live = y[y[:, :, 0] > 0]
    assert (live[:, 1:] >= 0).all() and (live[:, 1:] <= 1.0).all()


def test_pad_roi():
    def case(P):
        return (P.pad_roi(np.array([[1, .1, .1, .2, .2], [0, 0, 0, 0, 0]]), 3),
                P.pad_roi(None, 2))

    out, empty = _both(case)
    assert out.shape == (3, 5)
    assert out[0, 0] == 1 and (out[1:] == 0).all()
    assert empty.shape == (2, 5)


# -- general op tail ---------------------------------------------------------


def test_fixed_crop_normalized_and_pixel():
    def case(P):
        return (P.ImageFixedCrop(0.25, 0.25, 0.75, 0.75, normalized=True)(
                    _feat(P, h=40, w=60)),
                P.ImageFixedCrop(10, 5, 200, 35, normalized=False)(
                    _feat(P, h=40, w=60)))

    out, out2 = _both(case)
    assert out["image"].shape == (20, 30, 3)
    assert out2["image"].shape == (30, 50, 3)   # clipped


def test_random_cropper_center_and_mirror():
    def case(P):
        return (P.ImageRandomCropper(20, 16, cropper_method="center")(
                    _feat(P, h=40, w=60)),
                P.ImageRandomCropper(20, 16, mirror=True, seed=0)(
                    _feat(P, h=40, w=60)))

    out, out2 = _both(case)
    assert out["image"].shape == (16, 20, 3)
    assert out2["image"].shape == (16, 20, 3)


def test_random_resize_short_side_in_range():
    out = _both(lambda P: P.ImageRandomResize(20, 30, seed=0)(
        _feat(P, h=40, w=60)))
    h, w = out["image"].shape[:2]
    assert 20 <= min(h, w) <= 30
    assert abs(w / h - 60 / 40) < 0.1


def test_channel_scaled_normalizer():
    out = _both(lambda P: P.ImageChannelScaledNormalizer(10, 20, 30, 0.5)(
        P.ImageFeature(image=np.full((4, 4, 3), 100, np.uint8))))
    # BGR storage: mean (30, 20, 10)
    np.testing.assert_allclose(out["image"][0, 0], [35.0, 40.0, 45.0])


def test_color_jitter_preserves_shape_dtype_range():
    out = _both(lambda P: P.ImageColorJitter(
        random_channel_order_prob=1.0, shuffle=True, seed=0)(_feat(P)))
    img = np.asarray(out["image"])
    assert img.shape == (40, 60, 3)
    assert img.min() >= 0 and img.max() <= 255


def test_pixel_bytes_to_mat_roundtrip():
    img = np.random.default_rng(0).integers(0, 255, (8, 6, 3)).astype(np.uint8)
    out = _both(lambda P: P.ImagePixelBytesToMat()(P.ImageFeature(
        bytes=img.tobytes(), height=8, width=6, channels=3)))
    np.testing.assert_array_equal(out["image"], img)


def test_buffered_image_resize_then_decode():
    img = np.random.default_rng(0).integers(0, 255, (20, 30, 3)).astype(np.uint8)
    ok, enc = cv2.imencode(".png", img)
    assert ok
    f = _both(lambda P: P.ImageBytesToMat()(P.BufferedImageResize(10, 12)(
        P.ImageFeature(bytes=enc.tobytes()))))
    assert f["image"].shape == (10, 12, 3)


def test_mat_to_floats_pads_and_crops():
    out, out2 = _both(lambda P: (P.ImageMatToFloats(32, 32)(
        _feat(P, h=20, w=20)), P.ImageMatToFloats(32, 32)(
        _feat(P, h=40, w=40))))
    assert out["image"].shape == (32, 32, 3)
    assert out["image"].dtype == np.float32
    assert (out["image"][20:] == 0).all()
    assert out2["image"].shape == (32, 32, 3)


# -- readers -------------------------------------------------------------------

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "voc_mini")


def test_read_voc_fixture_matches_jax():
    """``read_voc`` on the committed VOC2007-layout fixture: the same
    images and rois as the JAX reader, through the chain of
    ``test_ssd_trains_on_voc_fixture`` into the same feature set."""
    def case(P):
        s, classes = P.read_voc(FIXTURE)
        raw = [(f["image"], f["roi"], f["uri"]) for f in s.features]
        s.transform(P.ImageRoiNormalize())
        s.transform(P.ImageResize(64, 64))
        s.transform(P.ImageRandomPreprocessing(
            P.ImageHFlip() | P.ImageRoiHFlip(), 0.5, seed=0))
        fs = P.to_detection_feature_set(s, max_boxes=4)
        return classes, raw, fs.xs[0], fs.ys[0]

    classes, raw, x, y = _both(case)
    assert classes == ["person", "tvmonitor"]
    assert len(raw) == 16 and all(len(r) >= 1 for _, r, _ in raw)
    assert x.shape == (16, 64, 64, 3) and y.shape == (16, 4, 5)
    # named classes, difficult boxes left out
    s, names = troi.read_voc(FIXTURE, class_names=["tvmonitor"],
                             include_difficult=False)
    js, jnames = jroi.read_voc(FIXTURE, class_names=["tvmonitor"],
                               include_difficult=False)
    assert names == jnames == ["tvmonitor"]
    _same([f["roi"] for f in s.features], [f["roi"] for f in js.features])
    with pytest.raises(FileNotFoundError, match="VOC-layout"):
        troi.read_voc(os.path.dirname(FIXTURE))


def _mini_coco(tmp_path, n_images=3):
    """A tiny COCO-layout dataset: cv2-readable images plus an instances
    json with xywh boxes, sparse category ids and one crowd region."""
    import json

    img_dir = tmp_path / "images"
    img_dir.mkdir(exist_ok=True)
    images, annotations = [], []
    aid = 1
    for i in range(n_images):
        name = f"im{i}.jpg"
        cv2.imwrite(str(img_dir / name),
                    np.full((40, 60, 3), 30 * (i + 1), np.uint8))
        images.append({"id": 10 + i, "file_name": name,
                       "width": 60, "height": 40})
        annotations.append({"id": aid, "image_id": 10 + i,
                            "category_id": 7, "bbox": [5, 5, 20, 10],
                            "iscrowd": 0})
        aid += 1
        if i == 1:
            annotations.append({"id": aid, "image_id": 10 + i,
                                "category_id": 21, "bbox": [30, 10, 15, 15],
                                "iscrowd": 1})
            aid += 1
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": 7, "name": "cat"},
                          {"id": 21, "name": "zebra"}]}
    ann_path = tmp_path / "instances.json"
    with open(ann_path, "w") as f:
        json.dump(ann, f)
    return str(img_dir), str(ann_path)


def test_read_coco_mini_fixture(tmp_path):
    img_dir, ann_path = _mini_coco(tmp_path)

    def case(P):
        iset, names = P.read_coco(img_dir, ann_path)
        return names, [dict(f) for f in iset.features]

    names, feats = _both(case)
    assert names == ["cat", "zebra"]
    assert len(feats) == 3
    np.testing.assert_allclose(feats[0]["roi"], [[1, 5, 5, 25, 15]])
    assert feats[1]["roi"].shape == (2, 5)
    assert feats[1]["roi"][1][0] == 2  # zebra -> contiguous label 2
    np.testing.assert_array_equal(feats[1]["crowd"], [False, True])
    assert feats[0]["image"].shape == (40, 60, 3)


def test_read_coco_feeds_detection_feature_set(tmp_path):
    img_dir, ann_path = _mini_coco(tmp_path)

    def case(P):
        iset, _ = P.read_coco(img_dir, ann_path)
        return P.to_detection_feature_set(iset, max_boxes=4).take(
            np.arange(3))

    x, y = _both(case)
    assert x.shape == (3, 40, 60, 3)
    assert y.shape == (3, 4, 5)
