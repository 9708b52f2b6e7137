"""Detection training in the port: SSD through ``compile``/``fit`` with
``MultiBoxLoss``, on the CPU.

- A 3-step ``ssd-tiny-64x64`` trajectory (f32, Adam 2e-3, batch 16) against
  the JAX ``Estimator.train`` from the same seeded weights over the same
  batches: the losses within ``LOSS_TOL`` relative, the parameters within
  ``PARAM_TOL`` of the update's norm (an update never made reads 1.0, so a
  port that does not train fails).
- The port of ``tests/test_detection_training.py``'s
  ``test_ssd_trains_and_map_improves`` with its thresholds unchanged: the
  roi augmentation chain -> ``to_detection_feature_set`` -> ``fit`` (bf16
  compute, as the catalog builds it) -> ``predict_detections`` -> VOC mAP
  at IoU 0.4 improving and reaching 0.5.

Tolerances: LOSS_TOL 1e-4 (the f32 loss of the same forward, about 40
layers and a mined cross-entropy summed in another order); PARAM_TOL 1e-3:
Adam's first steps move every leaf by about lr whatever the gradient's
scale, so a gradient that differs in its last bits moves a leaf by a
rounding-sized share of the update. Measured: losses equal, parameters
2.7e-5 of the update; mAP 0.012 -> 0.906.
"""

import jax
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.engine import estimator as jest
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.models.image.objectdetection import detector as jdet
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.data import feature_set as tfs
from analytics_zoo_tpu_torch.data.image_set import (
    ImageFeature,
    ImageHFlip,
    ImageRandomPreprocessing,
    ImageResize,
    ImageSet,
)
from analytics_zoo_tpu_torch.data.roi import (
    ImageRandomSampler,
    ImageRoiHFlip,
    ImageRoiNormalize,
    to_detection_feature_set,
)
from analytics_zoo_tpu_torch.engine import estimator as test_
from analytics_zoo_tpu_torch.engine import triggers as ttrig
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.models.image.objectdetection.detector import (
    ObjectDetector,
)
from analytics_zoo_tpu_torch.models.image.objectdetection.evaluator import (
    MeanAveragePrecision,
)

LOSS_TOL = 1e-4
PARAM_TOL = 1e-3


@pytest.fixture(autouse=True)
def _port_context():
    # two torch threads: the suite runs several workers on the machine's
    # cores, where torch's default of one thread per core oversubscribes
    # them (a bf16 fit took 75 times its time alone); restored after
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()
    torch.set_num_threads(threads)


def _make_dataset(n, rng, img=64):
    """Dark noise background + one bright box (class 1) per image (the JAX
    test's data)."""
    images, gts = [], []
    for _ in range(n):
        canvas = rng.integers(0, 60, (img, img, 3)).astype(np.uint8)
        w = int(rng.integers(20, 40))
        h = int(rng.integers(20, 40))
        x = int(rng.integers(0, img - w))
        y = int(rng.integers(0, img - h))
        canvas[y:y + h, x:x + w] = rng.integers(200, 255, (h, w, 3))
        images.append(canvas)
        gts.append(np.array([[1, x, y, x + w, y + h]], np.float32))
    return images, gts


def _distance(a, b):
    return float(np.sqrt(sum(
        np.sum((np.asarray(a[k][m], np.float64)
                - np.asarray(b[k][m], np.float64)) ** 2)
        for k in b for m in b[k])))


def test_ssd_tiny_trajectory_matches_jax(tmp_path):
    n, batch = 48, 16
    rng = np.random.default_rng(3)
    images, gts = _make_dataset(n, rng)
    x = (np.stack(images).astype(np.float32) - 127.5) / 127.5
    y = np.zeros((n, 4, 5), np.float32)
    for i, gt in enumerate(gts):
        y[i, :1] = gt
        y[i, :1, 1:] /= 64.0

    jd = jdet.ObjectDetector("ssd-tiny-64x64", num_classes=3)
    jd.model.compute_dtype = None
    params = jax.tree_util.tree_map(
        np.asarray, jd.model.init(jax.random.PRNGKey(4))[0])
    jd.model.init = lambda key: (params, {})
    est = jest.Estimator(jd.model, jopt.Adam(lr=2e-3))
    est.set_tensorboard(str(tmp_path), "ssd")
    est.train(jfs.ArrayFeatureSet(x, y), jd.multibox_loss(),
              end_trigger=jtrig.MaxEpoch(1), batch_size=batch)
    want = [v for _, v in est.train_summary.read_scalar("Loss")]
    ref = jax.tree_util.tree_map(np.asarray, est.tstate.params)

    td = ObjectDetector("ssd-tiny-64x64", num_classes=3)
    td.model.compute_dtype = None
    load_jax_params(td.model, params)
    test = test_.Estimator(td.model, topt.Adam(lr=2e-3))
    test.train(tfs.ArrayFeatureSet(x, y), td.multibox_loss(),
               end_trigger=ttrig.MaxEpoch(1), batch_size=batch)
    got = {k: {m: t.numpy() for m, t in v.items()}
           for k, v in test.tstate.params.items()}

    assert len(test.train_losses) == len(want) == n // batch
    np.testing.assert_allclose(test.train_losses, want, rtol=LOSS_TOL)
    assert set(got) == set(ref)
    update = _distance(ref, params)
    assert _distance(params, ref) / update > PARAM_TOL  # unchanged fails
    dev = _distance(got, ref) / update
    assert dev <= PARAM_TOL, dev
    # the trained weights came back to the model
    assert td.model.params is test.tstate.params


def test_ssd_trains_and_map_improves():
    rng = np.random.default_rng(0)
    images, gts = _make_dataset(64, rng)

    # -- augmentation chain (SSDDataSet.loadSSDTrainSet analogue) ----------
    feats = [ImageFeature(image=im, roi=gt) for im, gt in zip(images, gts)]
    s = ImageSet(feats)
    s.transform(ImageRoiNormalize())
    s.transform(ImageRandomSampler(seed=0))
    s.transform(ImageResize(64, 64))
    s.transform(ImageRandomPreprocessing(
        ImageHFlip() | ImageRoiHFlip(), 0.5, seed=0))
    fs_raw = to_detection_feature_set(s, max_boxes=4)

    det = ObjectDetector("ssd-tiny-64x64", num_classes=2)
    assert det.model.compute_dtype == "bfloat16"
    x = (fs_raw.xs[0] - 127.5) / 127.5          # cfg.preprocess normalization
    y = fs_raw.ys[0]

    def current_map():
        m = MeanAveragePrecision(num_classes=2, iou_threshold=0.4)
        # chain output is BGR; predict_detections takes RGB (the preprocess
        # contract): flip so train and eval see the same pixels
        dets = det.predict_detections(
            np.stack(images)[..., ::-1], score_threshold=0.3, batch_size=32)
        for d, gt in zip(dets, gts):
            m.add(d["boxes"], d["scores"], d["classes"], gt[:, 1:], gt[:, 0])
        return m.result()["mAP"]

    map_before = current_map()
    det.model.compile(optimizer=topt.Adam(lr=2e-3), loss=det.multibox_loss())
    det.model.fit(x, y, batch_size=16, nb_epoch=12)
    losses = det.model._estimator.train_losses
    assert all(np.isfinite(losses))
    map_after = current_map()
    assert map_after > map_before, (map_before, map_after)
    assert map_after >= 0.5, f"mAP only reached {map_after:.3f}"
