"""The object-detection family in the port against the JAX package, on the
CPU.

- ``ops/bbox``: every function on the same seeded numpy inputs, NMS against
  a greedy numpy loop and against JAX with tied scores, ``multiclass_nms``
  with ties in the final merge, ``match_priors`` (the JAX tests' padding
  and bipartite cases, random batches exactly, a contested prior going to
  one of its contenders: the higher box index).
- Nothing in the post-processing, the proposals or the loss syncs with the
  host: a dispatch mode records every aten op they run after a warm-up,
  and none is a host read (``.item()``), a ``nonzero``, a masked select or
  a tensor made from host values.
- Priors (8732 for SSD300), ``MultiBoxLoss`` (the JAX tests' cases, then
  value and gradient against ``jax.grad`` on logits from a few bf16 values,
  so that mining meets ties; with a sort that puts tied negatives in
  another order the gradient leaves JAX's).
- ``Reshape``, ``AtrousConvolution2D`` and ``UpSampling2D``: forward and
  gradients against ``jax.grad``.
- Forwards in f32 from one set of seeded numpy weights carried by
  ``interop.load_jax_params``: ``ssd_tiny``, a 300x300 ``ssd_mobilenet_300``
  and ``ssd_vgg16_300``; every ``_CATALOG`` name's tree at full width
  against ``jax.eval_shape``, with the parameter counts.
- ``ObjectDetector.predict_detections`` against the JAX package's on the
  same weights (the JAX tests' ``ssd-mobilenet-300x300`` setup and both
  ``frcnn-*`` at their small sizes); Faster-RCNN's RoI-align and
  proposals; save/load; the evaluators, label maps and visualizers.

Tolerances (f32): ``LAYER_TOL`` 1e-5 relative to the largest magnitude
(absolute below 1) for one op or layer; ``NET_TOL`` 1e-4 for whole
networks (dozens of layers summed in another order), as the image catalog
tests. Detections must have the same classes; boxes within ``BOX_TOL``
1e-4 (normalized units, after a decode of outputs within NET_TOL) and
scores within NET_TOL.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.models.image.objectdetection import detector as jdet
from analytics_zoo_tpu.models.image.objectdetection import evaluator as jev
from analytics_zoo_tpu.models.image.objectdetection import frcnn as jfr
from analytics_zoo_tpu.models.image.objectdetection import loss as jloss
from analytics_zoo_tpu.models.image.objectdetection import priorbox as jpb
from analytics_zoo_tpu.models.image.objectdetection import ssd as jssd
from analytics_zoo_tpu.models.image.objectdetection import visualizer as jvis
from analytics_zoo_tpu.ops import bbox as JB
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.data.image_set import ImageFeature
from analytics_zoo_tpu_torch.interop import (
    _counter_named,
    _natural_key,
    load_jax_params,
)
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.models.common import ZooModel
from analytics_zoo_tpu_torch.models.image.objectdetection import detector as tdet
from analytics_zoo_tpu_torch.models.image.objectdetection import evaluator as tev
from analytics_zoo_tpu_torch.models.image.objectdetection import frcnn as tfr
from analytics_zoo_tpu_torch.models.image.objectdetection import loss as tloss
from analytics_zoo_tpu_torch.models.image.objectdetection import priorbox as tpb
from analytics_zoo_tpu_torch.models.image.objectdetection import ssd as tssd
from analytics_zoo_tpu_torch.models.image.objectdetection import visualizer as tvis
from analytics_zoo_tpu_torch.ops import bbox as TB

LAYER_TOL = 1e-5
NET_TOL = 1e-4
BOX_TOL = 1e-4


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


def _close(got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _boxes(rng, n, lo=0.05, hi=0.4):
    corner = rng.uniform(0, 0.6, (n, 2))
    return np.concatenate([corner, corner + rng.uniform(lo, hi, (n, 2))],
                          -1).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _seeded_tree(shapes, seed, scale=1.0):
    """Numpy values for a ``{layer: {leaf: shape}}`` tree: kernels scaled
    by ``scale`` / sqrt(fan in), BN gamma near 1, L2Norm's gamma near 20,
    biases and betas small, moving means small, variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer in sorted(shapes):
        out[layer] = {}
        for leaf in sorted(shapes[layer]):
            shape = tuple(shapes[layer][leaf])
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * scale * np.sqrt(2.0 / fan_in)
            elif leaf == "gamma":
                v = rng.uniform(0.8, 1.2, shape) * (
                    20.0 if layer.endswith("_norm") else 1.0)
            elif leaf == "moving_var":
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.normal(0.0, 0.1, shape)
            out[layer][leaf] = v.astype(np.float32)
    return out


def _jax_shapes(jnet):
    p, s = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    return tuple({k: {n: tuple(a.shape) for n, a in v.items()}
                  for k, v in t.items()} for t in (p, s))


def _port_shapes(tnet):
    return tuple({k: {n: spec.shape for n, spec in v.items()}
                  for k, v in t.items()}
                 for t in (tnet.param_specs(), tnet.state_specs()))


def _canonical_names(tree):
    """Name -> canonical name: a counter name (``batchnormalization_7``)
    as its kind and rank among that kind's names in natural order, as
    ``load_jax_params`` matches it. VGG's ``conv4_3`` looks like one but is
    an explicit name in both graphs: it stays as it is, so the names
    themselves are compared."""
    ranks, seen = {}, {}
    for name in sorted(tree, key=_natural_key):
        if _counter_named(name) and not name.startswith("conv"):
            kind = name.rsplit("_", 1)[0]
            seen[kind] = seen.get(kind, -1) + 1
            ranks[name] = f"{kind}#{seen[kind]}"
    return {k: ranks.get(k, k) for k in tree}


def _canonical(trees):
    """The trees keyed by canonical names (how ``load_jax_params`` matches
    counter names)."""
    out = []
    for tree in trees:
        names = _canonical_names(tree)
        out.append({names[k]: v for k, v in tree.items()})
    return tuple(out)


# ---------------------------------------------------------------------------
# ops/bbox
# ---------------------------------------------------------------------------


def _iou_numpy(a, b):
    out = np.zeros((len(a), len(b)), np.float32)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            ix = max(0.0, min(x[2], y[2]) - max(x[0], y[0]))
            iy = max(0.0, min(x[3], y[3]) - max(x[1], y[1]))
            inter = ix * iy
            ua = (x[2] - x[0]) * (x[3] - x[1]) + (y[2] - y[0]) * (y[3] - y[1]) - inter
            out[i, j] = inter / ua if ua > 0 else 0.0
    return out


def test_iou_and_area_match_bruteforce_and_jax():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    b[0] = [0.3, 0.3, 0.3, 0.5]  # degenerate: zero area
    got = TB.bbox_iou(_t(a), _t(b))
    _close(got, _iou_numpy(a, b), LAYER_TOL)
    _close(got, JB.bbox_iou(jnp.asarray(a), jnp.asarray(b)), LAYER_TOL)
    _close(TB.bbox_area(_t(b)), JB.bbox_area(jnp.asarray(b)), LAYER_TOL)
    # leading dims broadcast: a batch of 3 images against one set
    batched = TB.bbox_iou(_t(np.stack([a] * 3)), _t(b))
    assert batched.shape == (3, 7, 5)
    assert torch.equal(batched[1], got)


def test_box_codecs_match_jax_and_round_trip():
    rng = np.random.default_rng(1)
    priors, boxes = _boxes(rng, 32, 0.1, 0.4), _boxes(rng, 32, 0.1, 0.4)
    for variances in ((0.1, 0.1, 0.2, 0.2), (1.0, 1.0, 1.0, 1.0)):
        enc = TB.encode_boxes(_t(priors), _t(boxes), variances)
        jenc = JB.encode_boxes(jnp.asarray(priors), jnp.asarray(boxes),
                               variances)
        _close(enc, jenc, LAYER_TOL)
        dec = TB.decode_boxes(_t(priors), enc, variances)
        _close(dec, JB.decode_boxes(jnp.asarray(priors), jenc, variances),
               LAYER_TOL)
        _close(dec, boxes, 1e-4)
    centers = TB.corner_to_center(_t(boxes))
    _close(centers, JB.corner_to_center(jnp.asarray(boxes)), LAYER_TOL)
    _close(TB.center_to_corner(centers), boxes, LAYER_TOL)
    wide = boxes * 3 - 1
    assert torch.equal(TB.clip_boxes(_t(wide)),
                       _t(np.asarray(JB.clip_boxes(jnp.asarray(wide)))))
    # a bf16 loc is promoted by the float32 variances, as in JAX
    assert TB.decode_boxes(_t(priors), enc.bfloat16()).dtype == torch.float32
    np.testing.assert_array_equal(
        TB.scale_detections(boxes, 640, 480),
        JB.scale_detections(boxes, 640, 480))


def _greedy_nms(boxes, scores, thr):
    iou = _iou_numpy(boxes, boxes)
    live = np.ones(len(boxes), bool)
    keep = []
    while live.any():
        i = int(np.argmax(np.where(live, scores, -1)))
        keep.append(i)
        live &= iou[i] < thr
        live[i] = False
    return keep


@pytest.mark.parametrize("tied", [False, True])
def test_nms_matches_greedy_numpy_and_jax(tied):
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 40, 0.05, 0.3)
    scores = rng.uniform(0, 1, 40).astype(np.float32)
    if tied:  # five distinct values: argmax must take the first index
        scores = np.round(scores * 4) / 4
    idx, valid = TB.nms(_t(boxes), _t(scores), 40, 0.45)
    got = list(idx.numpy()[valid.numpy()])
    assert got == _greedy_nms(boxes, scores, 0.45)
    jidx, jvalid = JB.nms(jnp.asarray(boxes), jnp.asarray(scores), max_out=40,
                          iou_threshold=0.45)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    # a score threshold leaves the low boxes out; unused slots are 0/False
    idx, valid = TB.nms(_t(boxes), _t(scores), 40, 0.45, score_threshold=0.5)
    jidx, jvalid = JB.nms(jnp.asarray(boxes), jnp.asarray(scores), 40, 0.45,
                          0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert (idx.numpy()[~valid.numpy()] == 0).all()


def test_nms_batch_equals_each_row():
    rng = np.random.default_rng(3)
    boxes = np.stack([_boxes(rng, 20) for _ in range(6)]).reshape(2, 3, 20, 4)
    scores = np.round(rng.uniform(0, 1, (2, 3, 20)) * 8).astype(np.float32)
    idx, valid = TB.nms(_t(boxes), _t(scores), 12, 0.3, 2.0)
    assert idx.shape == valid.shape == (2, 3, 12)
    for i in range(2):
        for j in range(3):
            one = TB.nms(_t(boxes[i, j]), _t(scores[i, j]), 12, 0.3, 2.0)
            assert torch.equal(idx[i, j], one[0])
            assert torch.equal(valid[i, j], one[1])


@pytest.mark.parametrize("tied", [False, True])
def test_multiclass_nms_matches_jax(tied):
    rng = np.random.default_rng(4)
    boxes = _boxes(rng, 30, 0.2, 0.2)
    logits = rng.normal(size=(30, 5)).astype(np.float32)
    scores = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
    if tied:  # equal scores across classes meet in the final merge
        scores = np.round(scores * 8) / 8
    got = TB.multiclass_nms(_t(boxes), _t(scores), max_per_class=10,
                            max_total=15)
    want = JB.multiclass_nms(jnp.asarray(boxes), jnp.asarray(scores),
                             max_per_class=10, max_total=15)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    b, s, c, v = got
    assert b.shape == (15, 4) and s.shape == (15,) and c.dtype == torch.int32
    assert (c[v] >= 1).all()                       # background never emitted
    assert (torch.diff(s[v]) <= 0).all()           # sorted descending
    # padded when the classes hold fewer slots than max_total; batched rows
    # equal the unbatched call
    pad = TB.multiclass_nms(_t(boxes[:3]), _t(scores[:3]), max_per_class=2,
                            max_total=20)
    jpad = JB.multiclass_nms(jnp.asarray(boxes[:3]), jnp.asarray(scores[:3]),
                             max_per_class=2, max_total=20)
    for g, w in zip(pad, jpad):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    batched = TB.multiclass_nms(_t(np.stack([boxes, boxes[::-1]])),
                                _t(np.stack([scores, scores[::-1]])),
                                max_per_class=10, max_total=15)
    for g, w in zip(batched, got):
        assert torch.equal(g[0], w)


def test_match_priors_padding_gt_does_not_clobber_prior0():
    # a padding box's argmax over its all(-1) IoU column is prior 0; the
    # scatter must drop it, not erase prior 0's forced match
    priors = _t([[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.7, 0.7]]).float()
    gts = _t([[0.0, 0.0, 0.1, 0.2], [0.0, 0.0, 0.0, 0.0]]).float()
    assign, _ = TB.match_priors(priors, gts, _t([True, False]), 0.9)
    assert assign[0] == 0


def test_match_priors_bipartite_guarantee():
    # box 1's best prior only overlaps 0.3 < threshold, but must still match
    priors = _t([[0.0, 0.0, 0.2, 0.2], [0.5, 0.5, 0.7, 0.7],
                 [0.05, 0.0, 0.25, 0.2]]).float()
    gts = _t([[0.0, 0.0, 0.2, 0.2], [0.55, 0.62, 0.75, 0.82]]).float()
    assign, _ = TB.match_priors(priors, gts, _t([True, True]), 0.5)
    assert assign[0] == 0
    assert assign[1] == 1
    assert assign[2] in (-1, 0)


def test_match_priors_matches_jax_on_random_batches():
    rng = np.random.default_rng(5)
    priors = jpb.generate_priors(jssd.SSD_TINY_64.specs, 64)
    gts = np.stack([_boxes(rng, 6, 0.1, 0.5) for _ in range(4)])
    valid = rng.uniform(size=(4, 6)) < 0.7
    assign, best = TB.match_priors(_t(priors), _t(gts), _t(valid), 0.5)
    for i in range(4):
        ja, jb = JB.match_priors(jnp.asarray(priors), jnp.asarray(gts[i]),
                                 jnp.asarray(valid[i]), 0.5)
        np.testing.assert_array_equal(assign[i].numpy(), np.asarray(ja))
        _close(best[i], jb, LAYER_TOL)
        # every valid box owns at least one prior
        assert set(np.flatnonzero(valid[i])) <= set(assign[i].tolist())


def test_match_priors_contested_prior_goes_to_the_higher_box():
    """Two valid boxes whose favourite is the same prior: JAX lets one of
    them win (unspecified); the port's rule is the higher box index."""
    priors = _t([[0.0, 0.0, 0.4, 0.4], [0.6, 0.6, 0.9, 0.9]]).float()
    gts = _t([[0.0, 0.0, 0.3, 0.3], [0.05, 0.05, 0.35, 0.35],
              [0.0, 0.0, 0.0, 0.0]]).float()
    valid = _t([True, True, False])
    assign, _ = TB.match_priors(priors, gts, valid, 0.9)
    ja, _ = JB.match_priors(jnp.asarray(priors.numpy()),
                            jnp.asarray(gts.numpy()),
                            jnp.asarray(valid.numpy()), 0.9)
    assert int(np.asarray(ja)[0]) in (0, 1)       # one of the contenders
    assert assign.tolist() == [1, -1]


class _OpLog(TorchDispatchMode):
    """Records the name of every aten op run under it."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


_HOST_SYNC_OPS = {"_local_scalar_dense", "nonzero", "nonzero_static",
                  "masked_select", "unique", "_unique2", "item"}


def _runs_without_host_sync(fn, *args):
    """``fn(*args)`` twice; the second call (after the warm-up that a CUDA
    graph capture follows) must run no host read and make no tensor from
    host values (``lift_fresh``: a copy from the host in a capture)."""
    fn(*args)
    with _OpLog() as log:
        out = fn(*args)
    assert log.ops, "nothing was recorded"
    bad = log.ops & (_HOST_SYNC_OPS | {"lift_fresh"})
    assert not bad, bad
    return out


def test_post_processing_proposals_and_loss_never_sync():
    """What runs inside a CUDA graph (the SSD and Faster-RCNN post-process,
    the proposals) and the loss of every train step: no op that reads a
    value to the host, makes a shape from values or copies host values in;
    two inputs with different live sets give the same shapes."""
    rng = np.random.default_rng(6)
    cfg = tdet.ObjectDetectionConfig("ssd-tiny-64x64", 64, num_classes=4,
                                     max_per_class=5, max_total=12)
    post = tdet.ssd_postprocess(tssd.SSD_TINY_64.priors(), cfg)
    shapes = []
    for live in (0.0, 8.0):
        raw = rng.normal(size=(2, 320, 8)).astype(np.float32)
        raw[..., 4] += live  # background everywhere: nothing clears 0.01
        out = _runs_without_host_sync(post, _t(raw))
        shapes.append([tuple(t.shape) for t in out])
    assert shapes[0] == shapes[1] == [(2, 12, 4), (2, 12), (2, 12), (2, 12)]
    small = tfr.FrcnnConfig(img_size=64, pre_nms_top_n=20, post_nms_top_n=6)
    f, a = small.feat_size, small.num_anchors
    rois = _runs_without_host_sync(
        tfr._proposals(small), _t(rng.uniform(size=(2, f, f, a)).astype(
            np.float32)), _t(rng.normal(size=(2, f, f, 4 * a)).astype(
                np.float32) * 0.1))
    assert rois.shape == (2, 6, 5)
    packed = rng.uniform(size=(2, 6, 3 + 12 + 5)).astype(np.float32)
    out = _runs_without_host_sync(tfr.frcnn_postprocess(small, 3, 0.01, 0.45,
                                                        4, 7), _t(packed))
    assert [tuple(t.shape) for t in out] == [(2, 7, 4), (2, 7), (2, 7),
                                              (2, 7)]
    loss = tloss.MultiBoxLoss(tssd.SSD_TINY_64.priors(), 4)
    y_true = np.zeros((2, 3, 5), np.float32)
    y_true[0, 0] = [1, 0.1, 0.1, 0.5, 0.5]
    _runs_without_host_sync(loss, _t(y_true), _t(raw))


# ---------------------------------------------------------------------------
# Priors and MultiBoxLoss
# ---------------------------------------------------------------------------


def test_priors_match_jax_and_ssd300_has_8732():
    spec = tpb.PriorBoxSpec(feature_size=2, step=150, min_size=60,
                            max_size=120, aspect_ratios=(2.0,), flip=True)
    assert spec.boxes_per_cell() == 4
    priors = tpb.generate_priors([spec], 300)
    assert priors.shape == (16, 4)
    np.testing.assert_allclose(priors[0], [0.15, 0.15, 0.35, 0.35], atol=1e-6)
    s = np.sqrt(60 * 120) / 300 / 2
    np.testing.assert_allclose(priors[1], [0.25 - s, 0.25 - s, 0.25 + s,
                                           0.25 + s], atol=1e-6)
    assert tssd.SSD_VGG16_300.num_priors == 8732   # the canonical SSD300
    for name in ("SSD_VGG16_300", "SSD_VGG16_512", "SSD_MOBILENET_300",
                 "SSD_TINY_64"):
        t, j = getattr(tssd, name), getattr(jssd, name)
        assert t.num_priors == j.num_priors
        np.testing.assert_array_equal(t.priors(), j.priors())


def _toy_loss_setup(mod):
    lo = np.array([[0.0, 0.0], [0.3, 0.3], [0.6, 0.6], [0.1, 0.5]],
                  np.float32)
    priors = np.concatenate([lo, lo + 0.25], -1)
    loss = mod.MultiBoxLoss(priors, num_classes=3, neg_pos_ratio=1.0)
    y_true = np.zeros((1, 2, 5), np.float32)
    y_true[0, 0] = [2, 0.0, 0.0, 0.25, 0.25]
    return loss, priors, y_true


def test_multibox_loss_perfect_prediction_is_small():
    loss, _, y_true = _toy_loss_setup(tloss)
    y_pred = np.zeros((1, 4, 7), np.float32)
    y_pred[0, :, 4] = 8.0          # background everywhere...
    y_pred[0, 0, 4] = 0.0
    y_pred[0, 0, 6] = 8.0          # ...except prior 0 -> class 2
    assert float(loss(_t(y_true), _t(y_pred))) < 0.01
    y_bad = y_pred.copy()
    y_bad[0, 0, 6] = 0.0
    y_bad[0, 0, 5] = 8.0
    assert float(loss(_t(y_true), _t(y_bad))) > 1.0


def test_multibox_loss_hard_negative_ratio():
    lo = np.linspace(0, 0.75, 8, dtype=np.float32)
    priors = np.stack([lo, lo, lo + 0.2, lo + 0.2], -1)
    y_true = np.zeros((1, 1, 5), np.float32)
    y_true[0, 0] = [1, 0.0, 0.0, 0.2, 0.2]       # matches prior 0 only
    y_pred = np.zeros((1, 8, 4 + 2), np.float32)
    v3 = float(tloss.MultiBoxLoss(priors, 2, neg_pos_ratio=3.0)(
        _t(y_true), _t(y_pred)))
    v0 = float(tloss.MultiBoxLoss(priors, 2, neg_pos_ratio=0.0)(
        _t(y_true), _t(y_pred)))
    # ratio 3 adds exactly 3 negative CE terms (uniform logits: ln2 each)
    assert v3 == pytest.approx(v0 + 3 * np.log(2.0), rel=1e-4)


def _tied_loss_case(seed):
    """SSD-tiny priors, 3 images of up to 4 boxes (one with none), conf
    logits from five bf16 values so that many priors share a background
    score, loc normal."""
    rng = np.random.default_rng(seed)
    priors = jpb.generate_priors(jssd.SSD_TINY_64.specs, 64)
    y_true = np.zeros((3, 4, 5), np.float32)
    for i, n in enumerate((3, 1)):
        y_true[i, :n, 0] = rng.integers(1, 4, n)
        y_true[i, :n, 1:] = _boxes(rng, n, 0.15, 0.4)
    y_pred = np.concatenate([
        rng.normal(0, 0.5, (3, 320, 4)),
        rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (3, 320, 4))], -1)
    y_pred = _t(y_pred.astype(np.float32)).bfloat16().float().numpy()
    return priors, y_true, y_pred


def _reversed_tie_ranks(score):
    """A sort that puts equal scores in descending index order: what an
    unstable sort may return."""
    n = score.shape[-1]
    order = n - 1 - torch.argsort(-score.flip(-1), dim=-1, stable=True)
    ar = torch.arange(n).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ar)


@pytest.mark.parametrize("seed", [0, 1])
def test_multibox_loss_and_gradient_match_jax_on_tied_logits(seed,
                                                             monkeypatch):
    priors, y_true, y_pred = _tied_loss_case(seed)
    jl = jloss.MultiBoxLoss(priors, 4)
    tl = tloss.MultiBoxLoss(priors, 4)
    jv, jg = jax.value_and_grad(lambda p: jl(jnp.asarray(y_true), p))(
        jnp.asarray(y_pred))
    jg = np.asarray(jg)

    def port_loss():
        p = _t(y_pred).requires_grad_()
        v = tl(_t(y_true), p)
        v.backward()
        return v.detach(), p.grad

    v, g = port_loss()
    assert all(len(np.unique(y_pred[i, :, 4:], axis=0)) < 320
               for i in range(3))  # tied rows
    assert abs(float(v) - float(jv)) <= LAYER_TOL * max(1.0, abs(float(jv)))
    _close(g, jg, LAYER_TOL)
    # the gradient lands on the mined negatives: with tied negatives in
    # another order it lands elsewhere (the value does not move: tied
    # negatives share their cross-entropy)
    monkeypatch.setattr(tloss, "descending_ranks", _reversed_tie_ranks)
    v2, g2 = port_loss()
    assert abs(float(v2) - float(jv)) <= LAYER_TOL * max(1.0, abs(float(jv)))
    assert np.abs(g2.numpy() - jg).max() > 1e-3


def test_detector_multibox_loss_binding():
    det = tdet.ObjectDetector("ssd-mobilenet-300x300", num_classes=3)
    loss = det.multibox_loss()
    p = det.model.ssd_config.num_priors
    y_true = np.zeros((1, 4, 5), np.float32)
    y_true[0, 0] = [1, 0.1, 0.1, 0.4, 0.4]
    val = float(loss(_t(y_true), torch.zeros(1, p, 7)))
    assert np.isfinite(val) and val > 0
    np.testing.assert_array_equal(loss.priors,
                                  tssd.SSD_MOBILENET_300.priors())


# ---------------------------------------------------------------------------
# The three layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    ("Reshape", ((6 * 6 * 2, 4),), (2, 6, 6, 8), {}),
    ("Reshape", ((-1, 3),), (2, 4, 3, 6), {}),
    ("AtrousConvolution2D", (5, 3, 3), (2, 19, 19, 4),
     dict(atrous_rate=(6, 6), border_mode="same", dim_ordering="tf")),
    ("AtrousConvolution2D", (5, 3, 2), (2, 4, 11, 9),
     dict(atrous_rate=(2, 3), border_mode="valid", dim_ordering="th")),
    ("UpSampling2D", (), (2, 5, 4, 3), dict(size=(2, 3), dim_ordering="tf")),
    ("UpSampling2D", (), (2, 3, 5, 4), dict(size=(2, 2), dim_ordering="th")),
], ids=lambda c: f"{c[0]}-{c[3].get('dim_ordering', '')}{c[2]}")
def test_detection_layers_match_jax(case):
    cls_name, args, shape, kw = case
    jl = getattr(jlayers, cls_name)(*args, **kw)
    tl = getattr(tlayers, cls_name)(*args, **kw)
    jl.ensure_built((None,) + shape[1:])
    tl.ensure_built((None,) + shape[1:])
    assert tl.output_shape == jl.output_shape
    rng = np.random.default_rng(7)
    params = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in jl.init_params(jax.random.PRNGKey(0)).items()}
    tparams = load_jax_params(tl, params)
    x = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(jl.call(params, x).shape).astype(np.float32)
    jy, (jgp, jgx) = jax.value_and_grad(
        lambda p, v: (jl.call(p, v) * g).sum(), argnums=(0, 1))(params, x)
    tp = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    tx = torch.tensor(x, requires_grad=True)
    y = tl.call(tp, tx)
    _close(y, jl.call(params, x), LAYER_TOL)
    assert tuple(y.shape[1:]) == tl.output_shape[1:]
    (y * torch.tensor(g)).sum().backward()
    _close(tx.grad, jgx, LAYER_TOL)
    for k in params:
        _close(tp[k].grad, jgp[k], LAYER_TOL)


def test_l2norm_matches_jax():
    jl, tl = jssd.L2Norm2D(name="n"), tssd.L2Norm2D(name="n")
    jl.ensure_built((None, 5, 5, 8))
    tl.ensure_built((None, 5, 5, 8))
    jp = jl.init_params(jax.random.PRNGKey(0))
    tp = tl.init_params(torch.Generator())
    np.testing.assert_array_equal(tp["gamma"].numpy(), np.asarray(jp["gamma"]))
    assert float(tp["gamma"][0]) == 20.0
    x = np.random.default_rng(8).standard_normal((2, 5, 5, 8)).astype(
        np.float32)
    _close(tl.call(tp, _t(x)), jl.call(jp, x), LAYER_TOL)
    y = tl.call({"gamma": tp["gamma"].bfloat16()}, _t(x).bfloat16())
    assert y.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The SSD graphs and the catalog
# ---------------------------------------------------------------------------


SSD_FORWARDS = {  # builder -> (num_classes, input, batch)
    "ssd_tiny": (4, (64, 64, 3), 2),
    "ssd_mobilenet_300": (4, (300, 300, 3), 1),
    "ssd_vgg16_300": (4, (300, 300, 3), 1),
}


@pytest.mark.parametrize("name", sorted(SSD_FORWARDS))
def test_ssd_forward_matches_jax(name):
    classes, shape, batch = SSD_FORWARDS[name]
    jnet = getattr(jssd, name)(num_classes=classes)
    tnet = getattr(tssd, name)(num_classes=classes)
    jshapes = _jax_shapes(jnet)
    assert _canonical(_port_shapes(tnet)) == _canonical(jshapes)
    assert tnet.compute_dtype == jnet.compute_dtype == "bfloat16"
    assert tnet.get_output_shape() == jnet.get_output_shape()
    jnet.compute_dtype = tnet.compute_dtype = None
    params = _seeded_tree(jshapes[0], 1)
    state = _seeded_tree(jshapes[1], 2)
    load_jax_params(tnet, params, state)
    x = np.random.default_rng(3).standard_normal((batch,) + shape).astype(
        np.float32)
    jy, _ = jax.jit(lambda p, s, v: jnet.apply(p, s, v))(params, state, x)
    ty, _ = tnet.apply(tnet.params, tnet.model_state, _t(x))
    jy = np.asarray(jy)
    assert jy.shape == (batch, jnet.ssd_config.num_priors, 4 + classes)
    assert np.abs(jy).max() > 1e-2
    _close(ty, jy, NET_TOL)


# parameter counts of the catalog at full width (21 classes), counted from
# the JAX package's trees
CATALOG_PARAMS = {
    "ssd-vgg16-300x300": 26285486, "ssd-vgg16-512x512": 26959300,
    "ssd-mobilenet-300x300": 9048516, "ssd-tiny-64x64": 307368,
    "frcnn-vgg16": 137073622, "frcnn-pvanet": 122797254,
}


@pytest.mark.parametrize("name", sorted(CATALOG_PARAMS))
def test_catalog_full_width_trees_match_jax(name):
    assert set(tdet._CATALOG) == set(jdet._CATALOG) == set(CATALOG_PARAMS)
    tnet = tdet.ObjectDetector(name).model
    jnet = jdet._CATALOG[name][0](num_classes=21)
    jshapes = _jax_shapes(jnet)
    assert _canonical(_port_shapes(tnet)) == _canonical(jshapes)
    assert tnet.name == jnet.name
    assert tnet.get_input_shape() == jnet.get_input_shape()
    assert tnet.get_output_shape() == jnet.get_output_shape()
    n = sum(int(np.prod(s)) for v in jshapes[0].values() for s in v.values())
    assert n == CATALOG_PARAMS[name]
    assert sum(int(np.prod(s.shape)) for v in tnet.param_specs().values()
               for s in v.values()) == n
    assert vars(tdet._CATALOG[name][1]) == vars(jdet._CATALOG[name][1])
    # the JAX tree fills every leaf (the atrous fc6 in HWIO, L2Norm's gamma,
    # Faster-RCNN's 25088 x 4096 fc6, the unnamed BNs by order): each JAX
    # leaf a constant of its own, found again in the port's leaf of the
    # same canonical name
    values = iter(range(1, 10 ** 6))
    tree = {k: {m: np.full(s, next(values), np.float32)
                for m, s in sorted(v.items())}
            for k, v in sorted(jshapes[0].items())}
    filled = load_jax_params(tnet, tree)
    jname = {c: k for k, c in _canonical_names(tree).items()}
    for k, c in _canonical_names(filled).items():
        for m, t in filled[k].items():
            assert tuple(t.shape) == tree[jname[c]][m].shape
            assert float(t.reshape(-1)[0]) == tree[jname[c]][m].flat[0], (k, m)
    del tree, filled, tnet


# ---------------------------------------------------------------------------
# ObjectDetector end to end
# ---------------------------------------------------------------------------


def _detector_pair(name, num_classes, cfg_kw, seed, scale=1.0):
    """The same detector in both packages, f32, one set of seeded weights
    (moving statistics at their initial values on both sides)."""
    jcfg = jdet.ObjectDetectionConfig(**cfg_kw)
    tcfg = tdet.ObjectDetectionConfig(**cfg_kw)
    jd = jdet.ObjectDetector(name, num_classes=num_classes, config=jcfg)
    td = tdet.ObjectDetector(name, num_classes=num_classes, config=tcfg)
    jd.model.compute_dtype = td.model.compute_dtype = None
    params = _seeded_tree(_jax_shapes(jd.model)[0], seed, scale)
    jd.model.set_weights(params)
    load_jax_params(td.model, params)
    return jd, td


def _assert_same_detections(got, want):
    """The same detections per image: each of JAX's has one of the port's
    with its class, its box within BOX_TOL and its score within NET_TOL
    (matched greedily, so two detections whose scores tie within rounding
    may come in either order)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g["scores"]) == len(w["scores"])
        assert sorted(g["labels"]) == sorted(w["labels"])
        scale = max([1.0] + [float(np.abs(w["boxes"]).max())] * bool(
            len(w["boxes"])))
        free = list(range(len(g["scores"])))
        for j in range(len(w["scores"])):
            hit = [i for i in free if g["classes"][i] == w["classes"][j]
                   and abs(g["scores"][i] - w["scores"][j]) <= NET_TOL
                   and np.abs(g["boxes"][i] - w["boxes"][j]).max()
                   <= BOX_TOL * scale]
            assert hit, (j, w["classes"][j], w["scores"][j], w["boxes"][j])
            free.remove(hit[0])
        assert (np.diff(g["scores"]) <= 0).all()


def test_predict_detections_matches_jax():
    kw = dict(model_name="ssd-mobilenet-300x300", img_size=300,
              num_classes=3, mean=(127.5, 127.5, 127.5), scale=1 / 127.5,
              score_threshold=0.0, max_per_class=8, max_total=10)
    jd, td = _detector_pair("ssd-mobilenet-300x300", 3, kw, 11, scale=2.0)
    imgs = np.random.default_rng(0).integers(0, 255, (2, 300, 300, 3)).astype(
        np.uint8)
    sizes = [(640, 480), (300, 300)]
    want = jd.predict_detections(imgs, original_sizes=sizes)
    got = td.predict_detections(imgs, original_sizes=sizes)
    assert sum(len(w["scores"]) for w in want) > 5
    _assert_same_detections(got, want)
    assert got[0]["boxes"][:, 2].max() <= 640 + 1e-3
    # two predict buckets and one post-process program per batch shape
    im = td.inference_model()
    assert im.cache_stats["misses"] == 2
    td.predict_detections(imgs[:1], batch_size=1)
    assert im.cache_stats["misses"] == 4 and td.inference_model() is im
    # after new weights the detector serves them
    load_jax_params(td.model, _seeded_tree(_jax_shapes(jd.model)[0], 12))
    assert td.inference_model() is not im
    # the visualizer runs on them
    img = tdet.Visualizer(threshold=0.0).visualize(imgs[0], got[1])
    np.testing.assert_array_equal(
        img, jdet.Visualizer(threshold=0.0).visualize(imgs[0], want[1]))


def test_frcnn_roi_align_linear_ramp_and_jax():
    """Bilinear RoI-align reproduces a linear function exactly, and equals
    the JAX package's at RoIs crossing every border."""
    cfg = tfr.FrcnnConfig(img_size=160, roi_size=4)
    fn = tfr._roi_align(cfg)
    hf = wf = 10
    ys, xs = np.meshgrid(np.arange(hf), np.arange(wf), indexing="ij")
    feat = (2.0 * xs + 3.0 * ys).astype(np.float32)[None, :, :, None]
    rois = np.array([[[0.2, 0.1, 0.8, 0.7, 1.0]]], np.float32)
    out = fn(_t(feat), _t(rois)).numpy()[0, 0, :, :, 0]
    r = cfg.roi_size
    gy = (0.1 + (np.arange(r) + 0.5) / r * 0.6) * hf - 0.5
    gx = (0.2 + (np.arange(r) + 0.5) / r * 0.6) * wf - 0.5
    np.testing.assert_allclose(out, 2.0 * gx[None, :] + 3.0 * gy[:, None],
                               rtol=1e-5, atol=1e-5)
    rng = np.random.default_rng(9)
    feat = rng.standard_normal((2, 10, 10, 3)).astype(np.float32)
    corner = rng.uniform(-0.2, 0.9, (2, 5, 2))
    rois = np.concatenate([corner, corner + rng.uniform(0, 0.5, (2, 5, 2)),
                           np.ones((2, 5, 1))], -1).astype(np.float32)
    want = jfr._roi_align(jfr.FrcnnConfig(img_size=160, roi_size=4))(
        jnp.asarray(feat), jnp.asarray(rois))
    _close(fn(_t(feat), _t(rois)), want, LAYER_TOL)


@pytest.mark.parametrize("tied", [False, True])
def test_frcnn_proposals_match_jax(tied):
    """The hottest anchor surfaces first (zero deltas: the RoI is its
    clipped anchor box), and the proposals equal the JAX package's,
    including objectness ties in the top-k."""
    cfg = tfr.FrcnnConfig(img_size=160, pre_nms_top_n=50, post_nms_top_n=8)
    f, a = cfg.feat_size, cfg.num_anchors
    obj = np.full((1, f, f, a), -9.0, np.float32)
    hot = (4, 6, 2)
    obj[0, hot[0], hot[1], hot[2]] = 9.0
    rois = tfr._proposals(cfg)(_t(obj), torch.zeros(1, f, f, 4 * a)).numpy()
    expect = np.clip(cfg.anchors().reshape(f, f, a, 4)[hot], 0.0, 1.0)
    np.testing.assert_allclose(rois[0, 0, :4], expect, rtol=1e-5, atol=1e-5)
    assert rois[0, 0, 4] == rois[0].max(axis=0)[4]
    rng = np.random.default_rng(10)
    obj = rng.uniform(size=(2, f, f, a)).astype(np.float32)
    if tied:
        obj = np.round(obj * 6) / 6
    deltas = (rng.standard_normal((2, f, f, 4 * a)) * 0.2).astype(np.float32)
    want = jfr._proposals(cfg)(jnp.asarray(obj), jnp.asarray(deltas))
    _close(tfr._proposals(cfg)(_t(obj), _t(deltas)), want, LAYER_TOL)


@pytest.mark.parametrize("name,small,det_kw,classes,seed", [
    ("frcnn-vgg16", dict(img_size=160, pre_nms_top_n=100, post_nms_top_n=16,
                         fc_dim=32), dict(max_per_class=5, max_total=10), 4,
     0),
    ("frcnn-pvanet", dict(img_size=160, pre_nms_top_n=64, post_nms_top_n=8,
                          fc_dim=32), dict(max_per_class=4, max_total=8), 3,
     1),
])
def test_frcnn_end_to_end_matches_jax(name, small, det_kw, classes, seed,
                                      monkeypatch):
    """Both Faster-RCNN catalog entries, shrunk as the JAX tests shrink
    them, through predict_detections on the same weights: the packed
    forward within NET_TOL, then the same detections."""
    builders = {"frcnn-vgg16": "frcnn_vgg16", "frcnn-pvanet": "frcnn_pvanet"}
    for mod, det_mod in ((jfr, jdet), (tfr, tdet)):
        cfg = mod.FrcnnConfig(**small)
        build = getattr(mod, builders[name])
        monkeypatch.setitem(det_mod._CATALOG, name, (
            lambda num_classes=21, img_size=160, b=build, c=cfg: b(
                num_classes=num_classes, config=c),
            det_mod.ObjectDetectionConfig(name, 160, **det_kw)))
    kw = dict(model_name=name, img_size=160, **det_kw)
    # small weights: the RPN's objectness and the boxes stay well inside
    # f32 range (at the JAX tests' init the deltas overflow exp into NaN)
    jd, td = _detector_pair(name, classes, kw, seed + 20, scale=0.1)
    imgs = np.random.default_rng(seed).random((2, 160, 160, 3)) * 255
    x = jd.det_config.preprocess(imgs)
    jraw = jd.model.predict(x, batch_size=2)
    traw = td.inference_model().do_predict(x)
    _close(traw, jraw, NET_TOL)
    want = jd.predict_detections(imgs, batch_size=2)
    got = td.predict_detections(imgs, batch_size=2)
    assert sum(len(w["scores"]) for w in want) > 0
    _assert_same_detections(got, want)
    for d in got:
        assert len(d["boxes"]) == len(d["scores"]) == len(d["classes"])
        assert d["classes"].min() >= 1


# Under bf16 compute the two packages' class scores and box deltas agree
# within this bound (the largest class score is about 0.3): the backbone and
# RPN round alike, and the RoI head runs in float32 on both sides (the
# float32 bilinear weights promote the bf16 features, and each Dense its
# bf16 kernel). A head run in bf16 is 3.9e-4 off.
FRCNN_BF16_TOL = 1e-5


@pytest.mark.parametrize("name,small,classes,seed", [
    ("frcnn-vgg16", dict(img_size=160, pre_nms_top_n=100, post_nms_top_n=16,
                         fc_dim=32), 4, 0),
    ("frcnn-pvanet", dict(img_size=160, pre_nms_top_n=64, post_nms_top_n=8,
                          fc_dim=32), 3, 1),
])
def test_frcnn_bf16_head_matches_jax(name, small, classes, seed,
                                     monkeypatch):
    """The served dtype: both Faster-RCNN entries at bf16 compute (shrunk
    as in test_frcnn_end_to_end_matches_jax), the port's InferenceModel
    against the JAX package's predict on the same weights: class scores
    and box deltas within FRCNN_BF16_TOL, the packed output float32."""
    builders = {"frcnn-vgg16": "frcnn_vgg16", "frcnn-pvanet": "frcnn_pvanet"}
    for mod, det_mod in ((jfr, jdet), (tfr, tdet)):
        cfg = mod.FrcnnConfig(**small)
        build = getattr(mod, builders[name])
        monkeypatch.setitem(det_mod._CATALOG, name, (
            lambda num_classes=21, img_size=160, b=build, c=cfg: b(
                num_classes=num_classes, config=c),
            det_mod.ObjectDetectionConfig(name, 160)))
    jd, td = _detector_pair(name, classes, dict(model_name=name,
                                                img_size=160),
                            seed + 20, scale=0.1)
    jd.model.compute_dtype = td.model.compute_dtype = "bfloat16"
    imgs = np.random.default_rng(seed).random((2, 160, 160, 3)) * 255
    x = jd.det_config.preprocess(imgs)
    jraw = np.asarray(jd.model.predict(x, batch_size=2))
    traw = td.inference_model().do_predict(x)
    assert traw.dtype == np.float32
    c = classes
    assert np.abs(traw[..., :c] - jraw[..., :c]).max() <= FRCNN_BF16_TOL
    assert (np.abs(traw[..., c:5 * c] - jraw[..., c:5 * c]).max()
            <= FRCNN_BF16_TOL)


def test_multibox_loss_priors_is_the_float32_array():
    """C4: ``MultiBoxLoss.priors`` is the float32 array, as in the JAX
    package; the per-device tensor is ``priors_on``."""
    priors = tssd.SSD_TINY_64.priors()
    want = jloss.MultiBoxLoss(jssd.SSD_TINY_64.priors(), 4).priors
    loss = tloss.MultiBoxLoss(priors.astype(np.float64), 4)
    assert isinstance(loss.priors, np.ndarray)
    assert loss.priors.dtype == np.float32
    np.testing.assert_array_equal(loss.priors, np.asarray(want))
    on = loss.priors_on(torch.device("cpu"))
    assert on.dtype == torch.float32
    assert loss.priors_on("cpu") is on
    np.testing.assert_array_equal(on.numpy(), loss.priors)


def test_object_detector_save_load_and_left_out(tmp_path):
    det = tdet.ObjectDetector("ssd-tiny-64x64", num_classes=3)
    assert det.config() == jdet.ObjectDetector("ssd-tiny-64x64",
                                               num_classes=3).config()
    det.model.compute_dtype = None
    imgs = np.random.default_rng(13).integers(0, 255, (3, 64, 64, 3))
    want = det.predict_detections(imgs, score_threshold=0.0)
    path = str(tmp_path / "det")
    det.save_model(path)
    back = ZooModel.load_model(path)
    assert isinstance(back, tdet.ObjectDetector)
    assert back.config() == json.loads(json.dumps(det.config()))
    back.model.compute_dtype = None
    _assert_same_detections(back.predict_detections(imgs, score_threshold=0.0),
                            want)
    det.model.save_weights(str(tmp_path / "w"))
    again = tdet.ObjectDetector("ssd-tiny-64x64", num_classes=3,
                                weights=str(tmp_path / "w"))
    again.model.compute_dtype = None
    _assert_same_detections(again.predict_detections(imgs,
                                                     score_threshold=0.0),
                            want)
    with pytest.raises(NotImplementedError, match="A6"):
        tdet.ObjectDetector("ssd-tiny-64x64", weights="w.h5")
    with pytest.raises(ValueError, match="Unknown detector"):
        tdet.ObjectDetector("ssd-vgg19")


# ---------------------------------------------------------------------------
# Evaluators, label maps, visualizers
# ---------------------------------------------------------------------------


def test_map_cases_match_the_jax_tests():
    m = tev.MeanAveragePrecision(num_classes=3)
    gt = np.array([[0, 0, 10, 10], [20, 20, 30, 30]], np.float32)
    m.add(gt, np.array([0.9, 0.8]), np.array([1, 2]), gt, np.array([1, 2]))
    assert m.result()["mAP"] == pytest.approx(1.0)
    m = tev.MeanAveragePrecision(num_classes=2, use_07_metric=False)
    m.add(np.array([[0, 0, 10, 10], [100, 100, 110, 110], [50, 50, 60, 60]],
                   np.float32), np.array([0.9, 0.8, 0.7]), np.array([1, 1, 1]),
          np.array([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32),
          np.array([1, 1]))
    assert m.result()["mAP"] == pytest.approx(0.5 + 0.5 * 2 / 3, abs=1e-6)
    res = tev.PascalVocEvaluator(num_classes=2).evaluate(
        [{"boxes": np.array([[0, 0, 10, 10]], np.float32),
          "scores": np.array([0.9]), "classes": np.array([1])}],
        [{"boxes": np.array([[0, 0, 10, 10], [50, 50, 60, 60]], np.float32),
          "classes": np.array([1, 1]), "difficult": np.array([False, True])}])
    assert res["mAP"] == pytest.approx(1.0)
    ev = tev.CocoEvaluator(num_classes=2)
    r = ev.evaluate([{"boxes": np.array([[5, 0, 35, 10.]]),
                      "scores": np.array([0.9]), "classes": np.array([1])}],
                    [{"boxes": np.array([[0, 0, 30, 10.]]),
                      "classes": np.array([1])}])
    assert r["AP50"] == 1.0 and r["AP75"] == 0.0
    np.testing.assert_allclose(r["mAP"], 0.5)
    r = tev.CocoEvaluator(num_classes=2).evaluate(
        [{"boxes": np.array([[0, 0, 10, 10], [50, 50, 90, 90.]]),
          "scores": np.array([0.9, 0.7]), "classes": np.array([1, 1])}],
        [{"boxes": np.array([[0, 0, 10, 10], [50, 50, 90, 90.]]),
          "classes": np.array([1, 1]), "crowd": np.array([False, True])}])
    assert r["mAP"] == 1.0


@pytest.mark.parametrize("interp", [None, "11point", "101point", "area"])
def test_evaluators_match_jax_on_random_detections(interp):
    rng = np.random.default_rng(14)
    dets, gts = [], []
    for _ in range(6):
        n, g = int(rng.integers(0, 9)), int(rng.integers(1, 5))
        gb = _boxes(rng, g, 0.1, 0.4) * 100
        db = np.concatenate([gb + rng.normal(0, 3, gb.shape),
                             _boxes(rng, n, 0.1, 0.4) * 100])
        dets.append({"boxes": db.astype(np.float32),
                     "scores": np.round(rng.uniform(size=len(db)), 1),
                     "classes": rng.integers(1, 4, len(db))})
        gts.append({"boxes": gb, "classes": rng.integers(1, 4, g),
                    "difficult": rng.uniform(size=g) < 0.2,
                    "crowd": rng.uniform(size=g) < 0.2})
    for thr in (0.3, 0.5):
        t = tev.MeanAveragePrecision(4, thr, interpolation=interp)
        j = jev.MeanAveragePrecision(4, thr, interpolation=interp)
        for d, g in zip(dets, gts):
            for m in (t, j):
                m.add(d["boxes"], d["scores"], d["classes"], g["boxes"],
                      g["classes"], g["difficult"])
        assert t.result() == j.result()
    assert tev.PascalVocEvaluator(4).evaluate(dets, gts) == \
        jev.PascalVocEvaluator(4).evaluate(dets, gts)
    assert tev.CocoEvaluator(4).evaluate(dets, gts) == \
        jev.CocoEvaluator(4).evaluate(dets, gts)


def test_label_maps_and_visualize_detections_match_jax():
    assert tvis.COCO_CLASSES == jvis.COCO_CLASSES
    assert tdet.PASCAL_CLASSES == jdet.PASCAL_CLASSES
    for key in ("pascal", "COCO"):
        assert tvis.LabelReader(key) == jvis.LabelReader(key)
    with pytest.raises(ValueError, match="pascal and coco"):
        tvis.LabelReader("imagenet")
    img = np.random.default_rng(15).integers(0, 255, (40, 60, 3)).astype(
        np.uint8)
    rois = np.array([[1, 0.9, 5, 5, 30, 20], [7, 0.1, 1, 1, 9, 9],
                     [15, 0.5, 10, 12, 50, 38]], np.float32)
    t = tvis.VisualizeDetections(thresh=0.3)(ImageFeature(image=img.copy(),
                                                          predict=rois))
    from analytics_zoo_tpu.data.image_set import ImageFeature as JFeature

    j = jvis.VisualizeDetections(thresh=0.3)(JFeature(image=img.copy(),
                                                      predict=rois))
    np.testing.assert_array_equal(t["visualized"], j["visualized"])
    assert (t["visualized"] != img).any()
    with pytest.raises(ValueError, match="rois must be"):
        tvis.VisualizeDetections()(ImageFeature(image=img,
                                                predict=rois[:, :4]))


def test_postprocess_program_keeps_its_float32_input():
    """A bf16 detector's post-process program takes the forward's float32
    output as it is (``compile_program(cast=False)``): a Faster-RCNN's
    packed RoI coordinates would lose bits in bf16. Its output equals the
    post-process function's on the same tensor."""
    det = tdet.ObjectDetector("ssd-tiny-64x64", num_classes=3)
    assert det.model.compute_dtype == "bfloat16"
    x = det.det_config.preprocess(np.random.default_rng(16).integers(
        0, 255, (2, 64, 64, 3)))
    raw = det.inference_model().do_dispatch(x)
    assert raw.dtype == torch.float32
    seen = []
    post = det.postprocess_fn()
    prog, params, state = det.inference_model().compile_program(
        "dtype_probe", lambda p, s, r: (seen.append(r.dtype), post(r))[1],
        (raw,), cast=False)
    out = prog(params, state, raw)
    assert seen[-1] == torch.float32
    for got, want in zip(out, post(raw)):
        assert torch.equal(got, want)
    prog, params, state = det.postprocess_program(raw)
    for got, want in zip(prog(params, state, raw), det.detect_raw(x)):
        assert torch.equal(got, want)
