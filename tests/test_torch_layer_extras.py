"""The port's ``keras.layers.extras`` against the JAX package's, layer by
layer, with the harness of ``test_torch_layer_library.py``: the same
seeded numpy input and weights (normal draws in the JAX layer's weight
shapes, carried over by ``interop.load_jax_params``) through both; the
forward values, the input and weight gradients against ``jax.vjp``, and
the declared output shape. Layers with both dim orderings run in both.

The traps: ``ResizeBilinear`` growing, shrinking and both at once
(``jax.image.resize`` antialiases when it shrinks, ``F.interpolate``
does not unless asked) and its explicit corner-aligned path (whose
float32 grid makes a bf16 input float32, as in JAX); ``LRN2D`` with
JAX's channel window (``n // 2`` before, the rest after) and ``alpha /
n``, at odd and even ``n``; ``LocallyConnected2D``'s patch order
(``lax.conv_general_dilated_patches`` against ``F.unfold``); the random
layers (``RReLU``, ``GaussianSampler``) in inference mode.

Tolerance: f32, ``rtol = atol = 1e-5`` (see the library test).
"""

import pytest

from test_torch_layer_library import _check, _img, _orders
from test_torch_layer_library import _port_context  # noqa: F401 (fixture)

CASES = [
    # -- elementwise, thresholds, affine, shape --------------------------------
    ("identity", lambda L: L.Identity(), (3, 4), "normal"),
    ("exp", lambda L: L.Exp(), (3, 4), "normal"),
    ("log", lambda L: L.Log(), (3, 4), "pos"),
    ("sqrt", lambda L: L.Sqrt(), (3, 4), "pos"),
    ("square", lambda L: L.Square(), (3, 4), "normal"),
    ("negative", lambda L: L.Negative(), (3, 4), "normal"),
    ("add-constant", lambda L: L.AddConstant(1.5), (3, 4), "normal"),
    ("mul-constant", lambda L: L.MulConstant(-2.5), (3, 4), "normal"),
    ("power", lambda L: L.Power(2.5, scale=0.5, shift=1.0), (3, 4), "pos"),
    ("softmax", lambda L: L.Softmax(), (3, 4), "normal"),
    ("hard-tanh", lambda L: L.HardTanh(-0.5, 0.8), (3, 4), "normal"),
    ("hard-shrink", lambda L: L.HardShrink(0.4), (3, 4), "normal"),
    ("soft-shrink", lambda L: L.SoftShrink(0.4), (3, 4), "normal"),
    ("threshold", lambda L: L.Threshold(0.2, -1.0), (3, 4), "normal"),
    ("binary-threshold", lambda L: L.BinaryThreshold(0.1), (3, 4),
     "normal"),
    ("rrelu-eval", lambda L: L.RReLU(), (3, 4), "normal"),
    ("max", lambda L: L.Max(2), (3, 4), "normal"),
    ("cmul", lambda L: L.CMul((1, 3, 1)), (3, 4), "normal"),
    ("cadd", lambda L: L.CAdd((1, 1, 4)), (3, 4), "normal"),
    ("mul", lambda L: L.Mul(), (3, 4), "normal"),
    ("scale", lambda L: L.Scale((1, 3, 4)), (3, 4), "normal"),
    ("expand", lambda L: L.Expand((3, 4)), (1, 4), "normal"),
    ("get-shape", lambda L: L.GetShape(), (3, 4), "normal"),
    ("select-table", lambda L: L.SelectTable(1), [(3,), (4,)], "normal"),
    ("gaussian-sampler-eval", lambda L: L.GaussianSampler(), [(4,), (4,)],
     "normal"),
    ("cropping3d", lambda L: L.Cropping3D(((1, 0), (0, 2), (1, 1))),
     (2, 4, 5, 4), "normal"),
    ("atrous-conv1d", lambda L: L.AtrousConvolution1D(
        3, 3, atrous_rate=2, border_mode="same"), (9, 2), "normal"),
    ("share-conv2d", lambda L: L.ShareConvolution2D(3, 3, 3),
     (2, 6, 6), "normal"),
    ("sparse-dense", lambda L: L.SparseDense(3), (5,), "normal"),
    ("sparse-embedding", lambda L: L.SparseEmbedding(10, 4), (3,),
     "int10"),
    ("compute-mask-pad", lambda L: L.ComputeMask(pad_value=0), (6,),
     "int3"),
    ("compute-mask-value", lambda L: L.ComputeMask(mask_value=0.0),
     (5, 3), "masked"),
]

ORDERED = _orders([
    ("resize-bilinear-grow", lambda L, o: L.ResizeBilinear(
        9, 7, dim_ordering=o), _img(2, 4, 5), "normal"),
    ("resize-bilinear-shrink", lambda L, o: L.ResizeBilinear(
        3, 4, dim_ordering=o), _img(2, 8, 9), "normal"),
    ("resize-bilinear-mixed", lambda L, o: L.ResizeBilinear(
        10, 3, dim_ordering=o), _img(2, 4, 7), "normal"),
    ("resize-bilinear-corners", lambda L, o: L.ResizeBilinear(
        7, 3, align_corners=True, dim_ordering=o), _img(2, 4, 6),
     "normal"),
    ("resize-bilinear-corners-one", lambda L, o: L.ResizeBilinear(
        1, 5, align_corners=True, dim_ordering=o), _img(2, 4, 3),
     "normal"),
    ("lrn2d", lambda L, o: L.LRN2D(alpha=0.5, k=1.5, beta=0.75, n=3,
                                   dim_ordering=o), _img(6, 3, 4),
     "normal"),
    ("lrn2d-even-n", lambda L, o: L.LRN2D(alpha=1.0, n=4, dim_ordering=o),
     _img(5, 3, 3), "normal"),
    ("locally-connected2d", lambda L, o: L.LocallyConnected2D(
        3, 2, 3, dim_ordering=o, activation="tanh"), _img(2, 5, 6),
     "normal"),
    ("locally-connected2d-stride", lambda L, o: L.LocallyConnected2D(
        2, 3, 2, subsample=(2, 1), dim_ordering=o, bias=False),
     _img(3, 7, 5), "normal"),
])


@pytest.mark.parametrize("make,shape,kind", [
    pytest.param(m, s, k, id=c) for c, m, s, k in CASES] + ORDERED)
def test_extras_layer_matches_jax(make, shape, kind):
    _check(make, shape, kind)
