"""Serialization sweep over the port's whole layer library (the JAX
package's ``tests/test_serialization_sweep.py`` with its imports pointed
at the port) — the SerializerSpec
analogue (SURVEY.md §4-3: the reference auto-enumerates all layer classes
and asserts save -> load -> forward equality, with an excluded-set pattern
so every NEW layer must either join the sweep or be consciously excluded).

For each constructible layer: build a model around it, run a forward pass,
save_weights, rebuild the same architecture fresh (different random init),
load_weights, and assert the forward output is bit-identical. Catches
weight-naming drift, shape-spec drift, and stateful-layer restore bugs
across the entire library at once.
"""

import numpy as np
import pytest

import torch

import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as L
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential


@pytest.fixture(autouse=True)
def _ctx():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()


# layer name -> (constructor kwargs, input_shape (no batch), extra leading
# layers needed). Shapes are small but exercise each op's real geometry.
SEQ8 = (6, 8)        # (steps, features) for recurrent/1D layers
IMG = (8, 8, 3)      # NHWC for "tf"-ordered 2D layers
VOL = (4, 6, 6, 2)   # NDHWC for 3D layers

SPECS = {
    "Activation": (dict(activation="tanh"), (8,)),
    "AddConstant": (dict(constant=1.5), (8,)),
    "AtrousConvolution1D": (dict(nb_filter=4, filter_length=3, atrous_rate=2), SEQ8),
    "AtrousConvolution2D": (dict(nb_filter=4, nb_row=3, nb_col=3,
                                 atrous_rate=(2, 2), dim_ordering="tf"), IMG),
    "AveragePooling1D": (dict(pool_length=2), SEQ8),
    "AveragePooling2D": (dict(pool_size=(2, 2), dim_ordering="tf"), IMG),
    "AveragePooling3D": (dict(pool_size=(2, 2, 2), dim_ordering="tf"), VOL),
    "BatchNormalization": (dict(), (8,)),
    "BinaryThreshold": (dict(value=0.1), (8,)),
    "CAdd": (dict(size=(1, 8)), (8,)),
    "CMul": (dict(size=(1, 8)), (8,)),
    "CRF": (dict(num_tags=5), (6, 5)),
    "Convolution1D": (dict(nb_filter=4, filter_length=3), SEQ8),
    "Convolution2D": (dict(nb_filter=4, nb_row=3, nb_col=3,
                           dim_ordering="tf"), IMG),
    "Convolution3D": (dict(nb_filter=4, kernel_dim1=2, kernel_dim2=2,
                           kernel_dim3=2, dim_ordering="tf"), VOL),
    "ConvLSTM2D": (dict(nb_filter=4, nb_kernel=3), (3, 2, 6, 6)),  # NCHW
    "Cropping1D": (dict(cropping=(1, 1)), SEQ8),
    "Cropping2D": (dict(cropping=((1, 1), (1, 1)), dim_ordering="tf"), IMG),
    "Cropping3D": (dict(cropping=((1, 1), (1, 1), (0, 0))), (2, 4, 6, 6)),  # NCDHW
    "Deconvolution2D": (dict(nb_filter=4, nb_row=3, nb_col=3), (3, 8, 8)),
    "ComputeMask": (dict(mask_value=0.0), SEQ8),
    "Dense": (dict(output_dim=5, activation="relu"), (8,)),
    "MoE": (dict(n_experts=4, hidden_dim=16), SEQ8),
    "DepthwiseConvolution2D": (dict(kernel_size=3, dim_ordering="tf"), IMG),
    "Dropout": (dict(p=0.3), (8,)),
    "ELU": (dict(), (8,)),
    "Embedding": (dict(input_dim=20, output_dim=6), (6,)),
    "Exp": (dict(), (8,)),
    "Expand": (dict(shape=(4, 8)), (1, 8)),
    "ExpandDim": (dict(dim=1), (8,)),
    "Flatten": (dict(), IMG),
    "GRU": (dict(output_dim=5, return_sequences=True), SEQ8),
    "GaussianDropout": (dict(p=0.3), (8,)),
    "GaussianNoise": (dict(sigma=0.2), (8,)),
    "GetShape": (dict(), (8,)),
    "GlobalAveragePooling1D": (dict(), SEQ8),
    "GlobalAveragePooling2D": (dict(dim_ordering="tf"), IMG),
    "GlobalAveragePooling3D": (dict(dim_ordering="tf"), VOL),
    "GlobalMaxPooling1D": (dict(), SEQ8),
    "GlobalMaxPooling2D": (dict(dim_ordering="tf"), IMG),
    "GlobalMaxPooling3D": (dict(dim_ordering="tf"), VOL),
    "HardShrink": (dict(), (8,)),
    "HardTanh": (dict(), (8,)),
    "Highway": (dict(), (8,)),
    "Identity": (dict(), (8,)),
    "LRN2D": (dict(dim_ordering="tf"), IMG),
    "LSTM": (dict(output_dim=5, return_sequences=True), SEQ8),
    "LayerNorm": (dict(), (8,)),
    "LeakyReLU": (dict(alpha=0.2), (8,)),
    "LocallyConnected1D": (dict(nb_filter=4, filter_length=3), SEQ8),
    "LocallyConnected2D": (dict(nb_filter=4, nb_row=3, nb_col=3,
                                dim_ordering="tf"), IMG),
    "Log": (dict(), (8,)),
    "Masking": (dict(mask_value=0.0), SEQ8),
    "Max": (dict(dim=1), (8,)),
    "MaxPooling1D": (dict(pool_length=2), SEQ8),
    "MaxPooling2D": (dict(pool_size=(2, 2), dim_ordering="tf"), IMG),
    "MaxPooling3D": (dict(pool_size=(2, 2, 2), dim_ordering="tf"), VOL),
    "MaxoutDense": (dict(output_dim=5), (8,)),
    "Mul": (dict(), (8,)),
    "MulConstant": (dict(constant=2.0), (8,)),
    "MultiHeadAttention": (dict(n_head=2), SEQ8),
    "Narrow": (dict(dim=1, offset=1, length=4), (8,)),
    "Negative": (dict(), (8,)),
    "PReLU": (dict(), (8,)),
    "Permute": (dict(dims=(2, 1)), SEQ8),
    "Power": (dict(power=2.0), (8,)),
    "RReLU": (dict(), (8,)),
    "RepeatVector": (dict(n=3), (8,)),
    "Reshape": (dict(target_shape=(4, 2)), (8,)),
    "ResizeBilinear": (dict(output_height=12, output_width=12,
                            dim_ordering="tf"), IMG),
    "SReLU": (dict(), (8,)),
    "Scale": (dict(size=(1, 8)), (8,)),
    "Select": (dict(dim=1, index=2), SEQ8),
    "SeparableConvolution2D": (dict(nb_filter=4, nb_row=3, nb_col=3,
                                    dim_ordering="tf"), IMG),
    "ShareConvolution2D": (dict(nb_filter=4, nb_row=3, nb_col=3), (3, 8, 8)),
    "SimpleRNN": (dict(output_dim=5, return_sequences=True), SEQ8),
    "SoftShrink": (dict(), (8,)),
    "Softmax": (dict(), (8,)),
    "SparseDense": (dict(output_dim=5), (8,)),
    "SpatialDropout1D": (dict(p=0.3), SEQ8),
    "SpatialDropout2D": (dict(p=0.3, dim_ordering="tf"), IMG),
    "SpatialDropout3D": (dict(p=0.3, dim_ordering="tf"), VOL),
    "Sqrt": (dict(), (8,)),
    "Square": (dict(), (8,)),
    "Squeeze": (dict(dim=1), (1, 8)),
    "Threshold": (dict(th=0.2), (8,)),
    "ThresholdedReLU": (dict(theta=0.3), (8,)),
    "TransformerBlock": (dict(n_head=2), SEQ8),
    "UpSampling1D": (dict(length=2), SEQ8),
    "UpSampling2D": (dict(size=(2, 2), dim_ordering="tf"), IMG),
    "UpSampling3D": (dict(size=(2, 2, 2), dim_ordering="tf"), VOL),
    "ZeroPadding1D": (dict(padding=1), SEQ8),
    "ZeroPadding2D": (dict(padding=(1, 1), dim_ordering="tf"), IMG),
    "ZeroPadding3D": (dict(padding=(1, 1, 1), dim_ordering="tf"), VOL),
}

# Consciously excluded (the reference's excluded-set pattern) — each with a
# reason; anything NOT here and NOT in SPECS fails test_sweep_is_exhaustive.
EXCLUDED = {
    "KerasLayer": "abstract base",
    "InputLayer": "placeholder, no forward of its own",
    "Input": "factory function (returns a Variable)",
    "Lambda": "wraps an arbitrary fn — covered by autograd tests",
    "Merge": "multi-input; covered by functional-graph tests",
    "SelectTable": "multi-input table op; covered by graph tests",
    "GaussianSampler": "two-input [mean, logvar]; covered by the VAE app",
    "Bidirectional": "wrapper; covered via test_golden_layers",
    "TimeDistributed": "wrapper; covered via test_golden_layers",
    "Conv1D": "alias of Convolution1D",
    "Conv2D": "alias of Convolution2D",
    "Conv3D": "alias of Convolution3D",
    "L1": "regularizer, not a layer",
    "L2": "regularizer, not a layer",
    "L1L2": "regularizer, not a layer",
    "WordEmbedding": "needs a pretrained-embedding file; covered in "
                     "test_layer_extras",
    "SparseEmbedding": "covered in test_layer_extras (sparse input)",
    "ConvLSTM3D": "covered by test_golden_layers (heavy; 5D scan)",
    "BERT": "4-input composite; covered by test_attention",
    "TransformerLayer": "composite; covered by test_attention",
    "WithinChannelLRN2D": "alias-style variant of LRN2D",
}

# The JAX package's exports that the port does not have yet: once one is
# ported, the exhaustiveness check below asks for its SPECS entry.
NOT_PORTED: dict = {}


def test_sweep_is_exhaustive():
    """Every public layer export is either swept or consciously excluded —
    a new layer cannot land without serialization coverage (the reference's
    SerializerSpecHelper excluded-set contract)."""
    exports = {n for n in dir(L) if n[0].isupper()}
    ported = exports & set(NOT_PORTED)
    assert not ported, f"now ported, so sweep them: {sorted(ported)}"
    unaccounted = exports - set(SPECS) - set(EXCLUDED)
    assert not unaccounted, (
        f"layers missing from the serialization sweep: {sorted(unaccounted)}"
        " — add a SPECS entry or an EXCLUDED reason")
    stale = (set(SPECS) | set(EXCLUDED)) - exports
    assert not stale, f"sweep entries for nonexistent layers: {sorted(stale)}"


def _build(name, kwargs, in_shape):
    reset_name_counts()
    cls = getattr(L, name)
    m = Sequential(name=f"sweep_{name.lower()}")
    m.add(cls(input_shape=in_shape, **kwargs))
    return m


@pytest.mark.parametrize("name", sorted(SPECS))
def test_save_load_forward_identical(name, tmp_path):
    import zlib

    kwargs, in_shape = SPECS[name]
    # stable per-layer seed: Python's hash() is randomized per process and
    # would make failures irreproducible across runs
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    x = rng.normal(size=(4,) + tuple(in_shape)).astype(np.float32)
    if name in ("Embedding",):
        x = rng.integers(0, 20, size=(4,) + tuple(in_shape)).astype(np.int32)
    if name in ("Log", "Sqrt"):
        x = np.abs(x) + 0.1  # domain

    m1 = _build(name, kwargs, in_shape)
    y1 = np.asarray(m1.predict(x, batch_size=4))
    path = str(tmp_path / f"{name}.npz")
    m1.save_weights(path)

    m2 = _build(name, kwargs, in_shape)
    # Perturb every param before loading: layers with deterministic
    # initializers (BN, CMul/CAdd/Scale, PReLU, LayerNorm...) would
    # otherwise match m1 bit-for-bit WITHOUT a restore, making the
    # save->load assertion vacuous — a silently-skipping load_weights
    # must turn the output different and fail here.
    w2 = m2.get_weights()
    if w2 and any(len(sub) for sub in w2.values()):
        m2.set_weights({
            lname: {k: torch.as_tensor(np.asarray(v) + 0.37)
                    for k, v in sub.items()}
            for lname, sub in w2.items()})
        y_perturbed = np.asarray(m2.predict(x, batch_size=4))
        assert not np.array_equal(y_perturbed, y1), (
            f"{name}: params do not influence the output — the roundtrip "
            "assertion below would be vacuous")
    m2.load_weights(path)
    y2 = np.asarray(m2.predict(x, batch_size=4))
    np.testing.assert_array_equal(y2, y1, err_msg=name)
