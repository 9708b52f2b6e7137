"""The dtype of every layer's output under bf16 compute in the int8
graphs, the port against the JAX package (the harness of
``test_torch_dtype_flow.py``: JAX under ``jax.eval_shape``, the port on
the meta device, each layer's output dtypes compared in graph order).

Calibrated graphs (a CNN, ResNet-50) and a weight-only BERT graph run with
the parameters as each package's ``InferenceModel`` serves them under
bf16 compute: calibrated qleafs whole (their integer layers return
float32 from their float32 rescale and the bf16 bias, so the batch norms
after them run in float32 by promotion), weight-only qleafs dequantized
and then cast to bf16.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch

import analytics_zoo_tpu.keras.layers as jl
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
from analytics_zoo_tpu.inference import calibration as jcalib
from analytics_zoo_tpu.inference import inference_model as jim_mod
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu.models.image import imageclassification as jic
from analytics_zoo_tpu_torch.common import tree as ttree
from analytics_zoo_tpu_torch.inference import calibration as tcalib
from analytics_zoo_tpu_torch.inference import inference_model as tim_mod
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.models.image import imageclassification as tic
from test_torch_dtype_flow import BATCH, FLOAT, INT, _image, _record


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _int8_cnn(m):
    net = m.topo.Sequential(name="int8_cnn")
    net.add(m.L.Convolution2D(8, (3, 3), activation="relu",
                              border_mode="same", dim_ordering="tf",
                              input_shape=(16, 16, 3)))
    net.add(m.L.MaxPooling2D((2, 2), dim_ordering="tf"))
    net.add(m.L.Flatten())
    net.add(m.L.Dense(32, activation="relu"))
    net.add(m.L.Dense(4, activation="softmax"))
    return net


INT8_GRAPHS = {
    "calibrated-cnn": (_int8_cnn, [((16, 16, 3), FLOAT)], "calibrate"),
    "calibrated-resnet-50": (lambda m: m.IC.build_model("resnet-50", 1000),
                             _image(224), "calibrate"),
    "quantized-bert": (
        lambda m: m.BERT(num_classes=2, vocab=100, hidden_size=32,
                         n_block=2, n_head=2, seq_len=16,
                         intermediate_size=64),
        [((16,), INT), ((16,), INT), ((16,), FLOAT)], "quantize"),
}


def _jax_int8_flow(net, inputs, kind):
    """JAX: the params as its InferenceModel serves them under bf16
    (``_get_executable``'s forward), the graph under ``jax.eval_shape``."""
    shapes, state = jax.eval_shape(net.init, jax.random.PRNGKey(0))
    if kind == "calibrate":
        scales = {l.name: 0.05 for l in net.layers()
                  if jcalib._quantizable(l)}
        shapes = jax.eval_shape(
            lambda p: jcalib.apply_calibration(net, p, scales), shapes)
    else:
        shapes = jax.eval_shape(
            lambda p: jax.tree_util.tree_map(jim_mod._quantize_leaf, p),
            shapes)

    def served(p):
        if kind == "quantize":
            p = jax.tree_util.tree_map(jim_mod._dequantize_leaf, p,
                                       is_leaf=jim_mod._is_qleaf)
        return jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16)
            if hasattr(a, "dtype") and a.dtype == jnp.float32 else a, p,
            is_leaf=jim_mod._is_qleaf)

    log = []
    _record(net.layers(), log)
    xs = [jax.ShapeDtypeStruct((BATCH,) + s, jnp.bfloat16 if k == FLOAT
                               else jnp.int32) for s, k in inputs]
    jax.eval_shape(
        lambda p, st, x: net.apply(served(p), st, x, training=False)[0],
        shapes, state, xs if len(xs) > 1 else xs[0])
    return log


def _port_int8_flow(net, inputs, kind):
    """The port: the params as its InferenceModel serves them under bf16
    (``_cast_params``, and the programs' per-call dequantize), on the meta
    device."""
    def f32(spec):
        if isinstance(spec, dict):
            return {k: f32(v) for k, v in spec.items()}
        return torch.empty(spec.shape, dtype=spec.dtype, device="meta")

    params = f32(net.param_specs())
    net.compute_dtype = "bfloat16"
    if kind == "calibrate":
        scales = {l.name: 0.05 for l in net.layers()
                  if tcalib._quantizable(l)}
        params = tim_mod._cast_params(
            tcalib.apply_calibration(net, params, scales), net)
    else:
        params = tim_mod._dequantize_params(
            tim_mod._cast_params(ttree.tree_map(tim_mod._quantize_leaf,
                                                params), net),
            torch.bfloat16)
    state = {l.name: {k: v.to("meta") for k, v in l.init_state().items()}
             for l in net.layers() if l.has_state}
    log = []
    _record(net.layers(), log)
    xs = [torch.empty((BATCH,) + s, device="meta",
                      dtype=torch.bfloat16 if k == FLOAT else torch.int64)
          for s, k in inputs]
    with torch.no_grad():
        net.apply(params, state, xs if len(xs) > 1 else xs[0],
                  training=False)
    return log


@pytest.mark.parametrize("graph", list(INT8_GRAPHS))
def test_int8_layer_output_dtypes_match_jax_under_bf16(graph):
    from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    build, inputs, kind = INT8_GRAPHS[graph]
    jm = SimpleNamespace(L=jl, topo=jtopo, IC=jic, BERT=JaxBERT)
    tm = SimpleNamespace(L=tl, topo=ttopo, IC=tic, BERT=BERTClassifierNet)
    jbase.reset_name_counts()
    reset_name_counts()
    want = _jax_int8_flow(build(jm), inputs, kind)
    got = _port_int8_flow(build(tm), inputs, kind)
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    if graph == "calibrated-resnet-50":
        # every batch norm follows an integer convolution: float32
        bns = [d for name, d in got if name == "BatchNormalization"]
        assert bns and all(d == ("float32",) for d in bns)
