"""Frozen TensorFlow graphs in the port (``tfnet``: the GraphDef reader,
``GraphFunction``, ``TFNet``, ``InferenceModel.do_load_tf``) against
TensorFlow and the JAX package, on the CPU.

The reader (``tfnet.graphdef``, on the in-repo wire codec) must agree with
``tf.compat.v1.GraphDef.ParseFromString`` node by node (op, inputs, every
attr) and constant by constant (bitwise) on TF-written graphs: a Keras CNN
frozen by the JAX package's ``freeze_keras_model``, a SavedModel freeze,
and a hand-encoded graph with ``half_val``, scalar-broadcast and unpacked
repeated fields. Its field numbers are checked against the installed
``tensorflow.core.framework`` descriptors. The op table runs TF-frozen
snippets against TF and the JAX package (within ``TOL`` of the largest
|value|, the JAX test's own bound against TF); ``chip_smoke.py``'s
``keras_graph_pb`` (phase 15b's frozen ResNet-50 writer) is shown to be a
real TF graph: it parses and runs under TF to the port's outputs.
"""

import struct
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
import chip_smoke as cs
from analytics_zoo_tpu import tfnet as jtfnet
from analytics_zoo_tpu_torch import tfnet as ttfnet
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.onnx import proto as P
from analytics_zoo_tpu_torch.tfnet import graphdef as G

tf = pytest.importorskip("tensorflow")
tf.config.set_visible_devices([], "GPU")
from tensorflow.core.framework import (  # noqa: E402
    attr_value_pb2,
    graph_pb2,
    node_def_pb2,
    tensor_pb2,
    tensor_shape_pb2,
)
from tensorflow.python.framework import tensor_util  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5  # tests/test_foreign_import.py's bound against TF


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _small_cnn(seed=0):
    tf.keras.utils.set_random_seed(seed)
    L = tf.keras.layers
    return tf.keras.Sequential([
        L.Input((16, 16, 3)), L.ZeroPadding2D(1),
        L.Conv2D(8, 3, strides=2, activation="relu"),
        L.BatchNormalization(), L.MaxPooling2D(2),
        L.Conv2D(16, 3, padding="same"), L.ReLU(),
        L.GlobalAveragePooling2D(), L.Dense(10, activation="softmax")])


@pytest.fixture(scope="module")
def cnn():
    """The small CNN trained one epoch (non-trivial BN statistics)."""
    m = _small_cnn()
    x = np.random.default_rng(9).normal(size=(32, 16, 16, 3)).astype(
        np.float32)
    m.compile("sgd", "mse")
    m.fit(x, np.zeros((32, 10), np.float32), epochs=1, verbose=0)
    return m


def _uncompiled(m):
    """The small CNN with ``m``'s weights and no compile state (a saved
    compiled model's "mse" metric does not load back in Keras 3)."""
    c = _small_cnn()
    c.set_weights(m.get_weights())
    return c


# -- the reader against TF's parser -----------------------------------------


def test_field_numbers_match_tensorflow_descriptors():
    want = {
        graph_pb2.GraphDef: {"node": 1},
        node_def_pb2.NodeDef: {"name": 1, "op": 2, "input": 3, "device": 4,
                               "attr": 5},
        attr_value_pb2.AttrValue: {"list": 1, "s": 2, "i": 3, "f": 4,
                                   "b": 5, "type": 6, "shape": 7,
                                   "tensor": 8, "placeholder": 9,
                                   "func": 10},
        attr_value_pb2.AttrValue.ListValue: {"s": 2, "i": 3, "f": 4, "b": 5,
                                             "type": 6, "shape": 7,
                                             "tensor": 8},
        tensor_shape_pb2.TensorShapeProto: {"dim": 2, "unknown_rank": 3},
        tensor_shape_pb2.TensorShapeProto.Dim: {"size": 1},
        tensor_pb2.TensorProto: {
            "dtype": 1, "tensor_shape": 2, "tensor_content": 4,
            "float_val": 5, "double_val": 6, "int_val": 7, "string_val": 8,
            "int64_val": 10, "bool_val": 11, "half_val": 13,
            "uint32_val": 16, "uint64_val": 17},
    }
    for msg, fields in want.items():
        got = {f.name: f.number for f in msg.DESCRIPTOR.fields}
        assert {k: got[k] for k in fields} == fields, msg.DESCRIPTOR.name
    from tensorflow.core.framework import types_pb2

    for name, code in (("DT_FLOAT", 1), ("DT_DOUBLE", 2), ("DT_INT32", 3),
                       ("DT_UINT8", 4), ("DT_INT8", 6), ("DT_INT64", 9),
                       ("DT_BOOL", 10), ("DT_BFLOAT16", 14),
                       ("DT_HALF", 19)):
        assert types_pb2.DataType.Value(name) == code
        assert code in G.DTYPES


def _attr_tuple(a):
    """A TF AttrValue as comparable Python values."""
    which = a.WhichOneof("value")
    if which == "tensor":
        return which, _tensor(tensor_util.MakeNdarray(a.tensor))
    if which == "shape":
        return which, (tuple(d.size for d in a.shape.dim),
                       a.shape.unknown_rank)
    if which == "list":
        lv = a.list
        return which, (list(lv.s), list(lv.i), [np.float32(v) for v in lv.f],
                       list(lv.b), list(lv.type),
                       [(tuple(d.size for d in s.dim), s.unknown_rank)
                        for s in lv.shape],
                       [_tensor(tensor_util.MakeNdarray(t))
                        for t in lv.tensor])
    if which == "func":
        return which, a.func.name
    if which == "f":
        return which, np.float32(a.f)
    return which, getattr(a, which) if which else None


def _port_attr_tuple(a):
    which = a.which
    if which == "tensor":
        return which, _tensor(a.tensor.ndarray())
    if which == "shape":
        return which, (tuple(d.size for d in a.shape.dim),
                       a.shape.unknown_rank)
    if which == "list":
        lv = a.list
        return which, (list(lv.s), list(lv.i), [np.float32(v) for v in lv.f],
                       list(lv.b), list(lv.type),
                       [(tuple(d.size for d in s.dim), s.unknown_rank)
                        for s in lv.shape],
                       [_tensor(t.ndarray()) for t in lv.tensor])
    if which == "func":
        return which, a.func_name
    if which == "f":
        return which, np.float32(a.f)
    return which, getattr(a, which) if which else None


def _tensor(arr):
    """A constant as (dtype, shape, bytes): bitwise; bfloat16 (which the
    reader decodes exactly to float32) as its float32 values."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if arr.dtype == object:
        return "object", arr.shape, tuple(arr.ravel().tolist())
    return arr.dtype.str, arr.shape, arr.tobytes()


def _agree(gd_tf):
    """The port's reader against TF's on ``gd_tf``'s bytes."""
    buf = gd_tf.SerializeToString()
    theirs = graph_pb2.GraphDef()
    theirs.ParseFromString(buf)
    ours = G.parse_graph_def(buf)
    assert [n.name for n in ours.node] == [n.name for n in theirs.node]
    consts = 0
    for a, b in zip(ours.node, theirs.node):
        assert (a.op, a.input, a.device) == (b.op, list(b.input), b.device)
        assert sorted(a.attr) == sorted(b.attr), a.name
        for k in b.attr:
            assert _port_attr_tuple(a.attr[k]) == _attr_tuple(b.attr[k]), \
                (a.name, k)
        consts += a.op == "Const"
    return len(ours.node), consts


def test_reader_agrees_with_tf_on_a_frozen_keras_cnn(cnn):
    fn = jtfnet.freeze_keras_model(cnn)
    gd = graph_pb2.GraphDef()
    gd.node.extend(fn._nodes.values())
    n, consts = _agree(gd)
    assert n > 20 and consts > 5


def test_reader_agrees_with_tf_on_a_saved_model_freeze(tmp_path):
    m = _small_cnn(seed=1)
    tf.saved_model.save(m, str(tmp_path / "sm"))
    gd, _, _ = jtfnet._freeze_saved_model(str(tmp_path / "sm"))
    n, consts = _agree(gd)
    assert n > 20 and consts > 5


def _tensor_proto(dtype, shape, **fields):
    t = tensor_pb2.TensorProto(dtype=dtype)
    for d in shape:
        t.tensor_shape.dim.add(size=d)
    for k, v in fields.items():
        if k == "tensor_content":
            t.tensor_content = v
        else:
            getattr(t, k).extend(v)
    return t


def _const(name, t):
    n = node_def_pb2.NodeDef(name=name, op="Const")
    n.attr["dtype"].type = t.dtype
    n.attr["value"].tensor.CopyFrom(t)
    return n


def _unpacked_float_const(name, shape, vals):
    """A Const NodeDef whose float_val is written UNPACKED (one fixed32
    field per value), encoded by hand: TF's own writer packs it."""
    shp = b"".join(P.emit(2, 2, P.emit(1, 0, d)) for d in shape)
    tensor = P.emit(1, 0, 1) + P.emit(2, 2, shp) + b"".join(
        P.emit(5, 5, struct.pack("<f", v)) for v in vals)
    attr_t = P.emit(5, 2, P.emit(1, 2, b"value") + P.emit(2, 2, P.emit(
        8, 2, tensor)))
    attr_d = P.emit(5, 2, P.emit(1, 2, b"dtype") + P.emit(2, 2, P.emit(
        6, 0, 1)))
    return P.emit(1, 2, name.encode()) + P.emit(2, 2, b"Const") + \
        attr_d + attr_t


def _unpacked_int_const(name, vals):
    """int_val unpacked (one varint field per value, negatives as 10-byte
    two's-complement varints)."""
    shp = P.emit(2, 2, P.emit(1, 0, len(vals)))
    tensor = P.emit(1, 0, 3) + P.emit(2, 2, shp) + b"".join(
        P.emit(7, 0, v) for v in vals)
    attr = P.emit(5, 2, P.emit(1, 2, b"value") + P.emit(2, 2, P.emit(
        8, 2, tensor)))
    return P.emit(1, 2, name.encode()) + P.emit(2, 2, b"Const") + attr


def test_reader_agrees_with_tf_on_typed_fields():
    """half_val (fp16 and bfloat16 bits in int32s), one value filling the
    whole shape, a short field repeating its last value, an empty field
    (zeros), tensor_content, packed and unpacked scalars, int64, bool,
    double, strings, and every attr kind, all against TF."""
    f16 = np.array([1.5, -2.25, 65504.0, 0.0], np.float16)
    bf16 = np.array([0x3FC0, 0xC010, 0x7F80], np.uint16)  # 1.5 -2.25 inf
    gd = graph_pb2.GraphDef()
    gd.node.extend([
        _const("half", _tensor_proto(19, [2, 2], half_val=f16.view(
            np.uint16).astype(np.int32).tolist())),
        _const("bf16", _tensor_proto(14, [3], half_val=bf16.astype(
            np.int32).tolist())),
        _const("fill", _tensor_proto(1, [2, 3], float_val=[3.0])),
        _const("short", _tensor_proto(3, [5], int_val=[7, -1])),
        _const("empty", _tensor_proto(9, [2, 2])),
        _const("content", _tensor_proto(
            1, [2, 2], tensor_content=np.arange(4, dtype="<f4").tobytes())),
        _const("i64", _tensor_proto(9, [3], int64_val=[-5, 2 ** 40, 0])),
        _const("flag", _tensor_proto(10, [2], bool_val=[True, False])),
        _const("dbl", _tensor_proto(2, [2], double_val=[0.1, -3.5])),
        _const("words", _tensor_proto(7, [2], string_val=[b"ab", b"c"])),
        _const("scalar", _tensor_proto(1, [], float_val=[2.5])),
    ])
    n = node_def_pb2.NodeDef(name="attrs", op="Identity",
                             input=["half", "^fill", "short:1"])
    n.attr["s"].s = b"SAME"
    n.attr["i"].i = -3
    n.attr["f"].f = 1e-3
    n.attr["b"].b = True
    n.attr["type"].type = 14
    n.attr["shape"].shape.dim.add(size=-1)
    n.attr["shape"].shape.dim.add(size=7)
    n.attr["unranked"].shape.unknown_rank = True
    n.attr["scalar_shape"].shape.SetInParent()
    n.attr["ints"].list.i.extend([1, -2, 2 ** 33])
    n.attr["floats"].list.f.extend([0.5, -1.25])
    n.attr["strs"].list.s.extend([b"x", b"yz"])
    n.attr["types"].list.type.extend([1, 3])
    n.attr["bools"].list.b.extend([True, False])
    sh = n.attr["shapes"].list.shape.add()
    sh.dim.add(size=2)
    n.attr["empty_list"].list.SetInParent()
    gd.node.append(n)
    _agree(gd)
    # the hand-encoded unpacked fields: TF parses them, and so does ours
    buf = gd.SerializeToString() + P.emit(1, 2, _unpacked_float_const(
        "unpacked", [2, 2], [1.0, -2.0, 3.5, 0.25])) + P.emit(
        1, 2, _unpacked_int_const("unpacked_i", [4, -9, 0]))
    theirs = graph_pb2.GraphDef()
    theirs.ParseFromString(buf)
    ours = G.parse_graph_def(buf)
    for name in ("unpacked", "unpacked_i"):
        a = [x for x in ours.node if x.name == name][0]
        b = [x for x in theirs.node if x.name == name][0]
        assert _port_attr_tuple(a.attr["value"]) == \
            _attr_tuple(b.attr["value"])
    vals = {x.name: x.attr["value"].tensor.ndarray() for x in ours.node
            if x.op == "Const"}
    np.testing.assert_array_equal(vals["fill"], np.full((2, 3), 3.0))
    np.testing.assert_array_equal(vals["short"], [7, -1, -1, -1, -1])
    np.testing.assert_array_equal(vals["empty"], np.zeros((2, 2)))
    np.testing.assert_array_equal(vals["half"], f16.reshape(2, 2))
    np.testing.assert_array_equal(vals["bf16"], [1.5, -2.25, np.inf])
    assert vals["scalar"].shape == ()


def test_refs_and_control_inputs_and_input_shapes():
    """``^ctrl`` inputs are skipped, ``name:k`` picks output k, and an
    absent ``shape`` attr (None) stays distinct from a declared scalar
    ``()`` — as the JAX package's GraphFunction has them."""
    g = tf.Graph()
    with g.as_default():
        a = tf.compat.v1.placeholder(tf.float32, (None, 4), name="a")
        s = tf.compat.v1.placeholder(tf.float32, (), name="s")
        parts = tf.split(a, 2, axis=1, name="split")
        with tf.control_dependencies([tf.no_op(name="ctrl")]):
            tf.identity(parts[1] * s, name="out")
    gd = g.as_graph_def()
    del gd.node[[n.name for n in gd.node].index("a")].attr["shape"]
    x = np.arange(8, dtype=np.float32).reshape(2, 4)
    for mod in (ttfnet, jtfnet):
        fn = mod.GraphFunction(gd, ["a:0", "s:0"], ["out:0"])
        assert fn.input_shapes == [None, ()]
        np.testing.assert_array_equal(np.asarray(fn(x, np.float32(2.0))),
                                      x[:, 2:] * 2)
    assert "^ctrl" in [i for n in G.parse_graph_def(
        gd.SerializeToString()).node for i in n.input]


# -- GraphFunction against TF and the JAX package ----------------------------


def _freeze(fn, *specs):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2,
    )

    concrete = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(concrete)
    return (frozen.graph.as_graph_def(), [t.name for t in frozen.inputs],
            [t.name for t in frozen.outputs])


def _check(gd, ins, outs, xs, want):
    got = ttfnet.GraphFunction(gd, ins, outs)(*xs)
    jgot = jtfnet.GraphFunction(gd, ins, outs)(*xs)
    got = got if isinstance(got, tuple) else (got,)
    jgot = jgot if isinstance(jgot, tuple) else (jgot,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    for g, j, w in zip(got, jgot, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g, w, atol=TOL * scale, rtol=0)
        np.testing.assert_allclose(g, np.asarray(j), atol=TOL * scale,
                                   rtol=0)


_rng = np.random.default_rng(3)
_X = _rng.normal(size=(2, 9, 7, 4)).astype(np.float32)
_M = _rng.normal(size=(3, 5, 6)).astype(np.float32)
_W = {k: _rng.normal(size=s).astype(np.float32) for k, s in (
    ("k3", (3, 3, 4, 5)), ("k43", (4, 3, 4, 6)), ("k2", (2, 2, 4, 3)),
    ("dw", (3, 3, 4, 2)), ("kt", (3, 3, 5, 4)), ("c4", (4,)),
    ("m4", (4,)))}
_W["s4"] = _rng.uniform(0.5, 1.5, 4).astype(np.float32)
_W["v4"] = _rng.uniform(0.5, 2.0, 4).astype(np.float32)


def _c(name):
    return tf.constant(_W[name])


def _pos(x):
    return tf.square(x) + 1.0


OP_CASES = {
    "conv_same_strided_dilated": lambda x: tf.nn.conv2d(
        x, _c("k3"), strides=1, padding="SAME", dilations=2),
    "conv_same_asym_stride2": lambda x: tf.nn.conv2d(
        x, _c("k43"), strides=2, padding="SAME"),
    "conv_explicit": lambda x: tf.nn.conv2d(
        x, _c("k2"), strides=1, padding=[[0, 0], [1, 2], [0, 1], [0, 0]]),
    "depthwise": lambda x: tf.nn.depthwise_conv2d(
        x, _c("dw"), strides=[1, 2, 2, 1], padding="SAME"),
    "pools_same": lambda x: tf.concat([
        tf.nn.max_pool2d(x, 3, 2, "SAME"), tf.nn.avg_pool2d(x, 3, 2, "SAME"),
        tf.nn.avg_pool2d(x, 2, 1, "VALID")[:, :5, :4]], axis=-1),
    "batch_norm": lambda x: tf.compat.v1.nn.fused_batch_norm(
        x, _c("s4"), _c("c4"), mean=_c("m4"), variance=_c("v4"),
        epsilon=1e-3, is_training=False)[0],
    "activations": lambda x: tf.concat([
        tf.nn.relu6(x * 4), tf.nn.leaky_relu(x, 0.1), tf.nn.elu(x),
        tf.nn.selu(x), tf.sigmoid(x), tf.tanh(x), tf.nn.softplus(x),
        tf.math.erf(x), tf.nn.softmax(x), tf.exp(x) - tf.math.log(_pos(x)),
        tf.math.rsqrt(_pos(x)), tf.sqrt(_pos(x)), tf.pow(_pos(x), 1.5),
        tf.negative(x), tf.maximum(x, 0.3) - tf.minimum(x, -0.3),
        tf.add_n([x, x, x]), tf.zeros_like(x) + x / 2.0], axis=-1),
    "shapes": lambda x: tf.reshape(
        tf.transpose(x, [0, 3, 1, 2]), [tf.shape(x)[0], -1]),
    "flatten_like_keras": lambda x: tf.reshape(x, tf.concat(
        [tf.shape(x)[:1], [tf.reduce_prod(tf.shape(x)[1:])]], 0)),
    "slices": lambda x: tf.concat([
        tf.reshape(x[:, 1:-1:2, ::-2, 2], [2, -1]),
        tf.reshape(x[:, 3, :, 0], [2, -1])], axis=1),
    "reductions": lambda x: tf.concat([
        tf.reduce_mean(x, [1, 2]), tf.reduce_sum(x, 1)[:, 0],
        tf.reduce_max(x, [1, 2]), tf.reduce_min(x, [1, 2], keepdims=True)[
            :, 0, 0], tf.reduce_prod(x[:, :2, :2], [1, 2]),
        tf.cast(tf.expand_dims(tf.argmax(x[:, 0, 0], 1), 1), tf.float32)],
        axis=1),
    "pad_tile_fill_gather": lambda x: tf.concat([
        tf.reshape(tf.pad(x, [[0, 0], [1, 2], [0, 1], [0, 0]],
                          constant_values=1.5), [2, -1]),
        tf.reshape(tf.pad(x, [[0, 0], [2, 1], [1, 1], [0, 0]],
                          mode="REFLECT"), [2, -1]),
        tf.reshape(tf.pad(x, [[0, 0], [1, 0], [0, 2], [0, 0]],
                          mode="SYMMETRIC"), [2, -1]),
        tf.reshape(tf.tile(x[:, :2, :2], [1, 2, 1, 3]), [2, -1]),
        tf.fill(tf.stack([tf.shape(x)[0], 3]), 2.0),
        tf.reshape(tf.gather(x, [3, 0, 3], axis=2), [2, -1])], axis=1),
    "split_squeeze_expand": lambda x: tf.concat([
        tf.reshape(tf.split(x, 2, axis=3)[1], [2, -1]),
        tf.reshape(tf.split(x, [3, -1, 2], axis=1)[1], [2, -1]),
        tf.squeeze(tf.expand_dims(x[:, :, :, 0], -1), [3])[:, 0],
        tf.reshape(tf.stack(tf.unstack(x[:, 0], axis=2), axis=1), [2, -1])],
        axis=1),
    "conv_transpose": lambda x: tf.nn.conv2d_transpose(
        x, _c("kt"), tf.stack([tf.shape(x)[0], 18, 14, 5]), 2, "SAME"),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_ops_match_tf_and_jax(case):
    """The op table, one TF-frozen snippet a case over a (2, 9, 7, 4)
    input: the port against TF and against the JAX package within TOL of
    the largest |value|."""
    fn = OP_CASES[case]
    gd, ins, outs = _freeze(fn, tf.TensorSpec((None, 9, 7, 4), tf.float32))
    _check(gd, ins, outs, [_X], fn(tf.constant(_X)).numpy())


def test_matmul_batch_matmul_multi_io():
    """MatMul (transposed), BatchMatMulV2 (adjoint), Cast, a multi-input
    and multi-output graph."""
    w = _rng.normal(size=(5, 6)).astype(np.float32)

    def fn(a, b):
        mm = tf.matmul(tf.reshape(a, [-1, 6]), w, transpose_b=True)
        bmm = tf.linalg.matmul(a, b, adjoint_b=True)
        return mm, tf.cast(tf.cast(bmm * 3, tf.int32), tf.float32)

    b = _rng.normal(size=(3, 4, 6)).astype(np.float32)
    gd, ins, outs = _freeze(fn, tf.TensorSpec((None, 5, 6), tf.float32),
                            tf.TensorSpec((None, 4, 6), tf.float32))
    want = [t.numpy() for t in fn(tf.constant(_M), tf.constant(b))]
    _check(gd, ins, outs, [_M, b], want)


def test_unsupported_op_reports_name():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, (None, 4), name="in")
        tf.raw_ops.Atan(x=x, name="weird")
    with pytest.raises(NotImplementedError, match="Atan"):
        ttfnet.GraphFunction(g.as_graph_def(), ["in:0"], ["weird:0"])


def test_training_batch_norm_and_traced_shapes_raise():
    g = tf.Graph()
    with g.as_default():
        x = tf.compat.v1.placeholder(tf.float32, (None, 2, 2, 3), name="x")
        c = tf.constant(np.ones(3, np.float32))
        tf.raw_ops.FusedBatchNormV3(x=x, scale=c, offset=c, mean=c,
                                    variance=c, is_training=True, name="bn")
        tf.reshape(x, tf.cast(tf.reduce_sum(x, [0, 1, 2]), tf.int32),
                   name="r")
    fn = ttfnet.GraphFunction(g.as_graph_def(), ["x:0"], ["bn:0"])
    with pytest.raises(NotImplementedError, match="is_training"):
        fn(np.ones((1, 2, 2, 3), np.float32))
    fn = ttfnet.GraphFunction(g.as_graph_def(), ["x:0"], ["r:0"])
    with pytest.raises(NotImplementedError, match="Reshape"):
        fn(np.ones((1, 2, 2, 3), np.float32))


def test_shape_chains_stay_on_the_host_and_constants_place_once(cnn):
    """A frozen Keras graph's Shape/StridedSlice/Pack chain folds to host
    arrays (so a CUDA-graph capture never reads the card), and each float
    constant is placed once: a second call adds no placed tensor."""
    fn = ttfnet.freeze_keras_model(cnn)
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(2, 16, 16, 3)).astype(np.float32))
    seen = []
    orig = ttfnet._OPS["Reshape"]

    def spy(attrs, t, shape):
        seen.append(type(shape))
        return orig(attrs, t, shape)

    ttfnet._OPS["Reshape"] = spy
    try:
        fn(x)
    finally:
        ttfnet._OPS["Reshape"] = orig
    placed = dict(fn.cache._placed)
    fn(x)
    assert dict(fn.cache._placed).keys() == placed.keys()
    assert all(a is b for a, b in zip(placed.values(),
                                      fn.cache._placed.values()))
    assert all(t is np.ndarray for t in seen)
    # constants kept by node name, layout and format; the convolution
    # kernels among them laid out OIHW once
    kernels = [t for _, layout, _, t in fn.cache.named_items()
               if layout is not None]
    assert kernels and all(t.dim() == 4 for t in kernels)


# -- loaders: Net.load_tf, do_load_tf, TFNet --------------------------------


def test_frozen_keras_cnn_matches_tf_and_jax(cnn):
    x = np.random.default_rng(0).normal(size=(4, 16, 16, 3)).astype(
        np.float32)
    want = cnn(x, training=False).numpy()
    got = ttfnet.freeze_keras_model(cnn)(x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jtfnet.freeze_keras_model(
        cnn)(x)), rtol=0, atol=1e-6)


def test_do_load_tf_forms_match_jax(cnn, tmp_path):
    """do_load_tf over a SavedModel directory, a frozen .pb (input and
    output names) and a Keras .h5: each answers as the JAX package's
    do_load_tf, do_quantize is a no-op (no parameters), and the wrong
    names or a missing path raise as there."""
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu_torch.inference import InferenceModel

    tf.saved_model.save(cnn, str(tmp_path / "sm"))
    gd, ins, outs = _freeze(lambda t: cnn(t), tf.TensorSpec(
        (None, 16, 16, 3), tf.float32))
    tf.io.write_graph(gd, str(tmp_path), "frozen.pb", as_text=False)
    _uncompiled(cnn).save(str(tmp_path / "m.h5"))
    x = np.random.default_rng(1).normal(size=(3, 16, 16, 3)).astype(
        np.float32)
    want = cnn(x, training=False).numpy()
    for args in ((str(tmp_path / "sm"),), (str(tmp_path / "frozen.pb"), ins,
                                           outs), (str(tmp_path / "m.h5"),)):
        im = InferenceModel().do_load_tf(*args)
        got = im.do_predict(x)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, JIM().do_load_tf(*args).do_predict(
            x), rtol=0, atol=1e-6)
        assert im.params == {} and im.do_quantize() is im
        assert np.array_equal(im.do_predict(x), got)
    with pytest.raises(ValueError, match="input_names"):
        InferenceModel().do_load_tf(str(tmp_path / "frozen.pb"))
    with pytest.raises(ValueError, match="only apply"):
        InferenceModel().do_load_tf(str(tmp_path / "sm"), ins, outs)
    with pytest.raises(FileNotFoundError):
        InferenceModel().do_load_tf(str(tmp_path / "nope.pb"), ins, outs)


def test_keras_graph_pb_is_a_tf_graph_and_serves_alike():
    """chip_smoke.py's phase-15b writer at a small size: its bytes parse
    under TF and run there (import_graph_def in a tf.function) to the same
    probabilities as the port's do_load_tf and the JAX package's, and the
    port's native model's softmax."""
    from analytics_zoo_tpu.inference import InferenceModel as JIM
    from analytics_zoo_tpu_torch.common.tree import tree_map
    from analytics_zoo_tpu_torch.inference import InferenceModel

    shape, classes = cs.ONNX_INPUT, cs.RESNET_CLASSES
    cs.ONNX_INPUT, cs.RESNET_CLASSES = (32, 32, 3), 7
    try:
        net, images = cs.calibrated_resnet(5)
    finally:
        cs.ONNX_INPUT, cs.RESNET_CLASSES = shape, classes
    host = lambda tree: tree_map(  # noqa: E731
        lambda t: t.detach().cpu().numpy(), tree)
    buf = cs.keras_graph_pb(net, host(net.params), host(net.model_state))
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(buf)
    assert {n.op for n in gd.node} == {
        "AddV2", "BiasAdd", "Const", "Conv2D", "FusedBatchNormV3", "MatMul",
        "MaxPool", "Mean", "Pad", "Placeholder", "Relu", "Softmax"}
    x = np.random.default_rng(6).normal(size=(3, 32, 32, 3)).astype(
        np.float32)

    @tf.function
    def run(t):
        return tf.graph_util.import_graph_def(
            gd, input_map={"input:0": t}, return_elements=["probs:0"])[0]

    want = run(tf.constant(x)).numpy()
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        pb = str(Path(d) / "r.pb")
        Path(pb).write_bytes(buf)
        got = InferenceModel().do_load_tf(pb, ["input:0"], ["probs:0"]) \
            .do_predict(x)
        jgot = JIM().do_load_tf(pb, ["input:0"], ["probs:0"]).do_predict(x)
    native = torch.softmax(torch.tensor(InferenceModel().do_load_keras(
        net).do_predict(x)), -1).numpy()
    for other in (want, jgot, native):
        np.testing.assert_allclose(got, other, rtol=0,
                                   atol=TOL * float(np.abs(other).max()))


def test_tfnet_layer_shapes_and_multi_input_refusal(cnn):
    net = ttfnet.TFNet.from_keras(cnn, input_shape=(16, 16, 3))
    assert net.compute_output_shape((None, 16, 16, 3)) == (None, 10)

    def two(a, b):
        return a + b

    gd, ins, outs = _freeze(two, tf.TensorSpec((None, 3), tf.float32),
                            tf.TensorSpec((None, 3), tf.float32))
    with pytest.raises(ValueError, match="single-input"):
        ttfnet.TFNet(ttfnet.GraphFunction(gd, ins, outs))


def test_tf_and_h5py_forms_raise_their_import_error_without_them(
        cnn, tmp_path):
    """On a machine without TensorFlow or h5py (the card's): a frozen .pb
    and a to_json() architecture load; a SavedModel directory and a Keras
    HDF5 file raise the ImportError that names the package (chip_smoke.py
    phase 15c)."""
    tf.saved_model.save(cnn, str(tmp_path / "sm"))
    gd, ins, outs = _freeze(lambda t: cnn(t), tf.TensorSpec(
        (None, 16, 16, 3), tf.float32))
    tf.io.write_graph(gd, str(tmp_path), "frozen.pb", as_text=False)
    _uncompiled(cnn).save(str(tmp_path / "m.h5"))
    (tmp_path / "arch.json").write_text(cnn.to_json())
    code = textwrap.dedent(f"""
        import sys
        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("tensorflow", "h5py", "keras"):
                    raise ImportError(f"No module named {{name!r}}")
        sys.meta_path.insert(0, Block())
        import numpy as np
        from analytics_zoo_tpu_torch import init_nncontext
        from analytics_zoo_tpu_torch.net import Net
        init_nncontext(device="cpu")
        net = Net.load_tf({str(tmp_path / 'frozen.pb')!r}, {ins!r}, {outs!r})
        print(tuple(net.fn(np.zeros((1, 16, 16, 3), np.float32)).shape))
        print(len(Net.load_keras({str(tmp_path / 'arch.json')!r}).layers()))
        for call in (lambda: Net.load_tf({str(tmp_path / 'sm')!r}),
                     lambda: Net.load_keras({str(tmp_path / 'm.h5')!r})):
            try:
                call()
            except ImportError as e:
                print("ImportError", str(e)[:40])
        assert "jax" not in sys.modules and "tensorflow" not in sys.modules
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0] == "(1, 10)" and int(lines[1]) > 5
    assert lines[2].startswith("ImportError TensorFlow is required")
    assert lines[3].startswith("ImportError No module named 'h5py'")
