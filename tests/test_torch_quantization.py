"""int8 inference in the port (``InferenceModel.do_quantize``,
``do_calibrate``, ``inference.calibration``, ``ops.int8``) held against
the JAX package's on the CPU.

Weights are carried from the JAX model leaf by leaf; both packages then
quantize from the same float32 weights, so the ``__q8__`` tensors, the
weight scales and the activation scales must be equal bitwise, and so
must the integer path: every calibrated layer's int8 input and int32
accumulator. Outputs (float32 compute) agree within ``OUT_TOL``: the two
frameworks round float32 sums in different orders.

Also: bytes at least 3.2x smaller, idempotence and the generation bump,
the original model untouched by calibration, two models calibrated on
different data keeping their own scales, every integer layer running
``torch._int_mm`` (never a float matmul or convolution), ``torch._int_mm``'s
zero padding at k = 147, m = 1, n = 4, and the ``-quantize`` catalog
names served int8. Weight-only BERT and the accuracy cases are in
``test_torch_quantization_models.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu.keras.layers as jl
from analytics_zoo_tpu.inference import calibration as jcalib
from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.inference.inference_model import (
    _quantize_leaf as jax_quantize_leaf,
)
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
import analytics_zoo_tpu_torch.ops.int8 as int8_ops
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.inference.inference_model import (
    _is_qleaf,
    _quantize_leaf,
    param_bytes,
)
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine import topology as ttopo
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

OUT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _contexts():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _cnn(L, topo):
    """"tf" integer convolutions: SAME at stride 2 (asymmetric pads) and a
    dilated VALID one, then Dense layers."""
    m = topo.Sequential(name="q_cnn")
    m.add(L.Convolution2D(6, (3, 3), subsample=(2, 2), border_mode="same",
                          dim_ordering="tf", activation="relu",
                          input_shape=(12, 12, 3)))
    m.add(L.AtrousConvolution2D(5, 2, 2, atrous_rate=(2, 2),
                                dim_ordering="tf"))
    m.add(L.Flatten())
    m.add(L.Dense(16, activation="relu"))
    m.add(L.Dense(4, activation="softmax"))
    return m


def _cnn_th(L, topo):
    """A "th" (NCHW) convolution, strided, into a Dense head."""
    m = topo.Sequential(name="q_cnn_th")
    m.add(L.Convolution2D(4, (3, 3), subsample=(2, 1), border_mode="same",
                          dim_ordering="th", input_shape=(3, 9, 8)))
    m.add(L.Flatten())
    m.add(L.Dense(3))
    return m


def _random_params(jnet, seed):
    """Seeded float32 numpy weights in the JAX model's tree (its structure
    from ``jax.eval_shape``: no JAX init runs): kernels at 1/sqrt(fan-in),
    small nonzero biases, LayerNorm gammas near 1."""
    rng = np.random.default_rng(seed)
    shapes, _ = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))

    def leaf(path, s):
        name = str(path[-1])
        if len(s.shape) >= 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(s.shape[:-1])),
                           s.shape)
        else:
            a = rng.normal(1.0 if "gamma" in name else 0.0, 0.05, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_model(jnet, params):
    """The JAX package's InferenceModel serving ``params`` (set directly:
    ``do_load_keras`` would build an Estimator and its state)."""
    jim = JaxInferenceModel()
    jim.model, jim.model_state = jnet, {}
    jim.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jim


def _pair(build, seed=0):
    """(JAX InferenceModel, port InferenceModel, port net) on the same
    float32 weights."""
    jbase.reset_name_counts()
    reset_name_counts()
    jnet = build(jl, jtopo)
    params = _random_params(jnet, seed)
    net = build(tl, ttopo)
    load_jax_params(net, params)
    return _jax_model(jnet, params), InferenceModel().do_load_keras(net), net


def _port(build):
    """A port model alone, on its own seeded init."""
    reset_name_counts()
    net = build(tl, ttopo)
    return InferenceModel().do_load_keras(net), net


def _input(shape, seed, n=6):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n,) + shape).astype(np.float32)


def _qleaves(tree, out=None, path=""):
    """{path: qleaf} of a parameter tree (JAX or port)."""
    out = {} if out is None else out
    if isinstance(tree, dict) and "__q8__" in tree:
        out[path] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _qleaves(v, out, f"{path}/{k}")
    return out


def _same_qleaves(jparams, params, keys=("__q8__", "scale")):
    jq, tq = _qleaves(jparams), _qleaves(params)
    assert sorted(jq) == sorted(tq) and jq
    for path in jq:
        for key in keys:
            np.testing.assert_array_equal(
                np.asarray(jq[path][key]), tq[path][key].numpy(),
                err_msg=f"{path}/{key}")
    return len(jq)


# -- _quantize_leaf ------------------------------------------------------


@pytest.mark.parametrize("shape,axis", [
    ((7, 5), -1), ((7, 5), 0), ((3, 4, 6), -1), ((3, 3, 4, 8), -1),
    ((3, 3, 4, 8), 0), ((2, 5, 3, 6), 2)])
def test_quantize_leaf_matches_jax_bitwise(shape, axis):
    rng = np.random.default_rng(len(shape) * 10 + axis)
    w = rng.normal(0.0, 0.3, shape).astype(np.float32)
    # a zero output channel (scale falls back to 1) and exact .5 ties
    idx = [slice(None)] * len(shape)
    idx[axis] = 1
    w[tuple(idx)] = 0.0
    w.flat[0] = np.float32(127.0 * 0.5 / 127.0)
    jq = jax_quantize_leaf(jnp.asarray(w), axis)
    tq = _quantize_leaf(torch.from_numpy(w), axis)
    np.testing.assert_array_equal(np.asarray(jq["__q8__"]),
                                  tq["__q8__"].numpy())
    np.testing.assert_array_equal(np.asarray(jq["scale"]),
                                  tq["scale"].numpy())
    assert tq["__q8__"].dtype == torch.int8
    assert tq["scale"].dtype == torch.float32
    # rank < 2 and integer leaves pass through
    b = torch.ones(5)
    assert _quantize_leaf(b) is b


# -- the integer product -------------------------------------------------


def test_int_mm_pads_to_the_cuda_shapes_exactly(monkeypatch):
    """A (1, 147) x (147, 4) product reaches ``torch._int_mm`` as
    (24, 152) x (152, 8), the first operand row-major and the second
    column-major, and returns the exact int32 product."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((tuple(a.shape), tuple(b.shape), a.is_contiguous(),
                     b.t().is_contiguous()))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (1, 147)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (147, 4)).astype(np.int8))
    got = int8_ops.int8_dense(a, w)
    assert seen == [((24, 152), (152, 8), True, True)]
    m, k, n = seen[0][0][0], seen[0][0][1], seen[0][1][1]
    assert m > 16 and k % 8 == 0 and n % 8 == 0
    assert got.dtype == torch.int32 and got.shape == (1, 4)
    want = a.numpy().astype(np.int64) @ w.numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ordering,stride,dilation,same", [
    ("tf", (1, 1), (1, 1), True), ("tf", (2, 2), (1, 1), True),
    ("tf", (1, 2), (2, 1), False), ("th", (2, 1), (1, 1), True),
    ("tf", (2, 2), (1, 1), False)])
def test_int8_conv2d_matches_an_int64_convolution(ordering, stride,
                                                  dilation, same):
    """im2col then ``torch._int_mm`` against an exact convolution in
    float64 (|sums| < 2^53)."""
    from analytics_zoo_tpu_torch.keras.layers.convolutional import (
        _same_pads,
    )

    rng = np.random.default_rng(7)
    x = rng.integers(-127, 128, (2, 9, 10, 5)).astype(np.int8)  # NHWC
    w = rng.integers(-127, 128, (3, 2, 5, 6)).astype(np.int8)   # HWIO
    pads = (_same_pads((9, 10), (3, 2), stride, dilation) if same
            else [(0, 0), (0, 0)])
    xt = torch.from_numpy(x)
    if ordering == "th":
        xt = xt.permute(0, 3, 1, 2).contiguous()
    got = int8_ops.int8_conv2d(xt, torch.from_numpy(w), stride, dilation,
                               pads, ordering)
    xf = torch.from_numpy(x.astype(np.float64)).permute(0, 3, 1, 2)
    xf = torch.nn.functional.pad(xf, (pads[1][0], pads[1][1], pads[0][0],
                                      pads[0][1]))
    want = torch.nn.functional.conv2d(
        xf, torch.from_numpy(w.astype(np.float64)).permute(3, 2, 0, 1),
        stride=stride, dilation=dilation)
    if ordering == "tf":
        want = want.permute(0, 2, 3, 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy().astype(np.int64))


# -- weight-only int8 ----------------------------------------------------


@pytest.mark.parametrize("build", [_cnn, _cnn_th], ids=["tf", "th"])
def test_do_quantize_matches_jax(build):
    jim, im, _ = _pair(build)
    x = _input(build(tl, ttopo).get_input_shape()[1:], 1)
    f32_bytes = param_bytes(im.params)
    gen = im._gen
    jim.do_quantize()
    assert im.do_quantize() is im
    assert im._gen == gen + 1 and im._quantized
    n = _same_qleaves(jim.params, im.params)
    assert n == len(build(tl, ttopo).layers()) - 1  # every kernel but Flatten
    assert f32_bytes / param_bytes(im.params) >= 3.2
    np.testing.assert_allclose(im.do_predict(x), np.asarray(jim.do_predict(x)),
                               rtol=0, atol=OUT_TOL)
    # idempotent: no second quantization, no new generation
    im.do_quantize()
    assert im._gen == gen + 1
    assert all(q["__q8__"].dtype == torch.int8
               for q in _qleaves(im.params).values())


def test_quantized_bf16_program_dequantizes_then_casts():
    """Under bf16 compute the programs run on ``bf16(f32(q) * scale)``
    while the params stay int8, and the int8 output equals the float
    model's forward on those dequantized weights."""
    _, net = _port(_cnn)
    net.compute_dtype = "bfloat16"
    im = InferenceModel().do_load_keras(net).do_quantize()
    for q in _qleaves(im._exec_params).values():
        assert q["__q8__"].dtype == torch.int8
        assert q["scale"].dtype == torch.float32  # never rounded to bf16
    x = _input((12, 12, 3), 2)
    got = im.do_predict(x)
    deq = {}
    for lname, p in im.params.items():
        deq[lname] = {k: ((v["__q8__"].float() * v["scale"]).to(
            torch.bfloat16) if _is_qleaf(v) else v.to(torch.bfloat16))
            for k, v in p.items()}
    with torch.inference_mode():
        want = net.apply(deq, {}, torch.from_numpy(x).to(torch.bfloat16),
                         training=False)[0].float()
    np.testing.assert_array_equal(got, want.numpy())


# -- calibrated int8 ------------------------------------------------------


def _jax_integer_path(jnet, jparams, x, monkeypatch):
    """The JAX package's int8 input and int32 accumulator of each
    calibrated layer in its jitted forward (as ``do_predict`` runs it):
    the integer ops are wrapped to hand their traced results out as
    outputs of the jitted function."""
    stash = []
    real_q, real_dot = jcalib._quantize_input, jax.lax.dot_general
    real_conv = jax.lax.conv_general_dilated

    def keep(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            stash.append(out)
            return out
        return wrapped

    monkeypatch.setattr(jcalib, "_quantize_input", keep(real_q))
    monkeypatch.setattr(jax.lax, "dot_general", keep(real_dot))
    monkeypatch.setattr(jax.lax, "conv_general_dilated", keep(real_conv))
    names = []
    for layer in jnet.layers():
        def call(p, xx, _inner=layer.call, _name=layer.name, **k):
            n = len(stash)
            out = _inner(p, xx, **k)
            if len(stash) > n:
                names.append(_name)
            return out

        monkeypatch.setattr(layer, "call", call)

    def forward(p, xx):
        stash.clear()
        jnet.apply(p, {}, xx, training=False)
        return list(stash)

    outs = jax.jit(forward)(jparams, jnp.asarray(x))
    monkeypatch.undo()
    return {name: (np.asarray(outs[2 * i]), np.asarray(outs[2 * i + 1]))
            for i, name in enumerate(names)}


@pytest.mark.parametrize("build", [_cnn, _cnn_th], ids=["tf", "th"])
def test_do_calibrate_matches_jax(build, monkeypatch):
    """Weights bitwise. Activation scales bitwise where the calibration
    pass feeds a layer the data itself, and within 2 ulp behind a float
    layer: the calibration pass runs the float model, whose matmuls and
    convolutions round differently in XLA and in PyTorch. Given the JAX
    calibration's scales, every integer layer's int8 input and int32
    accumulator equal the JAX package's bitwise, and the outputs agree
    within OUT_TOL (the float32 rescale and the layers between are
    float)."""
    from analytics_zoo_tpu_torch.inference import calibration as tcalib

    jim, im, net = _pair(build, seed=4)
    shape = net.get_input_shape()[1:]
    cal = [_input(shape, 10, 4), _input(shape, 11, 4)]
    x = _input(shape, 12)
    jim.do_calibrate(cal)
    im.do_calibrate(cal)
    assert im._calibrated and not im._quantized
    n = _same_qleaves(jim.params, im.params)
    assert n == len(net.layers()) - 1
    jq, tq = _qleaves(jim.params), _qleaves(im.params)
    first = f"/{net.layers()[0].name}/kernel"
    assert float(tq[first]["act_scale"]) == float(jq[first]["act_scale"])
    for path in jq:
        np.testing.assert_array_max_ulp(np.asarray(jq[path]["act_scale"]),
                                        tq[path]["act_scale"].numpy(), 2)

    jscales = {path.split("/")[1]: float(q["act_scale"])
               for path, q in jq.items()}
    monkeypatch.setattr(tcalib, "calibrate_activations",
                        lambda *a, **k: dict(jscales))
    im = InferenceModel().do_load_keras(net).do_calibrate(cal)
    monkeypatch.undo()
    _same_qleaves(jim.params, im.params, keys=("__q8__", "scale",
                                                "act_scale"))
    want = _jax_integer_path(jim.model, jim.params, x, monkeypatch)
    record = {}
    for layer in net.layers():
        layer._int8_record = record
    try:
        got = im.do_predict(x)
    finally:
        for layer in net.layers():
            del layer._int8_record
    assert sorted(record) == sorted(want) and len(record) == n
    for name, (jxq, jacc) in want.items():
        _, xq, acc = record[name]
        assert xq.dtype == torch.int8 and acc.dtype == torch.int32
        np.testing.assert_array_equal(xq.numpy(), jxq, err_msg=name)
        np.testing.assert_array_equal(acc.numpy(), jacc, err_msg=name)
    np.testing.assert_allclose(got, np.asarray(jim.do_predict(x)), rtol=0,
                               atol=OUT_TOL)


def test_every_integer_layer_runs_int_mm_and_no_float_product(monkeypatch):
    """A calibrated forward multiplies through ``torch._int_mm`` once per
    integer layer and never through a float matmul or convolution."""
    from analytics_zoo_tpu_torch.keras.layers import convolutional, core

    im, net = _port(_cnn)
    im.do_calibrate([_input((12, 12, 3), 20, 8)])
    calls = {"int_mm": 0, "float": 0}
    real = torch._int_mm

    def int_mm(a, b):
        calls["int_mm"] += 1
        return real(a, b)

    def float_product(*a, **k):
        calls["float"] += 1
        raise AssertionError("an integer layer reached a float product")

    monkeypatch.setattr(torch, "_int_mm", int_mm)
    monkeypatch.setattr(core, "matmul", float_product)
    monkeypatch.setattr(convolutional.F, "conv2d", float_product)
    im.do_predict(_input((12, 12, 3), 21, 1))  # a batch-1 head: m = 1
    assert calls == {"int_mm": 4, "float": 0}


def test_calibration_leaves_the_original_model_untouched():
    im, net = _port(_cnn)
    x = _input((12, 12, 3), 30, 16)
    before = np.asarray(net.predict(x, batch_size=8))
    p_f32 = im.do_predict(x)
    im.do_calibrate([x[:8]])
    after = np.asarray(net.predict(x, batch_size=8))
    np.testing.assert_array_equal(after, before)
    np.testing.assert_allclose(before.reshape(p_f32.shape), p_f32, rtol=0,
                               atol=OUT_TOL)
    # and the calibrated copy is integer, the float net's params are not
    assert not any(_is_qleaf(v) for p in net.params.values()
                   for v in p.values())


def test_two_models_calibrated_on_different_data_keep_their_scales():
    im_a, net = _port(_cnn)
    im_b = InferenceModel().do_load_keras(net)
    small = 0.1 * _input((12, 12, 3), 40, 8)
    large = 10.0 * _input((12, 12, 3), 41, 8)
    im_a.do_calibrate([small])
    im_b.do_calibrate([large])
    sa = {k: float(v["act_scale"]) for k, v in _qleaves(im_a.params).items()}
    sb = {k: float(v["act_scale"]) for k, v in _qleaves(im_b.params).items()}
    first = sorted(sa)[0]
    assert sb[first] > 50 * sa[first]
    x = _input((12, 12, 3), 42, 4)
    pa = im_a.do_predict(x)
    # a fresh calibration on the small data reproduces model a bitwise:
    # model b's later calibration did not overwrite a's scales
    im_c = InferenceModel().do_load_keras(net).do_calibrate([small])
    np.testing.assert_array_equal(pa, im_c.do_predict(x))
    assert not np.array_equal(pa, im_b.do_predict(x))


def test_calibration_records_only_its_own_forwards():
    """Another thread's predicts through the same layer objects while
    ``do_calibrate`` runs (eager on the CPU, with inputs far larger than
    the calibration data) leave the activation scales equal to a lone
    calibration's, and get the float model's answers."""
    im_lone, net = _port(_cnn)
    cal = [_input((12, 12, 3), 60 + i, 8) for i in range(3)]
    im_lone.do_calibrate(cal)
    lone = {k: float(v["act_scale"])
            for k, v in _qleaves(im_lone.params).items()}

    other = InferenceModel().do_load_keras(net)
    big = 100.0 * _input((12, 12, 3), 70, 4)
    want = other.do_predict(big)
    got = []

    def interleaved():
        for batch in cal:
            # the other model's forward runs while this calibration
            # records: between two of its batches, in another thread
            t = threading.Thread(target=lambda: got.append(
                other.do_predict(big)))
            t.start()
            t.join()
            yield batch

    im = InferenceModel().do_load_keras(net).do_calibrate(interleaved())
    assert len(got) == len(cal)
    for g in got:
        np.testing.assert_array_equal(g, want)
    assert {k: float(v["act_scale"])
            for k, v in _qleaves(im.params).items()} == lone


def test_calibrate_after_quantize_raises_and_quantize_after_calibrate_noop():
    im, net = _port(_cnn_th)
    im.do_quantize()
    with pytest.raises(RuntimeError, match="after do_quantize"):
        im.do_calibrate([_input((3, 9, 8), 50, 4)])
    im2 = InferenceModel().do_load_keras(net)
    im2.do_calibrate([_input((3, 9, 8), 51, 4)])
    gen = im2._gen
    assert im2.do_quantize() is im2 and im2._gen == gen
    assert im2.do_calibrate([]) is im2 and im2._gen == gen


def test_aot_cache_raises_naming_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="no persistent executable cache"):
        InferenceModel(aot_cache_dir="/nonexistent")
    with pytest.raises(NotImplementedError, match="no persistent executable cache"):
        InferenceModel().set_aot_cache("/nonexistent")


def test_quantize_catalog_name_serves_int8():
    """A ``-quantize`` catalog name builds its architecture's float graph,
    and ``do_quantize`` serves it int8: every kernel an int8 qleaf, the
    output that of the float forward over the dequantized weights."""
    from analytics_zoo_tpu_torch.models.image import imageclassification as tic

    reset_name_counts()
    net = tic.build_model("lenet-quantize", num_classes=5)
    reset_name_counts()
    plain = tic.build_model("lenet", num_classes=5)
    assert [type(l) for l in net.layers()] == [type(l) for l in
                                               plain.layers()]
    im = InferenceModel().do_load_keras(net).do_quantize()
    q = _qleaves(im.params)
    assert q and all(v["__q8__"].dtype == torch.int8 for v in q.values())
    x = _input(tuple(net.get_input_shape()[1:]), 12, 3)
    deq = {lname: {k: (v["__q8__"].float() * v["scale"] if _is_qleaf(v)
                       else v) for k, v in p.items()}
           for lname, p in im.params.items()}
    with torch.inference_mode():
        want = net.apply(deq, {}, torch.from_numpy(x), training=False)[0]
    np.testing.assert_array_equal(im.do_predict(x), want.numpy())
