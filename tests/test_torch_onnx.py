"""The port's ONNX importer against the JAX package's, on the same bytes.

- The codec: the port's ``encode_model``/``encode_node``/``encode_tensor``
  write the JAX package's bytes, and each parses the other's.
- Every registered op (78, the JAX package's table) runs in both packages
  on the same encoded graph and the same seeded inputs: float outputs
  within ``TOL`` (XLA against PyTorch on the CPU, IEEE float32 on both
  sides), integer and boolean outputs exactly.
- Shape chains stay static (host arrays) and never read a tensor's
  values; the device constants they need are made once per value.
- Serving through ``InferenceModel.do_load_onnx``: the reshape-target and
  ``transB`` quantize-axis cases of ``tests/test_onnx.py``, and the
  served output against ``OnnxModel.predict``.
- Fine-tuning: gradients through ``apply`` against ``jax.grad``.
- The op table has at least the reference's 42 mappers and is JAX's.
- ``precision="highest"`` leaves the TF32 flags as they are when they are
  off, and holds them off (restoring them after) on the card when a
  caller turned them on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu import onnx as jonnx
from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JInferenceModel,
)
from analytics_zoo_tpu.onnx import proto as JP
from analytics_zoo_tpu_torch import onnx as tonnx
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.onnx import proto as P

TOL = 1e-5  # float32 outputs, XLA against PyTorch on the same CPU


@pytest.fixture(autouse=True)
def _ctx():
    zoo.init_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()


def _f(rng, *shape, lo=-2.0, hi=2.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _one(op, x_shape=(2, 3, 4), lo=-2.0, hi=2.0, **attrs):
    def build(rng):
        return ([P.encode_node(op, ["x"], ["y"], **attrs)], {},
                {"x": _f(rng, *x_shape, lo=lo, hi=hi)}, ["y"])
    return build


def _two(op, dtype=np.float32, lo=-2.0, hi=2.0):
    def build(rng):
        if dtype == np.bool_:
            a, b = rng.random((3, 4)) > 0.5, rng.random((3, 4)) > 0.5
        else:
            a = np.round(_f(rng, 3, 4, lo=lo, hi=hi), 1)
            b = np.round(_f(rng, 4, lo=lo, hi=hi), 1)  # broadcast
        return ([P.encode_node(op, ["a", "b"], ["y"])], {},
                {"a": a, "b": b}, ["y"])
    return build


def _graph(nodes, inits, inputs, outputs=("y",)):
    return lambda rng: (nodes, inits(rng) if callable(inits) else inits,
                        inputs(rng), list(outputs))


N = P.encode_node
I64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731


def _conv_inputs(rng, c=4):
    return {"x": _f(rng, 2, c, 7, 6)}


CASES = {
    **{op: _two(op) for op in ("Add", "Sub", "Mul", "Equal", "Greater",
                               "Less")},
    "Div": _two("Div", lo=0.5), "Pow": _two("Pow", lo=0.5),
    "And": _two("And", np.bool_), "Or": _two("Or", np.bool_),
    **{op: _one(op) for op in ("Relu", "Sigmoid", "Tanh", "Exp", "Abs",
                               "Neg", "Floor", "Ceil", "Erf", "Softplus",
                               "Softsign", "Sign", "Sin", "Cos",
                               "Identity", "Selu", "Dropout",
                               "GlobalAveragePool", "GlobalMaxPool")},
    **{op: _one(op, lo=0.1) for op in ("Log", "Sqrt", "Reciprocal")},
    "Not": _graph([N("Greater", ["x", "z"], ["g"]), N("Not", ["g"], ["y"])],
                  {"z": np.zeros((), np.float32)},
                  lambda r: {"x": _f(r, 3, 4)}),
    "LeakyRelu": _one("LeakyRelu", alpha=0.1),
    "Elu": _one("Elu", alpha=0.5),
    "PRelu": _graph([N("PRelu", ["x", "s"], ["y"])],
                    lambda r: {"s": _f(r, 4, lo=0.0, hi=0.5)},
                    lambda r: {"x": _f(r, 2, 3, 4)}),
    "HardSigmoid": _one("HardSigmoid", alpha=0.3, beta=0.4),
    "Clip": _one("Clip", min=-0.5, max=0.7),
    "Clip-inputs": _graph([N("Clip", ["x", "lo", ""], ["y"])],
                          {"lo": np.asarray(-0.25, np.float32)},
                          lambda r: {"x": _f(r, 3, 4)}),
    "Softmax": _one("Softmax", axis=1),
    "LogSoftmax": _one("LogSoftmax", axis=-1),
    **{op: _graph([N(op, ["a", "b", "c"], ["y"])], {},
                  lambda r: {k: _f(r, 3, 4) for k in "abc"})
       for op in ("Max", "Min", "Sum", "Mean")},
    "Where": _graph([N("Greater", ["a", "b"], ["c"]),
                     N("Where", ["c", "a", "b"], ["y"])], {},
                    lambda r: {"a": _f(r, 3, 4), "b": _f(r, 3, 4)}),
    "Cast": _one("Cast", to=6),
    "Cast-static": _graph([N("Shape", ["x"], ["s"]),
                           N("Cast", ["s"], ["sf"], to=1),
                           N("Mul", ["x", "sf"], ["y"])], {},
                          lambda r: {"x": _f(r, 2, 3, 3)}),
    **{f"Reduce{k}": _one(f"Reduce{k}", axes=[1, -1], keepdims=0)
       for k in ("Mean", "Sum", "Max", "Min", "Prod")},
    "ReduceMean-keep": _one("ReduceMean", axes=[0], keepdims=1),
    "ReduceSum-all": _one("ReduceSum", keepdims=0),
    "ArgMax": _one("ArgMax", axis=1, keepdims=0),
    "ArgMin": _one("ArgMin", axis=-1),
    "Shape": _one("Shape"),
    "Reshape": _graph([N("Reshape", ["x", "t"], ["y"])],
                      {"t": I64(0, -1, 2)},
                      lambda r: {"x": _f(r, 2, 3, 4)}),
    "Flatten": _one("Flatten", axis=2),
    "Transpose": _one("Transpose", perm=[2, 0, 1]),
    "Transpose-default": _one("Transpose"),
    "Concat": _graph([N("Concat", ["x", "w"], ["y"], axis=1)],
                     lambda r: {"w": _f(r, 2, 2, 4)},
                     lambda r: {"x": _f(r, 2, 3, 4)}),
    "Split": _graph([N("Split", ["x"], ["a", "b"], axis=2, split=[1, 3])],
                    {}, lambda r: {"x": _f(r, 2, 3, 4)}, ("a", "b")),
    "Split-equal": _graph([N("Split", ["x"], ["a", "b"], axis=2)], {},
                          lambda r: {"x": _f(r, 2, 3, 4)}, ("a", "b")),
    "Squeeze": _one("Squeeze", x_shape=(2, 1, 4, 1), axes=[1, 3]),
    "Unsqueeze": _one("Unsqueeze", axes=[0, -1]),
    "Slice": _one("Slice", starts=[1, 0], ends=[3, 2], axes=[2, 1]),
    "Slice-inputs": _graph(
        [N("Slice", ["x", "st", "en", "ax", "sp"], ["y"])],
        {"st": I64(-1, 0), "en": I64(-2 ** 63, 2 ** 62), "ax": I64(2, 1),
         "sp": I64(-2, 2)},
        lambda r: {"x": _f(r, 2, 5, 6)}),
    "Gather": _graph([N("Gather", ["x", "i"], ["y"], axis=1)],
                     {"i": I64(2, -1, 0)},
                     lambda r: {"x": _f(r, 2, 4, 3)}),
    "Gather-ids": _graph([N("Gather", ["w", "ids"], ["y"])],
                         lambda r: {"w": _f(r, 10, 3)},
                         lambda r: {"ids": r.integers(0, 10, (2, 5))}),
    "Gather-shape": _graph([N("Shape", ["x"], ["s"]),
                            N("Gather", ["s", "i"], ["n"], axis=0),
                            N("Unsqueeze", ["n"], ["nu"], axes=[0]),
                            N("Concat", ["nu", "m"], ["t"], axis=0),
                            N("Reshape", ["x", "t"], ["y"])],
                           {"i": np.asarray(0, np.int64), "m": I64(-1)},
                           lambda r: {"x": _f(r, 2, 2, 3, 4)}),
    "Expand": _graph([N("Expand", ["x", "s"], ["y"])], {"s": I64(2, 1, 4)},
                     lambda r: {"x": _f(r, 3, 1)}),
    "Tile": _graph([N("Tile", ["x", "r"], ["y"])], {"r": I64(2, 1, 3)},
                   lambda r: {"x": _f(r, 2, 3, 4)}),
    "Pad": _one("Pad", pads=[0, 1, 2, 0, 0, 1], value=9.0),
    "Pad-reflect": _one("Pad", pads=[0, 0, 2, 0, 1, 1], mode="reflect"),
    "Pad-edge": _one("Pad", pads=[1, 0, 0, 0, 2, 3], mode="edge"),
    "Pad-inputs": _graph([N("Pad", ["x", "p", "v"], ["y"])],
                         {"p": I64(0, 1, 1, 0, 2, 0),
                          "v": np.asarray(-3.0, np.float32)},
                         lambda r: {"x": _f(r, 2, 3, 4)}),
    "Constant": _graph([N("Constant", [], ["c"],
                          value=np.arange(4, dtype=np.float32)),
                        N("Add", ["x", "c"], ["y"])], {},
                       lambda r: {"x": _f(r, 3, 4)}),
    "ConstantOfShape": _graph(
        [N("Shape", ["x"], ["s"]),
         N("ConstantOfShape", ["s"], ["c"],
           value=np.asarray([1.5], np.float32)),
         N("Mul", ["x", "c"], ["y"])], {}, lambda r: {"x": _f(r, 3, 4)}),
    "Range": _graph([N("Range", ["a", "b", "d"], ["y"])],
                    {"a": np.asarray(1, np.int64),
                     "b": np.asarray(9, np.int64),
                     "d": np.asarray(3, np.int64)}, lambda r: {}),
    "MatMul": _graph([N("MatMul", ["x", "w"], ["y"])],
                     lambda r: {"w": _f(r, 4, 5)},
                     lambda r: {"x": _f(r, 2, 3, 4)}),
    "Gemm": _graph([N("Gemm", ["x", "w", "b"], ["y"], alpha=0.5, beta=2.0,
                      transB=1)],
                   lambda r: {"w": _f(r, 5, 4), "b": _f(r, 5)},
                   lambda r: {"x": _f(r, 3, 4)}),
    "Gemm-transA": _graph([N("Gemm", ["x", "w"], ["y"], transA=1)],
                          lambda r: {"w": _f(r, 3, 5)},
                          lambda r: {"x": _f(r, 3, 4)}),
    "Conv": _graph([N("Conv", ["x", "w", "b"], ["y"], kernel_shape=[3, 3],
                      strides=[2, 1], pads=[1, 0, 2, 1])],
                   lambda r: {"w": _f(r, 6, 4, 3, 3), "b": _f(r, 6)},
                   _conv_inputs),
    "Conv-group-dilated": _graph(
        [N("Conv", ["x", "w"], ["y"], kernel_shape=[2, 2], group=2,
           dilations=[2, 1], auto_pad="SAME_UPPER")],
        lambda r: {"w": _f(r, 4, 2, 2, 2)}, _conv_inputs),
    "Conv-1d": _graph([N("Conv", ["x", "w"], ["y"], kernel_shape=[3],
                         auto_pad="SAME_LOWER", strides=[2])],
                      lambda r: {"w": _f(r, 5, 3, 3)},
                      lambda r: {"x": _f(r, 2, 3, 8)}),
    "ConvTranspose": _graph(
        [N("ConvTranspose", ["x", "w", "b"], ["y"], strides=[2, 2],
           pads=[1, 0, 0, 1], output_padding=[1, 1])],
        lambda r: {"w": _f(r, 4, 3, 3, 3), "b": _f(r, 3)}, _conv_inputs),
    "MaxPool": _graph([N("MaxPool", ["x"], ["y"], kernel_shape=[3, 2],
                         strides=[2, 2], pads=[1, 0, 1, 1])], {},
                      _conv_inputs),
    "AveragePool": _graph([N("AveragePool", ["x"], ["y"],
                             kernel_shape=[3, 3], strides=[2, 1],
                             pads=[1, 1, 1, 1])], {}, _conv_inputs),
    "AveragePool-count-pad": _graph(
        [N("AveragePool", ["x"], ["y"], kernel_shape=[2, 2],
           auto_pad="SAME_UPPER", count_include_pad=1)], {}, _conv_inputs),
    "AveragePool-1d": _graph([N("AveragePool", ["x"], ["y"],
                                kernel_shape=[3], strides=[2])], {},
                             lambda r: {"x": _f(r, 2, 3, 9)}),
    "BatchNormalization": _graph(
        [N("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
           epsilon=1e-3)],
        lambda r: {"s": _f(r, 4), "b": _f(r, 4), "m": _f(r, 4),
                   "v": _f(r, 4, lo=0.5, hi=2.0)}, _conv_inputs),
    "InstanceNormalization": _graph(
        [N("InstanceNormalization", ["x", "s", "b"], ["y"])],
        lambda r: {"s": _f(r, 4), "b": _f(r, 4)}, _conv_inputs),
    "LRN": _graph([N("LRN", ["x"], ["y"], size=3, alpha=0.01, beta=0.7,
                     bias=1.5)], {}, _conv_inputs),
}


def _case_op(case: str) -> set:
    nodes, _, _, _ = CASES[case](np.random.default_rng(0))
    return {P.parse_model(P.encode_model([n], {}, [], []))
            .nodes[0].op_type for n in nodes}


def test_the_cases_cover_every_registered_op():
    covered = set().union(*(_case_op(c) for c in CASES))
    assert covered == set(tonnx.supported_ops())


def _encode(case):
    nodes, inits, inputs, outputs = CASES[case](np.random.default_rng(3))
    buf = P.encode_model(nodes, inits,
                         [(k, v.shape) for k, v in inputs.items()], outputs)
    return buf, list(inputs.values())


def _assert_same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_every_op_matches_jax_on_the_same_bytes(case):
    buf, xs = _encode(case)
    _assert_same(tonnx.load_model_bytes(buf).predict(*xs),
                 jonnx.load_model_bytes(buf).predict(*xs))


def test_encoder_writes_the_jax_bytes_and_parses_them():
    rng = np.random.default_rng(1)
    inits = {"w": _f(rng, 4, 3), "t": I64(-1, 12), "f": np.float64(2.5),
             "b": rng.random((2, 2)) > 0.5}
    for mod in (P, JP):
        assert mod.encode_tensor("w", inits["w"]) == (
            JP if mod is P else P).encode_tensor("w", inits["w"])
    kw = dict(alpha=0.5, axis=-1, pads=[1, 2, 3, 4], mode="reflect",
              scales=[0.5, 2.0], value=np.arange(3, dtype=np.int32))
    assert P.encode_node("Foo", ["a", ""], ["b"], name="n", **kw) == \
        JP.encode_node("Foo", ["a", ""], ["b"], name="n", **kw)
    nodes = [N("Reshape", ["x", "t"], ["r"]), N("MatMul", ["r", "w"], ["y"])]
    args = (nodes, inits, [("x", (None, 3, 4))], ["y"])
    buf = P.encode_model(*args, graph_name="g1", opset=11)
    assert buf == JP.encode_model(*args, graph_name="g1", opset=11)
    g, jg = P.parse_model(buf), JP.parse_model(buf)
    assert [(n.op_type, n.inputs, n.outputs) for n in g.nodes] == \
        [(n.op_type, n.inputs, n.outputs) for n in jg.nodes]
    assert g.inputs == jg.inputs == [("x", (None, 3, 4))]
    for k, v in jg.initializers.items():
        np.testing.assert_array_equal(g.initializers[k], v)
        assert g.initializers[k].dtype == v.dtype
    node = P.parse_model(P.encode_model(
        [P.encode_node("Foo", ["a"], ["b"], **kw)], {}, [], [])).nodes[0]
    assert node.attrs["axis"] == -1 and node.attrs["mode"] == b"reflect"
    assert node.attrs["pads"] == [1, 2, 3, 4]


def test_shape_chains_stay_on_the_host(monkeypatch):
    """Shape -> Gather -> Unsqueeze -> Concat -> Reshape folds in numpy:
    no op reads a tensor's values (``_np`` of a tensor would), and the
    static values that meet the device are made once."""
    buf, (x,) = _encode("Gather-shape")
    om = tonnx.load_model_bytes(buf)
    real_np = tonnx._np

    def host_only(v):
        assert not isinstance(v, torch.Tensor), "a shape op read a tensor"
        return real_np(v)

    monkeypatch.setattr(tonnx, "_np", host_only)
    out = om.apply(om.device_params("cpu"), torch.tensor(x))
    np.testing.assert_array_equal(out.numpy(), x.reshape(2, -1))
    monkeypatch.undo()
    buf, (x,) = _encode("Gather")
    om = tonnx.load_model_bytes(buf)
    om.predict(x)
    made = dict(om._consts)
    om.predict(x)
    assert len(made) == 1 and om._consts == made


def test_unsupported_op_names_the_op():
    buf = P.encode_model([N("NonMaxSuppressionFancy", ["x"], ["y"])], {},
                         [("x", (1,))], ["y"])
    with pytest.raises(NotImplementedError, match="NonMaxSuppressionFancy"):
        tonnx.load_model_bytes(buf)


def test_supported_op_table_is_the_jax_one():
    # the reference has 42 mapper classes; both packages exceed that
    assert len(tonnx.supported_ops()) >= 42
    assert tonnx.supported_ops() == jonnx.supported_ops()


def test_finetune_grads_match_jax():
    rng = np.random.default_rng(4)
    inits = {"w1": _f(rng, 3, 6), "b1": _f(rng, 6), "w2": _f(rng, 2, 6)}
    buf = P.encode_model([N("MatMul", ["x", "w1"], ["h"]),
                          N("Add", ["h", "b1"], ["hb"]),
                          N("Tanh", ["hb"], ["t"]),
                          N("Gemm", ["t", "w2"], ["y"], transB=1)],
                         inits, [("x", (None, 3))], ["y"])
    x = _f(rng, 8, 3)
    jm, tm = jonnx.load_model_bytes(buf), tonnx.load_model_bytes(buf)
    jg = jax.grad(lambda p: jnp.sum(jnp.square(jm.apply(p, x))))(
        {k: jnp.asarray(v) for k, v in jm.params.items()})
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in tm.params.items()}
    loss = torch.square(tm.apply(params, torch.tensor(x))).sum()
    loss.backward()
    for k, p in params.items():
        assert p.grad.abs().sum() > 0
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg[k]),
                                   rtol=TOL, atol=TOL)


def test_served_reshape_target_stays_static():
    rng = np.random.default_rng(5)
    w = _f(rng, 12, 4)
    buf = P.encode_model([N("Reshape", ["x", "tgt"], ["f"]),
                          N("MatMul", ["f", "w"], ["y"])],
                         {"tgt": I64(-1, 12), "w": w},
                         [("x", (None, 3, 4))], ["y"])
    im = InferenceModel().do_load_onnx(buf)
    assert set(im.params) == {"w"} and set(im.model.static) == {"tgt"}
    assert isinstance(im.model.static["tgt"], np.ndarray)
    x = _f(rng, 2, 3, 4)
    got = im.do_predict(x)
    np.testing.assert_allclose(got, x.reshape(2, 12) @ w, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(JInferenceModel().do_load_onnx(buf).do_predict(x)),
        rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        got, tonnx.load_model_bytes(buf).predict(x))


def test_served_quantize_uses_the_onnx_channel_axis():
    rng = np.random.default_rng(6)
    # transB Gemm: weights (out, in) with wildly different per-OUT scales;
    # quantizing along the wrong axis would destroy the small-scale rows
    w = (rng.normal(size=(3, 16)) *
         np.array([[1e-3], [1.0], [100.0]])).astype(np.float32)
    b = np.zeros(3, np.float32)
    conv_w = _f(np.random.default_rng(7), 5, 2, 3, 3)
    buf = P.encode_model(
        [N("Gemm", ["x", "w", "b"], ["y"], transB=1)],
        {"w": w, "b": b}, [("x", (None, 16))], ["y"])
    conv = P.encode_model([N("Conv", ["img", "k"], ["y"])], {"k": conv_w},
                          [("img", (None, 2, 5, 5))], ["y"])
    assert InferenceModel().do_load_onnx(conv).model.quantize_axes == \
        JInferenceModel().do_load_onnx(conv).model.quantize_axes == {"k": 0}
    x = rng.normal(size=(4, 16)).astype(np.float32)  # tests/test_onnx.py's
    outs = []
    for cls in (InferenceModel, JInferenceModel):
        im = cls().do_load_onnx(buf)
        assert im.model.quantize_axes == {"w": 0}
        ref = np.asarray(im.do_predict(x))
        im.do_quantize()
        got = np.asarray(im.do_predict(x))
        rel = np.abs(got - ref) / np.maximum(np.abs(ref), 1e-6)
        assert rel.max() < 0.02, rel.max()
        outs.append(got)
    np.testing.assert_allclose(outs[0], outs[1], rtol=TOL, atol=TOL)


def test_highest_precision_holds_tf32_off_and_restores_it():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        with tonnx._ieee_f32(torch.device("cpu")):
            # the CPU has no TF32: nothing is touched
            assert torch.backends.cuda.matmul.allow_tf32
        with tonnx._ieee_f32(torch.device("cuda")):
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
