"""The port's convolution, pooling, core and graph layers against the JAX
package's, on the same numpy inputs and the JAX weights carried over by
``interop.load_jax_params``.

``Convolution2D`` runs in both orderings, ``same`` and ``valid``, strides 1
and 2, kernels 1, 3 and 7, at an odd and an even input size: the strided
``same`` cases on even sizes are the ones where XLA pads asymmetrically
(7x7/2 on 10: low 2, high 3; 3x3/2: low 0, high 1), which a symmetric
``padding=`` would shift by one row and column without changing the output
shape. Forward values and the gradients of the input and of every weight
(``jax.grad`` against autograd) are held. Then max and average pooling in
both border modes, global pooling, ``ZeroPadding2D``, the activation table,
``Merge`` in every mode, ``Dropout``, and a functional graph with
``Variable`` arithmetic; and the two routes of a layer's ``__call__``.

Tolerance: f32, ``rtol = atol = 1e-5`` (the same f32 sums over at most
7 * 7 * 3 products, or 2 * 10 * 10 positions for a weight gradient, in
another order).
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu.keras.layers as jl
from analytics_zoo_tpu.autograd.variable import Variable as JaxVariable
from analytics_zoo_tpu.keras.engine.topology import Input as JaxInput
from analytics_zoo_tpu.keras.engine.topology import Model as JaxModel
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.keras.layers as tl
from analytics_zoo_tpu_torch.autograd.variable import Node, Variable
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Input, Model

TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=tol)


def _pair(make, shape, seed=0):
    """The same layer built in both packages on ``shape`` (batch-free),
    with the JAX weights (perturbed off their init, so biases are not 0)
    carried into the port's."""
    jlayer, tlayer = make(jl), make(tl)
    jlayer.ensure_built((None,) + shape)
    tlayer.ensure_built((None,) + shape)
    rng = np.random.default_rng(seed)
    jparams = {k: (np.asarray(v) + rng.normal(0, 0.1, v.shape)
                   ).astype(np.float32)
               for k, v in jlayer.init_params(jax.random.PRNGKey(seed)
                                              ).items()}
    tparams = load_jax_params(tlayer, jparams)
    assert tlayer.output_shape == jlayer.output_shape
    return jlayer, tlayer, jparams, tparams


def _check_forward_and_grads(jlayer, tlayer, jparams, tparams, x):
    """Forward values, and the gradients of sum(out * cot) with respect to
    the input and every weight."""
    out_shape = jax.eval_shape(jlayer.call, jparams, x).shape
    cot = np.random.default_rng(7).standard_normal(out_shape).astype(
        np.float32)

    @jax.jit
    def jfwd_bwd(p, xx):
        out, vjp = jax.vjp(jlayer.call, p, xx)
        return out, vjp(cot)

    jout, (jgp, jgx) = jfwd_bwd(jparams, x)
    tp = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout = tlayer.call(tp, tx)
    assert tuple(tout.shape) == jout.shape
    assert tuple(tout.shape[1:]) == tuple(jlayer.output_shape[1:])
    _close(tout.detach(), jout)
    (tout * torch.tensor(cot)).sum().backward()
    _close(tx.grad, jgx)
    for k in jparams:
        _close(tp[k].grad, jgp[k])


def _image(rng, ordering, size, channels=3, batch=2):
    shape = ((batch, channels, size, size) if ordering == "th"
             else (batch, size, size, channels))
    return rng.standard_normal(shape).astype(np.float32)


def _shape(ordering, size, channels=3):
    return ((channels, size, size) if ordering == "th"
            else (size, size, channels))


# -- convolution -------------------------------------------------------------


CONV_CASES = list(itertools.product(["th", "tf"], ["same", "valid"], [1, 2],
                                    [1, 3, 7], [9, 10]))


@pytest.mark.parametrize("ordering,border,stride,k,size", CONV_CASES)
def test_convolution2d_matches_jax(ordering, border, stride, k, size):
    def make(lib):
        return lib.Convolution2D(4, (k, k), subsample=stride,
                                 border_mode=border, dim_ordering=ordering,
                                 activation="relu" if k == 3 else None)

    pair = _pair(make, _shape(ordering, size))
    x = _image(np.random.default_rng(size * 10 + k), ordering, size)
    _check_forward_and_grads(*pair, x)


@pytest.mark.parametrize("ordering,border,stride,dilation,bias", [
    ("tf", "same", 1, 2, True), ("th", "valid", 1, 2, False),
    ("tf", "valid", 2, 2, False), ("th", "same", 1, (2, 1), True)])
def test_convolution2d_dilation_and_bias_match_jax(ordering, border, stride,
                                                    dilation, bias):
    def make(lib):
        # the Keras-1 form: (nb_filter, nb_row, nb_col)
        return lib.Convolution2D(5, 3, 3, subsample=stride,
                                 border_mode=border, dim_ordering=ordering,
                                 dilation=dilation, bias=bias)

    pair = _pair(make, _shape(ordering, 11))
    assert pair[1].kernel_size == (3, 3)
    assert ("bias" in pair[3]) is bias
    _check_forward_and_grads(*pair, _image(np.random.default_rng(3),
                                           ordering, 11))


def test_convolution2d_rejects_ambiguous_positionals():
    with pytest.raises(TypeError, match="by keyword"):
        tl.Convolution2D(4, (3, 3), 2)


# -- pooling and padding -------------------------------------------------------


POOL_CASES = list(itertools.product(["max", "avg"], ["th", "tf"],
                                    ["same", "valid"], [(2, None), (3, 2),
                                                        (3, 1)], [9, 10]))


@pytest.mark.parametrize("op,ordering,border,pool,size", POOL_CASES)
def test_pooling_matches_jax(op, ordering, border, pool, size):
    k, stride = pool
    name = "MaxPooling2D" if op == "max" else "AveragePooling2D"

    def make(lib):
        return getattr(lib, name)((k, k), strides=stride,
                                  border_mode=border, dim_ordering=ordering)

    pair = _pair(make, _shape(ordering, size))
    _check_forward_and_grads(*pair, _image(np.random.default_rng(size),
                                           ordering, size))


@pytest.mark.parametrize("op", ["GlobalAveragePooling2D",
                                "GlobalMaxPooling2D"])
@pytest.mark.parametrize("ordering", ["th", "tf"])
def test_global_pooling_matches_jax(op, ordering):
    pair = _pair(lambda lib: getattr(lib, op)(dim_ordering=ordering),
                 _shape(ordering, 6, channels=4))
    _check_forward_and_grads(*pair, _image(np.random.default_rng(1),
                                           ordering, 6, channels=4))


@pytest.mark.parametrize("padding", [1, (1, 2), (0, 1, 2, 3),
                                     ((2, 0), (1, 3))])
@pytest.mark.parametrize("ordering", ["th", "tf"])
def test_zero_padding_matches_jax(padding, ordering):
    pair = _pair(lambda lib: lib.ZeroPadding2D(padding,
                                               dim_ordering=ordering),
                 _shape(ordering, 5))
    _check_forward_and_grads(*pair, _image(np.random.default_rng(2),
                                           ordering, 5))


# -- core layers ------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tl.core._ACTIVATIONS))
def test_activations_match_jax(name):
    from analytics_zoo_tpu.keras.layers.core import _ACTIVATIONS as jacts

    x = np.random.default_rng(4).standard_normal((3, 7)).astype(
        np.float32) * 3
    pair = _pair(lambda lib: lib.Activation(name), (7,))
    _check_forward_and_grads(*pair, x)
    assert set(tl.core._ACTIVATIONS) == set(jacts)


@pytest.mark.parametrize("mode", ["sum", "mul", "max", "min", "ave",
                                  "concat", "dot", "cosine"])
def test_merge_matches_jax(mode):
    rng = np.random.default_rng(5)
    n = 2 if mode in ("dot", "cosine") else 3
    xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(n)]
    jm, tm = jl.Merge(mode=mode), tl.Merge(mode=mode)
    jm.ensure_built([(None, 6)] * n)
    tm.ensure_built([(None, 6)] * n)
    assert tm.output_shape == jm.output_shape
    _close(tm.call({}, [torch.tensor(x) for x in xs]),
           jm.call({}, [jnp.asarray(x) for x in xs]))


def test_flatten_keeps_the_nhwc_order():
    x = np.random.default_rng(6).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    pair = _pair(lambda lib: lib.Flatten(), (3, 4, 5))
    assert pair[1].output_shape == (None, 60)
    _check_forward_and_grads(*pair, x)


def test_dropout_draws_from_the_step_generator():
    layer = tl.Dropout(0.25)
    x = torch.ones(200, 100)
    assert layer.call({}, x, training=False) is x
    assert layer.call({}, x, training=True, rng=None) is x
    gen = port.get_nncontext().step_generator
    state = gen.get_state()
    y = layer.call({}, x, training=True, rng=gen)
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.75) < 0.01
    assert torch.all((y == 0) | (y == 1 / 0.75))
    gen.set_state(state)
    assert torch.equal(layer.call({}, x, training=True, rng=gen), y)


# -- the functional graph -----------------------------------------------------


def _graph(lib, Input_, Model_):
    a = Input_(shape=(6,), name="a")
    b = Input_(shape=(6,), name="b")
    h = lib.Dense(5, activation="tanh", name="d1")(a)
    g = lib.Dense(5, name="d2")(b)
    s = lib.merge([h, g], mode="concat")
    y = (h + g) * 2.0 - g / 4.0
    y = (-y).slice(1, 1, 3)
    out = lib.Dense(2, name="head")(lib.merge([y, s.slice(1, 0, 3)],
                                               mode="sum"))
    return Model_([a, b], out)


def test_functional_graph_with_variable_arithmetic_matches_jax():
    jmodel = _graph(jl, JaxInput, JaxModel)
    tmodel = _graph(tl, Input, Model)
    assert [l.name for l in tmodel.layers() if l.param_specs()] == [
        "d1", "d2", "head"]
    jparams, jstate = jmodel.init(jax.random.PRNGKey(0))
    load_jax_params(tmodel, jparams, jstate)
    rng = np.random.default_rng(8)
    xs = [rng.standard_normal((4, 6)).astype(np.float32) for _ in range(2)]
    jout, _ = jmodel.apply(jparams, jstate, [jnp.asarray(x) for x in xs])
    tout, tstate = tmodel.apply(tmodel.params, tmodel.model_state,
                                [torch.tensor(x) for x in xs])
    assert tstate == {} and tmodel.get_output_shape() == (None, 2)
    _close(tout, jout)
    with pytest.raises(ValueError, match="2 inputs"):
        tmodel.apply(tmodel.params, {}, torch.tensor(xs[0]))


@pytest.mark.parametrize("op", ["index_select", "squeeze", "expand_dims",
                                "replicate", "rsub", "rdiv", "pow"])
def test_variable_ops_match_jax(op):
    def build(Input_, Model_):
        v = Input_(shape=(1, 4, 3), name="v")
        out = {"index_select": lambda: v.index_select(3, 1),
               "squeeze": lambda: v.squeeze(1),
               "expand_dims": lambda: v.expand_dims(2),
               "replicate": lambda: v.replicate(2, 2),
               "rsub": lambda: 1.5 - v,
               "rdiv": lambda: 2.0 / (v * v + 1.0),
               "pow": lambda: (v * v) ** 1.5}[op]()
        return Model_(v, out)

    jmodel, tmodel = build(JaxInput, JaxModel), build(Input, Model)
    assert tmodel.get_output_shape() == jmodel.get_output_shape()
    x = np.random.default_rng(9).standard_normal((2, 1, 4, 3)).astype(
        np.float32)
    jout, _ = jmodel.apply({}, {}, jnp.asarray(x))
    tout, _ = tmodel.apply({}, {}, torch.tensor(x))
    _close(tout, jout)


def test_layer_call_dispatch_symbolic_and_eager():
    """A layer called on a Variable (or a list of them) wires a graph node;
    on anything else it is the nn.Module call, which runs ``call``."""
    dense = tl.Dense(3, name="dense_x")
    v = Input(shape=(4,))
    out = dense(v)
    assert isinstance(out, Variable) and isinstance(out.node, Node)
    assert out.node.layer is dense and out.node.inbound == [v]
    assert out.shape == (None, 3) and dense.built
    merged = tl.Merge(mode="sum")([out, out])
    assert isinstance(merged, Variable) and merged.node.inbound == [out, out]
    # the JAX package's symbolic call gives the same wiring
    jout = jl.Dense(3)(JaxInput(shape=(4,)))
    assert isinstance(jout, JaxVariable) and jout.shape == out.shape
    params = {"kernel": torch.ones(4, 3), "bias": torch.zeros(3)}
    y = dense(params, torch.ones(2, 4))  # nn.Module.__call__ -> forward
    assert isinstance(y, torch.Tensor)
    assert torch.equal(y, torch.full((2, 3), 4.0))
    pooled = tl.GlobalAveragePooling2D(dim_ordering="tf")(
        {}, torch.ones(2, 3, 3, 5))
    assert isinstance(pooled, torch.Tensor) and pooled.shape == (2, 5)
