"""The port's recurrent layers against the JAX package: ``SimpleRNN``,
``LSTM`` and ``GRU`` (both layouts: the default split ``U``/``U_h`` and
``reset_after`` with ``b_rec``), ``go_backwards``, ``return_sequences``,
timestep masks (an ``[x, mask]`` pair), ``run`` with an explicit carry,
``step_once`` against ``run``, ``Bidirectional`` and ``TimeDistributed``,
the gradients of a loss through them, and the ``orthogonal`` initializer.

Each JAX layer's weights are carried over by ``load_jax_params``; inputs
come from a numpy seed. Tolerances, absolute: outputs and carries 1e-6
(the same float32 cell arithmetic over 7 steps; XLA and PyTorch sum the
matmuls in other orders, measured at most 2.4e-7); gradients 1e-5 (a
backward through 7 steps; measured at most 1.5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras import layers as JL
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.keras.engine import topology as jtopo
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import layers as TL
from analytics_zoo_tpu_torch.keras.engine import base as tbase
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential

TOL = 1e-6
GRAD_TOL = 1e-5
B, T, D, U = 3, 7, 5, 4


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    # row lengths 7, 4, 1 (left-aligned) and one row masked in the middle
    mask = (np.arange(T)[None] < np.array([[T], [4], [1]])).astype(
        np.float32)
    mask[0, 3] = 0.0
    return x, mask


def _pair(jlayer, tlayer, shape, seed=0):
    jlayer.ensure_built(shape)
    tlayer.ensure_built(shape)
    jp = jlayer.init_params(jax.random.PRNGKey(seed))
    tp = load_jax_params(tlayer, jax.tree_util.tree_map(np.asarray, jp))
    return jp, tp


def _np(t):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), t)


def _close(got, want, tol=TOL):
    for a, b in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.detach().numpy(), got,
                                   is_leaf=lambda t: isinstance(
                                       t, torch.Tensor))),
            jax.tree_util.tree_leaves(_np(want)), strict=True):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


CELLS = [("SimpleRNN", {}), ("LSTM", {}), ("GRU", {}),
         ("GRU", {"reset_after": True})]
CELL_IDS = ["simplernn", "lstm", "gru", "gru_reset_after"]


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
@pytest.mark.parametrize("return_sequences", [False, True])
@pytest.mark.parametrize("go_backwards", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_cells_match_jax(cell, return_sequences, go_backwards, masked):
    name, kw = cell
    kw = dict(kw, return_sequences=return_sequences,
              go_backwards=go_backwards)
    jl, tl = getattr(JL, name)(U, **kw), getattr(TL, name)(U, **kw)
    shape = [(None, T, D), (None, T)] if masked else (None, T, D)
    jp, tp = _pair(jl, tl, shape)
    x, mask = _inputs()
    jx = [jnp.asarray(x), jnp.asarray(mask)] if masked else jnp.asarray(x)
    tx = [torch.tensor(x), torch.tensor(mask)] if masked else torch.tensor(x)
    got = tl.call(tp, tx)
    _close(got, jl.call(jp, jx))
    assert tuple(got.shape[1:]) == tuple(tl.compute_output_shape(shape)[1:])
    assert tl.compute_output_shape(shape) == jl.compute_output_shape(shape)


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_run_carries_and_step_once_match_jax(cell):
    """``run`` with a given initial carry returns the JAX outputs and
    final carry (masked too), and stepping ``step_once`` reproduces
    ``run`` step by step."""
    name, kw = cell
    jl, tl = getattr(JL, name)(U, **kw), getattr(TL, name)(U, **kw)
    jp, tp = _pair(jl, tl, (None, T, D))
    x, mask = _inputs(1)
    rng = np.random.default_rng(2)
    carry = jax.tree_util.tree_map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        _np(jl.initial_carry(B)))
    tcarry = jax.tree_util.tree_map(torch.tensor, carry)
    for m in (None, mask):
        jys, jc = jl.run(jp, jnp.asarray(x),
                         jax.tree_util.tree_map(jnp.asarray, carry),
                         mask=None if m is None else jnp.asarray(m))
        tys, tc = tl.run(tp, torch.tensor(x), tcarry,
                         mask=None if m is None else torch.tensor(m))
        _close(tys, jys)
        _close(tc, jc)
    c, outs = tcarry, []
    for t in range(T):
        c, y = tl.step_once(tp, c, torch.tensor(x[:, t]))
        outs.append(y)
    tys, tc = tl.run(tp, torch.tensor(x), tcarry)
    assert torch.equal(torch.stack(outs, 1), tys)
    for a, b in zip(jax.tree_util.tree_leaves(c),
                    jax.tree_util.tree_leaves(tc)):
        assert torch.equal(a, b)


def test_masked_steps_hold_the_carry():
    """A row whose mask ends at step n gives the carry of its first n
    steps, bitwise, whatever follows."""
    tl = TL.LSTM(U)
    tl.ensure_built((None, T, D))
    tp = tl.init_params(torch.Generator().manual_seed(0))
    x, _ = _inputs()
    mask = np.zeros((B, T), np.float32)
    mask[:, :3] = 1.0
    _, full = tl.run(tp, torch.tensor(x), mask=torch.tensor(mask))
    _, short = tl.run(tp, torch.tensor(x[:, :3]))
    for a, b in zip(full, short):
        assert torch.equal(a, b)


@pytest.mark.parametrize("merge_mode", ["concat", "sum", "mul", "ave"])
@pytest.mark.parametrize("return_sequences", [False, True])
def test_bidirectional_matches_jax(merge_mode, return_sequences):
    jl = JL.Bidirectional(JL.GRU(U, return_sequences=return_sequences),
                          merge_mode=merge_mode)
    tl = TL.Bidirectional(TL.GRU(U, return_sequences=return_sequences),
                          merge_mode=merge_mode)
    jp, tp = _pair(jl, tl, (None, T, D))
    assert set(tp) == {"forward", "backward"}
    x, _ = _inputs(3)
    _close(tl.call(tp, torch.tensor(x)), jl.call(jp, jnp.asarray(x)))
    assert tl.compute_output_shape((None, T, D)) == \
        jl.compute_output_shape((None, T, D))


@pytest.mark.parametrize("inner", ["dense", "lstm_seq"])
def test_time_distributed_matches_jax(inner):
    if inner == "dense":
        jl = JL.TimeDistributed(JL.Dense(3, activation="tanh"))
        tl = TL.TimeDistributed(TL.Dense(3, activation="tanh"))
        shape = (None, T, D)
        x = _inputs(4)[0]
    else:  # an RNN applied to each of 2 sub-sequences
        jl = JL.TimeDistributed(JL.LSTM(U))
        tl = TL.TimeDistributed(TL.LSTM(U))
        shape = (None, 2, T, D)
        x = np.stack([_inputs(4)[0], _inputs(5)[0]], axis=1)
    jp, tp = _pair(jl, tl, shape)
    _close(tl.call(tp, torch.tensor(x)), jl.call(jp, jnp.asarray(x)))
    assert tl.compute_output_shape(shape) == jl.compute_output_shape(shape)


@pytest.mark.parametrize("cell", CELLS, ids=CELL_IDS)
def test_gradients_through_a_stack_match_jax(cell):
    """A Sequential (cell with sequences -> Bidirectional LSTM ->
    TimeDistributed Dense -> backwards GRU) carried from the JAX package:
    the loss gradient of every leaf."""
    name, kw = cell
    jbase.reset_name_counts()
    reset_name_counts()

    def build(L, sequential):
        m = sequential()
        m.add(getattr(L, name)(U, return_sequences=True,
                               input_shape=(T, D), **kw))
        m.add(L.Bidirectional(L.LSTM(U, return_sequences=True)))
        m.add(L.TimeDistributed(L.Dense(3)))
        m.add(L.GRU(2, go_backwards=True))
        return m

    jnet, tnet = build(JL, jtopo.Sequential), build(TL, Sequential)
    jp, _ = jnet.init(jax.random.PRNGKey(7))
    tp = load_jax_params(tnet, _np(jp))
    x, _ = _inputs(6)

    def jloss(p):
        y, _ = jnet.apply(p, {}, jnp.asarray(x))
        return jnp.sum(jnp.square(y))

    jg = jax.grad(jloss)(jp)
    leaves = [t.clone().requires_grad_(True)
              for t in jax.tree_util.tree_leaves(tp)]
    tp_req = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                          leaves)
    y, _ = tnet.apply(tp_req, {}, torch.tensor(x))
    (y ** 2).sum().backward()
    tg = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp),
                                      [t.grad for t in leaves])
    _close(tg, jg, GRAD_TOL)


@pytest.mark.parametrize("shape", [(4, 8), (8, 4), (6, 6), (3, 2, 5)])
def test_orthogonal_initializer(shape):
    """The recurrent kernels' initializer: orthonormal columns (or rows,
    when there are fewer rows than columns), drawn from the generator."""
    w = tbase.get_initializer("orthogonal")(
        torch.Generator().manual_seed(0), shape)
    assert tuple(w.shape) == shape
    m = w.reshape(-1, shape[-1]).double()
    gram = m.T @ m if m.shape[0] >= m.shape[1] else m @ m.T
    np.testing.assert_allclose(gram.numpy(), np.eye(gram.shape[0]),
                               rtol=0, atol=1e-5)
    again = tbase.get_initializer("orthogonal")(
        torch.Generator().manual_seed(0), shape)
    assert torch.equal(w, again)


def test_layer_trees_and_specs_match_jax():
    """Parameter names and shapes equal the JAX package's, leaf by leaf:
    the weight map is 1:1."""
    for jl, tl in ((JL.LSTM(U), TL.LSTM(U)),
                   (JL.GRU(U), TL.GRU(U)),
                   (JL.GRU(U, reset_after=True),
                    TL.GRU(U, reset_after=True)),
                   (JL.Bidirectional(JL.SimpleRNN(U)),
                    TL.Bidirectional(TL.SimpleRNN(U)))):
        jp, tp = _pair(jl, tl, (None, T, D))
        jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        tshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
        assert jshapes == tshapes
    b = TL.LSTM(U)
    b.ensure_built((None, T, D))
    bias = b.init_params(torch.Generator().manual_seed(0))["b"]
    assert bias[U:2 * U].eq(1).all() and bias[:U].eq(0).all()


def test_mask_pair_main_shape():
    assert tbase.mask_pair_main_shape([(None, T, D), (None, T)]) == \
        (None, T, D)
    assert tbase.mask_pair_main_shape((None, T, D)) == (None, T, D)
    assert tbase.mask_pair_main_shape([(None, T, D), (None, T)]) == \
        jbase.mask_pair_main_shape([(None, T, D), (None, T)])
