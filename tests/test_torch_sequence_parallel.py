"""Sequence parallelism of the port against the JAX package's on the same
inputs: ring attention (the einsum body) and Ulysses, causal and not, with
and without a key mask, on a 4-slot ``seq`` mesh against the JAX package's
functions on 4 of its 8 CPU devices; the ring's flash body
(``use_flash=True``: the kernels' plain versions here) against the JAX
package's ring on its Pallas kernel in interpret mode; the Ulysses
head-divisibility error;
and one ``Estimator.train`` step of a 2-block ``TransformerLayer`` under
``sequence_parallel="ring"`` on a (2, 1, 4) mesh against the JAX package's
same step on its (2, 1, 4) mesh (``__graft_entry__._dryrun_combined``'s
model, its weights carried by ``interop.load_jax_params``).

Tolerances are the JAX package's own (``tests/test_parallel.py``): forward
``FWD_TOL`` = 2e-5, gradients ``GRAD_ATOL`` = 5e-4 / ``GRAD_RTOL`` =
1e-3; the flash body ``FLASH_TOL`` = 2e-3 forward and gradients; the
train step's parameters ``STEP_TOL`` = 5e-5 and loss 1e-4 (the bound of
``_dryrun_combined``). The JAX functions run under ``jax.jit`` (one
compile per case instead of eager ``shard_map`` dispatch).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.common import nncontext as jctx
from analytics_zoo_tpu.data.feature_set import ArrayFeatureSet as JaxFS
from analytics_zoo_tpu.engine.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.engine.triggers import MaxEpoch as JaxMaxEpoch
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.keras.engine.base import reset_name_counts as jreset
from analytics_zoo_tpu.keras.engine.topology import Sequential as JaxSeq
from analytics_zoo_tpu.keras import layers as jlayers
from analytics_zoo_tpu.parallel import ring_attention as jra
from analytics_zoo_tpu_torch.common.tree import tree_leaves
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import objectives
from analytics_zoo_tpu_torch.keras import layers as tlayers
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.optimizers import SGD
from analytics_zoo_tpu_torch.parallel import ring_attention, ulysses_attention

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
STEP_TOL = 5e-5
FLASH_TOL = 2e-3
SHAPE = (2, 4, 32, 16)  # 4 heads: Ulysses splits them over 4 slots
FLASH_SHAPE = (1, 2, 512, 32)  # 128-row shards tile the kernels
CASES = [(engine, causal, masked) for engine in ("ring", "ulysses")
         for causal in (False, True) for masked in (False, True)]
FLASH_CASES = [("flash", causal, False) for causal in (False, True)]


@pytest.fixture(autouse=True)
def _port_context():
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(4,),
                        mesh_axis_names=("seq",))
    yield
    port.stop_nncontext()
    reset_name_counts()


def _padded_mask(b, s):
    km = np.ones((b, s), np.float32)
    km[:, 3 * s // 4:] = 0.0     # padded tail crossing shard boundaries
    km[0, s // 3:] = 0.0         # a heavily padded row
    return km


def _inputs(engine="ring"):
    rng = np.random.default_rng(3)
    shape = FLASH_SHAPE if engine == "flash" else SHAPE
    return ([rng.normal(size=shape).astype(np.float32) for _ in range(4)],
            _padded_mask(shape[0], shape[2]))


def _jax_fn(engine, mesh, causal, mask):
    if engine == "ulysses":
        return lambda a, b, c: jra.ulysses_attention(
            a, b, c, mesh, causal=causal, key_mask=mask)
    return lambda a, b, c: jra.ring_attention(
        a, b, c, mesh, causal=causal, key_mask=mask,
        use_flash=True if engine == "flash" else None)


@pytest.fixture(scope="module")
def jax_results():
    """Every case's JAX forward and (q, k, v) gradients of sum(out * g),
    built once."""
    zoo.init_nncontext()
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("seq",))
    out = {}
    try:
        for engine, causal, masked in CASES + FLASH_CASES:
            (q, k, v, g), km = _inputs(engine)
            fn = _jax_fn(engine, mesh, causal,
                         jnp.asarray(km) if masked else None)

            @jax.jit
            def both(a, b, c, cot, fn=fn):
                y, vjp = jax.vjp(fn, a, b, c)
                return y, vjp(cot)

            y, grads = both(*(jnp.asarray(t) for t in (q, k, v, g)))
            out[engine, causal, masked] = (
                np.asarray(y), [np.asarray(t) for t in grads])
    finally:
        jctx.stop_nncontext()
    return out


@pytest.mark.parametrize("engine,causal,masked", CASES + FLASH_CASES,
                         ids=[f"{e}-{'causal' if c else 'full'}-"
                              f"{'mask' if m else 'nomask'}"
                              for e, c, m in CASES + FLASH_CASES])
def test_sp_attention_matches_jax(jax_results, engine, causal, masked):
    (q, k, v, g), km = _inputs(engine)
    mesh = port.get_nncontext().mesh
    ts = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    if engine == "ulysses":
        y = ulysses_attention(*ts, mesh, causal=causal,
                              key_mask=torch.tensor(km) if masked else None)
    else:
        y = ring_attention(*ts, mesh, causal=causal,
                           key_mask=torch.tensor(km) if masked else None,
                           use_flash=True if engine == "flash" else None)
    grads = torch.autograd.grad((y * torch.tensor(g)).sum(), ts)
    want_y, want_g = jax_results[engine, causal, masked]
    fwd, atol, rtol = ((FLASH_TOL, FLASH_TOL, FLASH_TOL)
                       if engine == "flash"
                       else (FWD_TOL, GRAD_ATOL, GRAD_RTOL))
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0,
                               atol=fwd)
    for got, want, name in zip(grads, want_g, "qkv"):
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                                   atol=atol, err_msg=f"d{name}")


def test_sp_engines_auto_select_and_refuse():
    """The ring's flash body has no key mask; auto-select takes the einsum
    body off the card; Ulysses needs heads divisible by the seq axis (the
    JAX package's error)."""
    mesh = port.get_nncontext().mesh
    q = torch.zeros((1, 3, 8, 4))
    with pytest.raises(ValueError, match="must divide") as e:
        ulysses_attention(q, q, q, mesh)
    jmesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("seq",))
    with pytest.raises(ValueError, match="must divide") as je:
        jra.ulysses_attention(jnp.zeros((1, 3, 8, 4)),
                              jnp.zeros((1, 3, 8, 4)),
                              jnp.zeros((1, 3, 8, 4)), jmesh)
    assert str(e.value) == str(je.value)
    q = torch.zeros((1, 2, 256, 16))
    with pytest.raises(NotImplementedError, match="key_mask"):
        ring_attention(q, q, q, mesh, use_flash=True,
                       key_mask=torch.ones((1, 256)))
    tra = importlib.import_module(
        "analytics_zoo_tpu_torch.parallel.ring_attention")

    assert tra._flash_ring_shapes_ok(q, q, q, mesh, "seq")
    assert not tra._flash_ring_supported(q, q, q, mesh, "seq")  # CPU
    assert not tra._flash_ring_shapes_ok(q[:, :, :128], q[:, :, :128],
                                         q[:, :, :128], mesh, "seq")


def test_sequence_parallel_gates_like_jax():
    """The layer arms only on a mesh with a seq axis longer than 1, and
    refuses what the ring pass cannot carry, as the JAX layer does."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 64, 16)).astype(np.float32))
    from analytics_zoo_tpu_torch.keras.layers import attention as tatt

    mha = tatt.MultiHeadAttention(4, attn_dropout=0.1,
                                  sequence_parallel="ring", name="sp_mha")
    mha.ensure_built((None, 64, 16))
    params = mha.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="attention dropout"):
        mha.call(params, x, training=True,
                 rng=torch.Generator().manual_seed(1))
    mha.call(params, x, training=False)  # no dropout in inference
    with pytest.raises(ValueError, match="sequence_parallel"):
        tatt.MultiHeadAttention(4, sequence_parallel="tree")
    # pipeline and sequence parallelism on one mesh: the JAX package's
    # refusal, once both axes are there
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(2, 4),
                        mesh_axis_names=("pipe", "seq"))
    both = tatt.TransformerLayer(vocab=10, seq_len=8, n_block=2,
                                 hidden_size=16, n_head=4,
                                 pipeline_parallel=True,
                                 sequence_parallel="ring")
    both.ensure_built((None, 8))
    with pytest.raises(NotImplementedError,
                       match=r"pipeline_parallel \+ sequence_parallel"):
        both.call(both.init_params(torch.Generator().manual_seed(0)),
                  torch.zeros((2, 8), dtype=torch.long))
    # without a seq axis the same config runs the standard path, dropout
    # and all
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(4,),
                        mesh_axis_names=("data",))
    assert mha._sp_mesh() is None
    mha.call(params, x, training=True, rng=torch.Generator().manual_seed(1))


def _combo(L, sp, S, V):
    """``_dryrun_combined``'s model in the layer library ``L``."""
    return [L.TransformerLayer(vocab=V, seq_len=S, n_block=2,
                               hidden_size=32, n_head=4, embedding_drop=0.0,
                               hidden_drop=0.0, attn_drop=0.0,
                               sequence_parallel=sp, input_shape=(S,),
                               name="combo_t"),
            L.GlobalAveragePooling1D(),
            L.Dense(4, activation="softmax", name="combo_head")]


def test_ring_train_step_matches_jax_on_its_mesh():
    """One Estimator.train step of _dryrun_combined's model under ring
    sequence parallelism on a (data=2, model=1, seq=4) mesh, the port
    against the JAX package (which also splits the batch over its data
    axis: the same step to rounding)."""
    rng = np.random.default_rng(7)
    B, S, V = 16, 32, 50
    ids = rng.integers(0, V, (B, S)).astype(np.int32)
    y = rng.integers(0, 4, B).astype(np.int32)
    names = ("data", "model", "seq")
    jctx.stop_nncontext()
    jreset()
    zoo.init_nncontext(mesh_shape=(2, 1, 4), mesh_axis_names=names)
    try:
        jmodel = JaxSeq(_combo(jlayers, "ring", S, V))
        jest = JaxEstimator(jmodel, jopt.SGD(lr=0.1, momentum=0.9))
        jest._ensure_state()
        init = jax.tree_util.tree_map(np.asarray, jest.tstate.params)
        jest.train(JaxFS(ids, y), jobj.sparse_categorical_crossentropy,
                   end_trigger=JaxMaxEpoch(1), batch_size=B)
        jfinal = jax.tree_util.tree_map(np.asarray, jest.tstate.params)
        jloss = float(jest.run_state.loss)
    finally:
        jctx.stop_nncontext()

    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(2, 1, 4),
                        mesh_axis_names=names)
    reset_name_counts()
    model = Sequential(_combo(tlayers, "ring", S, V))
    load_jax_params(model, init)
    assert model.layers()[0].blocks[0].attn._sp_mesh() is not None
    est = Estimator(model, SGD(lr=0.1, momentum=0.9))
    est.train(ArrayFeatureSet(ids, y),
              objectives.sparse_categorical_crossentropy,
              end_trigger=MaxEpoch(1), batch_size=B)
    assert est.run_state.iteration == 1
    assert abs(float(est.run_state.loss) - jloss) < 1e-4
    reset_name_counts()
    want = tree_leaves(load_jax_params(
        Sequential(_combo(tlayers, None, S, V)), jfinal))
    got = tree_leaves(est.tstate.params)
    assert len(got) == len(want)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    assert err < STEP_TOL, err
