"""GPipe stages over a mesh axis in the port against the JAX package:
``parallel.pipeline.pipeline_apply`` on a 4-slot ``pipe`` mesh and on a
(2, 4) ``data`` x ``pipe`` mesh against the JAX package's
``pipeline_apply`` on its CPU devices under ``jax.jit`` (eager
``shard_map`` costs the JAX package's own test 99.6 s), its error
messages word for word, and ``TransformerLayer(pipeline_parallel=True)``
on a (2, 4) slot mesh against the JAX package's sequential layer
(``pipeline_parallel=False``) at the sizes of
``tests/test_attention.py::test_pipeline_parallel_layer_matches_sequential``,
with the layer's guards and microbatch choice.

Tolerances: ``pipeline_apply`` forward ``FWD_TOL`` 1e-5 relative / 1e-6
absolute (the JAX test's), gradients ``GRAD_TOL`` 1e-5 absolute (float32,
tanh stages of width 16); the layer's forward ``LAYER_FWD_TOL`` 2e-5 and
its gradients ``LAYER_GRAD_TOL`` 5e-5 absolute (the JAX test's, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.keras.engine.base import reset_name_counts as jreset
from analytics_zoo_tpu.keras.layers import TransformerLayer as JaxLayer
from analytics_zoo_tpu.parallel import pipeline as jpipe
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.layers import attention as tatt
from analytics_zoo_tpu_torch.mesh.slots import SlotMesh
from analytics_zoo_tpu_torch.parallel import (
    pipeline_apply,
    stack_stage_params,
)

FWD_TOL = (1e-5, 1e-6)
GRAD_TOL = 1e-5
LAYER_FWD_TOL = 2e-5
LAYER_GRAD_TOL = 5e-5
S, D = 4, 16
LAYER = dict(vocab=40, seq_len=16, n_block=8, hidden_size=16, n_head=4,
             embedding_drop=0.0, hidden_drop=0.0, attn_drop=0.0)


@pytest.fixture(autouse=True)
def _port_context():
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(2, 4),
                        mesh_axis_names=("data", "pipe"))
    yield
    port.stop_nncontext()
    reset_name_counts()


def _stage_inputs():
    rng = np.random.default_rng(0)
    params = [{"w": (rng.normal(size=(D, D)) * 0.3).astype(np.float32),
               "b": (rng.normal(size=(D,)) * 0.1).astype(np.float32)}
              for _ in range(S)]
    x = rng.normal(size=(24, D)).astype(np.float32)
    g = rng.normal(size=(24, D)).astype(np.float32)
    return params, x, g


def _port_mesh(shape, names):
    return SlotMesh.deal(shape, names, torch.device("cpu"))


def _jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


@pytest.mark.parametrize("shape,names,data_axis", [
    ((4,), ("pipe",), None),
    ((2, 4), ("data", "pipe"), "data")], ids=["pp", "dp_pp"])
def test_pipeline_apply_matches_jax(shape, names, data_axis):
    """Outputs and the gradients of sum(out * g) in the stacked parameters
    and the input, against the JAX package's pipeline_apply on its mesh
    of the same shape; the stage runs S x M times a data shard."""
    params, x, g = _stage_inputs()

    def jstage(p, t):
        return jnp.tanh(t @ p["w"] + p["b"])

    jmesh = _jax_mesh(shape, names)

    @jax.jit
    def jrun(stacked, xx, cot):
        out, vjp = jax.vjp(lambda p, a: jpipe.pipeline_apply(
            jstage, p, a, jmesh, n_microbatches=6, data_axis=data_axis),
            stacked, xx)
        return out, vjp(cot)

    jstacked = jpipe.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in params])
    jout, (jgp, jgx) = jrun(jstacked, jnp.asarray(x), jnp.asarray(g))

    calls = []

    def tstage(p, t):
        calls.append(t.shape[0])
        return torch.tanh(t @ p["w"] + p["b"])

    tp = [{k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
          for p in params]
    tx = torch.tensor(x, requires_grad=True)
    out = pipeline_apply(tstage, stack_stage_params(tp), tx,
                         _port_mesh(shape, names), n_microbatches=6,
                         data_axis=data_axis)
    n_data = shape[0] if data_axis else 1
    assert calls == [24 // 6 // n_data] * (S * 6 * n_data)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL[0], atol=FWD_TOL[1])
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=GRAD_TOL)
    for s in range(S):
        for key in ("w", "b"):
            np.testing.assert_allclose(tp[s][key].grad.numpy(),
                                       np.asarray(jgp[key][s]), rtol=0,
                                       atol=GRAD_TOL)


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_pipeline_apply_errors_equal_the_jax_package():
    """The four refusals in the JAX package's words: the stacked lead
    dim against the axis, batch % microbatches, the microbatch against
    the data axis, and a stage that changes its activation's shape or
    dtype."""
    params, x, _ = _stage_inputs()
    jm1, tm1 = _jax_mesh((4,), ("pipe",)), _port_mesh((4,), ("pipe",))
    jm2 = _jax_mesh((2, 4), ("data", "pipe"))
    tm2 = _port_mesh((2, 4), ("data", "pipe"))
    jst = jpipe.stack_stage_params(
        [jax.tree_util.tree_map(jnp.asarray, p) for p in params])
    tst = stack_stage_params(
        [{k: torch.tensor(v) for k, v in p.items()} for p in params])
    jx, tx = jnp.asarray(x), torch.tensor(x)

    def jfn(p, t):
        return jnp.tanh(t @ p["w"] + p["b"])

    def tfn(p, t):
        return torch.tanh(t @ p["w"] + p["b"])

    cases = [
        (lambda: jpipe.pipeline_apply(jfn, jax.tree_util.tree_map(
            lambda a: a[:3], jst), jx, jm1, 6),
         lambda: pipeline_apply(tfn, {k: v[:3] for k, v in tst.items()},
                                tx, tm1, 6)),
        (lambda: jpipe.pipeline_apply(jfn, jst, jx, jm1, 5),
         lambda: pipeline_apply(tfn, tst, tx, tm1, 5)),
        (lambda: jpipe.pipeline_apply(jfn, jst, jx, jm2, 8,
                                      data_axis="data"),
         lambda: pipeline_apply(tfn, tst, tx, tm2, 8, data_axis="data")),
        (lambda: jax.jit(lambda a: jpipe.pipeline_apply(
            lambda p, t: t[:, :4], jst, a, jm1, 6))(jx),
         lambda: pipeline_apply(lambda p, t: t[:, :4], tst, tx, tm1, 6)),
        (lambda: jax.jit(lambda a: jpipe.pipeline_apply(
            lambda p, t: t.astype(jnp.bfloat16), jst, a, jm1, 6))(jx),
         lambda: pipeline_apply(lambda p, t: t.to(torch.bfloat16), tst, tx,
                                tm1, 6)),
    ]
    for jcall, tcall in cases:
        assert _raised(tcall) == _raised(jcall)


@pytest.fixture(scope="module")
def jax_layer_results():
    """The JAX package's sequential TransformerLayer (the pipelined one's
    reference in its own test) at that test's sizes: its parameters, the
    ids, the output and the gradients of mean(out ** 2), under
    ``jax.jit``."""
    jreset()
    layer = JaxLayer(**LAYER, pipeline_parallel=False, name="pp_tl")
    layer.ensure_built((None, 16))
    params = layer.init_params(jax.random.PRNGKey(2))
    ids = np.random.default_rng(1).integers(0, 40, (4, 16)).astype(np.int32)

    def loss(p):
        out = layer.call(p, jnp.asarray(ids), training=False)
        return jnp.mean(jnp.square(out)), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    jreset()
    to_np = jax.tree_util.tree_map(np.asarray, (params, out, grads))
    return to_np[0], ids, to_np[1], to_np[2]


def _port_layer(params, **kw):
    layer = tatt.TransformerLayer(**{**LAYER, **kw}, name="pp_tl")
    layer.ensure_built((None, 16))
    tparams = load_jax_params(layer, params)
    return layer, tparams


def _grads_of(layer, tparams, ids, training=False):
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tparams)]
    p = tree_unflatten(tparams, leaves)
    out = layer.call(p, torch.tensor(ids), training=training)
    (out.float() ** 2).mean().backward()
    return out.detach(), [t.grad for t in leaves]


def test_pipeline_parallel_layer_matches_jax(jax_layer_results,
                                             monkeypatch):
    """On the (2, 4) data x pipe mesh the block stack runs as GPipe
    stages (2 blocks a stage, 2 microbatches of 2 rows, each data shard
    its own pipe line: 8 blocks x 2 microbatches x 2 shards = 32 block
    calls): output and gradients against the JAX package's sequential
    layer, and the port's sequential layer within the same bounds."""
    params, ids, jout, jgrads = jax_layer_results
    layer, tparams = _port_layer(params, pipeline_parallel=True)
    assert layer._pipe_mesh() is not None
    calls = []
    block_call = tatt.TransformerBlock.call

    def counted(self, *a, **kw):
        calls.append(self.name)
        return block_call(self, *a, **kw)

    monkeypatch.setattr(tatt.TransformerBlock, "call", counted)
    out, grads = _grads_of(layer, tparams, ids)
    assert len(calls) == 8 * 2 * 2
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=LAYER_FWD_TOL)
    gtree = tree_unflatten(tparams, grads)
    jtree = load_jax_params(layer, jgrads)
    for a, b in zip(tree_leaves(gtree), tree_leaves(jtree)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LAYER_GRAD_TOL)
    layer.pipeline_parallel = False
    seq_out, seq_grads = _grads_of(layer, tparams, ids)
    np.testing.assert_allclose(out.numpy(), seq_out.numpy(), rtol=0,
                               atol=LAYER_FWD_TOL)
    for a, b in zip(grads, seq_grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=LAYER_GRAD_TOL)


def test_pipeline_parallel_remat_and_mesh_gating(jax_layer_results,
                                                 monkeypatch):
    """Under ``remat=True`` a training step's gradients are bitwise those
    without it; off a mesh with a pipe axis the layer runs the sequential
    loop bitwise ``pipeline_parallel=False``; ``pipe_microbatches``
    overrides the 4 x p default."""
    params, ids, _, _ = jax_layer_results
    plain, tp = _port_layer(params, pipeline_parallel=True)
    remat, _ = _port_layer(params, pipeline_parallel=True, remat=True)
    a_out, a_grads = _grads_of(plain, tp, ids, training=True)
    b_out, b_grads = _grads_of(remat, tp, ids, training=True)
    assert torch.equal(a_out, b_out)
    for a, b in zip(a_grads, b_grads):
        assert torch.equal(a, b)

    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(8,),
                        mesh_axis_names=("data",))
    assert plain._pipe_mesh() is None
    off, _ = _grads_of(plain, tp, ids)
    plain.pipeline_parallel = False
    seq, _ = _grads_of(plain, tp, ids)
    assert torch.equal(off, seq)

    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(1, 4),
                        mesh_axis_names=("data", "pipe"))
    for want, layer_kw in ((4, {}), (2, {"pipe_microbatches": 2})):
        layer, _ = _port_layer(params, pipeline_parallel=True, **layer_kw)
        rows = []
        orig = tatt.TransformerBlock.call

        def spy(self, p, x, *a, **kw):
            rows.append(x.shape[0])
            return orig(self, p, x, *a, **kw)

        monkeypatch.setattr(tatt.TransformerBlock, "call", spy)
        layer.call(tp, torch.tensor(ids), training=False)
        monkeypatch.undo()
        assert rows == [4 // want] * (8 * want), layer_kw


def test_pipeline_parallel_guards_equal_the_jax_package():
    """The layer's refusals, in the JAX package's words and order: n_block
    against the pipe axis, a mask, dropout in training, and sequence
    parallelism on the same mesh."""
    from analytics_zoo_tpu.common import nncontext as jctx

    ids = np.zeros((4, 16), np.int32)
    mask = np.ones((4, 16), np.float32)
    cases = [
        (dict(n_block=6), {}, False),
        ({}, {"mask": True}, False),
        (dict(hidden_drop=0.1), {}, True),
        (dict(sequence_parallel="ring"), {}, False),
    ]
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(1, 4, 2),
                        mesh_axis_names=("data", "pipe", "seq"))
    jctx.stop_nncontext()
    jctx.init_nncontext(mesh_shape=(1, 4, 2),
                        mesh_axis_names=("data", "pipe", "seq"))
    try:
        for kw, call_kw, training in cases:
            jreset()
            reset_name_counts()
            j = JaxLayer(**{**LAYER, **kw}, pipeline_parallel=True)
            j.ensure_built((None, 16))
            jp = j.init_params(jax.random.PRNGKey(0))
            t = tatt.TransformerLayer(**{**LAYER, **kw},
                                      pipeline_parallel=True)
            t.ensure_built((None, 16))
            tp = t.init_params(torch.Generator().manual_seed(0))
            jx = ([jnp.asarray(ids), jnp.asarray(mask)] if call_kw
                  else jnp.asarray(ids))
            tx = ([torch.tensor(ids), torch.tensor(mask)] if call_kw
                  else torch.tensor(ids))
            errors = []
            for fn in (lambda: j.call(jp, jx, training=training,
                                      rng=jax.random.PRNGKey(1)),
                       lambda: t.call(tp, tx, training=training,
                                      rng=torch.Generator().manual_seed(1))):
                with pytest.raises((ValueError, NotImplementedError)) as e:
                    fn()
                errors.append((type(e.value), str(e.value)))
            assert errors[0] == errors[1], kw
    finally:
        jctx.stop_nncontext()
