"""Multi-host data-parallel training of the port against the JAX package:
the cases of ``tests/test_dist_training.py`` on the port (threads standing
in for hosts in-process), the flat layout and the sharded checkpoints
against the JAX package's, a two-host run against the JAX package's
single-host run, and one kill→resume gang of real subprocesses (the
always-on canary of ``tests/test_dist_crash_recovery.py``).

Tolerances: the sharded update against optax ``OPT_TOL`` (the optimizer
tests' 1e-6 absolute); the two-host BERT run against the JAX run
``RUN_TOL`` of the update's norm (f32; the hosts sum their gradients
apart and XLA fuses in another order, and Adam turns rounding-level
differences of gradients near zero into whole steps: 0.40% of the update
measured); the two-host regularized run against the port's plain
``train()`` ``REG_TOL`` of the update's norm (f32, SGD: the hosts sum
their rows in another order).
"""

import json
import os
import subprocess
import sys
import threading
import uuid

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.data import feature_set as jfs
from analytics_zoo_tpu.engine import checkpoint as jck
from analytics_zoo_tpu.engine import estimator as jest
from analytics_zoo_tpu.engine import triggers as jtrig
from analytics_zoo_tpu.ft import atomic as jatomic
from analytics_zoo_tpu.ft import distributed as jdist
from analytics_zoo_tpu.keras import objectives as jobj
from analytics_zoo_tpu.keras import optimizers as jopt
from analytics_zoo_tpu.keras.engine import base as jbase
from analytics_zoo_tpu.mesh.config import MeshConfig as JaxMeshConfig
from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten
from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
from analytics_zoo_tpu_torch.engine import triggers as trig
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.ft.distributed import (
    DistCommitError,
    DistContext,
    DistTimeoutError,
    ShardedUpdater,
    commit_sharded_checkpoint,
    opt_shard_key,
    split_round_robin,
)
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import objectives as tobj
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras import regularizers
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense, Dropout
from analytics_zoo_tpu_torch.mesh import MeshConfig
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
OPT_TOL = 1e-6
RUN_TOL = 1e-2
REG_TOL = 1e-4
CRIT = tobj.sparse_categorical_crossentropy_from_logits


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()
    chaos.reset()


def _build_estimator(drop=0.4):
    port.stop_nncontext()
    port.init_nncontext(device="cpu")
    reset_name_counts()
    layers = [Dense(8, activation="relu", input_shape=(8,))]
    if drop:
        layers.append(Dropout(drop))
    return Estimator(Sequential(layers + [Dense(3)]), topt.Adam(0.02))


def _data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(24, 8)).astype(np.float32)
    y = rng.integers(0, 3, 24).astype(np.int32)
    return ArrayFeatureSet(x, y)


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        if isinstance(p, torch.Tensor):
            assert torch.equal(p, q)
        else:
            assert p == q


# ---------------------------------------------------------------- parity


def test_single_host_train_distributed_is_bitwise_plain_train():
    """``train_distributed`` with a single-host DistContext gives the
    parameters, loss and optimizer state of ``train()`` bitwise (dropout
    on: the same step generator)."""
    a = _build_estimator()
    a.train(_data(), CRIT, end_trigger=trig.MaxEpoch(2), batch_size=8)
    b = _build_estimator()
    b.train_distributed(_data(), CRIT, end_trigger=trig.MaxEpoch(2),
                        batch_size=8)
    assert b.run_state.iteration == a.run_state.iteration == 6
    assert b.run_state.loss == a.run_state.loss
    assert b.train_losses == a.train_losses
    _assert_trees_equal(b.tstate.params, a.tstate.params)
    _assert_trees_equal(b.tstate.opt_state, a.tstate.opt_state)
    assert b.model.params is b.tstate.params


def test_psum_grad_matches_direct_mean_grad():
    """The loss-SUM gradient of a host's rows, normalized by the summed
    valid count, equals the direct masked-mean gradient (dropout-free)."""
    est = _build_estimator(drop=0)
    est._ensure_state()
    x, y, mask = next(_data().train_batches(8, shuffle=True, seed=0))
    xs, ys, m = torch.tensor(x), torch.tensor(y), torch.tensor(mask)
    fn, _ = est._make_dist_grad(CRIT)
    gsum, greg, ls, cnt, _ms = fn(est.tstate.params, est.tstate.model_state,
                                  xs, ys, m, est._host_generator(0, 0))
    assert greg is None  # no regularizer: nothing to add
    g_dist = gsum / cnt

    upd = ShardedUpdater(est._tx(), est.tstate.params, 0, 1)
    leaves = [t.detach().requires_grad_(True)
              for t in tree_leaves(est.tstate.params)]
    params = tree_unflatten(est.tstate.params, leaves)
    pred, _ = est.model.apply(params, {}, xs, training=True, rng=None)
    ps = tobj.get_per_sample(CRIT)(ys, pred)
    loss = (ps * m).sum() / m.sum()
    grads = torch.autograd.grad(loss, leaves)
    g_ref = upd.padded_vector(tree_unflatten(est.tstate.params,
                                             list(grads)))
    assert float(ls) / float(cnt) == pytest.approx(loss.item(), rel=1e-6)
    np.testing.assert_allclose(g_dist.numpy(), g_ref.numpy(), rtol=2e-5,
                               atol=1e-7)


def test_train_distributed_guards():
    est = _build_estimator()
    est.gradient_accumulation = 4
    with pytest.raises(NotImplementedError):
        est.train_distributed(_data(), CRIT)
    est = _build_estimator()
    est.zero1 = True
    with pytest.raises(NotImplementedError):
        est.train_distributed(_data(), CRIT)


def test_zero1_trajectory_is_bitwise_the_plain_one():
    """``Estimator(zero1=True)`` no longer raises: the port's data axis is
    one device, so there is nothing to shard and the run is the plain
    one, bitwise."""
    a = _build_estimator()
    a.train(_data(), CRIT, end_trigger=trig.MaxEpoch(2), batch_size=8)
    b = _build_estimator()
    b = Estimator(b.model, topt.Adam(0.02), zero1=True)
    b.train(_data(), CRIT, end_trigger=trig.MaxEpoch(2), batch_size=8)
    assert b.zero1
    _assert_trees_equal(b.tstate, a.tstate)


def _regularized_estimator():
    port.stop_nncontext()
    port.init_nncontext(device="cpu")
    reset_name_counts()
    model = Sequential([
        Dense(8, activation="relu", input_shape=(8,),
              W_regularizer=regularizers.l1l2(l1=0.01, l2=0.1)),
        Dense(3, W_regularizer=regularizers.l2(0.1))])
    est = Estimator(model, topt.SGD(0.1))
    est._ensure_state()  # initialized now, from the fresh context's seed
    return est


def test_two_host_regularized_run_matches_plain_train(tmp_path):
    """The L1/L2 penalty's gradient is added whole on every host, as
    ``train()`` adds it: a 2-host run (threads, 4 rows a host) of a
    regularized model ends within ``REG_TOL`` of the update's norm of the
    single-host ``train()`` over the same global batches of 8 (f32, SGD;
    the hosts only sum their rows in another order). Adding 1/N of it, as
    the JAX package's multi-host step does, misses by about a third of
    the update."""
    ref = _regularized_estimator()
    init = [t.clone() for t in tree_leaves(ref.tstate.params)]
    ref.train(_data(), CRIT, end_trigger=trig.MaxEpoch(2), batch_size=8)
    ests = [_regularized_estimator() for _ in range(2)]
    rdv = str(tmp_path / "rdv")
    errs = _threads(lambda h: ests[h].train_distributed(
        _data(), CRIT, end_trigger=trig.MaxEpoch(2), batch_size=8,
        dist=DistContext(h, 2, rdv, timeout_s=60)))
    assert not errs, errs
    assert ests[0].run_state.iteration == ref.run_state.iteration == 6
    _assert_trees_equal(ests[0].tstate.params, ests[1].tstate.params)
    want = [t.numpy() for t in tree_leaves(ref.tstate.params)]
    got = [t.numpy() for t in tree_leaves(ests[0].tstate.params)]
    gap = np.sqrt(sum(np.sum((g - w).astype(np.float64) ** 2)
                      for g, w in zip(got, want)))
    update = np.sqrt(sum(np.sum((w - i.numpy()).astype(np.float64) ** 2)
                         for w, i in zip(want, init)))
    assert gap <= REG_TOL * update, (gap, update)


# ------------------------------------------------------- sharded updater


def _tiny_params():
    return {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) / 10.0,
            "b": torch.ones((5,), dtype=torch.float32)}


def test_sharded_updater_matches_plain_tree_update():
    """The updated parameters of the windowed flat update equal the plain
    per-leaf update bitwise, for 1 and 2 hosts over two steps (eager
    elementwise arithmetic is the same on a flat vector as on its
    leaves)."""
    params = _tiny_params()
    tx = topt.Adam(0.05)
    grads = {k: v * 0.3 + 0.01 for k, v in params.items()}
    ref_p, ref_opt = params, tx.init(params)
    for _ in range(2):
        u, ref_opt = tx.update(grads, ref_opt, ref_p)
        ref_p = {k: ref_p[k] + u[k] for k in ref_p}

    for num_hosts in (1, 2):
        updaters = [ShardedUpdater(tx, params, h, num_hosts)
                    for h in range(num_hosts)]
        gvec = updaters[0].padded_vector(grads)
        cur = params
        opts = [u.init_opt(params) for u in updaters]
        for _ in range(2):
            slices = []
            for h, u in enumerate(updaters):
                s, opts[h] = u.step(cur, gvec, opts[h])
                slices.append(s)
            cur = updaters[0].assemble(slices)
        for k in ref_p:
            assert torch.equal(cur[k], ref_p[k]), (num_hosts, k)


def test_mask_vector_freezes_elements():
    params = _tiny_params()
    u = ShardedUpdater(topt.Adam(0.05), params, 0, 1)
    mv = u.mask_vector(params, {"w": True, "b": False})
    gvec = u.padded_vector({k: torch.ones_like(v)
                            for k, v in params.items()})
    s, _opt = u.step(params, gvec, u.init_opt(params), mv)
    new = u.assemble([s])
    assert not torch.equal(new["w"], params["w"])
    assert torch.equal(new["b"], params["b"])


def test_tree_flat_opt_state_roundtrip_bitwise():
    """tree_to_flat / to_tree_state are bitwise inverses: the single host
    trains the per-leaf state yet checkpoints the flat layout."""
    params = _tiny_params()
    tx = topt.Adam(0.05)
    u = ShardedUpdater(tx, params, 0, 1)
    _upd, tree_state = tx.update({k: v * 0.1 for k, v in params.items()},
                                 tx.init(params), params)
    back = u.to_tree_state(u.tree_to_flat(tree_state))
    _assert_trees_equal(back, tree_state)
    named = dict(u.opt_flat(u.tree_to_flat(tree_state)))
    assert set(named) == u.expected_opt_keys()


def _two_host_opt_flat(tx, params):
    """Two hosts' optimizer shards after one step, named, and their
    metadata."""
    writers = [ShardedUpdater(tx, params, h, 2) for h in range(2)]
    gvec = writers[0].padded_vector({k: v * 0.2 + 0.3
                                     for k, v in params.items()})
    flat_map = {}
    for w in writers:
        _s, o = w.step(params, gvec, w.init_opt(params))
        flat_map.update(dict(w.opt_flat(o)))
    meta = {"num_hosts": 2, "flat_size": writers[0].flat_size,
            "slice_len": writers[0].slice_len,
            "opt_leaves": writers[0].opt_leaf_count}
    return flat_map, meta


def test_restore_opt_resharding_is_deterministic():
    """Restoring a 2-host optimizer state on M hosts is a pure function of
    the checkpoint, and a 2 -> 1 -> 1 round trip restores the same
    state."""
    params = _tiny_params()
    tx = topt.Adam(0.05)
    flat_map, meta = _two_host_opt_flat(tx, params)
    for m in (1, 2, 4):
        readers = [ShardedUpdater(tx, params, h, m) for h in range(m)]
        for r in readers:
            _assert_trees_equal(r.restore_opt(flat_map, meta),
                                r.restore_opt(flat_map, meta))
    single = ShardedUpdater(tx, params, 0, 1)
    state1 = single.restore_opt(flat_map, meta)
    remap = dict(single.opt_flat(state1))
    meta1 = dict(meta, num_hosts=1, slice_len=single.slice_len)
    _assert_trees_equal(single.restore_opt(remap, meta1), state1)


def test_restore_opt_validates_flat_size():
    params = _tiny_params()
    u = ShardedUpdater(topt.Adam(0.05), params, 0, 1)
    with pytest.raises(ValueError, match="not the same model"):
        u.restore_opt({}, {"num_hosts": 1, "flat_size": 7,
                           "slice_len": u.slice_len,
                           "opt_leaves": u.opt_leaf_count})


def test_split_round_robin_partitions_completely():
    flat = [(f"k{i}", np.full((2,), i)) for i in range(7)]
    shards = [split_round_robin(flat, h, 3) for h in range(3)]
    assert sorted(k for s in shards for k, _ in s) == sorted(
        k for k, _ in flat)
    assert [k for k, _ in shards[1]] == ["k1", "k4"]


def test_mesh_config_counts_the_process_devices():
    """A host process's local data axis is one device, and a mesh larger
    than the context's slots (one here) is refused naming the count (JAX
    ``MeshConfig.build`` refuses likewise)."""
    assert MeshConfig.host_local_data().describe() == "data=1"
    assert MeshConfig.from_spec("data=1,tp=1").build().shape == (1, 1)
    cfg = MeshConfig.from_spec("data=2,tp=4")
    assert cfg.fingerprint() == "devices=8;axes=data=2,tp=4"
    with pytest.raises(ValueError, match="needs 8 device"):
        cfg.build()


# --------------------------------------------- rendezvous + commit (fs)


def _threads(fn, n=2):
    errs = {}

    def run(h):
        try:
            fn(h)
        except Exception as e:  # noqa: BLE001
            errs[h] = e

    ts = [threading.Thread(target=run, args=(h,)) for h in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    return errs


def test_dist_context_validation(tmp_path):
    with pytest.raises(ValueError):
        DistContext(2, 2, str(tmp_path))
    with pytest.raises(ValueError):
        DistContext(0, 2)  # multi-host needs a rendezvous dir
    DistContext(0, 1)  # single host does not


def test_exchange_and_allreduce_two_hosts(tmp_path):
    ctxs = [DistContext(h, 2, str(tmp_path / "rdv"), timeout_s=30)
            for h in range(2)]
    results = [None, None]

    def run(h):
        results[h] = ctxs[h].allreduce_sum(
            {"v": np.full((3,), float(h + 1), np.float64)})

    assert not _threads(run)
    for h in range(2):
        np.testing.assert_array_equal(results[h]["v"], np.full((3,), 3.0))


def test_exchange_timeout_names_missing_host(tmp_path):
    ctx = DistContext(0, 2, str(tmp_path / "rdv"), timeout_s=0.3,
                      poll_s=0.01)
    with pytest.raises(DistTimeoutError, match=r"host\(s\) \[1\]"):
        ctx.exchange({"x": np.zeros((1,))})


def _commit_two_host(path):
    flats = [[("a", np.arange(4.0)), ("c", np.ones((2, 2)))],
             [("b", np.full((3,), 7.0))]]
    errs = _threads(lambda h: commit_sharded_checkpoint(
        path, flats[h], host_id=h, num_hosts=2,
        expected_keys={"a", "b", "c"},
        metadata={"step": 1, "iteration": 1}, commit_id="run:1",
        timeout_s=30))
    assert not errs, errs


def test_commit_sharded_two_hosts_then_read(tmp_path):
    path = str(tmp_path / "ckpt_1")
    _commit_two_host(path)
    assert atomic.is_committed(path)
    flat, meta = atomic.read_checkpoint(path)
    got = dict(flat)
    assert set(got) == {"a", "b", "c"}
    np.testing.assert_array_equal(got["b"], np.full((3,), 7.0))
    assert meta == {"step": 1, "iteration": 1}
    manifest = atomic.read_manifest(path)
    assert manifest["shards"]["num_hosts"] == 2
    assert manifest["shards"]["commit_id"] == "run:1"
    atomic.verify_checksums(path)


def test_commit_sharded_rejects_overlapping_leaves(tmp_path):
    path = str(tmp_path / "ckpt_1")
    flats = [[("a", np.arange(4.0))], [("a", np.ones((4,)))]]
    errs = _threads(lambda h: commit_sharded_checkpoint(
        path, flats[h], host_id=h, num_hosts=2, commit_id="run:1",
        timeout_s=30, poll_s=0.01))
    assert isinstance(errs.get(0), DistCommitError)
    assert "a" in str(errs[0])
    assert isinstance(errs.get(1), (DistCommitError, DistTimeoutError))
    assert not atomic.is_committed(path)
    assert not os.path.exists(path + ".tmp"), "staging must be swept"


def test_commit_sharded_rejects_incomplete_union(tmp_path):
    path = str(tmp_path / "ckpt_1")
    with pytest.raises(DistCommitError, match="missing"):
        commit_sharded_checkpoint(
            path, [("a", np.arange(4.0))], host_id=0, num_hosts=1,
            expected_keys={"a", "zz"}, commit_id="run:1", timeout_s=5)
    assert not os.path.exists(path + ".tmp")


def test_coordinator_timeout_sweeps_staging_and_counts(tmp_path):
    from analytics_zoo_tpu_torch.common.observability import (
        checkpoint_sweep_counters,
        distributed_metrics,
    )

    sweeps = checkpoint_sweep_counters()["dist_abort"]
    before = sweeps.value
    timeouts = distributed_metrics()["commits"].labels(outcome="timeout")
    t_before = timeouts.value
    path = str(tmp_path / "ckpt_1")
    with pytest.raises(DistTimeoutError, match=r"host\(s\) \[1\]"):
        commit_sharded_checkpoint(
            path, [("a", np.arange(4.0))], host_id=0, num_hosts=2,
            commit_id="run:1", timeout_s=0.3, poll_s=0.01)
    assert not os.path.exists(path + ".tmp"), "staging must be swept"
    assert not atomic.is_committed(path)
    assert sweeps.value == before + 1
    assert timeouts.value == t_before + 1


def test_dist_chaos_points_registered():
    for point in ("dist_participant_torn", "dist_participant_before_manifest",
                  "dist_coordinator_before_merge",
                  "dist_coordinator_before_commit"):
        assert point in chaos.DIST_POINTS
    assert chaos.DIST_POINTS == jdist.chaos.DIST_POINTS


def test_sweep_stale_removes_orphan_shard_dirs(tmp_path):
    """A committed sharded checkpoint with a stray host_K/ directory from a
    dead run gets the debris swept (and counted), not the checkpoint."""
    from analytics_zoo_tpu_torch.common.observability import (
        checkpoint_sweep_counters,
    )

    path = str(tmp_path / "ckpt_1")
    commit_sharded_checkpoint(path, [("a", np.arange(4.0))], host_id=0,
                              num_hosts=1, commit_id="run:1", timeout_s=5)
    orphan = os.path.join(path, "host_7")
    os.makedirs(orphan)
    np.savez(os.path.join(orphan, "arrays.npz"), a0=np.zeros((1,)))
    counter = checkpoint_sweep_counters()["orphan_shard"]
    before = counter.value
    removed = atomic.sweep_stale(str(tmp_path), keep_steps={1})
    assert orphan in removed
    assert not os.path.exists(orphan)
    assert atomic.is_committed(path)
    assert counter.value == before + 1
    flat, _ = atomic.read_checkpoint(path)
    np.testing.assert_array_equal(dict(flat)["a"], np.arange(4.0))


def test_opt_shard_key_format():
    assert opt_shard_key(3, 11) == "optshard/00003/00011"


def test_jax_ckpt_inspect_reads_a_port_sharded_checkpoint(tmp_path,
                                                          capsys):
    """The JAX package's ``scripts/ckpt_inspect.py`` (its three sharded
    cases: the shard table, an orphan, a doctored overlap) on a 2-host
    checkpoint the port committed: the table and ``--verify`` pass."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "scripts", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _commit_two_host(str(tmp_path / "ckpt_1"))
    rows = mod.main([str(tmp_path), "--verify"])
    out = capsys.readouterr().out
    assert rows[0]["status"] == "committed"
    assert rows[0]["hosts"] == 2
    assert rows[0]["shard_problems"] == []
    assert {r["host"]: r["leaves"] for r in rows[0]["shard_rows"]} == \
        {0: 2, 1: 1}
    assert "ok (3 leaves)" in out


# ------------------------------------------- against the JAX package


def _nested_params(seed=0):
    """A BERT-like nested tree as numpy, with dict keys in an order JAX's
    flatten does not keep (its keys sort)."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    return {"zeta_head": {"kernel": a(6, 2), "bias": a(2)},
            "bert": {"word_embed": a(11, 6),
                     "block1": {"qkv_kernel": a(6, 18), "ln_b": a(6)},
                     "block0": {"qkv_kernel": a(6, 18), "ln_b": a(6)},
                     "pos_embed": a(9, 6)},
            "alpha": a(3)}


def _to_torch(tree):
    return {k: (_to_torch(v) if isinstance(v, dict) else torch.tensor(v))
            for k, v in tree.items()}


def test_flat_vector_is_jax_ravel_pytree():
    params = _nested_params()
    want, _ = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params))
    for hosts in (1, 3):
        u = ShardedUpdater(topt.Adam(), _to_torch(params), 0, hosts)
        got = u.padded_vector(_to_torch(params))
        assert u.flat_size == want.size
        assert got.numel() == u.padded_size >= want.size
        np.testing.assert_array_equal(got[: u.flat_size].numpy(),
                                      np.asarray(want))
        assert not got[u.flat_size:].any()
    back = u.assemble([u.padded_vector(_to_torch(params)).reshape(3, -1)[h]
                       for h in range(3)])
    assert list(back) == list(_to_torch(params))  # the port's own order
    _assert_trees_equal(back, _to_torch(params))


@pytest.mark.parametrize("name,jtx,ttx", [
    ("adam", lambda: optax.adam(0.01), lambda: topt.Adam(0.01)),
    ("adam-decay", lambda: jopt.Adam(0.01, decay=0.1),
     lambda: topt.Adam(0.01, decay=0.1)),
    ("sgd", lambda: jopt.SGD(0.1), lambda: topt.SGD(0.1)),
    ("sgd-momentum", lambda: jopt.SGD(0.1, momentum=0.9),
     lambda: topt.SGD(0.1, momentum=0.9))])
def test_sharded_step_matches_jax(name, jtx, ttx):
    """Each host's window and its optimizer shard after two steps, against
    the JAX ``ShardedUpdater`` on the same parameters and gradients (to
    ``OPT_TOL``); the port's shard leaves in optax's leaf order."""
    params = _nested_params(1)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    grads = _nested_params(2)
    tparams = _to_torch(params)
    for h in range(2):
        ju = jdist.ShardedUpdater(jtx(), jparams, h, 2,
                                  JaxMeshConfig((1,), ("data",)))
        tu = ShardedUpdater(ttx(), tparams, h, 2)
        assert (ju.slice_len, ju.opt_leaf_count) == (tu.slice_len,
                                                     tu.opt_leaf_count)
        jg = ju.padded_vector(grads)
        tg = tu.padded_vector(_to_torch(grads))
        np.testing.assert_array_equal(tg.numpy(), jg)
        jo, to = ju.init_opt(jparams), tu.init_opt(tparams)
        for _ in range(2):
            js, jo = ju.step(jparams, jg, jo)
            ts, to = tu.step(tparams, tg, to)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                       atol=OPT_TOL)
        for (jk, jv), (tk, tv) in zip(ju.opt_flat(jo), tu.opt_flat(to),
                                      strict=True):
            assert jk == tk
            assert tv.dtype == np.asarray(jv).dtype
            np.testing.assert_allclose(tv, np.asarray(jv), rtol=0,
                                       atol=OPT_TOL)


def test_optax_leaf_layouts_match_optax():
    """Every port optimizer declares optax's leaf order of the JAX
    package's same optimizer: the entries' shapes and values after two
    updates of a flat vector, leaf for leaf."""
    cases = [(jopt.Adam(0.01), topt.Adam(0.01)),
             (jopt.Adam(0.01, decay=0.1), topt.Adam(0.01, decay=0.1)),
             (jopt.AdamWeightDecay(0.01), topt.AdamWeightDecay(0.01)),
             (jopt.AdamWeightDecay(0.01, warmup_portion=0.1, total=10),
              topt.AdamWeightDecay(0.01, warmup_portion=0.1, total=10)),
             (jopt.SGD(0.1), topt.SGD(0.1)),
             (jopt.SGD(0.1, momentum=0.9), topt.SGD(0.1, momentum=0.9)),
             (jopt.SGD(0.1, decay=0.1), topt.SGD(0.1, decay=0.1)),
             (jopt.RMSprop(0.01), topt.RMSprop(0.01)),
             (jopt.RMSprop(0.01, centered=True),
              topt.RMSprop(0.01, centered=True)),
             (jopt.RMSprop(0.01, decay=0.1), topt.RMSprop(0.01, decay=0.1)),
             (jopt.Adagrad(0.01), topt.Adagrad(0.01)),
             (jopt.Adadelta(), topt.Adadelta()),
             (jopt.Adamax(), topt.Adamax())]
    rng = np.random.default_rng(3)
    p = rng.normal(size=(7,)).astype(np.float32)
    gs = [rng.normal(size=(7,)).astype(np.float32) for _ in range(2)]
    for jtx, ttx in cases:
        js, ts = jtx.init(jnp.asarray(p)), ttx.init(torch.tensor(p))
        for g in gs:
            _u, js = jtx.update(jnp.asarray(g), js, jnp.asarray(p))
            _u, ts = ttx.update(torch.tensor(g), ts, torch.tensor(p))
        jl = jax.tree_util.tree_leaves(js)
        names = topt.optax_leaves(ttx)
        assert len(names) == len(jl), names
        for name, leaf in zip(names, jl):
            got = np.asarray(ts[name] if name != "count"
                             else np.int32(ts["count"]))
            assert got.shape == np.shape(leaf), name
            np.testing.assert_allclose(got, np.asarray(leaf), rtol=1e-5,
                                       atol=1e-6, err_msg=name)


def _jax_flatten_shared(params):
    return jck._flatten({"params": params, "model_state": {},
                         "step": jnp.asarray(1, jnp.int32)})


def test_sharded_checkpoints_cross_between_the_packages(tmp_path):
    """A 2-host sharded checkpoint (hosts as threads) written by each
    package and read by the other: every parameter leaf by key and every
    optimizer shard after resharding onto one host, bitwise what the
    writer held."""
    params = _nested_params(4)
    grads = _nested_params(5)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    tparams = _to_torch(params)
    shared_keys = {k for k, _ in _jax_flatten_shared(jparams)}

    # -- the JAX package writes (its 8-device local mesh), the port reads
    jpath = str(tmp_path / "jax" / "ckpt_1")
    jus = [jdist.ShardedUpdater(optax.adam(0.01), jparams, h, 2)
           for h in range(2)]
    jg = jus[0].padded_vector(grads)
    jopts = [u.step(jparams, jg, u.init_opt(jparams))[1] for u in jus]
    jmeta = {"dist": {"num_hosts": 2, "flat_size": jus[0].flat_size,
                      "slice_len": jus[0].slice_len,
                      "opt_leaves": jus[0].opt_leaf_count}}
    shared = _jax_flatten_shared(jparams)
    errs = _threads(lambda h: jdist.commit_sharded_checkpoint(
        jpath, split_round_robin(shared, h, 2) + jus[h].opt_flat(jopts[h]),
        host_id=h, num_hosts=2,
        expected_keys=shared_keys | jus[0].expected_opt_keys(),
        metadata=jmeta, commit_id="j:1", timeout_s=30))
    assert not errs, errs
    flat, meta = atomic.read_checkpoint(jpath)
    got = dict(flat)
    for k, v in shared:
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
    tu = ShardedUpdater(topt.Adam(0.01), tparams, 0, 1)
    state = tu.restore_opt(got, meta["dist"])
    for i, name in enumerate(tu.layout):
        parts = [np.asarray(dict(jus[h].opt_flat(jopts[h]))[
            opt_shard_key(h, i)]) for h in range(2)]
        if name == "count":
            assert state["count"] == int(parts[0]) == 1
        else:
            np.testing.assert_array_equal(
                state[name].numpy()[: tu.flat_size],
                np.concatenate(parts)[: tu.flat_size], err_msg=name)

    # -- the port writes, the JAX package reads
    tpath = str(tmp_path / "port" / "ckpt_1")
    tus = [ShardedUpdater(topt.Adam(0.01), tparams, h, 2) for h in range(2)]
    tg = tus[0].padded_vector(_to_torch(grads))
    topts = [u.step(tparams, tg, u.init_opt(tparams))[1] for u in tus]
    tmeta = {"dist": {"num_hosts": 2, "flat_size": tus[0].flat_size,
                      "slice_len": tus[0].slice_len,
                      "opt_leaves": tus[0].opt_leaf_count}}
    from analytics_zoo_tpu_torch.engine.estimator import _jax_flatten

    tshared = _jax_flatten({"params": tparams, "model_state": {},
                            "step": 1})
    assert [k for k, _ in tshared] == [k for k, _ in shared]
    errs = _threads(lambda h: commit_sharded_checkpoint(
        tpath, split_round_robin(tshared, h, 2) + tus[h].opt_flat(topts[h]),
        host_id=h, num_hosts=2,
        expected_keys=shared_keys | tus[0].expected_opt_keys(),
        metadata=tmeta, commit_id="t:1", timeout_s=30))
    assert not errs, errs
    jflat, jm = jatomic.read_checkpoint(tpath)
    jgot = dict(jflat)
    for k, v in tshared:
        np.testing.assert_array_equal(jgot[k], v, err_msg=k)
    ju = jdist.ShardedUpdater(optax.adam(0.01), jparams, 0, 1)
    jstate = jax.tree_util.tree_leaves(ju.restore_opt(jgot, jm["dist"]))
    for i, (name, leaf) in enumerate(zip(tus[0].layout, jstate)):
        mine = [dict(tus[h].opt_flat(topts[h]))[opt_shard_key(h, i)]
                for h in range(2)]
        if name == "count":
            assert int(leaf) == int(mine[0]) == 1
        else:
            np.testing.assert_array_equal(
                np.asarray(leaf)[: ju.flat_size],
                np.concatenate(mine)[: ju.flat_size], err_msg=name)


BERT_CFG = dict(vocab=64, hidden_size=32, n_block=2, n_head=2, seq_len=16,
                intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)


def _bert_data(n=32, seq=16, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(seq // 4, seq + 1, n)
    pos = np.arange(seq)[None, :]
    mask = (pos < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (n, seq)) * mask).astype(np.int32)
    types = ((pos >= lens[:, None] // 2) * mask).astype(np.int32)
    return [ids, types, mask], rng.integers(0, 2, n).astype(np.int32)


def test_two_host_run_matches_the_jax_single_host_run(tmp_path):
    """A 2-host port run (threads, 8 rows a host) of a small BERT against
    the JAX package's single-host ``train_distributed`` on its 8-device
    CPU mesh over the same global batches of 16 (f32, dropout off, Adam):
    the last loss to 1e-4 and the parameters within ``RUN_TOL`` of the JAX
    run's update; both hosts end bitwise equal."""
    x, y = _bert_data()
    jbase.reset_name_counts()
    jnet = JaxBERT(num_classes=2, **BERT_CFG)
    jnet.compute_dtype = None
    jestim = jest.Estimator(jnet, jopt.Adam(1e-3))
    jestim._ensure_state()
    init = jax.tree_util.tree_map(np.asarray, jestim.tstate.params)
    jestim.train_distributed(jfs.ArrayFeatureSet(x, y),
                             jobj.sparse_categorical_crossentropy,
                             end_trigger=jtrig.MaxEpoch(2), batch_size=16)
    jfinal = jax.tree_util.tree_map(np.asarray, jestim.tstate.params)

    ests = []
    for _ in range(2):
        reset_name_counts()
        net = BERTClassifierNet(num_classes=2, **BERT_CFG)
        net.compute_dtype = None
        load_jax_params(net, init)
        ests.append(Estimator(net, topt.Adam(1e-3)))
    rdv = str(tmp_path / "rdv")
    errs = _threads(lambda h: ests[h].train_distributed(
        ArrayFeatureSet(x, y), tobj.sparse_categorical_crossentropy,
        end_trigger=trig.MaxEpoch(2), batch_size=16,
        dist=DistContext(h, 2, rdv, timeout_s=60)))
    assert not errs, errs
    assert ests[0].run_state.iteration == 4
    _assert_trees_equal(ests[0].tstate.params, ests[1].tstate.params)
    assert ests[0].run_state.loss == pytest.approx(jestim.run_state.loss,
                                                   abs=1e-4)
    reset_name_counts()
    carried = [t.numpy() for t in tree_leaves(load_jax_params(
        BERTClassifierNet(num_classes=2, **BERT_CFG), jfinal))]
    carried0 = [t.numpy() for t in tree_leaves(load_jax_params(
        BERTClassifierNet(num_classes=2, **BERT_CFG), init))]
    got = [t.numpy() for t in tree_leaves(ests[0].tstate.params)]
    gap = np.sqrt(sum(np.sum((g - c).astype(np.float64) ** 2)
                      for g, c in zip(got, carried)))
    update = np.sqrt(sum(np.sum((c - c0).astype(np.float64) ** 2)
                         for c, c0 in zip(carried, carried0)))
    assert gap <= RUN_TOL * update, (gap, update)


# ------------------------------------------------- the kill canary


def _gang(ckpt_dir, rdv_dir, out_dir, *, chaos_host=None, chaos_point=None,
          skip=0, timeout_s=60, preempt_at=0, epochs=3):
    """One 2-process gang with a fresh run id; returns (returncodes,
    out paths, stderrs)."""
    os.makedirs(out_dir, exist_ok=True)
    run_id = uuid.uuid4().hex[:12]
    procs, outs = [], []
    for h in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, AZOO_DIST_HOST=str(h),
                   AZOO_DIST_NHOSTS="2", AZOO_DIST_RUN_ID=run_id,
                   AZOO_DIST_TIMEOUT_S=str(timeout_s),
                   DIST_EPOCHS=str(epochs))
        for k in ("AZOO_FT_CHAOS", "AZOO_FT_CHAOS_SKIP", "DIST_PREEMPT_AT"):
            env.pop(k, None)
        if preempt_at:
            env["DIST_PREEMPT_AT"] = str(preempt_at)
        if chaos_point is not None and h == chaos_host:
            env["AZOO_FT_CHAOS"] = chaos_point
            env["AZOO_FT_CHAOS_SKIP"] = str(skip)
        out = os.path.join(out_dir, f"h{h}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, ckpt_dir, rdv_dir, out], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    rcs, errs = [], []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            err = (err or "") + "\n<gang member timed out>"
        rcs.append(p.returncode)
        errs.append(err)
    return rcs, outs, errs


def _params(out_path):
    with open(out_path) as f:
        doc = json.load(f)
    return {k: np.asarray(v) for k, v in doc["params"].items()}, doc


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One uninterrupted 2-host run: the trajectory every kill and resume
    must reproduce bitwise."""
    d = tmp_path_factory.mktemp("dist_ref")
    rcs, outs, errs = _gang(str(d / "ck"), str(d / "rdv"), str(d / "out"))
    assert rcs == [0, 0], errs
    want, doc = _params(outs[0])
    other, _ = _params(outs[1])
    for k in want:
        np.testing.assert_array_equal(want[k], other[k], err_msg=k)
    return want, doc


def _assert_no_torn_checkpoints(ckpt):
    for _step, path in atomic.committed_checkpoints(ckpt):
        flat, meta = atomic.read_checkpoint(path)  # CRCs verified
        assert flat and meta.get("dist"), path


def _kill_and_resume(tmp_path, reference, point, victim):
    """Run 1 dies at ``point`` of the second sharded save (the commit at
    iteration 4 survives) on host ``victim``; the survivor cannot finish
    alone; run 2, a restarted gang, ends bitwise where ``reference``
    ends."""
    ckpt, rdv = str(tmp_path / "ck"), str(tmp_path / "rdv")
    rcs, _outs, errs = _gang(ckpt, rdv, str(tmp_path / "o1"),
                             chaos_host=victim, chaos_point=point, skip=1,
                             timeout_s=8)
    assert rcs[victim] == chaos.EXIT_CODE, errs[victim][-3000:]
    assert rcs[1 - victim] != 0, errs[1 - victim][-3000:]
    assert [s for s, _ in atomic.committed_checkpoints(ckpt)] == [4]
    _assert_no_torn_checkpoints(ckpt)
    rcs, outs, errs = _gang(ckpt, rdv, str(tmp_path / "o2"))
    assert rcs == [0, 0], errs
    want, ref_doc = reference
    for out in outs:
        got, doc = _params(out)
        assert (doc["iteration"], doc["epoch"]) == (ref_doc["iteration"],
                                                     ref_doc["epoch"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _assert_no_torn_checkpoints(ckpt)


def test_kill_torn_participant_then_resume_bitwise(tmp_path, reference):
    """The always-on canary: the non-coordinator dies mid-array-write of
    the second sharded save (half its bytes staged); the survivor times
    out and fails; the torn save is invisible (only ``ckpt_4`` committed,
    and it restores clean); a restarted gang with ``auto_resume=True``
    ends bitwise where an uninterrupted 2-host run ends, both hosts."""
    _kill_and_resume(tmp_path, reference, "dist_participant_torn", victim=1)


@pytest.mark.slow
@pytest.mark.parametrize("point,victim", [
    ("dist_participant_torn", 0),
    ("dist_participant_before_manifest", 0),
    ("dist_participant_before_manifest", 1),
    ("dist_coordinator_before_merge", 0),
    ("dist_coordinator_before_commit", 0)])
def test_dist_kill_matrix_then_resume_bitwise(tmp_path, reference, point,
                                              victim):
    """The rest of the {failure point} x {participant, coordinator} matrix
    (the coordinator's points fire only on host 0)."""
    _kill_and_resume(tmp_path, reference, point, victim)


@pytest.mark.slow
def test_preemption_propagates_and_resumes_bitwise(tmp_path, reference):
    """A preemption flagged on host 0 rides the gradient exchange: every
    host saves coordinately (one committed checkpoint, the same step) and
    exits 41; the restarted gang finishes bitwise."""
    ckpt, rdv = str(tmp_path / "ck"), str(tmp_path / "rdv")
    rcs, outs, errs = _gang(ckpt, rdv, str(tmp_path / "o1"), preempt_at=5)
    assert rcs == [41, 41], (rcs, errs)
    docs = [_params(o)[1] for o in outs]
    assert all(d["preempted"] for d in docs)
    paths = {d["checkpoint_path"] for d in docs}
    assert len(paths) == 1 and None not in paths, paths
    assert atomic.is_committed(paths.pop())
    _assert_no_torn_checkpoints(ckpt)
    rcs, outs, errs = _gang(ckpt, rdv, str(tmp_path / "o2"))
    assert rcs == [0, 0], errs
    want, ref_doc = reference
    for out in outs:
        got, doc = _params(out)
        assert doc["iteration"] == ref_doc["iteration"]
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.slow
def test_restore_on_different_host_count_is_deterministic(tmp_path):
    """A 2-host checkpoint resumed by two independent 1-host runs (each on
    its own copy of the directory): the optimizer shards reshard as a pure
    function of the checkpoint, so both finish bitwise equal."""
    import shutil

    ckpt, rdv = str(tmp_path / "ck"), str(tmp_path / "rdv")
    rcs, _outs, errs = _gang(ckpt, rdv, str(tmp_path / "o1"), epochs=2)
    assert rcs == [0, 0], errs
    assert [s for s, _ in atomic.committed_checkpoints(ckpt)] == [4]

    def solo(tag):
        ck_copy = str(tmp_path / f"ck_{tag}")
        shutil.copytree(ckpt, ck_copy)
        env = dict(os.environ, PYTHONPATH=REPO, AZOO_DIST_HOST="0",
                   AZOO_DIST_NHOSTS="1", AZOO_DIST_RUN_ID=uuid.uuid4().hex[:12],
                   AZOO_DIST_TIMEOUT_S="60", DIST_EPOCHS="3")
        for k in ("AZOO_FT_CHAOS", "AZOO_FT_CHAOS_SKIP", "DIST_PREEMPT_AT"):
            env.pop(k, None)
        out = str(tmp_path / f"solo_{tag}.json")
        proc = subprocess.run([sys.executable, WORKER, ck_copy, rdv, out],
                              env=env, capture_output=True, text=True,
                              timeout=240)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return _params(out)

    got_a, doc_a = solo("a")
    got_b, doc_b = solo("b")
    assert doc_a["iteration"] == doc_b["iteration"] == 9
    for k in got_a:
        np.testing.assert_array_equal(got_a[k], got_b[k], err_msg=k)
