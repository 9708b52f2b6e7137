"""The port's pipeline-parallel stage axis against the JAX package: every
case of ``tests/test_pipeline.py`` on the port (StagePlan partitioning,
the microbatch schedules, the activation-slot discipline, training parity
against the unpipelined step, stage-split serving, stage-owned
checkpoints and the mid-schedule kill -> resume canary), the plans'
strings and the schedules' events equal to the JAX package's, the port's
``train_pipelined`` against the JAX package's on the same Dense stack, and
stage-sharded checkpoints crossing the packages both ways.

Tolerances. Within the port: a stage split alone and GPipe against 1F1B
are bitwise; M microbatches against one within ``ULP_BOUND`` (the JAX
test's 64 ULP: the M per-microbatch sums reassociate the batch's). Port
against the JAX package, the same K=1/M=1 run: ``ULP_BOUND`` element-wise
after one step, and after the JAX test's four Adam steps ``ULP_BOUND``
ULP of the largest parameter's magnitude (``SCALED_ULP``): the two
packages' float32 matmuls round apart by a few ULP, and Adam's
normalized steps turn that into a few 1e-8 absolute, which is hundreds
of ULP of a parameter near zero (434 ULP at a parameter of 1.8e-3
measured, 1.2e-7 absolute). Resumed runs continue within ``RESUME_TOL``
(absolute, float32) of the uninterrupted run of the other package.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.common.nncontext import get_nncontext as jax_ctx
from analytics_zoo_tpu.engine import checkpoint as jck
from analytics_zoo_tpu.engine.estimator import Estimator as JaxEstimator
from analytics_zoo_tpu.engine.triggers import MaxIteration as JaxMaxIteration
from analytics_zoo_tpu.engine.triggers import (
    SeveralIteration as JaxSeveralIteration,
)
from analytics_zoo_tpu.ft import atomic as jatomic
from analytics_zoo_tpu.keras.engine.topology import Sequential as JaxSeq
from analytics_zoo_tpu.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.pipeline import MicrobatchSchedule as JaxSchedule
from analytics_zoo_tpu.pipeline import StagePlan as JaxStagePlan
from analytics_zoo_tpu.mesh.config import MeshConfig as JaxMeshConfig
from analytics_zoo_tpu_torch.common.tree import (
    jax_leaf_order,
    tree_leaves,
    tree_paths,
)
from analytics_zoo_tpu_torch.engine.estimator import Estimator
from analytics_zoo_tpu_torch.engine.triggers import (
    MaxIteration,
    SeveralIteration,
)
from analytics_zoo_tpu_torch.ft import atomic, chaos
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras import optimizers as topt
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.mesh.config import MeshConfig, STAGE_AXIS
from analytics_zoo_tpu_torch.mesh.plan import ShardingPlan
from analytics_zoo_tpu_torch.pipeline import (
    ActivationSlots,
    MicrobatchSchedule,
    StageAssignmentError,
    StageLadderError,
    StagePlan,
    bubble_fraction,
)
from analytics_zoo_tpu_torch.serving.engine import (
    BatcherConfig,
    ServingEngine,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_pipeline_worker.py")
ULP_BOUND = 64
SCALED_ULP = ULP_BOUND * float(np.finfo(np.float32).eps)
RESUME_TOL = 1e-6

_RULES = {1: ((r".", 0),),
          2: ((r"^d1$", 0), (r".", 1)),
          3: ((r"^d1$", 0), (r"^d2$", 1), (r".", 2))}


@pytest.fixture(autouse=True)
def _port_context():
    port.stop_nncontext()
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()
    chaos.reset()


class _Layer:
    def __init__(self, name):
        self.name = name


class _Stack:
    def __init__(self, *names):
        self._layers = [_Layer(n) for n in names]

    def layers(self):
        return list(self._layers)


# ---------------------------------------------------------------------------
# StagePlan assignment
# ---------------------------------------------------------------------------


def test_first_match_wins():
    plan = StagePlan(2, rules=((r"^enc", 0), (r"^enc_late", 1), (r".", 1)))
    assert plan.stage_of("enc_late")[0] == 0
    assert plan.stage_of("dec")[0] == 1


def test_unmatched_layer_fails_loudly():
    plan = StagePlan(2, rules=((r"^enc", 0), (r"^dec", 1)))
    with pytest.raises(StageAssignmentError, match="'pool'"):
        plan.split(_Stack("enc_1", "pool", "dec_1"))


def test_non_monotonic_assignment_rejected():
    plan = StagePlan(2, rules=((r"^a", 1), (r".", 0)))
    with pytest.raises(StageAssignmentError, match="non-decreasing"):
        plan.assign(["a_1", "b_1"])


def test_empty_stage_rejected():
    plan = StagePlan(3, rules=((r"^a", 0), (r".", 2)))
    with pytest.raises(StageAssignmentError, match=r"stage\(s\) \[1\]"):
        plan.assign(["a_1", "b_1"])


def test_split_partitions_with_absolute_indices():
    plan = StagePlan(2, rules=((r"^a", 0), (r".", 1)))
    segs = plan.split(_Stack("a_1", "a_2", "b_1"))
    assert [s.names for s in segs] == [("a_1", "a_2"), ("b_1",)]
    assert [s.indices for s in segs] == [(0, 1), (2,)]


def test_rule_stage_out_of_range_and_bad_regex():
    with pytest.raises(ValueError, match="outside"):
        StagePlan(2, rules=((r".", 2),))
    with pytest.raises(ValueError, match="not a valid regex"):
        StagePlan(2, rules=((r"(", 0),))


def test_mesh_stage_axis_must_match_num_stages():
    mesh = MeshConfig.from_spec("data=1,stage=4")
    with pytest.raises(ValueError, match="stage=4"):
        StagePlan(2, rules=((r".", 0),), mesh=mesh)
    StagePlan(4, rules=((r".", 0),), mesh=mesh)


def test_fingerprint_stable_and_rule_ordered():
    a = StagePlan(2, rules=((r"^a", 0), (r".", 1)))
    b = StagePlan(2, rules=((r".", 1), (r"^a", 0)))
    assert a.fingerprint() != b.fingerprint()
    assert a.fingerprint() == \
        StagePlan(2, rules=((r"^a", 0), (r".", 1))).fingerprint()
    assert "stages=2" in a.fingerprint()


@pytest.mark.parametrize("num_stages,rules,mesh", [
    (2, ((r"^a", 0), (r".", 1)), None),
    (4, ((r"embed", 0), (r"block_[0-3]/", 1), (r"block_[4-7]/", 2),
         (r".", 3)), "data=2,stage=4"),
    (1, (), None)])
def test_plan_strings_equal_the_jax_package(num_stages, rules, mesh):
    """``describe()``, ``fingerprint()`` and ``repr`` give the JAX
    package's strings letter for letter."""
    ours = StagePlan(num_stages, rules=rules,
                     mesh=MeshConfig.from_spec(mesh) if mesh else None)
    theirs = JaxStagePlan(num_stages, rules=rules,
                          mesh=JaxMeshConfig.from_spec(mesh) if mesh
                          else None)
    assert ours.describe() == theirs.describe()
    assert ours.fingerprint() == theirs.fingerprint()
    assert repr(ours) == repr(theirs)


def test_owner_of_key_matches_layer_segment_only():
    plan = StagePlan(2, rules=((r"^d1$", 0), (r".", 1)))
    layer_stages = {"d1": 0, "d2": 1}
    assert plan.owner_of_key("params/d1/kernel", layer_stages) == 0
    assert plan.owner_of_key("opt_state/0/mu/d2/bias", layer_stages) == 1
    assert plan.owner_of_key("step", layer_stages) == 0


def test_partition_flat_covers_every_leaf():
    plan = StagePlan(2, rules=((r"^d1$", 0), (r".", 1)))
    layer_stages = {"d1": 0, "d2": 1}
    flat = [("params/d1/kernel", 1), ("params/d2/kernel", 2), ("step", 3)]
    shards = plan.partition_flat(flat, layer_stages)
    assert [k for k, _ in shards[0]] == ["params/d1/kernel", "step"]
    assert [k for k, _ in shards[1]] == ["params/d2/kernel"]


# ---------------------------------------------------------------------------
# mesh stage axis + ShardingPlan rejection
# ---------------------------------------------------------------------------


def test_mesh_from_spec_renders_stage_axis():
    mesh = MeshConfig.from_spec("data=2,stage=4")
    assert mesh.axis_length(STAGE_AXIS) == 4
    assert "stage=4" in mesh.describe()
    assert "stage=4" in mesh.fingerprint()


def test_sharding_plan_rejects_stage_axis_rule():
    mesh = MeshConfig.from_spec("data=2,stage=2")
    with pytest.raises(ValueError, match=r"'kernel\$'.*'stage'"):
        ShardingPlan(mesh, rules=(("kernel$", ("stage",)),))


# ---------------------------------------------------------------------------
# microbatch schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["1f1b", "gpipe"])
@pytest.mark.parametrize("num_stages,num_microbatches",
                         [(1, 1), (1, 4), (2, 2), (3, 4), (4, 8)])
def test_events_cover_every_op_once(num_stages, num_microbatches, mode):
    sched = MicrobatchSchedule(num_stages, num_microbatches, mode)
    events = sched.events()
    assert len(events) == (2 * num_stages - 1) * num_microbatches
    assert len(set(events)) == len(events)
    for kind in ("F", "B"):
        assert {(s, m) for k, s, m in events if k == kind} == {
            (s, m) for s in range(num_stages - 1)
            for m in range(num_microbatches)}
    assert {(s, m) for k, s, m in events if k == "L"} == {
        (num_stages - 1, m) for m in range(num_microbatches)}


@pytest.mark.parametrize("mode", ["1f1b", "gpipe"])
@pytest.mark.parametrize("num_stages,num_microbatches",
                         [(1, 2), (2, 1), (2, 4), (3, 4), (4, 8)])
def test_measured_slots_respect_declared_budget(num_stages,
                                                num_microbatches, mode):
    sched = MicrobatchSchedule(num_stages, num_microbatches, mode)
    budget = sched.slot_budget()
    measured = sched.measured_slots()
    if mode == "gpipe":
        assert measured == budget
    else:
        assert measured[0] == budget[0]
        for s in range(num_stages):
            assert 0 <= measured[s] - budget[s] <= (1 if s else 0)


def test_schedules_equal_the_jax_package():
    """Events, measured slots, budgets, descriptions and the modeled
    bubble equal the JAX package's for every (K, M, mode) up to 5 x 8."""
    for k in range(1, 6):
        for m in range(1, 9):
            for mode in ("1f1b", "gpipe"):
                ours, theirs = (MicrobatchSchedule(k, m, mode),
                                JaxSchedule(k, m, mode))
                assert ours.events() == theirs.events(), (k, m, mode)
                assert ours.measured_slots() == theirs.measured_slots()
                assert ours.describe() == theirs.describe()
                assert ours.simulate().bubble == theirs.simulate().bubble


def test_bubble_1f1b_strictly_below_gpipe_at_4_microbatches():
    for num_stages in (2, 3, 4):
        for num_microbatches in (4, 8):
            b1 = bubble_fraction(num_stages, num_microbatches, "1f1b")
            bg = bubble_fraction(num_stages, num_microbatches, "gpipe")
            assert b1 < bg, (num_stages, num_microbatches, b1, bg)
    assert bubble_fraction(3, 1, "1f1b") == bubble_fraction(3, 1, "gpipe")


def test_schedule_rejects_bad_mode_and_sizes():
    with pytest.raises(ValueError):
        MicrobatchSchedule(2, 2, "zigzag")
    with pytest.raises(ValueError):
        MicrobatchSchedule(0, 2, "1f1b")
    with pytest.raises(ValueError):
        MicrobatchSchedule(2, 0, "1f1b")


# ---------------------------------------------------------------------------
# activation-slot lease discipline
# ---------------------------------------------------------------------------


def test_slot_lease_checkout_release_cycle():
    slots = ActivationSlots({0: 2, 1: 1})
    a = slots.checkout(0, payload="x")
    b = slots.checkout(0, payload="y")
    assert slots.in_flight(0) == 2
    with pytest.raises(RuntimeError, match="exhausted"):
        slots.checkout(0, payload="z")
    slots.release(a)
    slots.release(b)
    with pytest.raises(RuntimeError, match="released twice"):
        slots.release(a)
    c = slots.checkout(1, payload="w")
    with pytest.raises(RuntimeError):
        slots.assert_drained()
    slots.release(c)
    slots.assert_drained()
    assert slots.peak(0) == 2


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------


class _ArrayDS:
    def __init__(self, n=64):
        r = np.random.RandomState(0)
        self.x = r.randn(n, 4).astype(np.float32)
        self.y = r.randn(n, 2).astype(np.float32)

    def batches(self, batch_size, shuffle=True, seed=0, start_step=0):
        idx = (np.random.RandomState(seed).permutation(len(self.x))
               if shuffle else np.arange(len(self.x)))
        for i in range(start_step, len(self.x) // batch_size):
            sl = idx[i * batch_size:(i + 1) * batch_size]
            yield self.x[sl], self.y[sl]


def _mse(y, pred):
    return ((y - pred) ** 2).mean()


def _jax_mse(y, pred):
    return jnp.mean((y - pred) ** 2)


def _jax_estimator():
    jax_ctx().set_rng_state(123, 0)
    model = JaxSeq([
        JaxDense(8, activation="relu", input_shape=(4,), name="d1"),
        JaxDense(8, activation="relu", name="d2"),
        JaxDense(2, name="d3"),
    ])
    est = JaxEstimator(model, optax.adam(1e-2))
    est._ensure_state()
    return est


@pytest.fixture(scope="module")
def init_params():
    """The JAX test's initial parameters (``_make_estimator``'s seed), as
    host arrays."""
    return jax.tree_util.tree_map(np.asarray,
                                  _jax_estimator().tstate.params)


def _make_estimator(init_params):
    model = Sequential([
        Dense(8, activation="relu", input_shape=(4,), name="d1"),
        Dense(8, activation="relu", name="d2"),
        Dense(2, name="d3"),
    ])
    load_jax_params(model, init_params, {})
    return Estimator(model, topt.Adam(1e-2))


def _flat(params):
    """The parameters as one vector in JAX's leaf order."""
    leaves = tree_leaves(params)
    return np.concatenate([leaves[i].detach().numpy().ravel()
                           for i in jax_leaf_order(params)])


def _train_cell(init_params, num_stages, num_microbatches, mode,
                ckpt_dir=None, iterations=4, auto_resume=False):
    est = _make_estimator(init_params)
    if ckpt_dir:
        est.set_checkpoint(ckpt_dir, keep_last=3)
    est.train_pipelined(
        _ArrayDS(), _mse, StagePlan(num_stages, rules=_RULES[num_stages]),
        num_microbatches=num_microbatches, schedule=mode,
        end_trigger=MaxIteration(iterations),
        checkpoint_trigger=SeveralIteration(2) if ckpt_dir else None,
        batch_size=16, auto_resume=auto_resume)
    return est


def _jax_train_cell(num_stages, num_microbatches, mode, ckpt_dir=None,
                    iterations=4, auto_resume=False):
    est = _jax_estimator()
    if ckpt_dir:
        est.set_checkpoint(ckpt_dir, keep_last=3)
    est.train_pipelined(
        _ArrayDS(), _jax_mse,
        JaxStagePlan(num_stages, rules=_RULES[num_stages]),
        num_microbatches=num_microbatches, schedule=mode,
        end_trigger=JaxMaxIteration(iterations),
        checkpoint_trigger=JaxSeveralIteration(2) if ckpt_dir else None,
        batch_size=16, auto_resume=auto_resume)
    return est


def _jax_flat(est):
    return np.concatenate([np.asarray(a).ravel() for a in
                           jax.tree_util.tree_leaves(est.tstate.params)])


def _max_ulp(a, b):
    if np.array_equal(a, b):
        return 0
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    return int(np.max(np.abs(ia - ib)))


def test_stage_split_alone_is_bitwise(init_params):
    """K >= 2 with M = 1 runs the same math in the same order: the stage
    cut perturbs no bit of the trained parameters."""
    base = _flat(_train_cell(init_params, 1, 1, "1f1b").tstate.params)
    np.testing.assert_array_equal(
        base, _flat(_train_cell(init_params, 2, 1, "1f1b").tstate.params))


def test_microbatching_is_ulp_bounded_and_schedules_bitwise(init_params):
    """M >= 2 reassociates the per-microbatch gradient sums (within
    ULP_BOUND); GPipe and 1F1B run the same cells over the same fixed
    fold order, so they match each other bitwise."""
    base = _flat(_train_cell(init_params, 1, 1, "1f1b").tstate.params)
    p1 = _flat(_train_cell(init_params, 2, 2, "1f1b").tstate.params)
    pg = _flat(_train_cell(init_params, 2, 2, "gpipe").tstate.params)
    assert _max_ulp(base, p1) <= ULP_BOUND
    np.testing.assert_array_equal(p1, pg)


@pytest.mark.slow
def test_parity_matrix_three_stages(init_params):
    base = _flat(_train_cell(init_params, 1, 1, "1f1b").tstate.params)
    np.testing.assert_array_equal(
        base, _flat(_train_cell(init_params, 3, 1, "1f1b").tstate.params))
    p1 = _flat(_train_cell(init_params, 3, 4, "1f1b").tstate.params)
    pg = _flat(_train_cell(init_params, 3, 4, "gpipe").tstate.params)
    assert _max_ulp(base, p1) <= ULP_BOUND
    np.testing.assert_array_equal(p1, pg)


def test_train_pipelined_matches_the_jax_package(init_params):
    """The JAX test's Dense stack and data, K=1/M=1, on both packages: the
    port's K=2/M=1 bitwise its K=1/M=1; against the JAX run, ULP_BOUND
    element-wise after one step and SCALED_ULP of the largest parameter
    after the four steps (the module docstring); the losses within the
    same bound."""
    one = _jax_train_cell(1, 1, "1f1b", iterations=1)
    ours_one = _train_cell(init_params, 1, 1, "1f1b", iterations=1)
    assert _max_ulp(_jax_flat(one), _flat(ours_one.tstate.params)) \
        <= ULP_BOUND
    ref = _jax_train_cell(1, 1, "1f1b")
    ours = _train_cell(init_params, 1, 1, "1f1b")
    split = _train_cell(init_params, 2, 1, "1f1b")
    np.testing.assert_array_equal(_flat(ours.tstate.params),
                                  _flat(split.tstate.params))
    want, got = _jax_flat(ref), _flat(ours.tstate.params)
    assert np.abs(got - want).max() <= SCALED_ULP * np.abs(want).max()
    assert abs(ours.run_state.loss - float(ref.run_state.loss)) \
        <= SCALED_ULP * abs(float(ref.run_state.loss))


@pytest.mark.parametrize("bad", ["gradient_accumulation", "zero1",
                                 "stage_plan"])
def test_gradient_accumulation_composition_rejected(init_params, bad):
    """The JAX package's refusals: gradient accumulation, zero1, and a
    stage plan that is not a StagePlan."""
    model = Sequential([Dense(2, input_shape=(4,), name="d1")])
    kw = {bad: 2 if bad == "gradient_accumulation" else True}
    plan = StagePlan(1, rules=_RULES[1])
    if bad == "stage_plan":
        kw, plan = {}, "not a plan"
    est = Estimator(model, topt.Adam(1e-2), **kw)
    with pytest.raises(TypeError if bad == "stage_plan"
                       else NotImplementedError, match=bad):
        est.train_pipelined(_ArrayDS(), _mse, plan, batch_size=16)


def test_model_state_and_dropout_follow_the_contract():
    """A stateful layer's committed state is the last microbatch's, and
    dropout draws per absolute layer index: K=2/M=1 bitwise K=1/M=1 with
    dropout on, and the same run twice is bitwise."""
    from analytics_zoo_tpu_torch.keras.layers import (
        BatchNormalization,
        Dropout,
    )

    def run(k):
        port.stop_nncontext()
        port.init_nncontext(device="cpu", seed=5)
        reset_name_counts()
        model = Sequential([
            Dense(8, activation="relu", input_shape=(4,), name="d1"),
            Dropout(0.3, name="drop"),
            BatchNormalization(name="bn"),
            Dense(2, name="d3")])
        est = Estimator(model, topt.SGD(0.1))
        est.train_pipelined(
            _ArrayDS(), _mse,
            StagePlan(k, rules=((r"^d1$", 0), (r".", k - 1))),
            end_trigger=MaxIteration(3), batch_size=16)
        return est

    a, b, again = run(1), run(2), run(2)
    np.testing.assert_array_equal(_flat(a.tstate.params),
                                  _flat(b.tstate.params))
    np.testing.assert_array_equal(_flat(b.tstate.params),
                                  _flat(again.tstate.params))
    for x, y in zip(tree_leaves(a.tstate.model_state),
                    tree_leaves(b.tstate.model_state)):
        assert torch.equal(x, y)
    assert set(a.tstate.model_state) == {"bn"}


def test_orphaned_params_rejected():
    """A plan that leaves a parameter-holding layer unassigned cannot be
    built, so the trainer's own check is reached only through a model
    whose params name a layer outside its stack; the error names it."""
    est = Estimator(Sequential([Dense(2, input_shape=(4,), name="d1")]),
                    topt.Adam(1e-2))
    est._ensure_state()
    est.tstate.params["ghost"] = {"w": torch.zeros(1)}
    with pytest.raises(ValueError, match="ghost"):
        est.train_pipelined(_ArrayDS(), _mse, StagePlan(1, rules=_RULES[1]),
                            batch_size=16)


# ---------------------------------------------------------------------------
# stage-owned sharded checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture
def inspect_mod():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "scripts", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pipelined_checkpoint_commits_stage_shards(tmp_path, inspect_mod,
                                                   capsys, init_params):
    """A pipelined run commits two-phase sharded checkpoints whose shard
    manifest names the owning stage per host dir, and the JAX package's
    ``ckpt_inspect`` renders the stage column."""
    ckpt = str(tmp_path / "ck")
    _train_cell(init_params, 2, 2, "1f1b", ckpt_dir=ckpt)
    committed = atomic.committed_checkpoints(ckpt)
    assert committed, "no checkpoint committed"
    step, path = committed[-1]
    manifest = atomic.read_manifest(path)
    hosts = manifest["shards"]["hosts"]
    assert [h["stage"] for h in hosts] == [0, 1]
    assert manifest["metadata"]["pipeline"]["num_stages"] == 2
    atomic.verify_checksums(path)

    rows = inspect_mod.main([ckpt, "--verify"])
    out = capsys.readouterr().out
    assert rows[-1]["shard_problems"] == []
    assert {r["host"]: r["stage"] for r in rows[-1]["shard_rows"]} == \
        {0: 0, 1: 1}
    assert "stage" in out


@pytest.fixture(scope="module")
def jax_checkpointed(tmp_path_factory):
    """The JAX package's K=2/M=2 run of four steps with a stage-sharded
    commit every two: its directory and final parameters."""
    d = str(tmp_path_factory.mktemp("jax_pipe") / "ck")
    est = _jax_train_cell(2, 2, "1f1b", ckpt_dir=d)
    return d, _jax_flat(est)


def test_checkpoints_cross_the_packages_both_ways(tmp_path, init_params,
                                                  jax_checkpointed):
    """The same keys, shards and stage layout in both packages' files; a
    port-written checkpoint resumed by the JAX package's
    ``train_pipelined`` and a JAX-written one by the port's: the restored
    state is the file's bitwise, and two more steps land within
    RESUME_TOL of the other package's uninterrupted run."""
    jsrc, jax_final = jax_checkpointed
    pdir = str(tmp_path / "port")
    ours = _train_cell(init_params, 2, 2, "1f1b", ckpt_dir=pdir)
    # each side resumes the other's iteration-2 commit: drop the newer one
    jdir = str(tmp_path / "jax")
    shutil.copytree(jsrc, jdir)
    for d in (jdir, pdir):
        shutil.rmtree(os.path.join(d, "ckpt_4"))
    jpath, ppath = (os.path.join(d, "ckpt_2") for d in (jdir, pdir))
    jflat, jmeta = jatomic.read_checkpoint(jpath)
    pflat, pmeta = jatomic.read_checkpoint(ppath)
    assert [k for k, _ in pflat] == [k for k, _ in jflat]
    for (_, a), (_, b) in zip(pflat, jflat):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert pmeta["pipeline"] == jmeta["pipeline"]
    jman, pman = atomic.read_manifest(jpath), atomic.read_manifest(ppath)
    assert ([h["stage"] for h in pman["shards"]["hosts"]]
            == [h["stage"] for h in jman["shards"]["hosts"]])

    # the JAX package resumes the port's checkpoint at iteration 2 (each
    # train_pipelined call starts a fresh optimizer unless it resumes, so
    # the state is checked by one run and continued by another)
    def jax_resume(end):
        est = _jax_estimator()
        est.set_checkpoint(pdir)
        est.train_pipelined(
            _ArrayDS(), _jax_mse, JaxStagePlan(2, rules=_RULES[2]),
            num_microbatches=2, end_trigger=JaxMaxIteration(end),
            batch_size=16, auto_resume=True)
        return est

    resumed = jax_resume(2)
    assert resumed.run_state.iteration == 2
    want = dict(pflat)
    for key, leaf in jck._flatten({"params": resumed.tstate.params}):
        np.testing.assert_array_equal(np.asarray(leaf), want[key])
    shutil.rmtree(os.path.join(pdir, "ckpt_4"), ignore_errors=True)
    np.testing.assert_allclose(_jax_flat(jax_resume(4)), _flat(
        ours.tstate.params), rtol=0, atol=RESUME_TOL)

    # the port resumes the JAX package's checkpoint at iteration 2
    def port_resume(end):
        port.stop_nncontext()
        port.init_nncontext(device="cpu")
        est = _make_estimator(init_params)
        est.set_checkpoint(jdir)
        est.train_pipelined(
            _ArrayDS(), _mse, StagePlan(2, rules=_RULES[2]),
            num_microbatches=2, end_trigger=MaxIteration(end),
            batch_size=16, auto_resume=True)
        return est

    back = port_resume(2)
    assert back.run_state.iteration == 2
    jwant = dict(jflat)
    for key, leaf in zip(tree_paths(back.tstate.params),
                         tree_leaves(back.tstate.params)):
        np.testing.assert_array_equal(leaf.numpy(), jwant["params/" + key])
    opt = back.tstate.opt_state
    assert opt["count"] == int(jwant["opt_state/0/.count"])
    for name in ("mu", "nu"):
        for key, leaf in zip(tree_paths(opt[name]), tree_leaves(opt[name])):
            np.testing.assert_array_equal(
                leaf.numpy(), jwant[f"opt_state/0/.{name}/{key}"])
    shutil.rmtree(os.path.join(jdir, "ckpt_4"), ignore_errors=True)
    np.testing.assert_allclose(_flat(port_resume(4).tstate.params),
                               jax_final, rtol=0, atol=RESUME_TOL)


def test_resume_falls_back_past_a_corrupt_checkpoint(tmp_path, init_params):
    """A torn newest checkpoint is skipped for the one before it."""
    d = str(tmp_path / "ck")
    _train_cell(init_params, 2, 1, "1f1b", ckpt_dir=d)
    newest = atomic.committed_checkpoints(d)[-1][1]
    for root, _dirs, files in os.walk(newest):
        for name in files:
            if name == "arrays.npz":
                with open(os.path.join(root, name), "r+b") as f:
                    f.truncate(16)
    est = _make_estimator(init_params)
    est.set_checkpoint(d)
    est.train_pipelined(_ArrayDS(), _mse, StagePlan(2, rules=_RULES[2]),
                        end_trigger=MaxIteration(2), batch_size=16,
                        auto_resume=True)
    assert est.run_state.iteration == 2


@pytest.mark.parametrize("name,kw", [
    ("Adam", {"lr": 1e-3}), ("Adam", {"lr": 1e-3, "decay": 0.1}),
    ("SGD", {"lr": 0.1}), ("SGD", {"lr": 0.1, "momentum": 0.9}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "decay": 0.1}),
    ("SGD", {"lr": 0.1, "decay": 0.1}), ("RMSprop", {}),
    ("RMSprop", {"decay": 0.1}), ("RMSprop", {"centered": True}),
    ("Adagrad", {}), ("Adagrad", {"decay": 0.1}), ("Adamax", {}),
    ("Adadelta", {}), ("AdamWeightDecay", {}),
    ("AdamWeightDecay", {"warmup_portion": 0.1, "total": 100})])
def test_optimizer_state_keys_equal_optax(name, kw):
    """Every optimizer's declared optax paths (the ``opt_state/`` keys of
    a pipelined checkpoint) are those of the JAX package's optax state."""
    from analytics_zoo_tpu.keras import optimizers as jopt

    tree = {"d1": {"kernel": jnp.zeros((2, 2))}}
    keys = [k for k, _ in jck._flatten(
        {"o": getattr(jopt, name)(**kw).init(tree)})]
    want = list(dict.fromkeys(
        "/".join(k.split("/")[1:3]) for k in keys))
    assert list(topt.optax_paths(getattr(topt, name)(**kw))) == want


# ---------------------------------------------------------------------------
# stage-split serving
# ---------------------------------------------------------------------------


@pytest.fixture
def serve_net(init_params):
    return _make_estimator(init_params).model


def _load_inference(net):
    return InferenceModel().do_load_keras(net)


def test_staged_predict_bitwise_one_executable_per_stage(serve_net, rng):
    """Staged predict is bitwise the unstaged one, warm-up covers every
    (bucket, stage) cell (no serve-time build), and each cell has its own
    executable, keyed by its stage index."""
    x16 = rng.normal(size=(16, 4)).astype(np.float32)
    x4 = rng.normal(size=(4, 4)).astype(np.float32)
    ref = _load_inference(serve_net)
    staged = _load_inference(serve_net)
    staged.set_stage_plan(StagePlan(2, rules=_RULES[2]))
    for b in (4, 16):
        staged.do_optimize(np.zeros((b, 4), np.float32))
    misses0 = staged.cache_stats["misses"]
    for x in (x4, x16):
        np.testing.assert_array_equal(ref.do_predict(x),
                                      staged.do_predict(x))
    assert staged.cache_stats["misses"] == misses0
    keys = list(staged._compiled)
    assert len(set(keys)) == 4
    assert sorted(k[-1] for k in keys) == [("__stage__", 0)] * 2 + [
        ("__stage__", 1)] * 2


def test_equal_shaped_stages_never_share_an_executable(rng):
    """The port's counterpart of the JAX package's AOT stage salt: two
    stages whose programs have the same tag and argument signature get
    two executables (the stage index is in the key), never a cross-hit."""
    net = Sequential([Dense(4, input_shape=(4,), name="a"),
                      Dense(4, name="b")])
    im = _load_inference(net)
    inner = InferenceModel._segment_inner(
        StagePlan(2, rules=((r"^a$", 0), (r".", 1))).split(net)[0])
    x = rng.normal(size=(2, 4)).astype(np.float32)
    f0, _, _ = im.compile_program("same", inner, (x,), stage=0)
    f1, _, _ = im.compile_program("same", inner, (x,), stage=1)
    plain, _, _ = im.compile_program("same", inner, (x,))
    assert len({id(f0), id(f1), id(plain)}) == 3
    assert im.cache_stats["misses"] == 3 and im.cache_stats["hits"] == 0


def test_set_stage_plan_rejected_leaves_model_untouched(serve_net, rng):
    x = rng.normal(size=(4, 4)).astype(np.float32)
    m = _load_inference(serve_net)
    ref = m.do_predict(x)
    gen = m._gen
    with pytest.raises(StageAssignmentError):
        m.set_stage_plan(StagePlan(2, rules=((r"^nomatch", 0),)))
    assert m.stage_plan is None
    assert m._gen == gen
    np.testing.assert_array_equal(ref, m.do_predict(x))


def test_stage_and_sharding_plans_mutually_exclusive(serve_net):
    splan = StagePlan(2, rules=_RULES[2])
    shard = ShardingPlan(MeshConfig.from_spec("data=1"), rules=())
    m = _load_inference(serve_net)
    m.set_stage_plan(splan)
    with pytest.raises(NotImplementedError):
        m.set_sharding_plan(shard)
    m2 = _load_inference(serve_net)
    m2.set_sharding_plan(shard)
    with pytest.raises(NotImplementedError):
        m2.set_stage_plan(splan)


def test_validate_ladder_names_bucket_and_stage():
    plan = StagePlan(2, rules=_RULES[2],
                     mesh=MeshConfig.from_spec("data=4,stage=2"))
    with pytest.raises(StageLadderError, match="bucket 6.*stage 0"):
        plan.validate_ladder((4, 6))
    plan.validate_ladder((4, 8))


def test_engine_register_stage_plan_serves_and_reports(serve_net, rng):
    x = rng.normal(size=(8, 4)).astype(np.float32)
    ref = _load_inference(serve_net).do_predict(x)
    eng = ServingEngine()
    try:
        model = _load_inference(serve_net)
        eng.register("pipe", model, example_input=x,
                     config=BatcherConfig(max_batch_size=8, buckets=(4, 8)),
                     stage_plan=StagePlan(2, rules=_RULES[2]))
        np.testing.assert_array_equal(ref, np.asarray(eng.predict("pipe",
                                                                  x)))
        entry = next(iter(eng._models["pipe"].values()))
        assert entry.info()["stages"] == StagePlan(
            2, rules=_RULES[2]).describe()
    finally:
        eng.shutdown()


def test_engine_register_bad_ladder_leaves_model_untouched(serve_net, rng):
    """A ladder the StagePlan rejects fails the register BEFORE the model
    is touched."""
    x = rng.normal(size=(8, 4)).astype(np.float32)
    eng = ServingEngine()
    try:
        model = _load_inference(serve_net)
        ref = model.do_predict(x)
        gen = model._gen
        with pytest.raises(StageLadderError, match="bucket 6"):
            eng.register(
                "pipe", model, example_input=x,
                config=BatcherConfig(max_batch_size=8, buckets=(4, 6)),
                stage_plan=StagePlan(
                    2, rules=_RULES[2],
                    mesh=MeshConfig.from_spec("data=4,stage=2")))
        assert model.stage_plan is None
        assert model._gen == gen
        np.testing.assert_array_equal(ref, model.do_predict(x))
        assert "pipe" not in eng._models
    finally:
        eng.shutdown()


def test_engine_register_duck_typed_model_rejects_stage_plan():
    class Duck:
        def do_predict(self, x):
            return x

    eng = ServingEngine()
    try:
        with pytest.raises(TypeError, match="set_stage_plan"):
            eng.register("duck", Duck(),
                         example_input=np.zeros((2, 2), np.float32),
                         stage_plan=StagePlan(1, rules=_RULES[1]))
    finally:
        eng.shutdown()


# ---------------------------------------------------------------------------
# chaos site + kill -> resume canary
# ---------------------------------------------------------------------------


def test_pipeline_chaos_point_registered(monkeypatch):
    from analytics_zoo_tpu.ft import chaos as jchaos

    assert chaos.PIPELINE_POINTS == jchaos.PIPELINE_POINTS
    assert "pipeline_mid_schedule_kill" in chaos.PIPELINE_POINTS
    monkeypatch.setenv("AZOO_FT_CHAOS", "pipeline_mid_schedule_kill")
    assert chaos.active_point() == "pipeline_mid_schedule_kill"
    monkeypatch.setenv("AZOO_FT_CHAOS", "no_such_pipeline_point")
    with pytest.raises(ValueError, match="no_such_pipeline_point"):
        chaos.active_point()


def _run_worker(ckpt_dir, out_path, extra_env):
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    for k in ("AZOO_FT_CHAOS", "AZOO_FT_CHAOS_SKIP"):
        env.pop(k, None)
    env.update(extra_env)
    proc = subprocess.run([sys.executable, WORKER, str(ckpt_dir),
                           str(out_path)],
                          env=env, capture_output=True, text=True,
                          timeout=240)
    doc = None
    if os.path.isfile(out_path):
        with open(out_path) as f:
            doc = json.load(f)
    return proc.returncode, doc, proc.stderr[-2000:]


def _kill_resume_drill(tmp_path, worker_env, skip=14):
    """ref run -> chaos-armed kill (must die 43 mid-schedule) -> disarmed
    resume (must finish bitwise the ref). The site fires (2K-1)·M times a
    step, and the kill must land mid-schedule in step 3, after the
    iteration-2 checkpoint committed."""
    rc, ref, err = _run_worker(tmp_path / "ck_ref", tmp_path / "ref.json",
                               worker_env)
    assert rc == 0 and ref is not None, (rc, err)

    kill_ck = tmp_path / "ck_kill"
    rc, _doc, err = _run_worker(kill_ck, tmp_path / "kill.json", {
        **worker_env,
        "AZOO_FT_CHAOS": "pipeline_mid_schedule_kill",
        "AZOO_FT_CHAOS_SKIP": str(skip)})
    assert rc == chaos.EXIT_CODE, (rc, err)
    committed = [s for s, _ in atomic.committed_checkpoints(str(kill_ck))]
    assert committed and committed[-1] < ref["iteration"]

    rc, res, err = _run_worker(kill_ck, tmp_path / "resume.json", worker_env)
    assert rc == 0 and res is not None, (rc, err)
    assert res["iteration"] == ref["iteration"]
    assert res["params"] == ref["params"], "resume diverged from reference"


def test_kill_mid_schedule_resumes_bitwise(tmp_path):
    _kill_resume_drill(tmp_path, {})


@pytest.mark.slow
@pytest.mark.parametrize("worker_env,skip", [
    ({"PIPE_STAGES": "3", "PIPE_MICROBATCHES": "4"}, 45),
    ({"PIPE_SCHEDULE": "gpipe"}, 14),
], ids=["k3m4", "gpipe"])
def test_kill_matrix(tmp_path, worker_env, skip):
    _kill_resume_drill(tmp_path, worker_env, skip=skip)
