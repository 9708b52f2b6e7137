"""The port's in-process mesh against the JAX package's, on the same
declarations (the cases of ``tests/test_mesh.py``): the context mesh,
``MeshConfig.build`` over slots, ``ShardingPlan``'s rules (first match
wins, replicated default, unknown and ``stage`` axes refused), its
``describe()`` and ``fingerprint()`` strings, ``validate_ladder``'s error
text and single-row warning, ``device_put_batch`` never aliasing its
input, ``parallel.sharding.param_shardings``' ``clean``, and the plan
threaded through ``InferenceModel``, ``ServingEngine.register`` and
``BatchPredictJob``: ``set_sharding_plan`` drops executables, and an
indivisible ladder is refused before the model is touched or a row read.

The JAX package sees 8 XLA host devices (``conftest.py``); the port makes
8 CPU slots with ``init_nncontext(device="cpu", mesh_shape=...)``. Strings
and specs are held equal; placed values bitwise.
"""

import logging

import numpy as np
import pytest
import torch

import analytics_zoo_tpu as zoo
import analytics_zoo_tpu.mesh as jmesh
import analytics_zoo_tpu.parallel.sharding as jsh
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.common import nncontext as jctx
from analytics_zoo_tpu_torch.batch import BatchPredictJob
from analytics_zoo_tpu_torch.data.sources import ArraySource
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.mesh import (
    BucketShardingError,
    MeshConfig,
    ShardingPlan,
    SlotMesh,
)
from analytics_zoo_tpu_torch.parallel import sharding as tsh
from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine

EIGHT = dict(mesh_shape=(8,), mesh_axis_names=("data",))


@pytest.fixture(autouse=True)
def _port_context():
    port.stop_nncontext()
    port.init_nncontext(device="cpu", **EIGHT)
    yield
    port.stop_nncontext()
    reset_name_counts()


def _fresh_context(**kw):
    port.stop_nncontext()
    return port.init_nncontext(device="cpu", **kw)


def _build_model():
    m = Sequential(name="meshm")
    m.add(Dense(4, activation="relu", input_shape=(6,), name="mesh_u1"))
    m.add(Dense(2, name="mesh_u2"))
    return m


PARAMS = {"mesh_u1": {"kernel": np.zeros((6, 4), np.float32),
                      "bias": np.zeros((4,), np.float32)},
          "mesh_u2": {"kernel": np.zeros((4, 2), np.float32),
                      "bias": np.zeros((2,), np.float32)}}


# -- the context mesh ------------------------------------------------------

def test_context_mesh_matches_jax():
    shape, names = (2, 1, 4), ("data", "model", "seq")
    ctx = _fresh_context(mesh_shape=shape, mesh_axis_names=names)
    jctx.stop_nncontext()
    jc = zoo.init_nncontext(mesh_shape=shape, mesh_axis_names=names)
    try:
        assert dict(ctx.mesh.shape) == dict(jc.mesh.shape) == {
            "data": 2, "model": 1, "seq": 4}
        assert ctx.mesh.axis_names == tuple(jc.mesh.axis_names)
        assert ctx.num_devices == jc.num_devices == 8
        assert ctx.data_axis == jc.data_axis == "data"
        assert ctx.mesh.slots() == [torch.device("cpu")] * 8
        assert ctx.mesh.line("seq") == [torch.device("cpu")] * 4
    finally:
        jctx.stop_nncontext()
    # no mesh_shape: one slot, the context's device, batch geometry by 1
    one = _fresh_context()
    assert one.num_devices == 1 and one.mesh.size == 1
    assert dict(one.mesh.shape) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="equal rank"):
        _fresh_context(mesh_shape=(2, 4), mesh_axis_names=("data",))


def test_slot_mesh_deals_round_robin_over_cards(monkeypatch):
    """On the card slots go round-robin over the visible cards: on one
    card every slot is that card, on four each of four slots its own."""
    for count, want in ((1, [0, 0, 0, 0]), (4, [0, 1, 2, 3]),
                        (2, [0, 1, 0, 1])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        mesh = SlotMesh.deal((1, 4), ("data", "seq"), torch.device("cuda"))
        assert [d.index for d in mesh.slots()] == want
        assert all(d.type == "cuda" for d in mesh.slots())


# -- MeshConfig.build over slots --------------------------------------------

def test_mesh_config_build_over_slots():
    slots = MeshConfig.from_spec("data=8").build()
    assert slots.shape == (8,) and slots.size == \
        jmesh.MeshConfig.from_spec("data=8").build().devices.size
    assert MeshConfig.from_spec("data=2,tp=4").build().shape == (2, 4)
    with pytest.raises(ValueError, match="needs 16 device") as e:
        MeshConfig.from_spec("data=16").build()
    assert "the context has 8" in str(e.value)
    with pytest.raises(ValueError):
        jmesh.MeshConfig.from_spec("data=16").build()
    # the data axis of one host process of a multi-host trainer
    assert MeshConfig.host_local_data().describe() == "data=1"


# -- ShardingPlan ------------------------------------------------------------

def _plans(pkg):
    M, S = pkg.MeshConfig, pkg.ShardingPlan
    return [S(M((8, 1, 1))),
            S(M((1, 1, 1))),
            S(M((2, 1, 4)), rules=((r"kernel$", (None, "tp")),
                                   (r"mesh_u1", ("fsdp", None)))),
            S(M.from_spec("data=2,tp=4"),
              rules=((r"embed", (("data", "tp"), None)),), data_axis="tp"),
            S(M((8,), ("data",)), rules=((r"bias", (None,)),))]


@pytest.mark.parametrize("i", range(5))
def test_plan_describe_and_fingerprint_strings_match_jax(i):
    plan, jplan = _plans(_port_mesh())[i], _plans(jmesh)[i]
    assert plan.describe() == jplan.describe()
    assert plan.fingerprint() == jplan.fingerprint()
    assert repr(plan) == repr(jplan)
    assert plan.data_axis_length == jplan.data_axis_length


def _port_mesh():
    import analytics_zoo_tpu_torch.mesh as m

    return m


def test_plan_rules_first_match_wins_and_replicated_default():
    rules = ((r"kernel$", (None, "tp")), (r"mesh_u1", ("fsdp", None)))
    plan = ShardingPlan(MeshConfig((2, 1, 4)), rules=rules)
    jplan = jmesh.ShardingPlan(jmesh.MeshConfig((2, 1, 4)), rules=rules)
    sh, jsh_ = plan.param_shardings(PARAMS), jplan.param_shardings(PARAMS)
    for layer in PARAMS:
        for leaf in PARAMS[layer]:
            got, want = sh[layer][leaf].spec, jsh_[layer][leaf].spec
            assert tuple(got) == tuple(want), (layer, leaf)
            assert str(got) == str(want)
    assert tuple(sh["mesh_u1"]["kernel"].spec) == (None, "tp")
    assert tuple(sh["mesh_u1"]["bias"].spec) == ("fsdp", None)
    assert tuple(sh["mesh_u2"]["bias"].spec) == ()
    sh2 = ShardingPlan(MeshConfig((8, 1, 1))).param_shardings(PARAMS)
    assert tuple(sh2["mesh_u1"]["kernel"].spec) == ()


@pytest.mark.parametrize("axis", ["bogus", "stage"])
def test_plan_refuses_unknown_and_stage_axes(axis):
    cfg = ((8,), ("data",)) if axis == "bogus" else ((2, 4), ("data",
                                                              "stage"))
    msgs = []
    for pkg in (_port_mesh(), jmesh):
        with pytest.raises(ValueError, match=axis) as e:
            pkg.ShardingPlan(pkg.MeshConfig(*cfg),
                             rules=((r"kernel", (axis,)),))
        msgs.append(str(e.value))
        with pytest.raises(TypeError):
            pkg.ShardingPlan("data=8")
    assert msgs[0] == msgs[1]


def test_plan_device_put_batch_is_data_sharded_and_never_aliases():
    plan = ShardingPlan(MeshConfig.from_spec("data=8"))
    x = np.arange(64, dtype=np.float32).reshape(16, 4)
    xs = plan.device_put_batch(x)
    assert tuple(xs.spec) == ("data", None)
    assert [tuple(s.shape) for s in xs.shards] == [(2, 4)] * 8
    np.testing.assert_array_equal(np.asarray(xs), x)
    x[:] = -1.0  # the batcher reuses its staging buffers
    assert float(xs.shards[0].min()) == 0.0
    assert not any(np.shares_memory(s.numpy(), x) for s in xs.shards)
    lst = plan.device_put_batch([x, x[:, :2]])
    assert [tuple(a.spec) for a in lst] == [("data", None), ("data", None)]
    assert tuple(plan.output_sharding().spec) == ("data",)
    assert str(plan.input_sharding(3).spec) == str(
        jmesh.ShardingPlan(jmesh.MeshConfig.from_spec(
            "data=8")).input_sharding(3).spec)


def test_plan_shard_params_gathers_bitwise():
    """A rule-matched leaf lives in shards on its slots; gathered it is the
    leaf itself (replicated leaves are one tensor per slot device)."""
    _fresh_context(mesh_shape=(2, 1, 4),
                   mesh_axis_names=("data", "fsdp", "tp"))
    plan = ShardingPlan(MeshConfig((2, 1, 4)),
                        rules=((r"kernel$", (None, "tp")),
                               (r"u2/bias", (("data", "tp"),))))
    rng = np.random.default_rng(0)
    params = {"u1": {"kernel": rng.normal(size=(6, 8)).astype(np.float32),
                     "bias": rng.normal(size=(8,)).astype(np.float32)},
              "u2": {"bias": rng.normal(size=(16,)).astype(np.float32)}}
    placed = plan.shard_params(params)
    k = placed["u1"]["kernel"]
    assert tuple(k.shards[0].shape) == (6, 2) and len(k.shards) == 8
    assert tuple(placed["u2"]["bias"].shards[5].shape) == (2,)
    # replicated: all slots on the CPU share one tensor
    assert len({id(t) for t in placed["u1"]["bias"].shards}) == 1
    for layer, leaves in params.items():
        for name, want in leaves.items():
            got = placed[layer][name].gather(torch.device("cpu"))
            np.testing.assert_array_equal(got.numpy(), want)


def test_param_shardings_clean_matches_jax():
    """Layer pspecs name the canonical axes; a mesh without one replicates
    that dim, in both packages; a non-canonical unknown name raises."""
    names = ("data", "seq")
    ctx = _fresh_context(mesh_shape=(2, 4), mesh_axis_names=names)
    jctx.stop_nncontext()
    jc = zoo.init_nncontext(mesh_shape=(2, 4), mesh_axis_names=names)
    try:
        pspecs = {"mesh_u1": {"kernel": (None, "model"),
                              "bias": ("model",)},
                  "mesh_u2": {"kernel": ("seq", None)}}
        got = tsh.param_shardings(ctx.mesh, PARAMS, pspecs)
        want = jsh.param_shardings(jc.mesh, PARAMS, pspecs)
        for layer in PARAMS:
            for leaf in PARAMS[layer]:
                assert str(got[layer][leaf].spec) == str(
                    want[layer][leaf].spec), (layer, leaf)
        assert tuple(got["mesh_u2"]["kernel"].spec) == ("seq", None)
        assert tuple(got["mesh_u1"]["kernel"].spec) == (None, None)
        bad = {"mesh_u1": {"kernel": (None, "typo")}}
        with pytest.raises(ValueError):
            tsh.param_shardings(ctx.mesh, PARAMS, bad)
        with pytest.raises(ValueError):
            jsh.param_shardings(jc.mesh, PARAMS, bad)
        placed = tsh.place_params(ctx.mesh, PARAMS, pspecs)
        assert tuple(placed["mesh_u2"]["kernel"].shards[1].shape) == (1, 2)
        batch = tsh.shard_batch(ctx.mesh, {"x": np.ones((4, 3))})
        assert batch["x"].dtype == torch.float32
        assert tuple(batch["x"].spec) == ("data", None)
    finally:
        jctx.stop_nncontext()


def test_plan_ladder_validation_text_and_single_row_warning(caplog):
    plan = ShardingPlan(MeshConfig.from_spec("data=8"))
    jplan = jmesh.ShardingPlan(jmesh.MeshConfig.from_spec("data=8"))
    plan.validate_ladder((16, 32))  # fine
    msgs = []
    for p in (plan, jplan):
        with pytest.raises(ValueError) as e:
            p.validate_ladder((1, 2, 4, 32))
        msgs.append(str(e.value))
        assert "[1, 2, 4]" in msgs[-1] and "'data'" in msgs[-1]
        with pytest.raises(ValueError) as e:
            p.validate_batch(13)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[2] and msgs[1] == msgs[3]
    with pytest.raises(BucketShardingError):
        plan.validate_batch(13)
    # a data axis of length 1 constrains nothing
    ShardingPlan(MeshConfig((1, 1, 8))).validate_ladder((1, 3, 7))
    warned = []
    for p, logger in ((plan, "analytics_zoo_tpu_torch"),
                      (jplan, "analytics_zoo_tpu")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            p.validate_ladder((8, 16))
        warned.append([r.getMessage() for r in caplog.records
                       if r.name == logger])
    assert len(warned[0]) == 1 and warned[0] == warned[1]
    assert "[8]" in warned[0][0]


# -- threading through InferenceModel / engines ----------------------------

def test_set_sharding_plan_invalidates_executables():
    im = InferenceModel().do_load_keras(_build_model())
    x = np.ones((8, 6), np.float32)
    ref = im.do_predict(x)
    assert len(im._compiled) == 1
    gen = im._gen
    im.set_sharding_plan(ShardingPlan(MeshConfig.from_spec("data=8")))
    assert len(im._compiled) == 0 and im._gen == gen + 1
    out = im.do_predict(x)
    assert len(im._compiled) == 8  # one executable per (bucket, slot)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    im.set_sharding_plan(None)
    assert len(im._compiled) == 0
    with pytest.raises(TypeError):
        im.set_sharding_plan("data=8")
    with pytest.raises(TypeError):
        InferenceModel(sharding_plan=ShardingPlan(
            MeshConfig((8, 1, 1)))).do_load_keras(
                _build_model()).set_sharding_plan(MeshConfig((8, 1, 1)))
    with pytest.raises(BucketShardingError):
        InferenceModel(sharding_plan=ShardingPlan(
            MeshConfig((8, 1, 1)))).do_load_keras(
                _build_model()).do_predict(np.ones((12, 6), np.float32))


def test_register_rejects_indivisible_ladder_without_mutating_model():
    im = InferenceModel().do_load_keras(_build_model())
    gen = im._gen
    engine = ServingEngine()
    try:
        with pytest.raises(BucketShardingError) as e:
            engine.register(
                "m", im, example_input=np.zeros((1, 6), np.float32),
                config=BatcherConfig(max_batch_size=32,
                                     buckets=(1, 2, 4, 32)),
                sharding_plan=ShardingPlan(MeshConfig.from_spec("data=8")))
        assert "'data'" in str(e.value) and "[1, 2, 4]" in str(e.value)
        # the rejected register left the model untouched
        assert im.sharding_plan is None and im._gen == gen
        assert engine.model_names() == []
        with pytest.raises(TypeError, match="set_sharding_plan"):
            engine.register(
                "d", object(), example_input=np.zeros((1, 3)),
                sharding_plan=ShardingPlan(MeshConfig.from_spec("data=8")))
        plan = ShardingPlan(MeshConfig.from_spec("data=8"))
        engine.register("m", im, example_input=np.zeros((1, 6), np.float32),
                        config=BatcherConfig(max_batch_size=32,
                                             buckets=(16, 32)),
                        sharding_plan=plan)
        assert im.sharding_plan is plan
        assert engine.entry("m").info()["sharding"] == jmesh.ShardingPlan(
            jmesh.MeshConfig.from_spec("data=8")).describe()
        assert im.cache_stats["misses"] == 16  # 2 buckets x 8 slots
    finally:
        engine.shutdown()


def test_batch_job_rejects_indivisible_bucket_before_reading_rows():
    class _Unread(ArraySource):
        def fetch(self, i):
            raise AssertionError("a row was read")

    im = InferenceModel().do_load_keras(_build_model())
    src = ArraySource(np.zeros((40, 6), np.float32))
    plan = ShardingPlan(MeshConfig.from_spec("data=8"))
    with pytest.raises(BucketShardingError) as e:
        BatchPredictJob(im, _Unread(np.zeros((40, 6), np.float32)),
                        batch_size=16, pad_to_bucket=(4, 16),
                        sharding_plan=plan)
    assert "[4]" in str(e.value) and "'data'" in str(e.value)
    assert im.sharding_plan is None  # rejected job left the model alone
    # the no-ladder shape (batch_size itself) is validated too
    with pytest.raises(BucketShardingError):
        BatchPredictJob(im, src, batch_size=12, sharding_plan=plan)
    BatchPredictJob(im, src, batch_size=16, pad_to_bucket=(8, 16),
                    sharding_plan=plan)  # divisible ladder passes
    assert im.sharding_plan is plan


def test_tfdataset_geometry_divides_by_the_slot_count():
    """``num_devices`` is the slot count, so TFDataset's batch geometry on
    8 slots is the JAX package's on its 8 devices."""
    import analytics_zoo_tpu.tfpark as jtp
    import analytics_zoo_tpu_torch.tfpark as ttp

    x, y = np.zeros((32, 4), np.float32), np.zeros(32)
    zoo.init_nncontext()
    try:
        for mod in (ttp, jtp):
            assert mod.TFDataset.from_ndarrays(
                (x, y), batch_per_thread=2).batch_size == 16
            with pytest.raises(ValueError, match="multiple of the"):
                mod.TFDataset.from_ndarrays((x, y), batch_size=12)
    finally:
        jctx.stop_nncontext()
