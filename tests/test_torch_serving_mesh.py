"""Mesh-parallel serving in the port (the cases of
``tests/test_serving_mesh.py``) on 8 CPU slots:

- a ``data=8`` engine against the unsharded engine on every bucket of the
  ladder and at 5 and 13 rows (off-ladder sizes pad to a bucket), within
  ``SHARD_TOL`` = 1e-6, and both against the JAX package's unsharded engine
  on the same weights within ``JAX_TOL`` = 1e-5; no executable is built
  after ``register``;
- concurrent HTTP predicts and a hot reload to a new version under the
  plan;
- a sharded ``BatchPredictJob`` against the unsharded one over a whole
  dataset.

No case asserts bitwise equality of sharded and unsharded results: a data
slot's rows are another batch shape, whose products may sum in another
order (the JAX package's own sharded path is 5.96e-08 off at 16 rows).
"""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu.serving as jax_serving
import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.keras.engine.topology import Sequential as JaxSeq
from analytics_zoo_tpu.keras.layers import Dense as JaxDense
from analytics_zoo_tpu_torch.batch import BatchPredictJob
from analytics_zoo_tpu_torch.data.sources import ArraySource
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.mesh import MeshConfig, ShardingPlan
from analytics_zoo_tpu_torch.serving import (
    BatcherConfig,
    ServingEngine,
    serve_http,
)

BUCKETS = (16, 32, 64)  # two rows or more on each of 8 data slots
FEATURES = 6
SHARD_TOL = 1e-6
JAX_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_context():
    port.stop_nncontext()
    port.init_nncontext(device="cpu", mesh_shape=(8,),
                        mesh_axis_names=("data",))
    yield
    port.stop_nncontext()
    reset_name_counts()


def _plan():
    return ShardingPlan(MeshConfig.from_spec("data=8"))


def _nets(names, seed):
    """The JAX package's InferenceModel of a seeded net and the port's net
    on its weights."""
    jnet = JaxSeq(name="meshe")
    jnet.add(JaxDense(4, activation="relu", input_shape=(FEATURES,),
                      name=names[0]))
    jnet.add(JaxDense(2, name=names[1]))
    params = jax.tree_util.tree_map(
        np.asarray, jnet.init(jax.random.PRNGKey(seed))[0])
    jim = JaxInferenceModel().do_load_keras(jnet)
    jim.params = jax.tree_util.tree_map(jnp.asarray, params)
    net = Sequential(name="meshe")
    net.add(Dense(4, activation="relu", input_shape=(FEATURES,),
                  name=names[0]))
    net.add(Dense(2, name=names[1]))
    load_jax_params(net, params)
    return jim, net


def _cfg(pkg_config=BatcherConfig):
    return pkg_config(max_batch_size=BUCKETS[-1], buckets=BUCKETS,
                      max_wait_ms=1.0)


def _example():
    return np.zeros((1, FEATURES), np.float32)


def test_sharded_engine_matches_unsharded_every_bucket():
    jim, net = _nets(("mesh_e1", "mesh_e2"), 0)
    ref_engine, sh_engine = ServingEngine(), ServingEngine()
    j_engine = jax_serving.ServingEngine()
    ref_im, sh_im = InferenceModel().do_load_keras(net), \
        InferenceModel().do_load_keras(net)
    try:
        ref_engine.register("m", ref_im, _example(), config=_cfg())
        sh_engine.register("m", sh_im, _example(), config=_cfg(),
                           sharding_plan=_plan())
        j_engine.register("m", jim, _example(),
                          config=_cfg(jax_serving.BatcherConfig))
        assert sh_im.cache_stats["misses"] == 8 * len(BUCKETS)
        misses = sh_im.cache_stats["misses"]
        rng = np.random.RandomState(7)
        for rows in BUCKETS + (5, 13):  # off-ladder sizes pad to a bucket
            x = rng.randn(rows, FEATURES).astype(np.float32)
            ref = np.asarray(ref_engine.predict("m", x))
            out = np.asarray(sh_engine.predict("m", x))
            want = np.asarray(j_engine.predict("m", x))
            assert out.shape == ref.shape == (rows, 2)
            np.testing.assert_allclose(out, ref, rtol=0, atol=SHARD_TOL,
                                       err_msg=f"rows={rows}")
            for got in (out, ref):
                np.testing.assert_allclose(got, want, rtol=0, atol=JAX_TOL)
        assert sh_im.cache_stats["misses"] == misses  # warm-up covered all
        assert sh_engine.entry("m").info()["sharding"]["mesh"] == "data=8"
    finally:
        ref_engine.shutdown()
        sh_engine.shutdown()
        j_engine.shutdown()


def test_concurrent_http_predicts_and_hot_reload_under_the_plan():
    _, net_v1 = _nets(("mh_a1", "mh_a2"), 1)
    _, net_v2 = _nets(("mh_b1", "mh_b2"), 2)
    ref, ref2 = (InferenceModel().do_load_keras(n) for n in (net_v1,
                                                             net_v2))
    engine = ServingEngine()
    srv = None
    try:
        im1 = InferenceModel().do_load_keras(net_v1)
        engine.register("m", im1, _example(), config=_cfg(),
                        sharding_plan=_plan())
        srv, _t = serve_http(engine, port=0)
        base = f"http://127.0.0.1:{srv.server_port}"
        rng = np.random.RandomState(11)
        xs = [rng.randn(16, FEATURES).astype(np.float32) for _ in range(6)]
        expected = [ref.do_predict(x) for x in xs]
        misses = im1.cache_stats["misses"]
        results, errors = [None] * len(xs), []

        def hit(i):
            try:
                req = urllib.request.Request(
                    f"{base}/v1/models/m:predict",
                    data=json.dumps({"instances": xs[i].tolist()}).encode(),
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=30) as resp:
                    assert resp.status == 200
                    results[i] = np.asarray(
                        json.loads(resp.read())["predictions"], np.float32)
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append((i, e))

        threads = [threading.Thread(target=hit, args=(i,))
                   for i in range(len(xs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, f"concurrent HTTP predicts failed: {errors}"
        for got, want in zip(results, expected):
            np.testing.assert_allclose(got, want, rtol=0, atol=SHARD_TOL)
        assert im1.cache_stats["misses"] == misses

        # hot reload: a new version under the same plan takes over the
        # version-less route; its warm-up builds, its traffic does not
        im2 = InferenceModel().do_load_keras(net_v2)
        engine.register("m", im2, _example(), config=_cfg(),
                        sharding_plan=_plan())
        misses2 = im2.cache_stats["misses"]
        out = np.asarray(engine.predict("m", xs[0]))
        np.testing.assert_allclose(out, ref2.do_predict(xs[0]), rtol=0,
                                   atol=SHARD_TOL)
        assert not np.allclose(out, expected[0])  # really the new model
        assert im2.cache_stats["misses"] == misses2
    finally:
        if srv is not None:
            srv.shutdown()
        engine.shutdown()


def test_batch_job_sharded_matches_unsharded():
    _, net = _nets(("mb_c1", "mb_c2"), 3)
    X = np.random.RandomState(3).randn(72, FEATURES).astype(np.float32)

    def run(sharded):
        job = BatchPredictJob(
            InferenceModel().do_load_keras(net), ArraySource(X),
            batch_size=32, pad_to_bucket=(16, 32),
            sharding_plan=_plan() if sharded else None)
        return np.concatenate([np.asarray(b)
                               for b in job.scored_blocks()], axis=0)

    ref, out = run(sharded=False), run(sharded=True)
    assert ref.shape == out.shape == (X.shape[0], 2)
    np.testing.assert_allclose(out, ref, rtol=0, atol=SHARD_TOL)
