"""The serving tier end to end on the small BERT of
``test_torch_bert_serving`` (``CFG``, ``TOL``, JAX weights carried by
``interop.load_jax_params``), and ``InferenceModel``'s executable cache.

- Whole slice: the same weights registered in the JAX ``ServingEngine``
  and the port's with one bucket ladder; the same seeded ragged requests
  through both engines' ``predict`` and through the port's
  ``serving.http`` on loopback (BERT's three inputs as columnar JSON).
  The port's answers agree with the JAX engine's within ``TOL`` and over
  HTTP are bitwise its in-process answers.
- The executable cache: one sequence of warm-ups, predicts and a reload
  with ``executable_cache_size=2`` gives the JAX package's
  ``cache_stats``, ``warmup_overflows``, warmed set, LRU order and
  process-wide cache counters.
- Batcher exactness: a batched row is bitwise the row of ``do_predict``
  of the batch the batcher dispatched, at the same bucket shape (across
  shapes the forward may pick other kernels, so only a stated tolerance
  holds there).
- Host behaviour through the engine: an oversize request split, a full
  queue, a deadline, the surface the port has not ported yet (stage
  plans), a sharding plan on a model that cannot take one, and what
  generation raises on a model it cannot serve.
"""

import json
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import analytics_zoo_tpu.common.observability as jax_obs
import analytics_zoo_tpu.serving as jax_serving
from analytics_zoo_tpu.inference.inference_model import (
    InferenceModel as JaxInferenceModel,
)
from analytics_zoo_tpu.keras.engine.topology import Sequential as JaxSequential
from analytics_zoo_tpu.keras.layers import Dense as JaxDense
from analytics_zoo_tpu.tfpark.bert import BERTClassifierNet as JaxBERT
import analytics_zoo_tpu_torch as port
import analytics_zoo_tpu_torch.common.observability as port_obs
import analytics_zoo_tpu_torch.serving as port_serving
from analytics_zoo_tpu_torch.inference import InferenceModel
from analytics_zoo_tpu_torch.interop import load_jax_params
from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts
from analytics_zoo_tpu_torch.keras.engine.topology import Sequential
from analytics_zoo_tpu_torch.keras.layers import Dense
from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet
from test_torch_bert_serving import CFG, TOL, _perturb

JOIN_S = 60
LADDER = (1, 2, 4, 8)
SEQ = CFG["seq_len"]


@pytest.fixture(autouse=True)
def _port_context():
    port.init_nncontext(device="cpu")
    yield
    port.stop_nncontext()
    reset_name_counts()


def _request(rng, rows):
    lens = rng.integers(1, SEQ + 1, rows)
    pos = np.arange(SEQ)[None, :]
    mask = (pos < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, CFG["vocab"], (rows, SEQ)) * mask).astype(np.int32)
    types = ((pos >= lens[:, None] // 2) * mask).astype(np.int32)
    return [ids, types, mask]


def _example():
    return [np.zeros((1, SEQ), np.int32), np.zeros((1, SEQ), np.int32),
            np.zeros((1, SEQ), np.float32)]


def _models(dtype, seed=0):
    """The JAX and the port InferenceModel of one small BERT's weights."""
    jnet = JaxBERT(num_classes=3, **CFG)
    jim = JaxInferenceModel().do_load_keras(jnet)
    params = _perturb(jim.params, seed)
    jim.params = jax.tree_util.tree_map(jnp.asarray, params)
    net = BERTClassifierNet(num_classes=3, **CFG)
    load_jax_params(net, params)
    if dtype == "float32":
        jnet.compute_dtype = net.compute_dtype = None
    return jim, InferenceModel().do_load_keras(net)


def _post_json(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=JOIN_S) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whole_slice_bert_through_both_engines_and_http(dtype):
    jim, im = _models(dtype)
    engines = {"jax": jax_serving.ServingEngine(),
               "port": port_serving.ServingEngine()}
    cfgs = {"jax": jax_serving.BatcherConfig(max_batch_size=8,
                                             buckets=LADDER, max_wait_ms=1.0),
            "port": port_serving.BatcherConfig(max_batch_size=8,
                                               buckets=LADDER,
                                               max_wait_ms=1.0)}
    srv = None
    try:
        engines["jax"].register("bert", jim, _example(), config=cfgs["jax"])
        engines["port"].register("bert", im, _example(), config=cfgs["port"])
        assert im.cache_stats == {"hits": 0, "misses": len(LADDER),
                                  "evictions": 0}
        srv, _ = port_serving.serve_http(engines["port"], port=0)
        url = f"http://127.0.0.1:{srv.server_port}/v1/models/bert:predict"
        rng = np.random.default_rng(11)
        for rows in (1, 3, 2, 8, 5, 1, 4):
            x = _request(rng, rows)
            j = np.asarray(engines["jax"].predict("bert", x))
            t = engines["port"].predict("bert", x)
            h = np.asarray(_post_json(url, {
                "inputs": [a.tolist() for a in x]})["predictions"],
                np.float32)
            assert t.shape == j.shape == (rows, 3) and t.dtype == np.float32
            np.testing.assert_allclose(t, j, rtol=0, atol=TOL[dtype])
            np.testing.assert_array_equal(h, t)
        # register warmed every bucket; serving never built another
        assert im.cache_stats["misses"] == len(LADDER)
        assert im.cache_stats["evictions"] == 0
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        for e in engines.values():
            e.shutdown()


def _dense(pkg_sequential, pkg_dense):
    """A one-layer model; each build draws fresh weights."""
    m = pkg_sequential()
    m.add(pkg_dense(3, input_shape=(4,)))
    return m


def _cache_walk(im, build, counters):
    """One sequence of warm-ups, predicts and a reload; returns what the
    executable cache shows after each step."""
    x = {n: np.arange(4 * n, dtype=np.float32).reshape(n, 4) for n in
         (1, 2, 4)}
    before = {k: c.value for k, c in counters.items()}
    steps = [("warm", 1), ("warm", 2), ("predict", 1), ("warm", 4),
             ("predict", 2), ("predict", 4), ("predict", 4), ("reload", 0),
             ("predict", 1), ("warm", 2)]
    trail = []
    for op, n in steps:
        if op == "warm":
            im.do_optimize(x[n])
        elif op == "predict":
            im.do_predict(x[n])
        else:
            im.do_load_keras(build())
        trail.append((op, n, dict(im.cache_stats), im.warmup_overflows,
                      sorted(im._warmed), list(im._compiled)))
    deltas = {k: c.value - before[k] for k, c in counters.items()}
    return trail, deltas


def test_executable_cache_matches_the_jax_package():
    """LRU of two: warming three shapes overflows once and evicts the
    least recently used; a reload drops every executable and the warmed
    set but keeps the counts. The port's trail equals the JAX package's
    step by step."""
    jax_build = lambda: _dense(JaxSequential, JaxDense)  # noqa: E731
    port_build = lambda: _dense(Sequential, Dense)  # noqa: E731
    jm = JaxInferenceModel(executable_cache_size=2).do_load_keras(
        jax_build())
    pm = InferenceModel(executable_cache_size=2).do_load_keras(port_build())
    j = _cache_walk(jm, jax_build, jax_obs.inference_cache_counters())
    p = _cache_walk(pm, port_build, port_obs.inference_cache_counters())
    assert p == j
    assert p[0][-1][2] == {"hits": 3, "misses": 6, "evictions": 2}
    assert p[0][-1][3] == 1  # the third distinct warm-up overflowed the cap
    assert p[1] == {"hits": 3, "misses": 6, "evictions": 2,
                    "warmup_overflow": 1}


def test_unbounded_cache_and_release():
    im = InferenceModel(executable_cache_size=None).do_load_keras(
        _dense(Sequential, Dense))
    for n in range(1, 40):
        im.do_optimize(np.zeros((n, 4), np.float32))
    assert len(im._compiled) == 39 and im.cache_stats["evictions"] == 0
    assert im.warmup_overflows == 0
    im.release()
    assert not im._compiled and not im._warmed
    with pytest.raises(RuntimeError, match="No model loaded"):
        im.do_predict(np.zeros((1, 4), np.float32))


def test_reload_serves_the_new_weights():
    """Load A, warm, load B: predict gives B's answer (a graph on the card
    captures parameters by address, so a reload must build anew)."""
    a, b = _dense(Sequential, Dense), _dense(Sequential, Dense)
    x = np.ones((2, 4), np.float32)
    im = InferenceModel().do_load_keras(a)
    im.do_optimize(x)
    y_a = im.do_predict(x)
    im.do_load_keras(b)
    y_b = im.do_predict(x)
    np.testing.assert_array_equal(
        y_b, InferenceModel().do_load_keras(b).do_predict(x))
    assert not np.array_equal(y_a, y_b)
    assert im.cache_stats["misses"] == 2


class _Recorder:
    """Stands in for ``do_dispatch``: keeps a copy of every batch the
    batcher dispatched."""

    def __init__(self, im):
        self.batches, self._dispatch = [], im.do_dispatch
        im.do_dispatch = self

    def __call__(self, x):
        self.batches.append([np.array(a) for a in x])
        return self._dispatch(x)


def test_batched_rows_are_bitwise_do_predict_of_their_batch():
    """Concurrent ragged requests share batches; each answer is bitwise
    the matching rows of ``do_predict`` of the whole dispatched batch (the
    same bucket shape), and within a stated tolerance of ``do_predict`` of
    the request alone (another shape: 1e-6 absolute on probabilities, f32
    sums in another blocking)."""
    _, im = _models("float32")
    rec = _Recorder(im)
    engine = port_serving.ServingEngine()
    try:
        engine.register("bert", im, _example(), config=port_serving
                        .BatcherConfig(max_batch_size=8, buckets=LADDER,
                                       max_wait_ms=20.0))
        rng = np.random.default_rng(5)
        reqs = [_request(rng, int(r)) for r in rng.integers(1, 4, 12)]
        futs = [engine.predict_async("bert", x) for x in reqs]
        outs = [f.result(timeout=JOIN_S) for f in futs]
    finally:
        engine.shutdown()
    assert any(len(b[0]) > 3 for b in rec.batches), "nothing was batched"
    index = {}
    for j, b in enumerate(rec.batches):
        for i in range(len(b[0])):
            index.setdefault(b[0][i].tobytes() + b[2][i].tobytes(), (j, i))
    replay = [im.do_predict(b) for b in rec.batches]
    for x, y in zip(reqs, outs):
        j, i = index[x[0][0].tobytes() + x[2][0].tobytes()]
        rows = len(x[0])
        np.testing.assert_array_equal(rec.batches[j][0][i:i + rows], x[0])
        np.testing.assert_array_equal(y, replay[j][i:i + rows])
        np.testing.assert_allclose(y, im.do_predict(x), rtol=0, atol=1e-6)


class _Held:
    """A duck-typed model whose dispatch waits on ``gate`` after setting
    ``entered``."""

    def __init__(self, im):
        self.im, self.gate, self.entered = im, threading.Event(), \
            threading.Event()

    def do_predict(self, x):
        self.entered.set()
        assert self.gate.wait(timeout=JOIN_S)
        return self.im.do_predict(x)


def test_engine_host_behaviour_split_queue_full_deadline():
    _, im = _models("float32")
    held = _Held(im)
    engine = port_serving.ServingEngine()
    try:
        engine.register("bert", im, _example(), config=port_serving
                        .BatcherConfig(max_batch_size=4, buckets=(1, 2, 4),
                                       max_wait_ms=1.0))
        big = _request(np.random.default_rng(3), 11)
        y = engine.predict("bert", big)
        assert y.shape == (11, 3)
        np.testing.assert_allclose(y, im.do_predict(big), rtol=0, atol=1e-6)
        engine.register("held", held, _example(), warmup=False,
                        config=port_serving.BatcherConfig(
                            max_batch_size=1, max_wait_ms=1.0,
                            max_queue_size=2, pipeline_depth=0))
        x = _request(np.random.default_rng(4), 1)
        first = engine.predict_async("held", x)
        assert held.entered.wait(timeout=JOIN_S)
        late = engine.predict_async("held", x, timeout_ms=1.0)
        queued = engine.predict_async("held", x)
        with pytest.raises(port_serving.QueueFullError):
            engine.predict_async("held", x)
        time.sleep(0.02)  # past the late request's 1 ms deadline
        held.gate.set()
        want = im.do_predict(x)
        for f in (first, queued):
            np.testing.assert_array_equal(f.result(timeout=JOIN_S), want)
        with pytest.raises(port_serving.DeadlineExceededError):
            late.result(timeout=JOIN_S)
    finally:
        held.gate.set()
        engine.shutdown()


@pytest.mark.parametrize("call", ["generate", "generate_async",
                                  "watch_checkpoints", "sequence",
                                  "sharding_plan", "stage_plan"])
def test_unported_surfaces_raise_naming_the_roadmap(call):
    """A sharding or stage plan given with a model that cannot take one
    raises the JAX package's ``TypeError`` (``tests/test_torch_mesh.py``,
    ``tests/test_torch_serving_mesh.py`` and
    ``tests/test_torch_pipeline.py`` drive the plans). Generation and
    hot reload are ported
    (``tests/test_torch_sequence_serving.py`` and
    ``tests/test_torch_hot_reload.py`` drive them); their cases here hold
    what they raise on what they cannot serve: ``generate`` and
    ``generate_async`` of an unregistered name raise the registry miss,
    ``register(sequence=)`` of a model without the decode contract raises
    ``TypeError``, and ``watch_checkpoints(aot_cache_dir=...)`` raises:
    the port keeps no persistent executable cache. Either way the engine
    stays empty."""
    engine = port_serving.ServingEngine()
    ex = np.zeros((1, 3), np.float32)
    try:
        if call in ("generate", "generate_async"):
            with pytest.raises(port_serving.ModelNotFoundError):
                getattr(engine, call)("m", [1, 2])
        elif call == "sequence":
            plain = type("Plain", (), {"do_predict": lambda self, x: x})()
            with pytest.raises(TypeError, match="seq_init_carries"):
                engine.register("m", plain, ex,
                                sequence=port_serving.SequenceConfig())
        elif call == "watch_checkpoints":
            with pytest.raises(NotImplementedError,
                               match="no persistent executable cache"):
                engine.watch_checkpoints("m", "/nonexistent", None, ex,
                                         aot_cache_dir="/nonexistent")
        else:
            with pytest.raises(TypeError, match=f"set_{call}"):
                engine.register("m", object(), ex, **{call: object()})
        assert engine.model_names() == []
    finally:
        engine.shutdown()
