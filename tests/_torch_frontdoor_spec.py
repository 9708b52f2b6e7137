"""Engine-factory specs for the port's front-door and fleet tests.

Loaded by worker subprocesses through ``--spec
/path/to/_torch_frontdoor_spec.py:<factory>``; nothing here imports jax
or the JAX package.

- ``build_engine``: a numpy linear model with fixed-seed weights (every
  replica computes bit-identical outputs, which the parity and failover
  tests rely on), registered as ``lin``.
- ``build_fleet_engine``: the fleet tests' engine, result cache on, with
  ``lin``, a pid probe ``pid`` and a two-version ``ver``.
- ``build_bert_engine``: a narrow port ``BERTClassifierNet`` served by
  the port's ``InferenceModel`` on the CPU (``init_nncontext(device=
  "cpu")``), its weights loaded with ``KerasNet.load_weights`` from the
  file named by ``AZOO_TEST_BERT_WEIGHTS``, registered as ``bert``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine

FEATURES = 4

#: the narrow BERT of tests/test_torch_bert_serving.py
BERT_CFG = dict(vocab=50, hidden_size=32, n_block=2, n_head=2, seq_len=128,
                intermediate_size=64, hidden_drop=0.0, attn_drop=0.0)
BERT_CLASSES = 3


class LinearModel:
    """y = x @ W + b with fixed-seed weights."""

    def __init__(self):
        rng = np.random.default_rng(7)
        self.w = rng.standard_normal((FEATURES, 3)).astype(np.float32)
        self.b = rng.standard_normal((3,)).astype(np.float32)

    def do_predict(self, x):
        return np.asarray(x, np.float32) @ self.w + self.b


def build_engine() -> ServingEngine:
    engine = ServingEngine()
    engine.register("lin", LinearModel(),
                    example_input=np.zeros((1, FEATURES)),
                    config=BatcherConfig(max_batch_size=8, max_wait_ms=1.0))
    return engine


class PidModel:
    """Every row answers with this process's pid (the stickiness probe)."""

    def do_predict(self, x):
        n = np.asarray(x).shape[0]
        return np.full((n, 1), os.getpid(), dtype=np.int64)


class ConstModel:
    """Every row answers ``value``: v1 answers 1.0, v2 answers 2.0."""

    def __init__(self, value):
        self.value = float(value)

    def do_predict(self, x):
        n = np.asarray(x).shape[0]
        return np.full((n, 1), self.value, dtype=np.float32)


def build_fleet_engine() -> ServingEngine:
    """The fleet tests' engine: the result cache on (its keys are
    host-agnostic), ``lin``, ``pid`` and ``ver`` v1/v2."""
    from analytics_zoo_tpu_torch.serving import ResultCacheConfig

    engine = ServingEngine(
        result_cache=ResultCacheConfig(max_entries=256, ttl_s=None))
    example = np.zeros((1, FEATURES))
    cfg = dict(max_batch_size=8, max_wait_ms=1.0)
    engine.register("lin", LinearModel(), example_input=example,
                    config=BatcherConfig(**cfg))
    engine.register("pid", PidModel(), example_input=example,
                    config=BatcherConfig(**cfg))
    engine.register("ver", ConstModel(1.0), example_input=example,
                    version="1", config=BatcherConfig(**cfg))
    engine.register("ver", ConstModel(2.0), example_input=example,
                    version="2", config=BatcherConfig(**cfg))
    return engine


def build_bert_net():
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    net = BERTClassifierNet(num_classes=BERT_CLASSES, **BERT_CFG)
    net.compute_dtype = None  # float32
    return net


def build_bert_engine() -> ServingEngine:
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.inference import InferenceModel

    init_nncontext(device="cpu")
    net = build_bert_net()
    net.load_weights(os.environ["AZOO_TEST_BERT_WEIGHTS"])
    im = InferenceModel().do_load_keras(net)
    seq = BERT_CFG["seq_len"]
    example = [np.zeros((1, seq), np.int32), np.zeros((1, seq), np.int32),
               np.ones((1, seq), np.float32)]
    engine = ServingEngine()
    engine.register("bert", im, example_input=example,
                    config=BatcherConfig(max_batch_size=4, max_wait_ms=1.0))
    return engine
