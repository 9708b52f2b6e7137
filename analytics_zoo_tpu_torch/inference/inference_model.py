"""Serving runtime (port of ``analytics_zoo_tpu.inference.inference_model``).

load → warm each bucket shape → concurrent predict. The forward is the JAX
package's compiled ``forward``: float32 params and inputs are cast to the
model's ``compute_dtype``, the model runs under ``torch.inference_mode()``,
and floating outputs come back as float32 (float64 requests reach the card
as float32, as in the JAX package). PyTorch runs eagerly, so there is
no executable cache: ``do_optimize`` runs a bucket shape once, which builds
the CUDA kernels and warms cuBLAS for it, and records the shape in
``_warmed``.

Quantization and calibration, sharding and stage plans, the AOT cache and
the TF/ONNX loaders are not ported yet.
"""

from __future__ import annotations

import threading
from typing import Any, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    host_to_device,
)
from analytics_zoo_tpu_torch.common.tree import tree_map


class InferenceModel:
    """load → (optional) warm → thread-safe predict, on the context's device
    (the CUDA card unless the context was made with ``device="cpu"``)."""

    def __init__(self):
        self.model = None
        self.params = None
        self.model_state = None
        self.device = None
        self._exec_params = None  # params cast to the compute dtype
        self._warmed: set = set()
        self._lock = threading.Lock()
        # bumped on every load/release; a warm-up that raced one is dropped
        self._gen = 0

    def do_load_keras(self, keras_net) -> "InferenceModel":
        """Adopt an in-memory KerasNet: its ``params`` and ``model_state``
        (drawn from the context's generator if it has none; after ``fit``
        or ``Estimator.train``, the trained ones that the estimator wrote
        back) are copied to the device, and the params cast once to the
        model's compute dtype for the forward. The state stays as it is
        (batch norm's f32 moving statistics), as in the JAX package."""
        with torch.inference_mode(False):  # the net may train later
            keras_net.ensure_params()
        device = get_nncontext().device
        params, state = (tree_map(lambda t: t.to(device, copy=True), tree)
                         for tree in (keras_net.params,
                                      keras_net.model_state or {}))
        cd = getattr(keras_net, "compute_dtype", None)
        if cd:
            dt = getattr(torch, cd)
            exec_params = tree_map(
                lambda t: t.to(dt) if t.dtype == torch.float32 else t, params)
        else:
            exec_params = params
        with self._lock:
            self._gen += 1
            self._warmed.clear()
            self.model = keras_net
            self.device = device
            self.params = params
            self._exec_params = exec_params
            self.model_state = state
        return self

    @staticmethod
    def _shape_key(x) -> Tuple:
        if isinstance(x, (list, tuple)):
            return tuple((tuple(a.shape), str(a.dtype)) for a in x)
        return ((tuple(x.shape), str(x.dtype)),)

    def _forward(self, x) -> Any:
        """Run the model on host arrays; returns device tensors."""
        with self._lock:
            model, params = self.model, self._exec_params
            state, device = self.model_state, self.device
        if model is None:
            raise RuntimeError("No model loaded — call do_load_keras")
        cd = getattr(model, "compute_dtype", None)
        dt = getattr(torch, cd) if cd else None

        def to_device(a):
            # a copy (a batcher reusing its staging buffers may overwrite
            # the array as soon as this returns), float64 made float32
            t = host_to_device(a, device)
            return t.to(dt) if dt is not None and t.dtype == torch.float32 \
                else t

        with torch.inference_mode():
            xs = (list(map(to_device, x)) if isinstance(x, (list, tuple))
                  else to_device(x))
            y, _ = model.apply(params, state, xs, training=False, rng=None)
            return tree_map(
                lambda t: t.float() if t.is_floating_point() else t, y)

    def do_optimize(self, example_input) -> "InferenceModel":
        """Warm one bucket shape: run it once (building the kernels and
        warming cuBLAS for it) and record it in ``_warmed``."""
        with self._lock:
            gen = self._gen
        self.do_fetch(self._forward(example_input))
        with self._lock:
            if self._gen == gen:
                self._warmed.add(self._shape_key(example_input))
        return self

    def do_predict(self, x):
        """Thread-safe predict: host arrays in, host float32 arrays out."""
        return self.do_fetch(self.do_dispatch(x))

    def do_dispatch(self, x):
        """Enqueue the forward and return the device output without waiting
        for it; pair with :meth:`do_fetch`."""
        if isinstance(x, (list, tuple)):
            x = [np.asarray(a) for a in x]
        else:
            x = np.asarray(x)
        return self._forward(x)

    def do_fetch(self, out):
        """Materialize a :meth:`do_dispatch` output as host numpy arrays
        (waits for the device)."""
        return tree_map(lambda t: t.cpu().numpy(), out)

    predict = do_predict

    def release(self) -> None:
        """Drop the model and its parameters."""
        with self._lock:
            self._gen += 1
            self._warmed.clear()
            self.model = None
            self.params = None
            self._exec_params = None
            self.model_state = None
