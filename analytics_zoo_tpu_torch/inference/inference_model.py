"""Serving runtime (port of ``analytics_zoo_tpu.inference.inference_model``).

load → warm each bucket shape → concurrent predict. The forward is the JAX
package's compiled ``forward``: float32 params and inputs are cast to the
model's ``compute_dtype``, the model runs under ``torch.inference_mode()``,
and floating outputs come back as float32 (float64 requests reach the card
as float32, as in the JAX package).

**The executable cache** keeps the JAX package's semantics: one
executable per input signature (:meth:`InferenceModel._shape_key`) in an
LRU capped by ``executable_cache_size`` (``None``: unbounded), counted in
``cache_stats`` (hits, misses, evictions) and in the process-wide
``zoo_inference_cache_events_total``; ``do_optimize`` records the warmed
signatures and counts a warm-up that overflows the cap
(``warmup_overflows``). ``_gen`` is bumped by every load and release: an
executable built for generation *g* is cached and replayed only while
``_gen == g``.

An executable is a *program*, ``inner(params, state, *args)`` at one
argument signature; a predict bucket is the program of the model's
inference forward with the request as its one argument. What it is
depends on the device:

- on the CPU, the eager call (:class:`_EagerProgram`);
- on the card, a CUDA graph captured over the whole call
  (:class:`_GraphProgram`): the arguments are copied into the graph's
  static inputs, cast to the compute dtype inside the graph, and the
  replay's outputs are cloned on the card before the lock is released.
  A capture that fails raises; there is no eager fallback on the card.

**Graph memory.** On the card a model's graphs share one memory pool, and
PyTorch lets its allocator hand a pool's blocks back to the device (at its
next release of cached blocks, such as ``torch.cuda.empty_cache``) only
once no graph of the pool is left: after a load, a release, a quantize or
calibrate, or the eviction of the last graph. An eviction that leaves
other graphs alive frees no card memory; its blocks are reused by the
pool's next capture. So ``executable_cache_size`` bounds the number of
graphs, not the card memory they hold (``chip_smoke.py`` phase 11c prints
the reserved MiB around both kinds of eviction).

**Programs** (:meth:`InferenceModel.compile_program`, the sequence tier's
compile surface) are the same executables over argument pytrees, keyed
``("__prog__", tag, args key)`` in the same LRU, ``cache_stats`` and
``_gen`` discipline as the buckets; their outputs feed the next program
(prefill -> admit -> step -> step), and integer tensors keep their dtype
(int32 tokens stay int32).

**int8.** :meth:`InferenceModel.do_quantize` is weight-only int8: every
float leaf of rank 2 or more becomes a qleaf ``{"__q8__": int8, "scale":
float32}`` (symmetric, per output channel), which stays int8 on the card;
every program dequantizes it on each call, ``bf16(f32(q) * scale)`` under
bf16 compute, inside the bucket's CUDA graph, as the JAX package's forward
does. :meth:`InferenceModel.do_calibrate` is static int8
(:mod:`~analytics_zoo_tpu_torch.inference.calibration`): Dense and Conv2D
kernels become qleafs with an activation scale, and those layers run
integer products (:mod:`analytics_zoo_tpu_torch.ops.int8`); their qleafs
pass the compute-dtype cast whole, so a float32 scale never rounds
through bf16.

**Imported graphs.** :meth:`InferenceModel.do_load_onnx` serves an ONNX
model (:mod:`analytics_zoo_tpu_torch.onnx`) like any other: its float
initializers are the parameters (quantizable along ONNX's channel axes),
its integer initializers stay host arrays that keep its shape chains
static, and on the card each bucket is a CUDA graph.

Not ported yet: sharding and stage plans (ROADMAP A7), the TF loader
(``do_load_tf``: ROADMAP A6, TensorFlow importers) and the persistent AOT
executable cache (A4: ``aot_cache_dir`` and ``set_aot_cache`` raise
``NotImplementedError``).
"""

from __future__ import annotations

import collections
import logging
import threading
import time
import weakref
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.nncontext import (
    get_nncontext,
    host_to_device,
)
from analytics_zoo_tpu_torch.common.observability import (
    get_tracer,
    inference_cache_counters,
)
from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.ops import _kernels

logger = logging.getLogger("analytics_zoo_tpu_torch")

# One CUDA graph capture at a time in the process: two models' captures must
# not overlap (each begins with a warm-up that synchronises its side stream,
# and a capture's memory-pool routing is process-wide).
_CAPTURE_LOCK = threading.Lock()


def _quantize_leaf(w, channel_axis: int = -1) -> Any:
    """Per-output-channel symmetric int8 of a floating tensor of rank 2 or
    more (anything else is returned as it is): ``{"__q8__": int8, "scale":
    float32 keepdims}`` with ``scale = max|w| / 127`` over every axis but
    ``channel_axis`` (1 where that is 0) and ``q = clip(round(w / scale),
    -127, 127)``, rounding half to even. ``channel_axis`` is the output
    channel: -1 for Keras (in, out) kernels."""
    if not (isinstance(w, torch.Tensor) and w.is_floating_point()
            and w.dim() >= 2):
        return w
    ch = channel_axis % w.dim()
    axes = tuple(a for a in range(w.dim()) if a != ch)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which can land 1 ulp off the quotient
    # (and so off JAX's scale, and flip a rounding of q)
    scale = w.abs().amax(dim=axes, keepdim=True) / torch.full(
        (), 127.0, dtype=w.dtype, device=w.device)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"__q8__": q, "scale": scale.float()}


def _dequantize_leaf(leaf: Any) -> Any:
    """``f32(q) * scale`` of a qleaf; anything else as it is."""
    if _is_qleaf(leaf):
        return torch.mul(leaf["__q8__"], leaf["scale"])  # int8 * f32 -> f32
    return leaf


def _is_qleaf(x) -> bool:
    return isinstance(x, dict) and "__q8__" in x


def _dequantize_params(params, dtype: Optional[torch.dtype] = None):
    """The tree with every qleaf dequantized, ``f32(q) * scale``, and cast
    to ``dtype`` after when one is given (``bf16(f32(q) * scale)``); the
    other leaves as they are. What a weight-only int8 program runs on."""
    return tree_map(
        lambda t: (t if not _is_qleaf(t) else _dequantize_leaf(t)
                   if dtype is None else _dequantize_leaf(t).to(dtype)),
        params, is_leaf=_is_qleaf)


def param_bytes(tree) -> int:
    """Bytes the tensors of a parameter tree hold (a qleaf's int8 payload
    and its scales counted as they are)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))



def _cast_params(params, model):
    """The parameters the programs run on: float32 leaves cast once to the
    model's compute dtype; qleafs whole (their int8 payload, and their
    float32 scales, which must not round through bf16)."""
    cd = getattr(model, "compute_dtype", None)
    if not cd:
        return params
    dt = getattr(torch, cd)
    return tree_map(
        lambda t: (t.to(dt) if isinstance(t, torch.Tensor)
                   and t.dtype == torch.float32 else t), params,
        is_leaf=_is_qleaf)

class _Snapshot:
    """What one executable was built from: the model, its parameters cast
    to the compute dtype (qleafs whole), its state, the device, the
    generation and whether the params are weight-only int8 (every program
    then dequantizes them per call). An executable holds its snapshot, so
    the tensors a graph captured by address stay alive as long as the
    graph does."""

    __slots__ = ("model", "params", "state", "device", "gen", "dtype",
                 "param_dtype", "quantized")

    def __init__(self, model, params, state, device, gen, quantized=False):
        self.model, self.params, self.state = model, params, state
        self.device, self.gen = device, gen
        self.quantized = quantized
        cd = getattr(model, "compute_dtype", None)
        # the arguments' cast (a program may keep float32 arguments) and
        # the parameters' (always the model's compute dtype)
        self.dtype = self.param_dtype = getattr(torch, cd) if cd else None


def _predict_inner(model):
    """A predict bucket's program: the model's inference forward of one
    request (a tensor, or a list of them for a multi-input model)."""
    def inner(params, state, x):
        return model.apply(params, state, x, training=False, rng=None)[0]
    return inner


def _forward(snap: _Snapshot, inner, args):
    """``inner(params, state, *args)`` under ``inference_mode``: float32
    argument leaves cast to the compute dtype (the parameters already
    are; weight-only int8 qleafs are dequantized here, on every call, and
    cast after: ``bf16(f32(q) * scale)``), floating outputs made float32
    (integer outputs, such as argmax tokens, pass through)."""
    dt = snap.dtype
    if dt is not None:
        args = tree_map(
            lambda t: t.to(dt) if t.dtype == torch.float32 else t, args)
    with torch.inference_mode():
        params = snap.params
        if snap.quantized:
            params = _dequantize_params(params, snap.param_dtype)
        out = inner(params, snap.state, *args)
        return tree_map(
            lambda t: t.float() if t.is_floating_point() else t, out)


def _to_device_tree(args, device):
    """Argument pytree on ``device``: tensors as they are (moved if on
    another device), host arrays through :func:`host_to_device`."""
    def one(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        return host_to_device(a, device)
    return tree_map(one, args)


def _host_leaf(a) -> torch.Tensor:
    """A host array as the CPU tensor copied into its static input
    (float64 made float32, as :func:`host_to_device` does)."""
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float32 if a.dtype == np.float64 else a.dtype))


class _EagerProgram:
    """The CPU executable: the eager ``inner`` over the given arguments."""

    def __init__(self, snap: _Snapshot, inner):
        self.snap, self.inner = snap, inner
        self.gen = snap.gen
        self.capture_bytes = 0
        self.warmup_seconds = self.capture_seconds = 0.0

    def __call__(self, params, state, *args):
        return self.run(*args)

    def run(self, *args):
        """``inner`` on ``args`` (device tensors or host arrays)."""
        return _forward(self.snap, self.inner,
                        _to_device_tree(args, self.snap.device))

    eager = run


class _GraphProgram:
    """The card's executable: one ``torch.cuda.CUDAGraph`` of ``inner(
    params, state, *args)`` at one argument signature (a predict bucket's
    whole forward, or a sequence program).

    Capture (under :data:`_CAPTURE_LOCK`): static inputs shaped and typed
    as the example arguments reach the device (float64 made float32,
    integers kept), one eager call on the model's side stream (it builds
    the CUDA kernels, creates the cuBLAS handle and workspace of that
    stream and runs the flash kernel's ``cudaFuncSetAttribute``, none of
    which may happen inside a capture), then the capture itself into the
    model's shared memory pool. ``capture_bytes`` is what the pool grew by
    during the capture; ``warmup_seconds`` and ``capture_seconds`` split
    the build's wall time between the eager warm-up and the capture with
    its instantiation (what a persistent cache of graphs could save). The
    captured ``cudaGraph_t`` is kept beside its
    instantiation, so the graph the card replays can be inspected
    (``graph.raw_cuda_graph()``).

    Call, under the model's replay lock: copy every argument leaf into its
    static input (device to device for a tensor; host to device for an
    array, from pageable memory, so the copy has read the host buffer
    when it returns and a batcher may reuse its staging buffer at once),
    replay, and clone the static outputs on the card, so the next replay
    cannot overwrite an output that is still to be fetched and a
    program's outputs can be the next call's arguments (prefill -> admit
    -> step -> step). The caller's stream waits for the side stream. The
    lock is the model's, not the graph's: the graphs share one pool, so a
    block that one graph uses as scratch may hold another's static
    outputs, and a replay of one between another's replay and its clone
    would overwrite them; and work enqueued on the side stream while it
    captures would be captured too. The kernel wrappers' launch counters
    see the warm-up's launches and the capture's, never a replay's: a
    replay launches the captured kernels with no Python. The graph runs on
    its snapshot's parameters: ``params`` and ``state`` of a call are the
    ones :meth:`InferenceModel.compile_program` returned with it."""

    def __init__(self, snap: _Snapshot, inner, example_args, pool, stream,
                 lock):
        self.snap, self.gen, self.inner = snap, snap.gen, inner
        self.stream, self.lock = stream, lock
        dev = snap.device
        self.inputs = tree_map(torch.clone,
                               _to_device_tree(example_args, dev))
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        t0 = time.perf_counter()
        with torch.cuda.stream(stream):
            _forward(snap, inner, self.inputs)  # warm-up: real launches
        stream.synchronize()
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        before = torch.cuda.memory_reserved(dev)
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                out = _forward(snap, inner, self.inputs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid anyway; report the cause
                raise
            graph.capture_end()
            graph.instantiate()
        stream.synchronize()
        self.warmup_seconds = t1 - t0
        self.capture_seconds = time.perf_counter() - t1
        self.capture_bytes = torch.cuda.memory_reserved(dev) - before
        self.graph = graph
        self.outputs = out
        self._static = tree_leaves(self.inputs)

    def __call__(self, params, state, *args):
        return self.run(*args)

    def run(self, *args):
        leaves = tree_leaves(args)
        if len(leaves) != len(self._static):
            raise ValueError(f"program takes {len(self._static)} argument "
                             f"leaves, got {len(leaves)}")
        host = [None if isinstance(a, torch.Tensor) else _host_leaf(a)
                for a in leaves]
        cur = torch.cuda.current_stream(self.snap.device)
        with self.lock:
            self.stream.wait_stream(cur)  # device arguments are ready
            with torch.cuda.stream(self.stream):
                for dst, a, h in zip(self._static, leaves, host):
                    dst.copy_(a if h is None else h, non_blocking=True)
                self.graph.replay()
                out = tree_map(torch.clone, self.outputs)
            cur.wait_stream(self.stream)
        for t in tree_leaves(out):
            t.record_stream(cur)
        return out

    def eager(self, *args):
        """The eager program on ``args``, through no graph: the yardstick
        a replay is held to (bitwise, at the same signature); never a
        fallback of the serving path."""
        return _forward(self.snap, self.inner,
                        _to_device_tree(args, self.snap.device))


class _OnnxAdapter:
    """The KerasNet ``apply`` protocol over an ``onnx.OnnxModel``: the
    served parameters are its float initializers, joined at each call
    by its integer ones (host arrays). Outputs that the graph folded on
    the host come back as tensors."""

    compute_dtype = None  # an imported graph runs as it was exported

    def __init__(self, om, static):
        self.om, self.static = om, static
        # output-channel axis per initializer (see do_load_onnx)
        self.quantize_axes: Dict[str, int] = {}

    def apply(self, params, state, x, training=False, rng=None):
        from analytics_zoo_tpu_torch.onnx import _t

        xs = x if isinstance(x, (list, tuple)) else (x,)
        out = self.om.apply({**self.static, **params}, *xs)
        dev = next(t.device for t in tree_leaves(params) + list(xs)
                   if isinstance(t, torch.Tensor))
        consts = self.om._consts
        if isinstance(out, tuple):
            return tuple(_t(o, dev, consts) for o in out), state
        return _t(out, dev, consts), state


class InferenceModel:
    """load → (optional) warm → thread-safe predict, on the context's device
    (the CUDA card unless the context was made with ``device="cpu"``).

    ``concurrent_num`` is kept for API parity: every executable takes
    concurrent callers, so there is no model pool.

    ``executable_cache_size`` caps the number of executables (``None``:
    unbounded). On the card it bounds the number of CUDA graphs, not the
    card memory they hold: the graphs share one pool, and an eviction that
    leaves other graphs alive returns no memory to the device (see the
    module docstring). ``aot_cache_dir`` other than ``None`` raises
    ``NotImplementedError`` (:meth:`set_aot_cache`)."""

    def __init__(self, concurrent_num: int = 1,
                 executable_cache_size: Optional[int] = 32,
                 aot_cache_dir: Optional[str] = None):
        if aot_cache_dir is not None:
            self.set_aot_cache(aot_cache_dir)
        self.concurrent_num = concurrent_num
        self.model = None
        self.params = None
        self.model_state = None
        self.device = None
        self._exec_params = None  # params cast to the compute dtype
        self.executable_cache_size = executable_cache_size
        self._compiled: "collections.OrderedDict[Tuple, Any]" = \
            collections.OrderedDict()
        self.cache_stats: Dict[str, int] = {
            "hits": 0, "misses": 0, "evictions": 0}
        # bytes of card memory each captured signature's graph added
        self.capture_bytes: Dict[Tuple, int] = {}
        self._warmed: set = set()
        self.warmup_overflows = 0
        self._lock = threading.Lock()
        # weight-only int8 (every program dequantizes) and calibrated int8
        # (the layer wrappers run integer products; no dequantize pass)
        self._quantized = False
        self._calibrated = False
        # bumped on every load/quantize/calibrate/release; an executable
        # built for generation g is cached and replayed only while
        # _gen == g
        self._gen = 0
        # card only: the graphs' shared memory pool, the graphs alive in it,
        # the side stream they capture and replay on, and the lock that
        # keeps one graph's capture or replay from interleaving with
        # another's on it (see _GraphProgram)
        self._replay_lock = threading.Lock()
        self._pool = None
        self._pool_graphs: "weakref.WeakSet[_GraphProgram]" = \
            weakref.WeakSet()
        self._stream = None

    # -- int8 -------------------------------------------------------------

    def set_aot_cache(self, directory: Optional[str]) -> "InferenceModel":
        """The persistent AOT executable cache is not ported: a CUDA graph
        cannot be saved, so a restarted process captures its graphs again.
        Raises ``NotImplementedError``; ``None`` is a no-op."""
        if directory is not None:
            raise NotImplementedError(
                "the persistent AOT executable cache is not ported "
                "(ROADMAP A4): PyTorch cannot save a CUDA graph, so every "
                "process captures its buckets at register")
        return self

    def do_calibrate(self, batches) -> "InferenceModel":
        """Post-training static int8: a calibration pass over
        representative ``batches`` (host arrays, or lists of them for a
        multi-input model) records each Dense/Conv2D input's absmax on
        the uncast float32 params, then those layers run integer products
        with one float32 rescale
        (:mod:`~analytics_zoo_tpu_torch.inference.calibration`).
        Idempotent; raises after :meth:`do_quantize`. Drops every
        executable."""
        from analytics_zoo_tpu_torch.inference import calibration as calib

        if self.model is None:
            raise RuntimeError("load a model before do_calibrate")
        if not hasattr(self.model, "layers"):
            raise NotImplementedError(
                "do_calibrate needs a Keras-protocol model")
        with self._lock:
            if self._calibrated:
                return self  # idempotent
            if self._quantized:
                raise RuntimeError(
                    "do_calibrate after do_quantize: the weight-only scales "
                    "are already baked in — reload the model and call "
                    "do_calibrate directly for the integer activation path")
            scales = calib.calibrate_activations(
                self.model, self.params, self.model_state, batches)
            self.params = calib.apply_calibration(
                self.model, self.params, scales)
            self._exec_params = _cast_params(self.params, self.model)
            self._calibrated = True
            self._gen += 1
            self._compiled.clear()
            self._warmed.clear()
        return self

    def do_quantize(self) -> "InferenceModel":
        """Weight-only int8: every float parameter of rank 2 or more
        becomes a per-output-channel int8 qleaf, which stays int8 on the
        device (about a quarter of the float32 bytes); every program
        dequantizes it on each call (inside the bucket's CUDA graph on the
        card). Idempotent, a no-op without params or after
        :meth:`do_calibrate`; bumps the generation and drops every
        executable."""
        with self._lock:
            if self._quantized or self._calibrated:
                return self  # re-quantizing would corrupt the scales
            if not self.params:
                return self  # nothing to quantize: keep the executables
            self._gen += 1
            axes = getattr(self.model, "quantize_axes", None)
            if axes is not None:
                # per-parameter channel axes; the rest stays float
                self.params = {
                    k: (_quantize_leaf(v, axes[k]) if k in axes else v)
                    for k, v in self.params.items()}
            else:
                self.params = tree_map(_quantize_leaf, self.params)
            self._exec_params = _cast_params(self.params, self.model)
            self._quantized = True
            self._compiled.clear()
            self._warmed.clear()
        return self

    # -- loaders -----------------------------------------------------------

    def do_load(self, path: str) -> "InferenceModel":
        """Load a saved ZooModel directory (``ZooModel.save_model``)."""
        from analytics_zoo_tpu_torch.models.common import ZooModel

        return self.do_load_keras(ZooModel.load_model(path).model)

    def do_load_keras(self, keras_net) -> "InferenceModel":
        """Adopt an in-memory KerasNet: its ``params`` and ``model_state``
        (drawn from the context's generator if it has none; after ``fit``
        or ``Estimator.train``, the trained ones that the estimator wrote
        back) are copied to the device, and the params cast once to the
        model's compute dtype for the forward. The state stays as it is
        (batch norm's f32 moving statistics), as in the JAX package. Drops
        every executable of the previous model."""
        with torch.inference_mode(False):  # the net may train later
            keras_net.ensure_params()
        device = get_nncontext().device
        params, state = (tree_map(lambda t: t.to(device, copy=True), tree)
                         for tree in (keras_net.params,
                                      keras_net.model_state or {}))
        exec_params = _cast_params(params, keras_net)
        with self._lock:
            self._gen += 1
            self._compiled.clear()
            self._warmed.clear()
            self._quantized = False
            self._calibrated = False
            self.model = keras_net
            self.device = device
            self.params = params
            self._exec_params = exec_params
            self.model_state = state
        return self

    def do_load_onnx(self, path) -> "InferenceModel":
        """Serve an imported ONNX graph (ref doLoad* loader family; the
        reference's ONNX story is pyzoo/zoo/pipeline/api/onnx): a path to
        a ``.onnx`` file, or its bytes.

        The float initializers become the model's parameters on the
        context's device (real tensors: ``do_quantize`` makes them int8
        along ONNX's output-channel axis, 0 for OIHW convolution kernels
        and ``transB`` Gemm weights, -1 otherwise). The integer
        initializers drive shape chains (Reshape targets, Slice bounds,
        axes tensors) and stay host arrays, so no shape op reads the
        device and each bucket's forward is captured whole on the card.
        The matmuls and convolutions run in IEEE float32
        (``onnx.OnnxModel``'s ``precision="highest"``)."""
        from analytics_zoo_tpu_torch import onnx as zonnx

        om = (zonnx.load_model(path) if isinstance(path, str)
              else zonnx.load_model_bytes(path))
        device = get_nncontext().device
        static = {k: v for k, v in om.params.items()
                  if not np.issubdtype(np.asarray(v).dtype, np.floating)}
        params = {k: host_to_device(v, device)
                  for k, v in om.params.items() if k not in static}
        adapter = _OnnxAdapter(om, static)
        for node in om.graph.nodes:
            if node.op_type == "Conv" and len(node.inputs) > 1:
                adapter.quantize_axes[node.inputs[1]] = 0
            elif node.op_type == "Gemm" and len(node.inputs) > 1:
                adapter.quantize_axes[node.inputs[1]] = \
                    0 if node.attrs.get("transB", 0) else -1
            elif node.op_type == "MatMul" and len(node.inputs) > 1:
                adapter.quantize_axes[node.inputs[1]] = -1
        with self._lock:
            self._gen += 1
            self._compiled.clear()
            self._warmed.clear()
            self._quantized = False
            self._calibrated = False
            self.model = adapter
            self.device = device
            self.params = params
            self._exec_params = params
            self.model_state = {}
        return self

    load = do_load

    # -- the executable cache ------------------------------------------------

    @staticmethod
    def _shape_key(x) -> Tuple:
        if isinstance(x, (list, tuple)):
            return tuple((tuple(a.shape), str(a.dtype)) for a in x)
        return ((tuple(x.shape), str(x.dtype)),)

    def _snapshot(self) -> _Snapshot:
        # call under self._lock
        return _Snapshot(self.model, self._exec_params, self.model_state,
                         self.device, self._gen, self._quantized)

    def _eager(self, x):
        """The eager forward of ``x`` (host arrays) on the current model,
        through no executable; returns device tensors. The yardstick that
        a graph replay is held to (bitwise, at the same shape) and timed
        against on the card; never a fallback of the serving path."""
        with self._lock:
            if self.model is None:
                raise RuntimeError(
                    "No model loaded — call do_load / do_load_keras")
            snap = self._snapshot()
        return _EagerProgram(snap, _predict_inner(snap.model)).run(
            self._host(x))

    def _build(self, snap: _Snapshot, inner, example_args):
        """A new executable of ``inner`` (``None``: the model's predict
        forward) at ``example_args``' signature: the eager call on the
        CPU, a capture on the card."""
        inner = inner or _predict_inner(snap.model)
        if snap.device.type != "cuda":
            return _EagerProgram(snap, inner)
        with _CAPTURE_LOCK, self._replay_lock:
            if self._stream is None:
                self._stream = torch.cuda.Stream(snap.device)
            if not self._pool_graphs:
                # PyTorch retires a pool once no graph holds it (a reload
                # or an eviction dropped the last one); start a new one
                self._pool = torch.cuda.graph_pool_handle()
            t0 = time.perf_counter()
            exe = _GraphProgram(snap, inner, example_args, self._pool,
                                self._stream, self._replay_lock)
            self._pool_graphs.add(exe)
            _kernels.compiled(time.perf_counter() - t0)
        return exe

    def _get_executable(self, key, inner, example_args, label, cast=True):
        # Snapshot (model, params, state, gen) in ONE lock acquisition so a
        # build never sees a torn combination; build outside the lock so a
        # new shape does not stall concurrent predicts of built ones.
        with self._lock:
            if self.model is None:
                raise RuntimeError(
                    "No model loaded — call do_load / do_load_keras")
            fn = self._compiled.get(key)
            if fn is not None:
                self._compiled.move_to_end(key)  # LRU touch
                self.cache_stats["hits"] += 1
            else:
                self.cache_stats["misses"] += 1
            snap = None if fn is not None else self._snapshot()
        if snap is not None and not cast:
            snap.dtype = None  # the arguments keep their float32
        inference_cache_counters()["hits" if fn is not None
                                   else "misses"].inc()
        tracer = get_tracer()
        if tracer.enabled:
            cur = tracer.current()
            if cur is not None:  # annotate the enclosing predict span
                cur.attrs["cache"] = "hit" if fn is not None else "miss"
        if fn is not None:
            return fn
        with tracer.span("inference.compile", cache="miss", key=label):
            compiled = self._build(snap, inner, example_args)
        self._insert(key, compiled, snap.gen)
        return compiled

    def _insert(self, key, compiled, gen: int) -> None:
        """Cache a new executable or program under the LRU cap. Two threads
        may race-build one key; last insert wins, both are valid. An insert
        is skipped when a load or release bumped _gen meanwhile: caching it
        would serve a stale executable."""
        evicted = 0
        with self._lock:
            if self._gen == gen:
                self._compiled[key] = compiled
                self._compiled.move_to_end(key)
                self.capture_bytes[key] = compiled.capture_bytes
                cap = self.executable_cache_size
                while cap is not None and len(self._compiled) > max(1, cap):
                    old, _ = self._compiled.popitem(last=False)
                    self.capture_bytes.pop(old, None)
                    self.cache_stats["evictions"] += 1
                    evicted += 1
        if evicted:
            inference_cache_counters()["evictions"].inc(evicted)

    def _run(self, x):
        """Run ``x`` (host arrays) through its signature's executable;
        returns device tensors. An executable of an older generation is
        never replayed: a load or release that raced the lookup sends the
        call back for the current model's executable."""
        key = self._shape_key(x)
        while True:
            fn = self._get_executable(key, None, (x,), str(key))
            if fn.gen == self._gen:
                return fn.run(x)

    def do_optimize(self, example_input) -> "InferenceModel":
        """Warm one bucket shape: build its executable (on the card,
        capture its CUDA graph) and record it in ``_warmed``.

        Warm-up overflow: warming more distinct shapes than
        ``executable_cache_size`` means the LRU is evicting just-warmed
        executables and serve-time captures return — logged and counted
        (``zoo_inference_cache_events_total{event="warmup_overflow"}``,
        plus the instance's ``warmup_overflows``)."""
        x = ([np.asarray(a) for a in example_input]
             if isinstance(example_input, (list, tuple))
             else np.asarray(example_input))
        key = self._shape_key(x)
        self._get_executable(key, None, (x,), str(key))
        self._note_warmed(key)
        return self

    def _note_warmed(self, key) -> None:
        """Record a warmed key; count and log a warm-up that outgrows the
        executable cache."""
        cap = self.executable_cache_size
        with self._lock:
            self._warmed.add(key)
            overflow = (cap is not None and len(self._warmed) > max(1, cap))
            if overflow:
                self.warmup_overflows += 1
        if overflow:
            inference_cache_counters()["warmup_overflow"].inc()
            logger.warning(
                "do_optimize warmed %d distinct shapes but "
                "executable_cache_size=%d — the LRU is evicting just-"
                "warmed executables and requests will capture again at "
                "serve time; raise executable_cache_size or shrink the "
                "bucket ladder (or the sequence grid)", len(self._warmed),
                cap)

    # -- programs ------------------------------------------------------------

    @staticmethod
    def _args_key(args) -> Tuple:
        """Shape/dtype/structure key of an argument pytree — the program
        analogue of :meth:`_shape_key`."""
        leaves = tree_leaves(args)
        struct = str(tree_map(lambda _: "*", args))
        return (struct,) + tuple(
            (tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in leaves)

    def compile_program(self, tag: str, inner, example_args,
                        warm: bool = False, cast: bool = True):
        """Build (or fetch) the executable of ``inner(params, model_state,
        *args)`` for ``example_args``' signature (shapes, dtypes and
        structure; values do not matter): the sequence tier's prefill,
        admission and decode-step programs.

        The key is ``("__prog__", tag, args key)`` in the same LRU as the
        buckets; ``cache_stats`` counts program hits and misses, a load or
        release bumps ``_gen`` and retires them, and ``warm=True`` records
        the key in the warm-up overflow accounting (:meth:`do_optimize`).
        On the card the program is a CUDA graph (:class:`_GraphProgram`);
        a capture that fails raises, nothing is cached, and there is no
        eager fallback. Float32 argument leaves are cast to the compute
        dtype (``cast=False``: they stay float32, as a detector's
        post-process over its forward's float32 output needs; ``tag``
        names one program, so one tag keeps one ``cast``) and floating
        outputs come back float32.

        Returns ``(program, params, model_state)``; call
        ``program(params, model_state, *args)``."""
        key = ("__prog__", tag, self._args_key(example_args))
        fn = self._get_executable(key, inner, example_args,
                                  f"{tag}:{key[2][1:]}", cast)
        if warm:
            self._note_warmed(key)
        return fn, fn.snap.params, fn.snap.state

    # -- predict -------------------------------------------------------------

    @staticmethod
    def _host(x):
        if isinstance(x, (list, tuple)):
            return [np.asarray(a) for a in x]
        return np.asarray(x)

    def do_predict(self, x):
        """Thread-safe predict: host arrays in, host float32 arrays out.
        With the global tracer enabled, records an ``inference.predict``
        span whose ``cache`` attr says whether the shape hit a built
        executable (an ``inference.compile`` child span appears on a
        miss)."""
        x = self._host(x)
        with get_tracer().span("inference.predict"):
            out = self._run(x)
        return self.do_fetch(out)

    def do_dispatch(self, x):
        """The serving fast path's asynchronous half: enqueue the forward
        (on the card, the graph replay and the copy-out of its outputs)
        and return the device outputs without waiting for them; pair with
        :meth:`do_fetch`. Same executables (and bitwise the same results)
        as :meth:`do_predict`."""
        return self._run(self._host(x))

    def do_fetch(self, out):
        """Materialize a :meth:`do_dispatch` output as host numpy arrays
        (waits for the device)."""
        return tree_map(lambda t: t.cpu().numpy(), out)

    predict = do_predict

    def release(self) -> None:
        """Drop the executables, the model and its parameters."""
        with self._lock:
            self._gen += 1
            self._compiled.clear()
            self._warmed.clear()
            self._quantized = False
            self._calibrated = False
            self.model = None
            self.params = None
            self._exec_params = None
            self.model_state = None
