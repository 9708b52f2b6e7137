"""Model containers and the compile/fit surface (port of
``analytics_zoo_tpu.keras.engine.topology``).

``KerasNet``: the protocol the engines use (``layers``, ``init``,
``apply``, ``regularization``, ``compute_dtype``) and the Keras-style
training surface over
:class:`~analytics_zoo_tpu_torch.engine.estimator.Estimator`: ``compile``,
``fit`` (epochs continue across calls), ``evaluate``, ``predict``,
``predict_classes``, the gradient-clipping, checkpoint and TensorBoard
setters, gradient accumulation (``compile(gradient_accumulation=K)``),
weights in and out (``get_weights``/``set_weights``/``set_states``,
``save_weights``/``load_weights``), ``resume_from_checkpoint`` and
``summary``. ``Sequential`` (a linear stack) and ``Model`` (a functional
graph of ``Input`` and layer calls) thread the state of stateful layers
through ``apply``. ``set_profile`` traces a window of the next ``fit``
(``Estimator.set_profile``). ``Model`` carries the GraphNet surface
(``node``, ``nodes``, ``freeze``, ``unfreeze``, ``freeze_up_to``,
``new_graph``): the transfer-learning idioms over the functional graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from analytics_zoo_tpu_torch.autograd.variable import (
    Variable,
    execute,
    graph_layers,
    topological_nodes,
)
from analytics_zoo_tpu_torch.common.nncontext import host_to_device
from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.data.feature_set import (
    ArrayFeatureSet,
    FeatureSet,
)
from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
from analytics_zoo_tpu_torch.keras import metrics as metrics_lib
from analytics_zoo_tpu_torch.keras import objectives as objectives_lib
from analytics_zoo_tpu_torch.keras import optimizers as optimizers_lib
from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Shape,
    materialize,
    unique_name,
)


class InputLayer(KerasLayer):
    """Explicit input placeholder."""

    def __init__(self, input_shape=None, name=None):
        super().__init__(input_shape, name or unique_name("input"))

    def call(self, params, x, **kw):
        return x


def Input(shape: Sequence[Optional[int]],
          name: Optional[str] = None) -> Variable:
    """Symbolic graph input; ``shape`` excludes the batch dim (Keras-1)."""
    return Variable(None, (None,) + tuple(shape),
                    name=name or unique_name("input"))


class KerasNet(nn.Module):
    """The model protocol the Estimator trains and InferenceModel serves,
    with the compile/fit surface.

    ``params`` holds the model's parameter dict once it has one, and
    ``model_state`` the state of its stateful layers: drawn by
    :meth:`ensure_params` from the context's generator, carried over from
    the JAX package by ``interop.load_jax_params``, or written back by
    ``Estimator.train``.
    """

    def __init__(self, name: Optional[str] = None):
        super().__init__()
        self.name = name or unique_name(type(self).__name__.lower())
        # "bfloat16": InferenceModel casts float32 params and inputs to it
        # for the forward, and returns float outputs as float32.
        self.compute_dtype: Optional[str] = None
        self.params: Optional[Dict] = None
        self.model_state: Optional[Dict] = None
        self.optim_method = None
        self.criterion = None
        self.validation_metrics: List = []
        self._estimator = None
        self._clipping: Optional[Tuple[str, Tuple]] = None
        self._tensorboard: Optional[Tuple[str, str]] = None
        self._profile: Optional[Tuple[str, int, int]] = None
        self._checkpoint: Optional[Tuple[str, bool]] = None
        self._gradient_accumulation = 1

    def layers(self) -> List[KerasLayer]:
        """The layer objects, flattened in graph order."""
        raise NotImplementedError

    def param_specs(self) -> Dict:
        """``{layer name: layer.param_specs()}`` for layers with params."""
        out = {}
        for layer in self.layers():
            specs = layer.param_specs()
            if specs:
                out[layer.name] = specs
        return out

    def state_specs(self) -> Dict:
        """``{layer name: {state name: WeightSpec}}`` for stateful
        layers."""
        return {layer.name: {s.name: s for s in layer.state_specs}
                for layer in self.layers() if layer.has_state}

    def init(self, generator: torch.Generator) -> Tuple[Dict, Dict]:
        """Initialize ``(params, state)``: the parameters drawn from a
        generator, each stateful layer's ``init_state()``."""
        state = {layer.name: layer.init_state() for layer in self.layers()
                 if layer.has_state}
        return materialize(self.param_specs(), generator), state

    def ensure_params(self) -> None:
        """Draw ``params`` from the context's root generator if the model
        has none yet."""
        if self.params is None:
            from analytics_zoo_tpu_torch.common.nncontext import get_nncontext

            self.params, self.model_state = self.init(
                get_nncontext().generator)

    def apply(self, params, state, x, training=False, rng=None):
        """Forward: ``(params, state, x) -> (pred, new_state)``."""
        raise NotImplementedError

    def regularization(self, params):
        """Total weight-penalty term added to the training loss: each
        layer's ``regularization_loss`` of its parameters (0.0 when no
        layer declares a regularizer)."""
        reg = 0.0
        for layer in self.layers():
            reg = reg + layer.regularization_loss(params.get(layer.name, {}))
        return reg

    def get_output_shape(self) -> Shape:
        """Batch-free output shape."""
        raise NotImplementedError

    def get_input_shape(self):
        """Batch-free input shape."""
        raise NotImplementedError

    # -- configuration ---------------------------------------------------

    def set_tensorboard(self, log_dir: str, app_name: str):
        """Attach train/validation TensorBoard summaries (ref
        setTensorBoard)."""
        self._tensorboard = (log_dir, app_name)
        if self._estimator is not None:
            self._estimator.set_tensorboard(log_dir, app_name)
        return self

    def set_profile(self, log_dir: str, start_iteration: int = 2,
                    num_iterations: int = 3):
        """Trace ``num_iterations`` steps of the next ``fit`` from its step
        ``start_iteration`` with ``torch.profiler`` into ``log_dir``
        (``Estimator.set_profile``)."""
        self._profile = (log_dir, start_iteration, num_iterations)
        if self._estimator is not None:
            self._estimator.set_profile(*self._profile)
        return self

    def get_train_summary(self, tag: str):
        """A (step, value) series of the training summary, e.g.
        ``get_train_summary("Loss")`` (ref getTrainSummary)."""
        est = self._estimator
        if est is not None and est.train_summary is not None:
            return est.train_summary.read_scalar(tag)
        return []

    def get_validation_summary(self, tag: str):
        """A validation metric series (ref getValidationSummary)."""
        est = self._estimator
        if est is not None and est.val_summary is not None:
            return est.val_summary.read_scalar(tag)
        return []

    def set_checkpoint(self, path: str, over_write: bool = True):
        """Write ``ckpt_N`` checkpoints to ``path`` every epoch (ref
        setCheckpoint)."""
        self._checkpoint = (path, over_write)
        if self._estimator is not None:
            self._estimator.set_checkpoint(path, over_write)
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        """Clip every gradient to [min, max] (ref
        setConstantGradientClipping)."""
        self._clipping = ("constant", (min_value, max_value))
        if self._estimator is not None:
            self._estimator.set_constant_gradient_clipping(min_value,
                                                           max_value)
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float):
        """Global-norm gradient clipping (ref setGradientClippingByL2Norm)."""
        self._clipping = ("l2norm", (clip_norm,))
        if self._estimator is not None:
            self._estimator.set_l2_norm_gradient_clipping(clip_norm)
        return self

    # -- compile/fit/evaluate/predict ------------------------------------

    def compile(self, optimizer, loss, metrics: Optional[Sequence] = None,
                gradient_accumulation: int = 1):
        """Ref Topology.scala:128. Recompiling keeps the parameters and
        rebuilds only the optimizer state. ``gradient_accumulation=K``
        applies the optimizer every Kth micro-batch on the valid-sample
        weighted mean of the K gradients (effective batch K x
        batch_size), the epoch's wrap-padded tail included."""
        self.optim_method = optimizers_lib.get(optimizer)
        self.criterion = objectives_lib.get(loss)
        self.validation_metrics = list(metrics or [])
        self._gradient_accumulation = int(gradient_accumulation)
        if self._estimator is not None:
            self._estimator.gradient_accumulation = (
                self._gradient_accumulation)
            self._estimator.reset_optimizer(self.optim_method)
        return self

    def _get_estimator(self):
        if self._estimator is None:
            from analytics_zoo_tpu_torch.engine.estimator import Estimator

            # optim_method may be None: a model predicts without compile;
            # training raises a friendly error via Estimator._tx
            est = Estimator(self, self.optim_method,
                            gradient_accumulation=self._gradient_accumulation)
            if self._tensorboard:
                est.set_tensorboard(*self._tensorboard)
            if self._profile:
                est.set_profile(*self._profile)
            if self._checkpoint:
                est.set_checkpoint(*self._checkpoint)
            if self._clipping:
                kind, args = self._clipping
                if kind == "constant":
                    est.set_constant_gradient_clipping(*args)
                else:
                    est.set_l2_norm_gradient_clipping(*args)
            self._estimator = est
        return self._estimator

    @staticmethod
    def _to_feature_set(x, y=None) -> FeatureSet:
        if isinstance(x, FeatureSet):
            return x
        return ArrayFeatureSet(x, y)

    def _metric_objs(self) -> List:
        objs = [metrics_lib.get(m) for m in self.validation_metrics]
        if self.criterion is not None:
            objs = [metrics_lib.Loss(self.criterion)] + objs
        return objs

    def fit(self, x, y=None, batch_size: int = 32, nb_epoch: int = 10,
            validation_data=None, distributed: bool = True,
            validation_batch_size: Optional[int] = None):
        """Ref Topology.scala:336/411 — epochs continue across calls."""
        if self.criterion is None:
            raise RuntimeError("Call compile(optimizer, loss) before fit")
        train_set = self._to_feature_set(x, y)
        est = self._get_estimator()
        val_set = None
        if validation_data is not None:
            val_set = (validation_data
                       if isinstance(validation_data, FeatureSet)
                       else ArrayFeatureSet(validation_data[0],
                                            validation_data[1]))
        est.train(train_set, self.criterion,
                  end_trigger=MaxEpoch(est.run_state.epoch + nb_epoch),
                  validation_set=val_set,
                  validation_method=(self._metric_objs()
                                     if val_set is not None else None),
                  batch_size=batch_size,
                  validation_batch_size=validation_batch_size)
        return self

    def evaluate(self, x, y=None, batch_size: int = 32) -> Dict[str, float]:
        """Ref Topology.scala:489."""
        metric_objs = self._metric_objs()
        if not metric_objs:
            raise RuntimeError("Nothing to evaluate: call compile(optimizer, "
                               "loss[, metrics]) first")
        return self._get_estimator().evaluate(
            self._to_feature_set(x, y), metric_objs, batch_size)

    def predict(self, x, batch_size: int = 32,
                distributed: bool = True) -> np.ndarray:
        """Batched inference -> host ndarray; partial tail batches are
        wrap-padded and trimmed (output length == input length)."""
        return self._get_estimator().predict(self._to_feature_set(x),
                                             batch_size)

    def predict_classes(self, x, batch_size: int = 32,
                        zero_based_label: bool = True) -> np.ndarray:
        """Ref KerasNet.predictClasses — argmax over the class axis."""
        cls = np.argmax(self.predict(x, batch_size), axis=-1)
        return cls if zero_based_label else cls + 1

    # -- weights and persistence -----------------------------------------

    def _estimator_state(self):
        est = self._get_estimator()
        est._ensure_state()
        return est

    def get_weights(self) -> Dict:
        """Host copies of every parameter, in layer order (ref
        getWeights)."""
        return tree_map(lambda t: t.detach().to("cpu", copy=True).numpy(),
                        self._estimator_state().tstate.params)

    def _install(self, params=None, model_state=None) -> None:
        """Copies of host arrays or tensors as the estimator's params or
        state (float64 made float32), handed back to the model."""
        est = self._estimator_state()
        dev = est.ctx.device

        def to_dev(v):
            if isinstance(v, torch.Tensor):
                return v.detach().to(dev, copy=True)
            return host_to_device(v, dev)

        with torch.inference_mode(False):  # the weights may train later
            if params is not None:
                est.tstate = est.tstate._replace(
                    params=tree_map(to_dev, params))
            if model_state is not None:
                est.tstate = est.tstate._replace(
                    model_state=tree_map(to_dev, model_state))
        est._write_back()

    def set_weights(self, params: Dict):
        """Install weights, merged per layer and per weight: what
        ``params`` leaves out keeps its current value (a backbone's weights
        poured into a model with a fresh head)."""
        known = {l.name for l in self.layers()}
        unknown = set(params) - known
        if unknown:
            raise KeyError(f"set_weights: no such layer(s) {sorted(unknown)}."
                           f" Layers: {sorted(known)}")

        def merge(cur, new):
            if isinstance(cur, dict) and isinstance(new, dict):
                out = dict(cur)
                for k, v in new.items():
                    out[k] = merge(cur[k], v) if k in cur else v
                return out
            return new

        self._install(params=merge(
            dict(self._estimator_state().tstate.params), params))

    def set_states(self, states: Dict):
        """Install non-trainable layer state (batch norm's moving
        statistics), merged per layer like :meth:`set_weights`."""
        cur = dict(self._estimator_state().tstate.model_state)
        for lname, st in states.items():
            if lname not in cur:
                raise KeyError(f"set_states: no state for layer '{lname}'. "
                               f"Stateful layers: {sorted(cur)}")
            unknown = set(st) - set(cur[lname])
            if unknown:
                raise KeyError(f"set_states: layer '{lname}' has no state "
                               f"{sorted(unknown)} (has {sorted(cur[lname])})")
            cur[lname] = {**cur[lname], **st}
        self._install(model_state=cur)

    def save_weights(self, path: str, overwrite: bool = True):
        """Write the parameters and the layer state as one checkpoint
        directory (keys ``0/<layer>/<weight>`` and ``1/<layer>/<stat>``,
        as the JAX package writes them)."""
        from analytics_zoo_tpu_torch.engine import checkpoint as ckpt_lib

        est = self._estimator_state()
        ckpt_lib.save_checkpoint(
            path, (est.tstate.params, est.tstate.model_state),
            overwrite=overwrite)

    def load_weights(self, path: str):
        """Load weights that ``save_weights`` wrote, in this package or in
        the JAX package: leaves match by name, and counter names
        (``dense_3``) by their order (``interop.load_jax_params``'s
        rules)."""
        from analytics_zoo_tpu_torch import interop
        from analytics_zoo_tpu_torch.engine import checkpoint as ckpt_lib

        flat, _ = ckpt_lib.load_flat(path)
        params, state = interop.fill_from_flat(self, flat, "0", "1")
        self._install(params=params, model_state=state)
        return self

    def resume_from_checkpoint(self, directory: Optional[str] = None) -> bool:
        """Restore the newest ``set_checkpoint`` checkpoint (model,
        optimizer and counters); False when there is none. The next
        ``fit`` continues where training stopped."""
        return self._get_estimator().resume_from_checkpoint(directory)

    def summary(self) -> str:
        """Layer table (ref KerasNet.summary)."""
        lines = [f"Model: {self.name}", "-" * 64,
                 f"{'Layer (type)':<34}{'Output Shape':<20}{'Params':<10}",
                 "=" * 64]
        total = 0
        for layer in self.layers():
            n = sum(int(np.prod(s.shape)) for s in layer.weight_specs)
            total += n
            lines.append(
                f"{layer.name + ' (' + type(layer).__name__ + ')':<34}"
                f"{str(layer.output_shape):<20}{n:<10}")
        lines.append("=" * 64)
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print(out)
        return out


class Sequential(KerasNet):
    """Linear stack of layers; the first carries ``input_shape``."""

    def __init__(self, layers: Optional[List[KerasLayer]] = None,
                 name: Optional[str] = None):
        # Keras-1 also allows Sequential("name")
        if isinstance(layers, str) and name is None:
            layers, name = None, layers
        if name is not None and not isinstance(name, str):
            raise TypeError(f"name must be a str, got {type(name).__name__}")
        super().__init__(name)
        self._layers = nn.ModuleList()
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: KerasLayer) -> "Sequential":
        """Append a layer, building it on the previous layer's output
        shape; returns self."""
        if not self._layers:
            in_shape = layer.user_input_shape()
            if in_shape is None and not isinstance(layer, InputLayer):
                raise ValueError(
                    "First layer needs input_shape (Keras-1 semantics)")
            layer.ensure_built(in_shape if in_shape is not None
                               else layer.input_shape)
        else:
            layer.ensure_built(self._layers[-1].output_shape)
        self._layers.append(layer)
        return self

    def layers(self) -> List[KerasLayer]:
        return list(self._layers)

    def get_output_shape(self) -> Shape:
        return self._layers[-1].output_shape

    def get_input_shape(self) -> Shape:
        return self._layers[0].input_shape

    def apply(self, params, state, x, training=False, rng=None):
        new_state = {}
        for layer in self._layers:
            p = params.get(layer.name, {})
            if layer.has_state:
                x, new_state[layer.name] = layer.call(
                    p, x, state=state.get(layer.name, {}), training=training,
                    rng=rng)
            else:
                x = layer.call(p, x, training=training, rng=rng)
        return x, new_state


class Model(KerasNet):
    """Functional graph model, built from ``Input`` Variables wired by
    layer calls."""

    def __init__(self, input: Union[Variable, Sequence[Variable]],
                 output: Union[Variable, Sequence[Variable]],
                 name: Optional[str] = None):
        super().__init__(name)
        self._multi_in = not isinstance(input, Variable)
        self._multi_out = not isinstance(output, Variable)
        self.inputs: List[Variable] = ([input] if not self._multi_in
                                       else list(input))
        self.outputs: List[Variable] = ([output] if not self._multi_out
                                        else list(output))
        self._layers = nn.ModuleList(graph_layers(self.outputs))

    def layers(self) -> List[KerasLayer]:
        return list(self._layers)

    def get_output_shape(self):
        shapes = [v.shape for v in self.outputs]
        return shapes if self._multi_out else shapes[0]

    def get_input_shape(self):
        shapes = [v.shape for v in self.inputs]
        return shapes if self._multi_in else shapes[0]

    def apply(self, params, state, x, training=False, rng=None):
        xs = x if isinstance(x, (list, tuple)) else [x]
        if len(xs) != len(self.inputs):
            raise ValueError(f"Model has {len(self.inputs)} inputs, got "
                             f"{len(xs)}")
        feed = {var.name: val for var, val in zip(self.inputs, xs)}
        outs, new_state = execute(self.outputs, feed, params, state=state,
                                  training=training, rng=rng)
        return (outs if self._multi_out else outs[0]), new_state

    # -- the GraphNet surface (ref NetUtils.scala:221-280, GraphNet:47) ----
    # Transfer learning on the functional graph: look nodes up by layer
    # name, freeze or unfreeze layers, cut a new graph at interior outputs.

    def _output_var_by_layer(self) -> Dict[str, Variable]:
        """Layer name -> the Variable its node produces."""
        by_node: Dict[int, Variable] = {}

        def note(var: Variable):
            if var.node is not None:
                by_node.setdefault(id(var.node), var)

        for v in self.outputs:
            note(v)
        nodes = topological_nodes(self.outputs)
        for node in nodes:
            for v in node.inbound:
                note(v)
        return {node.layer.name: by_node[id(node)] for node in nodes
                if id(node) in by_node}

    def node(self, name: str) -> Variable:
        """The output Variable of the layer called ``name`` (ref
        NetUtils.node)."""
        table = self._output_var_by_layer()
        if name not in table:
            raise KeyError(
                f"No layer named '{name}'. Layers: {sorted(table)}")
        return table[name]

    def nodes(self, names: Sequence[str]) -> List[Variable]:
        """The output Variables of the named layers (ref Model.nodes)."""
        table = self._output_var_by_layer()
        missing = [n for n in names if n not in table]
        if missing:
            raise KeyError(
                f"No layer(s) named {missing}. Layers: {sorted(table)}")
        return [table[n] for n in names]

    def _set_trainable(self, names: Optional[Sequence[str]], value: bool):
        if names is None:
            for layer in self._layers:
                layer.trainable = value
            return
        by_name = {l.name: l for l in self._layers}
        missing = [n for n in names if n not in by_name]
        if missing:
            raise KeyError(
                f"No layer(s) named {missing}. Layers: {sorted(by_name)}")
        for n in names:
            by_name[n].trainable = value

    def freeze(self, names: Optional[Sequence[str]] = None) -> "Model":
        """Mark layers (all, or by name) non-trainable: the train step
        zeroes their gradients and updates (ref GraphNet.freeze). Takes
        effect at the next ``fit``/``train``: every ``Estimator.train``
        call builds its step, and with it the update mask, from the
        layers' current ``trainable`` flags."""
        self._set_trainable(names, False)
        return self

    def unfreeze(self, names: Optional[Sequence[str]] = None) -> "Model":
        """Train again the layers (all, or by name) that :meth:`freeze`
        froze (ref unFreeze)."""
        self._set_trainable(names, True)
        return self

    def freeze_up_to(self, *names: str) -> "Model":
        """Freeze every layer from the inputs up to and including the named
        layers: the fine-tuning idiom (ref NetUtils.freezeUpTo:241)."""
        for node in topological_nodes(self.nodes(list(names))):
            node.layer.trainable = False
        return self

    def new_graph(self, outputs: Union[str, Sequence[str]]) -> "Model":
        """A new Model over the same layer objects with interior node(s) as
        its outputs (ref NetUtils.newGraph:250). The layers it keeps keep
        their parameters and state when this model has them, so its
        ``predict`` is this model's interior activation."""
        names = [outputs] if isinstance(outputs, str) else list(outputs)
        inp = self.inputs if self._multi_in else self.inputs[0]
        outs = self.nodes(names)
        sub = Model(inp, outs if len(names) > 1 else outs[0],
                    name=f"{self.name}_sub")
        if self.params is not None:
            keep = {l.name for l in sub.layers()}
            sub.params = {k: v for k, v in self.params.items() if k in keep}
            sub.model_state = {k: v for k, v in
                               (self.model_state or {}).items() if k in keep}
        return sub
