"""Symbolic graph: ``Variable``/``Node`` wiring behind ``Model`` (port of
``analytics_zoo_tpu.autograd.variable``).

A ``Variable`` is the output of a ``Node``; a ``Node`` is a layer applied to
inbound ``Variable``s. Calling a layer on a ``Variable`` builds its shapes at
once and returns the output ``Variable``. ``execute`` walks the graph in
topological order and calls each layer's ``call``, threading the state of
stateful layers. PyTorch runs eagerly, so the walk runs on every forward.

The JAX package folds the step key per node (``jax.random.fold_in``); here
every node that draws (``Dropout``) draws from the one generator passed as
``rng``, the context's step generator, in graph order.

``Parameter`` is a trainable graph source: a ``ParameterLayer`` node with
no inbound Variable whose output is its ``value`` weight (no batch dim).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from analytics_zoo_tpu_torch.keras.engine.base import (
    KerasLayer,
    Lambda,
    Shape,
    unique_name,
)


class Node:
    """One application of a layer to its inbound Variables."""
    __slots__ = ("layer", "inbound")

    def __init__(self, layer: KerasLayer, inbound: List["Variable"]):
        self.layer = layer
        self.inbound = inbound


class Variable:
    """A symbolic tensor: a shape-carrying handle to a node of the layer
    graph (``node`` None for a graph input). The arithmetic operators wire
    parameter-free :class:`Lambda` layers into the graph."""

    def __init__(self, node: Optional[Node], shape: Shape,
                 name: Optional[str] = None):
        self.node = node
        self.shape = tuple(shape)
        self.name = name or unique_name("variable")

    # -- arithmetic ------------------------------------------------------

    def _binop(self, other, fn, opname):
        if isinstance(other, Variable):
            lam = Lambda(fn, name=unique_name(opname), arity=2)
            return apply_layer(lam, [self, other])
        lam = Lambda(lambda x: fn(x, other), name=unique_name(opname))
        return apply_layer(lam, self)

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "sub")

    def __rsub__(self, other):
        return self._binop(other, lambda a, b: b - a, "rsub")

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b, "div")

    def __rtruediv__(self, other):
        return self._binop(other, lambda a, b: b / a, "rdiv")

    def __pow__(self, p):
        return self._binop(p, lambda a, b: a ** b, "pow")

    def __neg__(self):
        return apply_layer(Lambda(lambda x: -x, name=unique_name("neg")),
                           self)

    # -- shape ops -------------------------------------------------------

    def slice(self, dim: int, start_index: int, length: int) -> "Variable":
        """Narrow along ``dim`` (batch dim is 0)."""
        return apply_layer(Lambda(
            lambda x: x.narrow(dim, start_index, length),
            name=unique_name("slice")), self)

    def index_select(self, dim: int, index: int) -> "Variable":
        """Select one slice, dropping ``dim``."""
        return apply_layer(Lambda(lambda x: x.select(dim, index),
                                  name=unique_name("index_select")), self)

    def squeeze(self, dim: int) -> "Variable":
        """Drop a size-1 axis."""
        return apply_layer(Lambda(lambda x: x.squeeze(dim),
                                  name=unique_name("squeeze")), self)

    def expand_dims(self, axis: int) -> "Variable":
        """Insert a size-1 axis."""
        return apply_layer(Lambda(lambda x: x.unsqueeze(axis),
                                  name=unique_name("expand_dims")), self)

    def replicate(self, axis: int, mult: int) -> "Variable":
        """Repeat each element ``mult`` times along an axis."""
        return apply_layer(Lambda(
            lambda x: torch.repeat_interleave(x, mult, dim=axis),
            name=unique_name("replicate")), self)

    # -- misc ------------------------------------------------------------

    def get_output_shape(self) -> Shape:
        """Batch-free shape of this node's output."""
        return self.shape

    def get_input_shape(self) -> Shape:
        """Batch-free shape flowing into this node."""
        if self.node is None or not self.node.inbound:
            return self.shape
        ins = [v.shape for v in self.node.inbound]
        return ins[0] if len(ins) == 1 else ins  # type: ignore

    def __repr__(self):
        return f"<Variable {self.name} shape={self.shape}>"


class ParameterLayer(KerasLayer):
    """Graph source holding one standalone tensor, the leaf ``value``."""

    def __init__(self, shape, init="glorot_uniform", trainable=True,
                 name=None):
        super().__init__(name=name or unique_name("parameter"))
        self._shape = tuple(shape)
        self._init = init
        self.trainable = trainable

    def build(self, input_shape):
        self.add_weight("value", self._shape, self._init,
                        trainable=self.trainable)

    def compute_output_shape(self, input_shape):
        return self._shape

    def call(self, params, x, **kwargs):
        return params["value"]


def Parameter(shape, init="glorot_uniform", trainable=True,
              name=None) -> Variable:
    """A standalone (trainable) tensor as a graph Variable; its shape has
    no batch dim."""
    layer = ParameterLayer(shape, init=init, trainable=trainable, name=name)
    layer.ensure_built(tuple(shape))
    return Variable(Node(layer, []), layer.output_shape, name=layer.name)


def apply_layer(layer: KerasLayer,
                variables: Union[Variable, Sequence[Variable]]) -> Variable:
    """Wire ``layer`` onto symbolic input(s), building shapes at once."""
    if isinstance(variables, Variable):
        inbound = [variables]
        in_shape: Any = variables.shape
    else:
        inbound = list(variables)
        in_shape = [v.shape for v in inbound]
    layer.ensure_built(in_shape)
    return Variable(Node(layer, inbound), layer.output_shape,
                    name=f"{layer.name}_out")


# ---------------------------------------------------------------------------
# Graph walking
# ---------------------------------------------------------------------------


def topological_nodes(outputs: Sequence[Variable]) -> List[Node]:
    """Deterministic topological order of the nodes reachable from
    ``outputs``."""
    order: List[Node] = []
    seen = set()

    def visit(var: Variable):
        node = var.node
        if node is None or id(node) in seen:
            return
        seen.add(id(node))
        for parent in node.inbound:
            visit(parent)
        order.append(node)

    for v in outputs:
        visit(v)
    return order


def graph_layers(outputs: Sequence[Variable]) -> List[KerasLayer]:
    """Unique layers in topological order (a layer shared by several
    nodes appears once)."""
    layers, seen = [], set()
    for node in topological_nodes(outputs):
        if id(node.layer) not in seen:
            seen.add(id(node.layer))
            layers.append(node.layer)
    return layers


def execute(outputs: Sequence[Variable], input_values: Dict[str, Any],
            params: Dict, state: Optional[Dict] = None,
            training: bool = False, rng: Optional[torch.Generator] = None
            ) -> Tuple[List[Any], Dict]:
    """Evaluate the graph; ``input_values`` maps an input Variable's name
    to its tensor. Returns (output tensors, updated state)."""
    state = state or {}
    new_state: Dict = {}
    values: Dict[int, Any] = {}

    def var_value(var: Variable):
        if var.node is None:
            try:
                return input_values[var.name]
            except KeyError:
                raise ValueError(
                    f"No value fed for graph input '{var.name}'. "
                    f"Fed: {sorted(input_values)}") from None
        return values[id(var.node)]

    for node in topological_nodes(outputs):
        layer = node.layer
        ins = [var_value(v) for v in node.inbound]
        x = None if not ins else ins[0] if len(ins) == 1 else ins
        p = params.get(layer.name, {})
        if layer.has_state:
            out, upd = layer.call(p, x, state=state.get(layer.name, {}),
                                  training=training, rng=rng)
            new_state[layer.name] = upd
        else:
            out = layer.call(p, x, training=training, rng=rng)
        values[id(node)] = out

    return [var_value(v) for v in outputs], new_state
