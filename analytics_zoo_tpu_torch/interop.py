"""Carry parameters and state over from the JAX package.

The JAX package's parameter tree (``KerasNet.init``'s params, or an
``InferenceModel.params``) and state tree (batch norm's moving
statistics), converted to numpy, fill the port's model leaf by leaf. ``jax.random`` draws cannot be reproduced with torch, so parity
between the two packages always copies weights this way. Nothing here
imports jax: a leaf only has to convert with ``np.asarray``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch


def _natural_key(name: str):
    """``block2`` before ``block10``: digit runs compare as numbers."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]


def _counter_named(name: str) -> bool:
    """``dense_3``: a name from the per-process layer counters, which the
    two packages need not agree on."""
    return re.fullmatch(r"[a-z0-9]+_\d+", name) is not None


def _match_subs(spec_subs, tree_subs, path: str) -> Dict[str, str]:
    """Port nested-layer name -> JAX key: by name where both sides have
    the same explicit name (``fc1000``, ``res2a_a_bn``), then the rest in
    natural order on both sides."""
    if len(spec_subs) != len(tree_subs):
        raise ValueError(f"{path}: the port has {len(spec_subs)} nested "
                         f"layers, the JAX tree {len(tree_subs)}")
    named = {k for k in spec_subs
             if k in tree_subs and not _counter_named(k)}
    matched = {k: k for k in named}
    matched.update(zip(
        sorted((k for k in spec_subs if k not in named), key=_natural_key),
        [k for k in tree_subs if k not in named]))
    return matched


def _fill(specs: Dict, tree, path: str) -> Dict:
    if not isinstance(tree, Mapping):
        raise ValueError(f"{path}: expected a dict of parameters, got "
                         f"{type(tree).__name__}")
    spec_leaves = [k for k, s in specs.items() if not isinstance(s, dict)]
    spec_subs = [k for k, s in specs.items() if isinstance(s, dict)]
    tree_leaves = {k for k, t in tree.items() if not isinstance(t, Mapping)}
    tree_subs = sorted((k for k, t in tree.items() if isinstance(t, Mapping)),
                       key=_natural_key)
    missing = [k for k in spec_leaves if k not in tree_leaves]
    if missing:
        raise ValueError(f"{path}: missing leaf {missing}")
    extra = sorted(tree_leaves - set(spec_leaves))
    if extra:
        raise ValueError(f"{path}: extra leaf {extra}")
    matched = _match_subs(spec_subs, tree_subs, path)
    out = {}
    for name, spec in specs.items():
        if name in matched:
            out[name] = _fill(spec, tree[matched[name]], f"{path}/{name}")
            continue
        arr = np.asarray(tree[name])
        if arr.shape != spec.shape:
            raise ValueError(f"{path}/{name}: shape mismatch: JAX "
                             f"{arr.shape}, port {spec.shape}")
        out[name] = torch.tensor(arr, dtype=spec.dtype)
    return out


def load_jax_params(net, params, state=None) -> Dict:
    """Fill ``net`` (a KerasNet, or a single layer) from a JAX parameter
    tree and return the port's parameter dict; a KerasNet also keeps it as
    ``net.params``, and as ``net.model_state`` the JAX state tree ``state``
    (a JAX ``KerasNet.init``'s or ``TrainState.model_state``), or its own
    initial state when ``state`` is None.

    Leaves match by leaf name. Nested layer dicts match by name where both
    sides carry the same explicit name (``fc1000``, ``res2a_a_bn``), and the
    rest in natural order on both sides (``block2`` before ``block10``,
    ``conv_2`` before ``dense_1``), which is the order the packages number
    them in (jax's tree utilities sort dict keys, so insertion order is
    not kept). Counter names (``dense_3``) always match by order: they carry
    per-process counters the two packages need not agree on. Raises
    ``ValueError`` on a missing leaf, an extra leaf or a shape mismatch.
    """
    from analytics_zoo_tpu_torch.keras.engine.topology import KerasNet

    filled = _fill(net.param_specs(), params, net.name)
    if isinstance(net, KerasNet):
        net.params = filled
        net.model_state = (
            {layer.name: layer.init_state() for layer in net.layers()
             if layer.has_state}
            if state is None else _fill(net.state_specs(), state, net.name))
    return filled
