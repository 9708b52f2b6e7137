"""Carry parameters over from the JAX package.

The JAX package's parameter tree (``KerasNet.init``'s params, or an
``InferenceModel.params``), converted to numpy, fills the port's model leaf
by leaf. ``jax.random`` draws cannot be reproduced with torch, so parity
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
    if len(spec_subs) != len(tree_subs):
        raise ValueError(f"{path}: the port has {len(spec_subs)} nested "
                         f"layers, the JAX tree {len(tree_subs)}")
    matched = dict(zip(spec_subs, tree_subs))
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


def load_jax_params(net, params) -> Dict:
    """Fill ``net`` (a KerasNet, or a single layer) from a JAX parameter
    tree and return the port's parameter dict; a KerasNet also keeps it as
    ``net.params``.

    The map follows structure, not global layer names (those carry
    per-process counters the two packages need not agree on): at each
    level, leaves match by leaf name and nested layer dicts match in order —
    the port's ``layers()``/block order against the JAX keys in natural
    order, which is the order the JAX package builds and numbers them (jax's
    tree utilities sort dict keys, so insertion order is not kept). Raises
    ``ValueError`` on a missing leaf, an extra leaf or a shape mismatch.
    """
    from analytics_zoo_tpu_torch.keras.engine.topology import KerasNet

    filled = _fill(net.param_specs(), params, net.name)
    if isinstance(net, KerasNet):
        net.params, net.model_state = filled, {}
    return filled
