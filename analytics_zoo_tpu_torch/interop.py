"""Carry parameters and state over from the JAX package.

The JAX package's parameter tree (``KerasNet.init``'s params, or an
``InferenceModel.params``) and state tree (batch norm's moving
statistics), converted to numpy, fill the port's model leaf by leaf.
``jax.random`` draws cannot be reproduced with torch, so parity between
the two packages always copies weights this way. A checkpoint directory
that the JAX package wrote (``Estimator`` checkpoints, ``save_weights``,
``ZooModel.save_model``) is read through the port's own
``ft.atomic``/``engine.checkpoint`` and matched by the same rules. The
recurrent layers' leaves (``W``, ``U``, ``U_h``, ``b``, ``b_rec``),
``Bidirectional``'s ``forward``/``backward`` pair, ``TimeDistributed``'s
``inner`` and ``Seq2seqNet``'s embeddings, cells, bridges and generator
fill the same way, leaf by leaf; so do the tagging and ranking zoo: a
CRF's ``transitions``, the char encoder's Bi-LSTM (one layer over every
word), KNRM's shared embedding (one layer, so one leaf, filled once),
SessionRecommender's session and history embeddings and GRUs, and the
Dense heads; and the layer library's, in the JAX layouts: ``ConvLSTM2D``/
``ConvLSTM3D``'s HWIO ``W``/``U``, ``Deconvolution2D``'s (kh, kw, out,
in) kernel, ``Convolution3D``'s DHWIO one, ``LocallyConnected1D``/``2D``'s
per-position kernels, ``PReLU``, ``SReLU``, ``CMul``, ``CAdd``, ``Mul``,
``Scale``, ``Highway``, ``MaxoutDense`` and ``Parameter``'s ``value``.
Nothing here imports jax: a leaf only has to convert with ``np.asarray``.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, List, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import tree_map


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


def _tree_from_flat(flat: List[Tuple[str, np.ndarray]], root: str) -> Dict:
    """The nested dict of the leaves keyed ``root/a/b/...``."""
    tree: Dict = {}
    for key, arr in flat:
        first, _, rest = key.partition("/")
        if first != root:
            continue
        *path, leaf = rest.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def fill_from_flat(net, flat: List[Tuple[str, np.ndarray]],
                   params_root: str, state_root: str):
    """``(params, state)`` of ``net`` (CPU tensors) from a checkpoint's
    flat ``[(key, array)]`` leaves under ``params_root`` and
    ``state_root`` (``0``/``1`` for ``save_weights``, ``.params``/
    ``.model_state`` for a TrainState), matched as
    :func:`load_jax_params` matches."""
    return (_fill(net.param_specs(), _tree_from_flat(flat, params_root),
                  net.name),
            _fill(net.state_specs(), _tree_from_flat(flat, state_root),
                  net.name))


_MOMENT = re.compile(r"\.opt_state/0/\.(mu|nu|trace)/(.+)")
_COUNT = re.compile(r"\.opt_state/[01]/\.count")


def _map_opt_state(net, port_opt: Dict, flat, path: str) -> Dict:
    """The port's optimizer tree (``{"mu", "nu", "count"}`` or
    ``{"trace", "count"}``) from optax's ``ScaleByAdamState`` or
    ``TraceState`` leaves; raises naming any leaf it cannot map."""
    moments: Dict[str, List] = {}
    counts = []
    for key, arr in flat:
        if not key.startswith(".opt_state/"):
            continue
        m = _MOMENT.fullmatch(key)
        if m:
            moments.setdefault(m[1], []).append((f"{m[1]}/{m[2]}", arr))
        elif _COUNT.fullmatch(key):
            counts.append(int(arr))
        else:
            raise ValueError(
                f"{path}: optimizer state leaf '{key}' has no counterpart in "
                "the port (clipping chains, gradient accumulation and the "
                "optimizers not yet ported cannot be carried over)")
    if len(set(counts)) > 1:
        raise ValueError(f"{path}: the optimizer counts disagree: {counts}")
    out = {}
    for name, cur in port_opt.items():
        if name == "count":
            continue
        leaves = moments.pop(name, None)
        if cur is None and leaves is None:
            out[name] = None
            continue
        if cur is None or leaves is None:
            raise ValueError(
                f"{path}: optimizer state '{name}': the JAX checkpoint "
                f"{'has' if leaves else 'lacks'} '.opt_state/0/.{name}', the "
                f"port's optimizer {'lacks' if leaves else 'has'} it")
        out[name] = _fill(net.param_specs(), _tree_from_flat(leaves, name),
                          f"{net.name}/{name}")
    if moments:
        leaves = next(iter(moments.values()))
        raise ValueError(f"{path}: optimizer state leaf '.opt_state/0/."
                         f"{leaves[0][0]}' has no counterpart in the port's "
                         "optimizer")
    out["count"] = counts[0] if counts else None
    return out


def load_jax_checkpoint(estimator_or_net, path: str):
    """Load a checkpoint directory that the JAX package's Estimator wrote
    (``ckpt_N/``) into a port ``Estimator`` (or a ``KerasNet``'s own),
    through the port's ``ft.atomic`` reader; returns the estimator.

    ``.params`` and ``.model_state`` match the port's layers as
    :func:`load_jax_params` matches (explicit names, then natural order
    for counter names). optax's ``ScaleByAdamState`` (``count``, ``mu``,
    ``nu``) and SGD's ``TraceState`` map onto the port's optimizer tree
    (``engine.checkpoint``'s docstring has the table); the count is
    optax's, or ``.step`` where optax keeps none. The step, epoch,
    iteration and in-epoch step come from the checkpoint. Raises naming
    the leaf for optimizer state that cannot be mapped: clipping chains,
    the accumulation wrapper, optimizers not ported yet. The JAX RNG
    position (``rng_seed``/``rng_counter``) cannot be carried: ``jax.random``
    keys have no torch counterpart, so the port's dropout stream goes on
    from where it stands."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator, TrainState
    from analytics_zoo_tpu_torch.ft import atomic

    est = (estimator_or_net if isinstance(estimator_or_net, Estimator)
           else estimator_or_net._get_estimator())
    if est.optim_method is None:
        raise RuntimeError("load_jax_checkpoint before an optimizer is set: "
                           "compile() first")
    if est.gradient_accumulation != 1:
        raise ValueError("load_jax_checkpoint: gradient accumulation state "
                         "cannot be carried over (the estimator has "
                         f"gradient_accumulation={est.gradient_accumulation})")
    net = est.model
    flat, meta = atomic.read_checkpoint(path)
    params, state = fill_from_flat(net, flat, ".params", ".model_state")
    est._ensure_state()
    opt = _map_opt_state(net, est.tstate.opt_state, flat, path)
    step = int(dict(flat)[".step"])
    if opt["count"] is None:
        opt["count"] = step
    dev = est.ctx.device
    with torch.inference_mode(False):  # the state trains on
        est.tstate = TrainState(*(
            tree_map(lambda t: t if isinstance(t, int) else t.to(dev), tree)
            for tree in (params, state, opt)), step)
    est._write_back()
    rs = est.run_state
    rs.epoch = int(meta.get("epoch", 0))
    rs.iteration = int(meta.get("iteration", 0))
    rs.epoch_step = int(meta.get("epoch_step", 0))
    return est
