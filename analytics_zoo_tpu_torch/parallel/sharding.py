"""Sharding layout helpers (port of ``analytics_zoo_tpu.parallel.sharding``)
over the in-process slot mesh
(:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`).

PyTorch has no ``NamedSharding``, and the port uses neither DTensor nor a
process group: a mesh is a grid of slots in one process. Three small
types stand in for JAX's:

- :class:`PartitionSpec`: a tuple of per-dimension entries (``None``, an
  axis name, or a tuple of axis names), rendered as JAX renders its own
  (``PartitionSpec('data', None)``);
- :class:`SlotSharding`: a frozen (mesh, spec) pair, the placement of one
  tensor; :meth:`SlotSharding.shard` cuts a tensor into its slots' shards;
- :class:`ShardedTensor`: the per-slot shards of one tensor with its
  ``spec``; :meth:`ShardedTensor.gather` reassembles the whole tensor on a
  device. A slot's program gathers a sharded parameter before it uses it,
  so placement changes where the bytes live at rest, never a result.
  Slots that hold the same shard on the same device share one tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import tree_map
from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

__all__ = ["PartitionSpec", "SlotSharding", "ShardedTensor",
           "ShardingRules", "named_sharding", "replicated", "data_sharding",
           "shard_batch", "param_shardings", "place_params", "gather_tree"]

# The framework's logical axis vocabulary (config.py mesh_axis_names
# convention): declared layer pspecs may reference these; a mesh that lacks
# one simply replicates that dim (see param_shardings.clean).
_CANONICAL_AXES = frozenset({"data", "model", "seq", "expert", "pipe"})

SpecEntry = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension placement: ``None`` (whole on every slot), an axis
    name, or a tuple of axis names (the dim splits over their product).
    Trailing dims past the spec are whole."""

    def __new__(cls, *entries: SpecEntry):
        return super().__new__(cls, tuple(
            e if e is None or isinstance(e, str) else tuple(e)
            for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry: SpecEntry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True, eq=False)
class SlotSharding:
    """Where one tensor lives on ``mesh``: ``spec`` entry ``d`` names the
    axes dim ``d`` splits over. Raises ``ValueError`` for an axis the mesh
    does not have, or one named twice."""

    mesh: SlotMesh
    spec: PartitionSpec

    def __post_init__(self):
        spec = self.spec
        if not isinstance(spec, PartitionSpec):
            spec = PartitionSpec(*spec)
            object.__setattr__(self, "spec", spec)
        used = [a for e in spec for a in _axes(e)]
        for a in used:
            if a not in self.mesh.axis_names:
                raise ValueError(
                    f"partition spec {spec} names axis {a!r} but the mesh "
                    f"only has {self.mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"partition spec {spec} names an axis twice")

    def __repr__(self) -> str:
        return f"SlotSharding(mesh={self.mesh!r}, spec={self.spec})"

    def _chunk_index(self, coord: Tuple[int, ...]) -> Tuple[int, ...]:
        """The chunk of each sharded dim that the slot at ``coord`` holds:
        row-major over the dim's axes, in the order the spec names them."""
        shape = self.mesh.shape
        out = []
        for entry in self.spec:
            idx = 0
            for a in _axes(entry):
                idx = idx * shape[a] + coord[self.mesh.axis_names.index(a)]
            out.append(idx)
        return tuple(out)

    def _splits(self) -> Tuple[int, ...]:
        shape = self.mesh.shape
        return tuple(int(np.prod([shape[a] for a in _axes(e)]))
                     for e in self.spec)

    def shard(self, t: torch.Tensor) -> "ShardedTensor":
        """``t`` cut into its slots' shards, each copied to its slot's
        device (a fresh tensor: the caller's is never aliased)."""
        splits = self._splits()
        if len(splits) > t.dim():
            raise ValueError(f"partition spec {self.spec} has more entries "
                             f"than the rank-{t.dim()} tensor")
        for d, n in enumerate(splits):
            if t.shape[d] % n:
                raise ValueError(
                    f"dim {d} of a tensor of shape {tuple(t.shape)} does not "
                    f"split into {n} shards ({self.spec} over "
                    f"{self.mesh.shape})")
        shared: Dict[Tuple, torch.Tensor] = {}
        shards = []
        for coord in np.ndindex(*self.mesh.devices.shape):
            device = self.mesh.devices[coord]
            chunk = self._chunk_index(coord)
            key = (chunk, str(device))
            if key not in shared:
                piece = t
                for d, (i, n) in enumerate(zip(chunk, splits)):
                    if n > 1:
                        piece = piece.chunk(n, dim=d)[i]
                shared[key] = piece.to(device, copy=True).contiguous()
            shards.append(shared[key])
        return ShardedTensor(self, shards, tuple(t.shape), t.dtype)


class ShardedTensor:
    """One tensor's per-slot shards (``shards[i]`` is the shard of slot
    ``i`` in row-major slot order) under ``sharding``."""

    def __init__(self, sharding: SlotSharding, shards: List[torch.Tensor],
                 shape: Tuple[int, ...], dtype: torch.dtype):
        self.sharding = sharding
        self.shards = shards
        self.shape = shape
        self.dtype = dtype

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    def gather(self, device: Optional[torch.device] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first slot's by default):
        one copy of each distinct chunk (a slot's on ``device`` where one
        holds it), moved to ``device`` and concatenated dim by dim. A
        replicated tensor already on ``device`` comes back as it is,
        without a copy."""
        device = torch.device(device) if device is not None else \
            self.shards[0].device
        splits = self.sharding._splits()
        pieces: Dict[Tuple[int, ...], torch.Tensor] = {}
        for coord, shard in zip(np.ndindex(*self.sharding.mesh.devices.shape),
                                self.shards):
            chunk = self.sharding._chunk_index(coord)
            if chunk not in pieces or shard.device == device:
                pieces[chunk] = shard

        def assemble(prefix: Tuple[int, ...]) -> torch.Tensor:
            d = len(prefix)
            if d == len(splits):
                return pieces[prefix].to(device)
            parts = [assemble(prefix + (i,)) for i in range(splits[d])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=d)

        return assemble(())

    def __array__(self, dtype=None, copy=None):
        t = self.gather(torch.device("cpu")).detach()
        a = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return (f"ShardedTensor(shape={self.shape}, dtype={self.dtype}, "
                f"spec={self.spec})")


def named_sharding(mesh: SlotMesh, *spec) -> SlotSharding:
    """Shorthand: ``SlotSharding(mesh, PartitionSpec(*spec))``."""
    return SlotSharding(mesh, PartitionSpec(*spec))


def replicated(mesh: SlotMesh) -> SlotSharding:
    """Fully replicated layout on ``mesh`` (empty PartitionSpec)."""
    return SlotSharding(mesh, PartitionSpec())


def data_sharding(mesh: SlotMesh, ndim: int,
                  data_axis: str = "data") -> SlotSharding:
    """Batch-dim-0 sharding for an ``ndim``-rank tensor."""
    return SlotSharding(mesh, PartitionSpec(data_axis,
                                            *([None] * (ndim - 1))))


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.float32 if a.dtype == np.float64 else a.dtype))


def shard_batch(mesh: SlotMesh, batch: Any, data_axis: str = "data") -> Any:
    """A host (or device) tree of arrays placed on the mesh, batch-sharded
    on dim 0: one copy of each row block to its data slot. float64 host
    arrays become float32, as the context's ``host_to_device`` makes
    them."""
    return tree_map(
        lambda x: data_sharding(mesh, max(np.ndim(x), 1), data_axis).shard(
            _as_tensor(x)), batch)


def param_shardings(mesh: SlotMesh, params: Any, pspecs: Any) -> Any:
    """THE parameter-layout policy: per-leaf :class:`SlotSharding` from a
    model's declared partition specs (a nested dict mirroring ``params``;
    ``None`` or a missing entry replicates). Spec entries naming a
    canonical axis the mesh lacks replicate that dim instead (one model
    definition places on any mesh); other unknown names raise."""
    axis_names = set(mesh.axis_names)

    def clean(spec):
        return tuple(None if (a in _CANONICAL_AXES and a not in axis_names)
                     else a for a in spec)

    def build(tree, spec_tree):
        if isinstance(tree, dict):
            return {k: build(v, (spec_tree or {}).get(k)
                             if isinstance(spec_tree, dict) else None)
                    for k, v in tree.items()}
        if spec_tree is None:
            return SlotSharding(mesh, PartitionSpec())
        return SlotSharding(mesh, PartitionSpec(*clean(spec_tree)))

    return build(params, pspecs)


def place_params(mesh: SlotMesh, params: Any, pspecs: Any) -> Any:
    """``params`` placed according to :func:`param_shardings`: a tree of
    :class:`ShardedTensor`."""
    return tree_map(lambda t, s: s.shard(_as_tensor(t)), params,
                    param_shardings(mesh, params, pspecs))


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Named axes of the training layout. ``data`` carries the batch (DP);
    ``model`` carries TP-annotated parameters; parameter placement itself is
    :func:`param_shardings` (driven by per-layer pspec declarations)."""

    data_axis: str = "data"
    model_axis: Optional[str] = "model"


def gather_tree(tree: Any, device: torch.device) -> Any:
    """Every :class:`ShardedTensor` leaf of ``tree`` gathered on
    ``device``; other leaves as they are."""
    return tree_map(lambda t: t.gather(device) if isinstance(
        t, ShardedTensor) else t, tree)
