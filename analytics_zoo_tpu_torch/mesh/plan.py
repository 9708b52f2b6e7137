"""ShardingPlan, where every parameter and batch leaf lives on the mesh
(port of ``analytics_zoo_tpu.mesh.plan``).

The plan is the single declaration the serving stack consumes:

- **batch inputs** shard on the ``data`` axis, leading dim: request row
  *i* lives on exactly one data slot;
- **parameters** shard by *leaf-path regex rules*: each rule is a
  ``(pattern, partition spec)`` pair matched against the leaf's
  ``/``-joined tree path (``"dense_1/kernel"``); first match wins;
- **everything unmatched replicates**, explicitly, so a typo'd rule is a
  visible "replicated" in :meth:`ShardingPlan.describe`.

The mesh is the context's in-process slot mesh
(:class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`); placements are
:class:`~analytics_zoo_tpu_torch.parallel.sharding.SlotSharding` values and
placed tensors :class:`~analytics_zoo_tpu_torch.parallel.sharding
.ShardedTensor` holders. ``InferenceModel`` runs each data slot's rows
through one program of its own and gathers a sharded parameter inside it,
so a plan changes where rows and bytes live, not what a row computes.
:meth:`ShardingPlan.describe` and :meth:`ShardingPlan.fingerprint` return
the JAX package's strings for the same declaration.
"""

from __future__ import annotations

import logging
import re
from typing import Any, List, Sequence, Tuple, Union

from analytics_zoo_tpu_torch.mesh.config import STAGE_AXIS, MeshConfig

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = ["ShardingPlan", "BucketShardingError", "leaf_path"]

#: One partition-spec entry: ``None`` (replicate this dim), an axis name,
#: or a tuple of axis names (the dim shards over their product).
SpecEntry = Union[None, str, Tuple[str, ...]]


class BucketShardingError(ValueError):
    """A batch/bucket size is not divisible by the mesh's ``data`` axis
    length. Raised at register/job-construction time, naming the
    offending ``(bucket, axis)`` pair."""


def leaf_path(path: Sequence[Any]) -> str:
    """A tree key path (dict keys, sequence indices, named-tuple fields) as
    the ``/``-joined string the plan's rules match against, e.g.
    ``"dense_1/kernel"`` or ``"0/bias"``."""
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples (a named
    tuple's keys are its field names; ``None`` stays ``None``)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class ShardingPlan:
    """Placement policy over a :class:`~analytics_zoo_tpu_torch.mesh.config
    .MeshConfig`: batch on ``data``, params by rule, replicate the rest.

    ::

        plan = ShardingPlan(MeshConfig((8, 1, 1)))            # pure DP
        plan = ShardingPlan(
            MeshConfig((2, 1, 4)),
            rules=((r"kernel$", (None, "tp")),                # TP matmuls
                   (r"embedding", ("fsdp", None))))           # FSDP tables

    ``rules`` is an ordered sequence of ``(pattern, spec)`` pairs:
    ``pattern`` is an ``re.search`` regex over the leaf's ``/``-joined
    path; ``spec`` is a per-dimension tuple of ``None``, an axis name, or
    a tuple of axis names. The first matching rule wins; unmatched leaves
    replicate. A spec naming an axis the mesh does not have, or the
    ``stage`` axis, fails at construction.
    """

    def __init__(self, mesh: MeshConfig,
                 rules: Sequence[Tuple[str, Sequence[SpecEntry]]] = (),
                 data_axis: str = "data"):
        if not isinstance(mesh, MeshConfig):
            raise TypeError(
                f"mesh must be a MeshConfig, got {type(mesh).__name__}")
        self.mesh_config = mesh
        self.data_axis = str(data_axis)
        known = set(mesh.axis_names)
        compiled: List[Tuple[str, Any, Tuple[SpecEntry, ...]]] = []
        for pattern, spec in rules:
            entries: List[SpecEntry] = []
            for e in spec:
                if e is None:
                    entries.append(None)
                    continue
                names = (e,) if isinstance(e, str) else tuple(e)
                for n in names:
                    if n == STAGE_AXIS:
                        # the stage axis partitions the LAYER GRAPH, not
                        # tensors: a placement spec over it is always a
                        # misdeclaration
                        raise ValueError(
                            f"sharding rule {pattern!r} names the "
                            f"{STAGE_AXIS!r} axis — stages are assigned by "
                            "a StagePlan's layer rules, never by a "
                            "placement spec")
                    if n not in known:
                        raise ValueError(
                            f"sharding rule {pattern!r} names axis {n!r} "
                            f"but the mesh only has {mesh.axis_names}")
                entries.append(names[0] if isinstance(e, str) else names)
            compiled.append((str(pattern), re.compile(str(pattern)),
                             tuple(entries)))
        self._rules = tuple(compiled)
        self._mesh = None  # built lazily, cached

    # -- mesh -------------------------------------------------------------

    def build_mesh(self):
        """The plan's :class:`~analytics_zoo_tpu_torch.mesh.slots.SlotMesh`
        (built once, cached): the context's first slots, where the
        declaration is checked against the context's slot count."""
        if self._mesh is None:
            from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

            self._mesh = SlotMesh(self.mesh_config.build(),
                                  self.mesh_config.axis_names)
        return self._mesh

    @property
    def data_axis_length(self) -> int:
        """Ways the batch dim is split: every bucket size must be a
        multiple of this (:meth:`validate_ladder`)."""
        return self.mesh_config.axis_length(self.data_axis)

    def data_slot_indices(self) -> List[int]:
        """Row-major indices of the slots that run the data shards, in row
        order: the data axis's line (every other coordinate 0), or slot 0
        when the mesh has no data axis."""
        import numpy as np

        mesh = self.build_mesh()
        shape = mesh.devices.shape
        if self.data_axis not in mesh.axis_names:
            return [0]
        ax = mesh.axis_names.index(self.data_axis)
        return [int(np.ravel_multi_index(
            tuple(j if a == ax else 0 for a in range(len(shape))), shape))
            for j in range(shape[ax])]

    # -- partition specs --------------------------------------------------

    def spec_for_path(self, path: str):
        """The ``PartitionSpec`` the first matching rule assigns to a leaf
        at ``path`` (``/``-joined), or the replicated spec."""
        from analytics_zoo_tpu_torch.parallel.sharding import PartitionSpec

        for _, rx, entries in self._rules:
            if rx.search(path):
                return PartitionSpec(*entries)
        return PartitionSpec()

    def param_shardings(self, tree: Any) -> Any:
        """Per-leaf ``SlotSharding`` tree for a params/state tree:
        rule-matched leaves shard as declared, everything else carries the
        explicit replicated default."""
        from analytics_zoo_tpu_torch.parallel.sharding import SlotSharding

        mesh = self.build_mesh()
        return _map_with_path(
            lambda path, _leaf: SlotSharding(
                mesh, self.spec_for_path(leaf_path(path))), tree)

    def input_sharding(self, ndim: int):
        """Batch-input ``SlotSharding``: leading (batch) dim on the
        ``data`` axis, trailing dims whole."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            PartitionSpec,
            SlotSharding,
        )

        mesh = self.build_mesh()
        if self.data_axis not in self.mesh_config.axis_names:
            return SlotSharding(mesh, PartitionSpec())
        return SlotSharding(mesh, PartitionSpec(
            self.data_axis, *([None] * (max(ndim, 1) - 1))))

    def input_shardings(self, x: Any) -> Any:
        """Input shardings matching ``x``'s structure (an array or a
        list/tuple of arrays, leading axis = batch)."""
        if isinstance(x, (list, tuple)):
            return type(x)(self.input_sharding(
                getattr(a, "ndim", 1)) for a in x)
        return self.input_sharding(getattr(x, "ndim", 1))

    def output_sharding(self):
        """The sharding of every output leaf: batch dim on ``data``."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            PartitionSpec,
            SlotSharding,
        )

        mesh = self.build_mesh()
        if self.data_axis not in self.mesh_config.axis_names:
            return SlotSharding(mesh, PartitionSpec())
        return SlotSharding(mesh, PartitionSpec(self.data_axis))

    # -- placement helpers ------------------------------------------------

    def shard_params(self, tree: Any) -> Any:
        """A params/state tree placed in its planned form: a tree of
        ``ShardedTensor`` (a replicated leaf is one copy per slot device,
        which the slots on that device share)."""
        from analytics_zoo_tpu_torch.parallel.sharding import (
            SlotSharding,
            _as_tensor,
        )

        mesh = self.build_mesh()
        return _map_with_path(
            lambda path, leaf: SlotSharding(
                mesh, self.spec_for_path(leaf_path(path))).shard(
                    _as_tensor(leaf)), tree)

    def device_put_batch(self, x: Any) -> Any:
        """A host batch (array or list of arrays) placed in data-sharded
        form: each data slot's row block copied to its device. The copy is
        always fresh, so a caller may reuse its staging buffer at once
        (the batcher and the batch engine do)."""
        from analytics_zoo_tpu_torch.parallel.sharding import _as_tensor

        def put(a):
            return self.input_sharding(getattr(a, "ndim", 1)).shard(
                _as_tensor(a))

        if isinstance(x, (list, tuple)):
            return [put(a) for a in x]
        return put(x)

    # -- validation -------------------------------------------------------

    def validate_batch(self, rows: int, context: str = "batch") -> None:
        """Raise :class:`BucketShardingError` unless ``rows`` divides
        evenly over the ``data`` axis."""
        d = self.data_axis_length
        if d > 1 and rows % d:
            raise BucketShardingError(
                f"{context} size {rows} is not divisible by mesh axis "
                f"'{self.data_axis}' (length {d}) — every compiled "
                f"batch shape must split evenly across the data axis "
                f"(mesh {self.mesh_config.describe()})")

    def validate_ladder(self, ladder: Sequence[int],
                        context: str = "bucket ladder") -> None:
        """Validate every bucket in ``ladder`` divides evenly over the
        ``data`` axis, failing loudly with the offending ``(bucket, axis)``
        pair at register/job time."""
        d = self.data_axis_length
        if d <= 1:
            return
        bad = [b for b in ladder if int(b) % d]
        if bad:
            raise BucketShardingError(
                f"{context} {tuple(int(b) for b in ladder)} has bucket "
                f"size(s) {bad} not divisible by mesh axis "
                f"'{self.data_axis}' (length {d}) — pass an explicit "
                f"ladder of multiples of {2 * d}, e.g. "
                f"buckets=({2 * d}, {4 * d}, {8 * d}) "
                f"(mesh {self.mesh_config.describe()})")
        single_row = [int(b) for b in ladder if int(b) // d == 1]
        if single_row:
            # divisible, so legal; but a bucket of exactly d rows gives
            # each data slot a single row, and a single-row product may
            # take another kernel (a gemv) than the batched one, which
            # sums in another order: the sharded result is then not
            # bitwise the unsharded one
            logger.warning(
                "%s: bucket size(s) %s give each '%s' slice a single row "
                "— single-row kernels are not bitwise identical to "
                "batched ones on CPU; use buckets >= %d (2 rows/slice) "
                "where bitwise parity matters",
                context, single_row, self.data_axis, 2 * d)

    # -- identity ---------------------------------------------------------

    def fingerprint(self) -> str:
        """Stable identity: the mesh topology (device count + axis
        names/lengths), the data axis, and every rule's (pattern, spec)
        pair: any change to where a leaf lives changes it."""
        rules = ";".join(f"{p}->{e!r}" for p, _, e in self._rules)
        return (f"{self.mesh_config.fingerprint()};"
                f"data_axis={self.data_axis};rules=[{rules}]")

    def describe(self) -> dict:
        """JSON-friendly summary (engine ``info()`` / ``/healthz``)."""
        return {
            "mesh": self.mesh_config.describe(),
            "devices": self.mesh_config.total_devices,
            "data_axis": self.data_axis,
            "rules": [{"pattern": p, "spec": [list(e) if isinstance(
                e, tuple) else e for e in entries]}
                for p, _, entries in self._rules],
        }

    def __repr__(self) -> str:
        return (f"ShardingPlan({self.mesh_config.describe()}, "
                f"rules={len(self._rules)})")
