"""StagePlan — which pipeline stage owns every layer (and every leaf)
(port of ``analytics_zoo_tpu.pipeline.plan``: a copy; it imports no
framework).

The declaration mirrors :class:`~analytics_zoo_tpu_torch.mesh.plan
.ShardingPlan`: ordered ``(pattern, stage)`` rules, ``re.search`` over
the layer name (the leading segment of every parameter leaf path, e.g.
``"dense_1"`` in ``"dense_1/kernel"``), first match wins. The one
deliberate difference: a ``ShardingPlan`` replicates unmatched leaves —
a harmless default — but an unmatched *layer* here has no stage to run
on, so it **fails loudly** at assignment time. Stages must be a
partition of the layer stack, not a guess.

Assignment is validated structurally, before anything compiles:

- every layer matches some rule (:class:`StageAssignmentError` names
  the layer otherwise);
- stage ids are contiguous ``0..K-1`` with no empty stage (a pipeline
  with a hole is a misdeclaration);
- assignments are monotonic along the layer order — activations only
  flow forward, so ``[0, 1, 0]`` is an error naming the offending
  layer and rule.

The plan composes with the SPMD axes in one declaration: give it the
:class:`~analytics_zoo_tpu_torch.mesh.config.MeshConfig` that carries the
``stage`` axis next to ``data``/``fsdp``/``tp``
(``MeshConfig.from_spec("data=2,stage=4")``) and construction checks
the axis length equals ``num_stages``. See docs/pipeline-parallel.md.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from analytics_zoo_tpu_torch.mesh.config import MeshConfig, STAGE_AXIS

__all__ = ["StagePlan", "StageSegment", "StageAssignmentError",
           "StageLadderError"]


class StageAssignmentError(ValueError):
    """A layer the rules leave unmatched, a non-contiguous stage set, or
    an assignment that sends activations backwards. Raised at plan/split
    time, naming the offending layer and rule — never from inside a
    compile."""


class StageLadderError(ValueError):
    """A bucket ladder entry invalid under a stage split — raised at
    register time naming the ``(bucket, stage)`` pair, the stage twin of
    :class:`~analytics_zoo_tpu_torch.mesh.plan.BucketShardingError`."""


@dataclass(frozen=True)
class StageSegment:
    """One stage's contiguous slice of the layer stack.

    ``indices`` are the layers' ABSOLUTE positions in the original
    model — the per-layer RNG fold (``fold_in(rng, i)``) must use them,
    or a stage-split forward would draw different dropout masks than
    the unsplit model."""

    stage: int
    layers: Tuple[Any, ...]
    indices: Tuple[int, ...]

    @property
    def names(self) -> Tuple[str, ...]:
        """Layer names in this segment, in stack order."""
        return tuple(layer.name for layer in self.layers)


class StagePlan:
    """Layer-graph partition policy: K stages by first-match-wins rules.

    ::

        plan = StagePlan(2, rules=((r"^dense_1", 0), (r".", 1)))
        plan = StagePlan(4, rules=((r"embed", 0), (r"block_[0-3]/", 1),
                                   (r"block_[4-7]/", 2), (r".", 3)),
                         mesh=MeshConfig.from_spec("data=2,stage=4"))

    ``rules`` is an ordered sequence of ``(pattern, stage)`` pairs;
    ``pattern`` is an ``re.search`` regex over the layer name, ``stage``
    an int in ``[0, num_stages)``. ``mesh`` (optional) is the composed
    SPMD declaration — when it carries a ``stage`` axis its length must
    equal ``num_stages``.
    """

    def __init__(self, num_stages: int,
                 rules: Sequence[Tuple[str, int]] = (),
                 mesh: Optional[MeshConfig] = None):
        self.num_stages = int(num_stages)
        if self.num_stages < 1:
            raise ValueError(f"num_stages must be >= 1, got {num_stages}")
        compiled: List[Tuple[str, Any, int]] = []
        for pattern, stage in rules:
            stage = int(stage)
            if not (0 <= stage < self.num_stages):
                raise ValueError(
                    f"stage rule {pattern!r} assigns stage {stage}, outside "
                    f"[0, {self.num_stages})")
            try:
                rx = re.compile(str(pattern))
            except re.error as e:
                raise ValueError(
                    f"stage rule {pattern!r} is not a valid regex: {e}"
                ) from None
            compiled.append((str(pattern), rx, stage))
        self._rules = tuple(compiled)
        if mesh is not None and not isinstance(mesh, MeshConfig):
            raise TypeError(
                f"mesh must be a MeshConfig, got {type(mesh).__name__}")
        if mesh is not None:
            declared = mesh.axis_length(STAGE_AXIS)
            if declared != 1 and declared != self.num_stages:
                raise ValueError(
                    f"mesh declares {STAGE_AXIS}={declared} but the plan "
                    f"has {self.num_stages} stages — one declaration, one "
                    "truth")
        self.mesh_config = mesh

    # -- assignment -------------------------------------------------------

    def stage_of(self, layer_name: str) -> Tuple[int, str]:
        """``(stage, winning pattern)`` for one layer name — first match
        wins; no match raises :class:`StageAssignmentError` naming the
        layer (stages must be a partition, not a guess)."""
        for pattern, rx, stage in self._rules:
            if rx.search(layer_name):
                return stage, pattern
        raise StageAssignmentError(
            f"layer {layer_name!r} matches no stage rule — every layer "
            f"must be assigned (rules: "
            f"{[p for p, _, _ in self._rules]!r})")

    def assign(self, layer_names: Sequence[str]) -> List[int]:
        """Per-layer stage ids for an ordered layer stack, validated:
        monotonic non-decreasing (activations flow forward only) and a
        full partition (every stage ``0..K-1`` owns >= 1 layer)."""
        assigned: List[int] = []
        prev_stage, prev_name = 0, None
        for name in layer_names:
            stage, pattern = self.stage_of(name)
            if stage < prev_stage:
                raise StageAssignmentError(
                    f"layer {name!r} (rule {pattern!r}) lands on stage "
                    f"{stage} AFTER {prev_name!r} on stage {prev_stage} — "
                    "stage assignment must be non-decreasing along the "
                    "layer order (activations flow forward)")
            assigned.append(stage)
            prev_stage, prev_name = stage, name
        present = set(assigned)
        missing = [s for s in range(self.num_stages) if s not in present]
        if missing:
            raise StageAssignmentError(
                f"stage(s) {missing} own no layers — a {self.num_stages}-"
                f"stage plan must partition the stack (got stages "
                f"{sorted(present)} over {len(layer_names)} layers)")
        return assigned

    def split(self, model) -> List[StageSegment]:
        """Partition a Sequential-style model (anything exposing an
        ordered ``layers()`` stack) into K contiguous
        :class:`StageSegment` slices."""
        layers_fn = getattr(model, "layers", None)
        if not callable(layers_fn):
            raise TypeError(
                f"StagePlan.split needs a model with an ordered .layers() "
                f"stack, got {type(model).__name__}")
        layers = list(layers_fn())
        if not layers:
            raise StageAssignmentError("model has no layers to partition")
        assigned = self.assign([layer.name for layer in layers])
        segments = []
        for s in range(self.num_stages):
            idxs = tuple(i for i, a in enumerate(assigned) if a == s)
            segments.append(StageSegment(
                stage=s,
                layers=tuple(layers[i] for i in idxs),
                indices=idxs))
        return segments

    def layer_stages(self, model) -> Dict[str, int]:
        """Layer name → owning stage for a concrete model — the resolved
        assignment :meth:`owner_of_key`/:meth:`partition_flat` shard
        checkpoints by (rules match layer NAMES; checkpoint keys carry
        extra path segments like ``params/``/``opt_state/``, so raw rule
        matching over them would mis-assign)."""
        return {seg_layer.name: seg.stage
                for seg in self.split(model) for seg_layer in seg.layers}

    def owner_of_key(self, key: str, layer_stages: Dict[str, int]) -> int:
        """Owning stage of a checkpoint/leaf key by its layer-name path
        segment (``"params/dense_1/kernel"`` → ``dense_1``'s stage).
        Keys naming no assigned layer (step counters, optimizer scalars)
        belong to stage 0, the schedule's coordinator."""
        for part in str(key).split("/"):
            if part in layer_stages:
                return layer_stages[part]
        return 0

    def partition_flat(self, flat: Sequence[Tuple[str, Any]],
                       layer_stages: Dict[str, int]
                       ) -> List[List[Tuple[str, Any]]]:
        """Split a flattened ``(key, leaf)`` list into per-stage shard
        lists by :meth:`owner_of_key` — the stage-owned layout the
        two-phase sharded checkpoint commits (docs/pipeline-parallel.md
        "Checkpoint format")."""
        shards: List[List[Tuple[str, Any]]] = [
            [] for _ in range(self.num_stages)]
        for key, leaf in flat:
            shards[self.owner_of_key(key, layer_stages)].append((key, leaf))
        return shards

    # -- register-time validation -----------------------------------------

    def validate_ladder(self, ladder: Sequence[int],
                        sharding_plan=None, context: str = "") -> None:
        """Every stage's bucket ladder, validated before anything
        mutates: each (bucket, stage) cell compiles to its own
        executable, so each cell is checked — positive integer buckets,
        and when an SPMD plan composes, divisibility by its ``data``
        axis. Raises :class:`StageLadderError` naming the first bad
        ``(bucket, stage)`` pair."""
        where = f" ({context})" if context else ""
        n_data = 1
        if sharding_plan is not None:
            n_data = sharding_plan.mesh_config.axis_length(
                sharding_plan.data_axis)
        elif self.mesh_config is not None:
            n_data = self.mesh_config.axis_length("data")
        for stage in range(self.num_stages):
            for bucket in ladder:
                if int(bucket) != bucket or bucket <= 0:
                    raise StageLadderError(
                        f"bucket {bucket!r} is not a positive integer — "
                        f"stage {stage} cannot compile it{where}")
                if bucket % n_data:
                    raise StageLadderError(
                        f"bucket {bucket} does not divide the data axis "
                        f"({n_data}) — stage {stage}'s executable would "
                        f"fail at placement{where}")

    # -- identity ---------------------------------------------------------

    def describe(self) -> Dict[str, Any]:
        """Human-readable summary (the serving /models surface)."""
        out = {"num_stages": self.num_stages,
               "rules": [[p, s] for p, _, s in self._rules]}
        if self.mesh_config is not None:
            out["mesh"] = self.mesh_config.describe()
        return out

    def fingerprint(self) -> str:
        """Stable identity for executable keying and checkpoint metadata:
        stage count, every rule in order, and the composed mesh."""
        rules = ";".join(f"{p}=>{s}" for p, _, s in self._rules)
        mesh = (self.mesh_config.fingerprint()
                if self.mesh_config is not None else "none")
        return f"stages={self.num_stages};rules=[{rules}];mesh={mesh}"

    def __repr__(self) -> str:
        return (f"StagePlan(num_stages={self.num_stages}, "
                f"rules={[(p, s) for p, _, s in self._rules]!r})")
