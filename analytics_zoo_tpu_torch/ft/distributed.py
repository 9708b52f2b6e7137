"""Multi-host data-parallel training: the rendezvous, the sharded optimizer
update and the two-phase sharded checkpoint commit (port of
``analytics_zoo_tpu.ft.distributed``).

The multi-host trainer (``Estimator.train_distributed``) runs N host
processes in lockstep, each with its own device (a host process of the
port owns one card, or the CPU). Each host computes the gradient of the
summed per-sample loss over its rows of the global batch; the hosts
exchange gradient sums through a filesystem rendezvous
(:class:`DistContext`, the stand-in for a collective fabric, chosen so a
kill test can murder any host at any point and the survivors' view stays
inspectable on disk), and the optimizer update itself is *sharded*: host k
updates only the k-th ``1/N`` window of the flattened parameter vector
(:class:`ShardedUpdater`), on its device, then the updated windows are
all-gathered. Optimizer state is therefore ``1/N`` per host: ZeRO-1
across hosts.

The flat vector is the JAX package's ``ravel_pytree`` of the parameters:
leaves in JAX's flatten order (dict keys sorted), zero-padded to
``N * ceil(V / N)``. The optimizer shard of each host is checkpointed
leaf for leaf in optax's order of the JAX package's same optimizer
(``keras.optimizers.optax_leaves``), so either package restores the
other's sharded checkpoints, and on any host count.

Checkpoints extend the :mod:`analytics_zoo_tpu_torch.ft.atomic` commit
protocol to many writers with a two-phase commit
(:func:`commit_sharded_checkpoint`):

1. **Stage**: every host writes ``ckpt_N.tmp/host_K/arrays.npz`` plus a
   fsynced per-host shard manifest (``shard.json``: leaf keys, shapes,
   dtypes, CRC32s, commit id).
2. **Commit**: exactly one coordinator (host 0) validates every shard
   manifest (disjoint leaf sets whose union is the expected key set),
   writes the merged ``manifest.json``, renames ``ckpt_N.tmp`` to
   ``ckpt_N`` and drops the ``COMMIT`` marker last.

A reader therefore never observes a torn multi-host checkpoint: a kill at
any point leaves the previous committed checkpoint or sweepable staging
debris. Every kill site is a :mod:`analytics_zoo_tpu_torch.ft.chaos`
``dist_*`` failure point.

Restore is host-count independent: a checkpoint written by N hosts
restores on M hosts by re-slicing the concatenated optimizer shards
(:meth:`ShardedUpdater.restore_opt`).
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from analytics_zoo_tpu_torch.common.tree import (
    jax_leaf_order,
    tree_leaves,
    tree_map,
    tree_unflatten,
)
from analytics_zoo_tpu_torch.ft import atomic, chaos

logger = logging.getLogger("analytics_zoo_tpu_torch")

__all__ = [
    "DistTimeoutError",
    "DistCommitError",
    "DistContext",
    "ShardedUpdater",
    "commit_sharded_checkpoint",
    "opt_shard_key",
    "split_round_robin",
]

#: Default rendezvous/commit deadline in seconds; overridable per run via
#: ``AZOO_DIST_TIMEOUT_S`` (the kill matrix shortens it so a murdered
#: peer is detected in seconds, not minutes).
DEFAULT_TIMEOUT_S = 60.0


def _default_timeout() -> float:
    try:
        return float(os.environ.get("AZOO_DIST_TIMEOUT_S",
                                    str(DEFAULT_TIMEOUT_S)))
    except ValueError:  # pragma: no cover - malformed env
        return DEFAULT_TIMEOUT_S


class DistTimeoutError(RuntimeError):
    """A cross-host rendezvous or commit wait passed its deadline with
    peers still missing — the surviving host's signal that a peer died
    (or stalled) mid-round. The trainer surfaces it like an async
    checkpoint-writer failure: the save attempt is aborted and swept,
    training itself continues."""


class DistCommitError(atomic.CheckpointError):
    """A two-phase sharded commit was aborted: shard validation failed
    (overlapping or missing leaves), the coordinator swept the staging
    directory, or another run committed over the target path."""


def opt_shard_key(host: int, index: int) -> str:
    """Leaf key under which optimizer-shard leaf ``index`` of ``host`` is
    checkpointed (``optshard/00001/00003``) — zero-padded so key order is
    host-partition order."""
    return f"optshard/{int(host):05d}/{int(index):05d}"


def split_round_robin(flat: Sequence, host_id: int, num_hosts: int) -> list:
    """Deterministic ownership partition of a flat leaf list for the
    sharded commit: host ``k`` owns ``flat[k::num_hosts]``. Every host
    computes the same partition from the same list, so leaf-set
    disjointness and union completeness hold by construction when all
    hosts are healthy — the coordinator still verifies both."""
    return list(flat[int(host_id)::int(num_hosts)])


class DistContext:
    """Identity and rendezvous of one simulated host in an N-host run.

    Hosts are OS processes; the "collective" is a filesystem all-gather:
    each :meth:`exchange` round writes this host's payload to
    ``<rendezvous_dir>/x<seq>/h<k>.npz`` (atomically, via
    write-to-tmp + ``os.replace``) and polls until all N peers' files
    appear, then loads them **in fixed host order** — which makes the
    cross-host sum on every host bitwise identical. A peer missing past
    the deadline raises :class:`DistTimeoutError` naming the missing
    hosts. ``num_hosts == 1`` short-circuits without touching the
    filesystem.
    """

    def __init__(self, host_id: int, num_hosts: int,
                 rendezvous_dir: Optional[str] = None, *,
                 timeout_s: Optional[float] = None,
                 poll_s: float = 0.002,
                 run_id: Optional[str] = None):
        host_id, num_hosts = int(host_id), int(num_hosts)
        if num_hosts < 1:
            raise ValueError(f"num_hosts must be >= 1, got {num_hosts}")
        if not 0 <= host_id < num_hosts:
            raise ValueError(
                f"host_id {host_id} out of range for {num_hosts} host(s)")
        if num_hosts > 1 and not rendezvous_dir:
            raise ValueError("multi-host runs need a rendezvous_dir")
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.timeout_s = (_default_timeout() if timeout_s is None
                          else float(timeout_s))
        self.poll_s = float(poll_s)
        self.run_id = (os.environ.get("AZOO_DIST_RUN_ID", "")
                       if run_id is None else str(run_id))
        # namespace rounds by run id: a restarted attempt must never read
        # the round files a dead run left behind in the same rendezvous dir
        if rendezvous_dir and self.run_id:
            rendezvous_dir = os.path.join(rendezvous_dir, self.run_id)
        self.rendezvous_dir = rendezvous_dir
        self._seq = 0
        if num_hosts > 1:
            os.makedirs(rendezvous_dir, exist_ok=True)

    @property
    def is_coordinator(self) -> bool:
        """True on host 0 — the single host that merges shard manifests
        and drops the COMMIT marker."""
        return self.host_id == 0

    def commit_id(self, step: int) -> str:
        """The commit identity ``"<run_id>:<step>"`` staged into every
        shard manifest — what lets the coordinator tell this attempt's
        shards from stale debris of an earlier aborted run at the same
        step."""
        return f"{self.run_id}:{int(step)}"

    def exchange(self, payload: Dict[str, np.ndarray]
                 ) -> List[Dict[str, np.ndarray]]:
        """All-gather ``payload`` (a dict of arrays) across the N hosts;
        returns the N payloads in host order (index = host id). Blocks
        until every peer's round file appears; raises
        :class:`DistTimeoutError` past the deadline. The previous
        round's own file is deleted once this round is visible from all
        peers (a peer writing round *s* has, by construction, finished
        reading round *s-1*), so the rendezvous dir stays O(1)."""
        seq = self._seq
        if self.num_hosts == 1:
            self._seq = seq + 1
            return [{k: np.asarray(v) for k, v in payload.items()}]
        round_dir = os.path.join(self.rendezvous_dir, f"x{seq:08d}")
        os.makedirs(round_dir, exist_ok=True)
        mine = os.path.join(round_dir, f"h{self.host_id}.npz")
        tmp = mine + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **{k: np.asarray(v) for k, v in payload.items()})
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, mine)

        paths = [os.path.join(round_dir, f"h{k}.npz")
                 for k in range(self.num_hosts)]
        deadline = time.monotonic() + self.timeout_s
        while True:
            missing = [k for k, p in enumerate(paths)
                       if not os.path.isfile(p)]
            if not missing:
                break
            if time.monotonic() > deadline:
                raise DistTimeoutError(
                    f"host {self.host_id}: rendezvous round {seq} — "
                    f"host(s) {missing} missing after "
                    f"{self.timeout_s:.1f}s ({round_dir})")
            time.sleep(self.poll_s)
        out = []
        for p in paths:
            with np.load(p) as z:
                out.append({k: z[k] for k in z.files})
        if seq > 0:
            prev_dir = os.path.join(self.rendezvous_dir, f"x{seq - 1:08d}")
            try:
                os.unlink(os.path.join(prev_dir, f"h{self.host_id}.npz"))
            except OSError:  # pragma: no cover - already gone
                pass
            try:
                os.rmdir(prev_dir)  # last deleter removes the round dir
            except OSError:
                pass
        self._seq = seq + 1
        return out

    def allreduce_sum(self, payload: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """:meth:`exchange` then sum each key across hosts **in fixed
        host order** — float summation order is what makes the reduced
        value bitwise identical on every host."""
        parts = self.exchange(payload)
        out: Dict[str, np.ndarray] = {}
        for key in payload:
            acc = np.array(parts[0][key], copy=True)
            for part in parts[1:]:
                acc = acc + part[key]
            out[key] = acc
        return out

    def barrier(self) -> None:
        """A trivial :meth:`exchange` round — returns once every host has
        arrived here (or raises :class:`DistTimeoutError`)."""
        self.exchange({"b": np.zeros((), np.int8)})


class ShardedUpdater:
    """The sharded optimizer update: host ``k`` owns window ``k`` of the
    flattened parameter vector.

    The parameter tree is raveled in JAX's flatten order to one vector of
    ``flat_size`` elements, zero-padded to ``num_hosts * slice_len``
    (``slice_len`` is a multiple of the local data-axis device count, one
    on the port). ``tx.init`` runs on this host's padded window only, so
    the optimizer state is ``1/num_hosts`` of the full model's, as
    tensors on the parameters' device. :meth:`step` applies the optimizer
    and the parameter add to the window: the same elementwise arithmetic
    as the per-leaf step, so the updated window is that step's values.
    A single host trains the per-leaf state of the plain step and converts
    layouts at checkpoint time (:meth:`tree_to_flat`,
    :meth:`to_tree_state`: pure data movement, bitwise).

    Checkpointing: :meth:`opt_flat` names this host's optimizer leaves
    ``optshard/<host>/<i>`` in optax's leaf order; :meth:`restore_opt`
    reads them back from a checkpoint written by any host count.
    """

    def __init__(self, tx, params_template, host_id: int, num_hosts: int,
                 mesh_config=None):
        from analytics_zoo_tpu_torch.keras.optimizers import optax_leaves
        from analytics_zoo_tpu_torch.mesh.config import MeshConfig

        self.tx = tx
        self.host_id = int(host_id)
        self.num_hosts = int(num_hosts)
        if not 0 <= self.host_id < self.num_hosts:
            raise ValueError(
                f"host_id {host_id} out of range for {num_hosts} host(s)")
        layout = optax_leaves(tx)
        if layout is None:
            raise ValueError(
                "the optimizer declares no optax leaf layout "
                "(keras.optimizers.optax_leaves), so its shards cannot be "
                "checkpointed in the JAX package's format")
        self.layout = tuple(layout)
        leaves = tree_leaves(params_template)
        self._order = jax_leaf_order(params_template)
        self._shapes = [tuple(leaves[i].shape) for i in self._order]
        self._sizes = [int(np.prod(s, dtype=np.int64)) for s in self._shapes]
        self.flat_size = int(sum(self._sizes))
        if self.flat_size == 0:
            raise ValueError("cannot shard an empty parameter pytree")
        dtype = leaves[0].dtype
        for leaf in leaves[1:]:
            dtype = torch.promote_types(dtype, leaf.dtype)
        self._flat_dtype = dtype
        # the tree's structure, for unflattening (no reference to the
        # caller's tensors)
        self._structure = tree_map(lambda _: 0, params_template)
        if mesh_config is None:
            mesh_config = MeshConfig.host_local_data()
        self.mesh_config = mesh_config
        n_dev = int(mesh_config.axis_length("data"))
        per_dev = -(-self.flat_size // (self.num_hosts * n_dev))
        self.slice_len = per_dev * n_dev
        self.padded_size = self.num_hosts * self.slice_len
        mesh_config.build()  # a mesh larger than the process raises here

    @property
    def opt_leaf_count(self) -> int:
        """Optimizer-state leaves per host shard (the same on every host:
        the same ``tx``, the same ``slice_len``)."""
        return len(self.layout)

    def padded_vector(self, tree) -> torch.Tensor:
        """``tree`` raveled in JAX's order and zero-padded to
        ``padded_size``, on the tree's device."""
        leaves = tree_leaves(tree)
        parts = [leaves[i].detach().reshape(-1).to(self._flat_dtype)
                 for i in self._order]
        pad = self.padded_size - self.flat_size
        if pad:
            parts.append(parts[0].new_zeros((pad,)))
        return torch.cat(parts)

    def slice_of(self, vec, host: int):
        """Window ``host`` of a padded flat vector."""
        lo = int(host) * self.slice_len
        return vec[lo: lo + self.slice_len]

    def init_opt(self, params):
        """This host's optimizer shard: ``tx.init`` on the host's padded
        parameter window (what ``tx.init`` on the whole tree would hold
        for these elements)."""
        with torch.inference_mode(False):
            window = self.slice_of(self.padded_vector(params), self.host_id)
            return self.tx.init(window.clone())

    def _unravel(self, vec: torch.Tensor):
        """The parameter tree from the first ``flat_size`` elements of a
        flat vector (views of it), in the tree's own leaf order."""
        pieces = torch.split(vec[: self.flat_size], self._sizes)
        leaves = [None] * len(pieces)
        for piece, pos, shape in zip(pieces, self._order, self._shapes):
            leaves[pos] = piece.reshape(shape)
        return tree_unflatten(self._structure, leaves)

    def tree_to_flat(self, tree_state):
        """Convert a per-leaf optimizer state (what ``tx.init(params)``
        builds and the single-host path updates) into the flat layout this
        class checkpoints. Single-host only (the tree state IS the whole
        model). Pure data movement: each parameter-shaped entry is raveled
        in JAX's order and zero-padded (the padded tail matches a fresh
        :meth:`init_opt`: zero gradients keep zero moments); counts pass
        through. Bitwise inverse of :meth:`to_tree_state`."""
        if self.num_hosts != 1:
            raise ValueError(
                "tree_to_flat converts a whole-model optimizer state, only "
                f"valid with num_hosts == 1, not {self.num_hosts}")
        return {k: (v if v is None or isinstance(v, int)
                    else self.padded_vector(v))
                for k, v in tree_state.items()}

    def to_tree_state(self, flat_state):
        """Inverse of :meth:`tree_to_flat`: the per-leaf optimizer state
        from the flat layout (what :meth:`restore_opt` returns), for the
        single-host path. Bitwise: the vector splits back into the exact
        parameter-shaped leaves it was raveled from."""
        if self.num_hosts != 1:
            raise ValueError(
                "to_tree_state rebuilds a whole-model optimizer state, only "
                f"valid with num_hosts == 1, not {self.num_hosts}")
        return {k: (v if v is None or isinstance(v, int)
                    else tree_map(torch.clone, self._unravel(v)))
                for k, v in flat_state.items()}

    def mask_vector(self, params, update_mask) -> Optional[torch.Tensor]:
        """The trainability mask as a padded flat bool vector (True =
        trainable) on the parameters' device, or None when
        ``update_mask`` is None (everything trainable). The padding is
        False, so an update never touches the padded tail."""
        if update_mask is None:
            return None
        marks = tree_leaves(update_mask)
        device = tree_leaves(params)[0].device
        vec = torch.zeros((self.padded_size,), dtype=torch.bool,
                          device=device)
        lo = 0
        for pos, size in zip(self._order, self._sizes):
            vec[lo: lo + size] = bool(marks[pos])
            lo += size
        return vec

    def _window(self, vec, device) -> torch.Tensor:
        """This host's window of a padded host or device vector, on
        ``device`` in the flat dtype."""
        part = self.slice_of(vec, self.host_id)
        if isinstance(part, np.ndarray):
            part = torch.from_numpy(np.ascontiguousarray(part))
        return part.to(device=device, dtype=self._flat_dtype)

    def step(self, params, grad_vec, opt_state, mask_vec=None):
        """One sharded optimizer step. ``grad_vec`` is the globally
        combined padded gradient vector (the same on every host; a host
        array or a tensor); returns ``(new_slice, new_opt_state)``, where
        ``new_slice`` is this host's updated ``(slice_len,)`` parameter
        window on the parameters' device: what the next
        :meth:`DistContext.exchange` round circulates. The masking is the
        plain step's: frozen gradients are zeroed before the transform
        (they must not feed the moments) and frozen updates after it
        (decoupled decay must not drift frozen parameters)."""
        device = tree_leaves(params)[0].device
        with torch.no_grad(), torch.inference_mode(False):
            p = self.slice_of(self.padded_vector(params), self.host_id)
            g = self._window(grad_vec, device)
            if mask_vec is not None:
                m = self.slice_of(mask_vec, self.host_id)
                g = torch.where(m, g, torch.zeros_like(g))
            u, new_opt = self.tx.update(g, opt_state, p)
            if mask_vec is not None:
                u = torch.where(m, u, torch.zeros_like(u))
            return p + u, new_opt

    def assemble(self, slices: Sequence, device=None):
        """The full parameter tree from the N host windows (in host
        order, host arrays or tensors): the zero padding cut and the
        vector unraveled, on ``device`` (default: the first tensor's, else
        the CPU)."""
        if len(slices) != self.num_hosts:
            raise ValueError(
                f"assemble needs {self.num_hosts} slices, got {len(slices)}")
        if device is None:
            device = next((s.device for s in slices
                           if isinstance(s, torch.Tensor)), "cpu")
        parts = [torch.from_numpy(np.ascontiguousarray(s))
                 if isinstance(s, np.ndarray) else s for s in slices]
        full = torch.cat([p.to(device=device, dtype=self._flat_dtype)
                          for p in parts])
        if full.numel() != self.padded_size:
            raise ValueError(
                f"assembled vector has {full.numel()} elements, expected "
                f"{self.padded_size}")
        return self._unravel(full)

    def opt_flat(self, opt_state) -> List[Tuple[str, np.ndarray]]:
        """This host's optimizer shard as named host leaves for the
        sharded commit (``optshard/<host>/<i>`` in optax's leaf order;
        a count as an int32 scalar, as optax keeps it)."""
        out = []
        for i, name in enumerate(self.layout):
            value = opt_state[name]
            arr = (np.asarray(int(value), np.int32) if name == "count"
                   else value.detach().to("cpu", copy=True).numpy())
            out.append((opt_shard_key(self.host_id, i), arr))
        return out

    def expected_opt_keys(self) -> set:
        """Every optimizer-shard key the N hosts will stage: part of the
        coordinator's union-completeness check."""
        return {opt_shard_key(h, i)
                for h in range(self.num_hosts)
                for i in range(self.opt_leaf_count)}

    def restore_opt(self, flat_map: Dict[str, np.ndarray],
                    dist_meta: Dict[str, Any], device=None, step: int = 0):
        """Rebuild this host's optimizer shard from a checkpoint written
        on ``dist_meta['num_hosts']`` hosts (possibly not this run's
        count), on ``device``.

        Vector leaves (per-element state such as Adam's ``mu``/``nu``) are
        concatenated across the old hosts' windows, cut to the true flat
        size, re-padded and re-sliced for this host; a count is taken from
        host 0. Where optax keeps no count (an optimizer without a
        schedule) the port's count is ``step``. Deterministic: the same
        checkpoint restored on any host count gives bitwise the same state
        for every parameter element."""
        n_old = int(dist_meta["num_hosts"])
        L_old = int(dist_meta["slice_len"])
        n_leaves = int(dist_meta["opt_leaves"])
        V = int(dist_meta["flat_size"])
        if V != self.flat_size:
            raise ValueError(
                f"checkpoint flattened {V} parameters, this model has "
                f"{self.flat_size}: not the same model")
        if n_leaves != self.opt_leaf_count:
            raise ValueError(
                f"checkpoint has {n_leaves} optimizer leaves per shard, "
                f"this optimizer has {self.opt_leaf_count}: not the same "
                "transform chain")
        with torch.inference_mode(False):
            state = self.tx.init(torch.zeros(
                (self.slice_len,), dtype=self._flat_dtype, device=device))
            if "count" in state and "count" not in self.layout:
                state["count"] = int(step)
            for i, name in enumerate(self.layout):
                parts = []
                for h in range(n_old):
                    key = opt_shard_key(h, i)
                    if key not in flat_map:
                        raise atomic.CheckpointCorruptError(
                            f"optimizer shard leaf {key!r} missing from "
                            "checkpoint")
                    parts.append(np.asarray(flat_map[key]))
                if name == "count":
                    state["count"] = int(parts[0])
                    continue
                for h, part in enumerate(parts):
                    if part.shape != (L_old,):
                        raise atomic.CheckpointCorruptError(
                            f"optimizer shard leaf {opt_shard_key(h, i)!r} "
                            f"has shape {part.shape}, expected ({L_old},)")
                full = np.concatenate(parts)[:V]
                mine = np.zeros((self.slice_len,), dtype=full.dtype)
                lo = self.host_id * self.slice_len
                seg = full[lo: lo + self.slice_len]
                mine[: seg.size] = seg
                state[name] = torch.tensor(mine, device=device)
        return state


def _abort_staging(tmp: str, outcome: str) -> None:
    from analytics_zoo_tpu_torch.common.observability import (
        checkpoint_sweep_counters, distributed_metrics)

    shutil.rmtree(tmp, ignore_errors=True)
    checkpoint_sweep_counters()["dist_abort"].inc()
    distributed_metrics()["commits"].labels(outcome=outcome).inc()


def _read_committed_commit_id(path: str) -> Optional[str]:
    try:
        manifest = atomic.read_manifest(path)
    except atomic.CheckpointCorruptError:
        return None
    return (manifest.get("shards") or {}).get("commit_id")


def commit_sharded_checkpoint(path: str,
                              flat: List[Tuple[str, np.ndarray]], *,
                              host_id: int, num_hosts: int,
                              expected_keys: Optional[set] = None,
                              metadata: Optional[Dict] = None,
                              commit_id: str = "",
                              timeout_s: Optional[float] = None,
                              poll_s: float = 0.01,
                              overwrite: bool = True,
                              shard_meta: Optional[Dict] = None) -> str:
    """Two-phase multi-writer commit of a sharded checkpoint directory.

    Called by **every** host with its own ``flat`` leaf list. All hosts
    stage ``<path>.tmp/host_<k>/`` (``arrays.npz`` then a fsynced
    ``shard.json`` carrying keys/shapes/dtypes/CRC32s and ``commit_id``);
    host 0 then waits for all N shard manifests, validates leaf-set
    disjointness and (when ``expected_keys`` is given) union
    completeness, sweeps any stale ``host_K/`` debris whose commit id
    does not match, writes the merged ``manifest.json``, renames and
    drops ``COMMIT`` last. Participants block until the commit lands.

    Failure semantics: a coordinator-side timeout or validation failure
    sweeps the whole staging tree (counted in
    ``zoo_checkpoint_sweeps_total{kind="dist_abort"}``) and raises
    :class:`DistTimeoutError` / :class:`DistCommitError`; a
    participant-side wait past the deadline raises
    :class:`DistTimeoutError`. Either way no reader can ever observe a
    torn checkpoint. Returns ``path`` on success (on every host)."""
    from analytics_zoo_tpu_torch.common.observability import (
        checkpoint_sweep_counters, distributed_metrics, get_tracer)

    host_id, num_hosts = int(host_id), int(num_hosts)
    if timeout_s is None:
        timeout_s = _default_timeout()
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    if not overwrite and atomic.is_committed(path):
        raise FileExistsError(f"{path} exists and overwrite=False")

    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)  # hosts race; exist_ok makes it benign
    host_dir = os.path.join(tmp, f"host_{host_id}")
    if os.path.isdir(host_dir):
        shutil.rmtree(host_dir)  # own debris from an earlier aborted attempt
    os.makedirs(host_dir)

    arrays = {f"a{i}": np.asarray(a) for i, (_, a) in enumerate(flat)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    with open(os.path.join(host_dir, atomic.ARRAYS), "wb") as f:
        if chaos.should_fail("dist_participant_torn"):
            f.write(data[: max(1, len(data) // 2)])
            atomic._fsync_file(f)
            chaos.fail("dist_participant_torn")
        f.write(data)
        atomic._fsync_file(f)
    chaos.maybe_fail("dist_participant_before_manifest")

    shard = {
        "format": atomic.FORMAT,
        "host": host_id,
        "num_hosts": num_hosts,
        "commit_id": commit_id,
        "keys": [k for k, _ in flat],
        "leaves": [atomic._leaf_record(k, np.asarray(a)) for k, a in flat],
    }
    if shard_meta:
        # writer-declared shard identity (e.g. the pipeline trainer's
        # {"stage": k}) — rides in shard.json and is copied into the
        # merged manifest's per-host entries for inspectors
        for mk, mv in shard_meta.items():
            shard.setdefault(str(mk), mv)
    with open(os.path.join(host_dir, atomic.SHARD_MANIFEST), "wb") as f:
        f.write(json.dumps(shard).encode())
        atomic._fsync_file(f)
    atomic._fsync_dir(host_dir)
    atomic._fsync_dir(tmp)

    if host_id != 0:
        # participant: staging done — wait for the coordinator's commit
        deadline = time.monotonic() + timeout_s
        while True:
            if atomic.is_committed(path):
                got = _read_committed_commit_id(path)
                if got == commit_id:
                    return path
                if not os.path.isdir(tmp):
                    raise DistCommitError(
                        f"host {host_id}: {path!r} was committed by a "
                        f"different attempt (commit id {got!r}, expected "
                        f"{commit_id!r})")
                # an OLDER committed checkpoint at the same step while our
                # staging still exists: the coordinator is mid-overwrite —
                # keep polling until it swaps in this attempt's commit
            if (not os.path.isdir(tmp)) and (not os.path.isdir(path)):
                raise DistCommitError(
                    f"host {host_id}: coordinator aborted commit "
                    f"{commit_id!r} of {path!r} (staging swept)")
            if time.monotonic() > deadline:
                raise DistTimeoutError(
                    f"host {host_id}: commit {commit_id!r} of {path!r} "
                    f"not finalized within {timeout_s:.1f}s")
            time.sleep(poll_s)

    # ------------------------------------------------------------------
    # coordinator
    # ------------------------------------------------------------------
    metrics = distributed_metrics()
    with get_tracer().span("dist.commit", path=path, hosts=num_hosts,
                           commit_id=commit_id):
        shard_manifests: Dict[int, Dict[str, Any]] = {}
        deadline = time.monotonic() + timeout_s
        while len(shard_manifests) < num_hosts:
            for k in range(num_hosts):
                if k in shard_manifests:
                    continue
                sp = os.path.join(tmp, f"host_{k}", atomic.SHARD_MANIFEST)
                try:
                    with open(sp) as f:
                        man = json.load(f)
                except (OSError, ValueError):
                    continue
                if man.get("commit_id") != commit_id:
                    continue  # stale debris — the live host will restage
                shard_manifests[k] = man
            if len(shard_manifests) == num_hosts:
                break
            if time.monotonic() > deadline:
                missing = sorted(set(range(num_hosts))
                                 - set(shard_manifests))
                _abort_staging(tmp, "timeout")
                raise DistTimeoutError(
                    f"coordinator: host(s) {missing} never staged commit "
                    f"{commit_id!r} within {timeout_s:.1f}s — staging "
                    "swept, training continues")
            time.sleep(poll_s)

        # validation: disjointness + (optionally) union completeness
        owner: Dict[str, int] = {}
        for k in range(num_hosts):
            for key in shard_manifests[k].get("keys", []):
                if key in owner:
                    _abort_staging(tmp, "aborted")
                    raise DistCommitError(
                        f"leaf {key!r} claimed by both host {owner[key]} "
                        f"and host {k} — shard sets must be disjoint")
                owner[key] = k
        if expected_keys is not None:
            missing_keys = set(expected_keys) - set(owner)
            extra_keys = set(owner) - set(expected_keys)
            if missing_keys or extra_keys:
                _abort_staging(tmp, "aborted")
                raise DistCommitError(
                    f"shard union mismatch: missing "
                    f"{sorted(missing_keys)[:5]}, unexpected "
                    f"{sorted(extra_keys)[:5]}")
        chaos.maybe_fail("dist_coordinator_before_merge")

        # sweep stale host dirs (wrong/absent commit id) before the rename
        # so the committed directory never carries undeclared payloads
        sweeps = checkpoint_sweep_counters()
        for fname in os.listdir(tmp):
            m = atomic._HOST_DIR_RE.match(fname)
            if m and int(m.group(1)) not in shard_manifests:
                shutil.rmtree(os.path.join(tmp, fname), ignore_errors=True)
                sweeps["orphan_shard"].inc()

        keys: List[str] = []
        recs: List[Dict[str, Any]] = []
        hosts_meta = []
        for k in range(num_hosts):
            man = shard_manifests[k]
            host_entry = {"host": k, "leaves": len(man["keys"])}
            if "stage" in man:
                host_entry["stage"] = man["stage"]
            hosts_meta.append(host_entry)
            for idx, (key, rec) in enumerate(zip(man["keys"],
                                                 man["leaves"])):
                merged_rec = dict(rec)
                merged_rec["host"] = k
                merged_rec["index"] = idx
                keys.append(key)
                recs.append(merged_rec)
        merged = {
            "format": atomic.FORMAT,
            "keys": keys,
            "leaves": recs,
            "metadata": metadata or {},
            "shards": {"num_hosts": num_hosts, "commit_id": commit_id,
                       "hosts": hosts_meta},
        }
        with open(os.path.join(tmp, atomic.MANIFEST), "wb") as f:
            f.write(json.dumps(merged).encode())
            atomic._fsync_file(f)
        atomic._fsync_dir(tmp)

        if os.path.isdir(path):
            shutil.rmtree(path)  # overwrite / husk replacement
        os.rename(tmp, path)
        atomic._fsync_dir(parent)
        chaos.maybe_fail("dist_coordinator_before_commit")

        with open(os.path.join(path, atomic.COMMIT), "w") as f:
            json.dump({"format": atomic.FORMAT, "commit_id": commit_id,
                       "bytes": len(data)}, f)
            atomic._fsync_file(f)
        atomic._fsync_dir(path)
        metrics["commits"].labels(outcome="committed").inc()
        logger.info("sharded checkpoint committed: %s (%d hosts, %d leaves)",
                    path, num_hosts, len(keys))
    return path
