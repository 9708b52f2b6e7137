#!/usr/bin/env python3
"""Phase 16 of ``chip_smoke.py``: multi-host data-parallel training of the
PyTorch/CUDA port on one card, one host per process.

Each host process trains BERT-base at full widths and depth (bf16
compute, f32 master weights, dropout off, weights from ``--seed``)
through ``Estimator.train_distributed``: a global batch of 16 x 128
tokens (``16 / hosts`` rows per host), Adam, 3 steps, a two-phase sharded
checkpoint after step 2, the rendezvous in ``--rdv``, under
``torch.use_deterministic_algorithms``. The flash kernels' wrappers count
their launches per step. Host 0 then resumes that checkpoint on one host
(the optimizer shards reshard) and takes step 3 again; both hosts then
run the same 3 steps through a single-process ``Estimator.train``, host 0
with each batch as two micro-batches of 8 rows
(``gradient_accumulation=2``: the rows each host sums, summed as the
hosts sum them), host 1 with each batch in one forward.
Each host writes its numbers to ``--result`` as JSON; ``chip_smoke.py``
(``dist_phase``) starts the hosts, reads the files and holds the gates.

One host of a run (started by ``chip_smoke.py``; the kernels must be
built first)::

    python3 scripts/torch_dist_phase.py --host 0 --hosts 2 --rdv DIR \\
        --ckpt DIR --result host0.json [--seed 16] [--t0 EPOCH_SECONDS]

Alone, both hosts and the gates (builds the kernels first; one CUDA
card)::

    python3 scripts/torch_dist_phase.py [--seed 16]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


class _StepCounts:
    """An end trigger that records the flash wrappers' counts each time
    the loop asks it (before the first step and after each one), so the
    launches of every step can be read off; with ``snapshot``, also
    ``snapshot()`` at the first ask of every ``every``-th iteration (in
    ``shots``)."""

    reads_loss = False

    def __init__(self, inner, counters, snapshot=None, every=1):
        self.inner, self.counters = inner, counters
        self.snapshot, self.every = snapshot, every
        self.seen, self.shots = [], {}

    def __call__(self, rs):
        self.seen.append((rs.iteration, [c.count for c in self.counters]))
        if (self.snapshot is not None and rs.iteration % self.every == 0
                and rs.iteration not in self.shots):
            self.shots[rs.iteration] = self.snapshot()
        return self.inner(rs)

    def per_step(self):
        out, last = [], {}
        for it, counts in self.seen:
            if it - 1 in last and it not in last:
                out.append([a - b for a, b in zip(counts, last[it - 1])])
            last.setdefault(it, counts)
        return out


def _digest(params) -> str:
    from analytics_zoo_tpu_torch.common.tree import tree_leaves

    h = hashlib.sha256()
    for leaf in tree_leaves(params):
        h.update(leaf.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _optimizer():
    """The phase's optimizer: Adam at ``chip_smoke.DIST_LR``."""
    from analytics_zoo_tpu_torch.keras.optimizers import Adam

    return Adam(lr=cs.DIST_LR)


def _vector(params):
    """The parameters as one f32 host vector, in JAX's flat order."""
    from analytics_zoo_tpu_torch.common.tree import jax_leaf_order, tree_leaves

    leaves = tree_leaves(params)
    return torch.cat([leaves[i].detach().reshape(-1).float()
                      for i in jax_leaf_order(params)]).cpu().numpy()


def _rel(a, b, base) -> float:
    """|a - b| over |base|, as float64."""
    return float(np.linalg.norm((a - b).astype(np.float64))
                 / np.linalg.norm(base.astype(np.float64)))


def _worst_leaves(params, a, b, n=4):
    """The ``n`` leaves with the largest share of |a - b|^2 (two flat
    vectors in JAX's order): ``[key, share, |a - b| / |b| of the leaf]``."""
    from analytics_zoo_tpu_torch.common.tree import (
        jax_leaf_order,
        tree_leaves,
        tree_paths,
    )

    keys, leaves = tree_paths(params), tree_leaves(params)
    d2 = np.square((a - b).astype(np.float64))
    total, rows, lo = d2.sum(), [], 0
    for i in jax_leaf_order(params):
        size = leaves[i].numel()
        part = d2[lo: lo + size].sum()
        rows.append([keys[i], float(part / total) if total else 0.0,
                     float(np.sqrt(part) / (np.linalg.norm(
                         b[lo: lo + size].astype(np.float64)) or 1.0))])
        lo += size
    return sorted(rows, key=lambda r: -r[1])[:n]


def host_main(args) -> int:
    t0 = args.t0 or time.time()
    imported = time.time()  # the interpreter, torch and chip_smoke
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.common.observability import (
        distributed_metrics,
    )
    from analytics_zoo_tpu_torch.common.tree import tree_leaves
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import (
        MaxIteration,
        SeveralIteration,
    )
    from analytics_zoo_tpu_torch.ft.distributed import DistContext
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    init_nncontext(seed=args.seed)  # creates the CUDA context
    context = time.time()
    torch.use_deterministic_algorithms(True, warn_only=True)
    rng = np.random.default_rng(args.seed)
    cfg = cs.DIST_BERT
    x = cs.make_request(rng, cs.DIST_ROWS, cfg["seq_len"], cfg["vocab"])
    y = rng.integers(0, 2, cs.DIST_ROWS).astype(np.int32)
    data = ArrayFeatureSet(x, y)
    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **cfg)
    init = net.init(torch.Generator().manual_seed(args.seed))
    net.params, net.model_state = init
    crit = objectives.sparse_categorical_crossentropy
    counters = (fa.launches, fa.launches_dq, fa.launches_dkv)
    Estimator.time_steps = True

    est = Estimator(net, _optimizer())
    est.set_checkpoint(args.ckpt, asynchronous=False)
    est._ensure_state()
    torch.cuda.synchronize()
    ready = time.time()
    out = {"host": args.host, "hosts": args.hosts, "boot_s": ready - t0,
           "boot_parts": [imported - t0, context - imported,
                          ready - context]}
    commits = []
    write = est._write_dist_checkpoint

    def timed_write(*a, **kw):
        t0 = time.perf_counter()
        path = write(*a, **kw)
        commits.append(time.perf_counter() - t0)
        return path

    est._write_dist_checkpoint = timed_write
    dist = DistContext(args.host, args.hosts, args.rdv)
    end = _StepCounts(MaxIteration(cs.DIST_STEPS), counters,
                      lambda: _vector(est.tstate.params))
    t0 = time.perf_counter()
    est.train_distributed(data, crit, end_trigger=end,
                          checkpoint_trigger=SeveralIteration(
                              cs.DIST_CKPT_AT),
                          batch_size=cs.DIST_BATCH, dist=dist)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    out["steps"] = est.run_state.iteration
    out["losses"] = est.train_losses
    out["launches_per_step"] = end.per_step()
    out["launches"] = [c.count for c in counters]
    out["timings"] = est.dist_timings
    out["commit_s"] = commits
    out["digest"] = _digest(est.tstate.params)
    m = distributed_metrics()
    out["commits_committed"] = m["commits"].labels(
        outcome="committed").value
    out["flat_size"] = int(sum(t.numel()
                               for t in tree_leaves(est.tstate.params)))
    out["slice_len"] = -(-out["flat_size"] // args.hosts)
    # 16a's peak card memory (before the checks below)
    out["peak_alloc_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2 ** 30
    if args.host == 0:
        out.update(resume_check(args, net, data, crit, counters, end.shots))
    # host 0 holds 16a against the reference of the gate, host 1 against
    # the one-forward run, side by side
    out.update(reference_check(args, net, init, data, crit, counters,
                               end.shots, ("acc", "plain")[args.host]))
    Path(args.result).write_text(json.dumps(out))
    return 0


def resume_check(args, net, data, crit, counters, shots) -> dict:
    """16b in host 0's process: one host resumes the 2-host checkpoint
    (the optimizer shards reshard) and takes step 3 again; ``shots`` holds
    16a's parameters at each iteration."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import (
        MaxIteration,
        SeveralIteration,
    )
    from analytics_zoo_tpu_torch.ft.distributed import DistContext

    out = {}
    resumed = Estimator(net, _optimizer())
    resumed.set_checkpoint(args.ckpt, asynchronous=False)
    restore = resumed._resume_distributed
    restore_s = []

    def timed_restore(*a, **kw):
        t0 = time.perf_counter()
        got = restore(*a, **kw)
        restore_s.append(time.perf_counter() - t0)
        return got

    resumed._resume_distributed = timed_restore
    before = [c.count for c in counters]
    resumed.train_distributed(
        data, crit, end_trigger=MaxIteration(cs.DIST_STEPS),
        checkpoint_trigger=SeveralIteration(cs.DIST_CKPT_AT),
        batch_size=cs.DIST_BATCH, auto_resume=True,
        dist=DistContext(0, 1))
    torch.cuda.synchronize()
    out["resume_launches"] = [c.count - b for c, b in zip(counters, before)]
    out["restore_s"] = restore_s
    out["resume_iteration"] = resumed.run_state.iteration
    last, before_last = shots[cs.DIST_STEPS], shots[cs.DIST_CKPT_AT]
    out["resume_err"] = _rel(_vector(resumed.tstate.params), last,
                             last - before_last)
    return out


def reference_check(args, net, init, data, crit, counters, shots,
                    name) -> dict:
    """16a against a single-process ``Estimator.train`` from the same
    weights over the same 16-row batches: ``"acc"`` takes each batch as
    ``hosts`` micro-batches (``gradient_accumulation``), the rows each host
    sums, summed as the hosts sum them (bitwise 16a); ``"plain"`` takes
    each batch in one forward (bf16 then sums its rows in another order,
    which Adam's sign-like first steps magnify). The gap after each step,
    over the reference's update so far."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxIteration

    accumulate = args.hosts if name == "acc" else 1
    net.params, net.model_state = init
    ref = Estimator(net, _optimizer(),
                    gradient_accumulation=accumulate)
    ref._ensure_state()
    start = _vector(ref.tstate.params)
    end = _StepCounts(MaxIteration(cs.DIST_STEPS * accumulate), counters,
                      lambda: _vector(ref.tstate.params), every=accumulate)
    ref.train(data, crit, end_trigger=end,
              batch_size=cs.DIST_BATCH // accumulate)
    torch.cuda.synchronize()
    final = end.shots[cs.DIST_STEPS * accumulate]
    steps = [_rel(shots[i], end.shots[i * accumulate],
                  end.shots[i * accumulate] - start)
             for i in range(1, cs.DIST_STEPS + 1)]
    return {f"{name}_losses": ref.train_losses,
            f"{name}_err_steps": steps, f"{name}_err": steps[-1],
            f"{name}_err_leaves": _worst_leaves(
                ref.tstate.params, shots[cs.DIST_STEPS] - start,
                final - start),
            f"{name}_update_norm": float(np.linalg.norm(
                (final - start).astype(np.float64)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=16)
    ap.add_argument("--host", type=int)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--rdv")
    ap.add_argument("--ckpt")
    ap.add_argument("--result")
    ap.add_argument("--t0", type=float, default=0.0,
                    help="the spawner's time.time() at the start")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_dist_phase: needs a CUDA card", file=sys.stderr)
        return 2
    if args.host is not None:
        return host_main(args)
    from analytics_zoo_tpu_torch.ops import _kernels

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _kernels.build(_kernels.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    launches = cs.dist_phase(args.seed)
    print(f"phase 16 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches by the hosts' wrappers {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
