#!/usr/bin/env python3
"""Which operations of the port's training steps repeat bitwise on the card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_determinism.py [--seed N] [--repeats R]

1. step: the gradients of one BERT-base train step at full width (bf16
   compute, dropout off, batch 64, seq 128) cut to 2 blocks, and of one
   NeuralCF(2000, 5000, 5) step at batch 8192, each computed R times from
   the same parameters and batch; prints the leaves whose gradient is not
   bitwise equal across the repeats, with the largest difference. Then
   three 4-step ``Estimator.train`` runs of that BERT (SGD with momentum)
   from the same parameters and step-generator seed, with hidden dropout
   0 and 0.1: the leaves that end unequal.
2. ops: each candidate operation of those steps alone, forward and
   backward R times on the same inputs: ``F.embedding``'s backward into a
   bf16 and an f32 table for word ids (30522 rows), position ids (128 rows,
   each id 64 times) and segment ids (2 rows), a bf16 GEMM's input and
   weight gradients at the FFN's shape, the port's LayerNorm, the flash
   attention forward and backward with the padding bias, and the sparse
   cross-entropy's gather.

Prints one line per check: ``bitwise`` or the largest difference seen.
Needs the card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DEVICE = "cuda"
# BERT-base at full width cut to 2 blocks, batch 64, seq 128; NCF batch 8192
BATCH, SEQ, VOCAB, HIDDEN, HEADS, FFN, NCF_BATCH = (64, 128, 30522, 768, 12,
                                                     3072, 8192)
TRAIN_STEPS = 4  # per Estimator.train run (the same batch each step)


def max_diff(runs):
    """Largest |run - first run| over the runs' tensors (0.0 = bitwise)."""
    worst = 0.0
    for run in runs[1:]:
        for a, b in zip(runs[0], run):
            worst = max(worst, (a.double() - b.double()).abs().max().item())
    return worst


def repeat(fn, repeats):
    out = []
    for _ in range(repeats):
        out.append([t.detach().clone() for t in fn()])
        torch.cuda.synchronize()
    return out


def report(name, runs):
    d = max_diff(runs)
    print(f"determinism: {name}: "
          + ("bitwise" if d == 0 else f"NOT bitwise, max |diff| {d:.3e}"),
          flush=True)


def step_grads(net, params, xs, y, mask):
    """The gradients of one train step's loss, in leaf order."""
    from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_unflatten
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import objectives

    est = Estimator(net)
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    p = est._cast_for_compute(tree_unflatten(params, leaves))
    pred, _ = net.apply(p, {}, est._cast_for_compute(xs), training=True,
                        rng=None)
    ps = objectives.get_per_sample(objectives.sparse_categorical_crossentropy)
    loss = (ps(y, pred.float()) * mask).sum() / mask.sum()
    return torch.autograd.grad(loss, leaves)


def check_step(name, net, xs, y, repeats):
    from analytics_zoo_tpu_torch.common.tree import tree_map, tree_paths

    dev = torch.device(DEVICE)
    params = tree_map(lambda t: t.to(dev), net.params)
    mask = torch.ones(y.shape[0], device=dev)
    runs = repeat(lambda: step_grads(net, params, xs, y, mask), repeats)
    keys = tree_paths(params)
    differ = []
    for i, key in enumerate(keys):
        d = max_diff([[r[i]] for r in runs])
        if d:
            differ.append(f"{key} ({d:.3e})")
    print(f"determinism: {name} step gradients over {repeats} repeats: "
          f"{len(keys) - len(differ)} of {len(keys)} leaves bitwise; "
          f"differing: {differ or 'none'}", flush=True)


def check_train(name, net, data, steps, repeats, seed):
    """``repeats`` runs of ``steps`` Estimator.train steps (SGD with
    momentum) from the same parameters and step-generator seed: which
    parameter leaves end unequal."""
    from analytics_zoo_tpu_torch.common.nncontext import get_nncontext
    from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_paths
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxIteration
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    init = net.params
    runs = []
    for _ in range(repeats):
        net.params = init
        get_nncontext().step_generator.manual_seed(seed)
        est = Estimator(net, SGD(lr=0.01, momentum=0.9))
        est.train(data, objectives.sparse_categorical_crossentropy,
                  end_trigger=MaxIteration(steps), batch_size=BATCH)
        runs.append([t.clone() for t in tree_leaves(est.tstate.params)])
    net.params = init
    keys = tree_paths(init)
    differ = [f"{key} ({d:.3e})" for key, d in (
        (key, max_diff([[r[i]] for r in runs])) for i, key in enumerate(keys))
        if d]
    print(f"determinism: {name}, {steps} Estimator.train steps over "
          f"{repeats} runs: {len(keys) - len(differ)} of {len(keys)} leaves "
          f"bitwise; differing: {differ or 'none'}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("torch_determinism: needs a CUDA card", file=sys.stderr)
        return 2

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.keras.layers.attention import _layer_norm
    from analytics_zoo_tpu_torch.models.recommendation import NeuralCF
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    init_nncontext(seed=args.seed, device=DEVICE)
    dev, r = torch.device(DEVICE), args.repeats
    print(f"determinism: {torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, cuda {torch.version.cuda}", flush=True)
    rng = np.random.default_rng(args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    # -- 1. whole steps ----------------------------------------------------
    b, s, vocab, hid = BATCH, SEQ, VOCAB, HIDDEN
    bert = BERTClassifierNet(num_classes=2, vocab=vocab, hidden_size=hid,
                             n_block=2, n_head=HEADS, seq_len=s,
                             intermediate_size=FFN, hidden_drop=0.0,
                             attn_drop=0.0)
    bert.params, _ = bert.init(torch.Generator().manual_seed(args.seed))
    lens = rng.integers(s // 8, s + 1, b)
    pos = np.arange(s)[None, :]
    m = (pos < lens[:, None]).astype(np.float32)
    xs = [torch.tensor((rng.integers(1, vocab, (b, s)) * m).astype(np.int32),
                       device=dev),
          torch.tensor(((pos >= lens[:, None] // 2) * m).astype(np.int32),
                       device=dev),
          torch.tensor(m, device=dev)]
    y = torch.tensor(rng.integers(0, 2, b).astype(np.int32), device=dev)
    check_step("bert-2-block", bert, xs, y, r)
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet

    rows = ArrayFeatureSet([t.cpu().numpy() for t in xs],
                           y.cpu().numpy()).cache_device()
    for drop in (0.0, 0.1):
        net = BERTClassifierNet(num_classes=2, vocab=vocab, hidden_size=hid,
                                n_block=2, n_head=HEADS, seq_len=s,
                                intermediate_size=FFN, hidden_drop=drop,
                                attn_drop=0.0, name=bert.name)
        net.params = bert.params
        check_train(f"bert-2-block, hidden dropout {drop}", net, rows,
                    TRAIN_STEPS, 3, args.seed)
    ncf = NeuralCF(2000, 5000, 5).model
    ncf.params, _ = ncf.init(torch.Generator().manual_seed(args.seed))
    n = NCF_BATCH
    pairs = torch.tensor(np.stack([rng.integers(1, 2001, n),
                                   rng.integers(1, 5001, n)], 1)
                         .astype(np.int32), device=dev)
    check_step("ncf", ncf, pairs,
               torch.tensor(rng.integers(0, 5, n).astype(np.int32),
                            device=dev), r)

    # -- 2. single operations ----------------------------------------------
    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    ids = {"word": (vocab, xs[0]),
           "position": (s, torch.arange(s, device=dev).expand(b, s)),
           "segment": (2, xs[1])}
    for dtype in (torch.bfloat16, torch.float32):
        g = randn(b, s, hid, dtype=dtype)
        for kind, (rows, idx) in ids.items():
            table = randn(rows, hid).requires_grad_(True)

            def emb(table=table, idx=idx, g=g, dtype=dtype):
                out = F.embedding(idx.long(), table.to(dtype))
                return torch.autograd.grad(out, table, g)

            report(f"F.embedding backward, {kind} ids ({idx.numel()} ids "
                   f"into {rows} rows), {str(dtype)[6:]} table",
                   repeat(emb, r))

    x = randn(b * s, hid, dtype=torch.bfloat16).requires_grad_(True)
    w = randn(hid, FFN, dtype=torch.bfloat16).requires_grad_(True)
    gy = randn(b * s, FFN, dtype=torch.bfloat16)
    report(f"bf16 GEMM ({b * s} x {hid}) @ ({hid} x {FFN}): dx and dW",
           repeat(lambda: torch.autograd.grad(x @ w, (x, w), gy), r))
    h = randn(b, s, hid, dtype=torch.bfloat16).requires_grad_(True)
    gamma, beta = (randn(hid).requires_grad_(True) for _ in range(2))
    gh = randn(b, s, hid, dtype=torch.bfloat16)
    report("LayerNorm (f32 statistics, bf16 out) backward",
           repeat(lambda: torch.autograd.grad(
               _layer_norm(h, gamma, beta, 1e-12), (h, gamma, beta), gh), r))
    hd = hid // HEADS
    q, k, v = (randn(b, HEADS, s, hd, dtype=torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    bias = ((1.0 - xs[2]) * -1e9).to(torch.bfloat16)[:, None, None, :]
    go = randn(b, HEADS, s, hd, dtype=torch.bfloat16)
    report(f"flash attention forward and backward ({b}, {HEADS}, {s}, "
           f"{hd}), padding bias",
           repeat(lambda: (lambda o: (o,) + torch.autograd.grad(
               o, (q, k, v), go))(fa.flash_attention(q, k, v, bias)), r))
    logits = randn(n, 5).requires_grad_(True)
    labels = torch.tensor(rng.integers(0, 5, n), device=dev)
    report("sparse cross-entropy (log-softmax gather) backward",
           repeat(lambda: torch.autograd.grad(
               torch.log_softmax(logits, -1).gather(
                   -1, labels[:, None]).sum(), logits), r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
