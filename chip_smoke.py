#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Run from the repository root on a machine with one CUDA card (an NVIDIA H100
for the numbers in PERF.md):

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``analytics_zoo_tpu_torch/csrc`` (one
``nvcc`` per source, started together) and then:

1. device: prints the card's name and power limit (nvidia-smi) and the
   kernels' build time;
2. kernels: holds the forward kernel against its plain PyTorch version on
   the card, at the serving and training shapes and at f32/causal/
   cross-length cases (an odd number of q tiles with a ragged key tile at
   head dims 64 and 128, s_k 2048, causal with one live warpgroup, with
   s_q > s_k and at head dims 128 and 256, head dim 32 zero-padded, every
   bias layout), printing the max abs error of ``out`` and ``lse`` against
   the stated bounds; each bf16 case runs twice and must repeat bitwise
   (the kernel has no atomics); the plain version must walk the key tiles
   that the kernel's library reports; 2b. the same for the two backward
   kernels (dq; dk, dv and dbias) against the plain backward, at the
   BERT-base training shape, head dims 32 (zero-padded) to 256, causal with
   s_q < s_k, a per-head f32 bias with its gradient and a nonzero lse
   cotangent;
3. serving: serves BERT-base (12 x 768, 12 heads, vocab 30522, seq up to
   512, bf16 compute, random weights from ``--seed``) through
   ``InferenceModel``: warms buckets (8, 128) and (32, 512), answers
   requests from two threads plus one dispatch/fetch pair, checks shapes,
   finiteness and row sums, checks that the kernel launched 12 times per
   forward, and checks the same requests with attention forced onto the
   kernel's plain version;
3b. training: BERT-base (seq 128, bf16 compute, dropout 0, random weights
   from ``--seed``) trains 2 epochs through ``Estimator.train`` on a
   device-cached ``ArrayFeatureSet`` of randomly padded rows, then 1 more
   through ``compile``/``fit`` on the host arrays; checks that every loss is
   finite, that each train step launched exactly 12 forward, 12 dq and 12
   dk/dv kernels, that one train step on the kernel route and on the plain
   route agree, and that ``Estimator.predict`` of the trained model agrees
   with ``InferenceModel`` serving it;
4. times: the forward kernel (through ``flash_attention``, the call the
   main path makes, with the (batch, 1, 1, s) bf16 padding bias it passes;
   its device time under torch.profiler, cross-checked by CUDA events),
   ``F.scaled_dot_product_attention`` (a yardstick only; the port never
   calls it; its device time) and the bound at the three BERT-base
   attention shapes of the main path, (32, 512) and (8, 128) serving and
   (64, 128) training, and the plain version at (32, 512); the dq and dk/dv
   kernels (device time, cross-checked by events) on the operands the main
   path's backward builds at the training shape (64, 12, 128, 64), the
   whole backward wrapper, the plain backward, the autograd backward of
   ``F.scaled_dot_product_attention`` (one call for both kernels, bound by
   the host: its device time, the kernels it dispatches, five timings of
   it, and of each masked backend forced) and their bounds; the per-bucket
   ``do_predict`` latency over fresh requests; the train step's p50/p90,
   tokens/s and MFU.

The last lines are the kernels line (for each kernel, ``ms`` is its device
time under torch.profiler and ``event_ms`` CUDA-event time over
back-to-back calls; ``plain_ms`` is event time), the nvidia-smi line and
``{"ok": true, "device": {...}}``. Any failed check exits non-zero before
those lines are printed. Without a CUDA card it exits 2 and prints nothing
of the sort.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them,
# HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

# Kernel vs plain version, max abs error bounds, with their reasons:
# - bf16 out 2e-2: out is rounded to bf16 (8 significant bits, ulp 2^-8 at
#   0.5-1) and p is rounded to bf16 before p.v; tensor-core and f32-matmul
#   sums differ in order, which can flip a rounding of p or out by one ulp.
# - f32 out 1e-5, lse 1e-5: the same f32 arithmetic in another summation
#   order (d <= 256 products of O(1) terms).
# - bf16 lse 1e-3: lse stays f32 from the same bf16 operands; the margin
#   covers the summation order at |s| of a few units with room to spare.
BOUNDS = {torch.bfloat16: (2e-2, 1e-3), torch.float32: (1e-5, 1e-5)}
# Backward kernels vs the plain backward, element by element and per
# gradient: |kernel - plain| <= c * (|plain| + rms(plain)), with c by the
# dtype the gradient is formed in:
# - bf16 dq, dk, dv, c = 2^-6: each side is rounded to bf16 once, at the
#   flush; bf16 neighbours are at most 2^-7 |x| apart, so two f32 sums that
#   straddle a rounding boundary come out one ulp apart, and c allows two.
#   Before that rounding the sums differ where a bf16 rounding of p or ds
#   flips (s and dp come from tensor-core sums in another order than the
#   plain f32 matmuls), which moves one term by 2^-8 of itself: an absolute
#   shift, not one relative to the element, so the rms term (the bulk of
#   the gradient, not its peak) covers the elements near zero. At the
#   training shape |dq|, |dk| and |dv| peak at 2.5-3.4 with an rms of
#   0.18-0.19, so the bound is 2.8e-3 near zero and 1.6e-2 at |x| = 1.
# - f32 dq, dk, dv, and dbias in either dtype (an f32 column sum of the
#   unrounded ds, formed from the same exact products), c = 2^-14: the same
#   f32 arithmetic summed in another order over up to 384 keys or queries
#   (384 * 2^-24 ~ 2^-15.4), with a factor 2.7 for cancellation.
BWD_BOUNDS = {torch.bfloat16: 2.0 ** -6, torch.float32: 2.0 ** -14}
# Class probabilities of the kernel route vs the plain route through 12
# bf16 layers: each attention output can differ by about one bf16 ulp, which
# LayerNorm and the residual keep at the percent level of the hidden state.
PROB_BOUND = 2e-2
# One train step from the same parameters, kernel route vs plain route:
# - loss 2e-2: the forward differs as in PROB_BOUND;
# - parameters: the L2 norm of the difference of the updated parameters is
#   at most 5% of the L2 norm of the update. The bf16 gradients of the two
#   routes differ where a rounding in an attention output or a dS tile
#   flips (one bf16 ulp, 2^-8 relative); the bf16 accumulation of the
#   embedding gradients (8192 token rows per step) moves such differences
#   by a few ulps more. 5% is an order of magnitude above that.
STEP_LOSS_BOUND, STEP_PARAM_BOUND = 2e-2, 5e-2

BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=512, intermediate_size=3072)
BUCKETS = ((8, 128), (32, 512))
TRAIN_BERT = dict(BERT_BASE, seq_len=128)  # bench.py's BERT-base fit config
TRAIN_BATCH, TRAIN_SAMPLES, TRAIN_EPOCHS, FIT_EPOCHS = 64, 320, 2, 1
TIMED_STEPS = 20  # train steps timed in phase 4, after 3 warm-up steps
THREADS, REQUESTS_PER_THREAD = 2, 3
LATENCY_REQUESTS = 60  # sequential do_predict calls per bucket in phase 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attn_inputs(gen, device, dtype, b, n, s_q, s_k, d, bias=None):
    """Unit-normal q/k/v (b, n, s, d) and a bias of the kind named:
    ``"pad"`` is BERT's padding mask as MultiHeadAttention passes it,
    (b, 1, 1, s_k) in the compute dtype with the last keys of each sequence
    at -1e9; ``"pad-f32"`` the same in f32; ``"head"`` unit-normal
    (b, n, 1, s_k) f32 rows; ``"key1"`` one unit-normal f32 value per batch,
    (b, 1, 1, 1); None no bias."""
    q, k, v = (torch.randn((b, n, s, d), generator=gen).to(device, dtype)
               for s in (s_q, s_k, s_k))
    if bias in ("pad", "pad-f32"):
        lens = torch.randint(s_k // 4, s_k + 1, (b,), generator=gen)
        m = (torch.arange(s_k)[None, :] < lens[:, None]).float()
        mask = ((1.0 - m) * -1e9)[:, None, None, :]
        return q, k, v, mask.to(device,
                                dtype if bias == "pad" else torch.float32)
    shape = {"head": (b, n, 1, s_k), "key1": (b, 1, 1, 1), None: None}[bias]
    return q, k, v, (None if shape is None else
                     torch.randn(shape, generator=gen).to(device))


# Phase 2's forward cases: (name, dtype, b, n, s_q, s_k, d, bias, causal)
FWD_CASES = [
    ("serve-128", torch.bfloat16, 8, 12, 128, 128, 64, "pad", False),
    ("serve-512", torch.bfloat16, 32, 12, 512, 512, 64, "pad", False),
    ("bf16-d128", torch.bfloat16, 2, 12, 256, 256, 128, "pad", False),
    ("bf16-d256", torch.bfloat16, 2, 12, 256, 256, 256, None, False),
    ("bf16-f32-bias", torch.bfloat16, 2, 12, 256, 256, 64, "pad-f32",
     False),
    ("bf16-head-bias", torch.bfloat16, 2, 12, 256, 256, 64, "head",
     False),
    ("f32-d64", torch.float32, 2, 12, 256, 256, 64, None, False),
    ("f32-d256", torch.float32, 2, 12, 256, 256, 256, None, False),
    ("f32-d32-padded", torch.float32, 2, 12, 128, 128, 32, "pad", False),
    ("f32-key1-bias", torch.float32, 2, 12, 128, 128, 64, "key1", False),
    ("bf16-causal", torch.bfloat16, 2, 12, 128, 384, 64, None, True),
    ("f32-causal", torch.float32, 2, 12, 128, 384, 64, "pad", True),
    ("bf16-causal-sq", torch.bfloat16, 2, 12, 256, 256, 64, "head",
     True),
    # an odd number of 64-row q tiles (the last CTA's second warpgroup
    # has no rows) and a ragged last key tile
    ("bf16-ragged", torch.bfloat16, 2, 12, 192, 320, 64, "pad", False),
    # the K/V rings wrap many times: mbarrier parity faults show here
    ("bf16-ring-2048", torch.bfloat16, 2, 12, 256, 2048, 64, "pad",
     False),
    # one CTA whose only live warpgroup is the first
    ("bf16-causal-64", torch.bfloat16, 2, 12, 64, 384, 64, None, True),
    ("bf16-causal-d128", torch.bfloat16, 2, 12, 256, 320, 128, "pad",
     True),
    ("bf16-causal-d256", torch.bfloat16, 2, 12, 192, 256, 256, None,
     True),
    ("bf16-key1-bias", torch.bfloat16, 2, 12, 128, 192, 64, "key1",
     False),
]
# Forward cases checked after phase 2b, so that they leave the inputs that
# 2b draws as they are: on other draws 2b's bf16 causal head-bias case can
# exceed its bound where kernel and plain round one dominant ds term to
# neighbouring bf16 values, each as close to the exact gradient as the
# other (PERF.md, open questions)
FWD_CASES_AFTER_BWD = [
    ("train-128", torch.bfloat16, 64, 12, 128, 128, 64, "pad", False),
    # fully masked rows: the first s_q - s_k queries see no key
    ("bf16-causal-sq-gt-sk", torch.bfloat16, 2, 12, 384, 192, 64, "pad",
     True),
    ("bf16-d128-ragged", torch.bfloat16, 2, 12, 192, 320, 128, "pad",
     False),
    ("bf16-d32-padded", torch.bfloat16, 2, 12, 128, 192, 32, "pad",
     False),
    ("f32-d256-causal", torch.float32, 2, 12, 128, 256, 256, "head",
     True),
]


def check_key_tiles(fa) -> None:
    """The plain forward walks the key tiles that the kernel's library
    reports for each bf16 head dim."""
    from analytics_zoo_tpu_torch.ops import _kernels

    lib = _kernels.load("flash_attention_fwd")
    for d in fa.HEAD_DIMS:
        tile = lib.azoo_flash_attention_fwd_bf16_block_k(d)
        plain = fa._fwd_block_k(torch.bfloat16, d, d)
        print(f"kernel key tile at head dim {d}: {tile} (plain {plain})",
              flush=True)
        if tile != plain:
            fail(f"head dim {d}: the kernel's key tile is {tile}, the plain "
                 f"version's {plain}")


def check_kernels(fa, device, gen, cases):
    """Phase 2: kernel vs plain version over ``cases``. Returns the max abs
    error of out at the (32, 12, 512, 64) bf16 serving shape, if a case."""
    serve_err = None
    for case in cases:
        ok, err = check_forward_case(fa, device, gen, case)
        if not ok:
            fail(f"kernel case {case[0]} disagrees with the plain version")
        if case[0] == "serve-512":
            serve_err = err
    return serve_err


def check_forward_case(fa, device, gen, case):
    """One forward case ``(name, dtype, b, n, s_q, s_k, d, bias, causal)``:
    the kernel against the plain version, a bf16 case twice and bitwise
    equal. Prints a line; returns (ok, max abs error of out)."""
    name, dtype, b, n, s_q, s_k, d, bias_kind, causal = case
    q, k, v, bias = attn_inputs(gen, device, dtype, b, n, s_q, s_k, d,
                                bias=bias_kind)
    scale = d ** -0.5
    out, lse = fa._flash_forward(q, k, v, bias, scale, causal)
    ref, ref_lse = fa._flash_forward_plain(q, k, v, bias, scale, causal)
    # the kernel has no atomics: a second call that differs is a race
    again = (fa._flash_forward(q, k, v, bias, scale, causal)
             if dtype == torch.bfloat16 else (out, lse))
    torch.cuda.synchronize()
    if out.shape != ref.shape or lse.shape != ref_lse.shape:
        fail(f"{name}: shapes {tuple(out.shape)}/{tuple(lse.shape)} vs "
             f"{tuple(ref.shape)}/{tuple(ref_lse.shape)}")
    err = (out.float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
    repeat = ("" if dtype != torch.bfloat16 else
              ", two calls bitwise equal" if same else ", two calls DIFFER")
    bound, lse_bound = BOUNDS[dtype]
    ok = bool(torch.isfinite(out).all().item() and err <= bound
              and lse_err <= lse_bound and same)
    print(f"kernel {name}: b={b} n={n} s_q={s_q} s_k={s_k} d={d} "
          f"{str(dtype)[6:]} bias={bias_kind} causal={causal}: "
          f"max|out-plain|={err:.3e} (bound {bound:g}) "
          f"max|lse-plain|={lse_err:.3e} (bound {lse_bound:g}){repeat} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    return ok, err


def check_backward_kernels(fa, device, gen):
    """Phase 2b: the dq and dk/dv/dbias kernels vs the plain backward, on
    the same forward outputs and the same output gradients. Returns
    ``(dq error, dk/dv error)`` at the BERT-base training shape."""
    cases = [  # (name, dtype, b, n, s_q, s_k, d, bias, causal, lse grad)
        ("train-128", torch.bfloat16, 64, 12, 128, 128, 64, "pad", False,
         False),
        ("bf16-d128", torch.bfloat16, 2, 12, 256, 256, 128, "pad", False,
         False),
        ("bf16-d256", torch.bfloat16, 2, 12, 256, 256, 256, None, False,
         False),
        ("f32-d64", torch.float32, 2, 12, 256, 256, 64, "pad-f32", False,
         False),
        ("f32-d256", torch.float32, 2, 12, 256, 256, 256, None, False,
         False),
        ("f32-d32-padded", torch.float32, 2, 12, 128, 128, 32, "pad", False,
         False),
        ("bf16-causal", torch.bfloat16, 2, 12, 128, 384, 64, None, True,
         False),
        ("f32-causal", torch.float32, 2, 12, 128, 384, 64, "pad", True,
         False),
        ("f32-head-dbias", torch.float32, 2, 12, 256, 256, 64, "head", False,
         False),
        ("bf16-head-dbias", torch.bfloat16, 2, 12, 256, 256, 128, "head",
         True, False),
        ("bf16-lse-grad", torch.bfloat16, 2, 12, 256, 256, 64, None, True,
         True),
        ("f32-lse-grad", torch.float32, 2, 12, 128, 256, 64, None, True,
         True),
    ]
    train_err = None
    for (name, dtype, b, n, s_q, s_k, d, bias_kind, causal,
         lse_grad) in cases:
        q, k, v, bias = attn_inputs(gen, device, dtype, b, n, s_q, s_k, d,
                                    bias=bias_kind)
        scale = d ** -0.5
        out, lse = fa._flash_forward(q, k, v, bias, scale, causal)
        g = torch.randn(out.shape, generator=gen).to(device, dtype)
        g_lse = (torch.randn(lse.shape, generator=gen).to(device)
                 if lse_grad else None)
        need_dbias = bias_kind == "head"
        args = (q, k, v, bias, out, lse, g, scale, causal, g_lse, need_dbias)
        got = fa._flash_backward(*args)
        ref = fa._flash_backward_plain(*args)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for gname, a, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
            if r is None:
                continue
            if a.shape != r.shape or a.dtype != r.dtype:
                fail(f"{name}: {gname} {tuple(a.shape)} {a.dtype} vs "
                     f"{tuple(r.shape)} {r.dtype}")
            a, r = a.float(), r.float()
            c = BWD_BOUNDS[torch.float32 if gname == "dbias" else dtype]
            rms = r.square().mean().sqrt().item()
            diff = (a - r).abs()
            share = (diff / (c * (r.abs() + rms))).max().item()
            errs[gname] = err = diff.max().item()
            ok = ok and bool(torch.isfinite(a).all().item()) and share <= 1.0
            print(f"kernel-bwd {name}: {gname} max|kernel-plain|={err:.3e}; "
                  f"|plain| max {r.abs().max().item():.3e} rms {rms:.3e}; "
                  f"bound {c:.3e} * (|plain| + rms), largest share of it "
                  f"{share:.3f}", flush=True)
        print(f"kernel-bwd {name}: b={b} n={n} s_q={s_q} s_k={s_k} d={d} "
              f"{str(dtype)[6:]} bias={bias_kind} causal={causal} "
              f"lse_grad={lse_grad}: {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"backward kernel case {name} disagrees with the plain "
                 f"version")
        if name == "train-128":
            train_err = (errs["dq"], max(errs["dk"], errs["dv"]))
    return train_err


def make_request(rng, batch, seq, vocab):
    """Token ids with per-row padding lengths, two segments, float mask."""
    lens = rng.integers(max(1, seq // 8), seq + 1, batch)
    pos = np.arange(seq)[None, :]
    mask = (pos < lens[:, None]).astype(np.float32)
    ids = (rng.integers(1, vocab, (batch, seq)) * mask).astype(np.int32)
    types = ((pos >= lens[:, None] // 2) * mask).astype(np.int32)
    return [ids, types, mask]


def serve_slice(im, requests, n_threads):
    """Phase 3's traffic: warm every bucket, answer the requests from
    ``n_threads`` threads through do_predict, then one dispatch/fetch pair.
    Returns (outputs in request order, dispatch output, forwards run)."""
    forwards = 0
    for reqs in requests.values():
        im.do_optimize(reqs[0])
        forwards += 1
    flat = [r for reqs in requests.values() for r in reqs]
    outputs = [None] * len(flat)
    errors = []

    def worker(idx):
        try:
            for i in idx:
                outputs[i] = im.do_predict(flat[i])
        except Exception as e:  # reported after join
            errors.append(e)

    threads = [threading.Thread(target=worker,
                                args=(range(t, len(flat), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        fail("a serving thread did not finish")
    if errors:
        raise errors[0]
    forwards += len(flat)
    dispatched = im.do_fetch(im.do_dispatch(flat[-1]))
    forwards += 1
    return outputs, dispatched, forwards


def check_outputs(outputs, flat, dispatched, num_classes):
    for out, req in zip(outputs, flat):
        b = req[0].shape[0]
        if out.shape != (b, num_classes) or out.dtype != np.float32:
            fail(f"output {out.shape} {out.dtype}, want ({b}, "
                 f"{num_classes}) float32")
        if not np.isfinite(out).all():
            fail("non-finite probabilities")
        if np.abs(out.sum(-1) - 1.0).max() > 1e-5:
            fail(f"row sums {out.sum(-1)}")
    if not np.array_equal(dispatched, outputs[-1]):
        fail("do_dispatch/do_fetch differs from do_predict on one request")


def bert_train_flops(batch: int, seq: int, n_block: int,
                     hidden: int) -> float:
    """Training FLOPs per step, as bench.py counts them: 3x forward;
    forward per token = 2 * 12*L*h^2 (qkv/proj/mlp matmuls) + 4*S*h*L
    (QK^T and AV)."""
    per_token = (2.0 * 12 * n_block * hidden * hidden
                 + 4.0 * seq * hidden * n_block)
    return 3.0 * batch * seq * per_token


def train_slice(fa, rng):
    """Phase 3b: BERT-base trains through Estimator.train (device cache)
    and compile/fit (host arrays), and serves the trained model. Returns
    (net, cached set, train steps, the launches of each kernel in the
    run)."""
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxEpoch
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    t0 = time.perf_counter()
    x = make_request(rng, TRAIN_SAMPLES, TRAIN_BERT["seq_len"],
                     TRAIN_BERT["vocab"])
    y = rng.integers(0, 2, TRAIN_SAMPLES).astype(np.int32)
    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **TRAIN_BERT)
    net.ensure_params()
    cached = ArrayFeatureSet(x, y).cache_device()
    print(f"train: BERT-base (seq {TRAIN_BERT['seq_len']}) built, "
          f"{TRAIN_SAMPLES} rows cached in {time.perf_counter() - t0:.1f} s",
          flush=True)
    counters = (fa.launches, fa.launches_dq, fa.launches_dkv)
    for c in counters:  # the main path's run starts here
        c.reset()
    t0 = time.perf_counter()
    est = Estimator(net, SGD(lr=0.01, momentum=0.9))
    est.train(cached, objectives.sparse_categorical_crossentropy,
              end_trigger=MaxEpoch(TRAIN_EPOCHS), batch_size=TRAIN_BATCH)
    net.compile(SGD(lr=0.01, momentum=0.9),
                "sparse_categorical_crossentropy", ["accuracy"])
    net.fit(x, y, batch_size=TRAIN_BATCH, nb_epoch=FIT_EPOCHS)
    torch.cuda.synchronize()
    launches = [c.count for c in counters]  # ... and ends here
    wall = time.perf_counter() - t0
    losses = est.train_losses + net._estimator.train_losses
    steps = len(losses)
    want_steps = (TRAIN_EPOCHS + FIT_EPOCHS) * -(-TRAIN_SAMPLES
                                                 // TRAIN_BATCH)
    print(f"train: {steps} steps ({TRAIN_EPOCHS} epochs Estimator.train + "
          f"{FIT_EPOCHS} fit) in {wall:.1f} s; losses "
          f"{[round(v, 4) for v in losses]}", flush=True)
    if steps != want_steps or not all(np.isfinite(losses)):
        fail(f"training ran {steps} steps (want {want_steps}) or a loss is "
             f"not finite")
    n_block = TRAIN_BERT["n_block"]
    print(f"train: launches forward {launches[0]}, dq {launches[1]}, dk/dv "
          f"{launches[2]} (want {n_block} x {steps} = {n_block * steps} "
          f"each)", flush=True)
    if any(n != n_block * steps for n in launches):
        fail("a train step did not launch each attention kernel once per "
             "layer")

    rows = [a[:TRAIN_BATCH] for a in x]
    pred = net.predict(rows, batch_size=TRAIN_BATCH)
    served = InferenceModel().do_load_keras(net).do_predict(rows)
    diff = float(np.abs(pred - served).max())
    print(f"train: max |Estimator.predict - InferenceModel.do_predict| = "
          f"{diff:.3e} (bound {PROB_BOUND:g}) over {TRAIN_BATCH} rows",
          flush=True)
    if pred.shape != (TRAIN_BATCH, 2) or not diff <= PROB_BOUND:
        fail("the trained model serves other probabilities than it "
             "predicts")
    return net, cached, steps, launches


def check_step_routes(fa, net, cached):
    """One train step from the same parameters on the kernel route and on
    the plain route: losses and updated parameters agree."""
    from analytics_zoo_tpu_torch.common.tree import tree_leaves
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.engine.triggers import MaxIteration
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    start = net.params

    def one_step():
        net.params = start
        est = Estimator(net, SGD(lr=0.01, momentum=0.9))
        est.train(cached, objectives.sparse_categorical_crossentropy,
                  end_trigger=MaxIteration(1), batch_size=TRAIN_BATCH)
        return est.train_losses[0], tree_leaves(est.tstate.params)

    loss_k, params_k = one_step()
    kernels = fa._flash_forward, fa._flash_backward
    fa._flash_forward = fa._flash_forward_plain  # route onto the plain
    fa._flash_backward = fa._flash_backward_plain  # versions
    try:
        loss_p, params_p = one_step()
    finally:
        fa._flash_forward, fa._flash_backward = kernels
    net.params = start
    diff = torch.sqrt(sum(((a - b) ** 2).sum()
                          for a, b in zip(params_k, params_p)))
    update = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(
        params_k, tree_leaves(start))))
    rel = (diff / update).item()
    max_abs = max((a - b).abs().max().item()
                  for a, b in zip(params_k, params_p))
    print(f"train: one step kernel route vs plain route: loss {loss_k:.6f} "
          f"vs {loss_p:.6f} (bound {STEP_LOSS_BOUND:g}); |params diff|_2 / "
          f"|update|_2 = {rel:.3e} (bound {STEP_PARAM_BOUND:g}), max "
          f"|diff| {max_abs:.3e}", flush=True)
    if not (abs(loss_k - loss_p) <= STEP_LOSS_BOUND
            and rel <= STEP_PARAM_BOUND):
        fail("kernel route and plain route disagree on a train step")


def device_ms(fn, calls: int = 20):
    """Device time of one ``fn()``: the summed durations of the kernels and
    memsets that ``calls`` back-to-back calls run on the card (under
    torch.profiler), over ``calls``; and their names. Unlike ``cuda_ms`` it
    leaves out the gaps in which the card waits on the host."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        fail("torch.profiler recorded no device time")
    us = sum(e.self_device_time_total for e in events)
    return us / calls / 1e3, sorted(e.key for e in events)


def forward_bound(q, k, v, bias, out):
    """The least time the card could take for one bf16 forward: read q, k,
    v and the bias as the call receives them once, write out once, and the
    two matmuls' flops. Returns (ms, "bytes" or "operations", flops, bytes,
    ms by operations, ms by bytes)."""
    b, heads, s_q, d = q.shape
    flops = 2 * b * heads * s_q * k.shape[2] * (d + v.shape[-1])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, bias, out))
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops
            else "operations", flops, nbytes, t_ops, t_bytes)


def time_forward(fa, device, gen):
    """The forward kernel through ``flash_attention`` (the call the main
    path makes) at the main path's attention calls, as MultiHeadAttention
    hands them over, with the (batch, 1, 1, seq) bf16 padding bias: the
    (32, 512) serving bucket (the one the kernels line reports), the
    training batch and the (8, 128) bucket. At each: its device time (under
    torch.profiler, the time the card spends in it) cross-checked by CUDA
    events over back-to-back calls, ``F.scaled_dot_product_attention``'s
    (a yardstick only; the port never calls it) and the bound; the plain
    version's at the first. Returns one dict per shape."""
    heads = BERT_BASE["n_head"]
    d = BERT_BASE["hidden_size"] // heads
    shapes = [BUCKETS[-1], (TRAIN_BATCH, TRAIN_BERT["seq_len"]), BUCKETS[0]]
    rows = []
    for b, s in shapes:
        q, k, v, bias = attn_inputs(gen, device, torch.bfloat16, b, heads, s,
                                    s, d, bias="pad")
        scale = d ** -0.5
        call = lambda: fa.flash_attention(  # noqa: E731
            q, k, v, bias=bias, scale=scale)
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=bias, scale=scale)
        r = {"shape": [b, heads, s, s, d], "ms": device_ms(call, calls=50)[0],
             "event_ms": cuda_ms(call, reps=50)}
        r["library_ms"], library_kernels = device_ms(library, calls=50)
        r["library_event_ms"] = cuda_ms(library, reps=50)
        if not rows:
            r["plain_ms"] = cuda_ms(lambda: fa._flash_forward_plain(
                q, k, v, bias, scale, False), reps=5)
        r["bound_ms"], r["bound_by"], flops, nbytes, t_ops, t_bytes = \
            forward_bound(q, k, v, bias, call())
        plain = (f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r
                 else "")
        print(f"times: flash_attention (b={b}, n={heads}, s={s}, d={d}, "
              f"bf16, bias {tuple(bias.shape)}): kernel device "
              f"{r['ms']:.4f} ms (event {r['event_ms']:.4f} ms){plain}, "
              f"F.scaled_dot_product_attention device "
              f"{r['library_ms']:.4f} ms (event "
              f"{r['library_event_ms']:.4f} ms; kernels {library_kernels}); "
              f"bound {r['bound_ms']:.4f} ms ({flops:.3e} flop -> "
              f"{t_ops:.4f} ms, {nbytes:.3e} B -> {t_bytes:.4f} ms)",
              flush=True)
        rows.append(r)
    return rows


def time_library_backward(q, k, v, bias, g, scale, repeats: int = 5) -> float:
    """The library yardstick for the backward pair: the autograd backward of
    ``F.scaled_dot_product_attention`` with the padding bias as
    ``attn_mask`` (one call computes dq, dk and dv). The call is bound by
    the host (autograd and backend dispatch take longer than its kernels),
    so CUDA events around back-to-back calls time the host; the yardstick
    is its device time (:func:`device_ms`). Prints the kernels of the
    default dispatch (the backend it picked), ``repeats`` device times and
    event times of it, and the device times of each masked backend forced;
    returns the median device time of the default dispatch."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def backward_fn():
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        out = F.scaled_dot_product_attention(ql, kl, vl, attn_mask=bias,
                                             scale=scale)
        return lambda: torch.autograd.grad(out, (ql, kl, vl), g,
                                           retain_graph=True)

    default = backward_fn()
    dev, names = zip(*(device_ms(default) for _ in range(repeats)))
    wall = [cuda_ms(default, reps=20) for _ in range(repeats)]
    print(f"times: library backward, default dispatch, kernels: "
          f"{names[0]}", flush=True)
    print(f"times: library backward, default dispatch, {repeats} x 20 calls: "
          f"device ms {[round(t, 4) for t in dev]}, event ms "
          f"{[round(t, 4) for t in wall]}", flush=True)
    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        try:  # a yardstick only: a backend that refuses the mask is named
            with sdpa_kernel([backend]):
                fn = backward_fn()
        except RuntimeError as e:
            print(f"times: library backward, {backend.name}: not available "
                  f"({str(e).splitlines()[0][:120]})", flush=True)
            continue
        forced = [device_ms(fn)[0] for _ in range(repeats)]
        print(f"times: library backward, {backend.name} forced, {repeats} x "
              f"20 calls: device ms {[round(t, 4) for t in forced]}",
              flush=True)
    return float(np.median(dev))


def time_backward(fa, device, gen):
    """The backward kernels at the BERT-base training attention shape, on
    the operands the main path's backward wrapper builds. Returns a dict of
    ms and bounds."""
    b, s = TRAIN_BATCH, TRAIN_BERT["seq_len"]
    heads = TRAIN_BERT["n_head"]
    d = TRAIN_BERT["hidden_size"] // heads
    q, k, v, bias = attn_inputs(gen, device, torch.bfloat16, b, heads, s, s,
                                d, bias="pad")
    scale = d ** -0.5
    out, lse = fa._flash_forward(q, k, v, bias, scale, False)
    g = torch.randn(out.shape, generator=gen).to(device, torch.bfloat16)
    ops = fa._BackwardOperands(q, k, v, bias, out, lse, g, scale, False,
                               None, False)
    pb = fa._PlainBackward(q, k, v, bias, out, lse, g, scale, False, None)
    r = {
        "dq_ms": device_ms(ops.launch_dq, calls=50)[0],
        "dkv_ms": device_ms(ops.launch_dkv, calls=50)[0],
        "dq_event_ms": cuda_ms(ops.launch_dq, reps=50),
        "dkv_event_ms": cuda_ms(ops.launch_dkv, reps=50),
        "wrapper_ms": cuda_ms(lambda: fa._flash_backward(
            q, k, v, bias, out, lse, g, scale, False), reps=50),
        "dq_plain_ms": cuda_ms(lambda: fa._dq_plain(pb), reps=5),
        "dkv_plain_ms": cuda_ms(lambda: fa._dkv_plain(pb, False), reps=5),
    }
    r["library_ms"] = time_library_backward(q, k, v, bias, g, scale)
    # the least each kernel must do: read its inputs as it receives them
    # once, write its outputs once; 2 s_q s_k d flop per product
    reads = sum(t.numel() * t.element_size()
                for t in (q, k, v, g, lse, ops.delta, bias))
    prod = 2 * b * heads * s * s * d
    for name, n_prod, outs in (("dq", 3, (q,)), ("dkv", 4, (k, v))):
        nbytes = reads + sum(t.numel() * t.element_size() for t in outs)
        t_ops = n_prod * prod / PEAK_FLOPS[torch.bfloat16] * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        r[f"{name}_bound_ms"] = max(t_ops, t_bytes)
        r[f"{name}_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        print(f"times: {name} kernel (b={b}, n={heads}, s={s}, d={d}, bf16, "
              f"bias {tuple(bias.shape)}): device {r[f'{name}_ms']:.4f} ms "
              f"(event {r[f'{name}_event_ms']:.4f} ms), plain "
              f"{r[f'{name}_plain_ms']:.4f} ms; bound "
              f"{r[f'{name}_bound_ms']:.4f} ms ({n_prod * prod:.3e} flop -> "
              f"{t_ops:.4f} ms, {nbytes:.3e} B -> {t_bytes:.4f} ms)",
              flush=True)
    print(f"times: backward wrapper (delta + dq + dk/dv) {r['wrapper_ms']:.4f}"
          f" ms (event); dq + dk/dv kernels {r['dq_ms'] + r['dkv_ms']:.4f} "
          f"ms (device); "
          f"autograd backward of F.scaled_dot_product_attention (one call "
          f"for both kernels, median device time) {r['library_ms']:.4f} ms",
          flush=True)
    return r


def time_train_steps(net, cached):
    """The Estimator's own train step on the cached batches: host clock
    around each step, synchronised. Returns (p50 ms, p90 ms)."""
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD

    est = Estimator(net, SGD(lr=0.01, momentum=0.9))
    est._ensure_state()
    step = est._make_train_step(objectives.sparse_categorical_crossentropy)
    batches = list(est._batches(cached, TRAIN_BATCH, 0))
    lat = []
    for i in range(3 + TIMED_STEPS):
        xs, y, mask = batches[i % len(batches)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est.tstate, _ = step(est.tstate, xs, y, mask)
        torch.cuda.synchronize()
        if i >= 3:
            lat.append((time.perf_counter() - t0) * 1e3)
    p10, p50, p90 = np.percentile(lat, (10, 50, 90))
    seq = TRAIN_BERT["seq_len"]
    flops = bert_train_flops(TRAIN_BATCH, seq, TRAIN_BERT["n_block"],
                             TRAIN_BERT["hidden_size"])
    mfu = flops / (p50 / 1e3) / PEAK_FLOPS[torch.bfloat16]
    print(f"times: train step (batch {TRAIN_BATCH}, seq {seq}) over "
          f"{len(lat)} steps: p50 {p50:.3f} ms, p90 {p90:.3f} ms, p10 "
          f"{p10:.3f} ms, (p90-p10)/p50 {(p90 - p10) / p50:.3f}; "
          f"{TRAIN_BATCH * seq / (p50 / 1e3):.1f} tokens/s; "
          f"{flops:.3e} flop/step -> MFU {mfu:.4f} of 989 TFLOP/s bf16",
          flush=True)
    return p50, p90


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test needs a "
              "CUDA card", file=sys.stderr)
        return 2

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops import flash_attention as fa
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    # -- 1. device ---------------------------------------------------------
    smi = smi_line()
    print(f"device: {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}",
          flush=True)
    t0 = time.perf_counter()
    logs = _kernels.build(_kernels.KERNELS)
    print(f"build: {len(_kernels.KERNELS)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    ctx = init_nncontext(seed=args.seed)
    device = ctx.device
    gen = torch.Generator().manual_seed(args.seed)

    # -- 2. kernels vs plain versions --------------------------------------
    check_key_tiles(fa)
    serve_err = check_kernels(fa, device, gen, FWD_CASES)
    dq_err, dkv_err = check_backward_kernels(fa, device, gen)
    check_kernels(fa, device, gen, FWD_CASES_AFTER_BWD)

    # -- 3. the slice: BERT-base served through InferenceModel -------------
    t0 = time.perf_counter()
    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **BERT_BASE)
    im = InferenceModel().do_load_keras(net)
    print(f"slice: BERT-base built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(args.seed)
    requests = {bs: [make_request(rng, bs[0], bs[1], BERT_BASE["vocab"])
                     for _ in range(THREADS * REQUESTS_PER_THREAD)]
                for bs in BUCKETS}
    flat = [r for reqs in requests.values() for r in reqs]

    fa.launches.reset()  # the main path's run starts here
    outputs, dispatched, forwards = serve_slice(im, requests, THREADS)
    torch.cuda.synchronize()
    launches = fa.launches.count  # ... and ends here
    n_block = BERT_BASE["n_block"]
    print(f"slice: {forwards} forwards, flash kernel launches {launches} "
          f"(want {n_block} x {forwards} = {n_block * forwards})", flush=True)
    if launches == 0 or launches != n_block * forwards:
        fail("the main path did not run the flash kernel once per layer")
    check_outputs(outputs, flat, dispatched, 2)

    kernel_fwd = fa._flash_forward
    fa._flash_forward = fa._flash_forward_plain  # route onto the plain version
    try:
        plain_outputs = [im.do_predict(r) for r in flat]
    finally:
        fa._flash_forward = kernel_fwd
    diff = max(np.abs(a - b).max() for a, b in zip(outputs, plain_outputs))
    print(f"slice: max |p(kernel route) - p(plain route)| = {diff:.3e} "
          f"(bound {PROB_BOUND:g}) over {len(flat)} requests", flush=True)
    if not diff <= PROB_BOUND:
        fail("kernel route and plain route disagree")

    # -- 3b. the slice: BERT-base trained through Estimator.train and fit --
    train_net, cached, _, train_launches = train_slice(fa, rng)
    check_step_routes(fa, train_net, cached)

    # -- 4. times -----------------------------------------------------------
    fwd = time_forward(fa, device, gen)
    for batch, seq in BUCKETS:
        lat = []
        for _ in range(LATENCY_REQUESTS):  # fresh padding lengths each
            r = make_request(rng, batch, seq, BERT_BASE["vocab"])
            t0 = time.perf_counter()
            im.do_predict(r)
            lat.append((time.perf_counter() - t0) * 1e3)
        p10, p50, p90 = np.percentile(lat, (10, 50, 90))
        print(f"times: do_predict bucket ({batch}, {seq}) over {len(lat)} "
              f"sequential requests: p50 {p50:.3f} ms, p90 {p90:.3f} ms, "
              f"p10 {p10:.3f} ms, min {min(lat):.3f} ms, max "
              f"{max(lat):.3f} ms, (p90-p10)/p50 {(p90 - p10) / p50:.3f}",
              flush=True)

    bwd = time_backward(fa, device, gen)
    time_train_steps(train_net, cached)

    bwd_src = "analytics_zoo_tpu_torch/csrc/flash_attention_bwd.cu"
    bwd_pair = ["flash_attention_bwd_dq", "flash_attention_bwd_dkv"]
    serve = fwd[0]
    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:156",
        # the serving path's run and the training path's run
        "launches": launches + train_launches[0], "max_abs_err": serve_err,
        # device times at the (32, 512) serving shape; every main-path
        # shape, the training one included, under "shapes"
        "ms": serve["ms"], "event_ms": serve["event_ms"],
        "plain_ms": serve["plain_ms"],
        "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
        "library_ms": serve["library_ms"],
        "shapes": [{key: r[key] for key in (
            "shape", "ms", "event_ms", "library_ms", "bound_ms", "bound_by")}
            for r in fwd],
    }, {
        "name": "flash_attention_bwd_dq", "route": "cuda", "source": bwd_src,
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:323",
        "launches": train_launches[1], "max_abs_err": dq_err,
        "ms": bwd["dq_ms"], "event_ms": bwd["dq_event_ms"],
        "plain_ms": bwd["dq_plain_ms"],
        "bound_ms": bwd["dq_bound_ms"], "bound_by": bwd["dq_bound_by"],
        # one autograd call computes dq, dk and dv together: it is the
        # yardstick of the pair, to set beside the sum of both kernels' ms
        "library_ms": bwd["library_ms"], "library_covers": bwd_pair,
    }, {
        "name": "flash_attention_bwd_dkv", "route": "cuda", "source": bwd_src,
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:369",
        "launches": train_launches[2], "max_abs_err": dkv_err,
        "ms": bwd["dkv_ms"], "event_ms": bwd["dkv_event_ms"],
        "plain_ms": bwd["dkv_plain_ms"],
        "bound_ms": bwd["dkv_bound_ms"], "bound_by": bwd["dkv_bound_by"],
        "library_ms": bwd["library_ms"], "library_covers": bwd_pair,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
