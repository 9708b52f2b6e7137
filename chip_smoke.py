#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``analytics_zoo_tpu_torch``).

Run from the repository root on a machine with one CUDA card (an NVIDIA H100
for the numbers in PERF.md):

    python3 chip_smoke.py [--seed N]

It builds the port's CUDA kernels from ``analytics_zoo_tpu_torch/csrc`` and
then:

1. device: prints the card's name and power limit (nvidia-smi) and the
   kernels' build time;
2. kernels: holds each kernel against its plain PyTorch version on the card,
   at the serving shapes and at f32/causal/cross-length cases, printing the
   max abs error of ``out`` and ``lse`` against the stated bounds;
3. slice: serves BERT-base (12 x 768, 12 heads, vocab 30522, seq up to 512,
   bf16 compute, random weights from ``--seed``) through ``InferenceModel``:
   warms buckets (8, 128) and (32, 512), answers requests from two threads
   plus one dispatch/fetch pair, checks shapes, finiteness and row sums,
   checks that the kernel launched 12 times per forward, and checks the same
   requests with attention forced onto the kernel's plain version;
4. times: kernel (through ``flash_attention``, the call the main path
   makes, with the (batch, 1, 1, s) bf16 padding bias it passes), plain
   version, ``F.scaled_dot_product_attention`` (a yardstick only; the port
   never calls it) and the bound at the BERT-base (32, 512) attention shape,
   and the per-bucket ``do_predict`` latency over fresh requests.

The last lines are one JSON object per kernel line, the nvidia-smi line and
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
# Class probabilities of the kernel route vs the plain route through 12
# bf16 layers: each attention output can differ by about one bf16 ulp, which
# LayerNorm and the residual keep at the percent level of the hidden state.
PROB_BOUND = 2e-2

BERT_BASE = dict(vocab=30522, hidden_size=768, n_block=12, n_head=12,
                 seq_len=512, intermediate_size=3072)
BUCKETS = ((8, 128), (32, 512))
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


def check_kernels(fa, device, gen) -> float:
    """Phase 2: kernel vs plain version. Returns the max abs error of out
    at the (32, 12, 512, 64) bf16 serving shape."""
    cases = [  # (name, dtype, b, n, s_q, s_k, d, bias, causal)
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
    ]
    serve_err = None
    for name, dtype, b, n, s_q, s_k, d, bias_kind, causal in cases:
        q, k, v, bias = attn_inputs(gen, device, dtype, b, n, s_q, s_k, d,
                                    bias=bias_kind)
        scale = d ** -0.5
        out, lse = fa._flash_forward(q, k, v, bias, scale, causal)
        ref, ref_lse = fa._flash_forward_plain(q, k, v, bias, scale, causal)
        torch.cuda.synchronize()
        if out.shape != ref.shape or lse.shape != ref_lse.shape:
            fail(f"{name}: shapes {tuple(out.shape)}/{tuple(lse.shape)} vs "
                 f"{tuple(ref.shape)}/{tuple(ref_lse.shape)}")
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        bound, lse_bound = BOUNDS[dtype]
        ok = (torch.isfinite(out).all().item() and err <= bound
              and lse_err <= lse_bound)
        print(f"kernel {name}: b={b} n={n} s_q={s_q} s_k={s_k} d={d} "
              f"{str(dtype)[6:]} bias={bias_kind} causal={causal}: "
              f"max|out-plain|={err:.3e} (bound {bound:g}) "
              f"max|lse-plain|={lse_err:.3e} (bound {lse_bound:g}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"kernel case {name} disagrees with the plain version")
        if name == "serve-512":
            serve_err = err
    return serve_err


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
    serve_err = check_kernels(fa, device, gen)

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

    # -- 4. times -----------------------------------------------------------
    # the attention call of one BERT-base layer at the (32, 512) bucket:
    # contiguous (b, n, s, d) bf16 q/k/v and the (b, 1, 1, s) bf16 padding
    # bias, as MultiHeadAttention hands them to flash_attention
    b, s = BUCKETS[-1]
    heads, d = BERT_BASE["n_head"], BERT_BASE["hidden_size"] // BERT_BASE[
        "n_head"]
    q, k, v, bias = attn_inputs(gen, device, torch.bfloat16, b, heads, s, s,
                                d, bias="pad")
    scale = d ** -0.5
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, bias=bias,
                                            scale=scale), reps=50)
    plain_ms = cuda_ms(lambda: fa._flash_forward_plain(q, k, v, bias, scale,
                                                       False), reps=5)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias, scale=scale), reps=50)
    out = fa.flash_attention(q, k, v, bias=bias, scale=scale)
    # the least the call must do: read q, k, v and the bias as it receives
    # them once, write out once, and the two matmuls' flops
    flops = 2 * b * heads * s * s * (d + v.shape[-1])
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, bias, out))
    t_ops = flops / PEAK_FLOPS[torch.bfloat16] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"times: flash_attention (b={b}, n={heads}, s={s}, d={d}, bf16, "
          f"bias {tuple(bias.shape)}): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, F.scaled_dot_product_attention "
          f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms ({flops:.3e} flop "
          f"-> {t_ops:.4f} ms, {nbytes:.3e} B -> {t_bytes:.4f} ms)",
          flush=True)
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

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "analytics_zoo_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "analytics_zoo_tpu/ops/flash_attention.py:156",
        "launches": launches, "max_abs_err": serve_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
