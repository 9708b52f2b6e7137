#!/usr/bin/env python3
"""Where the time of one BERT-base ``do_predict`` goes on the card (the
PyTorch/CUDA port).

Builds the same BERT-base as ``chip_smoke.py`` (random weights from
``--seed``, bf16 compute), warms each serving bucket, then traces
``--reps`` predicts per bucket with ``torch.profiler`` and prints, per
bucket: the host-clock latency, the device time by kernel class (the flash
kernel, cuBLAS GEMMs, everything else) and by top kernel, and the device's
busy share of the traced window. Needs one CUDA card:

    python3 scripts/torch_serving_profile.py [--seed N] [--reps N]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import BERT_BASE, BUCKETS, make_request, smi_line  # noqa: E402


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in low:
        return "flash_attention_fwd"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "gemv",
                                  "nvjet")):
        return "gemm"
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    print(f"device: {smi_line()}", flush=True)
    init_nncontext(seed=args.seed)
    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **BERT_BASE)
    im = InferenceModel().do_load_keras(net)
    rng = np.random.default_rng(args.seed)
    for batch, seq in BUCKETS:
        x = make_request(rng, batch, seq, BERT_BASE["vocab"])
        im.do_optimize(x)
        im.do_predict(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(args.reps):
                im.do_predict(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_class, by_kernel = {}, {}
        for ev in prof.key_averages():
            if ev.device_type != DeviceType.CUDA:  # kernels, not host ops
                continue
            dev_us = ev.self_device_time_total
            cls = kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3
            by_kernel[ev.key] = (dev_us / 1e3, ev.count)
        device_ms = sum(by_class.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
        print(json.dumps({
            "bucket": [batch, seq], "reps": args.reps,
            "predict_ms": wall_ms / args.reps,
            "device_ms_per_predict": device_ms / args.reps,
            "device_busy_share": device_ms / wall_ms,
            "kernels_per_predict": sum(n for _, n in by_kernel.values())
            / args.reps,
            "device_ms_by_class": {k: v / args.reps
                                   for k, v in sorted(by_class.items())},
            "top_kernels": [{"name": k[:90], "ms_per_predict": v / args.reps,
                             "calls_per_predict": n / args.reps}
                            for k, (v, n) in top],
        }), flush=True)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
