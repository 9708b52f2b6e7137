#!/usr/bin/env python3
"""Where the time of one BERT-base ``do_predict``, or of one train step,
goes on the card (the PyTorch/CUDA port).

Builds the same BERT-base as ``chip_smoke.py`` (random weights from
``--seed``, bf16 compute). Serving (the default): warms each serving
bucket, then traces ``--reps`` predicts per bucket. ``--train``: takes 3
warm-up steps of the Estimator's train step at batch 64, seq 128 (the
training slice's shape), then traces ``--reps`` steps. Both trace with
``torch.profiler`` and print the host-clock time per call, the device time
by kernel class (the flash kernels, cuBLAS GEMMs, everything else) and by
top kernel, and the device's busy share of the traced window. Needs one
CUDA card:

    python3 scripts/torch_serving_profile.py [--seed N] [--reps N] [--train]
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

from chip_smoke import (  # noqa: E402
    BERT_BASE,
    BUCKETS,
    TRAIN_BATCH,
    TRAIN_BERT,
    make_request,
    smi_line,
)


def kernel_class(name: str) -> str:
    low = name.lower()
    if "flash_fwd_wgmma" in low or "flash_fwd_f32" in low:
        return "flash_attention_fwd"
    if "flash_bwd_dq_" in low:  # the wgmma kernel or the first version
        return "flash_attention_bwd_dq"
    if "flash_bwd_dkv_" in low:
        return "flash_attention_bwd_dkv"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "gemv",
                                  "nvjet")):
        return "gemm"
    return "other"


def profile_calls(label, call, reps: int) -> dict:
    """Trace ``reps`` calls of ``call`` (each ending in a synchronise) and
    summarise the device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
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
    return {
        **label, "reps": reps,
        "call_ms": wall_ms / reps,
        "device_ms_per_call": device_ms / reps,
        "device_busy_share": device_ms / wall_ms,
        "kernels_per_call": sum(n for _, n in by_kernel.values()) / reps,
        "device_ms_by_class": {k: v / reps
                               for k, v in sorted(by_class.items())},
        "top_kernels": [{"name": k[:90], "ms_per_call": v / reps,
                         "calls_per_call": n / reps}
                        for k, (v, n) in top],
    }


def profile_serving(args) -> None:
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **BERT_BASE)
    im = InferenceModel().do_load_keras(net)
    rng = np.random.default_rng(args.seed)
    for batch, seq in BUCKETS:
        x = make_request(rng, batch, seq, BERT_BASE["vocab"])
        im.do_optimize(x)
        im.do_predict(x)
        print(json.dumps(profile_calls({"bucket": [batch, seq]},
                                       lambda: im.do_predict(x),
                                       args.reps)), flush=True)


def profile_training(args) -> None:
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras import objectives
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    rng = np.random.default_rng(args.seed)
    seq = TRAIN_BERT["seq_len"]
    x = make_request(rng, TRAIN_BATCH, seq, TRAIN_BERT["vocab"])
    y = rng.integers(0, 2, TRAIN_BATCH).astype(np.int32)
    net = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                            **TRAIN_BERT)
    est = Estimator(net, SGD(lr=0.01, momentum=0.9))
    est._ensure_state()
    step = est._make_train_step(objectives.sparse_categorical_crossentropy)
    xs, yb, mask = next(est._batches(ArrayFeatureSet(x, y).cache_device(),
                                     TRAIN_BATCH, 0))

    def one_step():
        est.tstate, _ = step(est.tstate, xs, yb, mask)
        torch.cuda.synchronize()

    for _ in range(3):
        one_step()
    print(json.dumps(profile_calls({"train_step": [TRAIN_BATCH, seq]},
                                   one_step, args.reps)), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--train", action="store_true",
                    help="profile train steps instead of predicts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext

    print(f"device: {smi_line()}", flush=True)
    init_nncontext(seed=args.seed)
    (profile_training if args.train else profile_serving)(args)
    print(smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
