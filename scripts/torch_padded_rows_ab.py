#!/usr/bin/env python3
"""The bf16 train step of ``chip_smoke.py`` phase 15a's Keras encoder
(BERT-base widths, converted from its ``to_json()`` by ``Net.load_keras``)
timed with and without the gradient that a padded query's uniform
softmax row sends into q and k (``keras.layers.attention.
_fully_masked_rows``; without it the row is the mean of v alone, as
before that gradient was added). The two run in turns (with, without,
without, with), each round after warm-up steps, in one process; p50 and
p90 by CUDA events per variant. Needs one CUDA card:

    python3 scripts/torch_padded_rows_ab.py [--seed 15] [--steps 10]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_padded_rows_ab: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.data.feature_set import ArrayFeatureSet
    from analytics_zoo_tpu_torch.engine.estimator import Estimator
    from analytics_zoo_tpu_torch.keras.layers import attention
    from analytics_zoo_tpu_torch.keras.optimizers import SGD
    from analytics_zoo_tpu_torch.net import Net
    from analytics_zoo_tpu_torch.ops import _kernels

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    _kernels.build(_kernels.KERNELS)
    init_nncontext(seed=0)
    rng = np.random.default_rng(args.seed)
    cs.TF_DIR.mkdir(parents=True, exist_ok=True)
    path = cs.TF_DIR / "keras_encoder.json"
    path.write_text(json.dumps(cs.keras_encoder_config(**cs.KENC)))
    net = Net.load_keras(str(path))
    net.params, net.model_state = net.init(
        torch.Generator().manual_seed(args.seed))
    x = cs.encoder_request(rng, cs.KENC_BATCH, cs.KENC["seq"],
                           cs.KENC["vocab"])
    y = rng.integers(0, 2, cs.KENC_BATCH).astype(np.int32)
    data = ArrayFeatureSet(x, y).cache_device()
    net.compute_dtype = "bfloat16"
    net.compile(optimizer=SGD(lr=cs.KENC_LR, momentum=0.9),
                loss="sparse_categorical_crossentropy")
    est = Estimator(net, net.optim_method)
    est._ensure_state()
    step = est._make_train_step(net.criterion)
    xs, yb, mask = next(iter(est._batches(data, cs.KENC_BATCH, 0)))
    padded = float((x[0] == 0).mean())
    shipped = attention._fully_masked_rows

    def value_only(q, k, v, causal):
        return shipped(q.detach(), k.detach(), v, causal)

    ms = {"with the gradient": [], "mean of v only": []}
    for name in ("with the gradient", "mean of v only", "mean of v only",
                 "with the gradient"):
        attention._fully_masked_rows = (
            shipped if name == "with the gradient" else value_only)
        for i in range(args.warmup + args.steps):
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            t0.record()
            est.tstate, _ = step(est.tstate, xs, yb, mask)
            t1.record()
            torch.cuda.synchronize()
            if i >= args.warmup:
                ms[name].append(t0.elapsed_time(t1))
    attention._fully_masked_rows = shipped
    for name, v in ms.items():
        p50, p90 = np.percentile(v, (50, 90))
        print(f"padded-rows: Keras encoder train step ({cs.KENC_BATCH}, "
              f"{cs.KENC['seq']}) bf16, {name}: p50 {p50:.3f} ms, p90 "
              f"{p90:.3f} ms over {len(v)} steps in two rounds (CUDA "
              f"events; {padded:.3f} of the tokens padded) ({cs.smi_line()})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
