#!/usr/bin/env python3
"""How far the card-against-CPU check of ``chip_smoke.py`` is from its
bounds, over draws (the PyTorch/CUDA port).

Runs ``chip_smoke.card_cpu_errors`` with a train step for each
model of ``--models`` (ResNet-50 as phase 3c builds it, the MobileNets as
phase 7a does, 1000 classes at 224x224, raw logits), for each seed of
``--seeds`` (the images, labels and, through the context's seed, the
weights) and each CPU thread count of ``--threads`` (the CPU routes' sum
orders). Prints every draw's errors against the f64 CPU values (the f32
card, the f32 CPU, the f64 card), whether the check passed, and whether
the earlier gate, which held the f32 loss and update to twice the CPU's
error plus a floor (1e-6 and 1e-3), would have. Ends with the largest
error per route and key over the draws, on one JSON line. Exits 1 if a
draw failed the check. Needs one CUDA card:

    python3 scripts/torch_card_cpu_noise.py [--seeds 0 1 2]
        [--threads 8 4 2 1] [--models resnet-50 mobilenet-v2 mobilenet-v1]
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

# the earlier gate of the f32 train step: card <= 2 x cpu + these
EARLIER_FLOOR = {"loss": 1e-6, "params": 1e-3}


def build(name):
    from analytics_zoo_tpu_torch.keras.layers import get_activation
    from analytics_zoo_tpu_torch.models.image.imageclassification import (
        build_model,
    )

    if name == "resnet-50":
        return cs.build_resnet(), cs.CPU_FLOOR
    net = build_model(name, num_classes=cs.RESNET_CLASSES,
                      input_shape=(224, 224, 3))
    net.ensure_params()
    net.layers()[-1].activation = get_activation(None)
    return net, cs.CATALOG_FLOOR


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--threads", type=int, nargs="+", default=[8, 4, 2, 1])
    ap.add_argument("--models", nargs="+",
                    default=["resnet-50", "mobilenet-v2", "mobilenet-v1"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_card_cpu_noise: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext

    print(f"device: {cs.smi_line()}; torch {torch.__version__}; CPU "
          f"threads by default {torch.get_num_threads()}, capability "
          f"{torch.backends.cpu.get_cpu_capability()}", flush=True)
    init_nncontext(seed=0)
    default = torch.get_num_threads()
    worst, failed, earlier_failed, draws = {}, 0, 0, 0
    for name in args.models:
        for seed in args.seeds:
            for threads in args.threads:
                torch.set_num_threads(threads)
                net, floors = build(name)
                label = f"{name} seed {seed} threads {threads}"
                errs, bad = cs.card_cpu_errors(
                    net, np.random.default_rng(seed), label, (224, 224, 3),
                    True, floors)
                ok = not bad
                earlier = all(errs["card"][k] <= cs.CPU_FACTOR
                              * errs["cpu"][k] + f
                              for k, f in EARLIER_FLOOR.items())
                draws += 1
                failed += not ok
                earlier_failed += not earlier
                for route, e in errs.items():
                    for k, v in e.items():
                        key = f"{route}/{k}"
                        worst[key] = max(worst.get(key, 0.0), v)
                print(f"draw: {label}: check {'passed' if ok else bad}, "
                      f"earlier gate {'passed' if earlier else 'failed'}; "
                      + "; ".join(f"{r} " + ", ".join(
                          f"{k} {v:.3e}" for k, v in e.items())
                          for r, e in errs.items()), flush=True)
                del net
                torch.cuda.empty_cache()
    torch.set_num_threads(default)
    print(json.dumps({"draws": draws, "failed": failed,
                      "earlier_gate_failed": earlier_failed,
                      "worst": worst}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
