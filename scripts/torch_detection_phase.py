#!/usr/bin/env python3
"""Phase 8 of ``chip_smoke.py`` (object detection) alone, or its SSD
training at several learning rates (the PyTorch/CUDA port).

Without options it runs ``chip_smoke.detection_phase``: the detection
catalog card against CPU, SSD-VGG16-300 trained through ``compile``/``fit``
over the roi chain, a profiled train step, the trained SSD and
frcnn-vgg16 served through ``predict_detections``; it exits 1 on a failed
check. With ``--lr`` it runs only the training (``detection_training``)
once per learning rate, each for ``--seconds``, prints the loss at 12
steps spread over the run beside the phase's own lines, and reports a
failed learning gate without stopping. Needs one CUDA card:

    python3 scripts/torch_detection_phase.py [--seed 8]
        [--lr 1e-4 2e-4 5e-4 --seconds 55]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=8)
    ap.add_argument("--lr", type=float, nargs="*",
                    help="train only, once per learning rate")
    ap.add_argument("--seconds", type=float, default=cs.DET_SECONDS,
                    help="training time per run")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_detection_phase: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    init_nncontext(seed=0)
    cs.DET_SECONDS = args.seconds
    if not args.lr:
        t0 = time.perf_counter()
        cs.detection_phase(fa, args.seed)
        print(f"phase 8 alone took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0
    cs.fail = lambda msg: print(f"learning gate failed: {msg}", flush=True)
    for lr in args.lr:
        cs.DET_LR = lr
        det, _, _ = cs.detection_training(np.random.default_rng(args.seed))
        losses = det.model._estimator.train_losses
        at = np.linspace(0, len(losses) - 1, 12).astype(int)
        print(f"lr {lr:g}: losses at steps {at.tolist()}: "
              f"{[round(losses[i], 3) for i in at]}", flush=True)
        del det
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
