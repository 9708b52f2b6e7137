#!/usr/bin/env python3
"""Phase 11 of ``chip_smoke.py`` alone, on the PyTorch/CUDA port: int8
inference (BERT-base with ``do_quantize`` behind a ``ServingEngine``,
ResNet-50 with ``do_calibrate``, Seq2seq with ``do_quantize`` behind a
``ContinuousBatcher``), then NeuralCF trained through ``Estimator.train``
with a profile window and the step watchdog while each committed
checkpoint is hot-reloaded into a ``ServingEngine`` under HTTP traffic,
and graph memory around evictions. BERT runs on the flash kernels, built
first from ``analytics_zoo_tpu_torch/csrc``. Exits 1 on a failed check.
Needs one CUDA card:

    python3 scripts/torch_int8_reload_phase.py [--seed 11]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_int8_reload_phase: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops import _kernels
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    _kernels.build(_kernels.KERNELS)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    init_nncontext(seed=0)
    t0 = time.perf_counter()
    launches, replayed = cs.int8_reload_phase(fa, args.seed)
    print(f"phase 11 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches by the wrappers {launches}, in graph replays "
          f"{replayed}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
