#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` alone, on the PyTorch/CUDA port: pipeline
parallelism on one card. 18a ``TransformerLayer(pipeline_parallel=True)``
at BERT-base widths and depth on a (1, 4) data x pipe slot mesh against
one slot (a forward and 3 SGD steps); 18b ``train_pipelined`` of a
BERT-base-wide stack with ``StagePlan(4)`` at K=1/M=1, K=4/M=1, K=4/M=4
1F1B and GPipe, a stage-sharded commit and its resume; 18c the trained
stack served plain and stage-split. The flash kernels are built first
from ``analytics_zoo_tpu_torch/csrc``. Exits 1 on a failed check. Needs
one CUDA card:

    python3 scripts/torch_pipeline_phase.py [--seed 18]
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
    ap.add_argument("--seed", type=int, default=18)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_pipeline_phase: needs a CUDA card", file=sys.stderr)
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
    launches = cs.pipeline_phase(fa, args.seed)
    print(f"phase 18 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches by the wrappers {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
