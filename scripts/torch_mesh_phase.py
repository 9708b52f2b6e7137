#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` alone, on the PyTorch/CUDA port: the
in-process mesh on one card. 17a ring attention's flash body and Ulysses
on the hand-written kernels at (2, 12, 4096, 64) bf16 over a 4-slot seq
mesh, held with their gradients to the kernels' plain versions, one flash
call over the whole sequence and the f64 formulas; 17b a causal
TransformerLayer at BERT-base widths at 4096 tokens trained 3 steps with
``sequence_parallel="ring"`` against the same steps without it; 17c
BERT-base served and batch-scored under a ``data=4`` ``ShardingPlan``
against the unsharded model. The flash kernels are built first from
``analytics_zoo_tpu_torch/csrc``. Exits 1 on a failed check. Needs one
CUDA card:

    python3 scripts/torch_mesh_phase.py [--seed 17]
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
    ap.add_argument("--seed", type=int, default=17)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_phase: needs a CUDA card", file=sys.stderr)
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
    launches = cs.mesh_phase(fa, args.seed)
    print(f"phase 17 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches by the wrappers {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
