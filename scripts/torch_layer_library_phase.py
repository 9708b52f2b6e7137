#!/usr/bin/env python3
"""Phase 10 of ``chip_smoke.py`` (the layer library) alone, on the
PyTorch/CUDA port: the ConvLSTM next-frame model of keras-team/keras
``examples/conv_lstm.py`` checked card against CPU, trained through
``fit`` and served; ``examples/autograd/custom.py`` and the VAE app
trained with ``CustomLoss``; every layer of the library card against CPU;
an L1L2-regularized graph and a keras2 CNN. No flash kernel runs here, so
none is built. Exits 1 on a failed check. Needs one CUDA card:

    python3 scripts/torch_layer_library_phase.py [--seed 10]
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
    ap.add_argument("--seed", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_layer_library_phase: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.ops import flash_attention as fa

    print(cs.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    init_nncontext(seed=0)
    t0 = time.perf_counter()
    launches = cs.layer_library_phase(fa, args.seed)
    print(f"phase 10 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
