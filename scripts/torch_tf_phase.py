#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` alone, on the PyTorch/CUDA port: a Keras
transformer encoder at BERT-base widths converted from a ``to_json()``
file by ``Net.load_keras`` (trained in bf16 and served in CUDA graphs on
the flash kernels, three f32 steps held to the CPU), a frozen ResNet-50
GraphDef served by ``InferenceModel.do_load_tf`` and fine-tuned as a
``TFNet`` under a Dense head, and the TensorFlow- and h5py-only forms
raising their ImportError. The flash kernels are built first from
``analytics_zoo_tpu_torch/csrc``. Exits 1 on a failed check. Needs one
CUDA card:

    python3 scripts/torch_tf_phase.py [--seed 15]
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
    ap.add_argument("--seed", type=int, default=15)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_tf_phase: needs a CUDA card", file=sys.stderr)
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
    launches = cs.tf_phase(fa, args.seed)
    print(f"phase 15 alone took {time.perf_counter() - t0:.1f} s; flash "
          f"launches by the wrappers (15a) {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
