#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` (the tagging and ranking zoo) alone, on
the PyTorch/CUDA port: NER trained, checked card against CPU and served,
SequenceTagger and IntentEntity card against CPU, KNRM trained over
TextSet relation pairs, AnomalyDetector and SessionRecommender trained and
checked, then tfpark's BERTClassifier through TFEstimator on the flash
kernels (built first from ``analytics_zoo_tpu_torch/csrc``). Exits 1 on a
failed check. Needs one CUDA card:

    python3 scripts/torch_text_zoo_phase.py [--seed 9]
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
    ap.add_argument("--seed", type=int, default=9)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_text_zoo_phase: needs a CUDA card", file=sys.stderr)
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
    launches = cs.text_zoo_phase(fa, args.seed)
    print(f"phase 9 alone took {time.perf_counter() - t0:.1f} s; "
          f"BERTClassifier flash launches {launches}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
