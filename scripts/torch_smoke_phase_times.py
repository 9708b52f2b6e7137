#!/usr/bin/env python3
"""Every phase's seconds of a ``chip_smoke.py`` run, for any checkout of
it: loads the given ``chip_smoke.py`` (with its own checkout's
``analytics_zoo_tpu_torch`` first on the path), times each of its phase
functions as ``main`` calls them, runs ``main`` and then prints one line,
``phase times: {...}``, with the seconds by phase number. Phases 3 and 4
run inline in ``main``: phase 3 is timed from the end of the last phase
before it (17, or 18 where the checkout has it) to the start of
``time_forward``, phase 4 from there to the start of phase 5. So two
checkouts (a parent and its change) are timed alike, in one call on one
card:

    python3 scripts/torch_smoke_phase_times.py [path/to/chip_smoke.py]

The exit code is ``main``'s; the phase line is printed whatever it is.
Needs one CUDA card, as ``chip_smoke.py`` does.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

# phase number -> the function that runs it, in the order main calls them
PHASES = (("14", "foreign_phase"), ("15", "tf_phase"), ("16", "dist_phase"),
          ("17", "mesh_phase"), ("18", "pipeline_phase"),
          ("4", "time_forward"), ("5", "serve_tier"), ("6", "text_phase"),
          ("7", "image_phase"), ("8", "detection_phase"),
          ("9", "text_zoo_phase"), ("10", "layer_library_phase"),
          ("11", "int8_reload_phase"), ("12", "frontdoor_batch_phase"),
          ("13", "flywheel_phase"))


def load(path: Path):
    """``path`` as the module ``chip_smoke``, its checkout first on the
    import path."""
    sys.path.insert(0, str(path.parent))
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def phase_seconds(t0: float, t_end: float, spans: dict) -> dict:
    """Seconds by phase from each timed function's (start, end): "1-2"
    the build and the kernel checks, "3" and "4" the inline phases,
    "tail" what follows phase 13."""
    out = {}
    starts = sorted((s, n) for n, (s, _) in spans.items())
    if starts:
        out["1-2"] = starts[0][0] - t0
    for name, (start, end) in spans.items():
        if name != "4":
            out[name] = end - start
    if "4" in spans:
        before = [e for n, (_, e) in spans.items()
                  if n in ("17", "18")]
        if before:
            out["3"] = spans["4"][0] - max(before)
        if "5" in spans:
            out["4"] = spans["5"][0] - spans["4"][0]
    last = max((e for _, e in spans.values()), default=t0)
    out["tail"] = t_end - last
    order = ["1-2", "14", "15", "16", "17", "18", "3", "4"] + [
        str(n) for n in range(5, 14)] + ["tail"]
    return {k: round(out[k], 1) for k in order if k in out}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = Path(argv[0] if argv else
                Path(__file__).resolve().parents[1] / "chip_smoke.py")
    path = path.resolve()
    os.chdir(path.parent)
    mod = load(path)
    spans = {}

    def timed(name, fn):
        def run(*a, **kw):
            start = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                # phase 4's first call only: time_forward runs once
                spans.setdefault(name, (start, time.perf_counter()))
        return run

    for name, attr in PHASES:
        if hasattr(mod, attr):
            setattr(mod, attr, timed(name, getattr(mod, attr)))
    t0 = time.perf_counter()
    try:
        rc = mod.main([])
    finally:
        print(f"phase times ({path}): " + json.dumps(
            phase_seconds(t0, time.perf_counter(), spans)), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
