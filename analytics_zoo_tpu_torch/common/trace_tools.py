"""Profiler-trace summaries (port of
``analytics_zoo_tpu.common.trace_tools``): reads the ``torch.profiler``
traces that ``Estimator.set_profile`` writes.

``torch.profiler`` writes Chrome trace-event JSON (``*.pt.trace.json``,
through ``tensorboard_trace_handler`` or ``export_chrome_trace``). This
module aggregates it with no TensorBoard: a trace's processes are its
*planes* (``"python CPU"`` for the host, ``"python GPU 0"`` for the
card), each process's threads or CUDA streams are its *lines*
(``"thread 753 (python)"``, ``"stream 7"``), and each complete event
(``"ph": "X"``) counts its duration on its line, under a category read
from its name (:func:`_categorize`: gemm, int8 gemm, conv, flash,
elementwise, reduction, memcpy, other).

Both public views, :func:`summarize_trace` (per-line category roll-up)
and :func:`top_ops` (per-op totals), walk the trace through ONE parser
(:func:`_iter_planes`), so they cannot disagree about an event's name or
duration (their agreement on one trace is pinned in
``tests/test_torch_trace_tools.py``).

Caveat: host lines hold nested spans (``aten::matmul`` around
``aten::mm``), so a host line's total counts nested time more than once;
kernels on one CUDA stream do not overlap. Compare categories within a
line; do not sum lines into wall time.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import Counter
from typing import Dict, Iterator, List, Tuple

# an 8-bit integer operand in a kernel's name: "int8", "imma", "_int_mm", or
# a type token such as "_s8_", "i8i8", "_i8i32_" (cuBLASLt's sm90 int8 GEMM)
_INT8 = re.compile(r"_int_mm|int8|imma|(?:^|[_\W])[isu]8(?=[_\Wisu]|$)")
_CONV = ("conv", "fprop", "dgrad", "wgrad", "implicit_convolve")
_GEMM = ("gemm", "matmul", "aten::mm", "aten::addmm", "aten::bmm",
         "aten::linear", "cutlass", "xmma", "cublas")
_REDUCTION = ("reduce", "softmax", "norm", "aten::sum", "aten::mean",
              "aten::max", "aten::min", "aten::amax", "argmax", "topk",
              "sort", "scan", "pool")
_ELEMENTWISE = ("elementwise", "vectorized", "unrolled", "aten::add",
                "aten::sub", "aten::mul", "aten::div", "aten::tanh",
                "aten::relu", "aten::clamp", "aten::round", "aten::copy_",
                "aten::to", "aten::where", "aten::exp", "aten::gelu",
                "aten::sigmoid", "aten::fill_", "aten::zero_")


def _categorize(name: str) -> str:
    """The kernel class of an event's name: CUDA kernel names (cuBLAS,
    cuBLASLt, cuDNN, the port's ``flash_*`` kernels, PyTorch's
    elementwise and reduction templates) and ``aten::`` operator names
    on the CPU."""
    n = name.lower()
    if "flash" in n:
        return "flash"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    if any(k in n for k in _CONV):
        return "conv"
    if "_int_mm" in n or (any(k in n for k in ("gemm", "imma", "cutlass",
                                               "xmma"))
                          and _INT8.search(n)):
        return "int8 gemm"
    if any(k in n for k in _GEMM):
        return "gemm"
    if any(k in n for k in _REDUCTION):
        return "reduction"
    if any(k in n for k in _ELEMENTWISE):
        return "elementwise"
    return "other"


# ---------------------------------------------------------------------------
# The one trace walk (trace -> planes -> lines -> events) both public views
# are built on.
# ---------------------------------------------------------------------------


def _newest_dump(log_dir: str) -> dict:
    """The newest ``torch.profiler`` trace under ``log_dir``, parsed."""
    dumps = sorted(
        glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json"),
                  recursive=True)
        + glob.glob(os.path.join(log_dir, "**", "*.pt.trace.json.gz"),
                    recursive=True), key=os.path.getmtime)
    if not dumps:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    opener = gzip.open if dumps[-1].endswith(".gz") else open
    with opener(dumps[-1], "rt") as f:
        return json.load(f)


def _iter_planes(trace: dict) -> Iterator[Tuple[str, Dict[str, List[
        Tuple[str, float]]]]]:
    """Yield ``(plane_name, {line_name: [(event_name, duration_us)]})``
    per process of the trace: the process's name and label
    (``process_name``/``process_labels`` metadata), and its complete
    events grouped by thread or stream (``thread_name`` metadata)."""
    events = trace.get("traceEvents", [])
    pnames: Dict = {}
    plabels: Dict = {}
    tnames: Dict = {}
    for e in events:
        if e.get("ph") != "M":
            continue
        args = e.get("args", {})
        if e.get("name") == "process_name":
            pnames[e.get("pid")] = str(args.get("name", ""))
        elif e.get("name") == "process_labels":
            plabels[e.get("pid")] = str(args.get("labels", ""))
        elif e.get("name") == "thread_name":
            tnames[(e.get("pid"), e.get("tid"))] = str(args.get("name", ""))
    planes: Dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        pid, tid = e.get("pid"), e.get("tid")
        line = tnames.get((pid, tid), f"thread {tid}")
        planes.setdefault(pid, {}).setdefault(line, []).append(
            (str(e.get("name", "")), float(e.get("dur", 0.0))))
    for pid, lines in planes.items():
        name = " ".join(p for p in (pnames.get(pid, str(pid)),
                                    plabels.get(pid, "")) if p)
        yield name, lines


# ---------------------------------------------------------------------------
# Public views
# ---------------------------------------------------------------------------


def summarize_trace(log_dir: str) -> Dict[str, Dict]:
    """Aggregate the newest trace under ``log_dir``.

    Returns ``{plane_name: {"lines": {line_name: {"events": n,
    "total_ms": t, "by_category": {cat: ms}}}}}``, categories sorted by
    time."""
    out: Dict[str, Dict] = {}
    for pname, lines in _iter_planes(_newest_dump(log_dir)):
        agg = out.setdefault(pname, {"lines": {}})
        for lname, events in lines.items():
            cats: Counter = Counter()
            for name, dur in events:
                cats[_categorize(name)] += dur / 1e3
            slot = agg["lines"].setdefault(
                lname, {"events": 0, "total_ms": 0.0, "by_category": {}})
            slot["events"] += len(events)
            slot["total_ms"] += sum(d for _, d in events) / 1e3
            cats.update(slot["by_category"])
            slot["by_category"] = dict(cats.most_common())
    return out


def print_trace_summary(log_dir: str) -> None:
    """Human-readable dump of :func:`summarize_trace`."""
    for pname, plane in summarize_trace(log_dir).items():
        print(f"plane {pname}")
        for lname, line in plane["lines"].items():
            print(f"  line '{lname}': {line['events']} events, "
                  f"{line['total_ms']:.3f} ms")
            for cat, ms in line["by_category"].items():
                print(f"      {ms:9.3f} ms  {cat}")


def top_ops(log_dir: str, line: str = "stream", n: int = 25,
            plane_substr: str = "GPU"):
    """The top-``n`` individual ops by total time in the newest trace
    under ``log_dir``, one level finer than :func:`summarize_trace`'s
    categories: ``[(name, total_ms, count), ...]`` sorted by time, over
    the lines whose name contains ``line`` ("stream": the card's CUDA
    streams; "thread": host threads; "": every line) on the planes whose
    name contains ``plane_substr`` ("GPU" for the card, "CPU" for the
    host). Capture two traces and compare their rows to diff two runs."""
    totals: Counter = Counter()
    counts: Counter = Counter()
    for pname, lines in _iter_planes(_newest_dump(log_dir)):
        if plane_substr not in pname:
            continue
        for lname, events in lines.items():
            if line not in lname:
                continue
            for name, dur in events:
                totals[name] += dur
                counts[name] += 1
    return [(name, us / 1e3, counts[name])
            for name, us in totals.most_common(n)]
