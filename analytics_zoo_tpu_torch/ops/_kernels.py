"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into ``build/torch_kernels/`` beside the
package (one shared library per source, named by a hash of the source, the
shared headers ``csrc/*.cuh`` and the flags, so an edited source or header
is rebuilt) and loaded with ``ctypes``. Nothing
here runs at import time: the CPU tests import every module, and a CPU
tensor never reaches the loader.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Tuple

_PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_compile_listeners: List[Callable[[float], None]] = []


class LaunchCounter:
    """A wrapper's count of its kernel launches: a plain integer, bumped
    under a lock because serving threads launch concurrently.

    Only the wrapper adds to it, once per call of its kernel's launcher. A
    launch into a CUDA graph being captured counts like any other; a
    replay of that graph launches the captured kernels with no Python, so
    no counter sees it: a replay's launches are read from the card (a
    ``torch.profiler`` trace of its kernels)."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


def add_compile_listener(fn: Callable[[float], None]) -> None:
    """Call ``fn(seconds)`` after every compile: each fresh ``nvcc`` build
    of a kernel source here and each CUDA graph capture
    (:func:`compiled`). The observability layer's compile counters are
    such a listener."""
    _compile_listeners.append(fn)


def compiled(seconds: float) -> None:
    """Report one compile that took ``seconds`` to the listeners; a
    listener's fault is never the compile's."""
    for fn in list(_compile_listeners):
        try:
            fn(seconds)
        except Exception:  # pragma: no cover - defensive
            pass


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from csrc/ at first "
        "use and need the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _paths(name: str) -> Tuple[Path, Path]:
    """The source and its library, named by a hash of the source, every
    shared header (``csrc/*.cuh``, which any source may include) and the
    flags."""
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet: one ``nvcc`` per
    source, all started together. Each fresh build reports its own
    seconds, from its start to its end, to the compile listeners. Returns
    each fresh build's compiler log (``-Xptxas -v``: registers, shared
    memory, spills); raises ``RuntimeError`` with the log if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, t0, tmp, lib, log))

    def wait(job):
        rc = job[1].wait()
        return rc, time.perf_counter() - job[2]

    with ThreadPoolExecutor(max(1, len(jobs))) as pool:
        ends = list(pool.map(wait, jobs))
    logs, failed = {}, []
    for (name, _, _, tmp, lib, log), (rc, seconds) in zip(jobs, ends):
        logs[name] = log.read_text()
        if rc == 0:
            # atomic: another process never loads a half-written library
            os.replace(tmp, lib)
            compiled(seconds)
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {rc}\n{logs[name]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The named kernel's shared library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_paths(name)[1]))
            _libs[name] = lib
        return lib
