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
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "torch_kernels"
KERNELS = ("flash_attention_fwd", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


class LaunchCounter:
    """A wrapper's count of its kernel launches: a plain integer, bumped
    under a lock because serving threads launch concurrently."""

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self.count += 1

    def reset(self) -> None:
        with self._lock:
            self.count = 0


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
    source, all started together. Returns each fresh build's compiler log
    (``-Xptxas -v``: registers, shared memory, spills); raises
    ``RuntimeError`` with the log if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        log = lib.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, lib, log))
    logs, failed = {}, []
    for name, proc, tmp, lib, log in jobs:
        rc = proc.wait()
        logs[name] = log.read_text()
        if rc == 0:
            # atomic: another process never loads a half-written library
            os.replace(tmp, lib)
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
