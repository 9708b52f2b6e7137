"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, it runs on the card unless told otherwise, and CPU tensors never
reach the CUDA kernel loader."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import analytics_zoo_tpu_torch as port
from analytics_zoo_tpu_torch.ops import _kernels
from analytics_zoo_tpu_torch.ops import flash_attention as tfa

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "analytics_zoo_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    return any(module == m or module.startswith(m + ".")
               for m in ("jax", "analytics_zoo_tpu"))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0 and _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch.inference\n"
            "import analytics_zoo_tpu_torch.interop\n"
            "import analytics_zoo_tpu_torch.tfpark.bert\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'analytics_zoo_tpu.'))]\n"
            "assert not bad and 'analytics_zoo_tpu' not in sys.modules, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_init_nncontext_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    port.stop_nncontext()
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.init_nncontext()
        ctx = port.init_nncontext(device="cpu", seed=5)
        assert ctx.device == torch.device("cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        a = torch.rand(3, generator=ctx.generator)
        assert torch.equal(a, torch.rand(
            3, generator=torch.Generator().manual_seed(5)))
    finally:
        port.stop_nncontext()


def test_cpu_tensors_never_touch_the_cuda_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA loader reached from a CPU tensor")

    monkeypatch.setattr(_kernels, "load", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    before = tfa.launches.count
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 2, 64, 64)), dtype=torch.float32)
    out, lse = tfa.flash_attention_with_lse(q, q, q, causal=True)
    assert out.shape == (1, 2, 64, 64) and lse.shape == (1, 2, 64)
    assert tfa.launches.count == before
    # the CUDA wrapper itself refuses a CPU tensor before loading anything
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_forward_cuda(q, q, q, None, 0.125, False)
