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
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("torch_*.py"))


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
            "import analytics_zoo_tpu_torch.engine.estimator\n"
            "import analytics_zoo_tpu_torch.keras.engine.topology\n"
            "import analytics_zoo_tpu_torch.keras.layers\n"
            "import analytics_zoo_tpu_torch.models.image.imageclassification\n"
            "import analytics_zoo_tpu_torch.ops.batch_norm\n"
            "import analytics_zoo_tpu_torch.autograd.variable\n"
            "import analytics_zoo_tpu_torch.engine.checkpoint\n"
            "import analytics_zoo_tpu_torch.engine.summary\n"
            "import analytics_zoo_tpu_torch.ft.atomic\n"
            "import analytics_zoo_tpu_torch.ft.chaos\n"
            "import analytics_zoo_tpu_torch.ft.manager\n"
            "import analytics_zoo_tpu_torch.ft.preemption\n"
            "import analytics_zoo_tpu_torch.keras.layers.embeddings\n"
            "import analytics_zoo_tpu_torch.models.common\n"
            "import analytics_zoo_tpu_torch.models.recommendation\n"
            "import analytics_zoo_tpu_torch.models.seq2seq\n"
            "import analytics_zoo_tpu_torch.models.textclassification\n"
            "import analytics_zoo_tpu_torch.keras.layers.recurrent\n"
            "import analytics_zoo_tpu_torch.serving.sequence\n"
            "import analytics_zoo_tpu_torch.predictor\n"
            "import analytics_zoo_tpu_torch.serving\n"
            "import analytics_zoo_tpu_torch.serving.fabric.coopcache\n"
            "import analytics_zoo_tpu_torch.common.profiling\n"
            "import analytics_zoo_tpu_torch.common.slo\n"
            "import analytics_zoo_tpu_torch.models.image.objectdetection\n"
            "import analytics_zoo_tpu_torch.models.image.objectdetection.frcnn\n"
            "import analytics_zoo_tpu_torch.data.roi\n"
            "import analytics_zoo_tpu_torch.ops.bbox\n"
            "import analytics_zoo_tpu_torch.keras.layers.crf\n"
            "import analytics_zoo_tpu_torch.tfpark\n"
            "import analytics_zoo_tpu_torch.tfpark.text\n"
            "import analytics_zoo_tpu_torch.models\n"
            "import analytics_zoo_tpu_torch.models.textmatching\n"
            "import analytics_zoo_tpu_torch.models.anomalydetection\n"
            "import analytics_zoo_tpu_torch.data\n"
            "import analytics_zoo_tpu_torch.data.text_set\n"
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
        # the training draws: a device generator from the same seed, whose
        # position saves and restores
        gen = ctx.step_generator
        assert gen.device == ctx.device and gen.initial_seed() == 5
        state = gen.get_state()
        first = torch.rand(4, generator=gen)
        gen.set_state(state)
        assert torch.equal(torch.rand(4, generator=gen), first)
    finally:
        port.stop_nncontext()


def test_cpu_tensors_never_touch_the_cuda_loader(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("CUDA loader reached from a CPU tensor")

    monkeypatch.setattr(_kernels, "load", boom)
    monkeypatch.setattr(_kernels, "build", boom)
    counters = (tfa.launches, tfa.launches_dq, tfa.launches_dkv)
    before = [c.count for c in counters]
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, 2, 64, 64)), dtype=torch.float32,
                     requires_grad=True)
    out, lse = tfa.flash_attention_with_lse(q, q, q, causal=True)
    assert out.shape == (1, 2, 64, 64) and lse.shape == (1, 2, 64)
    (out.sum() + lse.sum()).backward()  # the backward's plain versions
    assert q.grad.shape == q.shape
    assert [c.count for c in counters] == before
    # the CUDA wrappers themselves refuse a CPU tensor before loading
    qd = q.detach()
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_forward_cuda(qd, qd, qd, None, 0.125, False)
    with pytest.raises(ValueError, match="CUDA device"):
        tfa._flash_backward_cuda(qd, qd, qd, None, qd, lse.detach(), qd,
                                 0.125, False)


def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """A kernel library is named by a hash of its source and of every
    shared header in csrc/, so an edit to the header alone rebuilds it
    rather than loading a stale library."""
    monkeypatch.setattr(_kernels, "SRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    src, first = _kernels._paths("k")
    assert src == tmp_path / "k.cu" and first.parent == _kernels.BUILD_DIR
    assert _kernels._paths("k")[1] == first  # stable
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _kernels._paths("k")[1]
    assert second != first
    (tmp_path / "other.cuh").write_text("// a new header\n")
    assert _kernels._paths("k")[1] not in (first, second)
    (tmp_path / "other.cuh").unlink()
    assert _kernels._paths("k")[1] == second
