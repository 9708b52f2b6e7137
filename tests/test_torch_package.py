"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, it runs on the card unless told otherwise, and CPU tensors never
reach the CUDA kernel loader."""

import ast
import json
import os
import subprocess
import sys
import textwrap
import time
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
            "import analytics_zoo_tpu_torch.data.sources\n"
            "import analytics_zoo_tpu_torch.data.pipeline\n"
            "import analytics_zoo_tpu_torch.batch\n"
            "import analytics_zoo_tpu_torch.serving.frontdoor\n"
            "import analytics_zoo_tpu_torch.serving.worker\n"
            "import analytics_zoo_tpu_torch.serving.fabric\n"
            "import analytics_zoo_tpu_torch.net\n"
            "import analytics_zoo_tpu_torch.onnx\n"
            "import analytics_zoo_tpu_torch.keras_import\n"
            "import analytics_zoo_tpu_torch.torch_import\n"
            "import analytics_zoo_tpu_torch.caffe_import\n"
            "import analytics_zoo_tpu_torch.keras.datasets\n"
            "import analytics_zoo_tpu_torch.data.image3d\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'analytics_zoo_tpu.'))]\n"
            "assert not bad and 'analytics_zoo_tpu' not in sys.modules, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_tf_importers_load_no_jax_tensorflow_or_h5py():
    """The TensorFlow importers (``keras_convert``, ``tfnet`` and its
    GraphDef reader) and the modules that call them import none of jax,
    the JAX package, TensorFlow or h5py: those load at call time only."""
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch.keras_convert\n"
            "import analytics_zoo_tpu_torch.tfnet\n"
            "import analytics_zoo_tpu_torch.tfnet.graphdef\n"
            "import analytics_zoo_tpu_torch.net\n"
            "import analytics_zoo_tpu_torch.inference\n"
            "import analytics_zoo_tpu_torch.tfpark\n"
            "import analytics_zoo_tpu_torch.models.image.imageclassification\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'analytics_zoo_tpu', 'tensorflow', 'h5py', 'keras')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_distributed_modules_load_no_jax():
    """Multi-host training (``ft.distributed``, ``mesh``), the in-process
    mesh (``mesh.plan``, ``mesh.slots``, ``parallel.sharding``,
    ``parallel.ring_attention``) and the mixture-of-experts layer
    (``parallel``, ``keras.layers.moe``) import neither jax nor the JAX
    package, nor optax."""
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch.ft.distributed\n"
            "import analytics_zoo_tpu_torch.mesh\n"
            "import analytics_zoo_tpu_torch.mesh.config\n"
            "import analytics_zoo_tpu_torch.mesh.plan\n"
            "import analytics_zoo_tpu_torch.mesh.slots\n"
            "import analytics_zoo_tpu_torch.parallel\n"
            "import analytics_zoo_tpu_torch.parallel.moe\n"
            "import analytics_zoo_tpu_torch.parallel.sharding\n"
            "import analytics_zoo_tpu_torch.parallel.ring_attention\n"
            "import analytics_zoo_tpu_torch.keras.layers.moe\n"
            "import analytics_zoo_tpu_torch.engine.estimator\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'analytics_zoo_tpu', 'optax')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_pipeline_modules_load_no_jax():
    """Pipeline parallelism (``pipeline`` with its lazy
    ``train_pipelined``, ``pipeline.trainer``, ``parallel.pipeline``)
    imports neither jax nor the JAX package, nor optax."""
    code = ("import sys\n"
            "import analytics_zoo_tpu_torch.pipeline as p\n"
            "import analytics_zoo_tpu_torch.pipeline.plan\n"
            "import analytics_zoo_tpu_torch.pipeline.schedule\n"
            "import analytics_zoo_tpu_torch.pipeline.buffers\n"
            "import analytics_zoo_tpu_torch.pipeline.trainer\n"
            "import analytics_zoo_tpu_torch.parallel.pipeline\n"
            "assert callable(p.train_pipelined)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'analytics_zoo_tpu', 'optax')]\n"
            "assert not bad, bad\n")
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


_STUB_NVCC = """#!/bin/sh
# a stand-in nvcc: note the call, take a while, write the -o file
out=""
prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  prev="$a"
done
echo "$out" >> "$STUB_NVCC_CALLS"
echo "ptxas info    : Used 1 registers"
sleep 1
echo lib > "$out"
"""


def test_processes_booting_together_build_each_source_once(tmp_path):
    """N processes on one empty build directory: the file lock lets one
    of them compile each source, the others find its libraries, and
    every log is whole."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(_STUB_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    calls = tmp_path / "calls.txt"
    child = textwrap.dedent(f"""
        import json, sys
        from pathlib import Path
        from analytics_zoo_tpu_torch.ops import _kernels
        _kernels.BUILD_DIR = Path({str(build_dir)!r})
        logs = _kernels.build()
        print(json.dumps({{
            "built": sorted(logs),
            "libs": [str(_kernels._paths(n)[1]) for n in _kernels.KERNELS]}}))
        """)
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_HOME=str(cuda),
               STUB_NVCC_CALLS=str(calls))
    procs = [subprocess.Popen([sys.executable, "-c", child], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    # each source compiled once, by one of the two processes
    assert sorted(outs[0]["built"] + outs[1]["built"]) == sorted(
        _kernels.KERNELS)
    assert len(calls.read_text().split()) == len(_kernels.KERNELS)
    assert outs[0]["libs"] == outs[1]["libs"]
    for lib in map(Path, outs[0]["libs"]):
        assert lib.read_text() == "lib\n"
        assert lib.with_suffix(".log").read_text() == (
            "ptxas info    : Used 1 registers\n")
    assert not list(build_dir.glob("*.tmp"))


_WORKER_SPEC = """
import json
import sys

import numpy as np

from analytics_zoo_tpu_torch import init_nncontext
from analytics_zoo_tpu_torch.serving import BatcherConfig, ServingEngine


class Model:
    def do_predict(self, x):
        # what this worker process holds, read while it serves
        bad = sorted(m for m in sys.modules if m in ("jax", "analytics_zoo_tpu")
                     or m.startswith(("jax.", "analytics_zoo_tpu.")))
        with open(__file__ + ".modules.json", "w") as f:
            json.dump(bad, f)
        return np.asarray(x, np.float32) * 2


def build_engine():
    init_nncontext(device="cpu")
    engine = ServingEngine()
    engine.register("m", Model(), example_input=np.zeros((1, 2)),
                    config=BatcherConfig(max_batch_size=2, max_wait_ms=1.0))
    return engine
"""


def test_booted_worker_holds_no_jax(tmp_path):
    """A port worker booted from a spec serves with neither jax nor the
    JAX package in its sys.modules, and exits 0 on SIGTERM."""
    import urllib.request

    spec = tmp_path / "spec.py"
    spec.write_text(_WORKER_SPEC)
    ready = tmp_path / "ready.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "analytics_zoo_tpu_torch.serving.worker",
         "--spec", f"{spec}:build_engine", "--ready-file", str(ready)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while not ready.exists():
            assert proc.poll() is None, proc.communicate()[1]
            assert time.monotonic() - t0 < 90, "worker never became ready"
            time.sleep(0.05)
        info = json.loads(ready.read_text())
        assert info["pid"] == proc.pid
        req = urllib.request.Request(
            f"http://127.0.0.1:{info['port']}/v1/models/m:predict",
            data=json.dumps({"instances": [[1.0, 2.0]]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            assert json.loads(r.read())["predictions"] == [[2.0, 4.0]]
        assert json.loads(
            (tmp_path / "spec.py.modules.json").read_text()) == []
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
