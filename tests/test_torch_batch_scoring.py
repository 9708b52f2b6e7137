"""The port's batch scoring engine (the cases of
tests/test_batch_scoring.py, on the port): the pipelined score loop, the
atomic shard commit protocol, kill→resume bitwise identity, manifest
verification, the JAX package's inspect CLI reading the port's output,
and the source contracts the runner's row math stands on. Then the
cross-package cases: one saved NeuralCF scored through the JAX
``BatchJobRunner`` and the port's gives manifests with equal row ranges
and fingerprint and scores within 1e-5; each package's ``verify_output``
accepts the other's directory; and ``scripts/torch_batch_predict.py``
killed at ``batch_mid_job_kill`` then run with ``--resume`` is bitwise
the uninterrupted run.

The in-process chaos matrix monkeypatches ``chaos.fail`` to raise, so
the exception unwinds with on-disk state byte-identical to a hard
kill's; the subprocess kill matrix (``os._exit(43)`` inside a live
batch-predict process, then a resume boot) runs every point.
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from analytics_zoo_tpu_torch.batch import (
    BatchJobRunner,
    BatchPredictJob,
    OutputSpec,
    ShardCorruptError,
    iter_output_rows,
    job_complete,
    load_shard_rows,
    read_manifest,
    verify_output,
)
from analytics_zoo_tpu_torch.data.pipeline import Pipeline
from analytics_zoo_tpu_torch.data.sources import (
    ArraySource,
    FileSource,
    NpyRowsSource,
)
from analytics_zoo_tpu_torch.ft import chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_batch_worker.py")
CLI = os.path.join(REPO, "scripts", "torch_batch_predict.py")


class _Boom(Exception):
    """Stands in for os._exit in in-process chaos tests."""


@pytest.fixture
def chaos_raise(monkeypatch):
    """Arm a batch failure point in-process; returns a disarm callable —
    the resume run re-enters the same commit path, so the env must come
    OFF before it (unlike test_ft.py's one-shot save drills)."""
    def arm(point, skip=0):
        chaos.reset()
        monkeypatch.setenv("AZOO_FT_CHAOS", point)
        monkeypatch.setenv("AZOO_FT_CHAOS_SKIP", str(skip))
        monkeypatch.setattr(chaos, "fail",
                            lambda p: (_ for _ in ()).throw(_Boom(p)))

        def disarm():
            monkeypatch.delenv("AZOO_FT_CHAOS", raising=False)
            monkeypatch.delenv("AZOO_FT_CHAOS_SKIP", raising=False)
            chaos.reset()
        return disarm
    yield arm
    chaos.reset()


class LinearModel:
    """Deterministic model with the dispatch/fetch split."""

    def __init__(self, features=4, out=3, seed=9):
        self.w = np.random.default_rng(seed).standard_normal(
            (features, out)).astype(np.float32)

    def do_dispatch(self, x):
        return np.asarray(x) @ self.w

    def do_fetch(self, out):
        return out

    def do_predict(self, x):
        return np.asarray(x) @ self.w


def _data(n=103, features=4, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, features)).astype(np.float32)


def _shard_digest(directory):
    h = hashlib.sha256()
    for rec in read_manifest(directory)["shards"]:
        with open(os.path.join(directory, rec["file"]), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the score loop
# ---------------------------------------------------------------------------


def test_npy_job_matches_direct_predict(tmp_path):
    """End-to-end: scored output rows == model(x) rows, pads stripped,
    manifest contiguous, COMMIT present. 103 rows / batch 16 exercises a
    bucketed tail (pad rows must never reach the output)."""
    x = _data()
    model = LinearModel()
    job = BatchPredictJob(model, ArraySource(x), batch_size=16,
                          pad_to_bucket=(4, 8, 16), pipeline_depth=2)
    out = str(tmp_path / "out")
    report = BatchJobRunner(
        job, OutputSpec(out, rows_per_shard=25)).run()
    assert report["complete"] and report["rows"] == 103
    assert job_complete(out)
    got = np.concatenate([np.asarray(load_shard_rows(
        os.path.join(out, rec["file"])))
        for rec in read_manifest(out)["shards"]])
    np.testing.assert_array_equal(got, x @ model.w)
    v = verify_output(out)
    assert v == {"shards": 5, "rows": 103, "complete": True,
                 "uncommitted": []}


def test_overlapped_matches_synchronous(tmp_path):
    """pipeline_depth=2 (dispatch/fetch overlapped) and depth=0 (pure
    do_predict) must produce bitwise identical output."""
    x = _data(77)
    outs = []
    for depth in (0, 2):
        out = str(tmp_path / f"out{depth}")
        job = BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                              pipeline_depth=depth, prefetch=0)
        BatchJobRunner(job, OutputSpec(out, rows_per_shard=30)).run()
        outs.append(_shard_digest(out))
    assert outs[0] == outs[1]


def test_jsonl_multi_output(tmp_path):
    """Multi-output models (list of arrays per block) round-trip through
    the jsonl writer, one row per line."""
    x = _data(20)

    class TwoHead:
        def do_predict(self, xb):
            xb = np.asarray(xb)
            return [xb * 2.0, np.sum(xb, axis=1)]

    job = BatchPredictJob(TwoHead(), ArraySource(x), batch_size=8,
                          pipeline_depth=0, prefetch=0)
    out = str(tmp_path / "out")
    BatchJobRunner(job, OutputSpec(out, fmt="jsonl",
                                   rows_per_shard=7)).run()
    rows = list(iter_output_rows(out))
    assert len(rows) == 20
    head0 = np.asarray([r[0] for r in rows], np.float32)
    head1 = np.asarray([r[1] for r in rows], np.float32)
    np.testing.assert_allclose(head0, x * 2.0, rtol=1e-6)
    np.testing.assert_allclose(head1, np.sum(x, axis=1), rtol=1e-5)


def test_scored_blocks_resume_offset():
    """scored_blocks(start_row=k) yields exactly rows k.. of the full
    stream — mid-batch offsets included (the resume row math)."""
    x = _data(50)
    model = LinearModel()
    want = x @ model.w

    def rows_from(start):
        job = BatchPredictJob(model, ArraySource(x), batch_size=16,
                              pad_to_bucket=(4, 8, 16), pipeline_depth=0,
                              prefetch=0)
        blocks = list(job.scored_blocks(start_row=start))
        return (np.concatenate(blocks) if blocks
                else np.zeros((0, 3), np.float32))

    for start in (0, 1, 15, 16, 17, 48, 50):
        np.testing.assert_array_equal(rows_from(start), want[start:],
                                      err_msg=f"start_row={start}")


def test_metrics_wired(tmp_path):
    """A run moves the zoo_batch_* families."""
    from analytics_zoo_tpu_torch.common.observability import batch_metrics

    m = batch_metrics()
    rows0, shards0 = m["rows"].value, m["shards"].value
    x = _data(40)
    job = BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                          pipeline_depth=0, prefetch=0)
    BatchJobRunner(job, OutputSpec(str(tmp_path / "o"),
                                   rows_per_shard=10)).run()
    assert m["rows"].value - rows0 == 40
    assert m["shards"].value - shards0 == 4
    assert m["rows_per_sec"].value > 0


# ---------------------------------------------------------------------------
# source contracts (satellite: the row math stands on these)
# ---------------------------------------------------------------------------


def test_filesource_ordering_pin(tmp_path):
    """FileSource's documented contract: class dirs sorted, files sorted
    within each class, len() snapshotted — the order the batch runner's
    shard ranges index into."""
    for cls in ("zebra", "ant", "moth"):
        os.makedirs(tmp_path / cls)
        for fn in ("c.img", "a.img", "b.img"):
            (tmp_path / cls / fn).write_bytes(b"x")
    src = FileSource(str(tmp_path), with_label=True)
    assert len(src) == 9
    assert src.label_map == {"ant": 0, "moth": 1, "zebra": 2}
    uris = [src.entries[i][0] for i in range(len(src))]
    want = [str(tmp_path / cls / fn)
            for cls in ("ant", "moth", "zebra")
            for fn in ("a.img", "b.img", "c.img")]
    assert uris == want
    labels = [src.entries[i][1] for i in range(len(src))]
    assert labels == [0] * 3 + [1] * 3 + [2] * 3
    # len is fixed at construction: a file added later is invisible
    (tmp_path / "ant" / "z.img").write_bytes(b"x")
    assert len(src) == 9
    assert src.fetch(0)["uri"] == want[0]


def test_npy_rows_source(tmp_path):
    """NpyRowsSource: sorted path order, concatenated row index, rows
    are copies."""
    rng = np.random.default_rng(2)
    parts = {"b.npy": rng.standard_normal((4, 3)).astype(np.float32),
             "a.npy": rng.standard_normal((3, 3)).astype(np.float32)}
    for name, arr in parts.items():
        np.save(tmp_path / name, arr)
    src = NpyRowsSource([str(tmp_path / "b.npy"), str(tmp_path / "a.npy")])
    assert len(src) == 7
    want = np.concatenate([parts["a.npy"], parts["b.npy"]])  # sorted order
    got = np.stack([src.fetch(i)[0] for i in range(7)])
    np.testing.assert_array_equal(got, want)
    row = src.fetch(0)[0]
    row[:] = 0  # a copy: mutating it must not corrupt later fetches
    np.testing.assert_array_equal(src.fetch(0)[0], want[0])
    with pytest.raises(ValueError, match="row shape"):
        np.save(tmp_path / "c.npy", np.zeros((2, 5), np.float32))
        NpyRowsSource([str(tmp_path / "a.npy"), str(tmp_path / "c.npy")])


# ---------------------------------------------------------------------------
# writer atomicity + the in-process chaos matrix
# ---------------------------------------------------------------------------


def _reference(tmp_path):
    x = _data()
    model = LinearModel()
    out = str(tmp_path / "ref")
    BatchJobRunner(
        BatchPredictJob(model, ArraySource(x), batch_size=16,
                        pad_to_bucket=(4, 8, 16), pipeline_depth=2),
        OutputSpec(out, rows_per_shard=25)).run()
    return x, model, _shard_digest(out)


@pytest.mark.parametrize("point,skip", [("batch_writer_torn", 2),
                                        ("batch_before_manifest", 1),
                                        ("batch_mid_job_kill", 2)])
def test_chaos_kill_then_resume_bitwise(tmp_path, chaos_raise, point, skip):
    """Die at each shard-commit failure point; the manifest must expose
    only committed shards (torn/uncommitted files invisible to readers),
    and the resumed job's output must be bitwise identical to an
    uninterrupted run's — zero duplicate rows, zero holes."""
    from analytics_zoo_tpu_torch.common.observability import batch_metrics

    x, model, ref_digest = _reference(tmp_path)
    out = str(tmp_path / "out")

    def mkrunner():
        return BatchJobRunner(
            BatchPredictJob(model, ArraySource(x), batch_size=16,
                            pad_to_bucket=(4, 8, 16), pipeline_depth=2),
            OutputSpec(out, rows_per_shard=25))

    disarm = chaos_raise(point, skip=skip)
    with pytest.raises(_Boom):
        mkrunner().run()
    disarm()

    v = verify_output(out)  # committed shards intact, ranges contiguous
    assert not v["complete"]
    assert v["shards"] >= 1
    # a reader sees ONLY committed rows — the torn/unrecorded shard never
    # appears in the manifest-driven row stream
    rows_visible = np.concatenate(list(
        np.asarray(r)[None] for r in iter_output_rows(out)))
    assert rows_visible.shape[0] == v["rows"]
    if point == "batch_before_manifest":
        assert v["uncommitted"], "renamed-but-unrecorded shard must be debris"

    skipped0 = batch_metrics()["resume_skipped"].value
    report = mkrunner().run(resume=True)
    assert report["complete"]
    assert report["skipped_shards"] == v["shards"]
    assert batch_metrics()["resume_skipped"].value - skipped0 == v["shards"]
    assert _shard_digest(out) == ref_digest
    final = verify_output(out)
    assert final["complete"] and final["rows"] == 103
    assert final["uncommitted"] == []


def test_resume_fingerprint_mismatch_is_loud(tmp_path, chaos_raise):
    """Resuming with different batch geometry must refuse before scoring
    a single row."""
    x, model, _ = _reference(tmp_path)
    out = str(tmp_path / "out")
    disarm = chaos_raise("batch_mid_job_kill", skip=1)
    with pytest.raises(_Boom):
        BatchJobRunner(
            BatchPredictJob(model, ArraySource(x), batch_size=16,
                            pad_to_bucket=(4, 8, 16)),
            OutputSpec(out, rows_per_shard=25)).run()
    disarm()
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        BatchJobRunner(
            BatchPredictJob(model, ArraySource(x), batch_size=8),
            OutputSpec(out, rows_per_shard=25)).run(resume=True)


def test_existing_output_guards(tmp_path):
    """A complete output raises without resume/overwrite; resume no-ops;
    overwrite discards and rescores. A partial output raises without
    resume."""
    x = _data(30)
    model = LinearModel()

    def mkrunner():
        return BatchJobRunner(
            BatchPredictJob(model, ArraySource(x), batch_size=16,
                            prefetch=0, pipeline_depth=0),
            OutputSpec(str(tmp_path / "o"), rows_per_shard=10))

    r1 = mkrunner().run()
    assert r1["complete"]
    with pytest.raises(FileExistsError, match="completed batch output"):
        mkrunner().run()
    noop = mkrunner().run(resume=True)
    assert noop["rows"] == 30 and noop["skipped_shards"] == 3
    r2 = mkrunner().run(overwrite=True)
    assert r2["rows"] == 30 and r2["skipped_shards"] == 0


def test_verify_corrupted_shard_is_loud(tmp_path):
    """A flipped byte in a committed shard must raise ShardCorruptError
    (the CheckpointCorruptError family) from verify_output, and exit 1
    from the inspect CLI."""
    x = _data(60)
    out = str(tmp_path / "o")
    BatchJobRunner(
        BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                        prefetch=0, pipeline_depth=0),
        OutputSpec(out, rows_per_shard=20)).run()
    shard = os.path.join(out, read_manifest(out)["shards"][1]["file"])
    blob = bytearray(open(shard, "rb").read())
    blob[-1] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    from analytics_zoo_tpu_torch.ft.atomic import CheckpointCorruptError

    with pytest.raises(ShardCorruptError, match="checksum mismatch"):
        verify_output(out)
    assert issubclass(ShardCorruptError, CheckpointCorruptError)


# ---------------------------------------------------------------------------
# the JAX package's inspect CLI over the port's output
# ---------------------------------------------------------------------------


def _inspect(load_script, argv):
    mod = load_script("ckpt_inspect.py")
    return mod, mod.main(argv)


@pytest.fixture
def inspect_mod():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ckpt_inspect", os.path.join(REPO, "scripts", "ckpt_inspect.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ckpt_inspect_batch_output(tmp_path, inspect_mod, capsys):
    """The inspect CLI auto-detects a batch output: committed shards
    with row ranges, COMMIT status, verify ok."""
    x = _data(60)
    out = str(tmp_path / "o")
    BatchJobRunner(
        BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                        prefetch=0, pipeline_depth=0),
        OutputSpec(out, rows_per_shard=20)).run()
    rows = inspect_mod.main([out, "--verify"])
    text = capsys.readouterr().out
    assert len(rows) == 3
    assert all(r["status"] == "committed" for r in rows)
    assert "COMPLETE" in text and "[0, 20)" in text


def test_ckpt_inspect_batch_corrupt_exits_1(tmp_path, inspect_mod, capsys):
    x = _data(60)
    out = str(tmp_path / "o")
    BatchJobRunner(
        BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                        prefetch=0, pipeline_depth=0),
        OutputSpec(out, rows_per_shard=20)).run()
    shard = os.path.join(out, read_manifest(out)["shards"][0]["file"])
    blob = bytearray(open(shard, "rb").read())
    blob[10] ^= 0xFF
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(SystemExit) as exc:
        inspect_mod.main([out, "--verify"])
    assert exc.value.code == 1
    assert "CORRUPT" in capsys.readouterr().out


def test_ckpt_inspect_reports_uncommitted_debris(tmp_path, inspect_mod,
                                                 chaos_raise, capsys):
    """Death between shard rename and manifest update leaves debris the
    inspect CLI must report as UNCOMMITTED (and not count as rows)."""
    x = _data()
    out = str(tmp_path / "o")
    disarm = chaos_raise("batch_before_manifest", skip=1)
    with pytest.raises(_Boom):
        BatchJobRunner(
            BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                            prefetch=0, pipeline_depth=0),
            OutputSpec(out, rows_per_shard=25)).run()
    disarm()
    rows = inspect_mod.main([out, "--verify"])
    statuses = {r["status"] for r in rows}
    assert "UNCOMMITTED" in statuses
    assert "IN PROGRESS / DEAD" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the subprocess kill matrix
# ---------------------------------------------------------------------------


def _worker_env(chaos_point=None, skip=0, resume=False) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env.pop("AZOO_FT_CHAOS", None)
    env.pop("AZOO_FT_CHAOS_SKIP", None)
    env.pop("BATCH_RESUME", None)
    if chaos_point is not None:
        env["AZOO_FT_CHAOS"] = chaos_point
        env["AZOO_FT_CHAOS_SKIP"] = str(skip)
    if resume:
        env["BATCH_RESUME"] = "1"
    return env


def _run_worker(out_dir, report, env) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, WORKER, str(out_dir), str(report)],
        env=env, capture_output=True, text=True, timeout=240)


@pytest.fixture(scope="module")
def subprocess_reference(tmp_path_factory):
    """One uninterrupted worker run — the shard bytes every kill/resume
    pair must reproduce."""
    d = tmp_path_factory.mktemp("batch_ref")
    out = d / "out"
    proc = _run_worker(out, d / "report.json", _worker_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    return _shard_digest(str(out))


def _kill_and_resume(tmp_path, ref_digest, point, skip=2):
    out = tmp_path / "out"
    report = tmp_path / "report.json"
    proc = _run_worker(out, report, _worker_env(point, skip=skip))
    assert proc.returncode == chaos.EXIT_CODE, (
        f"worker should have died at '{point}' (rc={proc.returncode})\n"
        + proc.stderr[-3000:])
    assert not report.exists(), "killed run must not have finished"
    partial = verify_output(str(out))
    assert not partial["complete"] and partial["shards"] >= 1
    proc = _run_worker(out, report, _worker_env(resume=True))
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(report.read_text())
    assert doc["complete"] and doc["skipped_shards"] == partial["shards"]
    assert _shard_digest(str(out)) == ref_digest, (
        "resumed output is not bitwise identical to the uninterrupted "
        "run's")
    final = verify_output(str(out))
    assert final["complete"] and final["uncommitted"] == []


def test_subprocess_kill_mid_job_then_resume_bitwise(
        tmp_path, subprocess_reference):
    """A real process dies between two committed shards (the plain preemption geometry), restarts with --resume, and
    reproduces the uninterrupted output bitwise."""
    _kill_and_resume(tmp_path, subprocess_reference, "batch_mid_job_kill")


@pytest.mark.parametrize("point", [p for p in chaos.BATCH_POINTS
                                   if p != "batch_mid_job_kill"])
def test_subprocess_kill_matrix_then_resume_bitwise(
        tmp_path, subprocess_reference, point):
    """The rest of the batch kill matrix (2 process boots per point)."""
    _kill_and_resume(tmp_path, subprocess_reference, point, skip=1)


# ---------------------------------------------------------------------------
# host_batches + pipeline integration
# ---------------------------------------------------------------------------


def test_host_batches_deterministic_and_resumable():
    """Pipeline.host_batches: dataset order, seed pinned, start_step
    resumes the same stream (the feed contract the job leans on)."""
    x = _data(40)
    pipe = Pipeline(ArraySource(x)).batch(16, pad_to_bucket=(4, 8, 16))
    full = [b for b, _y, _m in pipe.host_batches()]
    resumed = [b for b, _y, _m in pipe.host_batches(start_step=1)]
    np.testing.assert_array_equal(np.concatenate(full[1:]),
                                  np.concatenate(resumed))
    # with a prefetch stage the stream is identical, just async
    pipe2 = pipe.prefetch(2)
    pre = [b for b, _y, _m in pipe2.host_batches()]
    np.testing.assert_array_equal(np.concatenate(full),
                                  np.concatenate(pre))


# ---------------------------------------------------------------------------
# what raises
# ---------------------------------------------------------------------------


def test_aot_cache_and_sharding_plan_raise_naming_their_items(tmp_path):
    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.inference import InferenceModel

    x = _data(8)
    with pytest.raises(NotImplementedError, match="no persistent executable cache"):
        BatchPredictJob(LinearModel(), ArraySource(x),
                        aot_cache_dir=str(tmp_path / "aot"))
    port.init_nncontext(device="cpu")
    try:
        # through the model's own set_aot_cache where it has one
        with pytest.raises(NotImplementedError, match="no persistent executable cache"):
            BatchPredictJob(InferenceModel(), ArraySource(x),
                            aot_cache_dir=str(tmp_path / "aot"))
    finally:
        port.stop_nncontext()
    # a sharding plan needs a model that takes one (the JAX package's
    # TypeError; tests/test_torch_mesh.py drives the plan itself)
    with pytest.raises(TypeError, match="set_sharding_plan"):
        BatchPredictJob(LinearModel(), ArraySource(x), sharding_plan=object())
    np.save(tmp_path / "rows.npy", x)
    proc = subprocess.run(
        [sys.executable, CLI, "--model", str(tmp_path), "--input",
         str(tmp_path / "rows.npy"), "--output", str(tmp_path / "o"),
         "--device", "cpu", "--aot-cache-dir", str(tmp_path / "aot")],
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr
    assert "no persistent executable cache" in proc.stderr
    assert not os.path.exists(tmp_path / "o")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

USERS, ITEMS, CLASSES = 40, 60, 4


def _ncf_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(1, USERS + 1, n),
                     rng.integers(1, ITEMS + 1, n)], axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def saved_ncf(tmp_path_factory):
    """A JAX NeuralCF saved once with ``save_model``: both packages load
    this directory, so both score with the same weights."""
    from analytics_zoo_tpu.keras.engine import base as jbase
    from analytics_zoo_tpu.models import recommendation as jrec

    jbase.reset_name_counts()
    path = str(tmp_path_factory.mktemp("ncf") / "model")
    jrec.NeuralCF(USERS, ITEMS, CLASSES).save_model(path)
    return path


def _jax_run(model_dir, rows, out, **job_kw):
    from analytics_zoo_tpu import batch as jbatch
    from analytics_zoo_tpu.data.sources import ArraySource as JArraySource
    from analytics_zoo_tpu.inference.inference_model import (
        InferenceModel as JaxInferenceModel,
    )

    im = JaxInferenceModel()
    im.do_load(model_dir)
    job = jbatch.BatchPredictJob(im, JArraySource(rows), **job_kw)
    return jbatch.BatchJobRunner(
        job, jbatch.OutputSpec(out, rows_per_shard=48)).run()


def _port_run(model_dir, rows, out, **job_kw):
    import analytics_zoo_tpu_torch as port
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.keras.engine.base import reset_name_counts

    port.init_nncontext(device="cpu")
    try:
        im = InferenceModel()
        im.do_load(model_dir)
        job = BatchPredictJob(im, ArraySource(rows), **job_kw)
        return BatchJobRunner(job, OutputSpec(out, rows_per_shard=48)).run()
    finally:
        port.stop_nncontext()
        reset_name_counts()


def test_runner_matches_the_jax_runner(tmp_path, saved_ncf):
    """The same rows and weights through both runners: equal manifests
    (row ranges, fingerprint), scores within 1e-5, and each package's
    verify_output accepts the other's directory."""
    from analytics_zoo_tpu import batch as jbatch

    rows = _ncf_rows(203, seed=1)
    kw = dict(batch_size=32, pad_to_bucket=(8, 16, 32), pipeline_depth=2)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    jrep = _jax_run(saved_ncf, rows, jout, **kw)
    prep = _port_run(saved_ncf, rows, pout, **kw)
    assert jrep["rows"] == prep["rows"] == 203
    assert jrep["shards"] == prep["shards"] == 5
    jm, pm = jbatch.read_manifest(jout), read_manifest(pout)
    assert jm["job"] == pm["job"]
    assert ([(r["file"], r["start_row"], r["end_row"], r["rows"])
             for r in jm["shards"]]
            == [(r["file"], r["start_row"], r["end_row"], r["rows"])
                for r in pm["shards"]])
    jscores = np.concatenate([np.asarray(jbatch.load_shard_rows(
        os.path.join(jout, r["file"]))) for r in jm["shards"]])
    pscores = np.concatenate([np.asarray(load_shard_rows(
        os.path.join(pout, r["file"]))) for r in pm["shards"]])
    assert pscores.shape == jscores.shape == (203, CLASSES)
    assert pscores.dtype == jscores.dtype
    np.testing.assert_allclose(pscores, jscores, rtol=0, atol=1e-5)
    # each package's verifier accepts the other's directory
    assert jbatch.verify_output(pout) == verify_output(pout)
    assert verify_output(jout) == jbatch.verify_output(jout)
    assert verify_output(jout)["complete"]


def test_cross_package_verify_refuses_a_corrupt_port_shard(tmp_path):
    """The JAX verifier is as loud about damage to a port-written shard
    as the port's own."""
    from analytics_zoo_tpu import batch as jbatch

    x = _data(60)
    out = str(tmp_path / "o")
    BatchJobRunner(
        BatchPredictJob(LinearModel(), ArraySource(x), batch_size=16,
                        prefetch=0, pipeline_depth=0),
        OutputSpec(out, rows_per_shard=20)).run()
    assert jbatch.verify_output(out)["rows"] == 60
    shard = os.path.join(out, read_manifest(out)["shards"][2]["file"])
    blob = bytearray(open(shard, "rb").read())
    blob[-2] ^= 0x01
    with open(shard, "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(jbatch.ShardCorruptError, match="checksum mismatch"):
        jbatch.verify_output(out)
    with pytest.raises(ShardCorruptError, match="checksum mismatch"):
        verify_output(out)


def _cli(args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("AZOO_FT_CHAOS", None)
    env.pop("AZOO_FT_CHAOS_SKIP", None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, CLI, *args], env=env,
                          capture_output=True, text=True, timeout=240)


def test_cli_kill_then_resume_is_bitwise(tmp_path, saved_ncf):
    """scripts/torch_batch_predict.py on a saved NeuralCF: killed at
    batch_mid_job_kill, then run with --resume, its shards and manifest
    are bitwise the uninterrupted run's."""
    rows = _ncf_rows(157, seed=2)
    np.save(tmp_path / "rows_b.npy", rows[100:])
    np.save(tmp_path / "rows_a.npy", rows[:100])
    base = ["--model", saved_ncf, "--input", str(tmp_path / "rows_*.npy"),
            "--batch", "16", "--buckets", "4,8,16", "--rows-per-shard",
            "20", "--checkpoint-every", "2", "--device", "cpu"]
    ref = str(tmp_path / "ref")
    proc = _cli(base + ["--output", ref])
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout)["rows"] == 157

    out = str(tmp_path / "out")
    proc = _cli(base + ["--output", out],
                {"AZOO_FT_CHAOS": "batch_mid_job_kill",
                 "AZOO_FT_CHAOS_SKIP": "2"})
    assert proc.returncode == chaos.EXIT_CODE, proc.stderr[-3000:]
    partial = verify_output(out)
    assert not partial["complete"] and partial["shards"] == 3
    proc = _cli(base + ["--output", out, "--resume"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout)
    assert report["complete"] and report["resumed_at_row"] == 60
    assert _shard_digest(out) == _shard_digest(ref)
    for name in ("MANIFEST.json", "COMMIT"):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name
    assert verify_output(out)["complete"]
