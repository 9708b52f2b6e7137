"""Score a dataset through a saved model into sharded, resumable output:
the port's counterpart of ``scripts/batch_predict.py``, with the same
arguments and one more, ``--device`` (``cuda`` unless asked otherwise).

The CLI face of the port's batch scoring engine: loads a saved ZooModel
directory (``ZooModel.save_model``) into an
:class:`~analytics_zoo_tpu_torch.inference.inference_model.InferenceModel`,
streams rows from a glob of ``.npy`` files (concatenated along axis 0 in
sorted path order — :class:`~analytics_zoo_tpu_torch.data.sources
.NpyRowsSource`), and runs a
:class:`~analytics_zoo_tpu_torch.batch.runner.BatchJobRunner` into the output
directory. Kill it at any point; re-run with ``--resume`` and it
continues from the last committed shard, producing output bitwise
identical to an uninterrupted run.

::

    python scripts/torch_batch_predict.py --model /models/ncf \\
        --input '/data/rows_*.npy' --output /scored/run1 \\
        --batch 64 --buckets 16,32,64 --rows-per-shard 4096
    # ... preempted ...
    python scripts/torch_batch_predict.py --model /models/ncf \\
        --input '/data/rows_*.npy' --output /scored/run1 --resume \\
        --batch 64 --buckets 16,32,64 --rows-per-shard 4096
    # zero rescored shards

``--aot-cache-dir`` raises ``NotImplementedError``: the port keeps no
persistent executable cache (PyTorch cannot save a CUDA graph, and each
run captures its buckets again at little cost).
"""

from __future__ import annotations

import argparse
import glob as glob_lib
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from analytics_zoo_tpu_torch import init_nncontext  # noqa: E402
from analytics_zoo_tpu_torch.batch import (  # noqa: E402
    BatchJobRunner,
    BatchPredictJob,
    OutputSpec,
)
from analytics_zoo_tpu_torch.data.sources import NpyRowsSource  # noqa: E402
from analytics_zoo_tpu_torch.inference.inference_model import (  # noqa: E402
    InferenceModel,
)


def build_job(args, model=None) -> BatchPredictJob:
    """The job for a parsed CLI namespace (``model`` injectable for
    tests)."""
    paths = sorted(glob_lib.glob(args.input))
    if not paths:
        raise SystemExit(f"--input {args.input!r} matched no files")
    if model is None:
        init_nncontext(device=args.device)
        model = InferenceModel()
        model.do_load(args.model)
    buckets = ([int(b) for b in args.buckets.split(",")]
               if args.buckets else None)
    return BatchPredictJob(
        model, NpyRowsSource(paths), batch_size=args.batch,
        pad_to_bucket=buckets, prefetch=args.prefetch,
        pipeline_depth=args.pipeline_depth,
        aot_cache_dir=args.aot_cache_dir)


def main(argv=None, model=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", required=model is None,
                        help="saved ZooModel directory (InferenceModel"
                             ".do_load)")
    parser.add_argument("--input", required=True,
                        help="glob of .npy row files (axis 0 = rows; "
                             "sorted path order defines the row index)")
    parser.add_argument("--output", required=True,
                        help="output directory (shards + MANIFEST.json "
                             "+ COMMIT)")
    parser.add_argument("--format", choices=("npy", "jsonl"), default="npy")
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--buckets", default=None,
                        help="comma-separated tail-bucket ladder, e.g. "
                             "16,32,64 (default: pad tail to --batch)")
    parser.add_argument("--rows-per-shard", type=int, default=4096)
    parser.add_argument("--prefetch", type=int, default=2,
                        help="host-batch prefetch depth (0 = synchronous)")
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="device batches in flight before blocking "
                             "on a fetch (0 = synchronous scoring)")
    parser.add_argument("--checkpoint-every", type=int, default=8,
                        help="job-state checkpoint cadence, in shards")
    parser.add_argument("--aot-cache-dir", default=None,
                        help="the JAX package's persistent executable "
                             "cache: the port keeps none, so it raises")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the model (default cuda; "
                             "cpu runs without a card)")
    parser.add_argument("--resume", action="store_true",
                        help="continue from the output's committed shards")
    parser.add_argument("--overwrite", action="store_true",
                        help="discard any existing output first")
    args = parser.parse_args(argv)
    if args.aot_cache_dir is not None:
        from analytics_zoo_tpu_torch.inference.inference_model import (
            refuse_aot_cache,
        )

        refuse_aot_cache(f"--aot-cache-dir {args.aot_cache_dir}")

    job = build_job(args, model=model)
    spec = OutputSpec(args.output, fmt=args.format,
                      rows_per_shard=args.rows_per_shard)
    runner = BatchJobRunner(job, spec,
                            checkpoint_every_shards=args.checkpoint_every)
    report = runner.run(resume=args.resume, overwrite=args.overwrite)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main()
