#!/usr/bin/env python3
"""Hold torch.profiler's record of a CUDA graph replay against the graph.

Captures two kinds of the port's ``InferenceModel`` graphs: the sequence
tier's prefill programs at batch 1 (Seq2seq at ``chip_smoke.py``'s
``SEQ_SIZE`` with the bench's ``SequenceConfig``, random weights from
``--seed``) and one BERT serving bucket, (8, 128), of BERT-base cut to
``--bert-blocks`` blocks (bf16, the flash forward kernel in the graph).
Reads each graph's nodes through libcuda (``chip_smoke.graph_nodes``),
then traces ``--traces`` replays of it under torch.profiler, one replay a
trace, in two modes (CPU and CUDA activities; CUDA only), and the eager
program as many times; with ``--profile-first N``, after N profiler
runs over eager work made before any capture. Prints one JSON line
per graph: its nodes by kind (and the flash forward kernel nodes, by the
names libcuda gives), each trace's count of device records, and, for
a trace that holds fewer records than another of the same graph, the
records missing from it by name and their positions in the fuller
trace's order. Needs one CUDA card:

    python3 scripts/torch_graph_trace_check.py [--seed N] [--traces N]
        [--bert-blocks N] [--profile-first N]
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (  # noqa: E402
    BERT_BASE,
    SEQ_CONFIG,
    SEQ_SIZE,
    graph_nodes,
    make_request,
    missing_records,
    profiler_records,
    smi_line,
)


def check_graph(label, fn, traces):
    from torch.profiler import ProfilerActivity

    nodes = graph_nodes(fn.graph)
    kinds = collections.Counter(k for k, _ in nodes)
    modes = {"cpu+cuda": [ProfilerActivity.CPU, ProfilerActivity.CUDA],
             "cuda": [ProfilerActivity.CUDA]}
    row = {"graph": label, "nodes": dict(kinds),
           "flash_fwd_nodes": sum(k == "kernel" and "flash_fwd_" in n
                                  for k, n in nodes)}
    for mode, acts in modes.items():
        got = [profiler_records(fn.graph.replay, acts)[1]
               for _ in range(traces)]
        full, diffs = missing_records(got)
        row[mode] = {"records": [len(r) for r in got], "fullest": full,
                     "short": [d for d, r in zip(diffs, got)
                               if len(r) < full]}
    row["eager_records"] = [
        len(profiler_records(lambda: fn.eager(*fn.inputs))[1])
        for _ in range(traces)]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--traces", type=int, default=6)
    ap.add_argument("--bert-blocks", type=int, default=2)
    ap.add_argument("--profile-first", type=int, default=0,
                    help="profiler runs over eager work to make before "
                         "any graph is captured")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_graph_trace_check: needs a CUDA card", file=sys.stderr)
        return 2
    from analytics_zoo_tpu_torch import init_nncontext
    from analytics_zoo_tpu_torch.inference import InferenceModel
    from analytics_zoo_tpu_torch.models.seq2seq import Seq2seq
    from analytics_zoo_tpu_torch.serving import (
        ContinuousBatcher,
        SequenceConfig,
    )
    from analytics_zoo_tpu_torch.tfpark.bert import BERTClassifierNet

    print(smi_line(), flush=True)
    init_nncontext()
    torch.manual_seed(args.seed)
    x = torch.randn(256, 256, device="cuda")
    for _ in range(args.profile_first):
        profiler_records(lambda: [x @ x for _ in range(50)])
    s2s = Seq2seq(vocab_size=SEQ_SIZE["vocab"], embed_dim=SEQ_SIZE["embed"],
                  hidden_sizes=SEQ_SIZE["hidden"], cell_type="lstm",
                  bridge="pass")
    im = InferenceModel().do_load_keras(s2s.model)
    cfg = SequenceConfig(**SEQ_CONFIG)
    batcher = ContinuousBatcher(im, cfg, name="seq2seq")
    try:
        batcher.warmup()
    finally:
        batcher.stop(drain=False)
    progs = {k[1]: fn for k, fn in im._compiled.items()
             if k[0] == "__prog__"}
    for l in cfg.length_ladder():
        check_graph(f"seq_prefill_1x{l}", progs[f"seq_prefill_1x{l}"],
                    args.traces)
    rng = np.random.default_rng(args.seed)
    bert = BERTClassifierNet(num_classes=2, hidden_drop=0.0, attn_drop=0.0,
                             **dict(BERT_BASE, n_block=args.bert_blocks))
    bim = InferenceModel().do_load_keras(bert)
    bim.do_optimize(make_request(rng, 8, 128, BERT_BASE["vocab"]))
    (fn,) = bim._compiled.values()
    check_graph(f"bert_{args.bert_blocks}_blocks_8x128", fn, args.traces)
    return 0


if __name__ == "__main__":
    sys.exit(main())
