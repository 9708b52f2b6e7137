"""Pipeline parallelism: GPipe-style stage execution over a mesh axis (port
of ``analytics_zoo_tpu.parallel.pipeline``) on the in-process slot mesh.

The stacked-stage idiom of the JAX package: all stages share one layer
STRUCTURE, their parameters are stacked on a leading ``stages`` axis, and
stage ``s`` runs on slot ``s`` of the mesh's ``pipe`` axis.

Schedule: GPipe fill-and-drain. With S stages and M microbatches the loop
runs T = M + S - 1 ticks; at tick t, stage s processes microbatch
``t - s`` when it is in range, receiving the activation of stage s-1 as an
explicit copy from slot s-1's tensor to slot s's (the JAX package's
``lax.ppermute``), which autograd differentiates, so gradients flow back
through the same copies. The JAX package runs ``stage_fn`` on every
(tick, stage) cell of its ``shard_map`` and zeroes the inactive ones; the
port runs only the S x M active cells, whose results are the same. So a
forward calls ``stage_fn`` S x M times (times the data axis's length when
``data_axis`` shards the microbatches): for a stage of k transformer
blocks, k x M flash launches a stage, n_block x M a forward.
"""

from __future__ import annotations

from typing import Callable

import torch

from analytics_zoo_tpu_torch.common.tree import tree_leaves, tree_map
from analytics_zoo_tpu_torch.mesh.slots import SlotMesh

__all__ = ["stack_stage_params", "pipeline_apply"]


def stack_stage_params(param_list):
    """Stack S per-stage pytrees (identical structure) into one pytree with
    a leading ``stages`` axis: the pipeline parameter layout."""
    return tree_map(lambda *leaves: torch.stack(leaves, dim=0), *param_list)


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def pipeline_apply(stage_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh: SlotMesh, n_microbatches: int,
                   pipe_axis: str = "pipe", data_axis=None) -> torch.Tensor:
    """Run ``x`` through S pipelined stages.

    ``stage_fn(params, x) -> y`` is one stage (shape- and
    dtype-preserving); ``stacked_params``: a pytree whose leaves have a
    leading stages axis of length ``mesh.shape[pipe_axis]``; ``x``:
    (batch, ...) with batch % n_microbatches == 0. Returns the (batch,
    ...) outputs on ``x``'s device. Differentiable end to end.

    ``data_axis``: a second mesh axis over which each microbatch's rows
    are sharded (dp x pp): the slots at data coordinate j run the rows of
    shard j through their own pipe line, and the parameters' gradients
    sum over the shards through autograd. None: every row runs on the
    first pipe line (pure pp)."""
    S = mesh.shape[pipe_axis]
    leaves = tree_leaves(stacked_params)
    if leaves and leaves[0].shape[0] != S:
        raise ValueError(
            f"stacked params lead dim {leaves[0].shape[0]} != mesh "
            f"'{pipe_axis}' size {S}")
    b = x.shape[0]
    if b % n_microbatches:
        raise ValueError(f"batch {b} % microbatches {n_microbatches} != 0")
    mb = b // n_microbatches
    n_data = 1 if data_axis is None else mesh.shape[data_axis]
    if data_axis is not None and mb % n_data != 0:
        raise ValueError(
            f"microbatch size {mb} must divide across mesh axis "
            f"'{data_axis}' ({n_data})")
    micro = x.reshape((n_microbatches, mb) + tuple(x.shape[1:]))
    rows = mb // n_data
    axes = list(mesh.axis_names)
    outputs = []
    for j in range(n_data):
        index = [0] * len(axes)
        if data_axis is not None:
            index[axes.index(data_axis)] = j
        line = []
        for s in range(S):
            index[axes.index(pipe_axis)] = s
            line.append(mesh.devices[tuple(index)])
        params = [tree_map(lambda a, s=s: a[s].to(line[s]), stacked_params)
                  for s in range(S)]
        shard = micro[:, j * rows:(j + 1) * rows]
        outputs.append(_fill_and_drain(stage_fn, params, shard, line,
                                       x.device))
    out = torch.cat(outputs, dim=1) if n_data > 1 else outputs[0]
    return out.reshape((b,) + tuple(out.shape[2:]))


def _fill_and_drain(stage_fn, params, micro, line, out_device):
    """One pipe line's GPipe ticks over the (M, rows, ...) microbatch
    stack: at tick t stage s runs microbatch t - s on slot ``line[s]``,
    its input copied from slot s - 1's output. Returns the last stage's
    (M, rows, ...) outputs on ``out_device``."""
    S, m = len(line), micro.shape[0]
    local = tuple(micro.shape[1:])
    held = [None] * S     # each stage's output of the previous tick
    finished = [None] * m
    for t in range(m + S - 1):
        recv = [None] + [held[s - 1] for s in range(1, S)]
        for s in range(S):
            mb_idx = t - s
            if not 0 <= mb_idx < m:
                held[s] = None
                continue
            x_in = (micro[mb_idx].to(line[0]) if s == 0
                    else recv[s].to(line[s]))
            y = stage_fn(params[s], x_in)
            if tuple(y.shape) != local or y.dtype != micro.dtype:
                raise ValueError(
                    f"pipeline stages must preserve activation shape AND "
                    f"dtype (the ring buffer is typed once); got "
                    f"{local}/{_dtype_name(micro.dtype)} -> "
                    f"{tuple(y.shape)}/{_dtype_name(y.dtype)}")
            held[s] = y
            if s == S - 1:
                finished[mb_idx] = y.to(out_device)
    return torch.stack(finished, dim=0)
