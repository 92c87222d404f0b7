"""GPipe-style pipeline parallelism over a mesh axis (the port of
``src/repro/runtime/pipeline.py``).

Stages hold consecutive layer groups (params stacked on a leading stage
dim, stage s keeping slice s). Microbatches stream through with the
classic (M + S - 1)-tick schedule; the inter-stage hop i -> i+1 mod S is
a send/recv over the stage axis's process group (``runtime/dist.py``:
gloo, staged through the host), neighbour traffic only, as the
reference's collective-permute.

The reference runs one ``shard_map`` over the stage axis; here each rank
of a rank mesh (``launch/mesh.py``) is one stage and runs the same loop.
The last stage's outputs reach every stage as the reference's ``psum``
of zeros and outputs does: a sum over the stage group in rank order.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..convert import map_tree, tree_items
from .dist import send_recv, sum_ranks


def _stage_slice(tree, s: int, n_stages: int):
    """Stage s's params: leaf[s] of the whole stacked tree, or leaf[0] of
    a tree already placed on the stage axis (leading dim 1)."""
    def pick(_k, a):
        if a.shape[0] == n_stages:
            return a[s]
        if a.shape[0] == 1:
            return a[0]
        raise ValueError(f"a stacked leaf of leading dim {a.shape[0]} for "
                         f"{n_stages} stages")
    return map_tree(pick, tree)


def pipeline_apply(stage_fn: Callable, params_stacked, microbatches,
                   mesh, stage_axis: str = "stage"):
    """Run ``stage_fn(stage_params, x) -> y`` as a pipeline.

    params_stacked: a tree whose leaves have the leading dim n_stages
        (each rank takes its stage's slice) or 1 (already placed).
    microbatches: (M, mb, ...) tensor, the same on every stage.
    mesh: a rank mesh with the axis `stage_axis`.
    Returns the (M, mb, ...) outputs on every stage."""
    group = mesh.group(stage_axis)
    S, sid = group.size, group.index
    M = microbatches.shape[0]
    params = _stage_slice(params_stacked, sid, S)
    outputs = torch.zeros_like(microbatches)
    carry = torch.zeros_like(microbatches[0])
    for t in range(M + S - 1):
        # stage 0 ingests microbatch t (clipped); the others take the wire
        x = microbatches[min(max(t, 0), M - 1)] if sid == 0 else carry
        y = stage_fn(params, x)
        # the last stage emits microbatch t - (S-1)
        if sid == S - 1 and t >= S - 1:
            outputs[min(t - (S - 1), M - 1)] = y
        # shift activations one stage forward
        carry = send_recv(y, (sid + 1) % S, (sid - 1) % S, group)
    # outputs live on the last stage; broadcast to all stages
    mine = outputs if sid == S - 1 else torch.zeros_like(outputs)
    return sum_ranks(mine, group)


def sequential_reference(stage_fn: Callable, params_stacked, microbatches):
    """Oracle: every stage in order on each microbatch, one process."""
    S = next(iter(tree_items(params_stacked)))[1].shape[0]
    stages = [_stage_slice(params_stacked, s, S) for s in range(S)]
    outs = []
    for mb in microbatches:
        h = mb
        for ps in stages:
            h = stage_fn(ps, h)
        outs.append(h)
    return torch.stack(outs)
