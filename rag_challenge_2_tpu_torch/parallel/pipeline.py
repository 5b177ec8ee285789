"""Pipeline parallelism: GPipe scheduling over a mesh axis.

Port of ``rag_challenge_2_tpu/parallel/pipeline.py``.  The reference
writes the schedule as a ``shard_map`` body: stage ``s`` of ``S`` holds
its slice of the stacked stage parameters, ``M`` microbatches flow through
the classic ``S + M - 1`` steps, and each step's activations rotate one
stage on with ``ppermute``.  Here the body is the rank program itself
(rank ``s`` of the ``axis`` group runs stage ``s``), and the rotation is
``parallel/collectives.send_next``, whose backward sends the gradient
back one stage, so the schedule sits inside a train step.  At the end
only the last stage holds real outputs; a differentiable all-reduce of
``where(last, outs, 0)`` over the group replicates them, as the
reference's ``psum`` does.

A step where a stage has no microbatch (the fill and drain of the
schedule) passes its buffer on unchanged instead of computing on it, as
the reference's ``where(active, y, buf)`` selects.  Each step's output is
tied to the buffer it received (``collectives.tie``), so the backward
reaches every rotation, on every rank, in the same order: a rotation's
backward pairs with its neighbours'.

Called on every rank of the mesh, in the same order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .collectives import all_sum, gather, send_next, tie


def _rows_of(xs: torch.Tensor, extras: Optional[torch.Tensor], group
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """This rank's slice of dim 1 (each microbatch's rows) of ``xs`` and
    ``extras`` over ``group``, which must divide it."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return xs, extras
    if xs.shape[1] % n:
        raise ValueError(f"microbatches of {xs.shape[1]} rows do not divide over "
                         f"{n} shards")
    per, me = xs.shape[1] // n, dist.get_rank(group)
    return (xs.narrow(1, me * per, per),
            None if extras is None else extras.narrow(1, me * per, per))


def pipeline_forward(
    stage_fn: Callable,
    stage_params: Dict[str, torch.Tensor],
    x_microbatches: torch.Tensor,
    mesh: DeviceMesh,
    axis: str = "pipe",
    extras: Optional[torch.Tensor] = None,
    batch_axis: Optional[str] = None,
) -> torch.Tensor:
    """Run M microbatches through S pipelined stages.

    Args:
        stage_fn: ``(params_one_stage, x) -> y`` — or, when ``extras`` is
            given, ``(params_one_stage, x, extra) -> y`` — with
            ``y.shape == x.shape`` (homogeneous stages: the
            transformer-block case).
        stage_params: ``{name: tensor}`` whose tensors have leading dim S;
            the rank of stage ``s`` uses ``[s]`` of each.
        x_microbatches: ``[M, mb, ...]`` input microbatches (the same on
            every rank).
        mesh: mesh containing ``axis`` of size S.
        extras: optional ``[M, mb, ...]`` per-microbatch side input
            (attention masks) that follows each microbatch through every
            stage unchanged.
        batch_axis: optional mesh axis to split the per-microbatch batch
            dim (dim 1) over: data parallelism inside the pipeline.

    Returns:
        ``[M, mb, ...]`` outputs, the same on every rank (differentiable).
    """
    group = mesh.get_group(axis)
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    sid = mesh.get_local_rank(axis)
    batch = mesh.get_group(batch_axis) if batch_axis else None
    xs, extras = _rows_of(x_microbatches, extras, batch)
    M = xs.shape[0]
    params = {k: v[sid] for k, v in stage_params.items()}
    # every rotation is a node of the autograd graph on every rank (its
    # backward pairs with the neighbours'), the first one's input included
    buf = torch.zeros_like(xs[0], requires_grad=torch.is_grad_enabled())
    outs = [torch.zeros_like(xs[0]) for _ in range(M)]
    for t in range(S + M - 1):
        mb = t - sid
        if 0 <= mb < M:
            # stage 0 ingests fresh microbatches; later stages consume the
            # activation rotated in from the previous stage last step
            inp = xs[mb] if sid == 0 else buf
            y = (stage_fn(params, inp) if extras is None
                 else stage_fn(params, inp, extras[mb]))
            y = tie(y, buf)
            if sid == S - 1:
                outs[mb] = y
        else:
            y = buf
        buf = send_next(y, group)
    out = all_sum(tie(torch.stack(outs), buf), group)
    return gather(out, batch, 1)
