"""Differentiable collectives of the parallel train step.

The JAX package trains on a mesh through GSPMD: it states shardings and
XLA derives every collective and its transpose.  Here a rank program
calls the collectives itself, so each one that sits on the forward path
is an ``autograd.Function`` whose backward is its adjoint:

* :func:`gather` (all-gather along a dim) ↔ sum over the group, then this
  rank's slice;
* :func:`all_sum` (all-reduce sum) ↔ all-reduce sum;
* :func:`sum_scatter` (all-reduce sum, then this rank's slice: a
  reduce-scatter) ↔ all-gather;
* :func:`send_next` (the pipeline's rotation: send to the next rank of the
  group, receive from the previous) ↔ send to the previous, receive from
  the next.

**Why the step's gradients come out right.**  Every rank computes the same
global loss ``L`` from its own copies of the replicated tensors and
back-propagates ``L / W`` (``W`` ranks in the world).  With the adjoints
above, autograd gives each rank the derivative of ``Σ_r L / W = L`` with
respect to that rank's copy of each parameter; the derivative with
respect to the parameter itself is then the sum over its copies.
:func:`sum_grads` takes that sum: over every mesh axis a parameter is
replicated over (its spec, ``parallel/mesh.encoder_param_spec``, names
the axes it is split over), with a rank that did not use a parameter
adding zeros.  So each gradient counts once, never once per rank.

Sums go through f32 whatever the tensor's type.  Only ``all_gather``,
``all_reduce`` and point-to-point sends are used: gloo runs them on
CPU tensors and (but for the sends, staged through host memory here) on
CUDA tensors.  A collective over a group of one rank is the identity.

Every function here is called on every rank of its group in the same
order, forward and backward: the ranks build the same autograd graph, so
the backward passes issue their collectives in the same order too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum of ``x`` over ``group`` in f32, back in ``x``'s type
    (``x`` is not modified)."""
    y = x.to(torch.float32, copy=True).contiguous()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def _gathered(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return _gathered(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return _summed(g, ctx.group).narrow(ctx.dim, me * ctx.n, ctx.n), None, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = x.shape[dim] // dist.get_world_size(group)
        return _summed(x, group).narrow(dim, dist.get_rank(group) * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.group, ctx.dim), None, None


def _shift(x: torch.Tensor, group, by: int) -> torch.Tensor:
    """Send ``x`` to the rank ``by`` places on in ``group`` (a ring) and
    return what the rank ``by`` places back sent.  gloo sends CUDA tensors
    through host memory."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    ranks = dist.get_process_group_ranks(group)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    out = (x.detach().cpu() if staged else x.detach()).contiguous()
    into = torch.empty_like(out)
    ops = [dist.P2POp(dist.isend, out, ranks[(me + by) % n], group),
           dist.P2POp(dist.irecv, into, ranks[(me - by) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return into.to(x.device) if staged else into


class _SendNext(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, with zero-gradient edges to ``deps``: autograd then
    runs every node behind ``deps`` on every rank, in one order."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=t, device=v) for s, t, v in ctx.deps))


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` over ``group``, concatenated along ``dim`` in
    rank order (differentiable)."""
    return x if _size(group) == 1 else _Gather.apply(x, group, dim)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group`` (differentiable)."""
    return x if _size(group) == 1 else _Sum.apply(x, group)


def sum_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over ``group``
    (differentiable; ``x.shape[dim]`` divides by the group's size)."""
    return x if _size(group) == 1 else _SumScatter.apply(x, group, dim)


def send_next(x: torch.Tensor, group) -> torch.Tensor:
    """What the previous rank of ``group`` (a ring) sent, having sent ``x``
    to the next; the backward sends the gradient back one rank."""
    return x if _size(group) == 1 else _SendNext.apply(x, group)


def tie(x: torch.Tensor, *deps: torch.Tensor) -> torch.Tensor:
    """``x``, with the graphs behind ``deps`` reached by its backward."""
    deps = [d for d in deps if d.requires_grad]
    return _Tie.apply(x, *deps) if deps else x


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What this rank holds of an encoder on a train mesh.

    ``data``: the batch's rows split over the ``data`` axis (``dp``
    shards, this rank's is ``d``).  ``model``: Megatron tensor parallelism
    (``tp`` shards, this rank's is ``m``): attention heads, the MLP's
    hidden features, the experts and the embedding features.  ``sp``:
    sequence parallelism, the sequence split over ``model`` between
    blocks (only with a ``model`` axis).  A missing axis is one shard.
    """

    data: Optional[object]
    dp: int
    d: int
    model: Optional[object]
    tp: int
    m: int
    sp: bool

    @classmethod
    def of(cls, mesh: DeviceMesh, sequence_parallel: bool) -> "ShardPlan":
        names = mesh.mesh_dim_names

        def axis(a):
            if a not in names:
                return None, 1, 0
            return mesh.get_group(a), mesh.size(names.index(a)), mesh.get_local_rank(a)

        data, model = axis("data"), axis("model")
        return cls(*data, *model, sp=sequence_parallel and model[0] is not None)

    def split_seq(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of the sequence (dim 1) under ``sp``."""
        L = x.shape[1]
        if L % self.tp:
            raise ValueError(f"sequence_parallel: length {L} does not divide "
                             f"over {self.tp} model shards")
        n = L // self.tp
        return x[:, self.m * n:(self.m + 1) * n]

    def token_layout(self, rows: int, length: int, device) -> Tuple[torch.Tensor, int]:
        """``(global_index [G, rows * length], g)``: for the G token holders
        (``data`` shards, times ``model`` shards under ``sp``), in the
        order :meth:`gather_tokens` stacks them, the row-major ``[B, L]``
        index of each of their tokens in the global batch; ``g`` is this
        rank's holder."""
        tp = self.tp if self.sp else 1
        idx = torch.arange(self.dp * rows * tp * length, device=device)
        idx = idx.view(self.dp, rows, tp, length).permute(0, 2, 1, 3)
        return idx.reshape(self.dp * tp, rows * length), self.d * tp + (self.m if self.sp else 0)

    def gather_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """``[G, *x.shape]``: every token holder's ``x`` (differentiable)."""
        x = x.unsqueeze(0)
        if self.sp:
            x = gather(x, self.model, 0)
        return gather(x.unsqueeze(0), self.data, 0).flatten(0, 1)


def sum_grads(named: Iterable[Tuple[str, torch.nn.Parameter]],
              mesh: DeviceMesh, spec_of) -> None:
    """Sum each parameter's gradient over the mesh axes it is replicated
    over (every axis its ``spec_of(name, param)`` does not name), in place;
    a missing gradient counts as zeros.  One all-reduce per axis for each
    set of parameters replicated alike."""
    buckets: Dict[Tuple[str, ...], List[torch.nn.Parameter]] = {}
    for name, p in named:
        split = set(spec_of(name, p))
        axes = tuple(a for a in mesh.mesh_dim_names
                     if a not in split and mesh.size(mesh.mesh_dim_names.index(a)) > 1)
        if axes:
            buckets.setdefault(axes, []).append(p)
    for axes, params in buckets.items():
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flat = torch.cat([p.grad.reshape(-1).float() for p in params])
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p))

