"""The device mesh of a running world.

Port of ``rag_challenge_2_tpu/parallel/mesh.py``.  A JAX ``Mesh`` names
the axes of a grid of devices that one process drives; here each device
is a rank of a ``torch.distributed`` world (``parallel/launch.py`` starts
one), and the mesh is a ``DeviceMesh`` over the world's ranks with the
same axis names in the same order: ``make_mesh({"slice": 2, "device": 4})``
puts rank r at ``(r // 4, r % 4)``, as JAX lays its devices out.
``mesh.get_local_rank(axis)`` is ``jax.lax.axis_index(axis)`` and
``mesh.get_group(axis)`` the group a collective over that axis runs in.

The training half: :func:`encoder_param_spec` is the reference's
Megatron split of the encoder's parameters over ``model`` (attention
heads, the MLP's hidden features, the experts and the embedding features;
everything else replicated), and :func:`shard_params` keeps this rank's
shard of each parameter (:func:`shard_state_dict` of a whole state dict);
:func:`whole_state_dict` gathers the shards back.  GSPMD pads a dimension
its axis does not divide; here that raises.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .collectives import _gathered

Axes = Union[str, Sequence[str]]


def make_mesh(axes: Dict[str, int], backend: Optional[str] = None,
              device: Optional[str] = None) -> DeviceMesh:
    """The ``DeviceMesh`` of the running world, axis order as given.

    Called on every rank of a world (``launch.run_ranks``).  The mesh must
    cover the world exactly (``prod(axes)`` equal to the world size).
    ``backend``, when given, must be the world's.  ``device`` is the
    mesh's device type: ``"cuda"`` under NCCL (one card per rank, so NCCL
    with more ranks than cards raises), ``"cpu"`` under gloo, whatever
    device the ranks compute on (gloo stages CUDA tensors through host
    memory itself).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs on the ranks of a running world "
                           "(parallel.launch.run_ranks starts one)")
    names = tuple(axes.keys())
    shape = tuple(int(v) for v in axes.values())
    n = math.prod(shape)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(axes)} needs {n} ranks, the world has {world}")
    running = dist.get_backend()
    if backend is not None and backend != running:
        raise ValueError(f"mesh asked for {backend!r}, the world runs {running!r}")
    if running == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if world > cards:
            raise ValueError(f"nccl gives each rank its own card: {world} ranks, "
                             f"{cards} card(s)")
    want = "cuda" if running == "nccl" else "cpu"
    if device is not None and device != want:
        raise ValueError(f"a {running} mesh has device type {want!r}, not {device!r}")
    return init_device_mesh(want, shape, mesh_dim_names=names)


def cpu_mesh(axes: Dict[str, int]) -> DeviceMesh:
    """The mesh of a gloo world on the CPU (tests, dry runs)."""
    return make_mesh(axes, backend="gloo", device="cpu")


def axis_names(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh: DeviceMesh, axis: Axes) -> int:
    """Shards over ``axis``: one axis, or several flattened in order."""
    return math.prod(mesh.size(mesh.mesh_dim_names.index(a))
                     for a in axis_names(axis))


def axis_index(mesh: DeviceMesh, axis: Axes) -> int:
    """This rank's shard index over ``axis`` (``jax.lax.axis_index``); for
    several axes, the row-major flattened index, as ``P((a, b))`` orders
    the shards."""
    idx = 0
    for a in axis_names(axis):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


# ---- encoder parameter sharding rules (tensor parallelism) --------------

def encoder_param_spec(name: str, tensor: torch.Tensor) -> Tuple[Optional[str], ...]:
    """The mesh axis each dim of an :class:`~..models.encoder.Encoder`
    parameter splits over (``None``: not split), by its state-dict name:
    the reference's ``PartitionSpec`` of the matching flax leaf, carried
    through the port's layout (``nn.Linear.weight`` is ``[out, in]``, the
    transpose of a flax kernel, with attention's heads flattened).

    Token and position embeddings split their feature dim; attention's
    query / key / value split their heads (the weight's rows, the bias),
    its out projection its input (the weight's columns; the bias is
    replicated); ``mlp_in`` splits its output, ``mlp_out`` its input; the
    experts' ``[E, ., .]`` kernels split the expert axis; the router, the
    LayerNorms and the final projection are replicated."""
    nd = tensor.dim()
    last = name.rsplit(".", 1)[-1]
    if nd == 0:
        return ()
    if name in ("tok_embed", "pos_embed"):
        return (None, "model")
    if ".moe." in name:
        if ".router." in name:
            return (None,) * nd
        return ("model", None, None)
    for layer, split in ((".query.", "out"), (".key.", "out"), (".value.", "out"),
                         (".mlp_in.", "out"), (".out.", "in"), (".mlp_out.", "in")):
        if layer in name:
            if last == "bias":
                return ("model",) if split == "out" else (None,)
            return ("model", None) if split == "out" else (None, "model")
    return (None,) * nd


def _shard(name: str, t: torch.Tensor, mesh: DeviceMesh, head: int) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` of parameter ``name``
    (``head``: attention's head width, the unit its split keeps whole)."""
    names = mesh.mesh_dim_names
    unit = head if any(f".{a}." in name for a in ("query", "key", "value", "out")) else 1
    for dim, axis in enumerate(encoder_param_spec(name, t)):
        if axis is None or axis not in names:
            continue
        n = mesh.size(names.index(axis))
        if (t.shape[dim] // unit) % n:
            raise ValueError(
                f"{name}: dim {dim} of {t.shape[dim] // unit} "
                f"{'heads' if unit > 1 else 'elements'} does not divide over "
                f"the {n} shards of mesh axis {axis!r}")
        per = t.shape[dim] // n
        t = t.narrow(dim, mesh.get_local_rank(axis) * per, per)
    return t


def shard_params(module: torch.nn.Module, mesh: DeviceMesh) -> torch.nn.Module:
    """Keep this rank's shard of each parameter of ``module`` (an encoder
    holding the full weights) per :func:`encoder_param_spec`, in place, and
    give the module the mesh its forward's collectives run over.  An axis
    the mesh lacks degrades to replication (a ``data x pipe`` mesh has no
    ``model`` axis); a dimension its axis does not divide raises
    ``ValueError`` naming the parameter."""
    head = module.cfg.d_model // module.cfg.n_heads
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.data = _shard(name, p.data, mesh, head).contiguous()
    module.mesh = mesh
    return module


def shard_state_dict(sd: Dict[str, torch.Tensor], mesh: DeviceMesh,
                     n_heads: int) -> Dict[str, torch.Tensor]:
    """This rank's shards of a whole encoder state dict (``n_heads``
    attention heads), for ``load_state_dict`` into a module that
    :func:`shard_params` split."""
    head = sd["tok_embed"].shape[1] // n_heads
    return {name: _shard(name, t, mesh, head) for name, t in sd.items()}


def whole_param(name: str, t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole of a sharded parameter (or of its gradient) ``t`` named
    ``name``: its shards all-gathered over each axis its spec splits it
    over, in shard order.  Called on every rank of the mesh."""
    for dim, axis in enumerate(encoder_param_spec(name, t)):
        if axis is not None and axis in mesh.mesh_dim_names:
            t = _gathered(t, mesh.get_group(axis), dim)
    return t


def whole_state_dict(module: torch.nn.Module, mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """The whole weights of a module that :func:`shard_params` split (the
    inverse of :func:`shard_state_dict`), the same on every rank: a
    ``data`` or ``pipe`` axis keeps every parameter whole already, a
    ``model`` axis's shards are gathered.  Called on every rank."""
    return {name: whole_param(name, t, mesh) for name, t in module.state_dict().items()}
