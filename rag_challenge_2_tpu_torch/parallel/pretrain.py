"""Data-parallel encoder pretraining over a world of ranks.

The reference trains data-parallel by default: ``pretrain_encoder`` with
no mesh builds ``make_mesh({"data": len(jax.devices()), "model": 1})``
(``rag_challenge_2_tpu/models/pretrain.py:491-493``), and one controller
feeds each global batch to a jitted step that GSPMD splits over the
devices.  Here a device is a rank of a ``torch.distributed`` world:
:func:`pretrain_data_parallel` starts one (``parallel/launch.run_ranks``),
every rank runs ``models/pretrain.pretrain_encoder`` on a ``data`` mesh,
where rank 0 samples each global batch and broadcasts it and every rank
runs the mesh's step, and rank 0's whole weights and history come back.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .launch import run_ranks
from .mesh import make_mesh


def pretrain_rank(device: torch.device, chunk_texts: List[str], axes: Dict[str, int],
                  kw: Dict) -> Tuple[Dict[str, np.ndarray], Dict]:
    """The rank program of :func:`pretrain_data_parallel`:
    ``pretrain_encoder`` on the mesh ``axes`` of the running world, on this
    rank's ``device``.  Returns the whole weights as numpy arrays and the
    history (the same on every rank)."""
    from ..models.pretrain import pretrain_encoder

    kw = dict(kw)
    if kw.get("init_params") is not None:
        kw["init_params"] = {k: torch.from_numpy(v) for k, v in kw["init_params"].items()}
    mesh = make_mesh(axes, dist.get_backend())
    model, info = pretrain_encoder(chunk_texts, device=device, mesh=mesh, **kw)
    return {k: v.cpu().numpy() for k, v in model.module.state_dict().items()}, info


def pretrain_data_parallel(chunk_texts: List[str], world: int, backend: str, device: str,
                           timeout: float = 86_400.0, **kw):
    """``pretrain_encoder`` over ``world`` ranks of a ``backend`` world on
    ``device`` (``parallel/launch.run_ranks``: ``"nccl"`` and ``"cuda"``, a
    card a rank; ``"gloo"`` on ``"cuda"`` (every rank on one card) or on
    ``"cpu"``), data-parallel over a ``{"data": world}`` mesh: the
    counterpart of the reference's default mesh over every device plus
    GSPMD.  ``kw`` are ``pretrain_encoder``'s keywords (``enc_cfg``,
    ``pre_cfg``, ``train_cfg``, ``log_every``, ``teacher_score_fn``, which
    must pickle, ``init_params``); ``batch_size`` must divide over the
    ranks.  ``timeout`` (seconds) bounds the whole world.

    Returns ``(EmbeddingModel on device, info)`` as ``pretrain_encoder``
    does, from rank 0's whole weights and history."""
    from ..models.encoder import EmbeddingModel, EncoderConfig

    if kw.get("init_params") is not None:
        # numpy crosses to the ranks by value; a CPU tensor's storage would
        # be moved into shared memory under the caller
        kw["init_params"] = {k: v.detach().cpu().numpy() for k, v in kw["init_params"].items()}
    sd, info = run_ranks(pretrain_rank, world, backend, device,
                         (list(chunk_texts), {"data": world}, kw), timeout=timeout)
    model = EmbeddingModel(kw.get("enc_cfg") or EncoderConfig(),
                           params={k: torch.from_numpy(v) for k, v in sd.items()},
                           device=resolve_device(device))
    return model, info
