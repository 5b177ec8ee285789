"""k-means on the device: Lloyd's iterations as matmuls and index adds.

Port of ``rag_challenge_2_tpu/ops/kmeans.py``, the coarse quantizer of
the IVF index.  Assignment is one f32 product per row block
(``argmin ‖x−c‖² = argmax (x·c − ‖c‖²/2)``), so the ``[N, K]`` score
matrix never exists whole; the update is a segment sum by ``index_add_``.
The products go to ``torch.matmul`` in full f32 (TF32 is off,
``device.py``), as the JAX package leaves them to XLA.

Initial rows are drawn with ``np.random.default_rng(seed)`` exactly as in
the JAX package, so both start from the same rows.  ``torch.argmax``
returns the first maximum, as ``jnp.argmax`` does.  On the card the index
adds use atomics, so centroids are not bit-reproducible run to run.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import device  # noqa: F401  (full-f32 matmuls)


@torch.inference_mode()
def assign_clusters(x: torch.Tensor, centroids: torch.Tensor,
                    block: int = 16384) -> torch.Tensor:
    """Nearest-centroid id per row, block-streamed: ``[N, D]`` → i32 ``[N]``."""
    N = x.shape[0]
    c = centroids.float()
    half_c2 = 0.5 * (c * c).sum(dim=1)
    out = torch.empty(N, dtype=torch.int32, device=x.device)
    for s in range(0, N, block):
        scores = x[s:s + block].float() @ c.T - half_c2
        out[s:s + block] = scores.argmax(dim=1).to(torch.int32)
    return out


def _assign_batched(xs, cent):
    half = 0.5 * (cent * cent).sum(dim=2)                       # [G, k]
    scores = torch.bmm(xs, cent.transpose(1, 2)) - half[:, None, :]
    return scores.argmax(dim=2).to(torch.int32)                 # [G, n]


@torch.inference_mode()
def _kmeans_batched_iters(xs, cent, k: int, iters: int):
    for _ in range(iters):
        a = _assign_batched(xs, cent)
        onehot = torch.nn.functional.one_hot(a.long(), k).float()  # [G, n, k]
        sums = torch.bmm(onehot.transpose(1, 2), xs)                # [G, k, D]
        counts = onehot.sum(dim=1)                                  # [G, k]
        new = sums / counts.clamp(min=1.0)[:, :, None]
        cent = torch.where(counts[:, :, None] > 0, new, cent)
    return cent, _assign_batched(xs, cent)


def kmeans_batched(xs: torch.Tensor, k: int, iters: int = 10,
                   seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's over G independent small problems at once:
    ``[G, n, D]`` → ``(centroids [G, k, D], assignments i32 [G, n])``,
    with ``k`` clamped to ``n``.  Built for IVF list balancing."""
    G, n, D = xs.shape
    rng = np.random.default_rng(seed)
    k = min(k, n)
    init = np.stack([
        rng.choice(n, size=k, replace=False) for _ in range(G)
    ]).astype(np.int64)
    xs = xs.float()
    g_idx = torch.arange(G, device=xs.device)[:, None]
    cent0 = xs[g_idx, torch.as_tensor(init, device=xs.device)]
    return _kmeans_batched_iters(xs, cent0, k=k, iters=iters)


def kmeans(x: torch.Tensor, k: int, iters: int = 10, seed: int = 0,
           block: int = 16384, *, n_before: int = 0, n_total: Optional[int] = None,
           all_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means: ``(centroids f32 [k, D], assignments i32 [N])``.
    Init = ``k`` distinct random rows (zero rows beyond N); empty clusters
    keep their centroid.

    Over rows that live on the ranks of a world (called on every rank):
    ``x`` holds this rank's rows, rows ``[n_before, n_before + N)`` of the
    ``n_total`` rows the ranks hold in rank order, and ``all_sum(t)`` sums
    ``t`` over the ranks in place and returns it.  The initial rows are the
    same draw over the global row indices, each read from its owner (the
    owner writes it, the others zeros, one sum); each iteration sums the
    clusters' sums and counts over the ranks.  Every rank gets the same
    centroids, equal to one device's on all the rows up to the order of
    the f32 sums, and its own rows' assignments."""
    N, D = x.shape
    n_total = N if n_total is None else n_total
    rng = np.random.default_rng(seed)
    init_rows = rng.choice(n_total, size=min(k, n_total), replace=False)
    own = (init_rows >= n_before) & (init_rows < n_before + N)
    centroids = torch.zeros((k, D), dtype=torch.float32, device=x.device)
    if own.any():
        centroids[torch.as_tensor(np.flatnonzero(own), device=x.device)] = x[
            torch.as_tensor(init_rows[own] - n_before, device=x.device)].float()
    if all_sum is not None:
        all_sum(centroids)
    ones = torch.ones(N, device=x.device)
    for _ in range(iters):
        idx = assign_clusters(x, centroids, block=block).long()
        # [k, D] sums beside the [k] counts: one all-reduce for both
        acc = torch.zeros((k, D + 1), dtype=torch.float32, device=x.device)
        acc[:, :D].index_add_(0, idx, x.float())
        acc[:, D].index_add_(0, idx, ones)
        if all_sum is not None:
            all_sum(acc)
        counts = acc[:, D]
        new = acc[:, :D] / counts.clamp(min=1.0)[:, None]
        centroids = torch.where(counts[:, None] > 0, new, centroids)
    return centroids, assign_clusters(x, centroids, block=block)
