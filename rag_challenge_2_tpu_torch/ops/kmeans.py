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

from typing import Tuple

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


@torch.inference_mode()
def _update_centroids(x, assign, old_centroids, k):
    idx = assign.long()
    sums = torch.zeros((k, x.shape[1]), dtype=torch.float32, device=x.device)
    sums.index_add_(0, idx, x.float())
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    counts.index_add_(0, idx, torch.ones(x.shape[0], device=x.device))
    new = sums / counts.clamp(min=1.0)[:, None]
    # empty clusters keep their previous centroid
    return torch.where(counts[:, None] > 0, new, old_centroids), counts


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
           block: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means: ``(centroids f32 [k, D], assignments i32 [N])``.
    Init = ``k`` distinct random rows (zero rows beyond N)."""
    N = x.shape[0]
    rng = np.random.default_rng(seed)
    init_rows = rng.choice(N, size=min(k, N), replace=False)
    centroids = x[torch.as_tensor(init_rows, device=x.device)].float()
    if k > N:
        centroids = torch.cat([centroids, centroids.new_zeros((k - N, x.shape[1]))])
    for _ in range(iters):
        assign = assign_clusters(x, centroids, block=block)
        centroids, _ = _update_centroids(x, assign, centroids, k)
    return centroids, assign_clusters(x, centroids, block=block)
