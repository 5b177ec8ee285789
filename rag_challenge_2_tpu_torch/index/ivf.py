"""IVF-Flat clustered index, built and searched on the device.

Port of ``rag_challenge_2_tpu/index/ivf.py``.  Rows are permuted so each
cluster's rows are contiguous (``emb_perm``), ``list_offsets [K+1]`` marks
the lists and ``row_ids`` maps permuted positions back to corpus rows.  A
query scores the centroids, probes its top-``nprobe`` lists and keeps the
top-k of the probed rows.  The probe reads each list as one contiguous
span through kernel K4 (``ops/probe_scores.py``); the row ids (or doc
ids) and int8 row scales of the same spans come through kernel K2
(``ops/span_gather.py``).

The layout (list starts aligned to ``ROW_ALIGN`` rows, ``dma_pad_rows`` of
slack past the last list) and every field are the reference's, so a
sidecar saved by either package loads in the other (``index/store.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from .. import device  # noqa: F401  (full-f32 matmuls)
from ..ops.kmeans import assign_clusters, kmeans, kmeans_batched
from ..ops.probe_scores import ROW_ALIGN, dma_slack_rows, probe_span_scores
from ..ops.quant import quantize_rows
from ..ops.span_gather import gather_posting_spans
from ..ops.topk import NEG_INF, stable_topk
from .schema import CorpusIndex, _move


@dataclasses.dataclass
class IVFIndex:
    centroids: torch.Tensor     # f32 [K, D]
    emb_perm: torch.Tensor      # f32|bf16|int8 [N_pad, D], rows grouped by cluster
    row_ids: torch.Tensor       # i32 [N_pad]: permuted position → corpus row (-1 pad)
    pos_cluster: torch.Tensor   # i32 [N_pad]: cluster id per position (K pad)
    list_offsets: torch.Tensor  # i32 [K + 1]
    row_scale: Optional[torch.Tensor] = None     # f32 [N_pad] for an int8 store
    # per-cluster min/max ORIGINAL row id (-1/-1 for empty lists): interval
    # overlap gives probe eligibility under contiguous-range routing
    list_row_min: Optional[torch.Tensor] = None  # i32 [K]
    list_row_max: Optional[torch.Tensor] = None  # i32 [K]
    # bool [K + 1, n_docs]: does cluster c hold rows of doc d (cluster-
    # ordered corpora, doc-equality routing)
    cluster_doc: Optional[torch.Tensor] = None
    k_clusters: int = 0
    max_list: int = 0
    dim: int = 0
    # index-format layout contract: list starts aligned to `list_align`
    # rows (0 = unaligned legacy layout), `dma_pad_rows` rows past the end
    list_align: int = 0
    dma_pad_rows: int = 0

    @property
    def device(self) -> torch.device:
        return self.emb_perm.device

    def to(self, device) -> "IVFIndex":
        return _move(self, device)

    def zero_scales(self, n: int) -> torch.Tensor:
        """An f32 zero array of length ``n`` on the index's device, made once
        per index: K2 gathers one i32 and one f32 array, and f32/bf16 stores
        have no row scales to pair with the ids."""
        z = self.__dict__.get("_zero_scales")
        if z is None or z.shape[0] != n:
            z = torch.zeros(n, dtype=torch.float32, device=self.device)
            self.__dict__["_zero_scales"] = z
        return z


@torch.inference_mode()
def build_ivf(
    emb: torch.Tensor,
    n_clusters: Optional[int] = None,
    iters: int = 10,
    seed: int = 0,
    valid: Optional[torch.Tensor] = None,
    max_list_size: Optional[int] = None,
) -> IVFIndex:
    """Cluster and permute ``emb`` on its device.  ``valid`` (bool ``[N]``)
    keeps padding rows out of every list.  ``max_list_size`` is a SOFT cap: oversized
    clusters are re-clustered into ⌈n/cap⌉ sub-centroids, up to 3 rounds."""
    N, D = emb.shape
    dev = emb.device
    rows = (np.arange(N) if valid is None
            else np.flatnonzero(valid.cpu().numpy()))
    K = n_clusters or max(1, int(np.sqrt(len(rows)) * 4))
    # the matrix stays on the device; only [N]-sized index arrays cross
    x = emb.float()
    if len(rows) != N:
        x = x[torch.as_tensor(rows, device=dev)]
    centroids, assign = kmeans(x, K, iters=iters, seed=seed)
    assign = assign.cpu().numpy()
    if max_list_size:
        centroids, assign = _balance_clusters(
            x, assign, centroids, max_list_size, iters, seed)
        K = centroids.shape[0]

    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order]
    counts = np.bincount(sorted_assign, minlength=K)
    offsets, n_pad = _aligned_offsets(counts)
    within = np.arange(len(rows)) - np.repeat(
        np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    pos = offsets[:-1][sorted_assign] + within
    pos_of_x = np.empty(len(rows), np.int64)
    pos_of_x[order] = pos
    # The one in-place update of the build: rows are copied straight into
    # a zeroed destination, so the peak holds source + destination only
    # (x[order] as an intermediate would be a third full-matrix buffer).
    emb_perm = torch.zeros((n_pad, D), dtype=emb.dtype, device=dev)
    emb_perm.index_copy_(0, torch.as_tensor(pos_of_x, device=dev),
                         x.to(emb.dtype))
    rows_sorted = rows[order]
    row_ids = np.full((n_pad,), -1, np.int32)
    pos_cluster = np.full((n_pad,), K, np.int32)
    row_ids[pos] = rows_sorted
    pos_cluster[pos] = sorted_assign
    lmin, lmax = _list_row_bounds(sorted_assign, rows_sorted, K)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return IVFIndex(
        centroids=centroids,
        emb_perm=emb_perm,
        row_ids=t(row_ids),
        pos_cluster=t(pos_cluster),
        list_offsets=t(offsets.astype(np.int32)),
        list_row_min=t(lmin),
        list_row_max=t(lmax),
        k_clusters=K,
        max_list=int(counts.max()) if len(counts) else 0,
        dim=D,
        list_align=ROW_ALIGN,
        dma_pad_rows=n_pad - int(offsets[-1]),
    )


def _aligned_offsets(counts: np.ndarray):
    """List offsets padded to ``ROW_ALIGN`` rows, and the total row count
    (slack included, a multiple of 128)."""
    K = len(counts)
    aligned = -(-counts // ROW_ALIGN) * ROW_ALIGN
    offsets = np.zeros((K + 1,), np.int64)
    np.cumsum(aligned, out=offsets[1:])
    max_list = int(counts.max()) if K else 0
    n_pad = int(offsets[-1]) + dma_slack_rows(max_list)
    n_pad = -(-n_pad // 128) * 128
    return offsets, n_pad


def _list_row_bounds(sorted_assign, rows_sorted, K):
    """Per-cluster min/max original row id (-1 for empty lists)."""
    lmin = np.full((K,), np.iinfo(np.int32).max, np.int64)
    lmax = np.full((K,), -1, np.int64)
    np.minimum.at(lmin, sorted_assign, rows_sorted)
    np.maximum.at(lmax, sorted_assign, rows_sorted)
    lmin[lmax < 0] = -1
    return lmin.astype(np.int32), lmax.astype(np.int32)


# bound on the [G, n, D] gather one batched sub-split holds on the device
_BALANCE_BATCH_BYTES = 2 << 30


def _balance_clusters(x, assign, centroids, max_list_size, iters, seed):
    """Sub-split oversized clusters (the soft cap of :func:`build_ivf`).

    ``x`` are the vectors ``assign`` refers to.  Oversized clusters are
    grouped by (padded size, k_sub), and each group sub-splits through one
    :func:`kmeans_batched` call.  Returns ``(centroids f32 [K', D] on
    x's device, assign np.int32 [len(x)])``."""
    assign = np.asarray(assign).copy()
    cent_list = list(centroids.cpu().numpy())
    D = x.shape[1]
    for rnd in range(3):
        counts = np.bincount(assign, minlength=len(cent_list))
        oversized = np.nonzero(counts > max_list_size)[0]
        if len(oversized) == 0:
            break
        groups: dict = {}
        for c in oversized:
            n_c = int(counts[c])
            k_sub = int(np.ceil(n_c / max_list_size))
            pad_n = 1 << (n_c - 1).bit_length()
            groups.setdefault((pad_n, min(k_sub, pad_n)), []).append(int(c))
        for (pad_n, k_sub), cids in sorted(groups.items()):
            g_cap = max(1, _BALANCE_BATCH_BYTES // (pad_n * D * 4))
            for s in range(0, len(cids), g_cap):
                batch = cids[s : s + g_cap]
                members_b, idx_rows = [], []
                for c in batch:
                    members = np.nonzero(assign == c)[0]
                    members_b.append(members)
                    # pad rows CYCLE through the members so no single
                    # point is double-weighted during sub-clustering
                    idx_rows.append(members[np.arange(pad_n) % len(members)])
                xs = x[torch.as_tensor(np.stack(idx_rows), device=x.device)]
                sub_c, sub_a = kmeans_batched(
                    xs, k_sub, iters=max(3, iters // 2),
                    seed=seed + rnd * 131071 + batch[0] + 1,
                )
                sub_c = sub_c.cpu().numpy()
                sub_a = sub_a.cpu().numpy()
                del xs
                for gi, c in enumerate(batch):
                    members = members_b[gi]
                    a_g = sub_a[gi, : len(members)]
                    # the first sub-cluster reuses slot c; the rest append
                    cent_list[c] = sub_c[gi, 0]
                    for j in range(1, k_sub):
                        new_id = len(cent_list)
                        cent_list.append(sub_c[gi, j])
                        assign[members[a_g == j]] = new_id
    cents = torch.as_tensor(np.stack(cent_list), dtype=torch.float32,
                            device=x.device)
    return cents, assign


@torch.inference_mode()
def build_ivf_streaming(
    chunk_provider: Callable[[int], torch.Tensor],
    n_chunks: int,
    n_clusters: Optional[int] = None,
    iters: int = 10,
    seed: int = 0,
    sample_rows: int = 500_000,
    max_list_size: Optional[int] = None,
    quantize: bool = False,
) -> IVFIndex:
    """IVF build for stores whose flat and permuted copies do not fit the
    device together: never more than ONE chunk of source beside the
    destination, in three streamed passes.

    1. Train: k-means (+ soft balancing, cap scaled by the sample fraction)
       over ``sample_rows`` drawn evenly from every chunk.
    2. Assign: one product pass per chunk; only i32 assignments reach the
       host, giving exact list offsets.
    3. Scatter: each chunk (quantized per row iff ``quantize``) is copied in
       place into its clusters' slots of the destination.

    ``chunk_provider(i)`` returns row chunk i as f32 ``[C_i, D]`` on the
    device, deterministically (it is called twice per chunk).
    """
    sizes, samples = [], []
    for i in range(n_chunks):
        chunk = chunk_provider(i)
        sizes.append(chunk.shape[0])
        per = max(1, sample_rows // n_chunks)
        stride = max(1, chunk.shape[0] // per)
        samples.append(chunk[::stride][:per].float())
        del chunk
    N = int(np.sum(sizes))
    starts = np.zeros(n_chunks, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    x_s = torch.cat(samples, dim=0)
    del samples
    S = x_s.shape[0]
    dev = x_s.device
    K = n_clusters or max(1, int(np.sqrt(N) * 4))
    centroids, assign_s = kmeans(x_s, K, iters=iters, seed=seed)
    if max_list_size:
        cap_s = max(1, int(max_list_size * S / N))
        centroids, _ = _balance_clusters(
            x_s, assign_s.cpu().numpy(), centroids, cap_s, iters, seed)
    K = centroids.shape[0]
    del x_s, assign_s

    assigns = [assign_clusters(chunk_provider(i), centroids).cpu().numpy()
               for i in range(n_chunks)]
    counts = np.bincount(np.concatenate(assigns), minlength=K)
    offsets, n_pad = _aligned_offsets(counts)

    D = int(centroids.shape[1])
    dest = None
    row_scale = (torch.zeros((n_pad,), dtype=torch.float32, device=dev)
                 if quantize else None)
    row_ids = np.full((n_pad,), -1, np.int32)
    cursor = offsets[:K].copy()
    for i in range(n_chunks):
        chunk = chunk_provider(i)
        if dest is None:
            dtype = torch.int8 if quantize else chunk.dtype
            dest = torch.zeros((n_pad, D), dtype=dtype, device=dev)
        a = assigns[i]
        # per-row destination slot: the next free position of its list
        pos = np.empty(len(a), np.int64)
        for c in np.unique(a):
            m = a == c
            n_c = int(m.sum())
            pos[m] = cursor[c] + np.arange(n_c)
            cursor[c] += n_c
        row_ids[pos] = starts[i] + np.arange(len(a))
        pos_t = torch.as_tensor(pos, device=dev)
        if quantize:
            q8, sc = quantize_rows(chunk)
            dest.index_copy_(0, pos_t, q8)
            row_scale.index_copy_(0, pos_t, sc)
        else:
            dest.index_copy_(0, pos_t, chunk.to(dest.dtype))
        del chunk

    pos_cluster = np.full((n_pad,), K, np.int32)
    for c in range(K):
        pos_cluster[offsets[c] : offsets[c] + counts[c]] = c
    live = row_ids >= 0
    lmin, lmax = _list_row_bounds(
        pos_cluster[live], row_ids[live].astype(np.int64), K)

    def t(a):
        return torch.as_tensor(a, device=dev)

    return IVFIndex(
        centroids=centroids,
        emb_perm=dest,
        row_ids=t(row_ids),
        pos_cluster=t(pos_cluster),
        list_offsets=t(offsets.astype(np.int32)),
        row_scale=row_scale,
        list_row_min=t(lmin),
        list_row_max=t(lmax),
        k_clusters=K,
        max_list=int(counts.max()) if len(counts) else 0,
        dim=D,
        list_align=ROW_ALIGN,
        dma_pad_rows=n_pad - int(offsets[-1]),
    )


def quantize_ivf(index: IVFIndex) -> IVFIndex:
    """int8 variant of a built IVF index: a quarter of the row-store memory
    and of the probe's span bytes.  Idempotent on an int8 index."""
    if index.emb_perm.dtype == torch.int8:
        return index
    emb_i8, scale = quantize_rows(index.emb_perm)
    return dataclasses.replace(index, emb_perm=emb_i8, row_scale=scale)


def cluster_order_index(idx: CorpusIndex, meta, ivf: IVFIndex):
    """Rearrange a corpus into its IVF's cluster order, so ONE row store
    serves the probe path and every flat path: ``new_idx.emb`` IS
    ``ivf.emb_perm`` (no copy).  Metadata columns and chunk texts are
    permuted to match, the BM25 CSR's chunk ids are remapped, and the
    returned IVF's ``row_ids`` become the identity with a ``cluster_doc``
    presence bitmap for doc-equality routing.  Documents are no longer
    contiguous row ranges, so the engine's window becomes 0.

    Returns ``(new_idx, new_meta, new_ivf)``."""
    dev = ivf.device
    row_ids = ivf.row_ids.cpu().numpy()
    P = int(row_ids.shape[0])
    live = row_ids >= 0
    src = np.where(live, row_ids, 0)
    pad_pos = np.flatnonzero(~live)

    def perm(col, fill):
        c = col.cpu().numpy()
        return torch.as_tensor(np.where(live, c[src], fill).astype(c.dtype),
                               device=dev)

    new_sparse = None
    if idx.sparse is not None:
        # padding postings point at an invalid (padded) position; any
        # in-range id is correct, out-of-span postings never score
        sent = int(pad_pos[-1]) if pad_pos.size else 0
        inv = np.full((idx.n_pad,), sent, np.int64)
        inv[row_ids[live]] = np.flatnonzero(live)
        old_cid = idx.sparse.chunk_ids.cpu().numpy()
        new_cid = inv[np.clip(old_cid, 0, idx.n_pad - 1)].astype(np.int32)
        new_clen = np.where(
            live, idx.sparse.chunk_len.cpu().numpy()[src], 0.0
        ).astype(np.float32)
        # dl is per posting: renaming a chunk keeps its length
        new_sparse = dataclasses.replace(
            idx.sparse.to(dev),
            chunk_ids=torch.as_tensor(new_cid, device=dev),
            chunk_len=torch.as_tensor(new_clen, device=dev),
        )

    new_idx = CorpusIndex(
        emb=ivf.emb_perm,
        doc_id=perm(idx.doc_id, -1),
        page=perm(idx.page, -1),
        year=perm(idx.year, -1),
        company_id=perm(idx.company_id, -1),
        kind=perm(idx.kind, -1),
        page_seg=perm(idx.page_seg, 2**30),
        chunk_in_doc=perm(idx.chunk_in_doc, -1),
        valid=torch.as_tensor(
            np.where(live, idx.valid.cpu().numpy()[src], False), device=dev),
        sparse=new_sparse,
        emb_scale=ivf.row_scale if ivf.emb_perm.dtype == torch.int8 else None,
        n_chunks=idx.n_chunks,
        n_pages=idx.n_pages,
        n_docs=idx.n_docs,
        dim=idx.dim,
    )
    new_meta = meta
    if meta is not None:
        texts = meta.chunk_texts
        new_texts = [texts[int(r)] if 0 <= r < len(texts) else ""
                     for r in row_ids]
        new_meta = dataclasses.replace(meta, chunk_texts=new_texts)
    # cluster x doc presence; rows whose doc id lies outside [0, n_docs)
    # are never probe-eligible (doc mode compares ids by equality)
    pos_c = ivf.pos_cluster.cpu().numpy()
    doc_perm = new_idx.doc_id.cpu().numpy()
    n_docs = max(idx.n_docs, 1)
    cd = np.zeros((ivf.k_clusters + 1, n_docs), bool)
    sel = live & (doc_perm >= 0) & (doc_perm < n_docs)
    cd[pos_c[sel], doc_perm[sel]] = True

    new_ivf = dataclasses.replace(
        ivf,
        row_ids=torch.as_tensor(
            np.where(live, np.arange(P), -1).astype(np.int32), device=dev),
        cluster_doc=torch.as_tensor(cd, device=dev),
        # original-row bounds mean nothing once rows ARE positions
        list_row_min=None,
        list_row_max=None,
    )
    return new_idx, new_meta, new_ivf


@torch.inference_mode()
def select_probes(
    index: IVFIndex,
    q: torch.Tensor,
    nprobe: int,
    mask: Optional[torch.Tensor] = None,
    win_start: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,
    pair_doc: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The coarse stage of :func:`ivf_search`: f32 centroid scores, the
    routing mode's cluster eligibility, and the top-``nprobe`` eligible
    clusters per query, ``[B, min(nprobe, K)]`` with ties to the lowest
    cluster id.  A query with no eligible cluster gets clusters 0..P-1."""
    B = q.shape[0]
    coarse = q.float() @ index.centroids.float().T           # [B, K] f32
    K = index.k_clusters
    neg = torch.full_like(coarse, NEG_INF)
    if pair_doc is not None and index.cluster_doc is not None:
        n_docs = index.cluster_doc.shape[1]
        ok_doc = (pair_doc >= 0) & (pair_doc < n_docs)
        elig = index.cluster_doc[:K].T[pair_doc.long().clamp(0, n_docs - 1)]
        coarse = torch.where(elig & ok_doc[:, None], coarse, neg)
    elif win_start is not None and index.list_row_min is not None:
        lo = index.list_row_min[None, :K]
        hi = index.list_row_max[None, :K]
        s_col = win_start[:, None]
        e_col = (win_start + win_len)[:, None]
        elig = (hi >= 0) & (lo < e_col) & (hi >= s_col) & (win_len[:, None] > 0)
        coarse = torch.where(elig, coarse, neg)
    elif mask is not None:
        safe_all = index.row_ids.long().clamp(min=0)
        row_ok = (mask[safe_all] if mask.dim() == 1 else mask[:, safe_all]) & (
            index.row_ids >= 0)                              # [N_pad] or [B, N_pad]
        # scatter-max of bools as a count: a cluster is eligible iff it
        # holds at least one eligible row
        pc = index.pos_cluster.long()
        if row_ok.dim() == 1:
            hits = torch.zeros(K + 1, dtype=torch.float32, device=q.device)
            hits.index_add_(0, pc, row_ok.float())
            coarse = torch.where(hits[None, :K] > 0, coarse, neg)
        else:
            hits = torch.zeros((B, K + 1), dtype=torch.float32, device=q.device)
            hits.index_add_(1, pc, row_ok.float())
            coarse = torch.where(hits[:, :K] > 0, coarse, neg)
    return stable_topk(coarse, min(nprobe, K))[1]


@torch.inference_mode()
def ivf_search(
    index: IVFIndex,
    q: torch.Tensor,
    k: int,
    nprobe: int = 8,
    window: Optional[int] = None,
    mask: Optional[torch.Tensor] = None,
    win_start: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,
    pair_doc: Optional[torch.Tensor] = None,
    pos_doc: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k corpus rows per query: ``(f32 [B, k_eff], i32 [B, k_eff])``
    with ``k_eff = min(k, P * W)``; rows -1 where nothing scored.

    Routing (pick ONE; each selects probes among clusters that hold
    eligible rows, so a routed query never probes only foreign clusters):

    * ``mask`` (``[N]`` or ``[B, N]`` bool over corpus rows): eligibility
      by a scatter-max over ``pos_cluster``, candidates masked by gather.
    * ``win_start``/``win_len`` (i32 ``[B]``): a contiguous original-row
      range per query; eligibility from the per-list row bounds
      (over-approximate), candidates masked by compare.
    * ``pair_doc`` (i32 ``[B]`` routed doc, -1 invalid) with ``pos_doc``
      (i32 doc id per permuted position): the cluster-ordered mode;
      eligibility from ``cluster_doc``, candidates masked by doc equality,
      and the returned rows are permuted positions.

    One formulation serves every mode: :func:`select_probes`, then K4
    over the ``[B * P]`` spans, K2 for the spans' ids (and int8 scales),
    then masks and one stable top-k over ``[B, P * W]`` (ties to the
    earlier probe, then the lower offset, like the reference's scan).
    An f32 store scores q in f32; a bf16 store scores q cast to bf16, as
    the reference's span kernel does; an int8 store scores int8 codes.

    window: per-list span width (defaults to the longest list).
    """
    if win_start is not None and index.list_row_min is None and mask is None:
        raise ValueError(
            "win_start routing requires IVFIndex.list_row_min/max "
            "(absent on this index — a pre-bounds sidecar?); pass a "
            "routing mask instead")
    if pair_doc is not None and pos_doc is None:
        raise ValueError("pair_doc routing needs pos_doc (doc id per position)")
    B = q.shape[0]
    dev = q.device
    W = int(window or max(index.max_list, 1))
    qf = q.float()
    int8_store = index.emb_perm.dtype == torch.int8
    probes = select_probes(index, qf, nprobe, mask=mask, win_start=win_start,
                           win_len=win_len, pair_doc=pair_doc)   # [B, P]
    P = probes.shape[1]
    k_eff = min(k, P * W)

    starts = index.list_offsets[probes]                      # [B, P] i32
    ends = index.list_offsets[probes + 1]
    sf = starts.reshape(B * P).contiguous()
    if int8_store:
        q_span, q_scale = quantize_rows(qf)
    else:
        q_span = qf.to(index.emb_perm.dtype)
    acc = probe_span_scores(
        index.emb_perm, q_span.repeat_interleave(P, dim=0).contiguous(), sf,
        window=W)                                            # [B*P, W] raw dots
    id_arr = pos_doc if pair_doc is not None else index.row_ids
    scale_arr = index.row_scale if int8_store else index.zero_scales(id_arr.shape[0])
    ids_g, scale_g = gather_posting_spans(id_arr, scale_arr, sf, window=W)
    scores = acc.reshape(B, P * W)
    if int8_store:
        scores = scores * q_scale[:, None] * scale_g.reshape(B, P * W)
    ids_flat = ids_g.reshape(B, P * W)
    offs = torch.arange(W, dtype=torch.int32, device=dev)
    # bound each span to its own list: a short list's slot is narrower
    # than W, and the span would run into the NEXT cluster's rows
    in_list = (offs[None, None, :] < (ends - starts)[:, :, None]).reshape(B, P * W)
    ok = in_list & (ids_flat >= 0)                           # pad rows carry -1
    if pair_doc is not None:
        ok = ok & (ids_flat == pair_doc[:, None]) & (pair_doc[:, None] >= 0)
        # candidate rows ARE permuted positions (identity row_ids)
        rows_flat = (sf[:, None] + offs[None, :]).reshape(B, P * W)
    else:
        if win_start is not None:
            ok = ok & (ids_flat >= win_start[:, None]) & (
                ids_flat < (win_start + win_len)[:, None])
        elif mask is not None:
            safe = ids_flat.long().clamp(min=0)
            ok = ok & (mask[safe] if mask.dim() == 1
                       else torch.gather(mask, 1, safe))
        rows_flat = ids_flat
    scores = torch.where(ok, scores, torch.full_like(scores, NEG_INF))
    vals, idx_top = stable_topk(scores, k_eff)
    rows = torch.gather(rows_flat, 1, idx_top)
    rows = torch.where(vals > NEG_INF / 2, rows, torch.full_like(rows, -1))
    return vals, rows.to(torch.int32)
