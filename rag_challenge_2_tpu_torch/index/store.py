"""Index persistence: one ``.npz`` plus a ``.meta.json`` sidecar.

Port of ``save_index`` / ``load_index`` from
``rag_challenge_2_tpu/index/store.py`` on the same file format, so an
index written by either package loads in the other.  A bf16 row store is
kept on disk as its raw uint16 bits (npz has no bf16) and read back with
``torch.from_numpy(u16).view(torch.bfloat16)``, which needs no
``ml_dtypes``.  The per-posting ``dl`` and the CSR slack ``dma_pad`` are
derived at load time, not persisted.  IVF sidecars (``save_ivf`` /
``load_ivf``) share the reference's npz layout too.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..utils.tokenize import TOKENIZER_VERSION
from .schema import CorpusIndex, CorpusMeta, DocMeta, SparseIndex

_FORMAT_VERSION = 1
# the dtype names the reference writes into the statics
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.int8: "int8"}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _store_np(t: torch.Tensor) -> np.ndarray:
    """A row store as numpy; bf16 as its raw uint16 bits (npz has no bf16)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _store_tensor(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(
            np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def save_index(path: Path, idx: CorpusIndex,
               meta: Optional[CorpusMeta] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        "emb": _store_np(idx.emb),
        "doc_id": _np(idx.doc_id),
        "page": _np(idx.page),
        "year": _np(idx.year),
        "company_id": _np(idx.company_id),
        "kind": _np(idx.kind),
        "page_seg": _np(idx.page_seg),
        "chunk_in_doc": _np(idx.chunk_in_doc),
        "valid": _np(idx.valid),
    }
    if idx.emb_scale is not None:
        arrays["emb_scale"] = _np(idx.emb_scale)
    statics = {
        "version": _FORMAT_VERSION,
        "n_chunks": idx.n_chunks,
        "n_pages": idx.n_pages,
        "n_docs": idx.n_docs,
        "dim": idx.dim,
        "emb_dtype": _DTYPE_NAMES[idx.emb.dtype],
        "has_sparse": idx.sparse is not None,
        "tokenizer_version": TOKENIZER_VERSION,
    }
    if idx.sparse is not None:
        sp = idx.sparse
        arrays.update(
            sp_indptr=_np(sp.indptr),
            sp_chunk_ids=_np(sp.chunk_ids),
            sp_tf=_np(sp.tf),
            sp_df=_np(sp.df),
            sp_chunk_len=_np(sp.chunk_len),
            sp_avgdl=_np(sp.avgdl),
        )
        statics["sp_vocab_bits"] = sp.vocab_bits
        statics["sp_max_postings"] = sp.max_postings
    np.savez_compressed(path, __statics__=json.dumps(statics), **arrays)

    if meta is not None:
        side = {
            "docs": [dataclasses.asdict(d) for d in meta.docs],
            "companies": meta.companies,
            "chunk_texts": meta.chunk_texts,
            "page_texts": {str(k): v for k, v in meta.page_texts.items()},
            "page_seg_info": [list(t) for t in meta.page_seg_info],
        }
        with open(str(path) + ".meta.json", "w", encoding="utf-8") as f:
            json.dump(side, f, ensure_ascii=False)


def load_index(
    path: Path, device: DeviceLike = None
) -> Tuple[CorpusIndex, Optional[CorpusMeta]]:
    """Load an index saved by either package onto ``device``."""
    path = Path(path)
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        statics = json.loads(str(z["__statics__"]))
        arrays = {name: z[name] for name in z.files if name != "__statics__"}
    stamped = statics.get("tokenizer_version")
    if stamped is not None and stamped != TOKENIZER_VERSION:
        warnings.warn(
            f"index {path} was built with tokenizer {stamped!r}; current is "
            f"{TOKENIZER_VERSION!r} — BM25 term ids and encoder token ids "
            "will not match. Rebuild the index.",
            stacklevel=2,
        )

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sparse = None
    if statics.get("has_sparse"):
        cids = arrays["sp_chunk_ids"]
        clen = arrays["sp_chunk_len"]
        dl = clen[np.clip(cids, 0, len(clen) - 1)].astype(np.float32)
        sparse = SparseIndex(
            indptr=t(arrays["sp_indptr"]),
            chunk_ids=t(cids),
            tf=t(arrays["sp_tf"]),
            df=t(arrays["sp_df"]),
            chunk_len=t(clen),
            avgdl=t(arrays["sp_avgdl"]),
            dl=t(dl),
            vocab_bits=statics["sp_vocab_bits"],
            max_postings=statics["sp_max_postings"],
            dma_pad=int(len(cids) - arrays["sp_indptr"][-1]),
        )
    idx = CorpusIndex(
        emb=_store_tensor(arrays["emb"], statics.get("emb_dtype", ""), device),
        doc_id=t(arrays["doc_id"]),
        page=t(arrays["page"]),
        year=t(arrays["year"]),
        company_id=t(arrays["company_id"]),
        kind=t(arrays["kind"]),
        page_seg=t(arrays["page_seg"]),
        chunk_in_doc=t(arrays["chunk_in_doc"]),
        valid=t(arrays["valid"]),
        sparse=sparse,
        emb_scale=t(arrays["emb_scale"]) if "emb_scale" in arrays else None,
        n_chunks=statics["n_chunks"],
        n_pages=statics["n_pages"],
        n_docs=statics["n_docs"],
        dim=statics["dim"],
    )

    meta = None
    meta_path = Path(str(path) + ".meta.json")
    if meta_path.exists():
        with open(meta_path, "r", encoding="utf-8") as f:
            side = json.load(f)
        meta = CorpusMeta(
            docs=[DocMeta(**d) for d in side["docs"]],
            companies=side["companies"],
            chunk_texts=side["chunk_texts"],
            page_texts={int(k): v for k, v in side["page_texts"].items()},
            page_seg_info=[tuple(p) for p in side["page_seg_info"]],
        )
    return idx, meta


def index_fingerprint(index_path: Path) -> str:
    """Identity stamp of a saved index artifact (size + mtime).  An IVF
    sidecar is valid only for the corpus npz it was clustered from."""
    st = Path(index_path).stat()
    return f"{st.st_size}:{int(st.st_mtime_ns)}"


def save_ivf(path: Path, ivf, fingerprint: Optional[str] = None) -> None:
    """Persist an ``IVFIndex`` (index/ivf.py) as one npz sidecar."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {
        "centroids": _np(ivf.centroids),
        "emb_perm": _store_np(ivf.emb_perm),
        "row_ids": _np(ivf.row_ids),
        "pos_cluster": _np(ivf.pos_cluster),
        "list_offsets": _np(ivf.list_offsets),
    }
    for opt in ("row_scale", "list_row_min", "list_row_max", "cluster_doc"):
        if getattr(ivf, opt) is not None:
            arrays[opt] = _np(getattr(ivf, opt))
    statics = {
        "version": _FORMAT_VERSION,
        "k_clusters": ivf.k_clusters,
        "max_list": ivf.max_list,
        "dim": ivf.dim,
        "emb_dtype": _DTYPE_NAMES[ivf.emb_perm.dtype],
        "fingerprint": fingerprint,
        "list_align": ivf.list_align,
        "dma_pad_rows": ivf.dma_pad_rows,
    }
    np.savez_compressed(path, __statics__=json.dumps(statics), **arrays)


def load_ivf(path: Path, expect_fingerprint: Optional[str] = None,
             device: DeviceLike = None):
    """Load an IVF sidecar saved by either package onto ``device``; None
    when the file is missing or was built from another corpus artifact
    (fingerprint mismatch).  A sidecar from before the layout contract
    loads with ``list_align = dma_pad_rows = 0``."""
    from .ivf import IVFIndex

    path = Path(path)
    if not path.exists():
        return None
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        statics = json.loads(str(z["__statics__"]))
        if (expect_fingerprint is not None
                and statics.get("fingerprint") != expect_fingerprint):
            return None
        arrays = {name: z[name] for name in z.files if name != "__statics__"}

    def t(name):
        if name not in arrays:
            return None
        return torch.from_numpy(np.ascontiguousarray(arrays[name])).to(device)

    return IVFIndex(
        centroids=t("centroids"),
        emb_perm=_store_tensor(arrays["emb_perm"], statics.get("emb_dtype", ""),
                               device),
        row_ids=t("row_ids"),
        pos_cluster=t("pos_cluster"),
        list_offsets=t("list_offsets"),
        row_scale=t("row_scale"),
        list_row_min=t("list_row_min"),
        list_row_max=t("list_row_max"),
        cluster_doc=t("cluster_doc"),
        k_clusters=statics["k_clusters"],
        max_list=statics["max_list"],
        dim=statics["dim"],
        list_align=statics.get("list_align", 0),
        dma_pad_rows=statics.get("dma_pad_rows", 0),
    )
