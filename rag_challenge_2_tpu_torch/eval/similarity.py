"""Semantic-similarity analysis of a document's chunk embeddings.

Port of ``rag_challenge_2_tpu/eval/similarity.py``: the chunk-to-chunk
cosine matrix of one document, the graph the traversal methods walk, as
one f32 matmul on the index's device (an int8 store is dequantized
first), its summary statistics, and a heatmap.  Plotly heatmaps are
emitted when plotly is installed; the numeric artifacts (npz + stats) are
always written.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from .. import device  # noqa: F401  (full-f32 matmuls)
from ..index.schema import CorpusIndex, CorpusMeta


@torch.inference_mode()
def similarity_matrix(index: CorpusIndex, doc_id: int) -> np.ndarray:
    """Full chunk-to-chunk cosine matrix for one document (embeddings are
    unit-norm, so inner product == cosine)."""
    rows = torch.nonzero(index.doc_id == doc_id)[:, 0]
    if rows.numel() == 0:
        raise ValueError(f"doc_id {doc_id} has no chunks")
    E = index.emb[rows].float()
    if index.emb_scale is not None:   # int8 store: dequantize like every
        E = E * index.emb_scale[rows][:, None]               # other consumer
    return (E @ E.T).cpu().numpy()


def matrix_stats(M: np.ndarray) -> Dict:
    off = M[~np.eye(len(M), dtype=bool)] if len(M) > 1 else np.zeros((0,))
    return {
        "n_chunks": int(len(M)),
        "mean_similarity": round(float(off.mean()), 4) if off.size else 0.0,
        "max_similarity": round(float(off.max()), 4) if off.size else 0.0,
        "min_similarity": round(float(off.min()), 4) if off.size else 0.0,
        "p90_similarity": round(float(np.percentile(off, 90)), 4) if off.size else 0.0,
        "high_pairs_gt_0.9": int((off > 0.9).sum() // 2),
    }


def analyze_document(
    index: CorpusIndex,
    meta: CorpusMeta,
    doc_id: int,
    output_dir: Optional[Path] = None,
) -> Dict:
    M = similarity_matrix(index, doc_id)
    stats = matrix_stats(M)
    stats["sha1"] = meta.docs[doc_id].sha1
    if output_dir is not None:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        base = output_dir / f"similarity_{meta.docs[doc_id].sha1}"
        np.savez_compressed(f"{base}.npz", matrix=M)
        with open(f"{base}.stats.json", "w", encoding="utf-8") as f:
            json.dump(stats, f, ensure_ascii=False, indent=2)
        try:  # interactive heatmap when plotly is available
            import plotly.graph_objects as go

            fig = go.Figure(data=go.Heatmap(z=M, colorscale="Viridis"))
            fig.write_html(f"{base}.html")
        except ImportError:  # dependency-free fallback: the visual
            # artifact should exist regardless
            _write_canvas_heatmap(M, Path(f"{base}.html"), stats["sha1"])
        stats["heatmap"] = f"{base}.html"
    return stats


def _write_canvas_heatmap(M: np.ndarray, path: Path, title: str,
                          max_cells: int = 512) -> None:
    """Standalone-HTML heatmap (canvas + embedded data, no libraries).

    Large matrices are mean-pooled down to ``max_cells`` per side; values
    are 8-bit quantized over [min, max] to keep the file small."""
    n = len(M)
    if n > max_cells:
        # pad to a multiple then mean-pool
        step = -(-n // max_cells)
        pad = step * max_cells - n
        Mp = np.pad(M, ((0, pad), (0, pad)), mode="edge")
        M = Mp.reshape(max_cells, step, max_cells, step).mean(axis=(1, 3))
    lo, hi = float(M.min()), float(M.max())
    q = np.round((M - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
    import base64

    payload = base64.b64encode(q.tobytes()).decode()
    html = f"""<!doctype html><meta charset="utf-8">
<title>similarity {title}</title>
<body style="font-family:sans-serif;background:#111;color:#eee">
<h3>chunk-to-chunk cosine similarity — {title}</h3>
<p>{n}×{n} (rendered {len(q)}×{len(q)}), range [{lo:.3f}, {hi:.3f}]</p>
<canvas id=c width={len(q)} height={len(q)}
        style="width:min(90vmin,{len(q) * 2}px);image-rendering:pixelated"></canvas>
<script>
const N={len(q)}, lo={lo}, hi={hi};
const raw=Uint8Array.from(atob("{payload}"),ch=>ch.charCodeAt(0));
const cv=document.getElementById("c"),ctx=cv.getContext("2d");
const img=ctx.createImageData(N,N);
// viridis-ish 5-stop gradient
const stops=[[68,1,84],[59,82,139],[33,145,140],[94,201,98],[253,231,37]];
for(let i=0;i<N*N;i++){{
  const t=raw[i]/255*(stops.length-1), k=Math.min(Math.floor(t),stops.length-2), f=t-k;
  for(let ch=0;ch<3;ch++) img.data[i*4+ch]=stops[k][ch]*(1-f)+stops[k+1][ch]*f;
  img.data[i*4+3]=255;
}}
ctx.putImageData(img,0,0);
cv.title="hover: cell value";
cv.onmousemove=e=>{{const r=cv.getBoundingClientRect();
  const x=Math.floor((e.clientX-r.left)/r.width*N), y=Math.floor((e.clientY-r.top)/r.height*N);
  cv.title=`(${{y}},${{x}}) ≈ ${{(lo+raw[y*N+x]/255*(hi-lo)).toFixed(3)}}`;}};
</script>"""
    path.write_text(html, encoding="utf-8")
