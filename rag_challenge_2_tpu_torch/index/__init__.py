from .build import build_corpus_index, load_chunked_reports
from .ivf import (IVFIndex, build_ivf, build_ivf_streaming,
                  cluster_order_index, ivf_search, quantize_ivf)
from .schema import CorpusIndex, CorpusMeta, DocMeta, SparseIndex
from .store import index_fingerprint, load_index, load_ivf, save_index, save_ivf
