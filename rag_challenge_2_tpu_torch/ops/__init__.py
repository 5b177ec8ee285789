from .aggregate import FusedCandidates, fuse_hits
from .bm25 import (
    HostBM25Scorer, bm25_scores, bm25_topk, encode_queries, encode_queries_host)
from .topk import NEG_INF, dense_topk
