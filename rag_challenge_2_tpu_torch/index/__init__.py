from .build import build_corpus_index, load_chunked_reports
from .schema import CorpusIndex, CorpusMeta, DocMeta, SparseIndex
from .store import load_index, save_index
