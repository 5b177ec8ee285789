from .engine import (QueryEngine, Request, SearchConfig, search_device,
                     search_many_device)
from .expansion import ExpansionResult, expand_query
from .routing import extract_years_from_question, route_core, route_mask
from .sparse import BM25Retriever
from .traversal import TraversalResult, emit_hits, traverse, traverse_windowed
