from .engine import (QueryEngine, Request, SearchConfig, search_device,
                     search_many_device)
from .routing import extract_years_from_question, route_core, route_mask
