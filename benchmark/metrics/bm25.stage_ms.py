"""bm25.stage_ms: the median time between two CUDA events recorded on the
stream before and after each bracketed ``engine.bm25_hits`` call (one a
dispatch)."""

import statistics

UNIT = "ms"


def read(run):
    s = [sp.events[0].elapsed_time(sp.events[1]) for sp in run.spans.named("bm25")
         if sp.events is not None]
    return statistics.median(s) if s else None
