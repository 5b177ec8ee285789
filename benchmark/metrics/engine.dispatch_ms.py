"""engine.dispatch_ms: the median host time of one bracketed
``QueryEngine.search_many`` call, up to its return."""

import statistics

UNIT = "ms"


def read(run):
    s = [sp.host_s * 1e3 for sp in run.spans.named("dispatch")]
    return statistics.median(s) if s else None
