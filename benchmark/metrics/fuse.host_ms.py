"""fuse.host_ms: the median host time of one bracketed
``engine.fuse_blocks`` call (one a request)."""

import statistics

UNIT = "ms"


def read(run):
    s = [sp.host_s * 1e3 for sp in run.spans.named("fuse")]
    return statistics.median(s) if s else None
