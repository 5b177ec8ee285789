"""queries_per_s: the query vectors of every request completed in the
window over the window's seconds (host clock)."""


def read(run):
    w = run.window
    if not w.done or w.seconds <= 0:
        return None
    return len(w.done) * run.queries_per_request / w.seconds
