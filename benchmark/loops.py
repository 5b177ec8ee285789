"""The measured window: the closed loops that offer a mix's load.

A request's latency runs from the client's call until its results are
on the host.  The window runs from the first request's start until the
last request that started within ``seconds`` has completed; every
request completed in it counts.  Nothing is built or compiled here: the
harness has warmed every shape up before.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Done:
    """One completed request."""
    item: int              # pool batch (scan) or pool question (served)
    t0: float
    t1: float
    a: np.ndarray          # rows (scan, encode) or keys (served)
    b: np.ndarray          # values (scan, encode) or scores (served)
    c: Optional[np.ndarray] = None     # embeddings (encode)


@dataclass
class Window:
    start: float = 0.0
    stop: float = 0.0
    done: List[Done] = field(default_factory=list)
    failed: List[str] = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.stop - self.start


def scan(call: Callable, n_batches: int, seconds: float,
         on_tick: Optional[Callable[[float], None]] = None) -> Window:
    """One client: ``call(b)`` for batches 0, 1, .., cycling, until
    ``seconds`` have passed; ``call`` returns host ``(rows, values)``
    (encode: and the embeddings).
    ``on_tick(elapsed)`` runs between requests (the trace's stop)."""
    w = Window()
    w.start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - w.start >= seconds:
            break
        b = i % n_batches
        try:
            out = call(b)
            w.done.append(Done(b, t0, time.perf_counter(), *out))
        except Exception as e:      # a failed request is counted, not fatal
            w.failed.append(f"{type(e).__name__}: {e}")
        i += 1
        if on_tick is not None:
            on_tick(time.perf_counter() - w.start)
    w.stop = max([d.t1 for d in w.done], default=time.perf_counter())
    return w


def served(call: Callable, orders: List[np.ndarray], seconds: float,
           main: Optional[Callable[[float], None]] = None) -> Window:
    """``len(orders)`` client threads, each ``call(q)`` for the pool
    questions of its order, cycling, until ``seconds`` have passed;
    ``call`` returns host ``(keys, scores)``.  ``main(start)`` runs in the
    calling thread while the clients run (the trace's start and stop)."""
    w = Window()
    lock = threading.Lock()
    go = threading.Barrier(len(orders) + 1)

    def client(order):
        go.wait()
        j = 0
        while True:
            t0 = time.perf_counter()
            if t0 - w.start >= seconds:
                return
            q = int(order[j % len(order)])
            j += 1
            try:
                keys, scores = call(q)
                d = Done(q, t0, time.perf_counter(), keys, scores)
                with lock:
                    w.done.append(d)
            except Exception as e:  # a failed request is counted, not fatal
                with lock:
                    w.failed.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(o,), daemon=True) for o in orders]
    for t in threads:
        t.start()
    w.start = time.perf_counter()
    go.wait()
    if main is not None:
        main(w.start)
    for t in threads:
        t.join()
    w.stop = max([d.t1 for d in w.done], default=time.perf_counter())
    return w
