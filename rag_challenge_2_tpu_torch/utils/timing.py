"""Timing: the stage-timing contract of the JAX package's
``utils/timing.py`` (:class:`StageTimer`, :func:`timed`: wall seconds per
stage, device work waited for before the clock stops), and CUDA-event
timing of one call on the card, for the smoke run and the sweep scripts.

A kernel of a few microseconds is easy to mistime: events recorded around
``fn()`` measure the host wherever the device reaches the start event
before the host has queued ``fn``'s launch (a wrapper that validates,
allocates and crosses ctypes takes tens of microseconds on a busy host).
:func:`cuda_ms` therefore parks the device behind a fixed spin before the
start event, long enough for the host to queue everything, and
:func:`cuda_ms_train` times a train of back-to-back launches (L2 warm).
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, Optional

# device cycles the card spins before the start event (~0.3 ms at the
# H100's clocks): the host queues fn() meanwhile
SPIN_CYCLES = 600_000


def cuda_ms(fn, flush=None, reps=25, warmup=3, spin=True):
    """Median milliseconds of one ``fn()`` by CUDA events.  ``flush`` (a
    device buffer larger than L2) is zeroed before each timed call so the
    call finds L2 cold; ``spin=False`` is the unprotected single shot."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def cuda_ms_train(fn, n=20, reps=7, warmup=3):
    """Median milliseconds per call over trains of ``n`` back-to-back
    ``fn()`` calls behind one spin: what a launch costs when the device
    never waits for the host (L2 is warm from the call before)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(SPIN_CYCLES * max(1, n // 4))
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / n)
    return statistics.median(times)


def _wait_for(block_on) -> None:
    """Wait until the work behind ``block_on`` (a tensor, or a list, tuple
    or dict of them) is done: a tensor on the card synchronises its
    device's current stream; a host tensor or any other value is ready."""
    import torch

    if isinstance(block_on, dict):
        block_on = list(block_on.values())
    if not isinstance(block_on, (list, tuple)):
        block_on = [block_on]
    for t in block_on:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.current_stream(t.device).synchronize()


class StageTimer:
    """Accumulates per-stage wall seconds; device-aware."""

    def __init__(self) -> None:
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _wait_for(block_on)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def record(self, name: str, seconds: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + seconds

    def as_dict(self) -> Dict[str, float]:
        return dict(self.stages)


@contextlib.contextmanager
def timed(out: Optional[Dict[str, float]], name: str, block_on=None):
    """Lightweight one-off variant writing into a caller-supplied dict."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if block_on is not None:
            _wait_for(block_on)
        if out is not None:
            out[name] = out.get(name, 0.0) + time.perf_counter() - t0
