"""CUDA-event timing of one call on the card, for the smoke run and the
sweep scripts.

A kernel of a few microseconds is easy to mistime: events recorded around
``fn()`` measure the host wherever the device reaches the start event
before the host has queued ``fn``'s launch (a wrapper that validates,
allocates and crosses ctypes takes tens of microseconds on a busy host).
:func:`cuda_ms` therefore parks the device behind a fixed spin before the
start event, long enough for the host to queue everything, and
:func:`cuda_ms_train` times a train of back-to-back launches (L2 warm).
"""

from __future__ import annotations

import statistics

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
