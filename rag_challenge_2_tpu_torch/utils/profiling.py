"""Device profiling helpers.

Port of ``rag_challenge_2_tpu/utils/profiling.py`` over ``torch.profiler``:
a trace of the host and the card (CUDA kernels when a card is present)
around any pipeline stage, exported as a Chrome trace (viewable in
Perfetto or ``chrome://tracing``), and named regions on its timeline.
"""

from __future__ import annotations

import contextlib
from pathlib import Path
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def device_trace(trace_dir: Path | str, label: Optional[str] = None) -> Iterator[None]:
    """Capture a host + device trace for the enclosed block.

    Usage::

        with device_trace("traces/search"):
            engine.search(...)

    Writes ``<trace_dir>/<label or "trace">.json`` (Chrome trace format)
    when the block ends."""
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        if label:
            with annotate(label):
                yield
        else:
            yield
    prof.export_chrome_trace(str(trace_dir / f"{label or 'trace'}.json"))


@contextlib.contextmanager
def annotate(label: str) -> Iterator[None]:
    """Named region inside an active trace (shows up on the timeline)."""
    with torch.profiler.record_function(label):
        yield
