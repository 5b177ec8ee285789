"""Device profiling helpers and the program's own spans.

Port of ``rag_challenge_2_tpu/utils/profiling.py`` over ``torch.profiler``:
a trace of the host and the card (CUDA kernels when a card is present)
around any pipeline stage, exported as a Chrome trace (viewable in
Perfetto or ``chrome://tracing``), and named regions on its timeline.

Spans mark the program's own work from inside it.  :func:`span` opens
one around a piece of work; while no :func:`collect` is started (the
default) it checks one module flag and returns a shared no-op context
manager: no span object, no clock read, no ``record_function``.  While
a collection is started, each span that closes appends one
:class:`SpanRecord` to its buffer: the name, the request it serves, its
own id and its parent's, the thread under both keys the profiler may
give it, its start and end by ``time.time_ns`` (the clock the profiler's
events are tied to) and a few attributes (counts and names, never
tensors).  Inside :func:`device_trace` (a collection started with
``regions=True`` while the profiler runs) an open span also opens
``record_function(name)``, so it shows in the Chrome trace.  A plain
collection opens none: the profiler turns each such region into a
device-side annotation event as long as the kernels inside it, which a
reduction of the trace would count as device work.

Request ids let one request be followed across threads: a span inherits
the id of the span it opens in, takes one from its caller
(``request=``), or opens a fresh one (``request=NEW``) when none is
current.  A span that serves several requests at once lists their ids in
its ``requests`` attribute; :func:`member` reads them back below it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

# True while a collection is started: the one check a span makes when off
_ON = False
# True while a started collection wants profiler regions (device_trace)
_REGIONS = False
# the started collections (a tuple, replaced whole: a closing span
# iterates it without a lock)
_STARTED: Tuple["Collection", ...] = ()
_STARTED_LOCK = threading.Lock()
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_LOCAL = threading.local()

# ``span(..., request=NEW)``: the current request, or a fresh id when none is
NEW = object()


@dataclass(slots=True, eq=False)
class SpanRecord:
    """One closed span.  ``tid`` is the thread's native id and ``tid_low``
    the low 32 bits of its POSIX handle as a signed number: the profiler
    names a runtime call's thread by one or the other."""
    name: str
    request: Optional[int]
    id: int
    parent: Optional[int]
    tid: int
    tid_low: int
    t0_ns: int
    t1_ns: int = 0
    attrs: Dict[str, object] = field(default_factory=dict)


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def _thread():
    """The calling thread's open frames and its two keys."""
    st = getattr(_LOCAL, "stack", None)
    if st is None:
        low = threading.get_ident() & 0xFFFFFFFF
        _LOCAL.keys = (threading.get_native_id(),
                       low - (1 << 32) if low >= 1 << 31 else low)
        st = _LOCAL.stack = []
    return st, _LOCAL.keys


def _record(name, request, attrs, t0_ns, t1_ns=0) -> SpanRecord:
    """A record of the calling thread, under its innermost open frame."""
    st, (tid, low) = _thread()
    top = st[-1] if st else None
    return SpanRecord(name, _request_of(top, request), next(_SPAN_IDS),
                      top.id if top is not None else None, tid, low, t0_ns, t1_ns, attrs)


def _request_of(top, request):
    if request is NEW:
        if top is not None and top.request is not None:
            return top.request
        return next(_REQUEST_IDS)
    if request is None:
        return top.request if top is not None else None
    return request


class _Open:
    """One open span (tracing on)."""
    __slots__ = ("name", "request", "attrs", "rec", "rf")

    def __init__(self, name, request, attrs):
        self.name, self.request, self.attrs = name, request, attrs
        self.rec = self.rf = None

    def __enter__(self) -> SpanRecord:
        self.rec = rec = _record(self.name, self.request, self.attrs, time.time_ns())
        _LOCAL.stack.append(rec)
        if _REGIONS and torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return rec

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec.t1_ns = time.time_ns()
        st = _LOCAL.stack
        if st and st[-1] is rec:
            st.pop()
        for c in _STARTED:
            c.spans.append(rec)
        return False


class _Scope:
    """An open request scope (tracing on): a frame with a request id and
    its enclosing span's id, and no record of its own."""
    __slots__ = ("rid", "request", "id")

    def __init__(self, rid):
        self.rid = rid

    def __enter__(self) -> Optional[int]:
        st, _ = _thread()
        top = st[-1] if st else None
        self.request = _request_of(top, self.rid)
        self.id = top.id if top is not None else None
        st.append(self)
        return self.request

    def __exit__(self, *exc):
        st = _LOCAL.stack
        if st and st[-1] is self:
            st.pop()
        return False


def span(name: str, request=None, **attrs):
    """A span around the enclosed work, named ``name``.  ``request``: None
    inherits the enclosing span's request, an int sets it, :data:`NEW`
    inherits it or opens a fresh one.  ``attrs`` are kept on the record;
    the ``as`` target is the open :class:`SpanRecord` (add attributes to
    its ``attrs``), or None while tracing is off."""
    if not _ON:
        return _NOOP
    return _Open(name, request, attrs)


def request_scope(rid=NEW):
    """A request scope with no record of its own: spans opened inside it
    serve ``rid`` (by default the current request, or a fresh one).  The
    ``as`` target is the id, or None while tracing is off."""
    if not _ON:
        return _NOOP
    return _Scope(rid)


def request_id() -> Optional[int]:
    """The calling thread's current request, or a fresh id when it has
    none; None while tracing is off."""
    if not _ON:
        return None
    st, _ = _thread()
    return _request_of(st[-1] if st else None, NEW)


def member(i: int) -> Optional[int]:
    """The ``i``-th id of the ``requests`` attribute of the innermost open
    span that lists them, or None (tracing off, or no such span)."""
    if not _ON:
        return None
    st, _ = _thread()
    for fr in reversed(st):
        ids = fr.attrs.get("requests") if isinstance(fr, SpanRecord) else None
        if ids is not None:
            return ids[i] if i < len(ids) else None
    return None


def note(**attrs) -> None:
    """Add ``attrs`` to the innermost open span of the calling thread."""
    if not _ON:
        return
    st, _ = _thread()
    for fr in reversed(st):
        if isinstance(fr, SpanRecord):
            fr.attrs.update(attrs)
            return


def record(name: str, t0_ns: int, t1_ns: int, request=None, **attrs) -> None:
    """Record a span of the calling thread that has already ended, between
    two ``time.time_ns`` readings (its parent: the innermost open span)."""
    if not _ON:
        return
    rec = _record(name, request, attrs, t0_ns, t1_ns)
    for c in _STARTED:
        c.spans.append(rec)


def now_ns() -> int:
    """``time.time_ns()`` while tracing is on, else 0 (no clock read)."""
    return time.time_ns() if _ON else 0


class Collection:
    """The spans closed while it was started, in the order they closed.
    ``with collect() as spans:`` or ``c.start()`` ... ``c.stop()``;
    several collections may run at once, each with its own buffer.
    ``regions``: spans also open profiler regions (see the module
    docstring)."""

    def __init__(self, regions: bool = False):
        self.spans: List[SpanRecord] = []
        self.regions = regions

    @staticmethod
    def _set(started: Tuple["Collection", ...]) -> None:
        global _ON, _REGIONS, _STARTED
        _STARTED = started
        _REGIONS = any(c.regions for c in started)
        _ON = bool(started)

    def start(self) -> List[SpanRecord]:
        with _STARTED_LOCK:
            if self not in _STARTED:
                self._set(_STARTED + (self,))
        return self.spans

    def stop(self) -> List[SpanRecord]:
        with _STARTED_LOCK:
            self._set(tuple(c for c in _STARTED if c is not self))
        return self.spans

    def __enter__(self) -> List[SpanRecord]:
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False


def collect(regions: bool = False) -> Collection:
    """Tracing on for the program's spans: see :class:`Collection`."""
    return Collection(regions)


@contextlib.contextmanager
def device_trace(trace_dir: Path | str, label: Optional[str] = None) -> Iterator[None]:
    """Capture a host + device trace for the enclosed block.

    Usage::

        with device_trace("traces/search"):
            engine.search(...)

    Writes ``<trace_dir>/<label or "trace">.json`` (Chrome trace format)
    when the block ends; the program's spans are collected meanwhile, as
    regions of its timeline."""
    trace_dir = Path(trace_dir)
    trace_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof, collect(regions=True):
        if label:
            with annotate(label):
                yield
        else:
            yield
    prof.export_chrome_trace(str(trace_dir / f"{label or 'trace'}.json"))


@contextlib.contextmanager
def annotate(label: str) -> Iterator[None]:
    """Named region inside an active trace (shows up on the timeline): a
    :func:`span` called ``label``."""
    with span(label):
        yield
