"""Nested, thread-aware span tracing for the engine and serving tier.

A :class:`Span` times one stage of work on the thread that runs it.  Spans
nest through a thread-local stack — a span opened while another span is
active on the *same* thread records that span as its parent, so one
``engine.fit`` call yields a tree, and worker-thread spans (the serving
batcher) start their own roots tagged with their thread id.

Spans **always time** (callers read ``Span.duration`` for their own
timers, so the clock must run whether or not anyone is watching);
the *enabled* flag only controls whether finished records are appended to
the bounded in-process buffer that the exporters read.  That makes the
enabled-vs-disabled delta of the hot paths a few dict writes and one
lock-guarded list append per span.

Device stages lie to wall clocks: a CUDA launch returns after *dispatch*,
not completion.  ``device_sync=True`` (on :func:`traced`) or
:meth:`Span.track` (on a context-manager span) inserts a
``torch.cuda.synchronize`` fence for the devices of the tracked tensors
before the span closes, so the recorded duration covers the device work —
measured honestly instead of timing dispatch.

Spans reach ``torch.profiler`` too: while a profiler is recording (and
``torch`` is already imported), each span also opens a
``torch.profiler.record_function`` of its name, closed when the span
closes (on an exception too), so the span shows in the profiler's Chrome
trace as a ``user_annotation`` event on the clock of the device activity
it launched.  With no profiler running that costs one module lookup and
one attribute read a span.  Span names are static (a block index goes in
an attribute), since a trace groups time by name.

No dependencies beyond the standard library; ``torch`` is imported lazily
and only when a CUDA tensor actually needs a fence, and the profiler is
only ever looked up, never imported.  Port of ``repro.obs.trace``.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_DEFAULT_CAPACITY = 200_000

_lock = threading.Lock()
_enabled = True
_capacity = _DEFAULT_CAPACITY
_records: List["SpanRecord"] = []
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()

# perf_counter epoch → unix time, so exported timestamps are wall-clock
# anchored while durations keep perf_counter's monotonic resolution
_EPOCH_UNIX = time.time() - time.perf_counter()


@dataclasses.dataclass
class SpanRecord:
    """One finished span, as the exporters see it."""
    name: str
    span_id: int
    parent_id: int            # 0 → root (no enclosing span on this thread)
    thread_id: int
    thread_name: str
    t_start: float            # perf_counter timebase (see _EPOCH_UNIX)
    duration: float           # seconds
    attrs: Dict[str, Any]


def _profiler_range(name: str):
    """An entered ``record_function(name)`` while ``torch.profiler`` is
    recording, else None.  The profiler module is looked up, not
    imported: a process that never imported torch has no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    if prof is None or not prof._is_profiler_enabled:
        return None
    rf = prof.record_function(name)
    rf.__enter__()
    return rf


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """Context-manager span; see the module docstring.

    Attributes land in the record via constructor kwargs,
    :meth:`set_attr`, or :meth:`track` (which also registers a value for
    the ``device_sync`` fence).  ``duration`` is valid after ``__exit__``
    whether or not tracing is enabled.
    """

    __slots__ = ("name", "attrs", "device_sync", "span_id", "parent_id",
                 "t_start", "duration", "_tracked", "_range")

    def __init__(self, name: str, *, device_sync: bool = False, **attrs):
        self.name = name
        self.attrs = attrs
        self.device_sync = device_sync
        self.span_id = 0
        self.parent_id = 0
        self.t_start = 0.0
        self.duration = 0.0
        self._tracked: list = []
        self._range = None      # the profiler's record_function, if open

    # -- attribute / fence plumbing ---------------------------------------
    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def track(self, value):
        """Register ``value`` for the exit fence (returns it unchanged),
        and fence it immediately when ``device_sync`` is set so the time
        is attributed to *this* span even if more host work follows."""
        if self.device_sync:
            _fence(value)
        else:
            self._tracked.append(value)
        return value

    # -- context manager ---------------------------------------------------
    def __enter__(self) -> "Span":
        st = _stack()
        self.parent_id = st[-1].span_id if st else 0
        self.span_id = next(_ids)
        st.append(self)
        self._range = _profiler_range(self.name)
        self.t_start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.device_sync and self._tracked:
            _fence(self._tracked)
        self.duration = time.perf_counter() - self.t_start
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        elif self in st:            # mis-nested exit: drop up to self
            del st[st.index(self):]
        if _enabled:
            th = threading.current_thread()
            rec = SpanRecord(name=self.name, span_id=self.span_id,
                             parent_id=self.parent_id,
                             thread_id=th.ident or 0, thread_name=th.name,
                             t_start=self.t_start, duration=self.duration,
                             attrs=dict(self.attrs))
            global _dropped
            with _lock:
                if len(_records) < _capacity:
                    _records.append(rec)
                else:
                    _dropped += 1
        return None


def span(name: str, *, device_sync: bool = False, **attrs) -> Span:
    """Open a span: ``with obs.span("query.rerank", kind="fused") as sp:``."""
    return Span(name, device_sync=device_sync, **attrs)


def traced(name: Optional[str] = None, *, device_sync: bool = False,
           **attrs):
    """Decorator form: time every call of ``fn`` as a span named after it.

    ``device_sync=True`` fences the return value (a CUDA synchronize for
    every device its tensors live on) before the span closes — the honest
    way to time a function that dispatches device work.
    """
    def deco(fn):
        import functools
        label = name or f"{fn.__module__}.{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with Span(label, device_sync=device_sync, **attrs):
                out = fn(*args, **kwargs)
                if device_sync:
                    _fence(out)
                return out
        return wrapper
    return deco


def _fence(value) -> None:
    """Block until the CUDA work producing ``value`` (a tensor, or a
    tuple/list/dict nesting of them) has finished: one
    ``torch.cuda.synchronize`` per device found.  CPU tensors and plain
    values need no fence."""
    devices = set()
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif getattr(v, "is_cuda", False):
            devices.add(v.device)
    if devices:
        import torch
        for dev in devices:
            torch.cuda.synchronize(dev)


def current_span() -> Optional[Span]:
    """The innermost open span on this thread (None outside any span)."""
    st = _stack()
    return st[-1] if st else None


# -- buffer management -----------------------------------------------------
def enable() -> None:
    """Record finished spans into the trace buffer (the default)."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Stop recording (spans still time; see module docstring)."""
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def set_capacity(n: int) -> None:
    """Bound the trace buffer at ``n`` finished spans (drop-newest)."""
    global _capacity
    with _lock:
        _capacity = max(int(n), 0)
        del _records[_capacity:]


def get_spans() -> List[SpanRecord]:
    """Snapshot of the finished-span buffer (oldest first)."""
    with _lock:
        return list(_records)


def dropped_spans() -> int:
    """Finished spans discarded because the buffer was at capacity."""
    with _lock:
        return _dropped


def clear() -> None:
    """Empty the trace buffer (open spans are unaffected)."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0
