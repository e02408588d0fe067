"""Profiling utilities: the engine's spans, ``trace`` and ``device_activity``.

- ``span(name, device=None, **attrs)``: a span of the engine. It records
  only while a ``torch.profiler`` session runs (the one flag
  ``torch.autograd.profiler._is_profiler_enabled``); otherwise it is the
  shared no-op ``NO_SPAN``, which allocates nothing and reads no clock.
  While recording, each span keeps its request's id, its own id, its
  parent's id, its name, its host start and end on ``time.perf_counter()``
  and its attributes, and is a ``torch.profiler.record_function`` of its
  name, so it lands in the profiler's trace beside the kernels. A span with
  a CUDA ``device`` also records two CUDA events on that device's current
  stream; they are read as device milliseconds when the request's root
  span closes, after the request's own last sync, so the span adds no sync.
  On a CPU device the device time is the host time.
- ``sync(at)``: the span ``sync`` around a place where the host waits on
  the device (``at`` names it).
- ``stage(times, field)``: a span named ``field`` that always, tracing on
  or off, adds its host seconds to ``times.<field>`` (``StageTimes``).
- ``requests()``: the completed requests, oldest first, each the list of
  its spans in opening order, its root first; the last ``MAX_REQUESTS``
  are kept. Nothing is written to disk: the profiler's trace exports them.
- ``trace``: a ``torch.profiler`` trace context (CPU and CUDA activities)
  that writes a Chrome trace under ``log_dir``; ``device_activity`` reads
  the device's busy time and its kernels out of such a trace.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# completed requests kept: a benchmark's traced stretch holds 1-2
MAX_REQUESTS = 4096

_requests: collections.deque = collections.deque(maxlen=MAX_REQUESTS)
_ids = itertools.count(1)
_local = threading.local()          # .stack: this thread's open spans


class _NoSpan:
    """What ``span`` returns while nothing records."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None

    def __bool__(self) -> bool:
        return False


NO_SPAN = _NoSpan()


def _stack() -> List["Span"]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One recorded span. ``t0``/``t1``: host seconds on
    ``time.perf_counter()``; ``device_ms``: device milliseconds for a span
    given a device (None otherwise, and until its request completes)."""
    __slots__ = ("request", "id", "parent", "name", "t0", "t1", "attrs",
                 "device_ms", "_device", "_events", "_rf", "_spans")

    def __init__(self, name: str, device, attrs: Dict[str, Any]):
        self.name = name
        self.attrs = attrs
        self._device = None if device is None else torch.device(device)
        self.device_ms: Optional[float] = None
        self._events = None
        self.t1 = None

    def set(self, **attrs) -> None:
        """Set attributes while the span is open."""
        self.attrs.update(attrs)

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        stack = _stack()
        self.id = next(_ids)
        if stack:
            root = stack[0]
            self.request, self.parent = root.id, stack[-1].id
            root._spans.append(self)
        else:
            self.request, self.parent = self.id, None
            self._spans = [self]
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self._device is not None and self._device.type == "cuda":
            stream = torch.cuda.current_stream(self._device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._events is not None:
            self._events[1].record(torch.cuda.current_stream(self._device))
        elif self._device is not None:
            self.device_ms = 1e3 * (self.t1 - self.t0)
        self._rf.__exit__(None, None, None)
        self._rf = None
        stack = _stack()
        stack.pop()
        if self.parent is None:
            spans, self._spans = self._spans, None
            for s in spans:
                s._resolve(block=False)
            _requests.append(spans)

    def _resolve(self, block: bool) -> None:
        """Device milliseconds from the two events once the second has
        completed; ``block`` waits for it."""
        if self._events is None:
            return
        start, end = self._events
        if not block and not end.query():
            return
        end.synchronize()
        self.device_ms = start.elapsed_time(end)
        self._events = None


def span(name: str, device=None, **attrs):
    """A span of the engine (module docstring); ``NO_SPAN`` unless a
    ``torch.profiler`` session runs. ``device``: the device the span's work
    runs on, for its device time."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return Span(name, device, attrs)


def sync(at: str):
    """The span ``sync`` (attribute ``at``) around a host wait on the
    device."""
    if not _autograd_profiler._is_profiler_enabled:
        return NO_SPAN
    return Span("sync", None, {"at": at})


def annotate(**attrs) -> None:
    """Set attributes on the open request (the root span of this
    thread), if one records."""
    if _autograd_profiler._is_profiler_enabled:
        stack = _stack()
        if stack:
            stack[0].attrs.update(attrs)


class stage:
    """``with stage(times, "gpt_gen"):`` adds the block's host seconds to
    ``times.gpt_gen`` whether or not spans record; while they do, the block
    is also the span ``gpt_gen``, on the same two clock readings."""
    __slots__ = ("times", "field", "span", "t0")

    def __init__(self, times, field: str):
        self.times, self.field = times, field

    def __enter__(self):
        sp = self.span = span(self.field)
        sp.__enter__()
        self.t0 = sp.t0 if sp else time.perf_counter()
        return sp

    def __exit__(self, *exc) -> None:
        sp = self.span
        if sp:
            sp.__exit__(*exc)
            t1 = sp.t1
        else:
            t1 = time.perf_counter()
        setattr(self.times, self.field,
                getattr(self.times, self.field) + (t1 - self.t0))


def requests() -> List[List[Span]]:
    """The completed requests, oldest first (module docstring); device
    times still pending are waited for."""
    out = list(_requests)
    for spans in out:
        for s in spans:
            s._resolve(block=True)
    return out


def clear() -> None:
    """Forget every completed request."""
    _requests.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None
          ) -> Iterator[Optional[torch.profiler.profile]]:
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where a card is present), written as a Chrome trace
    ``log_dir/trace.json`` when the block ends; yields the profiler (its
    ``events()`` and ``key_averages()`` stay readable after the block). A
    no-op yielding None for ``log_dir`` None."""
    if log_dir is None:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


# Chrome-trace categories of work on the device
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_activity(trace_file) -> Tuple[float, Dict[str, float]]:
    """From a Chrome trace that ``trace`` wrote: (the union of the device's
    busy intervals, µs; device µs summed by kernel or copy name)."""
    events = json.loads(Path(trace_file).read_text())["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            start, dur = float(e["ts"]), float(e.get("dur", 0.0))
            spans.append((start, start + dur))
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + dur
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return busy, by_name
