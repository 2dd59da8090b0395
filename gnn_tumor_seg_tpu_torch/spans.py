"""Spans and counters of the program's host work, on the profiler's clock.

A span times one block of host work, and what comes of it depends on who
asks:

  - with a dict `into`, the block's seconds are added to `into[key or
    name]` (two `perf_counter_ns` reads, so callers keep these totals on
    always: a training epoch's `host_s`, a request's `stage_times`);
  - while a torch.profiler session runs, the span is also appended to a
    bounded in-memory timeline as `(name, start_ns, end_ns, parent, unit)`
    and opens `torch.profiler.record_function(name)`, so that a trace that
    records host activity shows it;
  - with neither, `span` returns a shared no-op after one flag read.

The trace's clock: torch.profiler stamps host events with an approximate
(TSC) clock that it converts to Unix-epoch nanoseconds against the system
clock; `kineto_results.trace_start_ns()` is on that scale and an event's
`time_range` counts microseconds after it. The timeline therefore reads
`time.time_ns()`, the same system clock: an entry's start and end are
`trace_start_ns() + 1000 * time_range.start` (and `.end`) of its
record_function copy, within the converter's error. `time.perf_counter_ns`
counts from boot and is not on that scale; only the totals read it.

A unit is one request or one training epoch: `unit(name, into, key)` is a
span whose inner spans carry its id in the timeline and whose `into`, when
the unit finishes, gains `profiled` (whether a profiler ran during it) and
joins `recent(name)`, the last 64 finished units of that name. A reader in
the same process (a benchmark's metric) finds them there.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "unit", "count", "timeline", "recent"]

TIMELINE_MAX = 1 << 17
RECENT_MAX = 64

_now = time.perf_counter_ns
_timeline: collections.deque = collections.deque(maxlen=TIMELINE_MAX)
_recent: dict[str, collections.deque] = {}
_unit_ids = itertools.count()


class _Open(threading.local):
    """This thread's open traced span names (the parent of the next one)
    and open units."""

    def __init__(self):
        self.names: list[str] = []
        self.units: list[_Unit] = []


_open = _Open()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "into", "key", "t0", "traced")

    def __init__(self, name: str, into: dict | None, key: str | None):
        self.name, self.into, self.key = name, into, key or name
        self.traced = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._trace()
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        dt = _now() - self.t0
        into = self.into
        if into is not None:
            into[self.key] = into.get(self.key, 0.0) + dt * 1e-9
        if self.traced is not None:
            self._untrace()
        return False

    def _trace(self) -> None:
        # the record_function's own stamp falls inside its enter and exit
        # calls: the timeline takes the middle of each
        rf = torch.profiler.record_function(self.name)
        t = time.time_ns()
        rf.__enter__()
        start = (t + time.time_ns()) // 2
        parent = _open.names[-1] if _open.names else None
        unit_id = None
        if _open.units:
            _open.units[-1].profiled = True
            unit_id = _open.units[-1].id
        _open.names.append(self.name)
        self.traced = (rf, parent, unit_id, start)

    def _untrace(self) -> None:
        rf, parent, unit_id, start = self.traced
        _open.names.pop()
        t = time.time_ns()
        rf.__exit__(None, None, None)
        _timeline.append((self.name, start, (t + time.time_ns()) // 2, parent,
                          unit_id))


class _Unit(_Span):
    __slots__ = ("id", "profiled")

    def __init__(self, name: str, into: dict | None, key: str | None):
        super().__init__(name, into, key)
        self.id = f"{name}:{next(_unit_ids)}"
        self.profiled = False

    def __enter__(self):
        _open.units.append(self)
        self.profiled = _profiler._is_profiler_enabled
        return super().__enter__()

    def __exit__(self, exc_type, *exc):
        super().__exit__(exc_type, *exc)
        _open.units.pop()
        if self.into is not None and exc_type is None:
            self.into["profiled"] = self.profiled or _profiler._is_profiler_enabled
            _recent.setdefault(self.name, collections.deque(maxlen=RECENT_MAX)
                               ).append(self.into)
        return False


def span(name: str, into: dict | None = None, key: str | None = None):
    """A context manager timing its block as `name` (module docstring)."""
    if into is None and not _profiler._is_profiler_enabled:
        return _NOOP
    return _Span(name, into, key)


def unit(name: str, into: dict | None = None, key: str | None = None):
    """A span that is one unit of work (a request, an epoch): the spans
    inside it carry its id, and a finished unit's `into` joins
    recent(name)."""
    return _Unit(name, into, key)


def count(name: str, n: int, into: dict | None) -> None:
    """Add `n` to `into[name]` (nothing without a dict)."""
    if into is not None:
        into[name] = into.get(name, 0) + n


def timeline() -> list[tuple]:
    """The traced spans since the last call, oldest first, as (name,
    start_ns, end_ns, parent, unit) on the trace's clock; the log is left
    empty. It keeps the last TIMELINE_MAX spans."""
    out = []
    while _timeline:
        out.append(_timeline.popleft())
    return out


def recent(name: str) -> list[dict]:
    """The totals of the last RECENT_MAX finished units called `name`,
    oldest first (each marked `profiled`)."""
    return list(_recent.get(name, ()))
