"""Device trace of part of the measured window (`--trace 1`), reduced to the
numbers the per-layer metrics and the result line read.

One region of the window runs under torch.profiler (device activity, and
for serving the host's too). Its device work is the union of the intervals
of kernels, copies and memsets; the device ranges of user annotations
(record_function) span other work and are left out. Idle time inside the
region is named by the innermost host annotation open at each instant
(the benchmark's own spans around the program's layers), or "host" where
none is or host spans are not traced.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

REGION = "bench.traced"


def _union(intervals):
    total, end = 0.0, None
    merged = []
    for s, e in sorted(intervals):
        if end is None or s > end:
            merged.append([s, e])
            end = e
        elif e > end:
            merged[-1][1] = e
            end = e
    for s, e in merged:
        total += e - s
    return total, merged


def _name_gaps(gaps, annotations) -> dict:
    """Idle seconds by the innermost annotation open at each instant of the
    gaps (the one opened last), "host" where none is: the annotations'
    boundaries cut the timeline into pieces, and each gap is split over
    them."""
    points = sorted({t for a0, a1, _ in annotations for t in (a0, a1)})
    events = sorted([(a0, 1, i) for i, (a0, _, _) in enumerate(annotations)]
                    + [(a1, 0, i) for i, (_, a1, _) in enumerate(annotations)])
    pieces, active, k = [], {}, 0
    for lo, hi in zip(points, points[1:]):
        while k < len(events) and events[k][0] <= lo:
            t, opening, i = events[k]
            if opening:
                active[i] = annotations[i][0]
            else:
                active.pop(i, None)
            k += 1
        if active:
            inner = max(active, key=lambda i: (active[i], -annotations[i][1]))
            pieces.append((lo, hi, annotations[inner][2]))
    idle_by = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        m = j
        while m < len(pieces) and pieces[m][0] < g1:
            lo, hi = max(pieces[m][0], g0), min(pieces[m][1], g1)
            if hi > lo:
                idle_by[pieces[m][2]] += (hi - lo) * 1e-6
                covered += hi - lo
            m += 1
        if g1 - g0 > covered:
            idle_by["host"] += (g1 - g0 - covered) * 1e-6
    return dict(idle_by)


def reduce_events(events, wall_s: float) -> dict:
    """Busy and idle time of the traced region from the profiler's events
    (times in microseconds). Where the trace holds the region's host range,
    it bounds the region; a trace of device activity alone is bounded by
    its first and last device event, and its idle time is the region's
    host wall time `wall_s` less the busy time."""
    from torch.autograd import DeviceType

    region = [e for e in events if e.name == REGION
              and e.device_type == DeviceType.CPU]
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if region:
        w0, w1 = region[0].time_range.start, region[0].time_range.end
    elif device:
        w0 = min(e.time_range.start for e in device)
        w1 = max(e.time_range.end for e in device)
    else:
        w0 = w1 = 0.0
    kernel_s, kernel_n = defaultdict(float), defaultdict(int)
    intervals = []
    annotations, annotation_n = [], defaultdict(int)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        user = bool(getattr(e, "is_user_annotation", False))
        if e.device_type == DeviceType.CUDA and not user:
            s, t = max(s, w0), min(t, w1)
            if t <= s:
                continue
            intervals.append((s, t))
            kernel_s[e.name] += (t - s) * 1e-6
            kernel_n[e.name] += 1
        elif e.device_type == DeviceType.CPU and user and e.name != REGION:
            annotations.append((s, t, e.name))
            annotation_n[e.name] += 1
    busy_us, merged = _union(intervals)
    gaps, prev = [], w0
    for s, e in merged:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    window_us = (w1 - w0) if region else wall_s * 1e6
    if not region:                       # the host time around the device span
        gaps.append((w1, w1 + max(window_us - (w1 - w0), 0.0)))
    idle_by = _name_gaps(gaps, annotations)
    return {"busy_s": busy_us * 1e-6, "window_s": window_us * 1e-6,
            "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
            "idle_by": idle_by, "annotation_n": dict(annotation_n)}


class Tracer:
    """Profiles the one region a run marks with `region()` when enabled;
    `result` then holds reduce_events' numbers and `reduce_s` what reading
    the trace took."""

    def __init__(self, enabled: bool, device=None):
        self.enabled = enabled
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self.result: dict | None = None
        self.reduce_s = 0.0

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def region(self, host_spans: bool = True):
        """Profile the block. `host_spans` records the host's operations and
        spans too, which names idle gaps but slows a host-bound loop of
        thousands of launches; without it only device activity is traced."""
        if not self.enabled or self.result is not None:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] if host_spans or not self.cuda else []
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            with torch.profiler.record_function(REGION):
                t0 = time.perf_counter()
                yield
                if self.cuda:
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        t = time.perf_counter()
        self.result = reduce_events(prof.events(), wall)
        self.reduce_s = time.perf_counter() - t

    def breakdown(self) -> dict | None:
        """The ten device operations that took most time and the ten
        longest idle stretches by what the host was doing, in seconds."""
        if self.result is None:
            return None
        ops = sorted(self.result["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(self.result["idle_by"].items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k[:120], v] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in idle]}
