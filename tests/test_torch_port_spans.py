"""gnn_tumor_seg_tpu_torch/spans.py on the CPU: off, a span records nothing
and opens no record_function; under torch.profiler, each span is one event
of the trace and one entry of the timeline, on the trace's clock; units
keep their totals in recent()."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_tumor_seg_tpu_torch import spans


def _no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_off_records_nothing_and_opens_no_record_function(monkeypatch):
    _no_record_function(monkeypatch)
    spans.timeline()
    assert spans.span("x") is spans.span("y")          # the shared no-op
    totals = {}
    with spans.unit("test.off_unit", totals, "all"):
        with spans.span("test.off", totals, "off"):
            time.sleep(0.002)
        with spans.span("test.off_untimed"):
            pass
    spans.count("n", 3, totals)
    spans.count("n", 2, totals)
    spans.count("n", 1, None)
    assert totals["off"] >= 0.002 and totals["all"] >= totals["off"]
    assert totals["n"] == 5 and totals["profiled"] is False
    assert set(totals) == {"off", "all", "n", "profiled"}
    assert spans.timeline() == []
    assert spans.recent("test.off_unit")[-1] is totals


def test_spans_add_up_and_units_keep_the_last_finished():
    for i in range(spans.RECENT_MAX + 3):
        with spans.unit("test.kept", {"i": i}):
            pass
    kept = spans.recent("test.kept")
    assert [u["i"] for u in kept] == list(range(3, spans.RECENT_MAX + 3))
    with pytest.raises(RuntimeError):
        with spans.unit("test.kept", {"i": "failed"}):
            raise RuntimeError
    assert spans.recent("test.kept")[-1]["i"] == spans.RECENT_MAX + 2
    totals = {}
    for _ in range(3):
        with spans.span("test.twice", totals, "k"):
            time.sleep(0.001)
    assert totals["k"] >= 0.003


def test_profiled_spans_match_the_trace():
    # the process's first record_function resolves its operator (about a
    # millisecond); a span's clock reads fall after and before the
    # profiler's, so that first call would offset one entry
    with torch.profiler.record_function("warm"):
        pass
    spans.timeline()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        totals = {}
        with spans.unit("test.request", totals, "request"):
            with spans.span("test.read", totals, "read"):
                time.sleep(0.003)
            with spans.span("test.prep", totals, "prep"):
                with spans.span("test.crop"):
                    time.sleep(0.002)
                torch.ones(64).sum()
    entries = spans.timeline()
    assert totals["profiled"] is True
    assert [e[0] for e in entries] == ["test.read", "test.crop", "test.prep",
                                      "test.request"]
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    events = {}
    for ev in prof.events():
        if ev.name.startswith("test."):
            assert ev.name not in events, f"{ev.name} twice in the trace"
            events[ev.name] = ev
    assert set(events) == {e[0] for e in entries}
    units = {e[4] for e in entries}
    assert len(units) == 1 and units.pop().startswith("test.request:")
    for name, start, end, parent, _ in entries:
        ev = events[name]
        assert (ev.cpu_parent.name if ev.cpu_parent else None) == parent
        assert abs(start - (start_ns + 1000 * ev.time_range.start)) < 1e6
        assert abs(end - (start_ns + 1000 * ev.time_range.end)) < 1e6
    assert {e[0]: e[3] for e in entries} == {
        "test.read": "test.request", "test.crop": "test.prep",
        "test.prep": "test.request", "test.request": None}
    # the timeline was taken: it starts empty again
    assert spans.timeline() == []
