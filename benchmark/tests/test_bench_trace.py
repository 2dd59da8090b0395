"""The trace reduction: busy time is the union of device intervals, idle
time is split over the innermost host span open at each instant."""

import pytest

from benchmark.trace import _name_gaps, _union


def test_union_merges_overlaps():
    total, merged = _union([(0, 10), (5, 12), (20, 25), (24, 30), (40, 41)])
    assert total == 12 + 10 + 1
    assert merged == [[0, 12], [20, 30], [40, 41]]


def test_gaps_split_over_nested_spans():
    spans = [(0, 100, "request"), (10, 40, "read"), (40, 70, "crop"), (75, 90, "knn")]
    idle = _name_gaps([(5, 80), (95, 120)], spans)
    assert idle == pytest.approx({"request": 15e-6, "read": 30e-6, "crop": 30e-6,
                                  "knn": 5e-6, "host": 20e-6})


def test_gaps_without_spans_are_the_host():
    assert _name_gaps([(0, 50)], []) == pytest.approx({"host": 50e-6})
