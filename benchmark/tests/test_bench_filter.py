"""The reader of savage.filter_pct: rank 0's abundance filters after stages
b and c as a share of the window, and nothing where the program records
neither filter."""

import pytest

import bench_helpers  # noqa: F401  (paths)
from benchlib import manifest


def _record(**timings):
    return {"window_s": 10.0, "extra": {"timings": timings}, "phases": {"verify": 2.0}}


def test_filter_pct_reads_both_filters_and_none_without_them():
    read = manifest.load_module("metrics", "savage.filter_pct").read
    rec = _record(stage_a_s=5.0, stage_b_s=1.0, stage_b_filter_s=0.25,
                  stage_c_s=0.5, stage_c_filter_s=0.5, filter_reads=600,
                  filter_reads_classified=150, filter_gather_wait_s=0.01)
    assert read(rec) == pytest.approx(7.5)
    # no stage c in a sample: stage b's filter alone
    assert read(_record(stage_b_filter_s=0.25)) == pytest.approx(2.5)
    # stage a alone, filtering off, or no timings at all
    assert read(_record(stage_a_s=5.0, stage_b_s=1.0, stage_c_s=0.5)) is None
    assert read({"window_s": 1.0, "extra": {}}) is None
    entry = next(m for m in manifest.manifest()["per_layer"]
                 if m["name"] == "savage.filter_pct")
    assert entry["workloads"] == ["savage-sample-4rank.abc"]
    assert entry["moves"] == "assembly_reads_per_s" and entry["layer"] == "workflow"
