"""BENCHMARK.json and the files it names; nothing that loads JAX."""

import json
import os
import shutil
import sys
import types

import bench_helpers
from benchlib import harness, manifest


def test_names_units_and_files():
    man = manifest.manifest()
    names = ([c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in man["workloads"]]:
        assert manifest.NAME_RE.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert manifest.UNIT_RE.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(bench_helpers.BENCH, "metrics", m["name"] + ".py"))
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        moved = next(e for e in man["end_to_end"] if e["name"] == m["moves"])
        for w in m["workloads"]:
            assert "workloads" not in moved or w in moved["workloads"]
    for w in man["workloads"]:
        cell = manifest.cell_file(w["name"])
        assert cell["config"] == w["config"]
        assert os.path.exists(os.path.join(bench_helpers.BENCH, "drivers",
                                           cell["driver"] + ".py"))
        assert manifest.metrics_for(man, w["name"], "per_layer")
        assert len(manifest.metrics_for(man, w["name"], "end_to_end")) >= 2
    for c in man["configs"]:
        assert os.path.exists(os.path.join(bench_helpers.ROOT, c["file"]))
    assert len(json.dumps(man)) < 64 * 1024


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    for name in ("jaxtyping_like", "haploconduct_tpu_x", "haploconduct_torch.ops"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert "jax" not in harness.forbidden_modules()
    assert "haploconduct_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "haploconduct_tpu.ops", types.ModuleType("x"))
    assert "haploconduct_tpu" in harness.forbidden_modules()


def test_a_new_config_cell_and_metric_are_files_the_harness_finds(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(bench_helpers.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(bench_helpers.ROOT, "BENCHMARK.json"), root)
    before = {p: open(p, "rb").read() for p in map(str, root.rglob("*")) if os.path.isfile(p)}
    bench = root / "benchmark"
    (bench / "configs" / "savage-patch-200x.json").write_text(
        json.dumps({"shapes": {"genome_len": 2000, "coverage": 200}}))
    (bench / "cells" / "savage-patch-200x.stage-a.json").write_text(
        json.dumps({"config": "savage-patch-200x", "driver": "savage_stage_a",
                    "stream": "savage-patch", "pool": 8, "limits": {}}))
    (bench / "metrics" / "units.count.py").write_text(
        "def read(record):\n    return record['units']\n")
    man_path = root / "BENCHMARK.json"
    # a later PR adds entries to BENCHMARK.json, which it may do
    man = json.loads(man_path.read_text())
    man["configs"].append({"name": "savage-patch-200x", "source": "x",
                           "file": "benchmark/configs/savage-patch-200x.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "savage-patch-200x.stage-a", "config": "savage-patch-200x",
                             "traffic": "stage-a", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "units.count", "unit": "units", "better": "higher",
                             "source": "host_clock", "layer": "workflow",
                             "moves": "assembly_reads_per_s",
                             "workloads": ["savage-patch-200x.stage-a"]})
    man_path.write_text(json.dumps(man))
    found = manifest.listing(str(bench))
    assert "savage-patch-200x" in found["configs"]
    assert "savage-patch-200x.stage-a" in found["cells"]
    assert "units.count" in found["metrics"]
    got = manifest.manifest(str(root))
    assert manifest.config_file(got, "savage-patch-200x", str(root))["shapes"]["coverage"] == 200
    assert manifest.cell_file("savage-patch-200x.stage-a", str(bench))["driver"] == "savage_stage_a"
    assert [m["name"] for m in manifest.metrics_for(got, "savage-patch-200x.stage-a",
                                                    "per_layer")][-1] == "units.count"
    assert manifest.load_module("metrics", "units.count", str(bench)).read({"units": 4}) == 4
    # no file that was there changed, but BENCHMARK.json's entries
    after = {p: open(p, "rb").read() for p in before}
    assert [p for p in before if after[p] != before[p]] == [str(man_path)]
