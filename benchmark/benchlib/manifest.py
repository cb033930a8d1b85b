"""BENCHMARK.json and the files it names, found by name: a cell's
benchmark/cells/<cell>.json (its traffic and the driver that runs it), a
configuration's benchmark/configs/<config>.json, a driver's
benchmark/drivers/<driver>.py and a metric's benchmark/metrics/<metric>.py.
Adding a cell, a configuration or a metric is adding files and entries."""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def cell_file(name: str, bench_dir: str = BENCH_DIR) -> dict:
    return load_json(os.path.join(bench_dir, "cells", name + ".json"))


def config_file(man: dict, name: str, root: str = ROOT) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """benchmark/<kind>/<name>.py as a module (names may hold dots)."""
    path = os.path.join(bench_dir, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, cell: str, section: str) -> list:
    """The entries of `section` ("end_to_end" or "per_layer") that this
    cell reports: those without a `workloads` key and those that list it."""
    return [m for m in man[section] if "workloads" not in m or cell in m["workloads"]]


def listing(bench_dir: str = BENCH_DIR) -> dict:
    """Every configuration, cell, driver, metric and span file the harness
    would find, by kind."""
    out = {}
    for kind, ext in (("configs", ".json"), ("cells", ".json"), ("drivers", ".py"),
                      ("metrics", ".py"), ("spans", ".json")):
        d = os.path.join(bench_dir, kind)
        out[kind] = sorted(f[: -len(ext)] for f in os.listdir(d)
                           if f.endswith(ext) and not f.startswith("_"))
    return out
