"""BENCHMARK.json and the files the harness finds by name agree, keep
to the benchmark's contract, and import neither JAX nor the JAX package."""

import ast
import json
import os
import re

import pytest

from cardbench_tiny import CARDBENCH, REPO
from harness import spec

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    BENCH = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "comet_tpu"}


def sources():
    for root, _, files in os.walk(CARDBENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def imported_tops(path):
    """Top-level names of every module a file imports, and of every name
    it hands to importlib / __import__ as a literal."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, CARDBENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    # whole top-level names: comet_tpu_torch is the program, comet_tpu is not allowed
    assert not imported_tops(path) & FORBIDDEN


def test_the_plain_references_import_nothing_of_the_program():
    for folder in ("references", "generators", "work"):
        for name in spec.names(folder, ".py"):
            assert "comet_tpu_torch" not in imported_tops(spec.path(folder, name, ".py"))
    for name in ("spec.py", "peaks.py", "traffic.py"):
        assert "comet_tpu_torch" not in imported_tops(os.path.join(CARDBENCH, "harness", name))


def test_benchmark_keys_and_limits_follow_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["cardbench"] and BENCH["command"][1].startswith("cardbench/")
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("cardbench/") and 1 <= len(c["why"]) <= 200
        assert 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_loads_by_name_and_matches_its_file(w):
    cell = spec.cell(w["name"])
    assert (cell["config"], cell["traffic"], cell["chips"], cell["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    cf = cell["config_spec"]
    entry = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert entry["file"] == f"cardbench/configs/{w['config']}.json"
    assert entry["reduced"] == cf["reduced"] and all(k in cf for k in cf["reduced"])
    assert set(cf.get("reduced_why", {})) == set(cf["reduced"])
    assert entry["source"] == cf["source"] and entry["why"] == cf["why"]
    for kind, name in (("systems", cf["system"]), ("references", cf["reference"])):
        assert hasattr(spec.load_module(kind, name), "System" if kind == "systems" else "expected")
    for g in cf["generators"]:
        assert hasattr(spec.load_module("generators", g), "make")


def test_every_metric_is_a_file_that_agrees_with_the_benchmark():
    files = {n: spec.load_module("metrics", n) for n in spec.names("metrics", ".py")}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]} == set(files)
    for m in BENCH["end_to_end"]:
        mod = files[m["name"]]
        assert (mod.KIND, mod.UNIT, mod.BETTER, mod.SOURCE) == (
            "end_to_end", m["unit"], m["better"], m["source"])
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        mod = files[m["name"]]
        assert (mod.KIND, mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES) == (
            "per_layer", m["unit"], m["better"], m["source"], m["layer"], m["moves"])
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:     # each of its cells reports the metric it moves
            assert m["moves"] in spec.reported(w, False, BENCH)
    for w in cells:    # every cell reports setup_s, one other end-to-end and one per-layer metric
        e2e = spec.reported(w, False, BENCH)
        assert "setup_s" in e2e and len(e2e) >= 2 and spec.reported(w, True, BENCH)


def test_a_roofline_is_named_for_its_stage_in_percent():
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            stage = m["name"].split("_roofline")[0]
            assert m["unit"] == "%" and os.path.exists(spec.path("work", stage, ".py"))
