"""A later PR adds a configuration, a cell, a roofline stage and a
per-layer metric as new files and BENCHMARK.json entries only: a copy of
the harness with such files added runs the new cell, computes the new
stage's work and reports the new metric, and no file it had changes."""

import json
import os
import shutil
import subprocess
import sys

from cardbench_tiny import CARDBENCH, REPO

NEW = {
    "systems/stubflat.py": '''
from harness.spec import load_module


class System(load_module("systems", "flat").System):
    def spans(self):
        return [(self.index, "_search_launch", "stage.stub")]
''',
    "work/stub.py": '''
def seconds(cell, data, calls):
    return float(len(calls))
''',
    "metrics/stub_calls.py": '''
KIND, UNIT, BETTER, SOURCE = "per_layer", "count", "higher", "device_trace"
LAYER, MOVES = "kernels", "qps"


def read(ctx):
    return ctx.work["stub"] if set(ctx.work) == {"stub"} else -1.0
''',
    "cells/stub-cell.json": json.dumps({"config": "stub-flat", "traffic": "online-k10",
                                        "chips": 1, "why": "a stub"}),
}

RUN = '''
import json, sys
sys.path.insert(0, sys.argv[1])
import run
from harness import spec
cell = spec.cell("stub-cell")
cell["config_spec"].update(n=4096, pool=512)
cell["traffic_spec"].update(rate=50.0, sample=128, warmup=6, trace_seconds=1.0)
print(json.dumps(run.run(cell, 2 ** 33 + 5, 2.0, True, "cpu")[0]))
'''


def test_a_cell_config_stage_and_metric_are_added_as_new_files_only(tmp_path):
    bench_dir = tmp_path / "cardbench"
    shutil.copytree(CARDBENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    with open(os.path.join(CARDBENCH, "configs", "sift1m-flat.json")) as f:
        config = dict(json.load(f), system="stubflat")
    files = dict(NEW, **{"configs/stub-flat.json": json.dumps(config)})
    for rel, text in files.items():
        path = bench_dir / rel
        assert not path.exists()
        path.write_text(text)
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "stub-flat", "source": "a stub", "reduced": [],
                             "file": "cardbench/configs/stub-flat.json", "why": "a stub"})
    bench["workloads"].append({"name": "stub-cell", "config": "stub-flat",
                               "traffic": "online-k10", "chips": 1, "why": "a stub"})
    bench["per_layer"].append({"name": "stub_calls", "unit": "count", "better": "higher",
                               "source": "device_trace", "layer": "kernels", "moves": "qps",
                               "workloads": ["stub-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    p = subprocess.run([sys.executable, "-c", RUN, str(bench_dir)], capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    # 50 traced requests a second for 1 s: the stub stage's work, and only it
    assert result["metrics"] == {"stub_calls": {"value": 50.0, "unit": "count"}}
    assert all(p.read_bytes() == data for p, data in before.items())
