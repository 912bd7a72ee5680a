"""Whole runs of each cell on the CPU at a tiny size: the result line's
shape, the comparison passing the program, and failing its control and
a program broken underneath; the roofline and trace arithmetic."""

import json
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cardbench_tiny import CARDBENCH, CELLS, SECONDS, tiny_cell
from harness import checks, peaks, spec, trace

import run  # noqa: E402  (cardbench/run.py, on the path through cardbench_tiny)

SEED = 2 ** 33 + 17


def run_tiny(name, hook=None, seed=SEED):
    return run.run(tiny_cell(name), seed, SECONDS, False, "cpu", system_hook=hook)


@pytest.mark.parametrize("name", CELLS)
def test_a_run_is_correct_and_prints_the_contract_line(name):
    result, lines = run_tiny(name)
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert list(result["metrics"]) == spec.reported(name, False)
    assert set(result["metrics"]) == {"qps", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert result["checks"]["mismatched_results"] == {"value": 0, "limit": 0, "rule": "at most"}
    assert lines[0].startswith("check mismatched_results: 0 (limit 0")
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    out = checks.control(tiny_cell(name), SEED, SECONDS, "cpu")
    assert out["correct"] is False and out["control_mismatched_results"] > 0


class Broken:
    """The system with its answers altered where they are produced."""

    def __init__(self, system, fault):
        self.system, self.fault = system, fault

    def __getattr__(self, name):
        return getattr(self.system, name)

    def batch(self, reqs, lo, hi, k):
        ids, scores = self.system.batch(reqs, lo, hi, k)
        ids, scores = ids.copy(), scores.copy()
        if self.fault == "half":         # half of the batch left out
            half = (hi - lo) // 2
            ids[half:], scores[half:] = 0xFFFFFFFF, np.inf
        else:                            # one answer altered
            ids[:, 0] = ids[:, 1]
        return ids, scores

    def one(self, reqs, i, k):
        out = self.system.one(reqs, i, k)
        out[0], out[1] = out[1], out[0]
        return out


@pytest.mark.parametrize("name,fault", [(c, "answer") for c in CELLS]
                         + [("flat-batch2048", "half")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    result, _ = run_tiny(name, lambda s: Broken(s, fault))
    assert result["correct"] is False and result["checks"]["mismatched_results"]["value"] > 0


def test_without_a_card_the_run_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, f"{CARDBENCH}/run.py", "--workload", "flat-batch2048",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_least_time_of_the_stages_over_calls():
    cell = {"config_spec": {"n": 1000, "dim": 4, "categories": ["a", "b", "c", "d"]},
            "traffic_spec": {"k": 10}}
    scan = spec.load_module("work", "scan")
    reqs = SimpleNamespace(cats=np.array([0, 1, 1, 3]))
    want = (peaks.least_seconds(*np.add(scan.least(1, 250, 4, 10, 1000, True),
                                        scan.least(2, 250, 4, 10, 1000, True)))
            + peaks.least_seconds(*scan.least(1, 250, 4, 10, 1000, True)))
    assert scan.seconds(cell, {}, [(reqs, 0, 3), (reqs, 3, 4)]) == pytest.approx(want)
    reqs.cats = None
    assert scan.seconds(cell, {}, [(reqs, 0, 4)]) == peaks.least_seconds(
        *scan.least(4, 1000, 4, 10, 1000, False))
    text = spec.load_module("work", "text")
    tokens = torch.tensor([[0, 1, 1], [2, 2, 2], [1, 3, 0]])
    cell["config_spec"].update(n=3, vocab=4)
    words = SimpleNamespace(words=[np.array([1]), np.array([2, 3])], cats=None)
    # word 1 has 2 postings and touches 2 documents; words 2 and 3 one each,
    # and with the space between them every document's space term
    want = (peaks.least_seconds(*text.least(2, 2, 1, 10, 3, False))
            + peaks.least_seconds(*text.least(2 + 3, 3, 1, 10, 3, False)))
    assert text.seconds(cell, {"tokens": tokens}, [(words, 0, 1), (words, 1, 2)]) == (
        pytest.approx(want))


def test_least_time_of_the_stages():
    scan = spec.load_module("work", "scan")
    ops, n_bytes = scan.least(2048, 10 ** 6, 128, 100, 10 ** 6, False)
    assert ops == 2 * 2048 * 10 ** 6 * 128
    assert n_bytes == 4 * 10 ** 6 * 128 + 4 * 2048 * 128 + 8 * 2048 * 100
    assert abs(peaks.least_seconds(ops, n_bytes) - ops / 67e12) < 1e-15   # operations bound it
    ops, n_bytes = scan.least(1, 250_000, 128, 10, 10 ** 6, True)
    assert n_bytes == 4 * 250_000 * 128 + 4 * 128 + 10 ** 6 / 8 + 80
    assert peaks.least_seconds(ops, n_bytes) == n_bytes / 3.35e12          # bytes bound it
    text = spec.load_module("work", "text")
    assert text.least(1000, 900, 2, 10, 4096) == (0.0, 8000 + 3600 + 512 + 160)
    assert text.least(1000, 900, 2, 10, 4096, False) == (0.0, 8000 + 3600 + 160)


def test_the_metrics_a_cell_reports_are_those_benchmark_json_lists():
    bench = {"end_to_end": [{"name": "qps"}, {"name": "p50_ms", "workloads": ["b"]},
                            {"name": "setup_s"}],
             "per_layer": [{"name": "x", "moves": "qps", "workloads": ["a"]},
                           {"name": "y", "moves": "p50_ms"},
                           {"name": "z", "moves": "qps"}]}
    assert spec.reported("a", False, bench) == ["qps", "setup_s"]
    assert spec.reported("b", False, bench) == ["qps", "p50_ms", "setup_s"]
    assert spec.reported("a", True, bench) == ["x", "z"]
    assert spec.reported("b", True, bench) == ["y", "z"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reports_only_the_cells_per_layer_metrics(name):
    result, _ = run.run(tiny_cell(name), SEED, 2.0, True, "cpu")
    assert result["correct"] is True
    listed = spec.reported(name, True)
    device = {m["name"] for m in spec.benchmark()["per_layer"]
              if m["source"] in ("device_trace", "program_counter")}
    # on the CPU no kernel runs: the readers of the trace and of the port's
    # launch counters find nothing
    assert list(result["metrics"]) == [m for m in listed if m not in device]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def ctx(trace_digest, work, loop="closed"):
    cell = {"traffic_spec": {"loop": loop}}
    return run.Context(cell, {}, 1.0, 0, None, None, trace_digest, work)


def test_a_roofline_share_is_least_time_over_device_time_and_absent_without_either():
    c = ctx({"stage_s": {"scan": 0.02}, "busy_s": 0.5, "window_s": 1.0, "request_s": 0.8,
             "request_busy_s": 0.4}, {"scan": 0.005})
    assert c.roofline("scan") == 25.0
    assert c.roofline("text") is None
    assert ctx({"stage_s": {}, "busy_s": 1, "window_s": 1}, {"scan": 0.005}).roofline("scan") is None
    assert ctx(None, {"scan": 0.005}).roofline("scan") is None
    idle = spec.load_module("metrics", "idle_share")
    assert idle.read(c) == 50.0 and idle.read(ctx(None, {})) is None
    assert idle.read(ctx({"busy_s": 0.0, "request_s": 0.8, "request_busy_s": 0.0}, {})) is None


def ev(name, a, b, cuda=False, eid=0):
    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
                           id=eid, time_range=SimpleNamespace(start=a, end=b),
                           device_time_total=0.0)


def test_the_trace_digest_counts_busy_time_stages_and_gaps():
    events = [ev("trace.window", 100, 1100),
              ev("request", 100, 600), ev("stage.scan", 120, 200), ev("cudaLaunchKernel", 150, 160,
                                                                            eid=7),
              ev("wait", 600, 1100), ev("cudaLaunchKernel", 700, 705, eid=8),
              ev("k2", 300, 500, cuda=True, eid=7), ev("k2", 450, 550, cuda=True, eid=7),
              ev("copy", 800, 900, cuda=True, eid=8), ev("trace.window", 100, 1100, cuda=True)]
    d = trace.digest(events)
    assert d["busy_s"] == pytest.approx(350e-6) and d["window_s"] == pytest.approx(1000e-6)
    # the request (100-600) holds 250 us of the device's 350: the copy at
    # 800-900 ran while the loop waited for the next arrival
    assert d["request_s"] == pytest.approx(500e-6)
    assert d["request_busy_s"] == pytest.approx(250e-6)
    assert d["stage_s"] == {"scan": pytest.approx(300e-6)} and d["stage_launches"] == {"scan": 2}
    gaps = d["breakdown"]["idle_gaps"]
    assert gaps[0] == ["wait", pytest.approx(250e-6)]
    assert [g[0] for g in gaps] == ["wait", "stage.scan", "wait"]
    assert d["breakdown"]["device_ops"][0] == ["k2", pytest.approx(300e-6)]


@pytest.mark.cuda
def test_one_run_on_the_card(cuda_card):
    p = subprocess.run([sys.executable, f"{CARDBENCH}/run.py", "--workload", "flat-online-k10",
                        "--seed", "5", "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the harness measures only on one")
