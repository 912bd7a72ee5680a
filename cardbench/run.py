"""The benchmark of comet_tpu_torch on NVIDIA cards: one run of one cell.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --sweep 200,300,400
    python3 cardbench/run.py --workload <cell> --seeds 1,2,3 --control

A run builds the cell's configuration (cells/<cell>.json names it) from
the seed, warms the cell's own shapes, measures its traffic for
`--seconds`, reads the peak device memory, frees the program's state,
holds what the timed path returned to the plain reference, and prints one
JSON line last on standard output: correct, attempted, failed, the
metrics (end-to-end with `--trace 0`, per-layer with `--trace 1`), the
device, with `--trace 1` the breakdown, and last the numbers compared
beside their limits, which also end standard error. Without a CUDA card
it exits 2 and prints no result.

`--sweep` (open-loop cells) pays set-up once and runs a window at each
offered rate, printing one line a rate; `--control` runs no program: it
puts the reference, at the precision below the configuration's, in the
program's place for each seed and prints what the comparison reads.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.path.dirname(HERE))   # the checkout's root: comet_tpu_torch

from harness import checks, loops, spec, traffic  # noqa: E402
from harness.traffic import Plan, vocabulary  # noqa: E402
from harness.spans import Spans  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "comet_tpu")   # top-level names, compared whole
GRACE_S = 60.0        # an open loop serves its window's requests at most this long past the close
LEAD_S = 0.3          # profiled calls before a traced window opens
KEEP_PER_CALL = 8     # rows of a closed-loop call kept for the check


class Context:
    """What a metric's reader reads."""

    def __init__(self, cell, window, setup_s, peak_bytes, spans, launches, trace, work):
        self.cell = cell
        self.loop = cell["traffic_spec"]["loop"]
        self.window = window
        self.setup_s = setup_s
        self.peak_bytes = peak_bytes
        self.spans = spans
        self.launches = launches
        self.trace = trace
        self.work = work or {}

    def span_mean_ms(self, name):
        times = (self.spans or {}).get(name)
        return 1e3 * float(np.mean(times)) if times else None

    def roofline(self, stage):
        """Least time over device time of a stage, in %; None where the
        trace holds no device time of it."""
        if not self.trace:
            return None
        dev = self.trace["stage_s"].get(stage, 0.0)
        least = self.work.get(stage, 0.0)
        return 100.0 * least / dev if dev > 0 and least > 0 else None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def launches():
    """The port's launch counters (chip_smoke.py's read_launches list)."""
    from comet_tpu_torch.ops import beam_kernel, bm25, fused_scan, ivf_sparse, sortnet

    return {"bm25_score": bm25.LAUNCHES, "topk_cl": sortnet.LAUNCHES,
            "fused_dist_select": fused_scan.LAUNCHES,
            "topk_cl_split": sortnet.SPLIT_LAUNCHES,
            "fused_dist_select_fewq": fused_scan.FEWQ_LAUNCHES,
            "fused_dist_select_nprobe": fused_scan.NPROBE_LAUNCHES,
            "fused_dist_select_bf16": fused_scan.BF16_LAUNCHES,
            "fused_dist_select_f16": fused_scan.F16_LAUNCHES,
            "fused_dist_select_int8": fused_scan.INT8_LAUNCHES,
            "sparse_scan": ivf_sparse.LAUNCHES, "sparse_scan_bf16": ivf_sparse.BF16_LAUNCHES,
            "beam_merge": beam_kernel.LAUNCHES, "beam_merge_fused": beam_kernel.FUSED_LAUNCHES,
            "gather_score": beam_kernel.SCORE_LAUNCHES,
            "gather_score_packed": beam_kernel.PACKED_SCORE_LAUNCHES,
            "fused_expand": beam_kernel.FUSE_LAUNCHES}


def make_data(config, seed, device):
    """The configuration's generators, on the device, then moved to the
    host: the program's peak memory is its own."""
    import torch

    data = {}
    for name in config["generators"]:
        spec.load_module("generators", name).make(config, seed, device, data)
    for key in list(data):
        data[key] = data[key].cpu()
    data["corpus_host"] = data["corpus"].numpy()
    data["pool_host"] = data["pool"].numpy()
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return data


def window_run(system, plan, seconds, traced):
    """The measured loop; returns (loop record, kept rows)."""
    tr, k = plan.tr, plan.tr["k"]
    kept = {}
    if tr["loop"] == "closed":
        def call(c):
            return system.batch(plan.reqs, *plan.batch_bounds(c), k)

        def keep(c, out):
            lo, hi = plan.batch_bounds(c)
            for j in traffic.sample(plan.seed, hi - lo, KEEP_PER_CALL, f"call{c}"):
                kept[(c, int(j))] = system.batch_row(out, int(j))

        rec = loops.closed(call, keep, seconds, tr["batch"], traced)
    else:
        picks = set(traffic.sample(plan.seed, len(plan.due), tr["sample"], "window").tolist())

        def call(i):
            return system.one(plan.reqs, i, k)

        def keep(i, out):
            if i in picks:
                kept[i] = system.one_row(out)

        rec = loops.open_loop(call, keep, plan.due, seconds, GRACE_S, traced)
    return rec, kept


def warm_up(system, plan):
    """Every shape the window uses, twice: builds or loads the kernels."""
    tr, k = plan.tr, plan.tr["k"]
    if tr["loop"] == "closed":
        per = tr["requests"] // tr["batch"]
        for c in range(max(2, per)):
            system.batch(plan.reqs, *plan.batch_bounds(c), k)
    else:
        for _ in range(2):
            for i in range(len(plan.warm.rows)):
                system.one(plan.warm, i, k)


def traced_stretch(system, plan, calls_before):
    """The profiled stretch after the window: LEAD_S of warm calls, then
    `trace_seconds` of the cell's traffic inside "trace.window"."""
    from harness import trace

    tr, k = plan.tr, plan.tr["k"]
    if tr["loop"] == "closed":
        def lead():
            t0 = time.perf_counter()
            c = 0
            while time.perf_counter() - t0 < LEAD_S:
                system.batch(plan.reqs, *plan.batch_bounds(c), k)
                c += 1

        def window():
            calls = []

            def call(c):
                calls.append(plan.batch_bounds(c))
                return system.batch(plan.reqs, *calls[-1], k)

            loops.closed(call, lambda c, out: None, tr["trace_seconds"], tr["batch"], True,
                         calls_before)
            return [(plan.reqs, lo, hi) for lo, hi in calls]
    else:
        def lead():
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < LEAD_S:
                system.one(plan.warm, i % len(plan.warm.rows), k)
                i += 1

        def window():
            loops.open_loop(lambda i: system.one(plan.trace_reqs, i, k), lambda i, out: None,
                            plan.trace_due, tr["trace_seconds"], GRACE_S, True)
            return [(plan.trace_reqs, i, i + 1) for i in range(len(plan.trace_due))]

    prof, wall, calls = trace.profiled(lead, window)
    t0 = time.perf_counter()
    digest = trace.digest(prof.events())
    print(f"trace: {wall:.3f} s profiled, read in {time.perf_counter() - t0:.1f} s; stages "
          f"by launch {digest['stage_s']} ({digest['stage_launches']} launches, "
          f"{digest['stage_spans']} spans)", file=sys.stderr, flush=True)
    return digest, calls


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--seeds", default="")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--sweep", default="")
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    try:
        import torch

        import comet_tpu_torch  # noqa: F401  (the program under test, beside cardbench/)
    except ImportError as exc:
        print(f"cannot import the program: {exc}", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.control:
        seeds = [int(s) for s in args.seeds.split(",")] if args.seeds else [args.seed]
        for seed in seeds:
            print(json.dumps(checks.control(cell, seed, args.seconds, "cuda")), flush=True)
        return 0
    if args.sweep:
        return sweep(cell, args.seed, args.seconds, [float(r) for r in args.sweep.split(",")])
    result, lines = run(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"the process holds {bad}: the benchmark runs without JAX and comet_tpu",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def run(cell, seed, seconds, traced, device, system_hook=None):
    """One run; returns (the result object, the check's lines)."""
    import torch

    cf, tr = cell["config_spec"], cell["traffic_spec"]
    on_card = str(device).startswith("cuda")
    data = make_data(cf, seed, device)
    plan = Plan(cell, seed, seconds)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    system = spec.load_module("systems", cf["system"]).System(cf, data, device)
    if system_hook is not None:
        system = system_hook(system)
    spans = Spans() if traced else None
    stages = []     # the roofline stages the system's spans declare
    if traced:
        for obj, attr, name in system.spans():
            spans.wrap(obj, attr, name)
            if name.startswith("stage."):
                stages.append(name[len("stage."):])
    warm_up(system, plan)
    if on_card:
        torch.cuda.synchronize()
    if spans:
        for times in spans.times.values():
            times.clear()
    before = launches()
    setup_s = time.perf_counter() - T_PROCESS
    rec, kept = window_run(system, plan, seconds, traced)
    counted = {key: v - before[key] for key, v in launches().items()}
    digest, work = None, None
    if traced:
        span_times = {key: list(v) for key, v in spans.times.items()}
        digest, traced_calls = traced_stretch(system, plan, rec.get("calls", 0))
        spans.remove()
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    else:
        peak = 0
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    for key in ("corpus", "pool", "tokens", "word_bytes"):
        if key in data:
            data[key] = data[key].to(device)
    if traced:
        work = checks.stage_work(cell, data, traced_calls, stages)
    verdict = checks.judge(cell, data, plan, kept, rec)
    ctx = Context(cell, rec, setup_s, peak, span_times if traced else None,
                  counted, digest, work)
    metrics = {}
    for name in spec.reported(cell["name"], traced):
        m = spec.load_module("metrics", name)
        value = m.read(ctx)
        if value is not None and not np.isfinite(value):
            print(f"{name} reads {value}: left out", file=sys.stderr)
        elif value is not None:
            metrics[name] = {"value": float(value), "unit": m.UNIT}
    result = {"correct": verdict["correct"] and rec["failed"] == 0,
              "attempted": int(rec["attempted"]), "failed": int(rec["failed"]),
              "metrics": metrics,
              "device": device_info(cell, peak, digest, on_card)}
    if digest:
        result["breakdown"] = digest["breakdown"]
    result["checks"] = verdict["checks"]
    lines = [f"check {name}: {c['value']} (limit {c['limit']}, {c['rule']})"
             for name, c in verdict["checks"].items()]
    return result, lines


def device_info(cell, peak, digest, on_card):
    import torch

    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if digest:
        info["busy_s"] = digest["busy_s"]
        info["window_s"] = digest["window_s"]
    return info


def sweep(cell, seed, seconds, rates):
    """One set-up, then a window at each offered rate: completed share,
    p50 and p99, and the mean latency of the window's first and last fifth
    (a growing backlog shows as a later fifth slower than the first)."""
    cf, tr = cell["config_spec"], cell["traffic_spec"]
    data = make_data(cf, seed, "cuda")
    plan = Plan(cell, seed, seconds)
    system = spec.load_module("systems", cf["system"]).System(cf, data, "cuda")
    warm_up(system, plan)
    print(json.dumps({"setup_s": time.perf_counter() - T_PROCESS}), flush=True)
    for rate in rates:
        tr_rate = dict(tr, rate=rate)
        due = traffic.arrivals(seed, rate, 0.0, seconds, f"sweep{rate}")
        reqs = traffic.requests(tr_rate, cf, seed, len(due), f"sweep{rate}", vocabulary(cf))
        rec = loops.open_loop(lambda i: system.one(reqs, i, tr["k"]), lambda i, out: None,
                              due, seconds, 0.0)
        lat = rec["latency_s"]
        fifth = max(1, len(lat) // 5)
        done = np.isfinite(lat)
        print(json.dumps({"rate": rate, "offered": len(due),
                          "completed_share": float(rec["completed"] / max(1, len(due))),
                          "served_share": float(done.mean()),
                          "p50_ms": float(np.percentile(lat, 50) * 1e3),
                          "p99_ms": float(np.percentile(lat, 99) * 1e3),
                          "first_fifth_ms": float(np.mean(lat[:fifth]) * 1e3),
                          "last_fifth_ms": float(np.mean(lat[-fifth:]) * 1e3),
                          "late_p99_ms": float(np.percentile(rec["late_s"], 99) * 1e3)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
