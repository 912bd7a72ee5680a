"""Reading a torch.profiler trace of a `--trace 1` run's profiled stretch.

- busy: the union of the intervals in which a kernel, copy or set ran on
  the card, inside the "trace.window" range; the idle share is the rest.
- busy in requests: the same inside the benchmark's "request" spans (a
  call of a closed loop, a request of an open loop), against their
  length: the waits between an open loop's arrivals left out.
- a stage's device time: the device time of every kernel, copy and set
  whose launch call (the runtime call CUPTI correlates with it) lies
  inside one of the stage's host spans ("stage.<name>"), whatever the
  kernel's name.
- the breakdown: the device operations that took most time, and the
  longest idle gaps named by the innermost benchmark span the host was in.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np

WINDOW = "trace.window"
SPAN_PREFIXES = ("stage.", "layer.", "builder.", "request", "wait", WINDOW)
TOP = 10


def is_span(name: str) -> bool:
    return name.startswith(SPAN_PREFIXES)


def profiled(run_lead, run_window):
    """Profiles run_lead() (outside the window: the trace can drop events
    at its start), then run_window() inside a "trace.window" range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    card = torch.cuda.is_available()   # the CPU tests profile the host alone
    sync = torch.cuda.synchronize if card else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * card) as prof:
        run_lead()
        sync()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            out = run_window()
            sync()
            wall = time.perf_counter() - t0
    return prof, wall, out


def merged(intervals) -> list[tuple[float, float]]:
    """The union of intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_length(intervals) -> float:
    return sum(b - a for a, b in merged(intervals))


def overlap_length(xs, ys) -> float:
    """Length of the intersection of two unions of intervals."""
    xs, ys = merged(xs), merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def gaps(intervals, w0: float, w1: float):
    """(start, end) of each stretch of [w0, w1] that no interval covers."""
    out, cur = [], w0
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, w1)))
        cur = max(cur, b)
        if cur >= w1:
            break
    if cur < w1:
        out.append((cur, w1))
    return [(a, b) for a, b in out if b > a]


def digest(events) -> dict:
    """events: torch.profiler FunctionEvents (or objects with .name,
    .device_type, .id and .time_range in us). Returns busy_s,
    window_s, stage device seconds and launches, and the breakdown."""
    from torch.autograd import DeviceType

    win = [e for e in events if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no trace.window range")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, launch_at, spans = [], {}, []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not is_span(e.name):   # not a user range mirrored on the device
                device.append((a, b, e.name, e.id))
        elif is_span(e.name):
            spans.append((a, b, e.name))
        elif e.name.startswith(("cuda", "cu")) and e.id:
            launch_at[e.id] = a
    inside = [(max(a, w0), min(b, w1), name) for a, b, name, _ in device if b > w0 and a < w1]
    busy_us = union_length([(a, b) for a, b, _ in inside])
    requests = [(max(a, w0), min(b, w1)) for a, b, name in spans
                if name == "request" and b > w0 and a < w1]
    request_busy_us = overlap_length([(a, b) for a, b, _ in inside], requests)

    stage_spans = sorted((a, b, name[len("stage."):]) for a, b, name in spans
                         if name.startswith("stage.") and w0 <= a < w1)
    stage_us: dict[str, float] = defaultdict(float)
    stage_launches: dict[str, int] = defaultdict(int)
    starts = np.array([s[0] for s in stage_spans])
    for a, b, _, cid in device:
        t = launch_at.get(cid)
        if t is None or not len(starts):
            continue
        j = int(np.searchsorted(starts, t, side="right")) - 1
        if j >= 0 and t <= stage_spans[j][1]:
            stage_us[stage_spans[j][2]] += b - a
            stage_launches[stage_spans[j][2]] += 1

    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in inside:
        by_op[name[:160]] += (b - a) * 1e-6
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    host = [(a, b, name) for a, b, name in spans if name != WINDOW]
    named = []
    for a, b in gaps([(a, b) for a, b, _ in inside], w0, w1):
        mid = 0.5 * (a + b)
        around = [(sb - sa, name) for sa, sb, name in host if sa <= mid <= sb]
        named.append((min(around)[1] if around else "outside the benchmark's spans",
                      (b - a) * 1e-6))
    named.sort(key=lambda g: -g[1])
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "request_s": union_length(requests) * 1e-6, "request_busy_s": request_busy_us * 1e-6,
            "stage_s": {k: v * 1e-6 for k, v in stage_us.items()},
            "stage_launches": dict(stage_launches),
            "stage_spans": {name: sum(1 for s in stage_spans if s[2] == name)
                            for name in {s[2] for s in stage_spans}},
            "breakdown": {"device_ops": [[k, v] for k, v in device_ops],
                          "idle_gaps": [[k, v] for k, v in named[:TOP]]}}
