"""The two loops a cell's traffic runs in.

closed: one caller; each call starts when the last has returned, until
    `seconds` have passed; the rate is all queries over all of that time.
open:   requests due on a schedule, served one at a time in arrival order
    by one caller; each request is timed from when it was due, so a stall
    delays every request behind it. Requests due in the window are all
    served, at most `grace` seconds past its close; one not served by then
    counts as failed.
"""

from __future__ import annotations

import time

import numpy as np

from harness.spans import record

SPIN_S = 0.0005   # the last stretch of a wait spins instead of sleeping


def wait_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > SPIN_S:
            time.sleep(left - SPIN_S)


def closed(call, keep, seconds: float, batch: int, traced: bool = False, first: int = 0):
    """call(c) runs call number c; keep(c, out) keeps what the check needs."""
    call_s, failed, c = [], 0, first
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            with record("request", traced):
                out = call(c)
        except Exception as exc:  # a failed call is counted, and the loop goes on
            out = None
            failed += batch
            print(f"call {c} failed: {exc!r}", flush=True)
        t1 = time.perf_counter()
        call_s.append(t1 - t0)
        if out is not None:
            keep(c, out)
        c += 1
        if t1 - t_start >= seconds:
            break
    return {"elapsed": t1 - t_start, "calls": c - first, "attempted": (c - first) * batch,
            "failed": failed, "call_s": np.asarray(call_s)}


def open_loop(call, keep, due: np.ndarray, seconds: float, grace: float, traced: bool = False,
              t_zero: float | None = None):
    """due: each request's due time, seconds after the window opens."""
    n = len(due)
    lat = np.full(n, np.inf)
    ends = np.full(n, np.inf)
    late = np.zeros(n)
    failed = 0
    t0 = time.perf_counter() if t_zero is None else t_zero
    for i in range(n):
        t_due = t0 + due[i]
        with record("wait", traced):
            wait_until(t_due)
        start = time.perf_counter()
        if start > t0 + seconds + grace:
            failed += n - i
            break
        try:
            with record("request", traced):
                out = call(i)
        except Exception as exc:
            out = None
            failed += 1
            print(f"request {i} failed: {exc!r}", flush=True)
        end = time.perf_counter()
        if out is not None:
            keep(i, out)
            lat[i] = end - t_due
            ends[i] = end - t0
        late[i] = start - t_due
    return {"elapsed": seconds, "attempted": n, "failed": failed, "latency_s": lat,
            "end_s": ends, "late_s": late, "completed": int((ends <= seconds).sum())}
