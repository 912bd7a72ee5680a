"""Tracing and timing.

Counterpart of comet_tpu/utils/profiling.py on torch:

- `profile_trace(dir)` wraps a block in torch.profiler (host activity and,
  where a card is present, its kernels and copies) and writes the trace to
  `dir/trace.json` (viewable in Perfetto or chrome://tracing); it yields
  the profiler, whose `key_averages()` gives per-kernel device times.
- `Timer` / `timed` give wall-clock spans that, before they stop, wait for
  the devices of the tensors registered with `sync`; given a CUDA
  `device`, a span also times the card's stream with CUDA events
  (`device_elapsed`, seconds).
- `span(name)` marks a step of the search paths (every name starts with
  "layer."). It is on only while a torch profiler records on the calling
  thread, as inside `profile_trace`: then it opens a `record_function`
  range, so the trace shows the program's steps above the kernels they
  launch, and keeps a record in memory (`spans()`). Off, it is one check
  and a shared no-op context. The outermost span on a thread is a
  request; the spans opened inside it are its steps. `count(key, n)` adds
  to the innermost open span's counters while on: a request counts the
  `queries` it serves, each copy to a CUDA device its `h2d_bytes`
  (`count_h2d`), and a collect that maps result slots to ids on the
  device the rows it maps (`ids_on_card`).
- `span_ms`, `unnamed_ms` and `per_query` summarise the stored requests:
  the store holds the newest profiled stretch only (the first span under a
  profiler after one without it empties it), at most `MAX_RECORDS`
  records, and counts those it drops (`dropped()`).
"""

from __future__ import annotations

import contextlib
import fnmatch
import itertools
import logging
import os
import threading
import time

import torch

log = logging.getLogger("comet_tpu_torch.profiling")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler trace around a block: per-kernel device timings."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock span that waits for registered device work before it
    stops; with a CUDA `device`, also the span's device time from events."""

    def __init__(self, name: str = "span", device=None):
        self.name = name
        self.elapsed = 0.0
        self.device_elapsed: float | None = None
        self._device = torch.device(device) if device is not None else None
        self._sync_targets: list = []
        self._events = None

    def sync(self, *tensors):
        """Register tensors whose devices to wait for before the span closes."""
        self._sync_targets.extend(tensors)
        return tensors[0] if len(tensors) == 1 else tensors

    def __enter__(self):
        if self._device is not None and self._device.type == "cuda":
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        devices = {t.device for t in self._sync_targets
                   if isinstance(t, torch.Tensor) and t.device.type == "cuda"}
        if self._events is not None:
            self._events[1].record()
            devices.add(self._device)
        for dev in devices:
            torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        if self._events is not None:
            self.device_elapsed = self._events[0].elapsed_time(self._events[1]) / 1e3
        log.debug("%s: %.3f ms", self.name, self.elapsed * 1e3)
        return False


@contextlib.contextmanager
def timed(name: str = "span", device=None):
    t = Timer(name, device)
    with t:
        yield t


# -- spans on the profiler's clock ---------------------------------------------

MAX_RECORDS = 1 << 20

_profiling = torch.autograd._profiler_enabled   # the cheapest check: ~0.1 us
_OFF = contextlib.nullcontext()
_local = threading.local()
_lock = threading.Lock()      # guards the store below
_request_ids = itertools.count(1)
_records: list["SpanRecord"] = []
_dropped = 0
_stale = False      # a span opened with no profiler since the store was filled


class SpanRecord:
    """One span: its name, start and end (`time.perf_counter_ns`), the
    request it belongs to, its parent record (None for a request) and its
    counters (None until something is counted)."""

    __slots__ = ("name", "start", "end", "request", "parent", "counters")

    def __init__(self, name, start, end, request, parent, counters=None):
        self.name, self.start, self.end = name, start, end
        self.request, self.parent, self.counters = request, parent, counters

    def __repr__(self):
        return (f"SpanRecord({self.name!r}, request={self.request}, "
                f"ms={(self.end - self.start) / 1e6 if self.end else None})")


class _Span:
    __slots__ = ("_name", "_range", "_record")

    def __init__(self, name):
        self._name = name

    def __enter__(self):
        global _stale, _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        rid = parent.request if parent is not None else next(_request_ids)
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        rec = self._record = SpanRecord(self._name, time.perf_counter_ns(), None, rid, parent)
        with _lock:
            if _stale:
                _records.clear()
                _dropped, _stale = 0, False
            if len(_records) < MAX_RECORDS:
                _records.append(rec)
            else:
                _dropped += 1
        stack.append(rec)
        return rec

    def __exit__(self, *exc):
        self._record.end = time.perf_counter_ns()
        _local.stack.pop()
        self._range.__exit__(*exc)
        return False


def span(name: str):
    """A step of a search path, as a context manager: on only while a
    torch profiler records (see the module's docstring)."""
    global _stale
    if not _profiling():
        _stale = True
        return _OFF
    return _Span(name)


def count(key: str, n) -> None:
    """Adds n to the innermost open span's counter `key`, while on."""
    if not _profiling():
        return
    stack = getattr(_local, "stack", None)
    if stack:
        rec = stack[-1]
        if rec.counters is None:
            rec.counters = {}
        rec.counters[key] = rec.counters.get(key, 0) + n


def count_h2d(nbytes: int, device: torch.device) -> None:
    """Counts `h2d_bytes` for a copy of nbytes to `device`, if a CUDA one."""
    if _profiling() and device.type == "cuda":
        count("h2d_bytes", int(nbytes))


def spans() -> list[SpanRecord]:
    """The stored records, in the order their spans opened."""
    return list(_records)


def dropped() -> int:
    """Spans of the stored stretch left out once the store was full."""
    return _dropped


def clear() -> None:
    global _dropped, _stale
    with _lock:
        _records.clear()
        _dropped, _stale = 0, False


def requests(records=None) -> dict[int, list[SpanRecord]]:
    """The closed records by request id, each list led by its request's
    outermost span; a request whose outermost span the store dropped is
    left out."""
    out: dict[int, list[SpanRecord]] = {}
    for rec in _records if records is None else records:
        if rec.end is not None:
            out.setdefault(rec.request, []).append(rec)
    return {rid: recs for rid, recs in out.items() if recs[0].parent is None}


def span_ms(patterns, records=None) -> float | None:
    """The mean, over the requests that hold a span whose name matches one
    of `patterns` (fnmatch), of those spans' summed duration, in ms."""
    patterns = (patterns,) if isinstance(patterns, str) else tuple(patterns)
    sums = []
    for recs in requests(records).values():
        hit = [r.end - r.start for r in recs
               if any(fnmatch.fnmatchcase(r.name, p) for p in patterns)]
        if hit:
            sums.append(sum(hit))
    return sum(sums) / len(sums) / 1e6 if sums else None


def unnamed_ms(records=None) -> float | None:
    """The mean, over the requests, of the time of a request's outermost
    span that none of its leaf spans (spans with no span inside) covers."""
    out = []
    for recs in requests(records).values():
        parents = {id(r.parent) for r in recs}
        covered = reach = 0
        for a, b in sorted((r.start, r.end) for r in recs[1:] if id(r) not in parents):
            a = max(a, reach)
            if b > a:
                covered, reach = covered + b - a, b
        out.append(recs[0].end - recs[0].start - covered)
    return sum(out) / len(out) / 1e6 if out else None


def per_query(key: str, records=None) -> float | None:
    """Counter `key` summed over every stored span, over the `queries` the
    requests served; None where no request counted queries."""
    total = served = 0
    for recs in requests(records).values():
        for rec in recs:
            if rec.counters:
                total += rec.counters.get(key, 0)
        if recs[0].counters:
            served += recs[0].counters.get("queries", 0)
    return total / served if served else None
