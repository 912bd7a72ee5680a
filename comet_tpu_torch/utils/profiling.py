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
"""

from __future__ import annotations

import contextlib
import logging
import os
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
