"""The benchmark's own host spans, put around the program's calls into
each layer in a `--trace 1` run (the program carries none of its own):
a span is a wall-clock duration kept in memory and, while the profiler
records, a `record_function` range, so that the kernels the profiler links
to the host op that launched them are found inside it."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext


def record(name: str, on: bool):
    if not on:
        return nullcontext()
    from torch.profiler import record_function

    return record_function(name)


class Spans:
    """Wraps (object, attribute) pairs with timed spans; `remove` puts the
    originals back. A span named "builder.<x>" wraps a builder factory: the
    span times the `execute` of the builder it returns."""

    def __init__(self):
        self.times: dict[str, list[float]] = defaultdict(list)
        self._installed = []

    def wrap(self, obj, attr: str, name: str) -> None:
        orig = getattr(obj, attr)
        own = vars(obj).get(attr, None) if hasattr(obj, "__dict__") else None
        times = self.times[name]

        def timed(fn):
            def call(*args, **kwargs):
                with record(name, True):
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        times.append(time.perf_counter() - t0)
            return call

        if name.startswith("builder."):
            def factory(*args, **kwargs):
                builder = orig(*args, **kwargs)
                builder.execute = timed(builder.execute)
                return builder
            setattr(obj, attr, factory)
        else:
            setattr(obj, attr, timed(orig))
        self._installed.append((obj, attr, own))

    def remove(self) -> None:
        for obj, attr, own in reversed(self._installed):
            if own is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, own)
        self._installed.clear()
