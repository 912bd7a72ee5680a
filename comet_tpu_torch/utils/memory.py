"""Exact per-structure memory accounting for an index.

Counterpart of comet_tpu/utils/memory.py. `memory_report(index)` walks an
index's instance state and tallies every numpy array and every CPU tensor
as HOST bytes and every tensor on an accelerator as DEVICE bytes, grouped
by the top-level attribute that owns it. It counts array bytes only, not
Python-object overhead. Attached to every index as `stats()["memory"]`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_SCALARS = (str, bytes, int, float, bool, type(None))


def _scalar_like(v: Any) -> bool:
    """True when v cannot (transitively) hold an array worth counting: a
    plain scalar, or a list/tuple of scalars (probed by first element)."""
    if isinstance(v, _SCALARS):
        return True
    if isinstance(v, (list, tuple)) and v:
        return isinstance(v[0], _SCALARS)
    return False


def _children(obj: Any):
    """Yield the traversable members of a container or package object.

    Large containers whose first elements are plain scalars are skipped
    wholesale: they cannot hold arrays (e.g. a slot store's id map)."""
    if isinstance(obj, (dict, list, tuple, set, frozenset)):
        values = obj.values() if isinstance(obj, dict) else obj
        if len(obj) > 64:
            it = iter(values)
            probe = [v for _, v in zip(range(4), it)]
            if all(_scalar_like(v) for v in probe):
                return
            yield from probe
            yield from it
            return
        yield from values
    else:
        mod = getattr(type(obj), "__module__", "") or ""
        if mod.startswith("comet_tpu_torch"):
            d = getattr(obj, "__dict__", None)
            if d is not None:
                yield from d.values()
            for slots_cls in type(obj).__mro__:
                for name in getattr(slots_cls, "__slots__", ()):
                    if hasattr(obj, name):
                        yield getattr(obj, name)


def _tally(obj: Any, host: dict, device: dict, key: str, seen: set) -> None:
    oid = id(obj)
    if oid in seen:
        return
    if isinstance(obj, np.ndarray):
        seen.add(oid)
        host[key] = host.get(key, 0) + int(obj.nbytes)
        return
    if isinstance(obj, torch.Tensor):
        seen.add(oid)
        side = host if obj.device.type == "cpu" else device
        side[key] = side.get(key, 0) + obj.numel() * obj.element_size()
        return
    if isinstance(obj, _SCALARS):
        return
    seen.add(oid)
    for child in _children(obj):
        _tally(child, host, device, key, seen)


def memory_report(index: Any) -> dict:
    """{"host": {attr: bytes}, "device": {attr: bytes},
    "host_total": int, "device_total": int} — exact array bytes, grouped by
    the index's top-level attribute names (leading underscores stripped).

    Shared arrays are counted once (identity-deduped), in the first
    attribute that reaches them."""
    host: dict[str, int] = {}
    device: dict[str, int] = {}
    seen: set[int] = set()
    for name, value in vars(index).items():
        _tally(value, host, device, name.lstrip("_"), seen)
    return {
        "host": host,
        "device": device,
        "host_total": sum(host.values()),
        "device_total": sum(device.values()),
    }
