"""Find the benchmark's pieces by name.

Every cell, configuration, traffic mix, per-layer metric, roofline stage,
system, plain reference and data generator is a file of its own under
`cardbench/`; this module loads them by the names the files carry, so a
later cell or metric is added as new files and no file here changes:

    cells/<cell>.json            configuration, traffic, why
    configs/<config>.json        source, shapes, assumed, reduced, the
                                 generators, system and reference it uses
    traffic/<traffic>.json       the parameters `harness/traffic.py` reads
    metrics/<metric>.py          KIND, UNIT, BETTER, SOURCE, read(ctx); a
                                 per-layer one also LAYER and MOVES
    work/<stage>.py              seconds(cell, data, calls): the least time of a
                                 roofline stage that a system's span
                                 "stage.<stage>" declares
    systems/<system>.py          System(config, data, device): the system under test
    references/<reference>.py    the plain reference the comparison holds it to
    generators/<generator>.py    make(config, seed, device, data)

Which metrics a cell reports is BENCHMARK.json's to say, beside cardbench/:
an end-to-end metric in every cell or in those its "workloads" lists, a
per-layer one in the cells its "workloads" lists or, without the key, in
every cell that reports the end-to-end metric it moves.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_MODULES: dict[str, object] = {}


def path(kind: str, name: str, ext: str) -> str:
    if not name or "/" in name or name.startswith("."):
        raise ValueError(f"bad {kind} name {name!r}")
    return os.path.join(ROOT, kind, name + ext)


def load_json(kind: str, name: str) -> dict:
    with open(path(kind, name, ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module `<kind>/<name>.py`, loaded once (names may hold dots)."""
    key = f"{kind}/{name}"
    if key not in _MODULES:
        file = path(kind, name, ".py")
        mod_name = "cardbench_" + hashlib.sha1(key.encode()).hexdigest()[:12]
        spec = importlib.util.spec_from_file_location(mod_name, file)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


def names(kind: str, ext: str) -> list[str]:
    folder = os.path.join(ROOT, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(folder) if f.endswith(ext))


def cell(name: str) -> dict:
    """The cell with its configuration and traffic loaded beside it."""
    c = load_json("cells", name)
    c["name"] = name
    c["config_spec"] = load_json("configs", c["config"])
    c["traffic_spec"] = load_json("traffic", c["traffic"])
    return c


def benchmark() -> dict:
    with open(os.path.join(os.path.dirname(ROOT), "BENCHMARK.json")) as f:
        return json.load(f)


def reported(cell_name: str, traced: bool, bench: dict | None = None) -> list[str]:
    """The metrics a run of the cell reports: its end-to-end metrics
    without the trace, its per-layer metrics with it."""
    bench = benchmark() if bench is None else bench

    def has(m):
        return cell_name in m["workloads"] if "workloads" in m else None

    e2e = [m["name"] for m in bench["end_to_end"] if has(m) is not False]
    if not traced:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if has(m) or (has(m) is None and m["moves"] in e2e)]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream of the run, from `--seed` and a tag:
    any whole number, however large, gives its own streams."""
    digest = hashlib.sha256(f"{int(seed)}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, tag))
