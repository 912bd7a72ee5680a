"""Shared helpers of the benchmark's CPU tests: the harness on the path,
and cells cut to a size the CPU runs in seconds."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CARDBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(CARDBENCH)
for p in (CARDBENCH, REPO):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import spec  # noqa: E402

CELLS = ("flat-batch2048", "hybrid-online-rrf", "flat-online-k10")
SECONDS = 3.0


def tiny_cell(name):
    """The cell with its configuration and traffic cut down: widths stay."""
    cell = spec.cell(name)
    cf, tr = cell["config_spec"], cell["traffic_spec"]
    cf.update(n=4096, pool=512)
    if "vocab" in cf:
        cf.update(vocab=6000, words_per_doc=20)
    if tr["loop"] == "closed":
        tr.update(batch=64, requests=256, sample=128)
    else:
        tr.update(rate=50.0, sample=128, warmup=6)
    return cell
