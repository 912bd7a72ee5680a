"""The one traffic generator: it reads a traffic file's parameters and
draws the requests of a run from `--seed`.

Parameters (traffic/<name>.json):
    loop           "closed" (one caller, the next call when the last
                   returns) or "open" (arrivals on a schedule)
    entry          the system's entry point: "search_batch" or "fluent"
    k              results a query
    batch          queries a call (closed loop)
    requests       the request pool a closed loop cycles through
    rate           offered queries/s (open loop)
    term_counts    words a query text draws from (hybrid), in equal shares
    term_ranks     [lo, hi): the vocabulary indices query words come from
    trace_seconds  length of the profiled stretch of a `--trace 1` run
    sample         results the correctness check compares

Where the configuration has `categories`, each request filters on one.
Every seed gets the same amount of work: term counts and categories come
in equal shares, shuffled, and an open loop's n = rate x seconds arrivals
are n sorted uniform times over the window (a Poisson process given its
count), so the count of arrivals does not vary with the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from harness import spec
from harness.spec import rng as seeded


@dataclass
class Requests:
    rows: np.ndarray                        # pool row of each request's vector
    cats: np.ndarray | None = None          # category index a request
    words: list | None = None               # word indices of each request's text
    texts: list | None = None               # the texts


def balanced(rng: np.random.Generator, values, count: int) -> np.ndarray:
    """`count` draws of `values` in equal shares, shuffled."""
    return rng.permutation(np.resize(np.asarray(values), count))


def requests(traffic: dict, config: dict, seed: int, count: int, tag: str,
             vocabulary=None) -> Requests:
    """`count` requests of this traffic; `tag` names the stream (window,
    warm-up, traced stretch) so that each has requests of its own."""
    rng = seeded(seed, f"traffic/{tag}")
    rows = rng.integers(0, config["pool"], size=count)
    out = Requests(rows=rows)
    cats = config.get("categories")
    if cats:
        out.cats = balanced(rng, range(len(cats)), count)
    if traffic.get("term_counts"):
        lo, hi = traffic["term_ranks"]
        counts = balanced(rng, traffic["term_counts"], count)
        out.words = [rng.choice(np.arange(lo, hi), size=c, replace=False) for c in counts]
        out.texts = [" ".join(vocabulary[w] for w in ws) for ws in out.words]
    return out


def arrivals(seed: int, rate: float, start: float, seconds: float, tag: str) -> np.ndarray:
    """round(rate x seconds) due times in [start, start + seconds), sorted."""
    rng = seeded(seed, f"arrivals/{tag}")
    n = int(round(rate * seconds))
    return start + np.sort(rng.uniform(0.0, seconds, size=n))


def sample(seed: int, population: int, size: int, tag: str) -> np.ndarray:
    """A seeded sample (sorted, no repeats) of range(population)."""
    rng = seeded(seed, f"sample/{tag}")
    size = min(size, population)
    return np.sort(rng.choice(population, size=size, replace=False))


def vocabulary(config):
    if "vocab" not in config:
        return None
    return spec.load_module("generators", "zipf_texts").vocabulary(config["vocab"])


class Plan:
    """The requests of one run, drawn from the seed."""

    def __init__(self, cell, seed, seconds):
        tr, cf = cell["traffic_spec"], cell["config_spec"]
        self.tr, self.cf, self.seed = tr, cf, seed
        vocab = vocabulary(cf)
        if tr["loop"] == "closed":
            self.reqs = requests(tr, cf, seed, tr["requests"], "pool", vocab)
            self.warm = self.reqs
        else:
            self.due = arrivals(seed, tr["rate"], 0.0, seconds, "window")
            self.reqs = requests(tr, cf, seed, len(self.due), "window", vocab)
            self.trace_due = arrivals(seed, tr["rate"], 0.0, tr["trace_seconds"], "trace")
            self.trace_reqs = requests(tr, cf, seed, len(self.trace_due), "trace", vocab)
            self.warm = requests(tr, cf, seed, tr["warmup"], "warm", vocab)

    def batch_bounds(self, c):
        """(lo, hi) of closed-loop call c: batches cycle through the pool."""
        b = self.tr["batch"]
        lo = (c % (self.tr["requests"] // b)) * b
        return lo, lo + b
