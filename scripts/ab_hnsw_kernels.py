"""Time HNSW search over one index with the kernel libraries of several
source trees, in one process, in alternating turns.

    python3 scripts/ab_hnsw_kernels.py [--kernels-only] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (the parent's,
unpacked with `git archive`, or `.`); its `comet_tpu_torch/csrc` is built
into its own `build/kernels`, all trees at once. The Python package is this
checkout's in every turn: only the kernel library changes, so a difference
between libraries is the kernels' and their launches', not the host code's.

First, for each library in two turns (the order reversed in the second),
chip_smoke.py's `beam_section`: K4, K5 and the scoring kernel (packed and
blocked) on its running search's state over the 1M x 128 corpus, held to
their plain versions, timed, with their torch.profiler device times a
launch. `--kernels-only` stops there.

Then builds chip_smoke.py's 1M x 128 graph (seed 0, M = 16), then for the
classic start (COMET_HNSW_SEED=0) and the seeded one: a warm batch a
library, then TURNS turns of 4 steady 2048-query batches a library, the
order of the libraries reversed every other turn, ids and scores held
array-equal across libraries; then one torch.profiler window of 2 batches
a library. Prints the queries/s of every turn, their median, and each
window's device activity, wall time and the scoring kernel's device time
a launch. Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from comet_tpu_torch import DistanceKind, HNSWIndex  # noqa: E402
from comet_tpu_torch.ops import _build  # noqa: E402

TURNS = 10
BATCHES = 4


def libraries(trees):
    """Build every tree's kernels at once, then load each library."""
    procs = [subprocess.Popen([sys.executable, "-c",
                               "from comet_tpu_torch.ops import _build; _build.library()"],
                              cwd=t) for t in trees]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a kernel build failed")
    libs = {}
    for t in trees:
        _build.CSRC_DIR = os.path.join(t, "comet_tpu_torch", "csrc")
        _build.BUILD_DIR = os.path.join(t, "build", "kernels")
        libs[t] = _build._build()
    return libs


def time_ms(fn, reps=5):
    """Median CUDA-event time of `fn`, in ms, after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def window(index, queries):
    """Device activity, wall time (ms) and the scoring kernel's mean device
    time a launch (us) over two batches under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            index.search_batch(queries, k=cs.K, ef_search=cs.EF_SEARCH)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = cs.kernel_rows(prof)
    score = [(us, count) for us, count, name in rows if "gather_score" in name]
    n = sum(c for _, c in score)
    return (sum(r[0] for r in rows) / 1e3, wall, sum(us for us, _ in score) / max(n, 1), n)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--kernels-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_hnsw_kernels: torch.cuda.is_available() is False; this needs an NVIDIA card")
    trees = [os.path.abspath(t) for t in args.trees]
    libs = libraries(trees)
    rng = np.random.default_rng(0)
    corpus, queries, _ = cs.sift_like(rng, cs.N, cs.BATCH, cs.DIM)
    x_dev = torch.from_numpy(corpus).cuda()
    for turn in range(2):
        for t in (trees if turn == 0 else trees[::-1]):
            _build._lib = libs[t]
            cs.beam_section(x_dev, queries, 0, x_dev.device, f"[{os.path.relpath(t, ROOT)}]",
                            time_ms)
    del x_dev
    torch.cuda.empty_cache()
    if args.kernels_only:
        return
    _build._lib = libs[trees[-1]]
    index = HNSWIndex(cs.DIM, DistanceKind.L2, device="cuda")
    index.add_batch(corpus, ids=np.arange(1, cs.N + 1, dtype=np.uint32))
    torch.cuda.synchronize()
    for mode, seed in (("classic", "0"), ("seeded", None)):
        if seed is None:
            os.environ.pop("COMET_HNSW_SEED", None)
        else:
            os.environ["COMET_HNSW_SEED"] = seed
        want = None
        for t in trees:
            _build._lib = libs[t]
            got = index.search_batch(queries, k=cs.K, ef_search=cs.EF_SEARCH)
            want = want or got
            if not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
                raise AssertionError(f"{mode}: {t}'s kernels give other ids or scores")
        qps = {t: [] for t in trees}
        for turn in range(TURNS):
            for t in (trees if turn % 2 == 0 else trees[::-1]):
                _build._lib = libs[t]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(BATCHES):
                    got = index.search_batch(queries, k=cs.K, ef_search=cs.EF_SEARCH)
                qps[t].append(BATCHES * cs.BATCH / (time.perf_counter() - t0))
                if not np.array_equal(got[0], want[0]):
                    raise AssertionError(f"{mode}: {t}'s kernels give other ids")
        for t in trees:
            _build._lib = libs[t]
            busy, wall, score, n = window(index, queries)
            print(f"{mode} {os.path.relpath(t, ROOT)}: queries/s median "
                  f"{statistics.median(qps[t]):.1f} of {' '.join(f'{v:.1f}' for v in qps[t])}; "
                  f"profiled 2 batches: {busy:.3f} ms device activity in {wall:.3f} ms, scoring "
                  f"{n} x {score:.3f} us")


if __name__ == "__main__":
    main()
