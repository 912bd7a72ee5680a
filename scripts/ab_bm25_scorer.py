"""Time the BM25 scorer (csrc/bm25_score.cu) of several source trees in one
process, in alternating turns, at chip_smoke.py's shapes.

    python3 scripts/ab_bm25_scorer.py [--sweep] TREE [TREE ...]

Each TREE is the root of a checkout of this repository (the parent's,
unpacked with `git archive`, or `.`). Its own `comet_tpu_torch/ops/_build.py`
builds its `csrc` into its own `build/kernels` (all trees at once) and
loads the library with its own C signatures; a scorer entry point that
takes a tile and a query group gets `ops/bm25.tile_shape`'s. The inputs
come from this checkout's package: chip_smoke.py's BM25 corpus (2^20
documents of seed 0) with 256-query chunks of 1-, 2- and 10-term queries,
the 1-term chunk with every query emptied (the rows alone), and one
2-term query over BM25 indexes of the corpus's first 70,000 and
330,000 documents (the sizes of the smallest and the largest segment of
chip_smoke's store phase). At each shape every library's dense rows are
held bit-equal (int32 views) to `_bm25_dense_plain`, then timed in TURNS
turns, the libraries' order reversed every other turn: the median
CUDA-event ms of 5 launches (the host's launch included) and
torch.profiler's device time a launch (mean over a 0.5 s window), beside `zero_` of a
tensor of the rows' shape, a write-only yardstick. `--sweep` then times
the last tree's kernel, held bit-equal, at other tiles and query groups.
Prints each shape's bound as chip_smoke.py counts it. Needs one NVIDIA
card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from comet_tpu_torch import BM25SearchIndex  # noqa: E402
from comet_tpu_torch.ops import bm25  # noqa: E402

TURNS = 2
SEGMENT_DOCS = (70_000, 330_000)
SMEM_MAX = 200 * 1024      # csrc/scan_tile.cuh smem_attr's limit
SMEM_FIXED = 16640         # the kernel's per-window entry arrays


def libraries(trees):
    """Build every tree's kernels at once, then load each tree's library
    through its own `_build` module."""
    procs = [subprocess.Popen([sys.executable, "-c",
                               "from comet_tpu_torch.ops import _build; _build.library()"],
                              cwd=t) for t in trees]
    if any(p.wait() != 0 for p in procs):
        raise RuntimeError("a kernel build failed")
    libs = {}
    for i, t in enumerate(trees):
        spec = importlib.util.spec_from_file_location(
            f"_build_tree{i}", os.path.join(t, "comet_tpu_torch", "ops", "_build.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        libs[t] = mod.library().comet_bm25_score
    return libs


def launch(fn, a, q_off_dev, shape=None):
    """One scorer launch of library entry `fn` on inputs `a`: its rows. An
    entry of 15 arguments takes a tile and a query group; one of 13 (one
    block a query) neither."""
    rows, n = q_off_dev.shape[0] - 1, a["doc_len"].shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=q_off_dev.device)
    args = [a["post_slot"].data_ptr(), a["post_tf"].data_ptr(), a["t_start"].data_ptr(),
            a["t_len"].data_ptr(), a["t_idf"].data_ptr(), q_off_dev.data_ptr(), rows,
            a["doc_len"].data_ptr(), a["allowed"].data_ptr(), n, a["avgdl"]]
    if len(fn.argtypes) == 15:
        args += list(shape or bm25.tile_shape(rows, n, bm25._sm_count(0)))
    code = fn(*args, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"bm25_score: CUDA launch failed with error {code}")
    return out


def shape_bound(a):
    """chip_smoke.py's bound: each distinct posting, length and mask byte
    read once, the rows written once; 9 operations a posting."""
    n, rows = a["doc_len"].shape[0], len(a["q_off"]) - 1
    terms = slice(int(a["q_off"][0]), int(a["q_off"][-1]))
    starts, lens = a["t_start"][terms].tolist(), a["t_len"][terms].tolist()
    runs = set(zip(starts, lens))
    postings = sum(lens)
    return cs.bound(8 * sum(c for _, c in runs) + 5 * n + 4 * rows * n, 9 * postings), postings


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_bm25_scorer: torch.cuda.is_available() is False; this needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]
    tag = f"[{card}]"
    dev = torch.device("cuda")
    trees = [os.path.abspath(t) for t in args.trees]
    t0 = time.perf_counter()
    libs = libraries(trees)
    print(f"card: {card}; libraries of {len(trees)} trees built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    texts, qterms = cs.bm25_corpus(0)
    shapes = {}
    index = BM25SearchIndex(device="cuda")
    index.add_batch(range(1, cs.BM25_N + 1), texts)
    for n_terms in cs.BM25_TERMS:
        queries = cs.bm25_queries(qterms, n_terms)[:cs.BM25_CHUNK]
        shapes[f"256 {n_terms}-term queries over {cs.BM25_N} documents"] = \
            cs.bm25_chunk_inputs(index, queries, dev)
    # the rows alone: the 1-term chunk's inputs with every query empty
    empty = dict(shapes[f"256 1-term queries over {cs.BM25_N} documents"])
    empty["q_off"] = np.zeros(cs.BM25_CHUNK + 1, np.int64)
    shapes[f"256 queries without terms over {cs.BM25_N} documents"] = empty
    query = cs.bm25_queries(qterms, 2, count=cs.STORE_QUERIES)[0]
    for n_docs in SEGMENT_DOCS:
        seg = BM25SearchIndex(device="cuda")
        seg.add_batch(range(1, n_docs + 1), texts[:n_docs])
        shapes[f"one 2-term query over {n_docs} documents"] = cs.bm25_chunk_inputs(
            seg, [query], dev)
    del texts
    print(f"inputs ready in {time.perf_counter() - t0:.1f} s", flush=True)

    for what, a in shapes.items():
        q_off_dev = torch.from_numpy(a["q_off"].astype(np.int32)).to(dev)
        plain_args = {k: v for k, v in a.items() if k != "q_off"}
        want = bm25._bm25_dense_plain(**plain_args, q_off=a["q_off"]).view(torch.int32)
        for t, fn in libs.items():
            if not torch.equal(launch(fn, a, q_off_dev).view(torch.int32), want):
                raise AssertionError(f"{t}: the scorer's rows differ from the plain rows ({what})")
        del want
        (b_ms, b_by), postings = shape_bound(a)
        times = {t: [] for t in libs}
        for turn in range(TURNS):
            order = list(libs) if turn % 2 == 0 else list(libs)[::-1]
            for t in order:
                fn = libs[t]
                ms = cs_time_ms(lambda: launch(fn, a, q_off_dev))
                us = cs.device_us(lambda: launch(fn, a, q_off_dev), ("bm25_score",))[0]
                times[t].append(f"{ms:.4f} ms / {us:.1f} us")
        rows, n = len(a["q_off"]) - 1, a["doc_len"].shape[0]
        print(f"{what} ({postings} postings; tile, group {bm25.tile_shape(rows, n, bm25._sm_count(0))}"
              f"; bound {b_ms:.4f} ms, {b_by}); rows bit-equal to plain in every tree; CUDA-event "
              f"ms / device us a launch, turns in order:", flush=True)
        for t, v in times.items():
            print(f"  {t}: {', '.join(v)} {tag}")
        rows_out = torch.empty((rows, n), dtype=torch.float32, device=dev)
        print(f"  the rows' {4 * rows * n} bytes written by Tensor.zero_ (a write-only "
              f"yardstick): {cs_time_ms(rows_out.zero_):.4f} ms {tag}")
        del rows_out
        torch.cuda.empty_cache()

    if args.sweep:
        fn = libs[trees[-1]]
        for what, a in shapes.items():
            q_off_dev = torch.from_numpy(a["q_off"].astype(np.int32)).to(dev)
            plain_args = {k: v for k, v in a.items() if k != "q_off"}
            want = bm25._bm25_dense_plain(**plain_args, q_off=a["q_off"]).view(torch.int32)
            rows = len(a["q_off"]) - 1
            groups = (1,) if rows == 1 else (4, 8, 16, 32)
            res = []
            for tile in (128, 256, 512, 1024, 2048):
                for group in groups:
                    if SMEM_FIXED + 4 * group * tile + 5 * tile > SMEM_MAX:
                        continue
                    got = launch(fn, a, q_off_dev, (tile, group)).view(torch.int32)
                    if not torch.equal(got, want):
                        raise AssertionError(f"tile {tile}, group {group}: rows differ ({what})")
                    del got
                    ms = cs_time_ms(lambda: launch(fn, a, q_off_dev, (tile, group)))
                    res.append(f"({tile}, {group}) {ms:.4f}")
            print(f"sweep, {what}, (tile, group) CUDA-event ms: {', '.join(res)} {tag}",
                  flush=True)
            del want
            torch.cuda.empty_cache()


def cs_time_ms(fn, reps=5):
    """chip_smoke.py's timing: the median CUDA-event ms of `reps` calls
    after one warm call."""
    fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


if __name__ == "__main__":
    main()
