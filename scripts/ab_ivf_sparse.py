"""Time the block-sparse IVF pipeline (ops/ivf_sparse.py and its kernel K3)
of two source trees in one process, in alternating turns, where the port's
indexes call it.

    python3 scripts/ab_ivf_sparse.py OTHER_TREE [OTHER_TREE ...]

Each OTHER_TREE is the root of another checkout of this repository (the
parent, unpacked with `git archive`, or a copy with a variant of the
kernel). Its `comet_tpu_torch/ops/ivf_sparse.py` is loaded beside this
checkout's and bound to a kernel library built from its own
`comet_tpu_torch/csrc` into its own `build/kernels`; every other module is
this checkout's. A turn sets `ivf_sparse.ivf_sparse_pipeline` to one
tree's, so the indexes, their data and every other kernel are shared.

On chip_smoke.py's 1M x 128 mixture and its 2048-query batch, three
searches: HNSW's seeded search (k 100, ef 200: the seed scan, a shortlist
by default), IVFPQ nlist 1024 m 16 on the sparse route at nprobe 10 with
nrefine 256 (a shortlist) and IVF nlist 1024 at nprobe 10 (the exact
search), k 100. For each: the outputs held array-equal across the trees;
TURNS turns of BATCHES batches a tree, the order reversed every other
turn, queries/s each; the search's pipeline call captured and its device
time a call (calls queued behind a sleep, CUDA events) in REPS turns a
tree; one torch.profiler window a tree: its kernels' device time a call
and the longest of them; and the call's scan shape (member (query, chunk)
pairs, the chunks they fall in, the 32-member slabs K3 computes, the most
members of a chunk). Needs one NVIDIA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from comet_tpu_torch import DistanceKind, HNSWIndex, IVFIndex, IVFPQIndex  # noqa: E402
from comet_tpu_torch.ops import ivf_sparse as sp  # noqa: E402

TURNS = 10
BATCHES = 4
REPS = 3


def load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def other_pipeline(tree: str, n: int):
    """OTHER_TREE's `ivf_sparse_pipeline`, its module bound to that tree's
    kernel library."""
    ops = os.path.join(tree, "comet_tpu_torch", "ops")
    build = load(os.path.join(ops, "_build.py"), f"other_build_{n}")
    mod = load(os.path.join(ops, "ivf_sparse.py"), f"other_ivf_sparse_{n}")
    mod._build = build
    build.library()
    return mod.ivf_sparse_pipeline


def compare(name, search, pipes):
    """Outputs equal across the trees, queries/s in turns, the captured
    pipeline call's device time in turns and its kernels' in a profiler
    window; one line a tree."""
    outs = {}
    for t, fn in pipes.items():
        sp.ivf_sparse_pipeline = fn
        search()
        outs[t] = search()
        torch.cuda.synchronize()
    ref = next(iter(outs.values()))
    for t, got in outs.items():
        if not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, ref)):
            raise AssertionError(f"{name}: {t} gives other outputs")
    qps = {t: [] for t in pipes}
    for turn in range(TURNS):
        for t in (list(pipes) if turn % 2 == 0 else list(pipes)[::-1]):
            sp.ivf_sparse_pipeline = pipes[t]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BATCHES):
                search()
            torch.cuda.synchronize()
            qps[t].append(BATCHES * cs.BATCH / (time.perf_counter() - t0))
    calls = []
    first = next(iter(pipes.values()))

    def capture(*a, **kw):
        calls.append((a, kw))
        return first(*a, **kw)

    sp.ivf_sparse_pipeline = capture
    search()
    if not calls:
        raise AssertionError(f"{name}: the search made no sparse pipeline call")
    a, kw = calls[-1]
    dev_ms = {t: [] for t in pipes}
    for turn in range(REPS):
        for t in (list(pipes) if turn % 2 == 0 else list(pipes)[::-1]):
            dev_ms[t].append(cs.queued_device_ms(lambda: pipes[t](*a, **kw), reps=10))
    sp.ivf_sparse_pipeline = pipes["this tree"]
    print(f"{name}: {scan_shape(a, kw)}")
    for t, fn_t in pipes.items():
        rows = cs.profiled_rows([lambda: fn_t(*a, **kw)])
        n = sum(count for _, count, key in rows if "scan_kernel" in key)
        top = sorted(rows, reverse=True)[:5]
        print(f"{name}, {t}: queries/s median {statistics.median(qps[t]):.1f} of "
              f"{' '.join(f'{v:.1f}' for v in qps[t])}; its pipeline call (k={kw.get('k')}, "
              f"nprobe {kw.get('nprobe')}, kb_cap {kw.get('kb_cap', 0)}, {len(calls)} a batch) "
              f"device {' '.join(f'{v:.3f}' for v in dev_ms[t])} ms a call, its kernels "
              f"{sum(r[0] for r in rows) / max(n, 1) / 1e3:.3f} ms a call, the longest "
              + ", ".join(f"{key[:48]} {us / max(n, 1):.1f} us" for us, _, key in top))
    sys.stdout.flush()


def scan_shape(a, kw):
    """The captured call's scan, from its plan (one slice): member (query,
    chunk) pairs, the chunks with a member, K3's 32-member slabs (each
    chunk's members over its groups, SP_LIST = 256 listed at most before
    a pass) and the most members of one chunk."""
    q = a[0]
    pad = -(-q.shape[0] // sp.QG) * sp.QG - q.shape[0]
    q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    plan = sp.scan_plan(q, a[5], a[6], a[7], a[8], kw["k"], kw["nprobe"], kw["S"], kw["UC"],
                        kw["MC"], kw["nlist"], False, kw.get("kb_cap", 0))
    g_n, s_n = plan["chunk_ids"].shape
    member = (plan["probes"][:, :kw["nprobe"]].view(g_n, sp.QG, -1, 1)
              == plan["cluster_ids"].view(g_n, 1, 1, s_n)).any(dim=2).sum(dim=1)   # [G, S]
    per_chunk = torch.zeros(int(a[7][-1]), dtype=torch.int64, device=q.device)
    per_chunk.index_add_(0, plan["chunk_ids"].long().flatten(), member.flatten())
    live = per_chunk[per_chunk > 0]
    slabs = int((-(-live // 32)).sum())
    return (f"{int(live.sum())} member pairs in {live.numel()} chunks, ~{slabs} slabs of 32, "
            f"at most {int(live.max())} members a chunk, median {int(live.median())}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("others", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_ivf_sparse: torch.cuda.is_available() is False; this needs an NVIDIA card")
    pipes = {os.path.relpath(os.path.abspath(t), ROOT): other_pipeline(os.path.abspath(t), n)
             for n, t in enumerate(args.others)}
    pipes["this tree"] = sp.ivf_sparse_pipeline
    rng = np.random.default_rng(0)
    corpus, queries, _ = cs.sift_like(rng, cs.N, cs.BATCH, cs.DIM)
    ids = np.arange(1, cs.N + 1, dtype=np.uint32)

    hnsw = HNSWIndex(cs.DIM, DistanceKind.L2, device="cuda")
    hnsw.add_batch(corpus, ids=ids)
    compare("HNSW seeded k=100 ef=200", lambda: hnsw.search_batch(
        queries, k=cs.K, ef_search=cs.EF_SEARCH), pipes)
    del hnsw
    torch.cuda.empty_cache()

    pq = IVFPQIndex(cs.DIM, DistanceKind.L2, nlist=cs.NLIST, m=cs.PQ_M, nbits=cs.PQ_NBITS,
                    store_originals=True, device="cuda")
    pq.train(corpus[:cs.N_TRAIN])
    pq.add_batch(corpus, ids=ids)
    compare("IVFPQ sparse route nprobe 10 nrefine 256 k=100", lambda: pq.search_batch(
        queries, k=cs.K, nprobes=10, nrefine=256), pipes)
    del pq
    torch.cuda.empty_cache()

    ivf = IVFIndex(cs.DIM, cs.NLIST, DistanceKind.L2, device="cuda")
    ivf.train(corpus[:cs.N_TRAIN])
    ivf.add_batch(corpus, ids=ids)
    compare("IVF nprobe 10 k=100 (exact)", lambda: ivf.search_batch(
        queries, k=cs.K, nprobes=10), pipes)


if __name__ == "__main__":
    main()
