"""IVF's sparse pipeline replayed as CUDA graphs (`ops/ivf_sparse.PipelineGraphs`).

The CPU tests hold the cache's policy with a stand-in for the capture: a
"graph" that reruns the pipeline on its static inputs and writes its
static outputs in place, the launch counters left as a replay leaves
them. K3's gate is opened on the CPU (`sp.use_plain` false, K3's launch
routed to its plain version with its counter), so the whole path runs
here: first use eager, capture on the second, the key, the size bound,
the cache dropped with the layout, the copies of the outputs, the
launch counters and `ivf_graph_rows`.

The card tests (marked `cuda`, skipped without a card) hold the real
replay array-equal to the eager pipeline: several calls through one graph,
a ragged batch, a filter, an overflow rescan, a rebuilt layout,
`search_stream(depth=2)` and the launch counters. On the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ivf_graph.py -q
"""

import numpy as np
import pytest
import torch

from comet_tpu_torch import DistanceKind, IVFIndex
from comet_tpu_torch.indexes import ivf as ivf_mod
from comet_tpu_torch.ops import edge_cases, sortnet
from comet_tpu_torch.ops import ivf_sparse as sp
from comet_tpu_torch.utils import profiling

D, NLIST, N = 16, 12, 3000


class StandIn:
    """`sp._capture`'s stand-in: a capture runs the pipeline once (the
    wrapper then takes its launches back off the counters, as after a
    real capture), a replay reruns it into the captured outputs and leaves
    the counters as they were, since a real replay runs no Python."""

    def __init__(self):
        self.captures = 0
        self.replays = 0

    def __call__(self, run):
        self.captures += 1
        stand_in = self

        class Graph:
            def replay(self):
                stand_in.replays += 1
                before = sp._launch_counts()
                for out, new in zip(outs, run()):
                    out.copy_(new)
                sp._add_launches(tuple(a - b for a, b in zip(before, sp._launch_counts())))

        outs = run()
        return Graph(), outs


@pytest.fixture
def card_gate(monkeypatch):
    """The wrapper and K3 take the card's path on CPU tensors: the capture
    is the stand-in, K3's launch its plain version with its counter."""
    stand_in = StandIn()

    def k3(*a, **kw):
        with sp._build.COUNT_LOCK:
            sp.LAUNCHES += 1
        return sp._compact_scan_plain(*a, **kw)

    monkeypatch.setattr(sp, "use_plain", lambda t: False)
    monkeypatch.setattr(sp, "_compact_scan_cuda", k3)
    monkeypatch.setattr(sp, "_capture", stand_in)
    return stand_in


def _args(layout="dead steps", dev=torch.device("cpu")):
    c = edge_cases.k3_route_case(layout, D)
    return c, edge_cases.k3_route_args(dev, c, False)


def _call(fn, args, q=None, mask=None, **kw):
    a = list(args)
    if q is not None:
        a[0] = q
    if mask is not None:
        a[2] = mask
    return fn(*a, sqrt_out=True, **kw)


def _equal(got, want):
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _shifted(q, n):
    """Other queries of the same shape: the rows rolled and nudged."""
    return torch.roll(q, n, dims=0) + float(n % 3)


# -- the cache's policy, on the CPU ---------------------------------------------------


def test_first_use_is_eager_and_the_second_captures(card_gate):
    _, args = _args()
    graphs = sp.PipelineGraphs()
    for n in range(4):
        q = _shifted(args[0], n)
        got = _call(graphs, args, q)
        assert (card_gate.captures, card_gate.replays, len(graphs)) == \
            ((0, 0, 0) if n == 0 else (1, n, 1))
        _equal(got, _call(sp.ivf_sparse_pipeline, args, q))


def test_a_ragged_batch_pads_like_the_eager_pipeline(card_gate):
    """200 and 256 queries share one graph (256 padded); the padding rows
    are zero again after a full batch. At a budget the groups overflow, so
    the padding's probes show in the overflow counts."""
    _, args = _args("overflow")
    graphs = sp.PipelineGraphs()
    part, full = args[0][:200], args[0]
    for q in (part, full, part, full, part):
        _equal(_call(graphs, args, q), _call(sp.ivf_sparse_pipeline, args, q))
    assert (card_gate.captures, len(graphs)) == (1, 1)


def test_the_mask_is_copied_in_every_call(card_gate):
    _, args = _args("filter")
    graphs = sp.PipelineGraphs()
    other = args[2].clone()
    other[::5] = float("inf")
    for mask in (args[2], args[2], other, args[2]):
        _equal(_call(graphs, args, mask=mask), _call(sp.ivf_sparse_pipeline, args, mask=mask))
    assert card_gate.captures == 1


KEY_FIELDS = ("q_pad", "d", "k", "nprobe", "S", "UC", "MC", "nlist", "threshold",
              "coarse_cosine", "cosine", "sqrt_out", "envelope", "corpus", "row_slot",
              "centroids", "order_key", "chunk_start", "nchunks")


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_every_key_field_separates_graphs(card_gate, field, monkeypatch):
    """A change of any one thing a capture bakes in takes a graph of its
    own, captured on its own second use; the first graph stays."""
    _, args = _args()
    args = list(args)
    kw = dict(coarse_cosine=False, cosine=False)
    graphs = sp.PipelineGraphs()
    for _ in range(2):
        _call(graphs, args, **kw)
    pos = {"k": 9, "nprobe": 10, "S": 11, "UC": 12, "MC": 13, "nlist": 14, "threshold": 4,
           "corpus": 1, "row_slot": 3, "centroids": 5, "order_key": 6, "chunk_start": 7,
           "nchunks": 8}
    if field == "q_pad":
        args[0] = torch.cat([args[0], args[0]])
    elif field == "d":     # the key alone: a wider query has no corpus to meet here
        a = list(args)
        a[0] = args[0][:, :-1]
        assert graphs.key(*a, **kw, sqrt_out=True) != graphs.key(*args, **kw, sqrt_out=True)
        return
    elif field in ("coarse_cosine", "cosine"):
        kw[field] = True
    elif field == "sqrt_out":
        assert graphs.key(*args, **kw, sqrt_out=False) != graphs.key(*args, **kw, sqrt_out=True)
        return
    elif field == "envelope":
        monkeypatch.setenv("COMET_SPARSE_MEM_GB", "1")
    elif field == "threshold":
        args[4] = 1.0e6
    elif field in ("k", "S", "UC"):
        args[pos[field]] = args[pos[field]] // 2
    elif field in ("nprobe", "MC"):
        args[pos[field]] = args[pos[field]] + 1
    elif field == "nlist":
        assert graphs.key(*args, **kw, sqrt_out=True) != graphs.key(
            *args[:14], args[14] + 1, **kw, sqrt_out=True)
        return
    else:   # a layout tensor: the same values at another address
        args[pos[field]] = args[pos[field]].clone()
    for n in range(3):
        _call(graphs, args, **kw)
        assert len(graphs) == (1 if n == 0 else 2)
    assert card_gate.captures == 2


def test_the_cache_holds_at_most_graphs_max(card_gate):
    _, args = _args()
    graphs = sp.PipelineGraphs()
    ks = [8 * (n + 1) for n in range(sp.GRAPHS_MAX + 2)]
    for k in ks:
        a = list(args)
        a[9] = k
        for _ in range(3):
            _call(graphs, a)
        assert len(graphs) <= sp.GRAPHS_MAX
    assert card_gate.captures == len(ks) and len(graphs) == sp.GRAPHS_MAX
    kept = {key[2] for key in graphs._graphs}
    assert kept == set(ks[-sp.GRAPHS_MAX:])


def test_a_cpu_tensor_never_captures(monkeypatch):
    stand_in = StandIn()
    monkeypatch.setattr(sp, "_capture", stand_in)
    _, args = _args()
    graphs = sp.PipelineGraphs()
    for _ in range(3):
        _equal(_call(graphs, args), _call(sp.ivf_sparse_pipeline, args))
    assert stand_in.captures == 0 and len(graphs) == 0


def test_a_replay_counts_the_launches_its_capture_made(card_gate):
    _, args = _args()
    graphs = sp.PipelineGraphs()
    deltas = []
    for fn in (sp.ivf_sparse_pipeline, graphs, graphs, graphs, graphs):
        before = sp._launch_counts()
        _call(fn, args)
        deltas.append(tuple(b - a for a, b in zip(before, sp._launch_counts())))
    assert deltas[0][0] == 1 and len(set(deltas)) == 1


def test_threads_sharing_one_cache_each_get_their_own_results(card_gate):
    """Eight threads call one cache at once, with short switch intervals:
    each call's outputs are its own queries' (the replay's copy in,
    replay and copy out run as one step under the cache's lock)."""
    import sys
    import threading

    _, args = _args()
    graphs = sp.PipelineGraphs()
    qs = [_shifted(args[0], n) for n in range(8)]
    want = [_call(sp.ivf_sparse_pipeline, args, q) for q in qs]
    _call(graphs, args)
    errors = []

    def work(n):
        try:
            for _ in range(3):
                _equal(_call(graphs, args, qs[n]), want[n])
        except AssertionError as exc:     # a lost or mixed replay
            errors.append((n, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(n,)) for n in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert card_gate.captures == 1 and card_gate.replays == 24


def _index(x, monkeypatch, device="cpu", nlist=NLIST):
    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    idx = IVFIndex(D, nlist, DistanceKind.L2, device=device)
    cents = x[np.linspace(0, len(x) - 1, nlist).astype(int)]
    idx._set_centroids(np.ascontiguousarray(cents))
    idx.add_batch(x, ids=range(1, len(x) + 1))
    return idx


def _corpus(seed=0):
    g = np.random.default_rng(seed)
    return (g.integers(0, 64, size=(N, D)).astype(np.float32),
            g.integers(0, 64, size=(300, D)).astype(np.float32))


def test_a_rebuilt_layout_drops_its_graphs(card_gate, monkeypatch):
    x, q = _corpus()
    idx = _index(x, monkeypatch)
    for _ in range(3):
        idx.search_batch(q, k=10, nprobes=3)
    old = idx._sparse["graphs"]
    assert len(old) == 1
    idx.add_batch(x[:5] + 1.0, ids=range(N + 1, N + 6))
    got = idx.search_batch(q, k=10, nprobes=3)
    assert idx._sparse["graphs"] is not old and len(idx._sparse["graphs"]) == 0
    monkeypatch.setattr(sp, "use_plain", lambda t: True)   # the eager pipeline throughout
    want = idx.search_batch(q, k=10, nprobes=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_search_stream_keeps_each_pending_output(card_gate, monkeypatch):
    """depth 2 holds a launch's outputs while the next one replays: each
    batch's result equals its own search_batch."""
    x, q = _corpus()
    idx = _index(x, monkeypatch)
    batches = [q[:100], q[100:200], q[200:], q[:100] + 2.0]
    got = list(idx.search_stream(batches, k=10, nprobes=3, depth=2))
    assert card_gate.replays >= 2
    monkeypatch.setattr(sp, "use_plain", lambda t: True)
    for b, (ids, scores) in zip(batches, got):
        want = idx.search_batch(b, k=10, nprobes=3)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(scores, want[1])


def test_ivf_graph_rows_counts_the_queries_a_replay_served(card_gate, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    x, q = _corpus()
    idx = _index(x, monkeypatch)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for n in (300, 300, 260, 300):     # 260 pads to 300's 384
            idx.search_batch(q[:n], k=10, nprobes=3)
    served = [sum(r.counters.get("ivf_graph_rows", 0) for r in recs if r.counters)
              for recs in profiling.requests().values()]
    assert served == [0, 300, 260, 300]
    assert profiling.per_query("ivf_graph_rows") == pytest.approx(860 / 1160)


def test_graph_share_reads_the_replayed_share(card_gate, monkeypatch):
    """The benchmark's `graph_share` reader: the replayed queries over the
    queries served, in %; None with no trace, and None where no span
    counted `ivf_graph_rows` (a program without the graphs)."""
    import importlib.util
    import os
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cardbench", "metrics", "graph_share.py")
    spec = importlib.util.spec_from_file_location("graph_share", path)
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    x, q = _corpus()
    idx = _index(x, monkeypatch)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(4):
            idx.search_batch(q, k=10, nprobes=3)
    assert metric.read(SimpleNamespace(trace={"busy_s": 0.0})) == pytest.approx(75.0)
    assert metric.read(SimpleNamespace(trace=None)) is None
    monkeypatch.setattr(sp, "use_plain", lambda t: True)    # the CPU path counts nothing
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        idx.search_batch(q, k=10, nprobes=3)
    assert metric.read(SimpleNamespace(trace={"busy_s": 0.0})) is None


# -- the real replay, on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ("dead steps", "overflow", "empty probes", "threshold",
                                    "filter", "narrow", "ragged", "ties"))
@pytest.mark.parametrize("d", (20, 128))
def test_replays_equal_the_eager_pipeline(dev, layout, d):
    """Four calls of other queries through one graph, each array-equal to
    the eager pipeline (scores, slots, overflow), and each replay's
    launches those of an eager call."""
    c = edge_cases.k3_route_case(layout, d)
    args = edge_cases.k3_route_args(dev, c, False)
    graphs = sp.PipelineGraphs()
    for n in range(5):
        q = _shifted(args[0], n)
        before = sp._launch_counts()
        got = _call(graphs, args, q)
        torch.cuda.synchronize()
        launched = tuple(b - a for a, b in zip(before, sp._launch_counts()))
        before = sp._launch_counts()
        want = _call(sp.ivf_sparse_pipeline, args, q)
        assert launched == tuple(b - a for a, b in zip(before, sp._launch_counts()))
        _equal(got, want)
    assert len(graphs) == 1


def _card_pair(monkeypatch, seed=3, nlist=NLIST):
    """Two CUDA indexes over the same data and centroids: one replays
    graphs, the other calls the eager pipeline."""
    x, q = _corpus(seed)
    a, b = _index(x, monkeypatch, "cuda", nlist), _index(x, monkeypatch, "cuda", nlist)
    b._device_sparse()["graphs"] = sp.ivf_sparse_pipeline
    return a, b, q


def _same(a, b, *args, **kw):
    got, want = a.search_batch(*args, **kw), b.search_batch(*args, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
def test_a_filtered_search_replays_through_the_same_graph(dev, monkeypatch):
    a, b, q = _card_pair(monkeypatch)
    for ids in (None, None, range(1, N, 3), range(2, N, 2), None):
        _same(a, b, q, k=20, nprobes=4, document_ids=ids)
    assert len(a._sparse["graphs"]) == 1


@pytest.mark.cuda
def test_an_overflow_rescan_replays_at_the_learned_budget(dev, monkeypatch):
    """A budget of 2 steps overflows and the rescan learns a larger one;
    the next call (the larger budget's second) captures it. 60 lists of
    50 rows (a chunk each), each query near one of eight list centres at
    nprobe 1: the learned budget stays below half the table, so the shape
    keeps the sparse route."""
    a, b, _ = _card_pair(monkeypatch, nlist=60)
    cents = a._centroids[:8]
    q = cents[np.arange(256) % 8] + np.random.default_rng(5).integers(-2, 3, size=(256, D))
    monkeypatch.setattr(ivf_mod.sp, "default_budgets", lambda nprobe, nlist, total, mc: (2, 2, mc))
    for n in range(4):
        _same(a, b, q.astype(np.float32), k=8, nprobes=1)
    assert a.stats()["sparse_overflow_batches"] == 1
    S = a._sparse_S_hint[(1, 8)]
    assert S > 4 and [key[4] for key in a._sparse["graphs"]._graphs] == [S]


@pytest.mark.cuda
def test_a_rebuilt_layout_replays_new_graphs(dev, monkeypatch):
    a, b, q = _card_pair(monkeypatch)
    for _ in range(3):
        _same(a, b, q, k=10, nprobes=3)
    old = a._sparse["graphs"]
    for idx in (a, b):
        idx.remove(7)
        idx.add_batch(q[:4], ids=range(N + 1, N + 5))
    b._device_sparse()["graphs"] = sp.ivf_sparse_pipeline
    for _ in range(3):
        _same(a, b, q, k=10, nprobes=3)
    assert a._sparse["graphs"] is not old and len(a._sparse["graphs"]) == 1


@pytest.mark.cuda
def test_search_stream_outputs_survive_later_replays(dev, monkeypatch):
    a, b, q = _card_pair(monkeypatch)
    batches = [q[:128], q[128:256], q[:128] + 1.0, q[128:256] + 2.0, q[:128] + 3.0]
    got = list(a.search_stream(batches, k=10, nprobes=3, depth=2))
    assert len(a._sparse["graphs"]) == 1
    for batch, (ids, scores) in zip(batches, got):
        want = b.search_batch(batch, k=10, nprobes=3)
        np.testing.assert_array_equal(ids, want[0])
        np.testing.assert_array_equal(scores, want[1])


@pytest.mark.cuda
def test_replays_count_the_eager_launches(dev, monkeypatch):
    a, b, q = _card_pair(monkeypatch)
    counts = {}
    for name, idx in (("eager", b), ("graph", a), ("graph", a), ("graph", a)):
        before = sp._launch_counts()
        idx.search_batch(q, k=100, nprobes=6)
        counts.setdefault(name, set()).add(
            tuple(y - x for x, y in zip(before, sp._launch_counts())))
    assert counts["graph"] == counts["eager"] and len(counts["eager"]) == 1
    assert next(iter(counts["eager"]))[0] == 1
    assert sortnet.LAUNCHES > 0
