"""comet_tpu_torch.utils.profiling's spans inside the search paths.

With no profiler recording, a span is one check: nothing is recorded and
no `record_function` range opens. Under torch.profiler every search
records its span tree (one request a call from outside, every step inside
its parent, every name under "layer."), the profiler's events carry the
same names, and results are the same as with spans off. The summary
arithmetic is held on hand-made records, and a tiny traced run of each
benchmark cell (cardbench/, imported as its own tests import it) reports
the per-layer metrics that read the spans.
"""

import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import comet_tpu_torch as ct
from comet_tpu_torch.utils import profiling
from comet_tpu_torch.utils.profiling import SpanRecord

N, D, K = 300, 8, 5

VECTOR_LEG = {"layer.vector.launch>layer.vector.mask", "layer.vector.launch>layer.vector.scan"}
TEXT_LEG = {f"layer.text.execute>layer.text.{step}"
            for step in ("postings", "terms", "mask", "score", "collect", "results")}


def _fluent_vector_tree(root):
    return VECTOR_LEG | {f"{root}>layer.vector.{s}" for s in ("launch", "collect", "results")}


TREES = {
    "flat_fluent": _fluent_vector_tree("layer.vector.execute"),
    "flat_batch": _fluent_vector_tree("layer.vector.search_batch"),
    "hybrid_fluent": (_fluent_vector_tree("layer.vector.execute") | TEXT_LEG
                      | {f"layer.hybrid.execute>layer.{s}" for s in
                         ("hybrid.filter", "vector.execute", "text.execute", "hybrid.fusion",
                          "hybrid.results")}),
    "bm25_fluent": TEXT_LEG,
    "bm25_batch": TEXT_LEG,
    "hybrid_batch": (VECTOR_LEG | TEXT_LEG
                     | {f"layer.hybrid.search_batch>layer.{s}" for s in
                        ("hybrid.filter", "vector.launch", "text.execute", "vector.collect",
                         "hybrid.fusion")}),
}
ROOTS = {"flat_fluent": "layer.vector.execute", "flat_batch": "layer.vector.search_batch",
         "hybrid_fluent": "layer.hybrid.execute", "bm25_fluent": "layer.text.execute",
         "bm25_batch": "layer.text.execute", "hybrid_batch": "layer.hybrid.search_batch"}


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(7)
    vecs = rng.integers(0, 16, size=(N, D)).astype(np.float32)
    ids = np.arange(1, N + 1, dtype=np.uint32)
    flat = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    flat.add_batch(vecs, ids=ids)
    words = [f"w{i}" for i in range(40)]
    texts = [" ".join(words[j] for j in rng.zipf(1.4, size=8) % len(words)) for _ in range(N)]
    bm25 = ct.BM25SearchIndex(device="cpu")
    bm25.add_batch(ids.tolist(), texts)
    meta = ct.RoaringMetadataIndex()
    meta.add_columns(ids, {"cat": np.array(["a", "b", "c"])[np.arange(N) % 3]})
    hybrid = ct.new_hybrid_search_index(flat, bm25, meta)
    return SimpleNamespace(flat=flat, bm25=bm25, hybrid=hybrid, vecs=vecs)


def search(ix, kind):
    """One call into the program, as plain comparable arrays."""
    rrf = ct.FusionKind.RECIPROCAL_RANK
    if kind == "flat_fluent":
        out = ix.flat.new_search().with_query(ix.vecs[3] + 0.5).with_k(K).execute()
        return [(r.get_id(), r.get_score()) for r in out]
    if kind == "flat_batch":
        return ix.flat.search_batch(ix.vecs[:4] + 0.25, k=K)
    if kind == "hybrid_fluent":
        out = (ix.hybrid.new_search().with_vector(ix.vecs[5]).with_text("w1 w3")
               .with_metadata(ct.eq("cat", "a")).with_fusion_kind(rrf).with_k(K).execute())
        return [(r.id, r.score) for r in out]
    if kind == "bm25_fluent":
        return [(r.get_id(), r.get_score())
                for r in ix.bm25.new_search().with_query("w2 w5").with_k(K).execute()]
    if kind == "bm25_batch":
        return ix.bm25.search_batch(["w0", "w4 w7"], k=K)
    out = ix.hybrid.search_batch(ix.vecs[:3], ["w1", "w2 w6", "w9"], k=K,
                                 metadata_filters=[ct.eq("cat", "b")], fusion_kind=rrf)
    return [[(r.id, r.score) for r in row] for row in out]


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_without_a_profiler_a_search_records_nothing_and_opens_no_range(indexes, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler")

    profiling.clear()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for kind in ("flat_fluent", "flat_batch", "hybrid_fluent", "bm25_fluent"):
        search(indexes, kind)
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize("kind", list(TREES))
def test_a_profiled_search_records_its_span_tree(indexes, kind):
    search(indexes, kind)       # warm: the postings and mirrors are built
    _, prof = profiled(lambda: search(indexes, kind))
    recs = profiling.spans()
    assert recs and all(r.name.startswith("layer.") for r in recs)
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [ROOTS[kind]]
    assert {r.request for r in recs} == {roots[0].request}
    ids = {id(r) for r in recs}
    for r in recs:
        assert r.end is not None and r.start <= r.end
        if r.parent is not None:
            assert id(r.parent) in ids and r.parent.request == r.request
            assert r.parent.start <= r.start and r.end <= r.parent.end
    assert {f"{r.parent.name}>{r.name}" for r in recs if r.parent is not None} == TREES[kind]
    events = {e.name for e in prof.events() if e.name.startswith("layer.")}
    assert events == {r.name for r in recs}
    assert roots[0].counters["queries"] == {"flat_batch": 4, "bm25_batch": 2,
                                            "hybrid_batch": 3}.get(kind, 1)
    assert profiling.per_query("h2d_bytes") == 0      # a CPU index copies to no card


@pytest.mark.parametrize("kind", ["flat_fluent", "flat_batch", "hybrid_fluent", "hybrid_batch"])
def test_the_device_collect_maps_ids_on_the_card_once_a_query(indexes, kind):
    """`ids_on_card` counts the rows whose slots the collect maps to ids on
    the device: one a query on the flat paths and the hybrid vector leg."""
    search(indexes, kind)
    profiled(lambda: search(indexes, kind))
    assert profiling.per_query("ids_on_card") == 1.0


def test_the_rerank_collect_maps_ids_on_the_host_and_counts_none(indexes):
    rerank = ct.FlatIndex(D, ct.DistanceKind.L2, storage="bfloat16", rerank=True, device="cpu")
    rerank.add_batch(indexes.vecs, ids=range(1, N + 1))
    for run in (lambda: rerank.search_batch(indexes.vecs[:4] + 0.25, k=K),
                lambda: rerank.new_search().with_query(indexes.vecs[3]).with_k(K).execute()):
        run()
        profiled(run)
        assert profiling.per_query("queries") is not None
        assert not any(r.counters and "ids_on_card" in r.counters for r in profiling.spans())


@pytest.mark.parametrize("kind", list(TREES))
def test_results_with_spans_on_equal_results_with_spans_off(indexes, kind):
    off = search(indexes, kind)
    on, _ = profiled(lambda: search(indexes, kind))
    assert profiling.spans()
    if isinstance(off, tuple):
        for a, b in zip(off, on):
            np.testing.assert_array_equal(a, b)
    else:
        assert on == off


def test_a_new_profiled_stretch_empties_the_last_and_the_store_is_bounded(indexes, monkeypatch):
    search(indexes, "flat_fluent")          # spans off: the next stretch starts afresh
    profiled(lambda: [search(indexes, "flat_fluent") for _ in range(2)])
    first = profiling.spans()
    assert len({r.request for r in first}) == 2
    search(indexes, "flat_fluent")          # spans off between the stretches
    profiled(lambda: search(indexes, "flat_batch"))
    second = profiling.spans()
    assert {r.name for r in second if r.parent is None} == {"layer.vector.search_batch"}
    assert min(r.request for r in second) > max(r.request for r in first)

    monkeypatch.setattr(profiling, "MAX_RECORDS", 5)
    search(indexes, "flat_fluent")
    profiled(lambda: [search(indexes, "flat_fluent") for _ in range(3)])
    assert len(profiling.spans()) == 5
    assert profiling.dropped() == 3 * len(TREES["flat_fluent"]) + 3 - 5
    assert len(profiling.requests()) == 1     # the first request, its results' span cut off
    assert all(r.end is not None for r in profiling.spans())


# -- the IVF path ------------------------------------------------------------

IVF_ROUTES = {"sparse": "1", "dense": "0"}
IVF_TREES = {
    "sparse": {"layer.vector.search_batch>layer.vector.launch",
               "layer.vector.launch>layer.vector.scan",
               "layer.vector.search_batch>layer.vector.collect",
               "layer.vector.search_batch>layer.vector.results"},
    "dense": {"layer.vector.search_batch>layer.vector.launch",
              "layer.vector.launch>layer.vector.mask",
              "layer.vector.launch>layer.vector.scan",
              "layer.vector.search_batch>layer.vector.collect",
              "layer.vector.search_batch>layer.vector.results"},
}


def _ivf(n=600, nlist=16):
    rng = np.random.default_rng(11)
    vecs = rng.integers(0, 16, size=(n, D)).astype(np.float32)
    idx = ct.IVFIndex(D, nlist, ct.DistanceKind.L2, device="cpu")
    idx.train(vecs)
    idx.add_batch(vecs, ids=np.arange(1, n + 1, dtype=np.uint32))
    return idx, vecs


def _edges(recs):
    return {f"{r.parent.name}>{r.name}" for r in recs if r.parent is not None}


@pytest.mark.parametrize("route", list(IVF_ROUTES))
def test_a_profiled_ivf_search_records_its_span_tree_and_route(route, monkeypatch):
    """The first search builds the route's layout inside `layer.ivf.layout`;
    once it is current, a batch's tree is the flat batch's, with the
    queries' copy and each pipeline's enqueue in `layer.vector.scan`, and
    `ivf_sparse_rows` counts the queries the sparse route served."""
    monkeypatch.setenv("COMET_IVF_SPARSE", IVF_ROUTES[route])
    idx, vecs = _ivf()
    q = vecs[:5] + 0.25
    first, _ = profiled(lambda: idx.search_batch(q, k=K, nprobes=3))
    assert "layer.vector.launch>layer.ivf.layout" in _edges(profiling.spans())
    profiling.clear()
    again, _ = profiled(lambda: idx.search_batch(q, k=K, nprobes=3))
    recs = profiling.spans()
    assert _edges(recs) == IVF_TREES[route]
    assert sum(r.name == "layer.vector.scan" for r in recs) == 2
    assert profiling.per_query("ivf_sparse_rows") == (1.0 if route == "sparse" else 0.0)
    assert profiling.per_query("h2d_bytes") == 0
    assert not any(r.name == "layer.ivf.rescan" for r in recs)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_a_forced_overflow_opens_the_rescan_span_and_counts_it(monkeypatch):
    """A step budget too small for the probes: the first scan drops chunks,
    the collect rescans inside `layer.ivf.rescan` (a scan and the wait for
    its overflow counts), once for each step of the budget's escalation;
    the rescanned results equal the dense route's."""
    from comet_tpu_torch.indexes import ivf as ivf_mod

    monkeypatch.setenv("COMET_IVF_SPARSE", "1")
    idx, vecs = _ivf()
    q = vecs[:6] + 0.5
    idx.search_batch(q, k=4, nprobes=7)        # the layout is built here
    idx._sparse_S_hint.clear()
    before = idx.stats()
    profiling.clear()
    monkeypatch.setattr(ivf_mod.sp, "default_budgets", lambda nprobe, nlist, total, mc: (4, 4, mc))
    got, _ = profiled(lambda: idx.search_batch(q, k=4, nprobes=7))
    recs = profiling.spans()
    rescans = [r for r in recs if r.name == "layer.ivf.rescan"]
    assert rescans and all(r.parent.name == "layer.vector.collect" for r in rescans)
    assert {r.name for r in recs if r.parent in rescans} == {"layer.vector.scan"}
    after = idx.stats()
    assert after["sparse_overflow_batches"] == before["sparse_overflow_batches"] + 1
    assert after["sparse_overflow_chunks"] > before["sparse_overflow_chunks"]
    assert profiling.span_ms("layer.ivf.rescan") > 0
    monkeypatch.setenv("COMET_IVF_SPARSE", "0")
    want = idx.search_batch(q, k=4, nprobes=7)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("route", list(IVF_ROUTES))
def test_the_ivf_query_copy_counts_in_h2d_bytes_for_a_card_and_not_for_the_cpu(
        route, monkeypatch):
    """`count_h2d` counts only copies to a CUDA device: a CPU index counts
    nothing; the same search with the index's copies taken as copies to a
    card counts the queries' bytes and, with the layouts current, only
    them."""
    from comet_tpu_torch.indexes import ivf as ivf_mod

    monkeypatch.setenv("COMET_IVF_SPARSE", IVF_ROUTES[route])
    idx, vecs = _ivf()
    q = vecs[:8] + 0.25
    idx.search_batch(q, k=K, nprobes=3)
    profiling.clear()
    profiled(lambda: idx.search_batch(q, k=K, nprobes=3))
    assert profiling.per_query("h2d_bytes") == 0
    card = torch.device("cuda")
    monkeypatch.setattr(ivf_mod, "count_h2d", lambda n, dev: profiling.count_h2d(n, card))
    profiling.clear()
    profiled(lambda: idx.search_batch(q, k=K, nprobes=3))
    assert profiling.per_query("h2d_bytes") == q[0].nbytes


def _rec(name, a_ms, b_ms, request, parent=None, **counters):
    return SpanRecord(name, int(a_ms * 1e6), None if b_ms is None else int(b_ms * 1e6),
                      request, parent, counters or None)


def test_the_summary_arithmetic_on_hand_made_records():
    a = _rec("layer.a.execute", 0, 10, 1, queries=2)
    x = _rec("layer.a.x", 1, 3, 1, a, h2d_bytes=100)
    y = _rec("layer.a.y", 2, 6, 1, a, queries=7)          # a child's queries are not served
    z = _rec("layer.a.results", 8, 9.5, 1, a)
    z1 = _rec("layer.a.z1", 8, 8.5, 1, z)
    b = _rec("layer.b.execute", 20, 24, 2, queries=3, h2d_bytes=50)
    bz = _rec("layer.b.results", 21, 22, 2, b)
    open_root = _rec("layer.c.execute", 30, None, 3, queries=100, h2d_bytes=10 ** 6)
    orphan = _rec("layer.a.x", 40, 41, 4, _rec("layer.d.execute", 39, 42, 4))   # root not stored
    recs = [a, x, y, z, z1, b, bz, open_root, orphan]

    assert sorted(profiling.requests(recs)) == [1, 2]
    assert profiling.span_ms("layer.a.x", recs) == pytest.approx(2.0)
    assert profiling.span_ms(("layer.a.x", "layer.a.y"), recs) == pytest.approx(6.0)
    assert profiling.span_ms("layer.*.results", recs) == pytest.approx((1.5 + 1.0) / 2)
    assert profiling.span_ms("layer.none", recs) is None
    # leaves of request 1: x, y, z1 -> [1, 6] and [8, 8.5] covered of [0, 10];
    # request 2: bz alone, 1 of 4 ms
    assert profiling.unnamed_ms(recs) == pytest.approx(((10 - 5.5) + (4 - 1)) / 2)
    assert profiling.per_query("h2d_bytes", recs) == pytest.approx(150 / 5)
    assert profiling.per_query("h2d_bytes", [x]) is None
    assert profiling.unnamed_ms([]) is None


# -- the benchmark's readers --------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARDBENCH_TESTS = os.path.join(REPO, "cardbench", "tests")
SPAN_METRICS = {"flat-batch2048": ["vector_mask_ms", "collect_ms", "results_ms", "unnamed_ms"],
                "flat-online-k10": ["vector_mask_ms", "collect_ms", "results_ms", "unnamed_ms"],
                "hybrid-online-rrf": ["text_mask_ms", "vector_mask_ms", "collect_ms",
                                      "results_ms", "unnamed_ms"],
                "ivf-batch2048": ["collect_ms", "results_ms", "unnamed_ms", "rescan_ms",
                                  "sparse_share"]}
TINY_NLIST = 32     # the IVF cell's lists at the tiny cells' 4096 rows


def _leaf_intervals(events):
    """(start, end) of the program's leaf spans among profiler events."""
    names = {r.name for r in profiling.spans()}
    spans = sorted(((e.time_range.start, e.time_range.end) for e in events
                    if e.name in names and e.device_type == torch.autograd.DeviceType.CPU),
                   key=lambda s: (s[0], -s[1]))
    return [s for i, s in enumerate(spans) if i + 1 == len(spans) or spans[i + 1][0] >= s[1]]


@pytest.mark.parametrize("cell", list(SPAN_METRICS))
def test_a_tiny_traced_run_of_each_cell_reports_the_span_metrics(cell, monkeypatch):
    if CARDBENCH_TESTS not in sys.path:
        sys.path.insert(0, CARDBENCH_TESTS)
    from cardbench_tiny import tiny_cell          # puts cardbench/ on the path
    from harness import spec, trace

    import run

    captured = {}
    digest = trace.digest

    def keep_events(events):
        captured["events"] = list(events)
        return digest(captured["events"])

    monkeypatch.setattr(trace, "digest", keep_events)
    spec_cell = tiny_cell(cell)
    spec_cell["traffic_spec"]["trace_seconds"] = 0.5
    if "nlist" in spec_cell["config_spec"]:
        spec_cell["config_spec"]["nlist"] = TINY_NLIST
    result, _ = run.run(spec_cell, 2 ** 33 + 5, 1.0, True, "cpu")
    listed = spec.reported(cell, True)
    for name in SPAN_METRICS[cell]:
        assert name in listed and name in result["metrics"], name
        assert math.isfinite(result["metrics"][name]["value"]), name
        assert result["metrics"][name]["value"] >= 0, name
    assert "h2d_kib_per_query" in listed and "h2d_kib_per_query" not in result["metrics"]
    assert not any(n.startswith("layer.") for n, _ in result["breakdown"]["device_ops"])

    # the card idle exactly inside the program's leaf spans: every gap is
    # named after a "layer." span, and the program's own names are among them
    events = captured["events"]
    win = next(e for e in events if e.name == trace.WINDOW)
    w0, w1 = win.time_range.start, win.time_range.end
    busy, cur = [], w0
    for a, b in trace.merged(_leaf_intervals(events)):
        if a > cur:
            busy.append((cur, min(a, w1)))
        cur = max(cur, b)
    if cur < w1:
        busy.append((cur, w1))
    device = [SimpleNamespace(name="kernel", device_type=torch.autograd.DeviceType.CUDA, id=0,
                              time_range=SimpleNamespace(start=a, end=b)) for a, b in busy]
    named = [name for name, _ in trace.digest(events + device)["breakdown"]["idle_gaps"]]
    assert named and all(name.startswith("layer.") for name in named), named
    assert set(named) & {r.name for r in profiling.spans()}
