"""comet_tpu_torch.indexes.hnsw (HNSWIndex) against comet_tpu's HNSW on
the CPU, with the search held apart from the build.

The JAX package builds the graph (its bulk build, BULK_BUILD_MIN lowered
as tests/test_hnsw_bulk.py does); the port takes it over through
`load_reference_state` and through CHNW bytes, both ways byte-identical.
On the CPU the reference's HNSWIndex searches with ops/graph.py, not with
the blocked beam, so the expected results are composed from the JAX
package's own functions the way its HNSWIndex composes them on a TPU:
`build_blocked_tables`, seeds from `ivf_sparse_pipeline(bf16_domain=True,
interpret=True)` on the JAX index's own `_ensure_seed()` tables, then
`beam_search_blocked(use_pallas=False)`. Data are SIFT-range integers
(cosine: +-1 entries, four per row, so that the normalised rows are
+-0.5), where every distance of the path is exact: ids array-equal,
scores allclose(1e-4).
"""

import io
import os
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest

import comet_tpu.indexes.hnsw as ref_hnsw
import comet_tpu_torch.indexes.hnsw as port_hnsw
from comet_tpu.core.filter import DocumentFilter as RefFilter
from comet_tpu.core.limiter import sanitize_k
from comet_tpu.indexes.base import next_pow2, pad_queries
from comet_tpu.ops import beam_kernel as ref_bk
from comet_tpu.ops import ivf_sparse as ref_sp
from comet_tpu.ops.distance import preprocess as ref_preprocess
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch import DistanceKind, HNSWConfig, HNSWIndex
from comet_tpu_torch.indexes.base import INVALID_ID

from oracle import distances_np, preprocess_np, recall_at_k, topk_np

N, D, M, EF, K, NQ = 3000, 16, 8, 64, 10, 100
SENT = 2**31 - 1
# a narrow seed scan (32 rows from 8 selection groups) keeps the reference's
# interpret-mode pipeline small; both packages read these knobs alike
SEED_WIDTH, SEED_KB = 32, 8


def _data(kind):
    rng = np.random.default_rng(31 if kind == "l2" else 32)
    if kind == "cosine":
        def signs(n):
            v = np.zeros((n, D), np.float32)
            for r in range(n):
                v[r, rng.choice(D, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
            return v
        return signs(N), signs(NQ)
    x = rng.integers(0, 256, size=(N + NQ, D)).astype(np.float32)
    return x[:N], x[N:]


@lru_cache(maxsize=None)
def _ref_built(kind):
    x, _ = _data(kind)
    old = ref_hnsw.BULK_BUILD_MIN
    ref_hnsw.BULK_BUILD_MIN = 512
    try:
        idx = ref_hnsw.HNSWIndex(D, RefKind(kind), _ref_cfg())
        idx.add_batch(x, ids=np.arange(1, N + 1))
    finally:
        ref_hnsw.BULK_BUILD_MIN = old
    return idx


def _ref_copy(kind):
    """A fresh JAX index with the built graph (through CHNW bytes)."""
    buf = io.BytesIO()
    _ref_built(kind).write_to(buf)
    idx = ref_hnsw.HNSWIndex(D, RefKind(kind), _ref_cfg())
    idx.read_from(io.BytesIO(buf.getvalue()))
    return idx


def _ref_cfg():
    return ref_hnsw.HNSWConfig(m=M, ef_construction=64, ef_search=EF, seed_width=SEED_WIDTH,
                               seed_kb=SEED_KB)


def _port_of(ref):
    s = ref._store
    cfg = HNSWConfig(m=ref._cfg.m, ef_construction=ref._cfg.ef_construction,
                     ef_search=ref._cfg.ef_search, seed_width=ref._cfg.seed_width,
                     seed_kb=ref._cfg.seed_kb)
    return HNSWIndex.load_reference_state(
        s.ids, s.vectors, s.valid, s.n, ref._levels, ref._adj0, ref._upper,
        ref._entry_slot, ref._max_level, DistanceKind(ref._distance_kind.value), cfg,
        ref._rng.bit_generator.state, device="cpu")


def _ref_search(idx, queries, k, seeded, threshold=0.0, doc_ids=None):
    """The reference's blocked-beam search (HNSWIndex._search_launch and
    _pallas_launch on a TPU), composed from its CPU forms."""
    store = idx._store
    k_eff = sanitize_k(k, store.n)
    ef = max(idx._effective_ef(None), k_eff)
    k_pad = min(next_pow2(k_eff), store.capacity)
    ef_pad = next_pow2(ef, 16)
    qpad, q_real = pad_queries(ref_preprocess(queries, idx._distance_kind))
    idx._ensure_device()
    idx._sync_valid()
    allowed = idx._dev_valid
    fmask = RefFilter(doc_ids).slot_mask(store.ids)
    if fmask is not None:
        allowed = jnp.logical_and(allowed, jnp.asarray(fmask))
    fused = fmask is not None or threshold > 0 or store.deleted > 0
    nv, aux = ref_bk.build_blocked_tables(jnp.asarray(idx._adj0), idx._dev_vectors,
                                          idx._dev_sqnorms)
    if seeded:
        stop = min(max(2 * k_pad, 64), ef_pad)
        seed_k = min(idx._cfg.seed_width or 128, stop)
        max_iters = max((2 * stop) // 8 // 2, 12)
        st = idx._ensure_seed()
        nprobe = min(max(2, st["nlist"] // 64), st["nlist"] - 1)
        S, UC, MC = ref_sp.default_budgets(nprobe, st["nlist"], st["nch_total"], st["max_chunks"])
        sd, ss, _ = ref_sp.ivf_sparse_pipeline(
            jnp.asarray(qpad), st["corpus_t"], st["mask_vec"], st["row_slot"],
            jnp.asarray(np.float32(np.inf)), st["centroids"], st["order_key"],
            st["chunk_start"], st["nchunks"], k=seed_k, nprobe=nprobe, S=S, UC=UC, MC=MC,
            nlist=st["nlist"], bf16_domain=True, kb_cap=idx._cfg.seed_kb, hier=False,
            interpret=True)
        seeds = (sd, ss)
        entries = np.full(qpad.shape[0], max(idx._entry_slot, 0), np.int32)
    else:
        stop, seeds = None, None
        max_iters = max(2 * ef_pad // 8, 48)
        entries = idx._descend_for_search(qpad)
    sd, ss = ref_bk.beam_search_blocked(
        jnp.asarray(qpad), jnp.asarray(entries), nv, aux, idx._dev_vectors, idx._dev_sqnorms,
        allowed, idx._sq_threshold(threshold), ef_pad, k_pad, 8, max_iters, fused,
        use_pallas=False, seeds=seeds, stop=stop)
    scores = idx._from_sq(np.asarray(sd))[:q_real, :k_eff]
    slots = np.asarray(ss)[:q_real, :k_eff]
    hit = slots != SENT
    ids = np.where(hit, store.ids[np.where(hit, slots, 0)], INVALID_ID)
    return ids.astype(np.uint32), scores


def _env_seed(monkeypatch, seeded):
    monkeypatch.setenv("COMET_HNSW_SEED", "1" if seeded else "0")


# (kind, seeded, threshold?, filter?, removed?)
CASES = {
    "seeded": ("l2", True, False, False, False),
    "classic": ("l2", False, False, False, False),
    "seeded-filter-threshold": ("l2", True, True, True, False),
    "seeded-after-remove": ("l2", True, False, False, True),
    "cosine-classic": ("cosine", False, False, False, False),
}
REMOVED = np.arange(7, N + 1, 100)          # 1% of the ids
ALLOWED_IDS = [i for i in range(1, N + 1) if i % 3]


def _threshold(kind):
    x, q = _data(kind)
    d = distances_np(preprocess_np(q, kind), preprocess_np(x, kind), kind)
    return float(np.median(np.sort(d, axis=1)[:, K // 2]))


@lru_cache(maxsize=None)
def _case(case):
    """(reference result, port index, kwargs of the port's search)."""
    kind, seeded, thr, filt, removed = CASES[case]
    ref = _ref_copy(kind)
    port = _port_of(ref)
    _, q = _data(kind)
    kw = dict(threshold=_threshold(kind) if thr else 0.0,
              document_ids=ALLOWED_IDS if filt else None)
    old = os.environ.get("COMET_HNSW_SEED")
    os.environ["COMET_HNSW_SEED"] = "1" if seeded else "0"
    try:
        if removed:
            # both build their seed tables first: the removals then take
            # the delta path (a mask refresh, no new layout)
            ref._ensure_seed()
            port._ensure_seed()
            for i in REMOVED.tolist():
                ref.remove(i)
                port.remove(i)
        want = _ref_search(ref, q, K, seeded, kw["threshold"], kw["document_ids"])
    finally:
        if old is None:
            del os.environ["COMET_HNSW_SEED"]
        else:
            os.environ["COMET_HNSW_SEED"] = old
    return want, port, kw


@pytest.mark.parametrize("case", list(CASES))
def test_search_matches_reference(case, monkeypatch):
    kind, seeded, thr, filt, removed = CASES[case]
    want, port, kw = _case(case)
    _env_seed(monkeypatch, seeded)
    _, q = _data(kind)
    ids, scores = port.search_batch(q, k=K, **kw)
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_allclose(scores, want[1], rtol=1e-4, atol=1e-4)
    hits = ids[ids != INVALID_ID]
    assert len(hits)
    if filt:
        assert (hits % 3 != 0).all() and (ids == INVALID_ID).any()
    if removed:
        assert not np.isin(hits, REMOVED).any()
        assert port._seed_layout_deleted == 0      # the delta path refreshed the mask
    if seeded:
        assert port._seed_state is not None


@pytest.mark.parametrize("seeded", [True, False])
def test_recall_matches_reference(seeded, monkeypatch):
    """recall@k against the numpy oracle, equal to the reference's on the
    same graph, and high."""
    want, port, _ = _case("seeded" if seeded else "classic")
    _env_seed(monkeypatch, seeded)
    x, q = _data("l2")
    _, gt = topk_np(distances_np(q, x, "l2"), K)
    ids, _ = port.search_batch(q, k=K)
    r_port = recall_at_k(ids.astype(np.int64) - 1, gt)
    assert r_port == recall_at_k(want[0].astype(np.int64) - 1, gt)
    assert r_port >= 0.9


def test_seed_tables_match_reference(monkeypatch):
    ref = _ref_copy("l2")
    port = _port_of(ref)
    rs, ps = ref._ensure_seed(), port._ensure_seed()
    assert ps["nlist"] == rs["nlist"] == 64
    np.testing.assert_array_equal(port._seed_centroids, ref._seed_centroids)
    for key in ("row_slot", "chunk_start", "nchunks", "mask_vec"):
        np.testing.assert_array_equal(ps[key].numpy(), np.asarray(rs[key]))
    np.testing.assert_array_equal(ps["corpus"].float().numpy(),
                                  np.asarray(rs["corpus_t"]).T.astype(np.float32))
    assert ps["max_chunks"] == rs["max_chunks"] and ps["nch_total"] == rs["nch_total"]


def test_chnw_bytes_both_ways():
    """The port writes the reference's bytes, reads them back, and the
    reference reads the port's."""
    ref = _ref_built("l2")
    want = io.BytesIO()
    ref.write_to(want)
    port = _port_of(ref)
    got = io.BytesIO()
    port.write_to(got)
    assert got.getvalue() == want.getvalue()
    back = HNSWIndex(D, DistanceKind.L2, HNSWConfig(m=M, ef_construction=64), device="cpu")
    back.read_from(io.BytesIO(want.getvalue()))
    again = io.BytesIO()
    back.write_to(again)
    assert again.getvalue() == want.getvalue()
    assert back.config.ef_search == EF and back._entry_slot == ref._entry_slot
    np.testing.assert_array_equal(back._adj0[:N], ref._adj0[:N])
    rback = ref_hnsw.HNSWIndex(D, RefKind.L2, ref_hnsw.HNSWConfig(m=M, ef_construction=64))
    rback.read_from(io.BytesIO(got.getvalue()))
    assert sorted(rback._upper) == sorted(port._upper)


def test_read_from_drops_the_seed_tables(monkeypatch):
    """read_from swaps in a new slot store, whose version restarts: the
    seed tables of the old corpus go with the old store. A seeded index
    that reads a smaller index's bytes searches as a fresh index does."""
    monkeypatch.setattr(port_hnsw, "BULK_BUILD_MIN", 512)
    _env_seed(monkeypatch, True)
    x, q = _data("l2")

    def cfg():
        return HNSWConfig(m=M, ef_construction=64, seed_width=SEED_WIDTH, seed_kb=SEED_KB)

    small = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
    small.add_batch(x[:1000], ids=np.arange(1, 1001))
    buf = io.BytesIO()
    small.write_to(buf)
    port = _port_of(_ref_copy("l2"))
    port.search_batch(q, k=K)
    assert port._seed_state["row_slot"].shape[0] > 1000
    port.read_from(io.BytesIO(buf.getvalue()))
    fresh = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
    fresh.read_from(io.BytesIO(buf.getvalue()))
    want_ids, want_scores = fresh.search_batch(q, k=K)
    ids, scores = port.search_batch(q, k=K)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(scores, want_scores)
    np.testing.assert_array_equal(port._seed_state["row_slot"].numpy(),
                                  fresh._seed_state["row_slot"].numpy())


def test_fluent_builder_takes_ef_search(monkeypatch):
    _, port, _ = _case("classic")
    _env_seed(monkeypatch, False)
    _, q = _data("l2")
    ids, scores = port.search_batch(q[:1], k=5, ef_search=32)
    res = port.new_search().with_query(q[0]).with_k(5).with_ef_search(32).execute()
    assert [r.node.id for r in res] == ids[0].tolist()
    np.testing.assert_allclose([r.score for r in res], scores[0])
    assert port._effective_ef(32) == 32 and port._effective_ef(0) == EF


def test_flush_compacts_and_searches(monkeypatch):
    """After remove + flush the removed ids are gone from the graph, the
    entry point is repaired, and searches return live ids only."""
    _env_seed(monkeypatch, False)
    port = _port_of(_ref_copy("l2"))
    for i in REMOVED.tolist():
        port.remove(i)
    port.flush()
    assert port._store.n == N - len(REMOVED) and port.count() == N - len(REMOVED)
    adj = port._adj0[: port._store.n]
    assert (adj < port._store.n).all() and ((adj >= 0).sum(axis=1) >= 1).all()
    _, q = _data("l2")
    ids, _ = port.search_batch(q, k=K)
    assert not np.isin(ids, REMOVED).any() and (ids != INVALID_ID).all()


def test_bulk_build_through_the_public_api(monkeypatch):
    """add_batch of an empty index builds the graph (the port's own build;
    tests/test_torch_graph_build.py holds it to the reference) and the
    default search finds every stored vector as its own nearest."""
    monkeypatch.setattr(port_hnsw, "BULK_BUILD_MIN", 512)
    _env_seed(monkeypatch, True)
    x, _ = _data("l2")
    idx = HNSWIndex(D, DistanceKind.L2, HNSWConfig(m=M, ef_construction=64), device="cpu")
    idx.add_batch(x[:1000], ids=np.arange(1, 1001))
    ids, scores = idx.search_batch(x[:50], k=1)
    np.testing.assert_array_equal(ids[:, 0], np.arange(1, 51))
    np.testing.assert_array_equal(scores[:, 0], 0.0)
    st = idx.stats()
    assert st["kind"] == "hnsw" and st["seed_overflow_chunks"] >= 0


def test_unported_paths_raise(monkeypatch):
    """The calls that raised before insertion, the packed table, the fused
    expand kernel and the graph beam were ported now succeed: an add below
    the bulk-build size, an add into a non-empty index, a bulk build under
    each switch, and a table past the cap (tests/test_torch_hnsw_insert.py
    and tests/test_torch_beam_kernel.py hold them to the reference)."""
    monkeypatch.setattr(port_hnsw, "BULK_BUILD_MIN", 512)
    x, _ = _data("l2")

    def cfg():
        return HNSWConfig(m=M, ef_construction=32, ef_search=32)

    idx = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
    idx.add_batch(x[:100])                                  # too few for the bulk build
    assert idx.count() == 100 and idx._max_level >= 0
    idx = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
    idx.add_batch(x[:600], ids=np.arange(1, 601))
    want = idx.search_batch(x[:50], k=5)
    idx.add_batch(x[600:700], ids=np.arange(601, 701))      # not empty
    np.testing.assert_array_equal(idx.search_batch(x[600:700], k=1)[0][:, 0],
                                  np.arange(601, 701))
    for var in ("COMET_HNSW_PACKED", "COMET_HNSW_FUSE"):
        monkeypatch.setenv(var, "1")
        fresh = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
        fresh.add_batch(x[:600], ids=np.arange(1, 601))
        got = fresh.search_batch(x[:50], k=5)
        assert fresh._table[0] is True
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        monkeypatch.delenv(var)
    monkeypatch.setattr(port_hnsw, "BLOCKED_TABLE_BYTES_MAX", 1 << 10)
    big = HNSWIndex(D, DistanceKind.L2, cfg(), device="cpu")
    big.add_batch(x[:600], ids=np.arange(1, 601))
    ids, scores = big.search_batch(x[:50], k=1)
    assert big._table is None
    np.testing.assert_array_equal(ids[:, 0], np.arange(1, 51))
    np.testing.assert_array_equal(scores[:, 0], 0.0)


def test_empty_index_returns_no_rows():
    idx = HNSWIndex(D, DistanceKind.L2, device="cpu")
    ids, scores = idx.search_batch(np.ones((3, D), np.float32), k=4)
    assert ids.shape == (3, 0) and scores.shape == (3, 0)
