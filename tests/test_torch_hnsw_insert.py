"""Incremental HNSW insertion in comet_tpu_torch against comet_tpu on the
CPU: the same adds, from the same state, build the same graph.

The two indexes start equal: both empty and seeded alike, or the port
taking over the reference's bulk-built graph with its generator's state
(`load_reference_state`; BULK_BUILD_MIN lowered as in
tests/test_torch_hnsw.py). Then both take the same `add_batch` / `add`
calls, in BUILD_SUB_BATCH rounds. Data are integers in 0..1023, where every
distance of the build is exact and equal distances are rare but present
(the graph beam keeps them in the reference's order, tests/
test_torch_graph.py). Levels, layer-0 and upper adjacency, the entry point
and the top level are array-equal; so are the CHNW bytes, and the graph-
beam search of a graph whose routing table would pass
BLOCKED_TABLE_BYTES_MAX equals the reference's CPU search, which always
takes the graph beam.

The reference compiles its graph beam once per query count, so the adds
keep to a few counts: 700 (rounds of 512 or 511 and 188), 188, 1, and
searches of 100 queries (one padded chunk of 128).
"""

import io
from functools import lru_cache

import numpy as np
import pytest
import torch

import comet_tpu.indexes.hnsw as ref_hnsw
import comet_tpu_torch.indexes.hnsw as port_hnsw
from comet_tpu.core.node import VectorNode as RefNode
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch import DistanceKind, HNSWConfig, HNSWIndex, VectorNode
from comet_tpu_torch.ops import beam_kernel as port_bk

D, M, EFC, EF = 16, 8, 64, 64
N_BULK, N_ADD = 600, 700


def _x():
    rng = np.random.default_rng(41)
    return rng.integers(0, 1024, size=(N_BULK + N_ADD + 400, D)).astype(np.float32)


def _cfgs():
    return (ref_hnsw.HNSWConfig(m=M, ef_construction=EFC, ef_search=EF),
            HNSWConfig(m=M, ef_construction=EFC, ef_search=EF))


def _state_equal(port, ref):
    n = ref._store.n
    assert port._store.n == n and port.count() == ref.count()
    np.testing.assert_array_equal(port._levels[:n], ref._levels[:n])
    np.testing.assert_array_equal(port._adj0[:n], ref._adj0[:n])
    assert sorted(port._upper) == sorted(ref._upper)
    for lvl in ref._upper:
        np.testing.assert_array_equal(port._upper[lvl][:n], ref._upper[lvl][:n])
    assert (port._entry_slot, port._max_level) == (ref._entry_slot, ref._max_level)
    np.testing.assert_array_equal(port._sqn0[:n], ref._sqn0[:n])


@lru_cache(maxsize=None)
def _pair(start):
    """(reference, port) after adding N_ADD rows to an empty index or on top
    of a bulk build of N_BULK rows."""
    x = _x()
    rcfg, pcfg = _cfgs()
    ref = ref_hnsw.HNSWIndex(D, RefKind.L2, rcfg)
    if start == "bulk":
        old = ref_hnsw.BULK_BUILD_MIN
        ref_hnsw.BULK_BUILD_MIN = 512
        try:
            ref.add_batch(x[:N_BULK], ids=np.arange(1, N_BULK + 1))
        finally:
            ref_hnsw.BULK_BUILD_MIN = old
        s = ref._store
        port = HNSWIndex.load_reference_state(
            s.ids, s.vectors, s.valid, s.n, ref._levels, ref._adj0, ref._upper,
            ref._entry_slot, ref._max_level, DistanceKind.L2, pcfg,
            ref._rng.bit_generator.state, device="cpu")
        lo = N_BULK
    else:
        port = HNSWIndex(D, DistanceKind.L2, pcfg, device="cpu")
        lo = 0
    ids = np.arange(lo + 1, lo + N_ADD + 1)
    ref.add_batch(x[lo: lo + N_ADD], ids=ids)
    port.add_batch(x[lo: lo + N_ADD], ids=ids)
    return ref, port


def _copies(start):
    """Fresh copies of the pair through the reference's CHNW bytes (both
    generators restart from seed 0)."""
    ref, _ = _pair(start)
    buf = io.BytesIO()
    ref.write_to(buf)
    rcfg, pcfg = _cfgs()
    rc = ref_hnsw.HNSWIndex(D, RefKind.L2, rcfg)
    rc.read_from(io.BytesIO(buf.getvalue()))
    pc = HNSWIndex(D, DistanceKind.L2, pcfg, device="cpu")
    pc.read_from(io.BytesIO(buf.getvalue()))
    return rc, pc


@pytest.mark.parametrize("start", ["empty", "bulk"])
def test_insert_matches_reference(start):
    ref, port = _pair(start)
    _state_equal(port, ref)
    assert port._max_level >= 1 and len(port._upper) >= 1
    assert (port._adj0[: port._store.n] >= 0).sum(axis=1).min() >= 1


@pytest.mark.parametrize("start", ["empty", "bulk"])
def test_chnw_bytes_after_insertion(start):
    """The port writes the reference's bytes after insertion, and each
    package reads the other's."""
    ref, port = _pair(start)
    want, got = io.BytesIO(), io.BytesIO()
    ref.write_to(want)
    port.write_to(got)
    assert got.getvalue() == want.getvalue()
    rcfg, pcfg = _cfgs()
    back = HNSWIndex(D, DistanceKind.L2, pcfg, device="cpu")
    back.read_from(io.BytesIO(want.getvalue()))
    _state_equal(back, ref)
    rback = ref_hnsw.HNSWIndex(D, RefKind.L2, rcfg)
    rback.read_from(io.BytesIO(got.getvalue()))
    _state_equal(back, rback)


def test_single_add_matches_reference():
    """`add`, one node: one round with the bootstrap's neighbours."""
    rc, pc = _copies("bulk")
    v = _x()[-1]
    rc.add(RefNode(90001, v))
    pc.add(VectorNode(90001, v))
    _state_equal(pc, rc)
    ids, scores = pc.search_batch(v[None, :], k=1)
    assert ids[0, 0] == 90001 and scores[0, 0] == 0.0


@pytest.mark.parametrize("packed", [False, True])
def test_one_routing_table_updated_in_place(packed, monkeypatch):
    """The index holds one routing table, in the layout the switch selects:
    an insertion round writes its touched rows into it, to a fresh build's
    values, and a changed switch replaces it with the other layout, with
    the same results."""
    monkeypatch.setenv("COMET_HNSW_PACKED", "1" if packed else "0")
    _, pc = _copies("bulk")
    q = _x()[-100:]
    pc.search_batch(q, k=5)
    table = pc._table[1][0]
    x = _x()[N_BULK + N_ADD: N_BULK + N_ADD + 188]
    pc.add_batch(x, ids=np.arange(50001, 50001 + len(x)))
    layout, (nbr_vecs, aux) = pc._table
    assert layout == packed and nbr_vecs is table       # updated, not rebuilt
    vecs, sqn, _ = pc._store.device_state()
    adj = torch.from_numpy(pc._adj0)
    assert torch.equal(pc._dev_adj, adj)
    if packed:
        assert aux is None and torch.equal(nbr_vecs, port_bk.build_packed_table(adj, vecs, sqn))
    else:
        fresh = port_bk.build_blocked_tables(adj, vecs, sqn)
        assert torch.equal(nbr_vecs, fresh[0]) and torch.equal(aux, fresh[1])
    want = pc.search_batch(q, k=5)
    monkeypatch.setenv("COMET_HNSW_PACKED", "0" if packed else "1")
    got = pc.search_batch(q, k=5)
    assert pc._table[0] == (not packed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_remove_flush_then_add_matches_reference():
    rc, pc = _copies("empty")
    for i in range(3, N_ADD, 7):
        rc.remove(i)
        pc.remove(i)
    rc.flush()
    pc.flush()
    _state_equal(pc, rc)
    x = _x()[N_BULK + N_ADD: N_BULK + N_ADD + 188]
    ids = np.arange(50001, 50001 + len(x))
    rc.add_batch(x, ids=ids)
    pc.add_batch(x, ids=ids)
    _state_equal(pc, rc)


def test_seed_tables_maintained_on_adds(monkeypatch):
    """The seed maintenance of tests/test_hnsw.py (seed state incremental
    maintenance) on the port, step by step beside the reference: a small
    add extends the assignments and keeps the layout, a removal refreshes
    the mask only, an add past the debounce rebuilds, a flush rebuilds
    cleanly; the tables equal the reference's at every step."""
    monkeypatch.setattr(ref_hnsw, "SEED_REBUILD_MIN", 64)
    monkeypatch.setattr(port_hnsw, "SEED_REBUILD_MIN", 64)
    rc, pc = _copies("bulk")
    x = _x()[N_BULK + N_ADD:]

    def same():
        rs, ps = rc._ensure_seed(), pc._ensure_seed()
        for key in ("row_slot", "mask_vec"):
            np.testing.assert_array_equal(ps[key].numpy(), np.asarray(rs[key]))
        np.testing.assert_array_equal(pc._seed_assign[: pc._store.n],
                                      rc._seed_assign[: rc._store.n])
        assert (pc._seed_layout_n, pc._seed_assign_n) == (rc._seed_layout_n, rc._seed_assign_n)
        return ps

    n0 = pc._store.n
    st1 = same()
    rc.add(RefNode(70001, x[0]))
    pc.add(VectorNode(70001, x[0]))
    st2 = same()
    assert st2["corpus"] is st1["corpus"] and pc._seed_layout_n == n0
    assert pc._seed_assign_n == n0 + 1 and pc._seed_version == pc._store.version
    slot = pc._store.id_to_slot[3]
    rc.remove(3)
    pc.remove(3)
    st3 = same()
    assert st3["corpus"] is st1["corpus"]
    assert np.isinf(st3["mask_vec"].numpy()[st3["row_slot"].numpy() == slot]).all()
    ids = np.arange(70002, 70002 + 188)
    rc.add_batch(x[1:189], ids=ids)
    pc.add_batch(x[1:189], ids=ids)
    st4 = same()
    assert st4["corpus"] is not st1["corpus"] and pc._seed_layout_n == pc._store.n
    assert not (st4["row_slot"].numpy() == slot).any()
    rc.remove(5)
    pc.remove(5)
    rc.flush()
    pc.flush()
    live = same()["row_slot"].numpy()
    assert len(live[live >= 0]) == pc._store.n == pc.count()


@pytest.mark.parametrize("scenario", ["plain", "filter-threshold", "after-remove"])
def test_graph_beam_search_matches_reference(scenario, monkeypatch):
    """A graph whose routing table would pass BLOCKED_TABLE_BYTES_MAX
    searches with the graph beam from a host descent, in 256-query chunks:
    the reference's CPU search (always the graph beam) on the same graph.
    Ids array-equal; scores too (integer data, correctly rounded roots)."""
    monkeypatch.setattr(port_hnsw, "BLOCKED_TABLE_BYTES_MAX", 1 << 10)
    monkeypatch.setenv("COMET_HNSW_SEED", "1")       # no table, no seeds
    rc, pc = _copies("bulk")
    q = np.random.default_rng(43).integers(0, 1024, size=(100, D)).astype(np.float32)
    kw = {}
    if scenario == "filter-threshold":
        kw = dict(threshold=1100.0, document_ids=list(range(1, 1400, 2)))
    elif scenario == "after-remove":
        for i in range(2, 1300, 11):
            rc.remove(i)
            pc.remove(i)
    want = rc.search_batch(q, k=10, **kw)
    got = pc.search_batch(q, k=10, **kw)
    assert pc._table is None and pc._seed_state is None
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    hits = got[0][got[0] != 0xFFFFFFFF]
    assert len(hits) and (len(hits) < got[0].size) == (scenario == "filter-threshold")
