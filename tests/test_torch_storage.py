"""comet_tpu_torch.storage on the CPU against comet_tpu.storage.

Every scenario of tests/test_storage.py and the engine scenarios of
tests/test_bloom_wal_batch.py run on both packages, each in its own
directory, through the same operations; the port's stores get CPU
factories. Both packages' node-ID counters start at 0, so auto IDs agree.
Each scenario returns what it observed (search hits, counts, stats); hits
must agree at the port's parity bar (ids equal, scores
`allclose(rtol=1e-4, atol=1e-4)`), everything else exactly. Where the
operations are deterministic the two directories must also hold the same
files: the gzip'd segment streams equal once decompressed, WALs, bloom
sidecars, TOMBSTONES, MAXID and LOCK byte for byte.

Also: compaction of a store of each vector index kind (Flat, IVF, PQ,
IVFPQ, HNSW) against the reference's compacted store, the trained state
carried across as the reference's own template bytes; the reference's
lossy text merge, which the port reproduces; and directories written by
one package after a simulated crash (WALs and tombstones left behind),
reopened by the other.
"""

import gzip
import io
import os
import threading
import time

import numpy as np
import pytest

import comet_tpu
import comet_tpu_torch
from comet_tpu import storage as rstore
from comet_tpu.core import node as ref_node
from comet_tpu_torch import storage as pstore
from comet_tpu_torch.core import node as port_node
from comet_tpu_torch.indexes import hnsw as port_hnsw

PKGS = {"ref": (comet_tpu, rstore, ref_node), "port": (comet_tpu_torch, pstore, port_node)}


@pytest.fixture(autouse=True)
def _reset_port_ids():
    port_node._reset_node_id_counter()
    yield


def _dev(lib):
    return {"device": "cpu"} if lib is comet_tpu_torch else {}


def make_config(lib, st, base, vector=None, **kw):
    return st.StorageConfig(
        base_dir=str(base),
        memtable_size_limit=kw.pop("memtable_size_limit", 1024),
        flush_threshold=kw.pop("flush_threshold", 1 << 30),
        compaction_interval=kw.pop("compaction_interval", 3600.0),
        compaction_threshold=kw.pop("compaction_threshold", 5),
        vector_index_factory=vector or (lambda: lib.FlatIndex(4, lib.DistanceKind.L2, **_dev(lib))),
        text_index_factory=lambda: lib.BM25SearchIndex(**_dev(lib)),
        metadata_index_factory=lib.RoaringMetadataIndex,
        **kw,
    )


def add_docs(store, n, start=0):
    return [
        store.add(np.array([i, 0, 0, 0], dtype=np.float32), f"document number {i} content",
                  {"num": i, "cat": "even" if i % 2 == 0 else "odd"})
        for i in range(start, start + n)
    ]


def hits(results):
    return [(int(r.id), float(r.score)) for r in results]


def _simulate_crash(store):
    """Stop a store's workers WITHOUT flushing, leaving its WALs and a
    LOCK of a dead pid behind, as a killed process would. The flush
    worker is not woken: woken, it would flush before it saw the stop."""
    store._stop.set()
    store._flush_thread.join(timeout=5)
    store._compact_event.set()  # the compaction worker returns on the stop
    store._compact_thread.join(timeout=5)
    assert not store._flush_thread.is_alive() and not store._compact_thread.is_alive()
    with open(os.path.join(store.provider.base_dir, "LOCK"), "w") as f:
        f.write("999999999")


def _same(got, want, path="obs"):
    """Observations equal; a list of (id, score) pairs at the parity bar."""
    if (isinstance(want, list) and want and isinstance(want[0], tuple) and len(want[0]) == 2
            and isinstance(want[0][1], float)):
        assert [i for i, _ in got] == [i for i, _ in want], path
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                                   rtol=1e-4, atol=1e-4, err_msg=path)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for n, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{n}]")
    else:
        assert got == want, path


def dir_bytes(base):
    """name -> content of every file of a store directory; segment streams
    decompressed."""
    out = {}
    for name in sorted(os.listdir(base)):
        with open(os.path.join(base, name), "rb") as f:
            raw = f.read()
        out[name] = gzip.decompress(raw) if name.endswith(".gz") else raw
    return out


def assert_same_files(ref_base, port_base):
    want, got = dir_bytes(ref_base), dir_bytes(port_base)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def run_both(tmp_path, scenario, files=True):
    """Run `scenario(lib, st, node_mod, base)` for each package in its own
    directory and hold the port's observations (and files) to the
    reference's."""
    obs = {}
    for key, (lib, st, node_mod) in PKGS.items():
        node_mod._reset_node_id_counter()
        obs[key] = scenario(lib, st, node_mod, tmp_path / key / "store")
    _same(obs["port"], obs["ref"])
    if files:
        assert_same_files(tmp_path / "ref" / "store", tmp_path / "port" / "store")
    return obs["port"]


# -- the scenarios of tests/test_storage.py ------------------------------------


def test_basic_add_and_search(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            ids = add_docs(store, 10)
            a = store.new_search().with_vector([3.0, 0, 0, 0]).with_k(3).execute()
            assert a[0].id == ids[3]
            b = store.new_search().with_text("document content").with_k(5).execute()
            assert len(b) == 5
            c = store.new_search().with_metadata(lib.eq("cat", "odd")).with_k(20).execute()
            assert sorted(r.id for r in c) == ids[1::2]
            d = (store.new_search().with_vector([4.0, 0, 0, 0]).with_text("number 7")
                 .with_metadata(lib.gte("num", 3)).with_k(4).execute())
            return [ids, hits(a), hits(b), sorted(hits(c)), hits(d)]

    run_both(tmp_path, scenario)


def test_rotation_and_explicit_flush_creates_segments(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base, memtable_size_limit=512)) \
                as store:
            add_docs(store, 20)
            rotated = store.memtables.count()
            assert rotated > 1
            store.flush()
            assert store.segments.count() >= 1
            res = store.new_search().with_vector([5.0, 0, 0, 0]).with_k(1).execute()
            assert res[0].score == pytest.approx(0.0, abs=1e-5)
            files = os.listdir(base)
            assert any(f.startswith("hybrid_") for f in files)
            assert any(f.startswith("vector_") for f in files)
            return [rotated, store.segments.count(), hits(res)]

    run_both(tmp_path, scenario)


def test_persistence_across_reopen(tmp_path):
    def scenario(lib, st, _, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        ids = add_docs(store, 8)
        store.close()
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store2:
            assert store2.segments.count() >= 1
            a = store2.new_search().with_vector([2.0, 0, 0, 0]).with_k(1).execute()
            assert a[0].id == ids[2]
            b = store2.new_search().with_text("number").with_k(20).execute()
            assert len(b) == 8
            c = store2.new_search().with_metadata(lib.gte("num", 6)).with_k(20).execute()
            assert sorted(r.id for r in c) == ids[6:]
            return [hits(a), hits(b), sorted(hits(c))]

    run_both(tmp_path, scenario)


def test_lock_file_exclusivity(tmp_path):
    def scenario(lib, st, _, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        with pytest.raises(st.StorageLockedError):
            st.open_persistent_hybrid_index(make_config(lib, st, base))
        held = open(os.path.join(base, "LOCK")).read()
        store.close()
        gone = not os.path.exists(os.path.join(base, "LOCK"))
        st.open_persistent_hybrid_index(make_config(lib, st, base)).close()
        return [held == str(os.getpid()), gone]

    assert run_both(tmp_path, scenario) == [True, True]


def test_auto_flush_on_threshold(tmp_path):
    """The background flush worker cuts segments where its timing falls,
    so the two directories are compared by their contents' search results."""
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, memtable_size_limit=512, flush_threshold=1024)
        with st.open_persistent_hybrid_index(cfg) as store:
            ids = add_docs(store, 30)
            deadline = time.time() + 5
            while time.time() < deadline and store.segments.count() == 0:
                time.sleep(0.05)
            assert store.segments.count() >= 1
            res = store.new_search().with_text("number").with_k(50).execute()
            return [ids, sorted(hits(res))]

    run_both(tmp_path, scenario, files=False)


def test_remove_from_memtable(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            ids = add_docs(store, 5)
            assert store.remove(ids[0])
            res = store.new_search().with_text("number").with_k(20).execute()
            assert ids[0] not in [r.id for r in res]
            assert not store.remove(99999)
            return [hits(res)]

    run_both(tmp_path, scenario)


def test_compaction_merges_for_real(tmp_path):
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, compaction_threshold=3, memtable_size_limit=4096)
        with st.open_persistent_hybrid_index(cfg) as store:
            all_ids = []
            for batch in range(3):
                all_ids.extend(add_docs(store, 5, start=batch * 5))
                store.flush()
            assert store.segments.count() == 3
            store.maybe_compact()
            assert store.segments.count() == 1
            out = []
            for i, doc_id in enumerate(all_ids):
                res = store.new_search().with_vector([float(i), 0, 0, 0]).with_k(1).execute()
                assert res[0].id == doc_id, f"vector lost doc {i}"
                out.append(hits(res))
            text = store.new_search().with_text("number").with_k(50).execute()
            assert len(text) == 15
            meta = store.new_search().with_metadata(lib.eq("cat", "even")).with_k(50).execute()
            assert len(meta) == 8
            return [out, hits(text), sorted(hits(meta))]

    run_both(tmp_path, scenario)


def test_compaction_below_threshold_is_noop(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base, compaction_threshold=5)) \
                as store:
            add_docs(store, 3)
            store.flush()
            assert store.segments.count() == 1
            store.maybe_compact()
            return [store.segments.count()]

    assert run_both(tmp_path, scenario) == [1]


def test_segment_lazy_load_and_evict(tmp_path):
    def scenario(lib, st, _, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        add_docs(store, 5)
        store.close()
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store2:
            seg = store2.segments.list()[0]
            cached = [seg.is_cached]
            first = store2.new_search().with_text("number").with_k(5).execute()
            cached.append(seg.is_cached)
            seg.evict_cache()
            cached.append(seg.is_cached)
            again = store2.new_search().with_text("number").with_k(5).execute()
            assert len(again) == 5
            return [cached, hits(first), hits(again)]

    assert run_both(tmp_path, scenario)[0] == [False, True, False]


def test_search_spans_memtables_and_segments(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            ids_a = add_docs(store, 5)
            store.flush()
            ids_b = add_docs(store, 5, start=100)
            res = store.new_search().with_text("number").with_k(20).execute()
            got = {r.id for r in res}
            assert set(ids_a) <= got and set(ids_b) <= got
            vec = store.new_search().with_vector([101.0, 0, 0, 0]).with_k(3).execute()
            return [hits(res), hits(vec)]

    run_both(tmp_path, scenario)


def test_closed_storage_errors(tmp_path):
    def scenario(lib, st, _, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        store.close()
        with pytest.raises(st.StorageClosedError):
            store.add(np.zeros(4, dtype=np.float32), "x", None)
        with pytest.raises(st.StorageClosedError):
            store.new_search()
        store.close()  # idempotent
        return []

    run_both(tmp_path, scenario)


def test_trained_template_propagates(tmp_path, monkeypatch):
    """The port's IVFPQ template trains by loading the reference's trained
    template bytes, so both stores hold the same quantizers."""
    rng = np.random.default_rng(42)
    train = rng.normal(size=(40, 8)).astype(np.float32)
    blob = {}

    def scenario(lib, st, _, base):
        cfg = st.StorageConfig(
            base_dir=str(base), memtable_size_limit=2048,
            vector_index_factory=lambda: lib.IVFPQIndex(8, lib.DistanceKind.L2, nlist=2, m=2,
                                                        nbits=2, **_dev(lib)),
            text_index_factory=lambda: lib.BM25SearchIndex(**_dev(lib)),
            metadata_index_factory=lib.RoaringMetadataIndex,
        )
        with st.open_persistent_hybrid_index(cfg) as store:
            store.train(train)
            blob.setdefault("ref", store._trained_vector_blob)
            for i in range(30):
                store.add(train[i % 40], f"doc {i}", {"i": i})
            n_mem = store.memtables.count()
            res = store.new_search().with_vector(train[0]).with_k(3).with_nprobes(2).execute()
            assert len(res) == 3
            return [n_mem, hits(res)]

    monkeypatch.setattr(comet_tpu_torch.IVFPQIndex, "train",
                        lambda self, vectors, max_iter=20: self.read_from(io.BytesIO(blob["ref"])))
    run_both(tmp_path, scenario)


def test_stats(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            add_docs(store, 5)
            s1 = store.stats()
            assert s1["memtables"] >= 1 and s1["memtable_bytes"] > 0
            store.flush()
            s2 = store.stats()
            assert s2["segments"] >= 1 and s2["segment_bytes"] > 0
            return [s1, {k: v for k, v in s2.items() if k != "segment_bytes"}]

    run_both(tmp_path, scenario)


def test_wal_recovers_unflushed_writes(tmp_path):
    def scenario(lib, st, _, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        ids = add_docs(store, 6)
        removed = ids[2]
        store.remove(removed)
        _simulate_crash(store)
        wal = dir_bytes(base)
        store2 = st.open_persistent_hybrid_index(make_config(lib, st, base))
        try:
            a = store2.new_search().with_text("number").with_k(20).execute()
            assert sorted(r.id for r in a) == sorted(set(ids) - {removed})
            b = store2.new_search().with_vector([4.0, 0, 0, 0]).with_k(1).execute()
            assert b[0].id == ids[4]
            c = store2.new_search().with_metadata(lib.eq("cat", "even")).with_k(20).execute()
            assert all(r.id in ids for r in c)
            return [sorted(wal), wal, hits(a), hits(b), sorted(hits(c))]
        finally:
            store2.close()

    run_both(tmp_path, scenario)


def test_wal_cleaned_after_flush_and_close(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            add_docs(store, 5)
            had = any(f.startswith("wal_") for f in os.listdir(base))
            store.flush()
        return [had, any(f.startswith("wal_") for f in os.listdir(base))]

    assert run_both(tmp_path, scenario) == [True, False]


def test_wal_disabled(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base, wal_enabled=False)) \
                as store:
            add_docs(store, 3)
            return [any(f.startswith("wal_") for f in os.listdir(base))]

    assert run_both(tmp_path, scenario) == [False]


def test_stale_lock_takeover(tmp_path):
    def scenario(lib, st, _, base):
        st.open_persistent_hybrid_index(make_config(lib, st, base)).close()
        with open(os.path.join(base, "LOCK"), "w") as f:
            f.write("999999999")
        store2 = st.open_persistent_hybrid_index(make_config(lib, st, base))
        held = open(os.path.join(base, "LOCK")).read()
        store2.close()
        return [held == str(os.getpid())]

    assert run_both(tmp_path, scenario) == [True]


def test_auto_ids_do_not_collide_after_reopen(tmp_path):
    def scenario(lib, st, node_mod, base):
        store = st.open_persistent_hybrid_index(make_config(lib, st, base))
        ids = add_docs(store, 4)
        store.close()
        node_mod._reset_node_id_counter()  # a fresh process
        store2 = st.open_persistent_hybrid_index(make_config(lib, st, base))
        try:
            new_id = store2.add(np.array([9, 9, 9, 9], dtype=np.float32), "fresh doc",
                                {"num": 99})
            assert new_id not in ids
            res = store2.new_search().with_text("fresh").with_k(5).execute()
            assert [r.id for r in res] == [new_id]
            return [ids, new_id, hits(res)]
        finally:
            store2.close()

    run_both(tmp_path, scenario)


def test_concurrent_flush_no_duplicate_segments(tmp_path):
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, memtable_size_limit=256, flush_threshold=10**9)
        with st.open_persistent_hybrid_index(cfg) as store:
            add_docs(store, 40)
            threads = [threading.Thread(target=store.flush) for _ in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            total = (sum(seg.get_index().count() for seg in store.segments.list())
                     + sum(mt.index.count() for mt in store.memtables.list_all()))
            assert total == 40
            return [store.segments.count()]

    run_both(tmp_path, scenario)


# -- the engine scenarios of tests/test_bloom_wal_batch.py ---------------------------


def test_engine_add_batch_search_and_recovery(tmp_path):
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, wal_fsync=True, memtable_size_limit=1 << 20)
        with st.open_persistent_hybrid_index(cfg) as store:
            docs = [(np.array([i, 0, 0, 0], np.float32), f"batch doc {i}", {"num": i})
                    for i in range(64)]
            ids = store.add_batch(docs)
            assert len(ids) == 64 and len(set(ids)) == 64
            assert store.add_batch([]) == []
            a = store.new_search().with_vector([5.0, 0, 0, 0]).with_k(1).execute()
            assert a[0].id == ids[5]
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            b = store.new_search().with_vector([7.0, 0, 0, 0]).with_k(1).execute()
            assert b[0].id == ids[7]
            return [ids, hits(a), hits(b)]

    run_both(tmp_path, scenario)


def test_engine_add_batch_wal_replay_after_crash(tmp_path):
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, wal_fsync=True, memtable_size_limit=1 << 20)
        store = st.open_persistent_hybrid_index(cfg)
        docs = [(np.array([i, 0, 0, 0], np.float32), f"crash doc {i}", None) for i in range(10)]
        ids = store.add_batch(docs)
        store._stop.set()
        os.remove(os.path.join(store.provider.base_dir, "LOCK"))
        wal = dir_bytes(base)
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as again:
            res = again.new_search().with_vector([3.0, 0, 0, 0]).with_k(1).execute()
            assert res[0].id == ids[3]
            return [wal, hits(res)]

    run_both(tmp_path, scenario)


def test_engine_add_batch_rotates_memtables(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            docs = [(np.array([i, 0, 0, 0], np.float32), f"doc {i}", {"num": i})
                    for i in range(40)]
            ids = store.add_batch(docs)
            assert store.memtables.count() > 1
            got = store.new_search().with_metadata().with_vector([11.0, 0, 0, 0]).with_k(1) \
                .execute()
            assert got[0].id == ids[11]
            return [store.memtables.count(), hits(got)]

    run_both(tmp_path, scenario)


def test_segment_bloom_written_and_point_lookup_skips(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            ids = add_docs(store, 12)
            store.flush()
            seg = store.segments.list()[0]
            assert os.path.exists(store.provider.bloom_path(seg.segment_id))
            store.segments.evict_all_caches()
            found = [store.has_document(ids[0]), store.has_document(10**9 + 7),
                     store.has_document(ids[-1])]
            # an absent id loads no segment its bloom sidecar rules out
            loaded = [s.is_cached for s in store.segments.list()]
            return [found, loaded]

    assert run_both(tmp_path, scenario)[0] == [True, False, True]


def test_bloom_sidecar_survives_reopen_and_compaction(tmp_path):
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, compaction_threshold=2, memtable_size_limit=1 << 20)
        with st.open_persistent_hybrid_index(cfg) as store:
            ids = add_docs(store, 6)
            store.flush()
            add_docs(store, 6, start=100)
            store.flush()
            assert store.segments.count() == 2
            store.maybe_compact()
            assert store.segments.count() == 1
            sid = store.segments.list()[0].segment_id
            assert os.path.exists(store.provider.bloom_path(sid))
            blooms = [f for f in os.listdir(base) if f.startswith("bloom_")]
            assert len(blooms) == 1
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            return [store.has_document(ids[0]), store.has_document(424242)]

    assert run_both(tmp_path, scenario) == [True, False]


def test_missing_bloom_sidecar_is_not_fatal(tmp_path):
    def scenario(lib, st, _, base):
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            ids = add_docs(store, 5)
            store.flush()
            os.remove(store.provider.bloom_path(store.segments.list()[0].segment_id))
        with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
            return [store.has_document(ids[2])]

    assert run_both(tmp_path, scenario) == [True]


# -- beyond the reference's scenarios -------------------------------------------------


def test_remove_flushed_documents_writes_tombstones(tmp_path):
    """Removing flushed documents writes the TOMBSTONES log; segment reads
    mask them; compaction consumes them; a reopen reads them back."""
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, compaction_threshold=2, memtable_size_limit=1 << 20)
        store = st.open_persistent_hybrid_index(cfg)
        ids = add_docs(store, 6)
        store.flush()
        ids += add_docs(store, 6, start=100)
        store.flush()
        assert store.remove(ids[1]) and store.remove(ids[8])
        tomb = open(os.path.join(base, "TOMBSTONES"), "rb").read()
        a = store.new_search().with_text("number").with_k(50).execute()
        assert not {ids[1], ids[8]} & {r.id for r in a}
        _simulate_crash(store)
        store = st.open_persistent_hybrid_index(make_config(lib, st, base, compaction_threshold=2))
        b = store.new_search().with_vector([1.0, 0, 0, 0]).with_k(3).execute()
        gone = [store.has_document(ids[1]), store.has_document(ids[8])]
        store.maybe_compact()
        c = store.new_search().with_text("number").with_k(50).execute()
        store.close()
        return [tomb, hits(a), hits(b), gone, hits(c)]

    run_both(tmp_path, scenario)


def test_search_after_flushed_removals_can_return_fewer_than_k(tmp_path):
    """Pins a reference behaviour that the port keeps for parity (ROADMAP
    Queue 3): a segment chooses its top k before the store drops its
    tombstoned ids, so live documents ranked past k in that segment never
    come back. Twelve documents at (i, 0), flushed; the three nearest (0, 0)
    removed; a search of (0, 0) at k = 5 returns two hits, ids 4 and 5,
    though nine live documents remain."""
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, memtable_size_limit=1 << 20,
                          vector=lambda: lib.FlatIndex(2, lib.DistanceKind.L2, **_dev(lib)))
        with st.open_persistent_hybrid_index(cfg) as store:
            ids = [store.add(np.array([i, 0], dtype=np.float32), f"document {i}", {"num": i})
                   for i in range(12)]
            store.flush()
            for doc_id in ids[:3]:
                assert store.remove(doc_id)
            res = store.new_search().with_vector([0.0, 0.0]).with_k(5).execute()
            live = sum(store.has_document(d) for d in ids)
            return [ids, hits(res), live]

    ids, res, live = run_both(tmp_path, scenario)
    assert ids == list(range(1, 13)) and live == 9
    assert [i for i, _ in res] == [4, 5]


def _kind_factory(lib, kind):
    L2 = lib.DistanceKind.L2
    if kind == "flat":
        return lambda: lib.FlatIndex(4, L2, **_dev(lib))
    if kind == "ivf":
        return lambda: lib.IVFIndex(4, 2, L2, **_dev(lib))
    if kind == "pq":
        return lambda: lib.PQIndex(4, L2, m=2, nbits=2, **_dev(lib))
    if kind == "ivfpq":
        return lambda: lib.IVFPQIndex(4, L2, nlist=2, m=2, nbits=2, store_originals=True,
                                      **_dev(lib))
    return lambda: lib.HNSWIndex(4, L2, lib.HNSWConfig(m=4, ef_construction=8, ef_search=16),
                                 **_dev(lib))


@pytest.mark.parametrize("kind", ["flat", "ivf", "pq", "ivfpq", "hnsw"])
def test_compaction_of_each_vector_index_kind(tmp_path, monkeypatch, kind):
    """A store of each vector index kind over integer vectors (every
    distance exact), flushed into three segments with an overwritten and a
    removed document, compacted and reopened. The trained kinds train the
    port's template from the reference's template bytes (a reopened store
    is trained again: the template is not persisted). HNSW searches with
    the graph beam on both sides, the reference's route on the CPU."""
    rng = np.random.default_rng(7)
    vecs = rng.integers(0, 16, size=(36, 4)).astype(np.float32)
    queries = rng.integers(0, 16, size=(5, 4)).astype(np.float32)
    blob = {}

    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, vector=_kind_factory(lib, kind), compaction_threshold=3,
                          memtable_size_limit=1 << 20)
        with st.open_persistent_hybrid_index(cfg) as store:
            if kind in ("ivf", "pq", "ivfpq"):
                store.train(vecs)
                blob.setdefault("ref", store._trained_vector_blob)
            for seg in range(3):
                for i in range(seg * 12, seg * 12 + 12):
                    store.add_with_id(i + 1, vecs[i], f"doc {i} words {i % 5}",
                                      {"num": i, "cat": "abc"[i % 3]})
                if seg == 2:
                    store.add_with_id(3, vecs[30], "doc three again", {"num": 3, "cat": "c"})
                store.flush()
            assert store.remove(5)
            store.maybe_compact()
            assert store.segments.count() == 1
            out = [store.stats()["segments"]]
            for q in queries:
                out.append(hits(store.new_search().with_vector(q).with_k(6).with_nprobes(2)
                                .execute()))
                out.append(hits(store.new_search().with_vector(q).with_text("words 2")
                                .with_metadata(lib.eq("cat", "a")).with_k(6).with_nprobes(2)
                                .execute()))
        with st.open_persistent_hybrid_index(make_config(lib, st, base,
                                                         vector=_kind_factory(lib, kind))) as s2:
            if kind in ("ivf", "pq", "ivfpq"):
                s2.train(vecs)
            for q in queries:
                out.append(hits(s2.new_search().with_vector(q).with_k(6).with_nprobes(2)
                                .execute()))
        return out

    monkeypatch.setattr(port_hnsw, "BLOCKED_TABLE_BYTES_MAX", 0)
    cls = {"ivf": "IVFIndex", "pq": "PQIndex", "ivfpq": "IVFPQIndex"}.get(kind)
    if cls:
        monkeypatch.setattr(getattr(comet_tpu_torch, cls), "train",
                            lambda self, v, max_iter=20: self.read_from(io.BytesIO(blob["ref"])))
    run_both(tmp_path, scenario)


def test_text_merge_follows_the_reference_lossy_rejoin(tmp_path):
    """Compaction re-adds a document's text as its tokens joined by " ",
    which re-tokenizes whitespace runs (the reference's merge, ROADMAP
    Queue 3): 'a b' has 3 tokens, 'a   b' after a merge; 'hello, world'
    4 tokens, 5 after. The port reproduces it."""
    def scenario(lib, st, _, base):
        cfg = make_config(lib, st, base, compaction_threshold=2, memtable_size_limit=1 << 20)
        with st.open_persistent_hybrid_index(cfg) as store:
            store.add_with_id(1, None, "a b", None)
            store.flush()
            store.add_with_id(2, None, "hello, world", None)
            store.flush()
            segs = store.segments.list()
            before = [_tokens(segs[0].get_index()._text, 1), _tokens(segs[1].get_index()._text, 2)]
            store.maybe_compact()
            text = store.segments.list()[0].get_index()._text
            after = [_tokens(text, 1), _tokens(text, 2)]
            res = store.new_search().with_text("a").with_k(5).execute()
            return [before, after, hits(res)]

    before, after, _ = run_both(tmp_path, scenario)
    assert before == [["a", " ", "b"], ["hello", ",", " ", "world"]]
    assert after == [["a", "   ", "b"], ["hello", " ", ",", "   ", "world"]]


def _tokens(text_index, doc_id):
    if hasattr(text_index, "doc_tokens"):
        return text_index.doc_tokens(doc_id)
    return list(text_index._doc_tokens[doc_id])


def _crashed_store(lib, st, base):
    """A store left as a crashed process leaves it: two segments, a removal
    of a flushed document in TOMBSTONES, unflushed adds and a removal in
    its WAL."""
    store = st.open_persistent_hybrid_index(make_config(lib, st, base,
                                                        memtable_size_limit=1 << 20))
    for i in range(20):
        store.add_with_id(i + 1, np.array([i, i % 3, 0, 1], np.float32),
                          f"doc {i} about {'cats' if i % 2 else 'dogs'}", {"num": i})
        if i in (7, 13):
            store.flush()
    store.remove(4)
    store.remove(17)
    _simulate_crash(store)


def _reopened_results(lib, st, base):
    with st.open_persistent_hybrid_index(make_config(lib, st, base)) as store:
        out = [hits(store.new_search().with_vector([float(i), 0, 0, 1]).with_k(4).execute())
               for i in (2, 4, 17)]
        out.append(hits(store.new_search().with_text("cats").with_k(30).execute()))
        out.append(hits(store.new_search().with_vector([3.0, 0, 0, 1]).with_text("dogs")
                        .with_metadata(lib.gte("num", 5)).with_k(5).execute()))
        out.append([store.has_document(d) for d in (4, 5, 17, 18)])
        return out


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_crashed_directory_opens_in_the_other_package(tmp_path, writer, reader):
    """The state carried across is the store directory: one written by
    `writer` and left by a crash opens in `reader` with the results the
    writer's own reopen gives."""
    lib_w, st_w, _ = PKGS[writer]
    lib_r, st_r, _ = PKGS[reader]
    _crashed_store(lib_w, st_w, tmp_path / "a")
    _crashed_store(lib_w, st_w, tmp_path / "b")
    assert any(f.startswith("wal_") for f in os.listdir(tmp_path / "a"))
    assert os.path.exists(tmp_path / "a" / "TOMBSTONES")
    want = _reopened_results(lib_w, st_w, tmp_path / "a")
    got = _reopened_results(lib_r, st_r, tmp_path / "b")
    _same(got, want)
    assert want[-1] == [False, True, False, True]
    assert_same_files(tmp_path / "a", tmp_path / "b")


def test_merge_results_best_score_each_way():
    from comet_tpu.hybrid import HybridSearchResult as RefResult
    from comet_tpu_torch.hybrid import HybridSearchResult

    pairs = [[(1, 0.5), (2, 0.9), (3, 0.1)], [(2, 0.3), (4, 0.9)]]
    r = [[RefResult(i, s) for i, s in lst] for lst in pairs]
    p = [[HybridSearchResult(i, s) for i, s in lst] for lst in pairs]
    for descending in (True, False):
        for k in (0, 2, 10):
            want = rstore.merge_results(r, k, descending=descending)
            got = pstore.merge_results(p, k, descending=descending)
            assert [(x.id, x.score) for x in got] == [(x.id, x.score) for x in want]


def test_port_store_exports():
    for name in ("StorageConfig", "default_storage_config", "PersistentHybridIndex",
                 "open_persistent_hybrid_index"):
        assert getattr(comet_tpu_torch, name) is getattr(pstore, name)
    assert pstore.default_storage_config("x") == pstore.StorageConfig(base_dir="x")
    assert (pstore.DEFAULT_MEMTABLE_SIZE_LIMIT, pstore.DEFAULT_FLUSH_THRESHOLD,
            pstore.DEFAULT_COMPACTION_INTERVAL, pstore.DEFAULT_COMPACTION_THRESHOLD) == (
        rstore.DEFAULT_MEMTABLE_SIZE_LIMIT, rstore.DEFAULT_FLUSH_THRESHOLD,
        rstore.DEFAULT_COMPACTION_INTERVAL, rstore.DEFAULT_COMPACTION_THRESHOLD)


def test_card_factories_raise_without_a_card(tmp_path):
    """The store detects no device: factories that make card indexes (the
    port's default) raise where there is no card; nothing moves to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    cfg = pstore.StorageConfig(
        base_dir=str(tmp_path / "store"),
        vector_index_factory=lambda: comet_tpu_torch.FlatIndex(4, comet_tpu_torch.DistanceKind.L2),
        text_index_factory=comet_tpu_torch.BM25SearchIndex,
        metadata_index_factory=comet_tpu_torch.RoaringMetadataIndex)
    with pytest.raises(comet_tpu_torch.InvalidConfigError):
        pstore.open_persistent_hybrid_index(cfg)


@pytest.mark.parametrize("block", [1, 777, 1 << 20])
def test_segment_files_deflate_in_blocks(tmp_path, monkeypatch, block):
    """write_segment_files deflates each stream in blocks on a thread pool
    into one gzip member: whatever the block size, the files hold exactly
    the streams write_to makes, with gzip.open's level-9 header, and the
    reference's segment loader reads them."""
    from comet_tpu_torch.storage import segment

    monkeypatch.setattr(segment, "GZIP_BLOCK", block)
    rng = np.random.default_rng(3)
    index = comet_tpu_torch.new_hybrid_search_index(
        comet_tpu_torch.FlatIndex(8, comet_tpu_torch.DistanceKind.L2, device="cpu"),
        comet_tpu_torch.BM25SearchIndex(device="cpu"), comet_tpu_torch.RoaringMetadataIndex())
    vecs = rng.integers(0, 256, size=(300, 8)).astype(np.float32)
    for i in range(300):
        index.add_with_id(i + 1, vecs[i], f"doc {i} of {i % 7} words", {"num": i})
    want = {k: io.BytesIO() for k in ("hybrid", "vector", "text", "metadata")}
    index.write_to(want["hybrid"], want["vector"], want["text"], want["metadata"])
    paths = {k: str(tmp_path / f"{k}_000000.bin.gz") for k in want}
    _, _, sizes = segment.write_segment_files(paths, index)
    for kind, path in paths.items():
        raw = open(path, "rb").read()
        assert raw[:4] == b"\x1f\x8b\x08\x08" and raw[8:10] == b"\x02\xff"
        assert raw[10:raw.index(b"\x00", 10)] == f"{kind}_000000.bin".encode()
        assert gzip.decompress(raw) == want[kind].getvalue()
        assert sizes[kind] == len(want[kind].getvalue())
    ref = rstore.segment.SegmentMetadata(0, paths, lambda: comet_tpu.new_hybrid_search_index(
        comet_tpu.FlatIndex(8, comet_tpu.DistanceKind.L2), comet_tpu.BM25SearchIndex(),
        comet_tpu.RoaringMetadataIndex())).get_index()
    assert ref.count() == 300
    got = ref.new_search().with_vector(vecs[5]).with_k(1).execute()
    assert got[0].id == 6
