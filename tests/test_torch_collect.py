"""The collect of a device handle maps result slots to ids on the device.

`collect_device_handle` gathers the ids from the store's device id map
(`SlotStore.device_id_map`: the uint32 ids' bits as int32, one entry more
holding INVALID_ID for an empty slot) before it copies anything out. The
plain reference here is the numpy map it replaced, kept in this file:
`ids_snap[slots]` where the slot is a hit, INVALID_ID where it is empty.
Every index whose launch builds a "dev" handle (flat, IVF on both routes,
PQ) and the fluent flat search must return exactly what that map gives,
with ids at and above 2^31 (so that the int32 bits round-trip), soft
deleted rows, k above the live rows and the scores left on the device.

The map is captured at launch, so a `search_stream` batch returns the ids
of the index at its submission even when a flush rewrites the host ids
before the batch is collected.
"""

import io

import numpy as np
import pytest
import torch

import comet_tpu_torch as ct
from comet_tpu_torch.indexes import base, flat, ivf, pq
from comet_tpu_torch.indexes.base import INVALID_ID
from comet_tpu_torch.ops.topk import IDX_SENTINEL

N, D, Q = 48, 8, 6
# ids on both sides of 2^31, the largest valid one included, in no order
IDS = np.concatenate([
    np.array([0xFFFFFFFE, 0x80000000, 0x7FFFFFFF, 0x80000001, 0, 1], np.uint32),
    np.random.default_rng(5).choice(np.arange(2, 2**32 - 2, 7919, dtype=np.uint64),
                                    N - 6, replace=False).astype(np.uint32),
])
DELETED = IDS[[1, 4, 9, 20, 33]]
KINDS = ["flat", "ivf_dense", "ivf_sparse", "pq"]
MODULES = {"flat": flat, "ivf_dense": ivf, "ivf_sparse": ivf, "pq": pq}
CASES = {
    "deleted": dict(k=10),                        # soft-deleted rows are never returned
    "k_above_live": dict(k=N + 5),                # empty slots: INVALID_ID and +inf
    "scores_on_device": dict(k=10, wire_scores=False),
}


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 16, size=(N, D)).astype(np.float32),
            rng.integers(0, 16, size=(Q, D)).astype(np.float32) + 0.25)


def _index(kind, x, monkeypatch):
    if kind == "flat":
        idx = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    elif kind.startswith("ivf"):
        monkeypatch.setenv("COMET_IVF_SPARSE", "1" if kind == "ivf_sparse" else "0")
        idx = ct.IVFIndex(D, 8, ct.DistanceKind.L2, device="cpu")
        idx.train(x)
    else:
        idx = ct.PQIndex(D, ct.DistanceKind.L2, m=4, nbits=4, device="cpu")
        idx.train(x)
    idx.add_batch(x, ids=IDS)
    for i in DELETED:
        idx.remove(int(i))
    return idx


def host_collect(ids_snap):
    """The numpy slot -> id map that the collect ran on the host before."""
    def collect(handle):
        if handle[0] == "empty":
            return (np.full((handle[1], 0), INVALID_ID, dtype=np.uint32),
                    np.zeros((handle[1], 0), dtype=np.float32))
        _, s, i, _ = handle
        slots = i.cpu().numpy()
        scores = np.zeros(slots.shape, dtype=np.float32) if s is None else s.cpu().numpy()
        hit = slots != IDX_SENTINEL
        ids = np.where(hit, ids_snap[np.where(hit, slots, 0)], INVALID_ID)
        return ids.astype(np.uint32), scores
    return collect


def _search(kind, idx, q, k, **knobs):
    extra = {"nprobes": 4 if kind == "ivf_sparse" else 8} if kind.startswith("ivf") else {}
    return idx.search_batch(q, k=k, **extra, **knobs)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("kind", KINDS)
def test_batch_ids_and_scores_equal_the_host_map(kind, case, monkeypatch):
    x, q = _data()
    idx = _index(kind, x, monkeypatch)
    got = _search(kind, idx, q, **CASES[case])
    with monkeypatch.context() as m:
        m.setattr(MODULES[kind], "collect_device_handle", host_collect(idx._store.ids.copy()))
        want = _search(kind, idx, q, **CASES[case])
    assert got[0].dtype == np.uint32 and got[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.isin(got[0], DELETED).any()
    assert (got[0] >= 2**31).any()                 # the high ids did come back
    if case == "k_above_live":
        empty = got[0] == INVALID_ID
        assert empty.any() and np.isinf(got[1][empty]).all()
    if case == "scores_on_device":
        assert not got[1].any()


@pytest.mark.parametrize("case", ["deleted", "k_above_live"])
def test_fluent_flat_results_equal_the_host_map(case, monkeypatch):
    x, q = _data(1)
    idx = _index("flat", x, monkeypatch)

    def run():
        res = (idx.new_search().with_query(q[0]).with_query(q[1])
               .with_k(CASES[case]["k"]).execute())
        return [r.node.id for r in res], [r.score for r in res]

    got = run()
    with monkeypatch.context() as m:
        m.setattr(flat, "collect_device_handle", host_collect(idx._store.ids.copy()))
        want = run()
    assert got == want
    assert got[0] and not set(got[0]) & set(DELETED.tolist())


def test_a_stream_batch_keeps_the_ids_of_its_submission():
    """A batch launched before a remove and a flush, collected after them,
    returns the ids the index had at its launch (the flush compacts the
    slots and rewrites the host ids in place)."""
    x, q = _data(2)
    idx = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    idx.add_batch(x, ids=IDS)
    before = idx.search_batch(q, k=10)
    ids_before = idx._store.ids.copy()

    def batches():
        yield q
        idx.remove(int(IDS[0]))          # slot 0: every later slot moves down at the flush
        idx.flush()
        yield q

    first, second = list(idx.search_stream(batches(), k=10, depth=2))
    assert not np.array_equal(idx._store.ids[:N - 1], ids_before[:N - 1])
    for got, want in zip(first, before):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(second, idx.search_batch(q, k=10)):
        np.testing.assert_array_equal(got, want)
    assert not np.shares_memory(idx._store.device_id_map().numpy(), idx._store.ids)


def test_the_id_map_follows_adds_in_place_and_other_changes_by_upload():
    """An add or a remove writes its rows into a current map in place (the
    same tensor, equal to a fresh upload); a flush or a capacity growth
    uploads a new tensor and leaves the old one as it was. The last entry
    is INVALID_ID's bits."""
    x, _ = _data(3)
    idx = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    idx.add_batch(x[:20], ids=IDS[:20])
    store = idx._store
    m = store.device_id_map()
    assert m.dtype == torch.int32 and m.shape == (store.capacity + 1,)
    idx.add_batch(x[20:], ids=IDS[20:])
    idx.remove(int(IDS[3]))
    assert store.device_id_map() is m
    want = np.append(store.ids, INVALID_ID)
    np.testing.assert_array_equal(m.numpy().view(np.uint32), want)
    assert m[-1].item() == -1

    idx.flush()
    fresh = store.device_id_map()
    assert fresh is not m
    np.testing.assert_array_equal(m.numpy().view(np.uint32), want)      # untouched
    np.testing.assert_array_equal(fresh.numpy().view(np.uint32),
                                  np.append(store.ids, INVALID_ID))
    idx.add_batch(np.repeat(x, 30, axis=0), ids=range(10**6, 10**6 + 30 * N))   # grows to 2048
    grown = store.device_id_map()
    assert grown is not fresh and grown.shape == (2049,)
    np.testing.assert_array_equal(grown.numpy().view(np.uint32), np.append(store.ids, INVALID_ID))


def test_a_filtered_search_after_read_from_uses_the_ids_read():
    """The ids' device copies belong to the slot store, so an index that
    reads another's file (a new store, its version counted from 0 again)
    never meets the copies of the store it replaced."""
    x, q = _data(4)
    idx = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    idx.add_batch(x, ids=range(1, N + 1))
    idx.search_batch(q, k=5, document_ids=range(1, N + 1))      # both copies made
    other = ct.FlatIndex(D, ct.DistanceKind.L2, device="cpu")
    other.add_batch(x, ids=range(5001, 5001 + N))
    f = io.BytesIO()
    other.write_to(f)
    f.seek(0)
    idx.read_from(f)
    allowed = list(range(5001, 5001 + N, 2))
    got = idx.search_batch(q, k=5, document_ids=allowed)
    want = other.search_batch(q, k=5, document_ids=allowed)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert np.isin(got[0], allowed).all()


def test_the_filter_expands_against_the_id_maps_int32_bits():
    """`_words_ok` reads the ids as the map holds them: ids at and above
    2^31 are negative int32 values and must still fall outside a filter's
    span, and ids inside it take their word's bit."""
    words = np.random.default_rng(6).integers(0, 2**32, size=8, dtype=np.uint64)
    ids = np.array([0, 5, 31, 32, 200, 255, 256, 4096, 0x7FFFFFFF, 0x80000000, 0x80000005,
                    0xFFFFFFE0, 0xFFFFFFFE], np.uint32)
    valid = np.ones(len(ids), bool)
    valid[4] = False
    got = base._words_ok(torch.from_numpy(words.astype(np.int64)),
                         torch.from_numpy(ids.view(np.int32)), torch.from_numpy(valid))
    bit = (words[np.minimum(ids >> 5, 7)] >> (ids & 31).astype(np.uint64)) & 1
    np.testing.assert_array_equal(got.numpy(), valid & (ids < 256) & (bit == 1))


def test_an_empty_slot_maps_to_invalid_and_the_collect_counts_nothing_off():
    """The collect alone, on a hand-made handle: slots at the sentinel and
    at the map's edge."""
    id_map = torch.from_numpy(np.array([7, 0xFFFFFFFE, 0x80000000, 0xFFFFFFFF],
                                       np.uint32).view(np.int32))
    slots = torch.tensor([[2, IDX_SENTINEL, 0], [1, 1, IDX_SENTINEL]], dtype=torch.int32)
    scores = torch.tensor([[1.0, float("inf"), 3.0], [0.5, 0.5, float("inf")]])
    ids, s = base.collect_device_handle(("dev", scores, slots[:, :3], id_map))
    np.testing.assert_array_equal(ids, np.array([[0x80000000, INVALID_ID, 7],
                                                 [0xFFFFFFFE, 0xFFFFFFFE, INVALID_ID]],
                                                np.uint32))
    np.testing.assert_array_equal(s, scores.numpy())
