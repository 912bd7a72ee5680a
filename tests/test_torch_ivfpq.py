"""comet_tpu_torch.IVFPQIndex on the CPU against comet_tpu.IVFPQIndex.

The same data, made from a seeded numpy generator, go through both
packages. On the CPU the reference always searches by its LUT walk; the
port's routes are the sparse scan (forced by COMET_IVFPQ_SPARSE=1), the
dense scan, and the walk (`pq.DECODED_BYTES_MAX` patched to 0). Bars:
- training on integer data: centroids, codebooks, codes and assignments
  array-equal;
- integer state (integer centroids, codebooks, rows and queries, OPQ
  rotations that are signed permutations), carried across by
  `IVFPQIndex.load_reference_state`: every distance is exact, so the walk
  and the dense route give ids and scores array-equal to the reference's
  search, and the sparse route scores array-equal with ids equal below
  each row's k-th score (it breaks ties at the k-th score in scan order,
  as the reference's sparse scan does);
- Gaussian state: the dense route with nrefine against the reference's
  `ivf_topk_pipeline` (kb_cap, interpret mode) and `_refine_device`, and
  the sparse route against the reference's `ivf_sparse_pipeline`
  (interpret mode), each on the reference's own reconstruction: ids equal,
  scores allclose(1e-4, 1e-4);
- CIPQ files byte-identical both ways.
"""

import io
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest

import comet_tpu
from comet_tpu.indexes import ivfpq as ref_ivfpq
from comet_tpu.io import serial as ref_serial
from comet_tpu.ops import ivf_sparse as ref_sp
from comet_tpu.ops import pallas_scan as ref_ps
import comet_tpu_torch
from comet_tpu_torch import DistanceKind, InvalidConfigError, IVFPQIndex, NotTrainedError
from comet_tpu_torch.indexes import ivfpq, pq
from comet_tpu_torch.io.serial import SerializationError
from comet_tpu_torch.ops import ivf_sparse as sp

D, M, NBITS, KSUB, NLIST, N, Q, K = 16, 4, 4, 16, 8, 600, 12, 10
IDS = list(range(1, N + 1))
INVALID = 0xFFFFFFFF
SENT = 2**31 - 1


def _ints(rng, shape, hi=8):
    return rng.integers(0, hi, size=shape).astype(np.float32)


def _signed_perm(rng, d=D):
    return (np.eye(d, dtype=np.float32)[rng.permutation(d)]
            * rng.choice([-1.0, 1.0], d)).astype(np.float32)


@lru_cache(maxsize=None)
def _int_state(seed, kind="l2", rot=False, originals=True):
    """A reference index with integer centroids and codebooks (and a
    signed-permutation rotation), integer rows added, every 7th removed;
    its queries."""
    rng = np.random.default_rng(seed)
    ref = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind(kind), nlist=NLIST, m=M, nbits=NBITS,
                               store_originals=originals)
    ref._centroids = _ints(rng, (NLIST, D), hi=12) - 6.0
    ref._codebooks = _ints(rng, (M, KSUB, D // M), hi=4) - 2.0
    ref._rot = _signed_perm(rng) if rot else None
    ref._trained = True
    ref.add_batch(_ints(rng, (N, D), hi=12) - 6.0, ids=IDS)
    for i in IDS[::7]:
        ref.remove(i)
    return ref, _ints(rng, (Q, D), hi=12) - 6.0


def _port_of(ref, kind="l2"):
    s = ref._store
    return IVFPQIndex.load_reference_state(
        s.ids, ref._codes, ref._assign, s.valid, s.n, ref._centroids, ref._codebooks, ref._rot,
        s.vectors if ref._store_originals else None, DistanceKind(kind), device="cpu")


def _assert_same(got, want, exact=True, ties_ok=False):
    if exact:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1]), fin)
        np.testing.assert_allclose(got[1][fin], want[1][fin], rtol=1e-4, atol=1e-4)
    if ties_ok:
        below = want[1] < want[1][:, -1:]
        np.testing.assert_array_equal(got[0][below], want[0][below])
        np.testing.assert_array_equal((got[0] != INVALID).sum(1), (want[0] != INVALID).sum(1))
    else:
        np.testing.assert_array_equal(got[0], want[0])


@pytest.fixture
def route(request, monkeypatch):
    if request.param == "sparse":
        monkeypatch.setenv("COMET_IVFPQ_SPARSE", "1")
    else:
        monkeypatch.setenv("COMET_IVFPQ_SPARSE", "0")
    if request.param == "walk":
        monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)
    return request.param


def test_params_validation_and_defaults():
    for bad in (dict(nlist=0), dict(m=3), dict(m=4, nbits=0), dict(m=4, nbits=17)):
        with pytest.raises(InvalidConfigError):
            IVFPQIndex(16, device="cpu", **bad)
    idx = IVFPQIndex(16, nlist=4, m=4, nbits=4, device="cpu")
    assert (idx.nlist, idx.m, idx.nbits, idx.kind().value) == (4, 4, 4, "ivfpq")
    assert idx.default_nprobes() == 2 and not idx.trained()
    with pytest.raises(NotTrainedError):
        idx.add_batch(np.zeros((1, 16), np.float32))
    with pytest.raises(NotTrainedError):
        idx.search_batch(np.zeros((1, 16), np.float32))
    with pytest.raises(InvalidConfigError, match="nlist\\*10"):
        idx.train(np.zeros((39, 16), np.float32))
    with pytest.raises(InvalidConfigError, match="CUDA"):   # the card is the default
        IVFPQIndex(16, nlist=4, m=4, nbits=4)
    assert comet_tpu_torch.IVFPQIndex is IVFPQIndex


@pytest.mark.parametrize("kind", ["l2", "l2_squared"])
def test_training_and_ingest_match_reference_on_integers(kind):
    rng = np.random.default_rng(1)
    x = _ints(rng, (N, D), hi=16)
    ref = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind(kind), nlist=NLIST, m=M, nbits=NBITS)
    port = IVFPQIndex(D, DistanceKind(kind), nlist=NLIST, m=M, nbits=NBITS, device="cpu")
    for index in (ref, port):
        index.train(x[:400])
        index.add_batch(x, ids=IDS)
    np.testing.assert_array_equal(port._centroids, ref._centroids)
    np.testing.assert_array_equal(port._codebooks, ref._codebooks)
    np.testing.assert_array_equal(port._codes, ref._codes)
    np.testing.assert_array_equal(port._assign, ref._assign)


@lru_cache(maxsize=None)
def _ref_search(seed, kind, rot, scenario, nprobe):
    ref, q = _int_state(seed, kind, rot)
    if scenario == "flush":
        ref = _flushed(seed, kind, rot)
    return ref.search_batch(q, k=K, nprobes=nprobe, **_knobs(seed, kind, rot, scenario))


@lru_cache(maxsize=None)
def _flushed(seed, kind, rot):
    ref, _ = _int_state(seed, kind, rot)
    buf = io.BytesIO()
    ref.write_to(buf)   # flushes a copy's state through the reference's own reader
    fresh = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind(kind), nlist=NLIST, m=M,
                                 nbits=NBITS, store_originals=True)
    fresh.read_from(io.BytesIO(buf.getvalue()))
    return fresh


def _knobs(seed, kind, rot, scenario):
    if scenario != "threshold-filter":
        return {}
    ref, q = _int_state(seed, kind, rot)
    thr = float(np.median(ref.search_batch(q, k=3, nprobes=NLIST)[1][:, 2]))
    return dict(threshold=thr, document_ids=[i for i in IDS if i % 3])


@pytest.mark.parametrize("route", ["sparse", "dense", "walk"], indirect=True)
@pytest.mark.parametrize("scenario,nprobe", [("batch", 1), ("batch", 3), ("batch", NLIST),
                                             ("threshold-filter", 3), ("flush", 2)])
@pytest.mark.parametrize("kind,rot", [("l2", False), ("l2_squared", False), ("l2", True)],
                         ids=["l2", "l2sq", "opq"])
def test_routes_match_reference_on_integer_state(kind, rot, scenario, nprobe, route):
    ref, q = _int_state(2, kind, rot)
    port = _port_of(ref, kind)
    if scenario == "flush":
        port.flush()
    got = port.search_batch(q, k=K, nprobes=nprobe, **_knobs(2, kind, rot, scenario))
    want = _ref_search(2, kind, rot, scenario, nprobe)
    # the sparse route runs only below nprobe = nlist
    _assert_same(got, want, ties_ok=route == "sparse" and nprobe < NLIST)
    hits = got[0][got[0] != INVALID]
    assert len(hits) and not np.isin(hits, IDS[::7]).any()
    if scenario == "threshold-filter":
        assert len(hits) < got[0].size and (hits % 3 != 0).all()


@lru_cache(maxsize=None)
def _cosine_state():
    """A reference cosine index trained on Gaussian rows (its centroids are
    means of unit rows, as in use), and its search by the walk."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(N, D)).astype(np.float32)
    ref = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind.COSINE, nlist=NLIST, m=M, nbits=NBITS)
    ref.train(x)
    ref.add_batch(x, ids=IDS)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    return ref, q, ref.search_batch(q, k=K, nprobes=3)


@pytest.mark.parametrize("route", ["sparse", "dense", "walk"], indirect=True)
def test_cosine_routes_match_reference(route):
    """Cosine on a trained state: the tables are not exact, so ids equal
    and scores allclose to the reference's walk on every route."""
    ref, q, want = _cosine_state()
    port = _port_of(ref, "cosine")
    _assert_same(port.search_batch(q, k=K, nprobes=3), want, exact=False)


def test_walk_nrefine_matches_reference(monkeypatch):
    """The walk's host re-rank over the stored originals (the reference's
    CPU route), and the fluent builder's with_nrefine."""
    monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)
    ref, q = _int_state(4)
    port = _port_of(ref)
    _assert_same(port.search_batch(q, k=K, nprobes=3, nrefine=40),
                 ref.search_batch(q, k=K, nprobes=3, nrefine=40))
    got = port.new_search().with_query(q[0]).with_k(5).with_nprobes(3).with_nrefine(40).execute()
    want = ref.new_search().with_query(q[0]).with_k(5).with_nprobes(3).with_nrefine(40).execute()
    assert [(r.node.id, r.score) for r in got] == [(r.node.id, r.score) for r in want]


@lru_cache(maxsize=None)
def _gauss_state():
    """A trained Gaussian reference index with originals (capacity 2048)
    and 256 queries."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1100, D)).astype(np.float32)
    ref = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind.L2, nlist=NLIST, m=M, nbits=NBITS,
                               store_originals=True)
    ref.train(x)
    ref.add_batch(x, ids=range(1, 1101))
    ref.remove(5)
    return ref, rng.normal(size=(256, D)).astype(np.float32)


NREFINE, NPROBE_G = 48, 3


@lru_cache(maxsize=None)
def _ref_dense_nrefine():
    ref, q = _gauss_state()
    rec_t, sqn, assign = ref._device_dense()
    mask = jnp.where(jnp.asarray(ref._store.valid), sqn, jnp.inf)
    s, i = ref_ps.ivf_topk_pipeline(
        jnp.asarray(q), rec_t, mask, jnp.float32(np.inf), ref._dev_cents_user, assign,
        64, NPROBE_G, sqrt_out=True, kb_cap=64, interpret=True)
    vecs, vsq, _ = ref._store.device_state()
    s, i = ref_ivfpq._refine_device(jnp.asarray(q), i[:, :NREFINE], vecs, vsq, K,
                                    comet_tpu.DistanceKind.L2)
    return np.asarray(s), np.asarray(i)


def test_dense_nrefine_matches_reference_pipeline(monkeypatch):
    """The dense route with nrefine (its kb_cap shortlist, then the device
    re-rank) against the reference's pipeline and `_refine_device` on the
    reference's reconstruction."""
    monkeypatch.setenv("COMET_IVFPQ_SPARSE", "0")
    ref, q = _gauss_state()
    s, i = _ref_dense_nrefine()
    ids, scores = _port_of(ref).search_batch(q, k=K, nprobes=NPROBE_G, nrefine=NREFINE)
    want = np.where(i == SENT, INVALID, ref._store.ids[np.where(i == SENT, 0, i)])
    _assert_same((ids, scores), (want, s), exact=False)
    assert not (ids == 5).any()


@lru_cache(maxsize=None)
def _ref_sparse():
    ref, q = _gauss_state()
    st = ref._device_sparse()
    S, UC, MC = ref_sp.default_budgets(NPROBE_G, NLIST, st["nch_total"], st["max_chunks"])
    s, i, ov = ref_sp.ivf_sparse_pipeline(
        jnp.asarray(q), st["corpus_t"], st["mask_vec"], st["row_slot"],
        jnp.float32(np.inf), st["cents_user"], ref._order_key, st["chunk_start"],
        st["nchunks"], k=16, nprobe=NPROBE_G, S=S, UC=UC, MC=MC, nlist=NLIST,
        sqrt_out=True, interpret=True)
    assert not np.asarray(ov).any()
    return np.asarray(s), np.asarray(i)


def test_sparse_route_matches_reference_pipeline(monkeypatch):
    monkeypatch.setenv("COMET_IVFPQ_SPARSE", "1")
    ref, q = _gauss_state()
    s, i = _ref_sparse()
    ids, scores = _port_of(ref).search_batch(q, k=16, nprobes=NPROBE_G)
    want = np.where(i == SENT, INVALID, ref._store.ids[np.where(i == SENT, 0, i)])
    _assert_same((ids, scores), (want, s), exact=False)


def test_opq_training_and_user_space_centroids():
    """OPQ on anisotropic integer data: the rotation is orthogonal and close
    to the reference's; the scan routes' coarse centroids are the model's
    rotated back to user coordinates (the reference's e43f6a8), and pass
    through unchanged without OPQ."""
    rng = np.random.default_rng(6)
    x = _ints(rng, (900, D), hi=16) * np.linspace(0.25, 2.0, D, dtype=np.float32)
    ref = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind.L2, nlist=4, m=M, nbits=NBITS,
                               store_originals=True, opq=True, opq_iters=2)
    port = IVFPQIndex(D, DistanceKind.L2, nlist=4, m=M, nbits=NBITS, store_originals=True,
                      opq=True, opq_iters=2, device="cpu")
    for index in (ref, port):
        index.train(x)
    np.testing.assert_allclose(port._rot @ port._rot.T, np.eye(D), atol=1e-5)
    np.testing.assert_allclose(port._rot, ref._rot, atol=1e-3)
    np.testing.assert_allclose(port._device_model()[3].numpy(), port._centroids @ port._rot.T,
                               rtol=1e-4, atol=1e-5)
    plain = IVFPQIndex(D, DistanceKind.L2, nlist=4, m=M, nbits=NBITS, device="cpu")
    plain.train(x)
    np.testing.assert_array_equal(plain._device_model()[3].numpy(), plain._centroids)


def _bytes(index):
    buf = io.BytesIO()
    index.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("rot,originals", [(False, True), (False, False), (True, True)],
                         ids=["originals", "codes-only", "opq"])
def test_cipq_byte_identical_both_ways(rot, originals):
    ref, q = _int_state(7, "l2", rot, originals)
    port = _port_of(ref)
    data = _bytes(ref)
    assert _bytes(port) == data
    back = IVFPQIndex(D, DistanceKind.L2, nlist=NLIST, m=M, nbits=NBITS, device="cpu")
    back.read_from(io.BytesIO(data))
    assert back._store_originals == originals
    _assert_same(back.search_batch(q, k=K, nprobes=3), ref.search_batch(q, k=K, nprobes=3))
    again = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind.L2, nlist=NLIST, m=M, nbits=NBITS)
    again.read_from(io.BytesIO(_bytes(back)))
    assert _bytes(again) == data
    with pytest.raises(SerializationError):
        IVFPQIndex(D, DistanceKind.L2, nlist=4, m=M, nbits=NBITS, device="cpu").read_from(
            io.BytesIO(data))


def test_cipq_v2_is_read():
    """A v2 file (no rotation field) from the reference's writer helpers."""
    ref, q = _int_state(8, originals=False)
    ref.flush()
    n = ref._store.n
    buf = io.BytesIO()
    w = ref_serial.CrcWriter(buf)
    ref_serial.write_magic(w, b"CIPQ", 2)
    ref_serial.write_str(w, "l2")
    for v in (D, NLIST, M, NBITS, 0, 1):
        ref_serial.write_u32(w, v)
    ref_serial.write_array(w, ref._centroids)
    ref_serial.write_array(w, ref._codebooks)
    ref_serial.write_u64(w, n)
    ref_serial.write_array(w, ref._store.ids[:n])
    ref_serial.write_array(w, ref._codes[:n].astype(np.uint8))
    ref_serial.write_array(w, ref._assign[:n])
    w.seal()
    port = IVFPQIndex(D, DistanceKind.L2, nlist=NLIST, m=M, nbits=NBITS, device="cpu")
    port.read_from(io.BytesIO(buf.getvalue()))
    _assert_same(port.search_batch(q, k=K, nprobes=3), ref.search_batch(q, k=K, nprobes=3))


@pytest.mark.parametrize("originals", [True, False])
def test_nodes_and_adds_match_reference(originals):
    """with_node and result nodes (stored originals, or decoded vectors), an
    add after loading encoded as the reference encodes it."""
    ref, q = _int_state(9, "l2", True, originals)
    ref = _flushed_copy(ref, originals)
    port = _port_of(ref)
    got = port.new_search().with_node(IDS[1]).with_k(4).with_nprobes(3).execute()
    want = ref.new_search().with_node(IDS[1]).with_k(4).with_nprobes(3).execute()
    for g, w in zip(got, want):
        assert g.node.id == w.node.id and g.score == w.score
        np.testing.assert_array_equal(g.node.vector, w.node.vector)
    for index in (ref, port):
        index.add_batch(q[:3] + 1.0, ids=[7001, 7002, 7003])
    np.testing.assert_array_equal(port._codes[:port._store.n], ref._codes[:ref._store.n])
    np.testing.assert_array_equal(port._assign[:port._store.n], ref._assign[:ref._store.n])


def _flushed_copy(ref, originals):
    fresh = comet_tpu.IVFPQIndex(D, comet_tpu.DistanceKind.L2, nlist=NLIST, m=M, nbits=NBITS,
                                 store_originals=originals)
    fresh.read_from(io.BytesIO(_bytes(ref)))
    return fresh
