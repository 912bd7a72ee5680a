"""comet_tpu_torch.PQIndex on the CPU against comet_tpu.PQIndex.

The same data, made from a seeded numpy generator, go through both
packages. On the CPU the reference always searches by ADC; the port takes
its dense route (the decoded corpus through the flat pipeline) unless the
decoded corpus is past `pq.DECODED_BYTES_MAX`, which the tests patch to 0
for the ADC route. Bars:
- training on integer data: codebooks and codes array-equal;
- integer state (integer codebooks, rows and queries, and OPQ rotations
  that are signed permutations), carried across by
  `PQIndex.load_reference_state`: every table entry, sum and square root
  is exact, so both routes' ids and scores are array-equal to the
  reference's search;
- Gaussian state: the dense route against the reference's
  `flat_topk_pipeline` (interpret mode) on the reference's own
  reconstruction, ids array-equal and scores allclose(1e-4, 1e-4);
- CPQX files byte-identical both ways.
"""

import io
from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import comet_tpu
from comet_tpu.io import serial as ref_serial
from comet_tpu.ops import pallas_scan as ref_ps
import comet_tpu_torch
from comet_tpu_torch import DistanceKind, InvalidConfigError, NotTrainedError, PQIndex
from comet_tpu_torch.indexes import pq
from comet_tpu_torch.io.serial import SerializationError

D, M, NBITS, KSUB, N, Q, K = 16, 4, 4, 16, 600, 12, 10
IDS = list(range(1, N + 1))
INVALID = 0xFFFFFFFF


def _ints(rng, shape, hi=8):
    return rng.integers(0, hi, size=shape).astype(np.float32)


def _signed_perm(rng, d=D):
    return (np.eye(d, dtype=np.float32)[rng.permutation(d)]
            * rng.choice([-1.0, 1.0], d)).astype(np.float32)


def _ref_int_state(seed, kind="l2", rot=False):
    """A reference index with integer codebooks (and a signed-permutation
    rotation), integer rows added, a few removed."""
    rng = np.random.default_rng(seed)
    ref = comet_tpu.PQIndex(D, comet_tpu.DistanceKind(kind), m=M, nbits=NBITS)
    ref._codebooks = _ints(rng, (M, KSUB, D // M), hi=6) - 2.0
    ref._rot = _signed_perm(rng) if rot else None
    ref._trained = True
    x = _ints(rng, (N, D), hi=6) - 2.0
    if kind == "cosine":
        x[np.abs(x).sum(1) == 0, 0] = 1.0
    ref.add_batch(x, ids=IDS)
    return ref, _ints(rng, (Q, D), hi=6) - 2.0


def _port_of(ref, kind="l2"):
    s = ref._store
    return PQIndex.load_reference_state(s.ids, ref._codes, s.valid, s.n, ref._codebooks,
                                        ref._rot, DistanceKind(kind), device="cpu")


def _assert_same(got, want, exact=True):
    np.testing.assert_array_equal(got[0], want[0])
    if exact:
        np.testing.assert_array_equal(got[1], want[1])
    else:
        fin = np.isfinite(want[1])
        np.testing.assert_array_equal(np.isfinite(got[1]), fin)
        np.testing.assert_allclose(got[1][fin], want[1][fin], rtol=1e-4, atol=1e-4)


@pytest.fixture
def adc_route(monkeypatch):
    monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)


def test_params_validation_and_defaults():
    for dim in (128, 96, 36, 10, 7):
        assert pq.calculate_pq_params(dim) == comet_tpu.calculate_pq_params(dim)
    for bad in (dict(m=3), dict(m=4, nbits=0), dict(m=4, nbits=17), dict(m=0)):
        with pytest.raises(InvalidConfigError):
            PQIndex(10 if bad.get("m") == 3 else 16, device="cpu", **bad)
    idx = PQIndex(16, m=4, nbits=4, device="cpu")
    assert (idx.m, idx.nbits, idx.ksub, idx.kind().value) == (4, 4, 16, "pq")
    assert not idx.trained()
    with pytest.raises(NotTrainedError):
        idx.add_batch(np.zeros((1, 16), np.float32))
    with pytest.raises(NotTrainedError):
        idx.new_search().with_query([0.0] * 16).execute()
    with pytest.raises(InvalidConfigError, match="at least 16"):
        idx.train(np.zeros((15, 16), np.float32))
    with pytest.raises(InvalidConfigError, match="CUDA"):   # the card is the default
        PQIndex(16, m=4, nbits=4)
    assert comet_tpu_torch.PQIndex is PQIndex
    assert comet_tpu_torch.calculate_pq_params is pq.calculate_pq_params


@pytest.mark.parametrize("kind", ["l2", "l2_squared"])
def test_training_and_codes_match_reference_on_integers(kind):
    rng = np.random.default_rng(1)
    x = _ints(rng, (N, D), hi=16)
    ref = comet_tpu.PQIndex(D, comet_tpu.DistanceKind(kind), m=M, nbits=NBITS)
    port = PQIndex(D, DistanceKind(kind), m=M, nbits=NBITS, device="cpu")
    for index in (ref, port):
        index.train(x)
        index.add_batch(x, ids=IDS)
    np.testing.assert_array_equal(port._codebooks, ref._codebooks)
    np.testing.assert_array_equal(port._codes, ref._codes)
    assert port.trained() and port.count() == N


SCENARIOS = ["batch", "threshold-filter", "remove-flush", "fluent-node"]


def _run(index, q, scenario, thr=4.0):
    if scenario == "fluent-node":
        res = index.new_search().with_query(q[0]).with_node(IDS[5]).with_k(K).execute()
        return (np.array([r.node.id for r in res], np.uint32),
                np.array([r.score for r in res], np.float32))
    knobs = {}
    if scenario == "threshold-filter":
        knobs = dict(threshold=thr, document_ids=[i for i in IDS if i % 3])
    return index.search_batch(q, k=K, **knobs)


@pytest.mark.parametrize("route", ["dense", "adc"])
@pytest.mark.parametrize("scenario", SCENARIOS)
@pytest.mark.parametrize("kind,rot", [("l2", False), ("l2_squared", False), ("l2", True)],
                         ids=["l2", "l2sq", "opq"])
def test_routes_match_reference_on_integer_state(kind, rot, scenario, route, monkeypatch):
    if route == "adc":
        monkeypatch.setattr(pq, "DECODED_BYTES_MAX", 0)
    ref, q = _ref_int_state(2, kind, rot)
    if scenario == "remove-flush":
        for i in IDS[::7]:
            ref.remove(i)
    port = _port_of(ref, kind)
    if scenario == "remove-flush":
        got_before = _run(port, q, "batch")
        _assert_same(got_before, _run(ref, q, "batch"))
        assert not np.isin(got_before[0], IDS[::7]).any()
        for index in (ref, port):
            index.flush()
    # a threshold at the median third score of an unfiltered search cuts
    thr = float(np.median(ref.search_batch(q, k=3)[1][:, 2]))
    got, want = _run(port, q, scenario, thr), _run(ref, q, scenario, thr)
    _assert_same(got, want)
    if scenario == "threshold-filter":
        hits = got[0][got[0] != INVALID]
        assert 0 < len(hits) < got[0].size and (hits % 3 != 0).all()


def test_cosine_matches_reference(adc_route):
    """Cosine: the queries and rows are normalised, so the tables are not
    exact: ids equal, scores allclose."""
    ref, q = _ref_int_state(3, "cosine")
    port = _port_of(ref, "cosine")
    _assert_same(port.search_batch(q, k=K), ref.search_batch(q, k=K), exact=False)


@lru_cache(maxsize=None)
def _gauss_state():
    """A trained Gaussian reference index (capacity 2048), its 256 queries
    and the reference's flat pipeline over its own reconstruction."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1100, D)).astype(np.float32)
    q = rng.normal(size=(256, D)).astype(np.float32)
    ref = comet_tpu.PQIndex(D, comet_tpu.DistanceKind.L2, m=M, nbits=NBITS)
    ref.train(x)
    ref.add_batch(x, ids=range(1, 1101))
    ref.remove(3)
    rec_t, sqn = ref._device_decoded()
    mask = jnp.where(jnp.asarray(ref._store.valid), sqn, jnp.inf)
    thr = np.float32(2.5)
    s, i = ref_ps.flat_topk_pipeline(jnp.asarray(q), rec_t, mask, thr * thr, 16,
                                     sqrt_out=True, interpret=True)
    return ref, q, thr, np.asarray(s), np.asarray(i)


def test_dense_route_matches_reference_pipeline_on_its_reconstruction():
    """The port's dense route over the reference's trained state against
    the reference's Pallas pipeline (interpret mode) over the reference's
    reconstruction: ids equal, scores allclose (the reconstructions' norms
    are summed in another order)."""
    ref, q, thr, s, i = _gauss_state()
    port = _port_of(ref)
    ids, scores = port.search_batch(q, k=16, threshold=float(thr))
    want_ids = np.where(i == 2**31 - 1, INVALID, ref._store.ids[np.where(i == 2**31 - 1, 0, i)])
    _assert_same((ids, scores), (want_ids, s), exact=False)
    assert (ids == INVALID).any() and (ids != INVALID).any() and not (ids == 3).any()
    # the reference's own ADC search gives the same neighbours
    np.testing.assert_array_equal(ids, ref.search_batch(q, k=16, threshold=float(thr))[0])


def test_opq_training_matches_reference():
    """OPQ on integer data: the learned rotation is orthogonal and close to
    the reference's (the Procrustes products sum in another order before
    the host SVD); the codebooks trained in the rotated space give the
    reference's recall."""
    rng = np.random.default_rng(5)
    x = _ints(rng, (500, D), hi=16) * np.linspace(0.2, 2.0, D, dtype=np.float32)
    ref = comet_tpu.PQIndex(D, comet_tpu.DistanceKind.L2, m=M, nbits=NBITS, opq=True,
                            opq_iters=2)
    port = PQIndex(D, DistanceKind.L2, m=M, nbits=NBITS, opq=True, opq_iters=2, device="cpu")
    for index in (ref, port):
        index.train(x)
        index.add_batch(x, ids=range(1, 501))
    np.testing.assert_allclose(port._rot @ port._rot.T, np.eye(D), atol=1e-5)
    np.testing.assert_allclose(port._rot, ref._rot, atol=1e-3)
    q = x[:40] + 0.25
    exact = np.argsort(((q[:, None] - x[None]) ** 2).sum(-1), axis=1)[:, :10] + 1

    def recall(ids):
        return np.mean([len(np.intersect1d(a, b)) / 10 for a, b in zip(ids, exact)])

    assert abs(recall(port.search_batch(q, k=10)[0]) - recall(ref.search_batch(q, k=10)[0])) < 0.05


def _bytes(index):
    buf = io.BytesIO()
    index.write_to(buf)
    return buf.getvalue()


@pytest.mark.parametrize("rot", [False, True], ids=["plain", "opq"])
def test_cpqx_byte_identical_both_ways(rot):
    ref, q = _ref_int_state(6, "l2", rot)
    ref.remove(IDS[4])
    port = _port_of(ref)
    data = _bytes(ref)
    assert _bytes(port) == data
    back = PQIndex(D, DistanceKind.L2, m=M, nbits=NBITS, device="cpu")
    back.read_from(io.BytesIO(data))
    _assert_same(back.search_batch(q, k=K), ref.search_batch(q, k=K))
    again = comet_tpu.PQIndex(D, comet_tpu.DistanceKind.L2, m=M, nbits=NBITS)
    again.read_from(io.BytesIO(_bytes(back)))
    assert _bytes(again) == data
    with pytest.raises(SerializationError):
        PQIndex(D, DistanceKind.L2, m=2, nbits=NBITS, device="cpu").read_from(io.BytesIO(data))
    with pytest.raises(SerializationError):
        PQIndex(D, DistanceKind.COSINE, m=M, nbits=NBITS, device="cpu").read_from(
            io.BytesIO(data))


def test_cpqx_v2_is_read():
    """A v2 file (no rotation field) from the reference's writer helpers."""
    ref, q = _ref_int_state(7)
    w_buf = io.BytesIO()
    w = ref_serial.CrcWriter(w_buf)
    ref_serial.write_magic(w, b"CPQX", 2)
    ref_serial.write_str(w, "l2")
    for v in (D, M, NBITS, 1):
        ref_serial.write_u32(w, v)
    ref_serial.write_array(w, ref._codebooks)
    ref_serial.write_u64(w, N)
    ref_serial.write_array(w, ref._store.ids[:N])
    ref_serial.write_array(w, ref._codes[:N].astype(np.uint8))
    w.seal()
    port = PQIndex(D, DistanceKind.L2, m=M, nbits=NBITS, device="cpu")
    port.read_from(io.BytesIO(w_buf.getvalue()))
    _assert_same(port.search_batch(q, k=K), ref.search_batch(q, k=K))


def test_result_nodes_and_adds_decode(adc_route):
    """Result nodes carry decoded vectors, an add after loading encodes as
    the reference does, and a search after an add and a flush agrees."""
    ref, q = _ref_int_state(8, "l2", rot=True)
    port = _port_of(ref)
    got = port.new_search().with_query(q[0]).with_k(3).execute()
    want = ref.new_search().with_query(q[0]).with_k(3).execute()
    for g, w in zip(got, want):
        assert g.node.id == w.node.id
        np.testing.assert_array_equal(g.node.vector, w.node.vector)
    extra = q[:4] + 1.0
    for index in (ref, port):
        index.add_batch(extra, ids=[9001, 9002, 9003, 9004])
        index.remove(IDS[0])
        index.flush()
    np.testing.assert_array_equal(port._codes[:port._store.n], ref._codes[:ref._store.n])
    _assert_same(port.search_batch(q, k=K), ref.search_batch(q, k=K))
    assert port.count() == ref.count() == N + 3
