"""comet_tpu_torch.ops.adc against comet_tpu.ops.adc and the numpy ADC
oracle of tests/test_pq.py, on the CPU.

Inputs come from a seeded numpy generator and go to both packages. Bars:
- on integer data (integer rows, codebooks and queries) every table entry
  and sum is exact in float32, so codes, tables, reconstructions, scores
  and slots are array-equal to the reference's;
- ADC is bit-exact against the oracle, which adds the table entries of
  each code in ascending subspace order, one float32 add each, on
  Gaussian data too, given the same table;
- the selects keep the reference's (score, slot) order, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import adc as ref
from comet_tpu.types import DistanceKind as RefKind
from comet_tpu_torch.ops import adc
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind

from test_pq import np_adc_oracle, np_encode

M, KSUB, DSUB = 4, 16, 3


def _ints(rng, shape, hi=8):
    return rng.integers(0, hi, size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pq_encode_and_decode_match_reference():
    """Integer rows and codebooks with repeated codewords: ties go to the
    lowest codeword in all three (reference, port, numpy scan)."""
    rng = np.random.default_rng(0)
    books = _ints(rng, (M, KSUB, DSUB), hi=3)          # many equal codewords
    x = _ints(rng, (300, M * DSUB), hi=4)
    want = np.asarray(ref.pq_encode(jnp.asarray(x.reshape(-1, M, DSUB)), jnp.asarray(books)))
    got = adc.pq_encode(_t(x).view(-1, M, DSUB), _t(books)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np_encode(x, books))
    np.testing.assert_array_equal(
        adc.pq_decode(_t(got.astype(np.uint8)), _t(books)).numpy(),
        np.asarray(ref.pq_decode(jnp.asarray(want), jnp.asarray(books))))


def test_encode_chunks_change_nothing(monkeypatch):
    rng = np.random.default_rng(1)
    books = rng.normal(size=(M, KSUB, DSUB)).astype(np.float32)
    x = rng.normal(size=(500, M * DSUB)).astype(np.float32)
    whole = adc.pq_encode(_t(x).view(-1, M, DSUB), _t(books))
    monkeypatch.setattr(adc, "ENCODE_CHUNK", 64)
    assert torch.equal(adc.pq_encode(_t(x).view(-1, M, DSUB), _t(books)), whole)


@pytest.mark.parametrize("rotate", [False, True], ids=["plain", "opq"])
@pytest.mark.parametrize("kind", ["l2", "cosine"])
def test_ivfpq_assign_encode_matches_reference(kind, rotate):
    """Coarse assignment and residual codes; with OPQ a signed permutation
    as the rotation, which keeps integer rows integer."""
    rng = np.random.default_rng(2)
    d = M * DSUB
    x = _ints(rng, (400, d), hi=6) - 3.0
    cents = _ints(rng, (7, d), hi=6) - 3.0
    books = _ints(rng, (M, KSUB, DSUB), hi=3) - 1.0
    rot = None
    if rotate:
        rot = np.eye(d, dtype=np.float32)[rng.permutation(d)] * rng.choice([-1.0, 1.0], d)
        rot = rot.astype(np.float32)
    if kind == "cosine":
        x = x + (np.abs(x).sum(1, keepdims=True) == 0)   # no zero rows
    wa, wc = ref.ivfpq_assign_encode(jnp.asarray(x), jnp.asarray(cents), jnp.asarray(books),
                                     RefKind(kind),
                                     jnp.asarray(rot) if rot is not None else None)
    ga, gc = adc.ivfpq_assign_encode(_t(x), _t(cents), _t(books), DistanceKind(kind),
                                     _t(rot) if rot is not None else None)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


def test_build_lut_matches_reference():
    rng = np.random.default_rng(3)
    books = _ints(rng, (M, KSUB, DSUB))
    q = _ints(rng, (9, M, DSUB))
    want = np.asarray(ref.build_lut(jnp.asarray(q), jnp.asarray(books)))
    np.testing.assert_array_equal(adc.build_lut(_t(q), _t(books)).numpy(), want)


def _codes_valid(rng, n):
    codes = rng.integers(0, KSUB, size=(n, M)).astype(np.int32)
    valid = rng.random(n) > 0.2
    return codes, valid


@pytest.mark.parametrize("thr", [np.inf, 4.5], ids=["all", "threshold"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_adc_topk_matches_reference_on_integers(k, thr):
    """Integer tables: scores and slots array-equal to the reference's, ties
    at equal sums ordered by slot, across super tiles."""
    rng = np.random.default_rng(4 + k)
    lut = _ints(rng, (12, M, KSUB), hi=20)
    codes, valid = _codes_valid(rng, 1024)
    ws, wi = ref.adc_topk(jnp.asarray(lut), jnp.asarray(codes), jnp.asarray(valid),
                          jnp.asarray(np.float32(thr)), k, super_tile=256)
    gs, gi = adc.adc_topk(_t(lut), _t(codes.astype(np.uint8)), _t(valid), np.float32(thr), k,
                          super_tile=384)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    if thr != np.inf and k == 64:     # the threshold cuts some of the 64
        assert (gi.numpy() == IDX_SENTINEL).any() and (gi.numpy() != IDX_SENTINEL).any()


def test_adc_is_bit_exact_against_the_oracle():
    """Gaussian data: the port's table, summed by the oracle's loop, gives
    the port's scores bit for bit, and the kept slots are the oracle's
    top k of those sums by (score, slot)."""
    rng = np.random.default_rng(5)
    books = rng.normal(size=(M, KSUB, DSUB)).astype(np.float32)
    q = rng.normal(size=(6, M * DSUB)).astype(np.float32)
    codes, _ = _codes_valid(rng, 900)
    lut = adc.build_lut(_t(q).view(-1, M, DSUB), _t(books))
    oracle = np.zeros((6, 900), np.float32)
    for mm in range(M):
        oracle += lut.numpy()[:, mm, codes[:, mm]]
    oracle = np.sqrt(oracle)
    gs, gi = adc.adc_topk(lut, _t(codes), torch.ones(900, dtype=torch.bool), np.float32(np.inf),
                          900)
    order = np.lexsort((np.broadcast_to(np.arange(900), oracle.shape), oracle), axis=1)
    np.testing.assert_array_equal(gi.numpy(), order)
    np.testing.assert_array_equal(gs.numpy(), np.take_along_axis(oracle, order, axis=1))
    # and the oracle of tests/test_pq.py, on its own table, within the
    # reference's bar: the two tables differ in the last bits
    want = np_adc_oracle(q, books, codes)
    np.testing.assert_allclose(gs.numpy(), np.take_along_axis(want, order, axis=1),
                               rtol=1e-4, atol=1e-4)
