"""comet_tpu_torch's Bitset and BSI against comet_tpu's.

The same ids and values, made from a seeded numpy generator, go through
both packages; every set operation and every BSI compare must give the
same words. The reference's BSI compares run with its C kernel and, with
that patched out, with its numpy path; the port has only the numpy path.
"""

import contextlib

import numpy as np
import pytest

from comet_tpu import native
from comet_tpu.ops import bitset as ref
from comet_tpu_torch.ops import bitset as port


def _words_equal(a, b):
    """Equal bits: words past the shorter array are zero."""
    n = max(len(a.words), len(b.words))
    wa = np.zeros(n, np.uint64)
    wb = np.zeros(n, np.uint64)
    wa[: len(a.words)] = a.words
    wb[: len(b.words)] = b.words
    np.testing.assert_array_equal(wa, wb)


@contextlib.contextmanager
def _reference_path(name):
    if name == "native":
        assert native.available()
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "bsi_compare_pack", lambda *a, **k: None)
        yield


def _pair_bitsets(rng, n_ids, span):
    ids = rng.integers(0, span, size=n_ids)
    return ref.Bitset.from_array(ids), port.Bitset.from_array(ids)


@pytest.mark.parametrize("seed", range(3))
def test_set_algebra_and_inspection(seed):
    rng = np.random.default_rng(seed)
    ra, pa = _pair_bitsets(rng, 300, 5000)
    rb, pb = _pair_bitsets(rng, 200, 2000)
    for op in ("and_", "or_", "andnot"):
        _words_equal(getattr(pa, op)(pb), getattr(ra, op)(rb))
        _words_equal(getattr(pb, op)(pa), getattr(rb, op)(ra))
    for op in ("iand", "ior", "iandnot"):
        r, p = ra.clone(), pa.clone()
        getattr(r, op)(rb)
        getattr(p, op)(pb)
        _words_equal(p, r)
        assert p.count() == r.count()
    np.testing.assert_array_equal(pa.to_array(), ra.to_array())
    assert pa.count() == ra.count() and pa.is_empty() == ra.is_empty()
    probe = rng.integers(0, 7000, size=500)
    np.testing.assert_array_equal(pa.contains_many(probe), ra.contains_many(probe))
    drop = rng.integers(0, 6000, size=100)
    ra.discard_many(drop)
    pa.discard_many(drop)
    _words_equal(pa, ra)
    for i in rng.integers(0, 9000, size=20).tolist():
        ra.add(i)
        pa.add(i)
        ra.discard(i + 1)
        pa.discard(i + 1)
        assert pa.contains(i + 2) == ra.contains(i + 2)
    _words_equal(pa, ra)


def test_share_is_copy_on_write_and_counts_track_mutation():
    a = port.Bitset.from_array([1, 2, 3])
    b = a.share()
    assert b.count() == 3
    b.add(100)
    a.discard(1)
    assert a.to_array().tolist() == [2, 3] and b.to_array().tolist() == [1, 2, 3, 100]
    assert a.count() == 2 and b.count() == 4


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("seed", range(2))
def test_bsi_compare_ops_give_the_reference_words(path, seed):
    rng = np.random.default_rng(seed)
    ids = rng.choice(5000, size=1200, replace=False)
    vals = rng.integers(-400, 400, size=len(ids))
    vals[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0]
    r, p = ref.BSI(), port.BSI()
    r.set_values(ids, vals)
    p.set_values(ids, vals)
    for d in rng.integers(0, 5000, size=30).tolist():   # clears and scalar sets
        r.clear_value(d)
        p.clear_value(d)
        r.set_value(d + 1, d - 2000)
        p.set_value(d + 1, d - 2000)
    probes = [-401, -1, 0, 7, 399, int(vals[5]), np.iinfo(np.int64).min]
    with _reference_path(path):
        for v in probes:
            for op in ("compare_gt", "compare_ge", "compare_eq", "compare_lt", "compare_le"):
                _words_equal(getattr(p, op)(v), getattr(r, op)(v))
            _words_equal(p.compare_range(v, v + 150), r.compare_range(v, v + 150))
    dr, vr = r.doc_values()
    dp, vp = p.doc_values()
    np.testing.assert_array_equal(dp, dr)
    np.testing.assert_array_equal(vp, vr)
    assert p.values == r.values
