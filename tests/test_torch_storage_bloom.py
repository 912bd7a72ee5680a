"""comet_tpu_torch.storage.bloom against comet_tpu.storage.bloom.

The bloom scenarios of tests/test_bloom_wal_batch.py: built from the same
ids, the port's filter has the reference's bits (its sidecar bytes are
equal), answers every probe as the reference does, and each package loads
the other's sidecar.
"""

import numpy as np
import pytest

from comet_tpu.storage.bloom import BloomFilter as RefBloom
from comet_tpu_torch.storage.bloom import BloomFilter


def _pair(ids, **kw):
    ref, port = RefBloom.build(ids, **kw), BloomFilter.build(ids, **kw)
    assert port.to_bytes() == ref.to_bytes()
    return ref, port


def test_bloom_no_false_negatives(rng):
    ids = rng.choice(1 << 40, size=5000, replace=False)
    ref, port = _pair(ids)
    assert all(port.may_contain(int(i)) for i in ids[:500])
    assert port.may_contain_any(ids)
    both = np.concatenate([ids[:1], ids[:1] + 1])
    assert port.may_contain_any(both) == ref.may_contain_any(both) is True


def test_bloom_false_positive_rate(rng):
    ids = rng.choice(1 << 40, size=10000, replace=False)
    ref, port = _pair(ids)
    probes = np.setdiff1d(rng.choice(1 << 40, size=20000, replace=False), ids)[:5000]
    got = [port.may_contain(int(p)) for p in probes]
    assert got == [ref.may_contain(int(p)) for p in probes]
    assert sum(got) / len(probes) < 0.03  # ~0.8 % at the design point


def test_bloom_all_absent_rejects():
    ref, port = _pair(np.arange(100, dtype=np.uint64))
    far = np.arange(10**9, 10**9 + 50, dtype=np.uint64)
    assert port.may_contain_any(far) == ref.may_contain_any(far)
    assert [port.may_contain(int(p)) for p in far] == [ref.may_contain(int(p)) for p in far]
    assert not port.may_contain_any(np.asarray([], dtype=np.uint64))


def test_bloom_roundtrip(tmp_path, rng):
    ids = rng.choice(1 << 30, size=333, replace=False)
    ref, port = _pair(ids, bits_per_key=12, k=5)
    port.save(str(tmp_path / "p.bin"))
    ref.save(str(tmp_path / "r.bin"))
    for loaded in (BloomFilter.load(str(tmp_path / "r.bin")),
                   RefBloom.load(str(tmp_path / "p.bin"))):
        assert loaded.k == 5
        np.testing.assert_array_equal(loaded.words, port.words)
    with pytest.raises(ValueError):
        BloomFilter.from_bytes(b"nope")


def test_bloom_empty_build():
    ref, port = _pair([])
    assert not port.may_contain(7) and not ref.may_contain(7)
