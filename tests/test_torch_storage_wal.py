"""comet_tpu_torch.storage.wal against comet_tpu.storage.wal.

The scenarios of tests/test_wal.py and the WAL scenarios of
tests/test_bloom_wal_batch.py: each package's writer makes the same bytes
for the same appends, and each package's replay reads the other's log to
the same records (torn tails dropped, a corrupt record ending replay).
"""

import threading

import numpy as np
import pytest

from comet_tpu.storage import wal as ref_wal
from comet_tpu_torch.storage import wal as port_wal


def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[3:] == w[3:]
        if w[2] is None:
            assert g[2] is None
        else:
            assert g[2].dtype == w[2].dtype
            np.testing.assert_array_equal(g[2], w[2])


def _write_both(tmp_path, appends):
    """Run `appends(writer)` on each package's writer; return the two logs."""
    paths = {}
    for key, mod in (("ref", ref_wal), ("port", port_wal)):
        paths[key] = str(tmp_path / f"{key}.log")
        w = mod.WalWriter(paths[key])
        appends(w)
        w.close()
    with open(paths["ref"], "rb") as f, open(paths["port"], "rb") as g:
        assert g.read() == f.read()
    return paths


def _replays_agree(path):
    want = list(ref_wal.replay(path))
    _records_equal(list(port_wal.replay(path)), want)
    return want


def test_record_roundtrip(tmp_path):
    vec = np.arange(4, dtype=np.float32)

    def appends(w):
        w.append_add(7, vec, "hello world", {"a": 1, "b": "x"})
        w.append_add(8, None, "", None)
        w.append_remove(7)

    paths = _write_both(tmp_path, appends)
    records = _replays_agree(paths["port"])
    assert len(records) == 3
    op, doc, v, text, meta = records[0]
    assert op == port_wal.OP_ADD == ref_wal.OP_ADD and doc == 7
    np.testing.assert_array_equal(v, vec)
    assert text == "hello world" and meta == {"a": 1, "b": "x"}
    assert records[1][:3] == (port_wal.OP_ADD, 8, None) and records[1][4] is None
    assert records[2][0] == port_wal.OP_REMOVE and records[2][1] == 7


def test_torn_tail_dropped(tmp_path):
    def appends(w):
        w.append_add(1, np.ones(3, dtype=np.float32), "a", None)
        w.append_add(2, np.ones(3, dtype=np.float32), "b", None)

    path = _write_both(tmp_path, appends)["port"]
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) - 5])  # cut inside the second record
    records = _replays_agree(path)
    assert [r[1] for r in records] == [1]


def test_corrupt_record_stops_at_last_good(tmp_path):
    path = _write_both(tmp_path, lambda w: w.append_add(1, None, "ok", None))["port"]
    with open(path, "ab") as f:
        f.write(b"\x08\x00\x00\x00GARBAGE!")  # a valid length, a junk body
    assert [r[1] for r in _replays_agree(path)] == [1]


def test_replay_missing_file(tmp_path):
    assert list(port_wal.replay(str(tmp_path / "absent.log"))) == []


def test_wal_batch_append_replays(tmp_path):
    entries = [(i, np.arange(4, dtype=np.float32) + i, f"text {i}", {"i": i}) for i in range(50)]

    def appends(w):
        w.append_add_batch(entries)
        w.append_add_batch([])  # no-op

    path = _write_both(tmp_path, appends)["port"]
    got = _replays_agree(path)
    assert len(got) == 50
    for (op, doc_id, vec, text, meta), (i, v, t, m) in zip(got, entries):
        assert (op, doc_id, text, meta) == (1, i, t, m)
        np.testing.assert_array_equal(vec, v)
    # one batch append is one write, fsync'd once
    w = port_wal.WalWriter(str(tmp_path / "fsync.log"), fsync=True)
    w.append_add_batch(entries)
    w.close()
    assert w._write_seq == w._sync_seq == 1


@pytest.mark.parametrize("mod", [ref_wal, port_wal], ids=["ref", "port"])
def test_wal_group_commit_concurrent_appends(tmp_path, mod):
    """8 threads append 40 records each with fsync on: every append returns
    only after an fsync covered it, and the other package replays all 320."""
    path = str(tmp_path / "w.log")
    w = mod.WalWriter(path, fsync=True)
    errors = []

    def worker(base):
        try:
            for i in range(40):
                w.append_add(base + i, None, f"doc {base + i}", None)
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t * 1000,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    w.close()
    assert not errors
    records = _replays_agree(path)
    assert sorted(r[1] for r in records) == sorted(t * 1000 + i for t in range(8)
                                                   for i in range(40))
    assert w._sync_seq == w._write_seq == 320
