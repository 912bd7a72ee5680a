"""comet_tpu_torch.RoaringMetadataIndex against comet_tpu's.

The same seeded nodes (string, bool, int and float fields, some missing,
one field of mixed types) go into both packages by `add`, `add_batch` and
`add_columns`; every Filter operator, `not_`, filter groups of both logics
and the fluent where / or_ / and_ builder must give the same bitsets. The
reference's AND fold runs with its C kernel and, patched out, with numpy.
Also: CMTX bytes equal both ways, v1 readable, removal, the memo.
"""

import contextlib
import io

import numpy as np
import pytest

import comet_tpu.indexes.metadata as ref
import comet_tpu_torch.indexes.metadata as port
from comet_tpu import native
from comet_tpu.core.node import new_metadata_node_with_id as ref_node
from comet_tpu_torch import InvalidConfigError, new_metadata_node_with_id as port_node

N = 600
CATS = ["a", "b", "c", "d"]


def _metas(seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(N):
        m = {"cat": CATS[int(rng.integers(0, 4))], "num": int(rng.integers(-50, 50)),
             "price": float(np.round(rng.uniform(0, 100), 2)), "flag": bool(rng.integers(0, 2))}
        if i % 7 == 0:
            del m["price"]
        if i % 11 == 0:
            m["mixed"] = "x" if i % 2 else 3
        out.append((i + 1, m))
    return out


def _build(path, seed=0):
    metas = _metas(seed)
    r, p = ref.RoaringMetadataIndex(), port.RoaringMetadataIndex()
    if path == "add":
        for i, m in metas:
            r.add(ref_node(i, m))
            p.add(port_node(i, m))
    elif path == "add_batch":
        r.add_batch([ref_node(i, m) for i, m in metas])
        p.add_batch([port_node(i, m) for i, m in metas])
    else:
        ids = np.array([i for i, _ in metas], np.uint64)
        cols = {"cat": np.array([m["cat"] for _, m in metas]),
                "num": np.array([m["num"] for _, m in metas]),
                "price": np.array([m.get("price", np.nan) for _, m in metas]),
                "flag": np.array([m["flag"] for _, m in metas])}
        r.add_columns(ids, cols)
        p.add_columns(ids, cols)
    return r, p


def _filters(mod):
    return [
        mod.eq("cat", "a"), mod.ne("cat", "b"), mod.eq("flag", True), mod.ne("flag", False),
        mod.eq("num", 3), mod.ne("num", 3), mod.gt("num", 10), mod.gte("num", 10),
        mod.lt("price", 25.5), mod.lte("price", 25.5), mod.range_filter("num", -5, 5),
        mod.between("price", 10, 20), mod.in_filter("cat", "a", "c"),
        mod.in_filter("num", [1, 2, 3]), mod.not_in("cat", "a", "d"), mod.anyof("num", 4, 5),
        mod.noneof("num", 4, 5), mod.exists("price"), mod.not_exists("price"),
        mod.is_null("mixed"), mod.is_not_null("mixed"), mod.eq("mixed", "x"),
        mod.eq("mixed", 3), mod.gt("cat", 3), mod.eq("absent", "q"), mod.not_(mod.gt("num", 0)),
        mod.not_(mod.in_filter("cat", "b")), mod.not_(mod.exists("price")),
    ]


@contextlib.contextmanager
def _reference_fold(name):
    if name == "native":
        assert native.available()
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "bitset_and_fold", lambda *a, **k: None)
        mp.setattr(native, "bsi_compare_pack", lambda *a, **k: None)
        yield


def _same(got, want):
    np.testing.assert_array_equal(got.to_array(), want.to_array())


@pytest.mark.parametrize("path", ["add", "add_batch", "add_columns"])
@pytest.mark.parametrize("fold", ["native", "numpy"])
def test_every_filter_and_group_gives_the_reference_bitset(path, fold):
    r, p = _build(path)
    rf, pf = _filters(ref), _filters(port)
    with _reference_fold(fold):
        for a, b in zip(rf, pf):
            _same(p.filter_bitset([b]), r.filter_bitset([a]))
        for a, b in ((rf[:3], pf[:3]), (rf[4:9], pf[4:9]), (rf[10:14], pf[10:14]), ([], [])):
            _same(p.filter_bitset(b), r.filter_bitset(a))
        for logic in ("AND", "OR"):
            rg = [ref.FilterGroup(rf[0:2], logic), ref.FilterGroup(rf[6:9], logic),
                  ref.FilterGroup([], logic)]
            pg = [port.FilterGroup(pf[0:2], logic), port.FilterGroup(pf[6:9], logic),
                  port.FilterGroup([], logic)]
            _same(p.filter_bitset(groups=pg[:2]), r.filter_bitset(groups=rg[:2]))
            _same(p.filter_bitset(groups=pg), r.filter_bitset(groups=rg))
        rb = (r.new_search().where(rf[0], rf[6]).or_(rf[12]).and_(rf[17]).execute())
        pb = (p.new_search().where(pf[0], pf[6]).or_(pf[12]).and_(pf[17]).execute())
        assert [x.id for x in pb] == [x.id for x in rb]
        _same(p.new_search().with_filters(*pf[:2]).execute_bitset(),
              r.new_search().with_filters(*rf[:2]).execute_bitset())
    assert p.count() == r.count()
    for key in ("docs", "categorical_planes", "numeric_fields"):
        assert p.stats()[key] == r.stats()[key]


def test_remove_and_memo_isolation():
    r, p = _build("add_batch")
    before = p.filter_bitset([port.eq("cat", "a")])
    want_before = before.to_array().copy()
    for idx, node in ((r, ref_node), (p, port_node)):
        idx.remove(node(1, {}))
        idx.remove(node(10, {}))
        idx.add(node(5000, {"cat": "a", "num": 1}))
    np.testing.assert_array_equal(before.to_array(), want_before)
    for a, b in zip(_filters(ref), _filters(port)):
        _same(p.filter_bitset([b]), r.filter_bitset([a]))
    # bool and int predicates do not share a memo entry
    _same(p.filter_bitset([port.eq("mixed", True)]), r.filter_bitset([ref.eq("mixed", True)]))
    _same(p.filter_bitset([port.eq("mixed", 1)]), r.filter_bitset([ref.eq("mixed", 1)]))


def test_cmtx_bytes_equal_both_ways_and_v1_readable():
    r, p = _build("add")
    want, got = io.BytesIO(), io.BytesIO()
    r.write_to(want)
    p.write_to(got)
    assert got.getvalue() == want.getvalue()
    back = port.RoaringMetadataIndex()
    back.read_from(io.BytesIO(want.getvalue()))
    again = io.BytesIO()
    back.write_to(again)
    assert again.getvalue() == want.getvalue()
    for a, b in zip(_filters(ref), _filters(port)):
        _same(back.filter_bitset([b]), r.filter_bitset([a]))
    v1 = bytearray(want.getvalue()[:-4])
    v1[4:8] = (1).to_bytes(4, "little")
    for idx in (ref.RoaringMetadataIndex(), port.RoaringMetadataIndex()):
        idx.read_from(io.BytesIO(bytes(v1)))
        assert idx.count() == N


def test_invalid_inputs_raise():
    p = port.RoaringMetadataIndex()
    with pytest.raises(InvalidConfigError):
        p.add(port_node(1, {"bad": [1, 2, 3]}))
    with pytest.raises(InvalidConfigError):
        p.add_columns([1, 2], {"x": [1, 2, 3]})
    with pytest.raises(ValueError):
        p.add_batch([port_node(1, {"f": float("nan")}), port_node(2, {"f": 1.5})])
