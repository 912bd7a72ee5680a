"""Metadata index: categorical bitmaps + numeric per-field indexes.

Counterpart of comet_tpu/indexes/metadata.py (the Go reference's
RoaringMetadataIndex, metadata_index.go, metadata_index_search.go):

- Field typing at Add: int/float -> numeric BSI with floats stored as
  int64(v*100) fixed-point (metadata_index.go:142-143); str/bool ->
  categorical "field:value" bitmap (bools as "True"/"False" — the Go
  reference renders "true"/"false"; both spellings are accepted in
  filters for compatibility).
- Operators: eq/ne/gt/gte/lt/lte/range/in/not_in/exists/not_exists
  (metadata_index.go:414-435) with typed constructors + not_() inversion
  + anyof/noneof/between/is_null aliases (metadata_index.go:448-553).
- Remove is a HARD delete (metadata_index.go:187-206); flush is a no-op.
- Search: simple filters AND-ed with early exit
  (metadata_index_search.go:162-189); FilterGroups OR-ed between groups,
  AND/OR within (metadata_index_search.go:193-250); fluent
  where/and_/or_ query builder (metadata_index_search.go:275-345).

Engine: dense packed-word bitsets + biased-uint64 BSI (ops/bitset.py) —
every filter compiles to O(words) vectorized ops on the host, and the
final bitmap becomes the slot mask of the vector scan and the allowed
mask of the BM25 scorer (the Go reference instead hands over a candidate
ID list per query, hybrid_search_index.go:498-532). The AND / OR folds
take the JAX package's numpy paths, which give the same words as its C
fold (comet_tpu/native).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field as dc_field
from typing import Any, BinaryIO, Iterable

import numpy as np

from comet_tpu_torch.core.node import MetadataNode
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops.bitset import BSI, Bitset
from comet_tpu_torch.types import InvalidConfigError
from comet_tpu_torch.utils.memory import memory_report

MAGIC = b"CMTX"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

FIXED_POINT_SCALE = 100  # float -> int64(v*100), metadata_index.go:142-143


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Filter:
    """A single predicate (metadata_index.go:438-443)."""

    field: str
    operator: str
    value: Any = None
    value2: Any = None  # for range


def eq(field: str, value) -> Filter:
    return Filter(field, "eq", value)


def ne(field: str, value) -> Filter:
    return Filter(field, "ne", value)


def gt(field: str, value) -> Filter:
    return Filter(field, "gt", value)


def gte(field: str, value) -> Filter:
    return Filter(field, "gte", value)


def lt(field: str, value) -> Filter:
    return Filter(field, "lt", value)


def lte(field: str, value) -> Filter:
    return Filter(field, "lte", value)


def range_filter(field: str, lo, hi) -> Filter:
    return Filter(field, "range", lo, hi)


def between(field: str, lo, hi) -> Filter:
    return range_filter(field, lo, hi)


def in_filter(field: str, *values) -> Filter:
    if len(values) == 1 and isinstance(values[0], (list, tuple)):
        values = tuple(values[0])
    return Filter(field, "in", values)


def not_in(field: str, *values) -> Filter:
    if len(values) == 1 and isinstance(values[0], (list, tuple)):
        values = tuple(values[0])
    return Filter(field, "not_in", values)


def anyof(field: str, *values) -> Filter:
    return in_filter(field, *values)


def noneof(field: str, *values) -> Filter:
    return not_in(field, *values)


def exists(field: str) -> Filter:
    return Filter(field, "exists")


def not_exists(field: str) -> Filter:
    return Filter(field, "not_exists")


def is_null(field: str) -> Filter:
    return not_exists(field)


def is_not_null(field: str) -> Filter:
    return exists(field)


_NOT_TABLE = {
    "eq": "ne", "ne": "eq",
    "gt": "lte", "gte": "lt", "lt": "gte", "lte": "gt",
    "in": "not_in", "not_in": "in",
    "exists": "not_exists", "not_exists": "exists",
}


def not_(f: Filter) -> Filter:
    """Invert a filter's operator (metadata_index.go Not, :519-545)."""
    return Filter(f.field, _NOT_TABLE.get(f.operator, f.operator), f.value, f.value2)


def _and_fold(parts: list[tuple[Bitset, bool]]) -> Bitset:
    """AND a list of (bitset, shared) predicate results into ONE owned
    bitset with a single output allocation — inputs are never mutated, so
    live planes and BSI cache entries participate copy-free. AND truncates
    to the shortest word array (bits past a shorter operand are 0).

    Operands are folded most-selective-first (cached popcounts), one pass
    each."""
    if not parts:
        return Bitset()
    if len(parts) == 1:
        bs, shared = parts[0]
        return bs.share() if shared else bs
    n = min(len(bs.words) for bs, _ in parts)
    sets = sorted((bs for bs, _ in parts), key=Bitset.count)
    out = np.bitwise_and(sets[0].words[:n], sets[1].words[:n])
    for bs in sets[2:]:
        np.bitwise_and(out, bs.words[:n], out=out)
    return Bitset(out)


def _or_fold(parts: list[tuple[Bitset, bool]]) -> Bitset:
    """OR-fold counterpart of `_and_fold` (output sized to the longest)."""
    if not parts:
        return Bitset()
    if len(parts) == 1:
        bs, shared = parts[0]
        return bs.share() if shared else bs
    n = max(len(bs.words) for bs, _ in parts)
    first = parts[0][0].words
    out = np.zeros(n, dtype=np.uint64)
    out[: len(first)] = first
    for bs, _ in parts[1:]:
        w = bs.words
        np.bitwise_or(out[: len(w)], w, out=out[: len(w)])
    return Bitset(out)


@dataclass
class FilterGroup:
    """Filters combined with AND/OR; groups OR together
    (metadata_index_search.go:181-199)."""

    filters: list[Filter] = dc_field(default_factory=list)
    logic: str = "AND"  # "AND" | "OR"


@dataclass(frozen=True)
class MetadataResult:
    id: int

    def get_id(self) -> int:
        return self.id

    def get_score(self) -> float:
        return 0.0  # metadata hits carry no score (metadata_index_search.go:40-44)


def _to_fixed(value) -> int:
    """Numeric -> fixed-point int64.

    The reference scales only floats by 100 (toInt64,
    metadata_index.go:396-408), which makes int 150 and float 150.0 in the
    same field compare differently — a footgun, not a feature. Here ALL
    numerics are scaled, so mixed int/float fields behave consistently at
    the same 2-decimal precision.
    """
    if isinstance(value, bool):
        raise InvalidConfigError("boolean is categorical, not numeric")
    if isinstance(value, (int, np.integer)):
        return int(value) * FIXED_POINT_SCALE
    if isinstance(value, (float, np.floating)):
        return int(value * FIXED_POINT_SCALE)
    raise InvalidConfigError(f"cannot convert {type(value).__name__} to int64")


def _cat_value(value) -> str:
    if isinstance(value, bool):
        return str(value)  # "True"/"False"
    return str(value)


_MISSING_SENTINEL = object()


def _group_categorical(field: str, doc_ids: np.ndarray, sarr: np.ndarray):
    """Group a string column by distinct value: yields one
    ("field:value", sorted-doc-id-array) pair per unique value — the
    vectorized replacement for per-document plane routing."""
    uniq, inv = np.unique(sarr, return_inverse=True)
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
    for u in range(len(uniq)):
        yield f"{field}:{uniq[u]}", doc_ids[order[bounds[u]: bounds[u + 1]]]


# ---------------------------------------------------------------------------
# Index
# ---------------------------------------------------------------------------


class RoaringMetadataIndex:
    """Metadata filter index (name kept for reference-API familiarity; the
    engine is dense packed bitsets, not roaring — see module docstring)."""

    def __init__(self):
        self._categorical: dict[str, Bitset] = {}
        self._numeric: dict[str, BSI] = {}
        self._all_docs = Bitset()
        self._lock = threading.RLock()
        # filter-result memo: repeated hybrid queries reuse the same
        # predicate set, and the vector launch can't go out until the
        # candidate mask exists. Keyed by filter signature; any write
        # clears it and bumps the mutation epoch.
        self._mutation = 0
        self._bitset_cache: "dict[tuple, Bitset]" = {}

    def _dirty(self) -> None:
        """Mark contents changed (caller holds the lock)."""
        self._mutation += 1
        if self._bitset_cache:
            self._bitset_cache.clear()

    # -- mutation ----------------------------------------------------------

    def add(self, node: MetadataNode) -> None:
        """Classify each field numeric/categorical and index it
        (metadata_index.go:126-154)."""
        with self._lock:
            self._dirty()
            doc_id = int(node.id)
            self._all_docs.add(doc_id)
            for key, value in node.metadata.items():
                if isinstance(value, bool):
                    self._add_categorical(key, _cat_value(value), doc_id)
                elif isinstance(value, (int, float, np.integer, np.floating)):
                    self._add_numeric(key, doc_id, _to_fixed(value))
                elif isinstance(value, str):
                    self._add_categorical(key, value, doc_id)
                else:
                    raise InvalidConfigError(
                        f"unsupported type for key {key}: {type(value).__name__}"
                    )

    def add_batch(self, nodes: Iterable[MetadataNode]) -> None:
        """Bulk insert: pivots the node batch into per-field COLUMNS, then
        applies one vectorized bitset/BSI update per field/plane.

        The reference (and `add()`) pay a per-document per-bitplane cost
        (metadata_index.go:126-154); pivoting first makes the Python work
        one list-comp per field and pushes everything else into numpy.
        Columns that mix value kinds across documents (e.g. int in one doc,
        str in another) fall back to per-value routing for that field.
        Like the grouped path it replaces, all values are validated before
        any plane is mutated."""
        nodes = list(nodes)
        if not nodes:
            return
        doc_ids = np.array([n.id for n in nodes], dtype=np.uint64)
        metas = [n.metadata for n in nodes]
        keys: dict[str, None] = {}
        for m in metas:
            for k in m:
                keys[k] = None
        # uniform schema (the common bulk shape: every node has every key)
        # => no per-field missing-value scans at all
        nkeys = len(keys)
        uniform = all(len(m) == nkeys for m in metas)
        _MISSING = _MISSING_SENTINEL
        # classify every field's column first (validation before mutation)
        num_ops: list[tuple[str, np.ndarray, np.ndarray]] = []
        cat_ops: list[tuple[str, np.ndarray]] = []
        for key in keys:
            vals = [m.get(key, _MISSING) for m in metas]
            if not uniform and any(v is _MISSING for v in vals):
                present = np.fromiter(
                    (v is not _MISSING for v in vals), dtype=bool, count=len(vals)
                )
                ids_k = doc_ids[present]
                vals = [v for v in vals if v is not _MISSING]
            else:
                ids_k = doc_ids
            # exact element-type routing (np.asarray alone would silently
            # str-ify mixed int/str columns)
            ts = set(map(type, vals))
            numeric = all(issubclass(t, (int, float, np.integer, np.floating))
                          and not issubclass(t, bool) for t in ts)
            if numeric:
                if any(issubclass(t, (float, np.floating)) for t in ts):
                    arr = np.asarray(vals, dtype=np.float64)
                    if np.isnan(arr).any():
                        raise ValueError(
                            f"cannot convert float NaN to integer (field {key!r})"
                        )  # same failure as add()'s int(v*100)
                    fixed = (arr * FIXED_POINT_SCALE).astype(np.int64)
                else:
                    fixed = np.asarray(vals, dtype=np.int64) * FIXED_POINT_SCALE
                num_ops.append((key, ids_k, fixed))
            elif all(issubclass(t, (str, np.str_)) for t in ts):
                for plane_key, plane_ids in _group_categorical(
                    key, ids_k, np.asarray(vals)
                ):
                    cat_ops.append((plane_key, plane_ids))
            elif ts == {bool} or ts == {np.bool_}:
                arr = np.asarray(vals, dtype=bool).astype("U5")  # "True"/"False"
                for plane_key, plane_ids in _group_categorical(key, ids_k, arr):
                    cat_ops.append((plane_key, plane_ids))
            else:
                # mixed/unsupported column: validate + route each value
                for v in vals:
                    if not isinstance(
                        v, (bool, int, float, str, np.integer, np.floating, np.str_)
                    ):
                        raise InvalidConfigError(
                            f"unsupported type for key {key}: {type(v).__name__}"
                        )
                n_ids, n_vals, c_keys = [], [], {}
                for doc_id, v in zip(ids_k.tolist(), vals):
                    if isinstance(v, bool) or isinstance(v, (str, np.str_)):
                        c_keys.setdefault(f"{key}:{_cat_value(v)}", []).append(doc_id)
                    else:
                        n_ids.append(doc_id)
                        n_vals.append(_to_fixed(v))
                if n_ids:
                    num_ops.append(
                        (
                            key,
                            np.asarray(n_ids, dtype=np.uint64),
                            np.asarray(n_vals, dtype=np.int64),
                        )
                    )
                for plane_key, plane_ids in c_keys.items():
                    cat_ops.append(
                        (plane_key, np.asarray(plane_ids, dtype=np.uint64))
                    )
        with self._lock:
            self._dirty()
            self._all_docs.add_many(doc_ids)
            for plane_key, plane_ids in cat_ops:
                bs = self._categorical.get(plane_key)
                if bs is None:
                    bs = self._categorical[plane_key] = Bitset()
                bs.add_many(plane_ids)
            for field_name, ids, fixed in num_ops:
                bsi = self._numeric.get(field_name)
                if bsi is None:
                    bsi = self._numeric[field_name] = BSI()
                bsi.set_values(ids, fixed)

    def add_columns(self, doc_ids, columns: dict) -> None:
        """Columnar bulk insert: one numpy array per field.

        The bulk-ingest shape (same design move as the vector indexes'
        `add_batch`): numeric columns become ONE vectorized
        fixed-point convert + dense-array scatter, categorical columns
        group by unique value and apply one packed-word `add_many` per
        distinct value — no per-document Python routing. Semantics match
        `add_batch` over nodes with the same fields (reference bulk path:
        metadata_index.go:126-154 per-doc map iteration).

        `columns` maps field name -> array-like of length len(doc_ids):
        numeric dtypes index as fixed-point numerics (floats x100, ints
        x100 — same rule as `add`); string/object/bool arrays index as
        categorical "field:value" planes. NaN entries in float columns are
        skipped (treated as missing).
        """
        doc_ids = np.asarray(doc_ids, dtype=np.uint64)
        n = len(doc_ids)
        with self._lock:
            self._dirty()
            self._all_docs.add_many(doc_ids)
            for field_name, values in columns.items():
                arr = np.asarray(values)
                if len(arr) != n:
                    raise InvalidConfigError(
                        f"column {field_name!r} length {len(arr)} != ids {n}"
                    )
                if arr.dtype == bool:
                    arr = arr.astype("U5")  # "True"/"False" categorical
                if np.issubdtype(arr.dtype, np.integer):
                    fixed = arr.astype(np.int64) * FIXED_POINT_SCALE
                    ids, vals = doc_ids, fixed
                elif np.issubdtype(arr.dtype, np.floating):
                    ok = ~np.isnan(arr)
                    fixed = (arr[ok] * FIXED_POINT_SCALE).astype(np.int64)
                    ids, vals = doc_ids[ok], fixed
                else:
                    sarr = arr.astype("U") if arr.dtype == object else arr
                    if not np.issubdtype(sarr.dtype, np.str_):
                        raise InvalidConfigError(
                            f"unsupported column dtype for {field_name!r}: {arr.dtype}"
                        )
                    for key, plane_ids in _group_categorical(
                        field_name, doc_ids, sarr
                    ):
                        bs = self._categorical.get(key)
                        if bs is None:
                            bs = self._categorical[key] = Bitset()
                        bs.add_many(plane_ids)
                    continue
                bsi = self._numeric.get(field_name)
                if bsi is None:
                    bsi = self._numeric[field_name] = BSI()
                bsi.set_values(ids, vals)

    def _add_categorical(self, field: str, value: str, doc_id: int) -> None:
        key = f"{field}:{value}"
        bs = self._categorical.get(key)
        if bs is None:
            bs = self._categorical[key] = Bitset()
        bs.add(doc_id)

    def _add_numeric(self, field: str, doc_id: int, value: int) -> None:
        bsi = self._numeric.get(field)
        if bsi is None:
            bsi = self._numeric[field] = BSI()
        bsi.set_value(doc_id, value)

    def remove(self, node: MetadataNode) -> None:
        """HARD delete from every plane (metadata_index.go:187-206)."""
        with self._lock:
            self._dirty()
            doc_id = int(node.id)
            self._all_docs.discard(doc_id)
            for bs in self._categorical.values():
                bs.discard(doc_id)
            for bsi in self._numeric.values():
                bsi.clear_value(doc_id)

    def flush(self) -> None:
        """No-op (metadata_index.go:232-234)."""

    def train(self, *_args) -> None:
        """No-op; metadata index needs no training."""

    def trained(self) -> bool:
        return True

    def count(self) -> int:
        return self._all_docs.count()

    def stats(self) -> dict:
        with self._lock:
            return {
                "kind": "metadata",
                "docs": self._all_docs.count(),
                "categorical_planes": len(self._categorical),
                "numeric_fields": len(self._numeric),
                "memory": memory_report(self),
            }

    # -- filter evaluation -------------------------------------------------

    def _existence(self, field: str) -> Bitset:
        # a field can carry BOTH planes (some docs numeric, some bool/str):
        # existence is the union
        result = Bitset()
        bsi = self._numeric.get(field)
        if bsi is not None:
            result.ior(bsi.ebm)
        prefix = field + ":"
        for key, bs in self._categorical.items():
            if key.startswith(prefix):
                result.ior(bs)
        return result

    def _eval_categorical_ro(self, f: Filter) -> tuple[Bitset, bool]:
        """(bitset, shared): shared=True means the result is a LIVE plane
        the caller must not mutate."""
        op = f.operator or "eq"
        if op == "eq":
            key = f"{f.field}:{_cat_value(f.value)}"
            bs = self._categorical.get(key)
            return (bs, True) if bs is not None else (Bitset(), False)
        if op == "ne":
            key = f"{f.field}:{_cat_value(f.value)}"
            bs = self._categorical.get(key)
            if bs is None:
                return self._all_docs.share(), False
            return self._all_docs.andnot(bs), False
        if op in ("gt", "gte", "lt", "lte", "range"):
            # Numeric operator on a field this index has never seen as
            # numeric: no matches. (The reference errors here, which makes a
            # hybrid/LSM search fail whenever ANY source — e.g. an empty
            # memtable — lacks the field; returning empty is the sane LSM
            # semantics.)
            return Bitset(), False
        raise InvalidConfigError(f"unsupported operator for categorical field: {op}")

    def _eval_numeric(self, bsi: BSI, f: Filter, ro: bool = False) -> Bitset:
        """ro=True may return the BSI's cached result object (do not
        mutate) — skips one full-plane copy per predicate."""
        op = f.operator or "eq"
        if op == "eq":
            return bsi.compare_eq(_to_fixed(f.value), ro=ro)
        if op == "ne":
            return bsi.ebm.andnot(bsi.compare_eq(_to_fixed(f.value), ro=True))
        if op == "gt":
            return bsi.compare_gt(_to_fixed(f.value), ro=ro)
        if op == "gte":
            return bsi.compare_ge(_to_fixed(f.value), ro=ro)
        if op == "lt":
            return bsi.compare_lt(_to_fixed(f.value), ro=ro)
        if op == "lte":
            return bsi.compare_le(_to_fixed(f.value), ro=ro)
        if op == "range":
            return bsi.compare_range(
                _to_fixed(f.value), _to_fixed(f.value2), ro=ro
            )
        raise InvalidConfigError(f"unsupported operator for numeric field: {op}")

    def _eval_filter_ro(self, f: Filter) -> tuple[Bitset, bool]:
        """Evaluate one predicate WITHOUT defensive copies: returns
        (bitset, shared). shared results are live planes / cache entries —
        the fold helpers below never mutate their inputs, which is what
        makes the 10M-doc filter path allocation-minimal (one output
        buffer per query instead of a clone per predicate)."""
        op = f.operator or "eq"
        if op == "exists":
            return self._existence(f.field), False
        if op == "not_exists":
            result = self._all_docs.clone()
            result.iandnot(self._existence(f.field))
            return result, False
        # route by PREDICATE VALUE type, like the reference's evaluateFilter
        # type switch (metadata_index.go:258-330): bool/str predicates hit
        # the categorical planes even when the field also has a numeric BSI
        # (mixed-type fields), numeric predicates hit the BSI. in/not_in
        # decompose into per-value eq so each value routes independently.
        if op == "in":
            parts = [
                self._eval_filter_ro(Filter(f.field, "eq", v)) for v in f.value
            ]
            return _or_fold(parts), False
        if op == "not_in":
            result = self._all_docs.clone()
            for v in f.value:
                result.iandnot(
                    self._eval_filter_ro(Filter(f.field, "eq", v))[0]
                )
            return result, False
        bsi = self._numeric.get(f.field)
        categorical_value = isinstance(f.value, (bool, str, np.bool_, np.str_))
        if bsi is not None and not categorical_value:
            return self._eval_numeric(bsi, f, ro=True), True
        return self._eval_categorical_ro(f)

    def _eval_filter(self, f: Filter) -> Bitset:
        """Owned (mutation-safe) single-predicate evaluation."""
        bs, shared = self._eval_filter_ro(f)
        return bs.share() if shared else bs

    def _eval(self, filters: list[Filter], groups: list[FilterGroup]) -> Bitset:
        if groups:
            parts = []
            for g in groups:
                if not g.filters:
                    parts.append((self._all_docs, True))
                elif g.logic == "AND":
                    parts.append(
                        (_and_fold([self._eval_filter_ro(f) for f in g.filters]),
                         False)
                    )
                else:
                    parts.append(
                        (_or_fold([self._eval_filter_ro(f) for f in g.filters]),
                         False)
                    )
            return _or_fold(parts)
        if filters:
            return _and_fold([self._eval_filter_ro(f) for f in filters])
        # neither set: all documents (metadata_index_search.go Execute)
        return self._all_docs.share()

    @staticmethod
    def _value_sig(v):
        """Type-tagged value key. Python conflates True == 1 == 1.0 under
        hash/equality, but categorical evaluation keys planes by str(value)
        (``f:True`` vs ``f:1`` vs ``f:1.0``) — so the memo signature must
        distinguish them or eq(field, True) poisons eq(field, 1)."""
        if isinstance(v, (tuple, list)):
            return (type(v).__name__,) + tuple(
                RoaringMetadataIndex._value_sig(x) for x in v
            )
        return (type(v).__name__, v)

    @staticmethod
    def _filter_sig(filters: list[Filter], groups: list[FilterGroup]):
        """Hashable signature of a predicate set (None when any value is
        unhashable — those queries just skip the memo)."""
        vs = RoaringMetadataIndex._value_sig
        try:
            def fsig(f: Filter):
                return (f.field, f.operator, vs(f.value), vs(f.value2))

            return (
                tuple(fsig(f) for f in filters),
                tuple((tuple(fsig(f) for f in g.filters), g.logic) for g in groups),
            )
        except TypeError:
            return None

    def filter_bitset(
        self,
        filters: list[Filter] | None = None,
        groups: list[FilterGroup] | None = None,
    ) -> Bitset:
        """Evaluate to a bitmap — the fused-mask fast path for hybrid
        search. Results memoize per (mutation epoch, predicate signature):
        serving traffic repeats predicate sets, and evaluation sits on the
        single-query critical path ahead of the vector dispatch."""
        filters = list(filters or [])
        groups = list(groups or [])
        sig = self._filter_sig(filters, groups)
        with self._lock:
            if sig is not None:
                hit = self._bitset_cache.get(sig)
                if hit is not None:
                    return hit.share()
            out = self._eval(filters, groups)
            if sig is not None:
                if len(self._bitset_cache) >= 256:
                    self._bitset_cache.clear()
                self._bitset_cache[sig] = out.share()
            return out

    def new_search(self) -> "MetadataSearchBuilder":
        return MetadataSearchBuilder(self)

    # -- serialization ------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CMTX v1: all-docs words + categorical planes + numeric values."""
        with self._lock:
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_array(w, self._all_docs.words)
            serial.write_u32(w, len(self._categorical))
            for key in sorted(self._categorical):
                serial.write_str(w, key)
                serial.write_array(w, self._categorical[key].words)
            serial.write_u32(w, len(self._numeric))
            for field_name in sorted(self._numeric):
                bsi = self._numeric[field_name]
                serial.write_str(w, field_name)
                docs, vals = bsi.doc_values()
                serial.write_array(w, docs.astype(np.uint64))
                serial.write_array(w, vals)
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        all_docs = serial.read_array(r).astype(np.uint64)
        categorical = {}
        n_cat = serial.read_u32(r)
        for _ in range(n_cat):
            key = serial.read_str(r)
            categorical[key] = serial.read_array(r).astype(np.uint64)
        numeric = {}
        n_num = serial.read_u32(r)
        for _ in range(n_num):
            field_name = serial.read_str(r)
            docs = serial.read_array(r)
            vals = serial.read_array(r)
            numeric[field_name] = (docs, vals)
        if version >= 2:
            r.verify()
        with self._lock:
            self._dirty()
            self._all_docs = Bitset(all_docs)
            self._categorical = {k: Bitset(v) for k, v in categorical.items()}
            self._numeric = {}
            for field_name, (docs, vals) in numeric.items():
                bsi = BSI()
                bsi.set_values(docs, vals)
                self._numeric[field_name] = bsi


class MetadataSearchBuilder:
    """Fluent search (metadata_index_search.go:55-272 + the
    where/and_/or_ query builder at :275-345)."""

    def __init__(self, index: RoaringMetadataIndex):
        self._index = index
        self._filters: list[Filter] = []
        self._groups: list[FilterGroup] = []

    def with_filters(self, *filters: Filter) -> "MetadataSearchBuilder":
        self._filters = list(filters)
        return self

    def with_filter_groups(self, *groups: FilterGroup) -> "MetadataSearchBuilder":
        self._groups = list(groups)
        return self

    # fluent builder style: where/and_/or_
    def where(self, *filters: Filter) -> "MetadataSearchBuilder":
        if filters:
            self._groups.append(FilterGroup(list(filters), "AND"))
        return self

    def or_(self, *filters: Filter) -> "MetadataSearchBuilder":
        if filters:
            self._groups.append(FilterGroup(list(filters), "AND"))
        return self

    def and_(self, *filters: Filter) -> "MetadataSearchBuilder":
        if self._groups and filters:
            self._groups[-1].filters.extend(filters)
            self._groups[-1].logic = "AND"
        elif filters:
            self.where(*filters)
        return self

    def execute(self) -> list[MetadataResult]:
        bs = self._index.filter_bitset(self._filters, self._groups)
        return [MetadataResult(int(i)) for i in bs.to_array()]

    def execute_bitset(self) -> Bitset:
        """Bitmap result — stays packed for fusing into scan kernels."""
        return self._index.filter_bitset(self._filters, self._groups)
