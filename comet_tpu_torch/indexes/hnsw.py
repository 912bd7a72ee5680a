"""HNSW vector index: bulk build, incremental insertion and batched beam
search.

Counterpart of comet_tpu/indexes/hnsw.py (capability parity with the Go
reference's HNSWIndex, hnsw_index.go and hnsw_index_search.go): geometric
levels p = 1/M capped at 16, layer-0 degree 2M, per-query efSearch
override (0 falls back to efConstruction), soft delete + flush with
entry-point repair, the CHNW v2 format (byte-identical to the reference
package's).

- Build: an `add_batch` of at least BULK_BUILD_MIN vectors into an empty
  index takes the staged exact-kNN bulk build (ops/graph_build.py). Every
  other add, `add` included, runs insertion rounds of BUILD_SUB_BATCH
  vectors: a host greedy descent through the upper layers, the graph beam
  (ops/graph.py, E = GRAPH_EXPAND) at efConstruction for each new node's
  candidate pool plus the exact candidates within the round, the nearest M
  as forward edges, batched reverse edges with pruning, upper-layer links
  and entry-point promotion. Each round then writes the touched adjacency
  rows into the device adjacency and the resident routing table in place;
  only a capacity growth or a replaced graph (flush, load) rebuilds them.
- Search: a lockstep beam over bf16 routing tables (ops/beam_kernel.py),
  blocked by default, packed with COMET_HNSW_PACKED=1; in-loop scoring,
  the merge step K4, an exact float32 re-score at the end, and with
  COMET_HNSW_FUSE=1 (which implies the packed table) the fused expand
  kernel K5 for unfiltered searches. Doc-ID filters, thresholds and soft
  deletes gate result admission (the fused result set of K4) while every
  node still routes. At n >= SEED_MIN_N (or COMET_HNSW_SEED=1) the beam
  starts from a cluster-probe seed scan (ops/ivf_sparse.py, K3 in bf16
  mode) and stops on the k-window bound; otherwise from the exact nearest
  upper-layer member. A graph whose routing table would pass
  BLOCKED_TABLE_BYTES_MAX searches with the graph beam instead, in chunks
  of GRAPH_QUERY_CHUNK queries from a host descent, as the reference does.
  On a CUDA index every kernel of the path launches on the card, on a CPU
  index the plain versions run; nothing falls back.

The reference's query padding is kept, and is part of the result: a batch
is padded with zero rows to a power of two, cut into chunks of
SEARCH_QUERY_CHUNK, each padded to a multiple of 128. The seed scan drops
the chunks a 128-query group's step budget cannot hold (its overflow is
not rescanned, as in the reference), so which queries share a group
decides what each query's seeds can be.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import BinaryIO, Iterable

import numpy as np
import torch

from comet_tpu_torch.core.filter import DocumentFilter
from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.core.node import VectorNode, reserve_node_ids
from comet_tpu_torch.indexes.base import (
    INVALID_ID,
    BaseVectorIndex,
    VectorSearchBuilder,
    next_pow2,
    threshold_scalar,
)
from comet_tpu_torch.io import serial
from comet_tpu_torch.ops import beam_kernel as bk
from comet_tpu_torch.ops import ivf_sparse as sp
from comet_tpu_torch.ops.distance import bf16_round, preprocess
from comet_tpu_torch.ops.graph import beam_search_layer0, scatter_graph_update
from comet_tpu_torch.ops.graph_build import BulkGraphBuilder
from comet_tpu_torch.ops.kmeans import find_nearest_centroid, kmeans
from comet_tpu_torch.ops.topk import IDX_SENTINEL
from comet_tpu_torch.types import DistanceKind, InvalidConfigError, VectorIndexKind

MAGIC = b"CHNW"
VERSION = 2  # v2: CRC32 payload trailer (v1 readable, no trailer check)

MAX_LEVEL = 16            # hnsw_index.go:474-484 cap
# The routing-table beam (ops/beam_kernel.py): nodes expanded per
# iteration and queries per launch (the reference's PALLAS_EXPAND and
# PALLAS_QUERY_CHUNK).
BEAM_EXPAND = 8
SEARCH_QUERY_CHUNK = 2048
# The graph beam (ops/graph.py) of insertion and of searches without a
# routing table: nodes expanded per iteration and queries per search chunk
# (the reference's SEARCH_EXPAND = BUILD_EXPAND and HNSW_QUERY_CHUNK).
GRAPH_EXPAND = 1
GRAPH_QUERY_CHUNK = 256
# New vectors per insertion round.
BUILD_SUB_BATCH = 512
# A routing table (blocked: cap x 2M x d bf16; packed: cap x 2M (d + 1 +
# ndig) bf16) may take at most half of an 80 GB H100: the other half holds
# the corpus, the seed tables and the search and build transients. 1M x 32
# x 128 is 8 GiB; the cap is reached near 5M rows at d = 128. A larger
# graph searches with the graph beam.
BLOCKED_TABLE_BYTES_MAX = 40 << 30
# Seeded beam: smaller corpora start from the entry point.
SEED_MIN_N = 1 << 15
# Seed-table rebuild debounce: the cluster-major layout is rebuilt when the
# adds + removes since the last layout exceed max(SEED_REBUILD_MIN, frac *
# layout size); smaller deltas refresh the removal mask only.
SEED_REBUILD_MIN = 8192
SEED_REBUILD_FRAC = 0.125
# An add_batch of at least this many vectors into an empty index takes the
# bulk build.
BULK_BUILD_MIN = 4096


def _use_packed_table() -> bool:
    """COMET_HNSW_PACKED=1 selects the packed routing table (one row per
    node: the neighbour vectors and the aux planes), with the blocked
    pair's results; implied by COMET_HNSW_FUSE."""
    return os.environ.get("COMET_HNSW_PACKED", "0") == "1" or _use_fused_beam()


def _use_fused_beam() -> bool:
    """COMET_HNSW_FUSE=1 runs each iteration of an unfiltered search as one
    launch of K5 over the packed table; filtered, thresholded and
    soft-deleted searches keep the split path."""
    return os.environ.get("COMET_HNSW_FUSE", "0") == "1"


def pad_queries(qarr: np.ndarray) -> tuple[np.ndarray, int]:
    """Pad the batch with zero rows to a power-of-two row count."""
    q = qarr.shape[0]
    qp = next_pow2(q)
    if qp == q:
        return qarr, q
    out = np.zeros((qp, qarr.shape[1]), dtype=np.float32)
    out[:q] = qarr
    return out, q


@dataclass
class HNSWConfig:
    """Graph and search parameters (DefaultHNSWConfig = (16, 200, 200),
    hnsw_index.go:95-97), as the reference package's HNSWConfig.

    search_iters bounds the beam's iterations (0: derived from ef).
    seed_search enables the seeded beam at n >= SEED_MIN_N; seed_nprobe
    (0: nlist / 64, at least 2), seed_stop (0: max(2 k_pad, 64), at most
    ef_pad), seed_width (0: min(stop, 128) seeded rows) and seed_kb (0:
    max(seed_width / 4, 32) selection groups; -1: exact) shape it."""

    m: int = 16
    ef_construction: int = 200
    ef_search: int = 200
    search_iters: int = 0
    seed_search: bool = True
    seed_nprobe: int = 0
    seed_stop: int = 0
    seed_width: int = 0
    seed_kb: int = 0


class HNSWIndex(BaseVectorIndex):
    """Hierarchical navigable small-world index (reference:
    hnsw_index.go:50-172). `device` is "cuda" (the default) or "cpu"."""

    def __init__(
        self,
        dim: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        config: HNSWConfig | None = None,
        seed: int = 0,
        *,
        device="cuda",
    ):
        super().__init__(dim, distance_kind, device)
        self._cfg = config or HNSWConfig()
        if self._cfg.m <= 0:
            raise InvalidConfigError("M must be positive")
        if self._cfg.ef_construction <= 0:
            raise InvalidConfigError("efConstruction must be positive")
        cap = self._store.capacity
        self._levels = np.full(cap, -1, dtype=np.int32)
        self._sqn0 = np.zeros(cap, dtype=np.float32)   # host squared norms
        self._adj0 = np.full((cap, 2 * self._cfg.m), -1, dtype=np.int32)
        self._upper: dict[int, np.ndarray] = {}
        self._entry_slot = -1
        self._max_level = -1
        self._rng = np.random.default_rng(seed)
        self._graph_version = 0
        # device state of the graph, current at (graph version, capacity)
        # _dev_key: the layer-0 adjacency and the one resident routing table,
        # (packed, (nbr_vecs, aux or None)) in the layout last selected
        self._dev_adj = None
        self._table = None
        self._dev_key = None
        # level >= 1 member tables for the entry choice
        self._dev_l1 = None
        self._dev_l1_version = -1
        self._reset_seed()
        # seed-scan health, device counters: chunks dropped by the step
        # budget, and probe-starved queries (an empty seed row)
        self._seed_overflow = None
        self._seed_starved = None

    def _reset_seed(self) -> None:
        """Drop the seeded beam state (cluster-major bf16 probe tables). A
        new slot store restarts its version at 0, so the state must go with
        the old store: its slots point into the old corpus."""
        self._seed_state = None
        self._seed_version = -1
        self._seed_centroids = None
        self._seed_order_key = None
        self._seed_trained_n = 0
        self._seed_assign = None
        self._seed_assign_n = 0
        self._seed_layout_n = 0
        self._seed_layout_deleted = 0

    @classmethod
    def load_reference_state(
        cls,
        ids: np.ndarray,
        vectors: np.ndarray,
        valid: np.ndarray,
        n: int,
        levels: np.ndarray,
        adj0: np.ndarray,
        upper: dict,
        entry_slot: int,
        max_level: int,
        distance_kind: DistanceKind = DistanceKind.L2,
        config: HNSWConfig | None = None,
        rng_state: dict | None = None,
        *,
        device="cuda",
    ) -> "HNSWIndex":
        """An index holding the graph of a comet_tpu HNSW index: its slot
        store's host arrays `ids`, `vectors` (preprocessed), `valid` and
        `n`, soft-deleted slots included, its `levels`, layer-0 `adj0`,
        upper layers {level: adjacency}, entry slot and top level, and its
        numpy generator's state (`rng_state`), which later draws read."""
        vectors = np.asarray(vectors, dtype=np.float32)
        cfg = HNSWConfig(**vars(config)) if config is not None else None
        idx = cls(vectors.shape[1], distance_kind, cfg, device=device)
        idx._store.load(ids, vectors, valid, n)
        cap = idx._store.capacity
        m = idx._cfg.m
        idx._levels = np.full(cap, -1, dtype=np.int32)
        idx._levels[:n] = np.asarray(levels)[:n]
        idx._sqn0 = np.zeros(cap, dtype=np.float32)
        idx._sqn0[:n] = np.einsum("nd,nd->n", vectors[:n], vectors[:n])
        idx._adj0 = np.full((cap, 2 * m), -1, dtype=np.int32)
        idx._adj0[:n] = np.asarray(adj0)[:n]
        for lvl, arr in upper.items():
            grown = np.full((cap, m), -1, dtype=np.int32)
            grown[:n] = np.asarray(arr)[:n]
            idx._upper[int(lvl)] = grown
        idx._entry_slot = int(entry_slot)
        idx._max_level = int(max_level)
        idx._graph_version += 1
        if rng_state is not None:
            idx._rng.bit_generator.state = rng_state
        return idx

    # -- contracts -----------------------------------------------------------

    def kind(self) -> VectorIndexKind:
        return VectorIndexKind.HNSW

    def train(self, vectors=None) -> None:
        """HNSW requires no training (parity)."""
        return None

    @property
    def config(self) -> HNSWConfig:
        return self._cfg

    def set_ef_search(self, ef: int) -> None:
        """Default search beam width (hnsw_index.go:463-467)."""
        self._cfg.ef_search = int(ef)

    def _effective_ef(self, override: int | None) -> int:
        ef = override if override and override > 0 else self._cfg.ef_search
        if ef <= 0:
            ef = self._cfg.ef_construction  # 0 falls back (hnsw_index.go:185-187)
        return ef

    def stats(self) -> dict:
        s = super().stats()
        s["max_level"] = self._max_level
        s["seed_overflow_chunks"] = (int(self._seed_overflow.item())
                                     if self._seed_overflow is not None else 0)
        s["seed_starved_queries"] = (int(self._seed_starved.item())
                                     if self._seed_starved is not None else 0)
        return s

    # -- levels and upper layers ---------------------------------------------

    def _sample_levels(self, n: int) -> np.ndarray:
        """Geometric levels: P(level >= L) = (1/M)^L, capped at 16
        (hnsw_index.go:474-484)."""
        u = self._rng.random(n)
        levels = np.floor(np.log(np.maximum(u, 1e-300)) / np.log(1.0 / self._cfg.m))
        return np.minimum(levels, MAX_LEVEL).astype(np.int32)

    def _ensure_level(self, level: int) -> None:
        if level not in self._upper:
            self._upper[level] = np.full((self._store.capacity, self._cfg.m), -1, dtype=np.int32)

    def _grow_host(self) -> None:
        cap = self._store.capacity
        if len(self._levels) >= cap:
            return
        levels = np.full(cap, -1, dtype=np.int32)
        levels[: len(self._levels)] = self._levels
        self._levels = levels
        sqn = np.zeros(cap, dtype=np.float32)
        sqn[: len(self._sqn0)] = self._sqn0
        self._sqn0 = sqn
        adj0 = np.full((cap, 2 * self._cfg.m), -1, dtype=np.int32)
        adj0[: len(self._adj0)] = self._adj0
        self._adj0 = adj0
        for lvl in list(self._upper):
            up = np.full((cap, self._cfg.m), -1, dtype=np.int32)
            up[: len(self._upper[lvl])] = self._upper[lvl]
            self._upper[lvl] = up

    # -- device state ----------------------------------------------------------

    def _table_bytes(self, packed: bool) -> int:
        cap, w = self._store.capacity, 2 * self._cfg.m
        if packed:
            return cap * w * (self._dim + 1 + bk._aux_digits(cap)) * 2
        return cap * w * self._dim * 2

    def _sync_device(self) -> None:
        """Bring the device state to the current graph and capacity: upload
        the layer-0 adjacency and rebuild the resident routing table, in the
        layout the switch selects, when the graph was replaced or the
        capacity changed (insertion rounds keep both current in place,
        `_scatter_device`)."""
        key = (self._graph_version, self._store.capacity)
        if self._dev_key == key:
            return
        had_table = self._table is not None
        self._table = None    # free the old state before the new
        self._dev_adj = None
        self._dev_adj = torch.from_numpy(self._adj0).to(self._device)
        self._dev_key = key
        if had_table:
            self._build_table(_use_packed_table())

    def _build_table(self, packed: bool):
        """Build the routing table in one layout, after freeing the resident
        one: the index holds one table, as the reference does. None when it
        would pass BLOCKED_TABLE_BYTES_MAX."""
        self._table = None
        if self._table_bytes(packed) > BLOCKED_TABLE_BYTES_MAX:
            return None
        vecs, sqnorms, _ = self._store.device_state()
        if packed:
            tables = (bk.build_packed_table(self._dev_adj, vecs, sqnorms), None)
        else:
            tables = bk.build_blocked_tables(self._dev_adj, vecs, sqnorms)
        self._table = (packed, tables)
        return tables

    def _routing_tables(self):
        """The routing table of the current graph in the layout the switch
        selects, (nbr_vecs, aux) blocked or (packed, None), built on first
        use or when the switch changed; None when the table would pass
        BLOCKED_TABLE_BYTES_MAX."""
        self._sync_device()
        packed = _use_packed_table()
        if self._table is not None and self._table[0] == packed:
            return self._table[1]
        return self._build_table(packed)

    def _scatter_device(self, touched: np.ndarray, version: int) -> None:
        """After an insertion round that moved the graph on from `version`:
        the touched adjacency rows to the device adjacency
        (ops/graph.scatter_graph_update, with no vector rows: the slot store
        already wrote the round's vectors and norms into its mirror) and to
        the resident routing table, in place. Device state that was not
        current before the round stays stale and is rebuilt at its next
        use."""
        cap = self._store.capacity
        if self._dev_key != (version, cap):
            return
        dev = self._device
        vecs, sqnorms, _ = self._store.device_state()
        rows = torch.from_numpy(np.asarray(touched, dtype=np.int64)).to(dev)
        adj_rows = torch.from_numpy(self._adj0[touched]).to(dev)
        no_rows = rows[:0]
        scatter_graph_update(vecs, sqnorms, self._dev_adj, no_rows, vecs[no_rows], rows, adj_rows)
        if self._table is not None:
            packed, (nbr_vecs, aux) = self._table
            if packed:
                bk.update_packed_rows(nbr_vecs, rows, adj_rows, vecs, sqnorms)
            else:
                bk.update_blocked_rows(nbr_vecs, aux, rows, adj_rows, vecs, sqnorms)
        self._dev_key = (self._graph_version, cap)

    # -- host distances and descent ------------------------------------------

    def _dist_rows_cmp(self, a: np.ndarray, b: np.ndarray, bn: np.ndarray,
                       an: np.ndarray | None = None) -> np.ndarray:
        """Comparison-only scores of a[i] against b[i, ...]: a [n, d], b
        [n, m, d], bn [n, m] b's squared norms (the `_sqn0` cache). L2 stays
        squared; only the order is used (construction and descent)."""
        ip = np.einsum("nd,nmd->nm", a, b)
        if self._distance_kind == DistanceKind.COSINE:
            return 1.0 - np.clip(ip, -1.0, 1.0)
        if an is None:
            an = (a * a).sum(axis=1)
        return an[:, None] + bn - 2 * ip

    def _descend(self, queries: np.ndarray) -> np.ndarray:
        """Greedy descent through the upper layers on the host, vectorised
        over the queries. Returns each query's layer-0 entry slot."""
        q = queries.shape[0]
        cur = np.full(q, self._entry_slot, dtype=np.int64)
        qn = (queries * queries).sum(axis=1)
        ev = self._store.vectors[self._entry_slot][None, :]
        cur_d = self._dist_rows_cmp(
            queries, np.broadcast_to(ev, (q, 1, self._dim)),
            np.broadcast_to(self._sqn0[self._entry_slot], (q, 1)), an=qn)[:, 0]
        for level in range(self._max_level, 0, -1):
            adj = self._upper.get(level)
            if adj is None:
                continue
            for _ in range(64):  # safety cap; greedy converges fast
                neigh = adj[cur]                      # [Q, M]
                mask = neigh >= 0
                if not mask.any():
                    break
                safe = np.maximum(neigh, 0)
                nd = self._dist_rows_cmp(queries, self._store.vectors[safe], self._sqn0[safe],
                                         an=qn)
                nd = np.where(mask, nd, np.inf)
                best = nd.argmin(axis=1)
                bd = nd[np.arange(q), best]
                move = bd < cur_d
                if not move.any():
                    break
                cur = np.where(move, neigh[np.arange(q), best], cur)
                cur_d = np.where(move, bd, cur_d)
        return cur.astype(np.int32)

    # -- mutation --------------------------------------------------------------

    def add(self, node: VectorNode) -> None:
        self.add_batch(np.asarray(node.vector, dtype=np.float32)[None, :], [node.id])

    def add_batch(self, vectors: np.ndarray, ids: Iterable[int] | None = None) -> list[int]:
        """Insert vectors: the bulk build for at least BULK_BUILD_MIN vectors
        into an empty index, insertion rounds otherwise (module docstring).
        Returns the node IDs (auto-assigned when `ids` is None)."""
        vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        self._check_dim(vectors)
        if ids is None:
            first = reserve_node_ids(len(vectors))
            id_arr = np.arange(first, first + len(vectors), dtype=np.uint32)
        else:
            id_arr = np.asarray(list(ids), dtype=np.uint32)
            if len(id_arr) != len(vectors):
                raise InvalidConfigError("ids and vectors length mismatch")
        prepped = preprocess(vectors, self._distance_kind)
        with self._lock:
            for i in id_arr.tolist():
                if self._store.contains(i):
                    raise InvalidConfigError(f"duplicate node ID {i}")
            self._insert_preprocessed(id_arr, prepped)
        return id_arr.tolist()

    def _vectors_of_slots(self, slots: np.ndarray) -> np.ndarray:
        """The preprocessed vectors of `slots` (the store's merge reads them)."""
        return self._store.vectors[slots]

    def _insert_preprocessed(self, id_arr: np.ndarray, prepped: np.ndarray) -> None:
        was_empty = self._store.n == 0 and self._entry_slot < 0
        slots = self._store.add_batch(id_arr, prepped)
        self._grow_host()
        levels = self._sample_levels(len(slots))
        self._levels[slots] = levels
        self._sqn0[slots] = np.einsum("nd,nd->n", prepped, prepped)
        if was_empty and len(slots) >= BULK_BUILD_MIN:
            self._bulk_build(levels)
            return
        for lo in range(0, len(slots), BUILD_SUB_BATCH):
            self._insert_round(np.asarray(slots[lo: lo + BUILD_SUB_BATCH]),
                               levels[lo: lo + BUILD_SUB_BATCH])

    def _bulk_build(self, levels: np.ndarray) -> None:
        """Whole-graph construction (ops/graph_build.py) of a freshly
        loaded index: slots [0, n), `levels` in slot order."""
        n = self._store.n
        m = self._cfg.m
        vecs, sqnorms, _ = self._store.device_state()
        builder = BulkGraphBuilder(n, self._distance_kind, vecs, sqnorms)
        self._adj0[:n] = builder.build_layer(None, m, 2 * m)[:n]
        max_level = int(levels.max())
        for lvl in range(1, max_level + 1):
            members = np.flatnonzero(self._levels[:n] >= lvl).astype(np.int32)
            self._ensure_level(lvl)
            if len(members) < 2:
                continue
            adj = builder.build_layer(members, m, m)
            self._upper[lvl][members] = adj[members]
        top = np.flatnonzero(self._levels[:n] == max_level)
        self._entry_slot = int(top[0])
        self._max_level = max_level
        self._graph_version += 1
        self._routing_tables()

    def _insert_round(self, sub: np.ndarray, sub_levels: np.ndarray) -> None:
        """One insertion round of the new slots `sub` (reference
        _insert_round, the graph beam's candidate pool)."""
        cfg = self._cfg
        self._sync_device()
        version = self._graph_version
        vecs = self._store.vectors[sub]
        touched: set[int] = set()

        if self._entry_slot < 0:
            # bootstrap: the first node becomes the entry point
            self._entry_slot = int(sub[0])
            self._max_level = int(sub_levels[0])
            for lvl in range(1, sub_levels[0] + 1):
                self._ensure_level(lvl)
            first, rest = sub[:1], sub[1:]
            if len(rest) == 0:
                self._graph_version += 1
                self._scatter_device(np.asarray([], dtype=np.int64), version)
                return
            sub, sub_levels, vecs = rest, sub_levels[1:], vecs[1:]
            touched.add(int(first[0]))

        b = len(sub)
        # candidate pool: the graph beam over the existing graph ...
        entries = self._descend(vecs)
        efc = cfg.ef_construction
        dev_vecs, dev_sqn, _ = self._store.device_state()
        cand_d, cand_s = beam_search_layer0(
            torch.from_numpy(np.ascontiguousarray(vecs)).to(self._device),
            torch.from_numpy(entries).to(self._device),
            self._dev_adj, dev_vecs, dev_sqn,
            torch.ones(self._store.capacity, dtype=torch.bool, device=self._device),
            float("inf"), efc, efc, self._distance_kind,
            (4 * efc + 32) // GRAPH_EXPAND + 16, GRAPH_EXPAND,
            False,  # construction: the results are the final beam
        )
        cand_d = cand_d.cpu().numpy()
        cand_s = cand_s.cpu().numpy()
        # ... plus the exact candidates within the round, so that its new
        # nodes can link to each other
        if b > 1:
            ip = vecs @ vecs.T
            if self._distance_kind == DistanceKind.COSINE:
                intra = 1.0 - np.clip(ip, -1.0, 1.0)
            else:
                sq = (vecs * vecs).sum(axis=1)
                intra = np.maximum(sq[:, None] + sq[None, :] - 2.0 * ip, 0.0)
                if self._distance_kind == DistanceKind.L2:
                    intra = np.sqrt(intra)
            np.fill_diagonal(intra, np.inf)
            order = np.argsort(intra, axis=1, kind="stable")[:, : cfg.m]
            intra_d = np.take_along_axis(intra, order, axis=1)
            intra_s = sub[order]
            cand_d = np.concatenate([cand_d, intra_d], axis=1)
            cand_s = np.concatenate([cand_s, intra_s.astype(np.int32)], axis=1)
            reorder = np.argsort(cand_d, axis=1, kind="stable")
            cand_d = np.take_along_axis(cand_d, reorder, axis=1)
            cand_s = np.take_along_axis(cand_s, reorder, axis=1)

        m = cfg.m
        # beam rows are duplicate-free and disjoint from the round's nodes:
        # the forward neighbours are the first M finite candidates
        finite = (cand_s != IDX_SENTINEL) & np.isfinite(cand_d)
        neighbors = np.full((b, m), -1, dtype=np.int32)
        for i in range(b):
            row = cand_s[i][finite[i]][:m]
            neighbors[i, : len(row)] = row
        self._adj0[sub, :m] = neighbors
        touched.update(int(s) for s in sub)

        # reverse edges, batched over the round (hnsw_index.go:535-546, 667-694)
        valid = neighbors >= 0
        if valid.any():
            nbr = neighbors[valid].astype(np.int64)
            new = np.repeat(sub, valid.sum(axis=1))
            uniq = self._batch_reverse_edges(self._adj0, 2 * m, nbr, new)
            touched.update(int(u) for u in uniq)

        # upper layers: forward rows per node, reverse edges per level
        upper_pairs: dict[int, tuple[list, list]] = {}
        for i in np.flatnonzero(sub_levels > 0):
            slot = int(sub[i])
            level = int(sub_levels[i])
            css = cand_s[i][finite[i]]
            for lvl in range(1, level + 1):
                self._ensure_level(lvl)
                at_level = css[self._levels[css] >= lvl][:m]
                self._upper[lvl][slot, : len(at_level)] = at_level
                if len(at_level):
                    nbrs, news = upper_pairs.setdefault(lvl, ([], []))
                    nbrs.extend(int(x) for x in at_level)
                    news.extend([slot] * len(at_level))
        for lvl, (nbrs, news) in upper_pairs.items():
            self._batch_reverse_edges(self._upper[lvl], m, np.asarray(nbrs, dtype=np.int64),
                                      np.asarray(news, dtype=np.int64))

        best = int(np.argmax(sub_levels))
        if int(sub_levels[best]) > self._max_level:
            self._max_level = int(sub_levels[best])
            self._entry_slot = int(sub[best])

        self._graph_version += 1
        self._scatter_device(np.fromiter(touched, dtype=np.int64), version)

    def _batch_reverse_edges(self, adj: np.ndarray, capacity: int, nbr: np.ndarray,
                             new: np.ndarray) -> np.ndarray:
        """Append each reverse edge (new[i] into nbr[i]'s row) and prune
        every overflowing row to its `capacity` nearest, in one vectorised
        pass. Returns the touched rows."""
        order = np.argsort(nbr, kind="stable")
        nbr_s, new_s = nbr[order], new[order]
        uniq, starts, counts = np.unique(nbr_s, return_index=True, return_counts=True)
        maxc = int(counts.max())
        w0 = capacity
        cand_mat = np.full((len(uniq), w0 + maxc), -1, dtype=np.int64)
        cand_mat[:, :w0] = adj[uniq]
        rows = np.searchsorted(uniq, nbr_s)
        cols = np.arange(len(nbr_s)) - starts[rows]
        cand_mat[rows, w0 + cols] = new_s
        # a mutual selection puts a new node in a row and in its appends
        cm_valid = cand_mat >= 0
        ordv = np.argsort(cand_mat, axis=1, kind="stable")
        sv = np.take_along_axis(cand_mat, ordv, axis=1)
        rep = np.zeros_like(cand_mat, dtype=bool)
        rep[:, 1:] = sv[:, 1:] == sv[:, :-1]
        dup = np.zeros_like(rep)
        np.put_along_axis(dup, ordv, rep, axis=1)
        keepable = cm_valid & ~dup
        cand_mat = np.where(keepable, cand_mat, -1)

        fill = keepable.sum(axis=1)
        over = fill > w0
        # rows within capacity: compact left, no distances needed
        if (~over).any():
            rows_u = np.flatnonzero(~over)
            cm_u = cand_mat[rows_u]
            order_u = np.argsort(cm_u < 0, axis=1, kind="stable")
            adj[uniq[rows_u]] = np.take_along_axis(cm_u, order_u, axis=1)[:, :w0].astype(np.int32)
        # overflowing rows: keep the nearest
        if over.any():
            rows_o = np.flatnonzero(over)
            cm_o = cand_mat[rows_o]
            safe = np.maximum(cm_o, 0)
            d = self._dist_rows_cmp(self._store.vectors[uniq[rows_o]], self._store.vectors[safe],
                                    self._sqn0[safe], an=self._sqn0[uniq[rows_o]])
            d = np.where(cm_o >= 0, d, np.inf)
            keep = np.argsort(d, axis=1, kind="stable")[:, :w0]
            adj[uniq[rows_o]] = np.take_along_axis(cm_o, keep, axis=1).astype(np.int32)
        return uniq

    def remove(self, node_id: int) -> None:
        """Soft delete: excluded from results, still routes traversal."""
        with self._lock:
            self._store.remove(node_id)

    def flush(self) -> None:
        """Hard-delete with slot compaction, adjacency remap and entry-point
        repair (hnsw_index.go:384-413)."""
        with self._lock:
            self._graph_version += 1
            old_cap = self._store.capacity
            keep = np.flatnonzero(self._store.valid[: self._store.n])
            self._store.flush()
            n_new = len(keep)
            remap = np.full(old_cap, -1, dtype=np.int32)
            remap[keep] = np.arange(n_new, dtype=np.int32)

            def remap_adj(adj: np.ndarray, width: int) -> np.ndarray:
                out = np.full((len(adj), width), -1, dtype=np.int32)
                rows = adj[keep]
                vals = np.where(rows >= 0, remap[np.maximum(rows, 0)], -1)
                order = np.argsort(vals < 0, axis=1, kind="stable")
                out[:n_new] = np.take_along_axis(vals, order, axis=1)
                return out

            self._adj0 = remap_adj(self._adj0, 2 * self._cfg.m)
            new_levels = np.full(old_cap, -1, dtype=np.int32)
            new_levels[:n_new] = self._levels[keep]
            self._levels = new_levels
            new_sqn = np.zeros(old_cap, dtype=np.float32)
            new_sqn[:n_new] = self._sqn0[keep]
            self._sqn0 = new_sqn
            for lvl in list(self._upper):
                self._upper[lvl] = remap_adj(self._upper[lvl], self._cfg.m)
            if n_new == 0:
                self._entry_slot = -1
                self._max_level = -1
                self._upper = {}
            else:
                best = int(np.argmax(self._levels[:n_new]))
                self._entry_slot = best
                self._max_level = int(self._levels[best])
                self._upper = {lvl: adj for lvl, adj in self._upper.items()
                               if lvl <= self._max_level}

    # -- entry choice -----------------------------------------------------------

    def _ensure_dev_l1(self) -> None:
        """Device tables of the level >= 1 members: slots, bf16-rounded
        vectors and squared norms, refreshed when the graph changed."""
        if self._dev_l1_version == self._graph_version and self._dev_l1 is not None:
            return
        members = np.nonzero(self._levels[: self._store.capacity] >= 1)[0]
        self._dev_l1_version = self._graph_version
        if len(members) == 0:
            self._dev_l1 = None
            return
        vecs, sqnorms, _ = self._store.device_state()
        slots = torch.from_numpy(members.astype(np.int32)).to(self._device)
        self._dev_l1 = (bf16_round(vecs[slots.long()]), sqnorms[slots.long()], slots)

    def _descend_for_search(self, q: torch.Tensor) -> torch.Tensor:
        """Layer-0 entry per query: the nearest level >= 1 member
        (ops/beam_kernel.nearest_entry), or the entry point."""
        if self._max_level >= 1 and self._upper:
            self._ensure_dev_l1()
            if self._dev_l1 is not None:
                return bk.nearest_entry(q, *self._dev_l1)
        return torch.full((q.shape[0],), self._entry_slot, dtype=torch.int32, device=q.device)

    # -- seeded start -------------------------------------------------------------

    def _seed_nlist(self, n: int) -> int:
        return max(64, min(4096, next_pow2(int(n ** 0.5))))

    def _assign_new_slots(self, n: int) -> None:
        """Extend the per-slot seed-assignment cache to [assign_n, n)."""
        cap = self._store.capacity
        if self._seed_assign is None or len(self._seed_assign) < cap:
            a = np.full(cap, -1, np.int32)
            if self._seed_assign is not None:
                a[: self._seed_assign_n] = self._seed_assign[: self._seed_assign_n]
            self._seed_assign = a
        if n <= self._seed_assign_n:
            return
        new_sl = np.arange(self._seed_assign_n, n)
        new_sl = new_sl[self._store.valid[new_sl]]
        cents = torch.from_numpy(self._seed_centroids).to(self._device)
        ch = 1 << 18
        for i0 in range(0, len(new_sl), ch):
            sl = new_sl[i0: i0 + ch]
            x = torch.from_numpy(self._store.vectors[sl]).to(self._device)
            self._seed_assign[sl] = find_nearest_centroid(x, cents).cpu().numpy()
        self._seed_assign_n = n

    def _ensure_seed(self) -> dict:
        """Cluster-probe seed tables, maintained across mutations as the
        reference does: k-means into ~sqrt(n) cells (a 2^17-row sample of
        larger corpora, drawn from the index's generator), the valid slots
        laid out cluster-major with a bf16 copy of their vectors and the
        float32 value of their bf16 squared norms as the mask; removals
        refresh the mask, and the layout is rebuilt once the delta passes
        SEED_REBUILD_FRAC, a flush or a retrain."""
        if self._seed_version == self._store.version:
            return self._seed_state
        store = self._store
        n = store.n
        nlist = self._seed_nlist(n)
        retrain = (self._seed_centroids is None or len(self._seed_centroids) != nlist
                   or n > 2 * self._seed_trained_n)
        flushed = self._seed_state is not None and (
            n < self._seed_layout_n or store.deleted < self._seed_layout_deleted)
        if retrain:
            sample = store.vectors[:n]
            if n > (1 << 17):
                sel = self._rng.choice(n, 1 << 17, replace=False)
                sample = sample[np.sort(sel)]
            cents, _ = kmeans(torch.from_numpy(np.ascontiguousarray(sample)).to(self._device),
                              nlist, DistanceKind.L2_SQUARED, 10)
            self._seed_centroids = cents.cpu().numpy()
            self._seed_trained_n = n
            self._seed_order_key = sp.cluster_order_key(self._seed_centroids, device=self._device)
        if retrain or flushed:
            self._seed_assign = None
            self._seed_assign_n = 0
        self._assign_new_slots(n)

        adds = n - self._seed_layout_n
        dels = max(store.deleted - self._seed_layout_deleted, 0)
        rebuild = (self._seed_state is None or retrain or flushed
                   or (adds + dels) > max(SEED_REBUILD_MIN,
                                          int(self._seed_layout_n * SEED_REBUILD_FRAC)))
        _, sqnorms, valid = store.device_state()
        if not rebuild:
            st = self._seed_state
            perm = st["row_slot"]
            ok = (perm >= 0) & valid[perm.clamp_min(0).long()]
            st["mask_vec"] = torch.where(ok, st["base_mask"], float("inf"))
            self._seed_version = store.version
            return st
        self._seed_state = None   # free the old layout before the new one
        assign = np.where(store.valid[:n], self._seed_assign[:n], -1).astype(np.int32)
        lay = sp.build_cluster_major(assign, nlist)
        vecs = store.device_state()[0]
        perm = torch.from_numpy(lay["perm"]).to(self._device)
        pc = perm.clamp_min(0).long()
        mask = torch.where(perm >= 0, bf16_round(sqnorms[pc]),
                           torch.full((len(perm),), float("inf"), device=self._device))
        self._seed_state = {
            "nlist": nlist,
            "corpus": vecs[pc].to(torch.bfloat16),
            "mask_vec": mask,
            "base_mask": mask,
            "row_slot": perm,
            "centroids": torch.from_numpy(self._seed_centroids).to(self._device),
            "order_key": torch.from_numpy(self._seed_order_key).to(self._device),
            "chunk_start": torch.from_numpy(lay["chunk_start"]).to(self._device),
            "nchunks": torch.from_numpy(lay["nchunks"]).to(self._device),
            "nch_total": int(lay["chunk_start"][-1]),
            "max_chunks": lay["max_chunks"],
        }
        self._seed_layout_n = n
        self._seed_layout_deleted = store.deleted
        self._seed_version = store.version
        return self._seed_state

    def _seed_scan(self, q: torch.Tensor, qn: torch.Tensor, seed_k: int):
        """The top-seed_k cluster-probe seeds of one query chunk, (seed_d,
        seed_s) [Q, seed_k] in the beam's bf16 distance domain, sorted by
        (dist, slot), (+inf, SENT) padded."""
        st = self._ensure_seed()
        nprobe = self._cfg.seed_nprobe or max(2, st["nlist"] // 64)
        nprobe = min(nprobe, st["nlist"] - 1)
        S, UC, MC = sp.default_budgets(nprobe, st["nlist"], st["nch_total"], st["max_chunks"])
        kb_cap = self._cfg.seed_kb
        if kb_cap == 0:
            kb_cap = max(seed_k // 4, 32)
        elif kb_cap < 0:
            kb_cap = 0  # exact
        sd, ss, overflow = sp.ivf_sparse_pipeline(
            q, st["corpus"], st["mask_vec"], st["row_slot"], float("inf"), st["centroids"],
            st["order_key"], st["chunk_start"], st["nchunks"],
            k=seed_k, nprobe=nprobe, S=S, UC=UC, MC=MC, nlist=st["nlist"],
            bf16_domain=True, kb_cap=kb_cap, qn=qn,
        )
        ov = overflow.sum().to(torch.int64)
        starved = (ss[:, 0] == IDX_SENTINEL).sum().to(torch.int64)
        self._seed_overflow = ov if self._seed_overflow is None else self._seed_overflow + ov
        self._seed_starved = (starved if self._seed_starved is None
                              else self._seed_starved + starved)
        return sd, ss

    def _use_seed(self) -> bool:
        """The seeded start serves the routing-table beam only."""
        if not self._cfg.seed_search:
            return False
        env = os.environ.get("COMET_HNSW_SEED", "")
        if env == "0":
            return False
        return self._store.n >= SEED_MIN_N or env == "1"

    # -- search ---------------------------------------------------------------

    def _sq_threshold(self, threshold: float) -> float:
        """The metric-space threshold in the beam's squared-distance space
        (+inf when disabled; threshold 0 = disabled)."""
        if threshold <= 0:
            return float("inf")
        t = float(threshold)
        if self._distance_kind == DistanceKind.L2:
            t = t * t
        elif self._distance_kind == DistanceKind.COSINE:
            t = 2.0 * t
        return float(np.float32(t))

    def _from_sq(self, scores: np.ndarray) -> np.ndarray:
        """Squared beam distances -> the index's metric space."""
        finite = np.isfinite(scores)
        if self._distance_kind == DistanceKind.L2:
            return np.where(finite, np.sqrt(np.maximum(scores, 0.0)), scores)
        if self._distance_kind == DistanceKind.COSINE:
            return np.where(finite, scores * 0.5, scores)
        return scores

    def _search_launch(self, queries: np.ndarray, builder: VectorSearchBuilder):
        store = self._store
        n_slots = store.n
        q_in = queries.shape[0]
        if n_slots == 0 or self._entry_slot < 0:
            return ("empty", q_in)
        k_eff = sanitize_k(builder._k, n_slots)
        ef = max(self._effective_ef(builder._ef_search), k_eff)
        k_pad = min(next_pow2(k_eff), store.capacity)
        ef_pad = next_pow2(ef, 16)
        qpad, q_real = pad_queries(preprocess(queries, self._distance_kind))
        _, _, valid = store.device_state()
        allowed = valid
        fmask = DocumentFilter(builder._document_ids).slot_mask(store.ids)
        if fmask is not None:
            allowed = allowed & torch.from_numpy(np.ascontiguousarray(fmask)).to(self._device)
        # result admission == beam membership unless something filters
        fused = fmask is not None or builder._threshold > 0 or store.deleted > 0
        tables = self._routing_tables()
        if tables is None:
            chunks = self._graph_launch(qpad, allowed, builder._threshold, ef_pad, k_pad, fused,
                                        k_eff, builder._wire_scores)
        else:
            chunks = self._beam_launch(tables, qpad, allowed, builder._threshold, ef_pad, k_pad,
                                       fused, k_eff, builder._wire_scores)
        return ("hnsw", chunks, q_real, k_eff, store.ids, tables is not None)

    def _graph_launch(self, qpad, allowed, threshold, ef_pad, k_pad, fused, k_eff,
                      wire_scores=True):
        """The graph beam (ops/graph.py) over each chunk of GRAPH_QUERY_CHUNK
        queries from a host descent, for a graph whose routing table would
        pass BLOCKED_TABLE_BYTES_MAX. Returns per chunk the device
        (metric-space scores or None, slots) [chunk, k_eff]."""
        vecs, sqnorms, _ = self._store.device_state()
        thr = float(threshold_scalar(threshold))
        chunks = []
        for q0 in range(0, qpad.shape[0], GRAPH_QUERY_CHUNK):
            qc = np.ascontiguousarray(qpad[q0: q0 + GRAPH_QUERY_CHUNK])
            entries = torch.from_numpy(self._descend(qc)).to(self._device)
            sd, ss = beam_search_layer0(
                torch.from_numpy(qc).to(self._device), entries, self._dev_adj, vecs, sqnorms,
                allowed, thr, ef_pad, k_pad, self._distance_kind,
                (4 * ef_pad + 32) // GRAPH_EXPAND + 16, GRAPH_EXPAND, fused)
            chunks.append((sd[:, :k_eff] if wire_scores else None, ss[:, :k_eff]))
        return chunks

    def _beam_launch(self, tables, qpad, allowed, threshold, ef_pad, k_pad, fused, k_eff,
                     wire_scores=True):
        """The routing-table beam over each chunk of SEARCH_QUERY_CHUNK
        queries, each padded to a multiple of 128. Returns per chunk the
        device (squared scores or None, slots) [chunk, k_eff]."""
        nbr_vecs, aux = tables
        vecs, sqnorms, _ = self._store.device_state()
        sq_thr = self._sq_threshold(threshold)
        seeded = self._use_seed()
        if seeded:
            # seeds fill the beam with near neighbours: stop on the k-window
            # row rather than expand every seed
            stop = min(self._cfg.seed_stop or max(2 * k_pad, 64), ef_pad)
            seed_k = min(self._cfg.seed_width or 128, stop)
            max_iters = self._cfg.search_iters or max((2 * stop) // BEAM_EXPAND // 2, 12)
        else:
            stop = None
            max_iters = self._cfg.search_iters or max(2 * ef_pad // BEAM_EXPAND, 48)
        chunks = []
        for q0 in range(0, qpad.shape[0], SEARCH_QUERY_CHUNK):
            qc = qpad[q0: q0 + SEARCH_QUERY_CHUNK]
            if qc.shape[0] % sp.QG:
                grown = np.zeros((-(-qc.shape[0] // sp.QG) * sp.QG, qc.shape[1]), np.float32)
                grown[: qc.shape[0]] = qc
                qc = grown
            q = torch.from_numpy(np.ascontiguousarray(qc)).to(self._device)
            qn = bk.row_sqnorms(q)
            if seeded:
                seeds = self._seed_scan(q, qn, seed_k)
                # the entry point is the probe-starved queries' start
                entries = torch.full((q.shape[0],), max(self._entry_slot, 0), dtype=torch.int32,
                                     device=self._device)
            else:
                seeds = None
                entries = self._descend_for_search(q)
            sd, ss = bk.beam_search_blocked(
                q, entries, nbr_vecs, aux, vecs, sqnorms, allowed, sq_thr, ef_pad, k_pad,
                BEAM_EXPAND, max_iters, fused, seeds=seeds, stop=stop, qn=qn,
                fuse=_use_fused_beam(),
            )
            chunks.append((sd[:, :k_eff] if wire_scores else None, ss[:, :k_eff]))
        return chunks

    def _search_collect(self, handle):
        if handle[0] == "empty":
            q_in = handle[1]
            return (np.full((q_in, 0), INVALID_ID, dtype=np.uint32),
                    np.zeros((q_in, 0), dtype=np.float32))
        _, chunks, q_real, k_eff, ids_arr, squared = handle
        slots = np.concatenate([i.cpu().numpy() for _, i in chunks])
        if chunks[0][0] is None:
            scores = np.zeros(slots.shape, dtype=np.float32)
        else:
            scores = np.concatenate([s.cpu().numpy() for s, _ in chunks])
            if squared:
                scores = self._from_sq(scores)
        scores = scores[:q_real, :k_eff]
        slots = slots[:q_real, :k_eff]
        hit = slots != IDX_SENTINEL
        ids = np.where(hit, ids_arr[np.where(hit, slots, 0)], INVALID_ID)
        return ids.astype(np.uint32), scores.astype(np.float32)

    # -- serialization ----------------------------------------------------------

    def write_to(self, f: BinaryIO) -> None:
        """CHNW v2: params + vectors + levels + adjacency + CRC32 trailer.
        Flushes first."""
        with self._lock:
            self.flush()
            n = self._store.n
            w = serial.CrcWriter(f)
            serial.write_magic(w, MAGIC, VERSION)
            serial.write_str(w, self._distance_kind.value)
            serial.write_u32(w, self._dim)
            serial.write_u32(w, self._cfg.m)
            serial.write_u32(w, self._cfg.ef_construction)
            serial.write_u32(w, self._cfg.ef_search)
            serial.write_i64(w, self._entry_slot)
            serial.write_i64(w, self._max_level)
            serial.write_u64(w, n)
            serial.write_array(w, self._store.ids[:n])
            serial.write_array(w, self._store.vectors[:n])
            serial.write_array(w, self._levels[:n])
            serial.write_array(w, self._adj0[:n])
            serial.write_u32(w, len(self._upper))
            for lvl in sorted(self._upper):
                serial.write_u32(w, lvl)
                serial.write_array(w, self._upper[lvl][:n])
            w.seal()

    def read_from(self, f: BinaryIO) -> None:
        r = serial.CrcReader(f)
        version = serial.read_magic(r, MAGIC, VERSION)
        kind = DistanceKind(serial.read_str(r))
        dim = serial.read_u32(r)
        m = serial.read_u32(r)
        efc = serial.read_u32(r)
        efs = serial.read_u32(r)
        if kind != self._distance_kind or dim != self._dim:
            raise serial.SerializationError(
                f"param mismatch: index=({self._distance_kind.value}, dim={self._dim}), "
                f"stored=({kind.value}, dim={dim})")
        if m != self._cfg.m or efc != self._cfg.ef_construction:
            raise serial.SerializationError(
                f"HNSW param mismatch: index=(M={self._cfg.m}, efC={self._cfg.ef_construction}), "
                f"stored=(M={m}, efC={efc})")
        entry = serial.read_i64(r)
        max_level = serial.read_i64(r)
        n = serial.read_u64(r)
        ids = serial.read_array(r)
        vectors = serial.read_array(r)
        levels = serial.read_array(r)
        adj0 = serial.read_array(r)
        n_upper = serial.read_u32(r)
        upper = {}
        for _ in range(n_upper):
            lvl = serial.read_u32(r)
            upper[lvl] = serial.read_array(r)
        if version >= 2:
            r.verify()
        if (len(ids) != n or vectors.shape != (n, dim) or len(levels) != n
                or adj0.shape != (n, 2 * m)):
            raise serial.SerializationError("corrupt HNSW index payload")
        with self._lock:
            self._cfg.ef_search = efs
            self._store = type(self._store)(dim, capacity=max(n, 1), device=self._device)
            self._reset_seed()
            cap = self._store.capacity
            self._levels = np.full(cap, -1, dtype=np.int32)
            self._sqn0 = np.zeros(cap, dtype=np.float32)
            self._adj0 = np.full((cap, 2 * m), -1, dtype=np.int32)
            self._upper = {}
            if n:
                self._store.add_batch(ids.astype(np.uint32), vectors.astype(np.float32))
                v32 = self._store.vectors[:n]
                self._sqn0[:n] = (v32 * v32).sum(axis=1)
                self._levels[:n] = levels
                self._adj0[:n] = adj0
                for lvl, arr in upper.items():
                    grown = np.full((cap, m), -1, dtype=np.int32)
                    grown[:n] = arr
                    self._upper[lvl] = grown
            self._entry_slot = int(entry)
            self._max_level = int(max_level)
            self._graph_version += 1
