"""Corpus sharding over a mesh of torch devices.

Counterpart of comet_tpu/parallel/sharded.py, which shards over a JAX
device mesh with `shard_map`. Here one process drives a list of devices,
as `shard_map` does; a device may repeat, so `[cuda:0] * 4` is four
shards on one card.

- Search: the corpus [N, d] is split by row over the mesh, one contiguous
  block a device. Each shard runs the package's own exact scan on its
  block (ops/fused_scan: kernel K2, then K1's two selects; K2's nprobe
  mode for IVF), offsets its local slots by `shard * n_local` (never a
  sentinel), and the shards' [Q, k] (score, slot) pairs meet on the
  mesh's first device, the gather device, where K1 keeps the best k of
  each query by (score, slot): the order of the reference's
  `lax.sort(num_keys=2)` after its `all_gather`.
- IVF: the probes are computed once, on the gather device, as the
  reference computes them (the coarse kind's full distances, then the
  top-nprobe, ties to the lower centroid id), and handed to every shard.
- K-means training: per-shard partial sums and counts are added on the
  gather device in shard order (the reference's `psum`).
- HNSW: the queries are split over the mesh and the graph is replicated;
  each shard runs the graph beam (ops/graph.py) on its queries. A
  replicated tensor already on a shard's device is not copied.

A global slot is a row's index in the padded corpus, as in the reference.
K2 needs whole 128-row groups, so each shard is padded further on its own
device with rows that are never valid; that padding moves no slot. The
reference's `tile` arguments stay in the signatures and set only the
flat searcher's padding.

The reference's flat searcher preprocesses the queries but not the
corpus, so a cosine search over rows that are not unit vectors clips
every inner product above 1 to a distance of 0. This port returns the
same results (K2's cosine epilogue `1 - clamp(ip, -1, 1)` over the raw
rows), and tests/test_torch_sharded.py pins it.

Searches return numpy arrays, as the reference's do. The searchers read
an index's state when they are built: build a new one after the index
changes.
"""

from __future__ import annotations

import numpy as np
import torch

from comet_tpu_torch.core.filter import DocumentFilter
from comet_tpu_torch.core.limiter import sanitize_k
from comet_tpu_torch.fusion import default_fusion, new_fusion
from comet_tpu_torch.hybrid import fuse_batch_rows
from comet_tpu_torch.indexes.base import (
    INVALID_ID,
    next_pow2,
    postprocess_batch_rows,
    resolve_device,
    threshold_scalar,
)
from comet_tpu_torch.indexes.hnsw import GRAPH_EXPAND, HNSWIndex, pad_queries
from comet_tpu_torch.indexes.ivf import IVFIndex
from comet_tpu_torch.indexes.ivfpq import IVFPQIndex
from comet_tpu_torch.indexes.pq import PQIndex
from comet_tpu_torch.ops import fused_scan, sortnet
from comet_tpu_torch.ops.adc import pq_decode
from comet_tpu_torch.ops.distance import pairwise_scores, preprocess
from comet_tpu_torch.ops.graph import beam_search_layer0
from comet_tpu_torch.ops.kmeans import _nearest, find_nearest_centroid, kmeans
from comet_tpu_torch.ops.topk import IDX_SENTINEL, INF
from comet_tpu_torch.types import DistanceKind, InvalidConfigError


class Mesh:
    """A 1-D mesh of torch devices, one a shard (the reference's jax Mesh
    over its one axis). A device may repeat. `devices[0]` is the gather
    device."""

    def __init__(self, devices):
        devs = []
        for d in devices:
            dev = resolve_device(d)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            devs.append(dev)
        if not devs:
            raise InvalidConfigError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def gather_device(self) -> torch.device:
        return self.devices[0]


def make_corpus_mesh(devices=None) -> Mesh:
    """1-D mesh over every CUDA device, or over the devices given (repeats
    allowed). Without an argument and without a card it raises: it never
    builds a CPU mesh by itself."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise InvalidConfigError(
                "make_corpus_mesh(): no CUDA device; pass the devices, "
                "e.g. [torch.device('cpu')] * 4")
        devices = [torch.device("cuda", i) for i in range(count)]
    return Mesh(devices)


def _replicate(mesh: Mesh, t: torch.Tensor) -> tuple:
    """`t` on every device of the mesh, copied once a distinct device (not
    at all to its own)."""
    on: dict = {}
    for dev in mesh.devices:
        if dev not in on:
            on[dev] = t.to(dev)
    return tuple(on[dev] for dev in mesh.devices)


def shard_rows(mesh: Mesh, *arrays):
    """Split each array's leading axis evenly over the mesh, one contiguous
    block a device in mesh order (the rows must divide evenly); a 0-d array
    is replicated. Returns for each array a tuple of mesh.size tensors, the
    blocks copies; a single tuple for a single array."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a)
        if t.ndim == 0:
            out.append(_replicate(mesh, t))
            continue
        if t.shape[0] % mesh.size:
            raise ValueError(f"{t.shape[0]} rows do not divide evenly over {mesh.size} devices")
        per = t.shape[0] // mesh.size
        out.append(tuple(t[i * per:(i + 1) * per].to(dev, copy=True)
                         for i, dev in enumerate(mesh.devices)))
    return tuple(out) if len(out) > 1 else out[0]


def _pad_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    out = t.new_full((rows,) + tuple(t.shape[1:]), fill)
    out[: t.shape[0]] = t
    return out


class _Rows:
    """A row-sharded corpus as K2 reads it: shard i holds rows
    [i * n_local, (i + 1) * n_local) of the padded corpus on the device of
    its block, padded on that device to whole GROUPs of rows that are
    never valid (assign -1)."""

    def __init__(self, corpus, valid, assign=None, sqnorms=None):
        self.n_local = corpus[0].shape[0]
        if any(x.shape[0] != self.n_local for x in corpus):
            raise ValueError("every shard must hold the same number of rows")
        g = fused_scan.GROUP
        self.rows = max(-(-self.n_local // g), 1) * g
        self.corpus = [_pad_rows(x.to(torch.float32), self.rows, 0.0) for x in corpus]
        if sqnorms is None:
            self.sqnorms = [(x * x).sum(dim=1) for x in self.corpus]
        else:
            self.sqnorms = [_pad_rows(s.to(torch.float32), self.rows, 0.0) for s in sqnorms]
        self.valid = self.pad_valid(valid)
        self.assign = (None if assign is None else
                       [_pad_rows(a.to(torch.int32), self.rows, -1) for a in assign])

    def pad_valid(self, valid) -> list:
        return [_pad_rows(v.to(torch.bool), self.rows, False) for v in valid]


def _on_gather(mesh: Mesh, x) -> torch.Tensor:
    """A float32 array or tensor on the gather device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(mesh.gather_device, torch.float32)


def _merge(scores: torch.Tensor, slots: torch.Tensor, k: int):
    """K1 over the gathered [Q, S k] candidates, in the reference's column
    layout: the best k of each query by (score, slot)."""
    if scores.shape[0] == 0:
        return scores[:, :k], slots[:, :k]
    v, i = sortnet.topk_cl(scores.T, slots.T, k)
    return v[:k].T.contiguous(), i[:k].T.contiguous()


def _scan(mesh: Mesh, rows: _Rows, queries: torch.Tensor, k: int, kind: DistanceKind,
          threshold, valid=None, probes=None, nlist: int = 0):
    """Every shard's exact top-k of `queries` (on the gather device) over
    its rows, with K2 and K1 (K2's nprobe mode given `probes`), its slots
    made global, then merged by K1 on the gather device. `threshold` is in
    the metric's space; `valid` replaces the rows' validity. Returns
    (scores [Q, k], slots [Q, k]) on the gather device."""
    cosine = kind == DistanceKind.COSINE
    thr = float(threshold)
    thr_k = thr * thr if kind == DistanceKind.L2 else thr   # K2 thresholds L2 squared
    valid = rows.valid if valid is None else valid
    qs = _replicate(mesh, queries)
    ps = _replicate(mesh, probes) if probes is not None else None
    g = mesh.gather_device
    part_s, part_i = [], []
    for i, dev in enumerate(mesh.devices):
        base = torch.zeros_like(rows.sqnorms[i]) if cosine else rows.sqnorms[i]
        mask = torch.where(valid[i], base, torch.full_like(base, INF))
        kk = min(k, rows.rows)
        s, sl = fused_scan._pipeline(
            qs[i], rows.corpus[i], mask, thr_k, kk, cosine, kind == DistanceKind.L2,
            rows.assign[i] if probes is not None else None,
            ps[i] if probes is not None else None, nlist)
        sl = torch.where(sl == IDX_SENTINEL, sl, sl + i * rows.n_local)
        if kk < k:
            s = torch.cat([s, s.new_full((s.shape[0], k - kk), INF)], dim=1)
            sl = torch.cat([sl, sl.new_full((sl.shape[0], k - kk), IDX_SENTINEL)], dim=1)
        part_s.append(s.to(g))
        part_i.append(sl.to(g))
    return _merge(torch.cat(part_s, dim=1), torch.cat(part_i, dim=1), k)


def _probes(queries: torch.Tensor, centroids: torch.Tensor, nprobe: int,
            kind: DistanceKind) -> torch.Tensor:
    """[Q, width] int32: each query's nprobe nearest centroids by the
    coarse kind's distance (`pairwise_scores`, the square root for L2),
    ties to the lower id (K1), padded to K2's probe width by repeating
    probe 0 (fused_scan.ivf_topk_pipeline)."""
    nlist = centroids.shape[0]
    probes = sortnet.topk_rows(pairwise_scores(queries, centroids, kind), None, nprobe)[1]
    probes = probes[:, :nprobe]
    width = fused_scan.probe_pad(nprobe)
    if nlist >= 8:
        width = min(width, nlist)
    if width > nprobe:
        probes = torch.cat([probes, probes[:, :1].expand(-1, width - nprobe)], dim=1)
    return probes.contiguous()


def _ivf_scan(mesh, rows, queries, centroids, k, kind, coarse_kind, nprobe, threshold,
              valid=None):
    probes = _probes(queries, centroids, nprobe, coarse_kind)
    return _scan(mesh, rows, queries, k, kind, threshold, valid, probes, centroids.shape[0])


def _default_nprobe(nprobe, nlist: int) -> int:
    nprobe = int(nprobe) if nprobe else max(int(round(nlist ** 0.5)), 1)
    return min(nprobe, nlist)


def make_sharded_search(mesh: Mesh, k: int, kind: DistanceKind, tile: int):
    """Build the sharded exact-search step.

    fn(queries [Q, d] (preprocessed), corpus, sqnorms, valid (each a tuple
    of shards, as `shard_rows` gives them), threshold (metric space, +inf
    disables)) -> (scores [Q, k], global slots [Q, k]) on the gather
    device. `tile` is the reference's; K2 scans each shard whole."""
    kind = DistanceKind(kind)

    def fn(queries, corpus, sqnorms, valid, threshold):
        rows = _Rows(corpus, valid, sqnorms=sqnorms)
        return _scan(mesh, rows, _on_gather(mesh, queries), k, kind, threshold)

    return fn


def make_sharded_kmeans_step(mesh: Mesh, kind: DistanceKind):
    """Build the distributed k-means step (assignment, then the update from
    the shards' partial sums).

    fn(vectors, valid, prev_assign (each a tuple of shards), centroids
    [k, d]) -> (assign (a tuple of shards, int32, k on invalid rows),
    new_centroids [k, d], changed 0-d int32), the last two on the gather
    device. Each shard assigns by `pairwise_scores` + argmin (the first
    minimum) and sums into k + 1 rows with `index_add_`, the extra row
    taking the invalid rows; the sums and counts are added on the gather
    device in shard order, and `changed` is their max. Empty clusters
    keep their centroid (clustering.go:236-238 of the Go reference). On the
    card `index_add_` adds in no fixed order (ops/kmeans.py)."""
    kind = DistanceKind(kind)

    def fn(vectors, valid, prev_assign, centroids):
        g = mesh.gather_device
        cents = _on_gather(mesh, centroids)
        k = cents.shape[0]
        cs = _replicate(mesh, cents)
        assigns, sums, counts, changed = [], None, None, None
        for i in range(mesh.size):
            x, v = vectors[i].to(torch.float32), valid[i].to(torch.bool)
            a = torch.where(v, _nearest(x, cs[i], kind), k)
            s = torch.zeros((k + 1, x.shape[1]), dtype=torch.float32, device=x.device)
            s.index_add_(0, a, x)
            c = torch.zeros(k + 1, dtype=torch.float32, device=x.device)
            c.index_add_(0, a, v.to(torch.float32))
            ch = ((a != prev_assign[i].to(a.device)) & v).any().to(torch.int32).to(g)
            s, c = s[:k].to(g), c[:k].to(g)
            sums = s if sums is None else sums + s
            counts = c if counts is None else counts + c
            changed = ch if changed is None else torch.maximum(changed, ch)
            assigns.append(a.to(torch.int32))
        col = counts[:, None]
        new = torch.where(col > 0, sums / torch.clamp_min(col, 1.0), cents)
        return tuple(assigns), new, changed

    return fn


def make_sharded_ivf_search(
    mesh: Mesh, k: int, kind: DistanceKind, nprobe: int, tile: int,
    coarse_kind: DistanceKind | None = None,
):
    """Build the sharded IVF search step: inverted lists sharded by row,
    centroids replicated, the probes computed once on the gather device
    and every shard's rows scanned in K2's nprobe mode.

    fn(queries [Q, d] (preprocessed), corpus, sqnorms, assign (int32, -1 =
    invalid), valid (each a tuple of shards), centroids [nlist, d],
    threshold) -> (scores [Q, k], global slots [Q, k]) on the gather
    device. `tile` is the reference's."""
    kind = DistanceKind(kind)
    ckind = DistanceKind(coarse_kind) if coarse_kind is not None else kind

    def fn(queries, corpus, sqnorms, assign, valid, centroids, threshold):
        rows = _Rows(corpus, valid, assign=assign, sqnorms=sqnorms)
        q = _on_gather(mesh, queries)
        return _ivf_scan(mesh, rows, q, _on_gather(mesh, centroids), k, kind, ckind,
                         nprobe, threshold)

    return fn


class ShardedFlatSearcher:
    """Shard a corpus once, search it many times: the rows split over the
    mesh, every search scans each shard and merges the shards' k best."""

    def __init__(self, mesh: Mesh, corpus: np.ndarray,
                 kind: DistanceKind = DistanceKind.L2, tile: int = 1 << 17):
        corpus = np.asarray(corpus, dtype=np.float32)
        n_dev = mesh.size
        n = corpus.shape[0]
        shard = -(-n // n_dev)
        # pad so rows divide evenly over devices and tiles
        shard = max(((shard + tile - 1) // tile) * tile, tile) if shard > tile else shard
        n_pad = shard * n_dev
        pad = np.zeros((n_pad, corpus.shape[1]), dtype=np.float32)
        pad[:n] = corpus
        valid = np.zeros(n_pad, dtype=bool)
        valid[:n] = True
        self.mesh = mesh
        self.kind = DistanceKind(kind)
        self.n = n
        self.n_pad = n_pad
        self._valid_host = valid
        self._rows = _Rows(*shard_rows(mesh, pad, valid))

    def _set_valid(self, valid: np.ndarray) -> None:
        """Base liveness of the padded rows."""
        self._valid_host = np.asarray(valid, dtype=bool)
        self._rows.valid = self._rows.pad_valid(shard_rows(self.mesh, self._valid_host))

    def _valid_for(self, allowed: np.ndarray | None):
        """Per-call validity: base liveness AND an optional host keep-mask
        over the original n rows (the hybrid path's metadata candidates)."""
        if allowed is None:
            return None
        mask = self._valid_host.copy()
        mask[: self.n] &= np.asarray(allowed[: self.n], dtype=bool)
        return self._rows.pad_valid(shard_rows(self.mesh, mask))

    def search(self, queries: np.ndarray, k: int, allowed: np.ndarray | None = None):
        queries = preprocess(np.atleast_2d(np.asarray(queries, dtype=np.float32)), self.kind)
        s, i = _scan(self.mesh, self._rows, _on_gather(self.mesh, queries), k, self.kind,
                     INF, self._valid_for(allowed))
        return s.cpu().numpy(), i.cpu().numpy()


class _ShardedIVFBase:
    """Rows with their cluster ids sharded, centroids on the gather device:
    the state of the IVF and IVFPQ searchers."""

    def _shard(self, mesh, rows: np.ndarray, assign: np.ndarray, valid: np.ndarray,
               centroids: np.ndarray) -> None:
        n = len(assign)
        shard = max(-(-n // mesh.size), 1)
        n_pad = shard * mesh.size
        pad = np.zeros((n_pad, rows.shape[1]), dtype=np.float32)
        pad[:n] = rows
        assign_pad = np.full(n_pad, -1, dtype=np.int32)
        assign_pad[:n] = assign
        valid_pad = np.zeros(n_pad, dtype=bool)
        valid_pad[:n] = valid
        pad[~valid_pad] = 0.0
        self.mesh = mesh
        self.n = n
        self.n_pad = n_pad
        self.centroids = torch.tensor(np.asarray(centroids, dtype=np.float32),
                                      device=mesh.gather_device)
        self._valid_host = valid_pad
        corpus, valid_s, assign_s = shard_rows(mesh, pad, valid_pad, assign_pad)
        self._rows = _Rows(corpus, valid_s, assign=assign_s)

    def _valid_for(self, allowed: np.ndarray | None):
        if allowed is None:
            return None
        mask = self._valid_host.copy()
        mask[: self.n] &= np.asarray(allowed[: self.n], dtype=bool)
        return self._rows.pad_valid(shard_rows(self.mesh, mask))

    def search(self, queries: np.ndarray, k: int, nprobe: int | None = None,
               allowed: np.ndarray | None = None):
        queries = preprocess(np.atleast_2d(np.asarray(queries, dtype=np.float32)),
                             self._query_kind)
        nprobe = _default_nprobe(nprobe, self.centroids.shape[0])
        s, i = _ivf_scan(self.mesh, self._rows, _on_gather(self.mesh, queries),
                         self.centroids, k, self.kind, self._coarse_kind, nprobe, INF,
                         self._valid_for(allowed))
        return s.cpu().numpy(), i.cpu().numpy()


class ShardedIVFSearcher(_ShardedIVFBase):
    """IVF serving with the inverted lists sharded by corpus row, built
    from a trained single-device `IVFIndex` (its centroids and per-row
    cluster ids, so results are those of the source index's dense scan)."""

    def __init__(self, mesh: Mesh, ivf_index, tile: int = 1 << 14):
        if not (isinstance(ivf_index, IVFIndex) and ivf_index.trained()):
            raise InvalidConfigError("ShardedIVFSearcher needs a trained IVFIndex")
        store = ivf_index._store
        n = store.n
        self.kind = self._coarse_kind = self._query_kind = ivf_index.distance_kind()
        self.row_ids = store.ids[:n].copy()
        self._shard(mesh, store.vectors[:n], ivf_index._assign[:n], store.valid[:n],
                    ivf_index._centroids)


def _decoded(index, n: int) -> np.ndarray:
    """The PQ reconstructions of an index's first n slots, on the host."""
    return pq_decode(torch.from_numpy(np.ascontiguousarray(index._codes[:n])),
                     torch.from_numpy(np.ascontiguousarray(index._codebooks))).numpy()


class ShardedPQSearcher:
    """PQ serving over the decoded reconstructions, sharded: ADC is L2 to
    the reconstruction, so this is a sharded flat L2 scan of the decoded
    corpus (OPQ rotated back to user coordinates on the host), with the
    queries preprocessed for the source index's metric."""

    def __init__(self, mesh: Mesh, pq_index, tile: int = 1 << 14):
        if not (isinstance(pq_index, PQIndex) and pq_index.trained()):
            raise InvalidConfigError("ShardedPQSearcher needs a trained PQIndex")
        store = pq_index._store
        n = store.n
        rec = _decoded(pq_index, n)
        if pq_index._rot is not None:
            rec = rec @ pq_index._rot.T  # OPQ: back to user coordinates
        rec[~store.valid[:n]] = 0.0
        self._flat = ShardedFlatSearcher(mesh, rec, DistanceKind.L2, tile)
        valid = self._flat._valid_host.copy()
        valid[:n] = store.valid[:n]
        self._flat._set_valid(valid)
        self._query_kind = pq_index.distance_kind()
        self.n = n
        self.row_ids = store.ids[:n].copy()

    def search(self, queries: np.ndarray, k: int, allowed: np.ndarray | None = None):
        queries = preprocess(np.atleast_2d(np.asarray(queries, dtype=np.float32)),
                             self._query_kind)
        return self._flat.search(queries, k, allowed=allowed)


class ShardedIVFPQSearcher(_ShardedIVFBase):
    """IVFPQ serving: the reconstructions (decoded codes plus their
    centroid) and the cluster ids sharded, the centroids replicated. The
    coarse stage ranks centroids by the index's metric, the fine scan is L2
    over the reconstructions; OPQ rotates both back to user coordinates."""

    def __init__(self, mesh: Mesh, ivfpq_index, tile: int = 1 << 14):
        if not (isinstance(ivfpq_index, IVFPQIndex) and ivfpq_index.trained()):
            raise InvalidConfigError("ShardedIVFPQSearcher needs a trained IVFPQIndex")
        store = ivfpq_index._store
        n = store.n
        assign = ivfpq_index._assign[:n].astype(np.int32)
        rec = _decoded(ivfpq_index, n) + ivfpq_index._centroids[np.maximum(assign, 0)]
        centroids = ivfpq_index._centroids
        if ivfpq_index._rot is not None:
            rec = rec @ ivfpq_index._rot.T
            centroids = centroids @ ivfpq_index._rot.T
        self.kind = DistanceKind.L2          # fine scan over reconstructions
        self._coarse_kind = self._query_kind = ivfpq_index.distance_kind()
        self.row_ids = store.ids[:n].copy()
        self._shard(mesh, rec, assign, store.valid[:n], centroids)


class ShardedHybridSearcher:
    """Hybrid serving: metadata prefilter -> sharded vector scan -> text
    scoring -> fusion, with `HybridSearchIndex.search_batch`'s result
    semantics (the shared `fuse_batch_rows`). The vector modality is any
    sharded searcher over rows whose doc ids are `row_ids`; the metadata
    candidates become a keep-mask over those rows."""

    def __init__(self, vector_searcher, row_ids: np.ndarray, text_index=None,
                 metadata_index=None):
        self._vector = vector_searcher
        self._row_ids = np.asarray(row_ids, dtype=np.uint32)
        if len(self._row_ids) != vector_searcher.n:
            raise InvalidConfigError(
                f"{len(self._row_ids)} row ids for {vector_searcher.n} rows")
        self._text = text_index
        self._metadata = metadata_index

    def search_batch(
        self,
        vectors: np.ndarray | None = None,
        texts: "list[str] | None" = None,
        k: int = 10,
        *,
        metadata_filters=None,
        metadata_groups=None,
        fusion=None,
        fusion_kind=None,
        nprobes: int | None = None,
        cutoff: int = -1,
    ):
        if vectors is not None:
            vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
        nq = (len(vectors) if vectors is not None
              else len(texts) if texts is not None else 0)
        if nq == 0:
            return []
        fus = fusion or (new_fusion(fusion_kind) if fusion_kind is not None
                         else default_fusion())

        candidates = None
        if metadata_filters or metadata_groups:
            if self._metadata is None:
                raise ValueError("metadata filters but no metadata index")
            candidates = self._metadata.filter_bitset(metadata_filters or [],
                                                      metadata_groups or [])
            if candidates.is_empty():
                return [[] for _ in range(nq)]

        v_ids = v_sc = None
        if vectors is not None:
            allowed = (DocumentFilter(candidates).slot_mask(self._row_ids)
                       if candidates is not None else None)
            kw = ({"nprobe": nprobes}
                  if nprobes and isinstance(self._vector, _ShardedIVFBase) else {})
            v_sc, v_slots = self._vector.search(vectors, k, allowed=allowed, **kw)
            hit = v_slots != IDX_SENTINEL
            v_ids = np.where(hit, self._row_ids[np.where(hit, v_slots, 0)],
                             INVALID_ID).astype(np.uint32)
            if cutoff != -1:
                v_ids, v_sc = postprocess_batch_rows(
                    v_ids[:, :k], np.asarray(v_sc)[:, :k], k, cutoff=cutoff, ascending=True)

        t_ids = t_sc = None
        if texts is not None:
            if self._text is None:
                raise ValueError("text queries but no text index")
            t_ids, t_sc = self._text.search_batch(texts, k=k, document_ids=candidates,
                                                  cutoff=cutoff)

        return fuse_batch_rows(v_ids, v_sc, t_ids, t_sc, candidates, fus, nq, k)


def _graph_state(mesh: Mesh, index: HNSWIndex):
    """The index's layer-0 adjacency, vectors and squared norms on every
    device of the mesh (no copy onto the index's own device)."""
    index._sync_device()
    vecs, sqnorms, _ = index._store.device_state()
    return tuple(_replicate(mesh, t) for t in (index._dev_adj, vecs, sqnorms))


def _query_batch(index: HNSWIndex, queries: np.ndarray, n_dev: int):
    """Preprocessed queries padded as the single-device search pads them
    (`pad_queries`), then to a multiple of the mesh size. Returns (padded
    [Q_pad, d], Q)."""
    qprep = preprocess(np.atleast_2d(np.asarray(queries, dtype=np.float32)),
                       index._distance_kind)
    q_real = len(qprep)
    qpad, _ = pad_queries(qprep)
    if len(qpad) % n_dev:
        grown = np.zeros((-(-len(qpad) // n_dev) * n_dev, qpad.shape[1]), np.float32)
        grown[: len(qpad)] = qpad
        qpad = grown
    return qpad, q_real


def _search_params(index: HNSWIndex, k: int, ef_search):
    """(k_eff, k_pad, ef_pad) of the single-device search."""
    k_eff = sanitize_k(k, index._store.n)
    ef = max(index._effective_ef(ef_search), k_eff)
    return k_eff, min(next_pow2(k_eff), index._store.capacity), next_pow2(ef, 16)


def _admission(mesh: Mesh, index: HNSWIndex, allowed):
    amask = index._store.valid
    if allowed is not None:
        amask = amask & np.asarray(allowed, dtype=bool)
    return _replicate(mesh, torch.from_numpy(np.ascontiguousarray(amask)))


def make_sharded_seeded_hnsw_search(
    mesh: Mesh, ef: int, k: int, kind: DistanceKind, max_iters: int,
    expand: int, fused: bool, stop: int,
):
    """Build the query-sharded seeded beam step (stage 2 of
    `ShardedSeededHNSWSearcher`): the graph is replicated, the queries and
    their seed rows are split over the mesh, and each shard runs the graph
    beam from its queries' seeds with the k-window stop bound.

    fn(queries, seeds_d, seeds_s, entries, adj, vectors, sqnorms, allowed
    (the last four tuples of replicas), threshold) -> (scores [Q, k],
    slots [Q, k]) on the gather device."""
    kind = DistanceKind(kind)

    def fn(queries, seeds_d, seeds_s, entries, adj, vectors, sqnorms, allowed, threshold):
        return _beam_shards(mesh, queries, entries, adj, vectors, sqnorms, allowed,
                            threshold, ef, k, kind, max_iters, expand, fused,
                            seeds=(seeds_d, seeds_s), stop=stop)

    return fn


def _beam_shards(mesh, queries, entries, adj, vectors, sqnorms, allowed, threshold, ef, k,
                 kind, max_iters, expand, fused, seeds=None, stop=None):
    """The graph beam of each shard's block of queries (the rows of
    `queries`, `entries` and the seeds split evenly over the mesh), the
    results concatenated on the gather device in shard order."""
    queries = torch.as_tensor(queries, dtype=torch.float32)
    entries = torch.as_tensor(entries, dtype=torch.int32)
    per = queries.shape[0] // mesh.size
    g = mesh.gather_device
    out_d, out_s = [], []
    for i, dev in enumerate(mesh.devices):
        rows = slice(i * per, (i + 1) * per)
        sd = ss = None
        if seeds is not None:
            sd, ss = seeds[0][rows].to(dev), seeds[1][rows].to(dev)
        d, s = beam_search_layer0(
            queries[rows].to(dev), entries[rows].to(dev), adj[i], vectors[i], sqnorms[i],
            allowed[i], float(threshold), ef, k, kind, max_iters, expand, fused,
            seed_d=sd, seed_s=ss, stop=stop)
        out_d.append(d.to(g))
        out_s.append(s.to(g))
    return torch.cat(out_d), torch.cat(out_s)


class ShardedSeededHNSWSearcher:
    """Seeded HNSW serving in two stages. Stage 1 shards the corpus: it is
    the sharded IVF search (`make_sharded_ivf_search`) over the corpus rows
    and their k-means cells, with k = stop, giving each query [Q, stop]
    seeds in the metric's space. Stage 2 shards the queries: the graph
    beam over the replicated graph starts from each query's seeds (from
    the entry slot where a row has none) and stops on the k-window bound.

    The seed centroids are the caller's, else the index's own
    (`_seed_centroids`, of a seeded single-device search), else k-means
    (10 iterations, L2 squared) of a 2^17-row sample drawn with `seed`."""

    def __init__(self, mesh: Mesh, hnsw_index, nlist: int | None = None,
                 nprobe: int = 0, tile: int = 1 << 13, seed: int = 0,
                 centroids: np.ndarray | None = None):
        self._mesh = mesh
        self._idx = hnsw_index
        self._expand = GRAPH_EXPAND
        store = hnsw_index._store
        n = store.n
        g = mesh.gather_device
        self._adj, self._vectors, self._sqnorms = _graph_state(mesh, hnsw_index)

        if centroids is not None:
            cents = np.asarray(centroids, dtype=np.float32)
        elif hnsw_index._seed_centroids is not None and (
                nlist is None or len(hnsw_index._seed_centroids) == nlist):
            cents = np.asarray(hnsw_index._seed_centroids)
        else:
            nl = nlist or max(64, min(4096, next_pow2(max(int(n ** 0.5), 1))))
            nl = min(nl, max(n, 1))
            sample = store.vectors[:n]
            if n > (1 << 17):
                sel = np.random.default_rng(seed).choice(n, 1 << 17, replace=False)
                sample = sample[np.sort(sel)]
            cents = kmeans(torch.from_numpy(np.ascontiguousarray(sample)).to(g), nl,
                           DistanceKind.L2_SQUARED, 10)[0].cpu().numpy()
        self._nlist = len(cents)
        self._nprobe_default = int(nprobe) or max(2, self._nlist // 64)

        # per-row cells for the stage-1 probe scan
        assign = np.full(n, -1, np.int32)
        live = np.flatnonzero(store.valid[:n])
        cents_g = torch.from_numpy(cents).to(g)
        ch = 1 << 18
        for i0 in range(0, len(live), ch):
            sl = live[i0:i0 + ch]
            x = torch.from_numpy(store.vectors[sl]).to(g)
            assign[sl] = find_nearest_centroid(x, cents_g).cpu().numpy()

        self.n = n
        shard = max(-(-n // mesh.size), 1)
        self._centroids = cents_g
        n_pad = shard * mesh.size
        pad = np.zeros((n_pad, store.vectors.shape[1]), np.float32)
        pad[:n] = store.vectors[:n]
        assign_pad = np.full(n_pad, -1, np.int32)
        assign_pad[:n] = assign
        valid = np.zeros(n_pad, bool)
        valid[:n] = store.valid[:n]
        corpus, valid_s, assign_s = shard_rows(mesh, pad, valid, assign_pad)
        self._scan_rows = _Rows(corpus, valid_s, assign=assign_s)

    def search(self, queries: np.ndarray, k: int, ef_search: int | None = None,
               allowed: np.ndarray | None = None, threshold: float = 0.0,
               nprobe: int | None = None, seed_stop: int = 0):
        """Returns (scores [Q, k], slots [Q, k]); empty = (inf, SENTINEL)."""
        idx = self._idx
        mesh = self._mesh
        k_eff, k_pad, ef_pad = _search_params(idx, k, ef_search)
        stop = min(seed_stop or max(2 * k_pad, 64), ef_pad)
        nprobe = int(nprobe) if nprobe else self._nprobe_default
        nprobe = min(nprobe, self._nlist)
        qpad, q_real = _query_batch(idx, queries, mesh.size)
        qdev = torch.from_numpy(qpad).to(mesh.gather_device)
        kind = idx._distance_kind

        # stage 1: corpus-sharded probe scan -> [Q, stop] seed candidates
        seed_d, seed_s = _ivf_scan(mesh, self._scan_rows, qdev, self._centroids, stop,
                                   kind, kind, nprobe, INF)

        # stage 2: query-sharded seeded beam over the replicated graph
        fused = allowed is not None or threshold > 0 or idx._store.deleted > 0
        entries = np.full(len(qpad), max(idx._entry_slot, 0), np.int32)
        step = make_sharded_seeded_hnsw_search(
            mesh, ef_pad, k_pad, kind, (2 * stop) // self._expand + 16, self._expand, fused,
            stop)
        s, i = step(qdev, seed_d, seed_s, torch.from_numpy(entries), self._adj, self._vectors,
                    self._sqnorms, _admission(mesh, idx, allowed), threshold_scalar(threshold))
        return s.cpu().numpy()[:q_real, :k_eff], i.cpu().numpy()[:q_real, :k_eff]


def make_sharded_hnsw_search(
    mesh: Mesh, ef: int, k: int, kind: DistanceKind, max_iters: int,
    expand: int, fused: bool,
):
    """Build the query-sharded HNSW beam step: the graph is replicated, the
    query batch is split over the mesh, and each shard runs the graph beam
    on its block. No collective: the results are concatenated in query
    order.

    fn(queries, entries, adj, vectors, sqnorms, allowed (the last four
    tuples of replicas), threshold) -> (scores [Q, k], slots [Q, k]) on
    the gather device."""
    kind = DistanceKind(kind)

    def fn(queries, entries, adj, vectors, sqnorms, allowed, threshold):
        return _beam_shards(mesh, queries, entries, adj, vectors, sqnorms, allowed,
                            threshold, ef, k, kind, max_iters, expand, fused)

    return fn


class ShardedHNSWSearcher:
    """HNSW serving with the graph replicated and the queries sharded: the
    single-device graph beam's parameters (ef and k padding, iteration
    budget, the host descent's entries), so results equal the index's
    graph-beam search."""

    def __init__(self, mesh: Mesh, hnsw_index):
        self._mesh = mesh
        self._idx = hnsw_index
        self._expand = GRAPH_EXPAND
        self._adj, self._vectors, self._sqnorms = _graph_state(mesh, hnsw_index)

    def search(self, queries: np.ndarray, k: int, ef_search: int | None = None,
               allowed: np.ndarray | None = None, threshold: float = 0.0):
        """Returns (scores [Q, k], slots [Q, k]); empty = (inf, SENTINEL)."""
        idx = self._idx
        k_eff, k_pad, ef_pad = _search_params(idx, k, ef_search)
        qpad, q_real = _query_batch(idx, queries, self._mesh.size)
        entries = idx._descend(qpad)
        fused = allowed is not None or threshold > 0 or idx._store.deleted > 0
        step = make_sharded_hnsw_search(
            self._mesh, ef_pad, k_pad, idx._distance_kind,
            (4 * ef_pad + 32) // self._expand + 16, self._expand, fused)
        s, i = step(torch.from_numpy(qpad), torch.from_numpy(entries), self._adj,
                    self._vectors, self._sqnorms, _admission(self._mesh, idx, allowed),
                    threshold_scalar(threshold))
        return s.cpu().numpy()[:q_real, :k_eff], i.cpu().numpy()[:q_real, :k_eff]
