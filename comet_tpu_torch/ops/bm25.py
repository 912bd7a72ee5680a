"""BM25 batch scoring: per query, the top-k documents by BM25 score.

The port's counterpart of the reference's XLA scorer, `_bm25_device_kernel`
(comet_tpu/indexes/bm25.py:602-633). The reference scores batches with a
host C loop first and falls back to that scorer; the port scores on the
card. Inputs, all on one device:

- the postings, one run a term (CSR): `post_slot` [P] int32 (a document's
  slot: documents in ascending id order) and `post_tf` [P] float32;
- the queries' terms, query-major, each query's in token order, repeats
  included: `t_start` [M] int64 (a run's first posting), `t_len` [M] int32,
  `t_idf` [M] float32; `q_off` [Q + 1] (host numpy) bounds query q's terms;
- `doc_len` [n_pad] float32, `allowed` [n_pad] bool (not deleted and not
  filtered out), and the float32 `avgdl`.

`bm25_topk` scores the queries in chunks of `chunk_rows(n_pad)`. A chunk's
dense [rows, n_pad] float32 rows hold each allowed document's score
negated (0 for the rest), summed term by term in query order with the
reference's XLA expression; K1 (`ops/sortnet.topk_rows`) then takes the k
smallest of each row, which orders the results by score desc, then slot
asc, as `lax.top_k` does. On a CUDA tensor the rows come from the kernel
of `csrc/bm25_score.cu`, counted in `LAUNCHES`: a block scores a group of
queries over a tile of documents, its shape from `tile_shape`. On a CPU
tensor they come from the plain version, `_bm25_dense_plain`, which sums
in the same order and gives the same bits. `_bm25_score_plain` is the
whole plain scorer, for the card checks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comet_tpu_torch.ops import _build, sortnet
from comet_tpu_torch.ops.sortnet import topk_rows, use_plain
from comet_tpu_torch.utils.profiling import count_h2d

K1 = 1.2  # bm25_index.go:75-80
B = 0.75

# float32 constants of the reference's XLA expression (bm25.py:619-621)
_K1 = float(np.float32(K1))
_K1P1 = float(np.float32(K1 + 1.0))
_B = float(np.float32(B))
_1MB = float(np.float32(1.0 - B))

# One chunk's dense float32 rows, budgeted at 12 bytes a (query, slot):
# 256 queries at 2^20 slots.
SCORE_BYTES_MAX = 3 << 30
# postings gathered at once by the plain version
_PLAIN_GATHER_MAX = 1 << 26

# The kernel's block: GROUP_MAX queries (fewer when a chunk has fewer) over
# a tile of TILE_MAX documents, halved down to TILE_MIN while the grid has
# fewer than BLOCKS_PER_SM blocks for each SM of the card. The fastest pair
# of `scripts/ab_bm25_scorer.py --sweep` on an H100 at 256-query chunks.
GROUP_MAX = 8
TILE_MAX = 1024
TILE_MIN = 128
BLOCKS_PER_SM = 2

# Kernel launches made by `_bm25_dense_cuda`.
LAUNCHES = 0


def chunk_rows(n_pad: int) -> int:
    """Queries a chunk scores at once."""
    return max(1, SCORE_BYTES_MAX // (12 * max(int(n_pad), 1)))


def tile_shape(rows: int, n_pad: int, sms: int) -> tuple[int, int]:
    """The kernel's (documents a tile, queries a block) for `rows` queries
    over `n_pad` documents on a card of `sms` SMs."""
    group = min(GROUP_MAX, max(int(rows), 1))
    groups = -(-max(int(rows), 1) // group)
    tile = TILE_MAX
    while tile > TILE_MIN and groups * -(-int(n_pad) // tile) < BLOCKS_PER_SM * sms:
        tile //= 2
    return tile, group


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def contribution(tf, dl, idf, avgdl):
    """The reference's XLA expression in its order, each step one float32
    operation: idf * (tf * (K1 + 1)) / (tf + K1 * ((1 - B) + B * (dl / avgdl))).
    `avgdl` is a 0-dim tensor on the device (a division by a CPU scalar may
    run as a product with its reciprocal on the card)."""
    norm = _1MB + _B * (dl / avgdl)
    return (idf * (tf * _K1P1)) / (tf + _K1 * norm)


def _check(post_slot, post_tf, t_start, t_len, t_idf, doc_len, allowed):
    dev = doc_len.device
    for name, t, dtype in (
        ("post_slot", post_slot, torch.int32), ("post_tf", post_tf, torch.float32),
        ("t_start", t_start, torch.int64), ("t_len", t_len, torch.int32),
        ("t_idf", t_idf, torch.float32), ("doc_len", doc_len, torch.float32),
        ("allowed", allowed, torch.bool),
    ):
        if t.dtype != dtype or t.ndim != 1 or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dtype} tensor on {dev}")
    if post_slot.shape != post_tf.shape or allowed.shape != doc_len.shape:
        raise ValueError("postings or per-document arrays differ in length")
    if not (t_start.shape == t_len.shape == t_idf.shape):
        raise ValueError("query term arrays differ in length")


def _bm25_dense_plain(post_slot, post_tf, t_start, t_len, t_idf, q_off, doc_len, allowed,
                      avgdl):
    """Plain PyTorch version of the kernel: the dense [rows, n_pad] rows of
    the queries whose terms `q_off` (host, absolute) bounds. Term position
    j of every query is added before position j + 1, one add a (query,
    slot), so each document's sum runs in term order."""
    q_off = np.asarray(q_off, dtype=np.int64)
    rows, n_pad = len(q_off) - 1, doc_len.shape[0]
    dev = doc_len.device
    out = torch.zeros((rows, n_pad), dtype=torch.float32, device=dev)
    counts = np.diff(q_off)
    starts, lens = t_start.cpu().numpy(), t_len.cpu().numpy().astype(np.int64)
    avg = torch.tensor(avgdl, dtype=torch.float32, device=dev)
    for j in range(int(counts.max(initial=0))):
        qs = np.flatnonzero(counts > j)
        t = q_off[qs] + j
        # queries in groups of at most _PLAIN_GATHER_MAX postings
        ends = np.cumsum(lens[t])
        g0 = 0
        while g0 < len(qs):
            base = ends[g0 - 1] if g0 else 0
            g1 = max(g0 + 1, int(np.searchsorted(ends, base + _PLAIN_GATHER_MAX, "right")))
            tg = torch.from_numpy(t[g0:g1]).to(dev)
            n = t_len[tg].long()
            total = int(n.sum())
            if total:
                first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
                pidx = (torch.repeat_interleave(t_start[tg], n)
                        + torch.arange(total, device=dev) - first)
                row = torch.repeat_interleave(torch.from_numpy(qs[g0:g1]).to(dev), n)
                slot = post_slot[pidx].long()
                tf = post_tf[pidx]
                c = contribution(tf, doc_len[slot], torch.repeat_interleave(t_idf[tg], n), avg)
                out.index_put_((row, slot), c, accumulate=True)
            g0 = g1
    return torch.where(allowed[None, :], -out, torch.zeros((), device=dev))


def _bm25_dense_cuda(post_slot, post_tf, t_start, t_len, t_idf, q_off_dev, doc_len, allowed,
                     avgdl):
    """Launch the kernel on the queries whose terms `q_off_dev` (int32 on
    the card, absolute) bounds: their dense rows."""
    global LAUNCHES
    lib = _build.library()
    dev = doc_len.device
    rows, n_pad = q_off_dev.shape[0] - 1, doc_len.shape[0]
    tile, group = tile_shape(rows, n_pad, _sm_count(dev.index))
    out = torch.empty((rows, n_pad), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = lib.comet_bm25_score(
        post_slot.data_ptr(), post_tf.data_ptr(), t_start.data_ptr(), t_len.data_ptr(),
        t_idf.data_ptr(), q_off_dev.data_ptr(), rows, doc_len.data_ptr(),
        allowed.data_ptr(), n_pad, avgdl, tile, group, out.data_ptr(), stream,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    _build.check(code, "bm25_score")
    return out


def _chunks(q_off, n_pad, k, dense, select):
    """Score the queries chunk by chunk: `dense(q0, q1)` gives a chunk's
    rows, `select` takes their k smallest. Returns the negated scores and
    slots, [Q, k] each."""
    q_n = len(q_off) - 1
    step = chunk_rows(n_pad)
    vals, slots = [], []
    for q0 in range(0, q_n, step):
        q1 = min(q_n, q0 + step)
        v, i = select(dense(q0, q1), None, k)
        vals.append(v[:, :k])
        slots.append(i[:, :k])
    if not vals:
        return torch.zeros((0, k)), torch.zeros((0, k), dtype=torch.int32)
    return torch.cat(vals), torch.cat(slots)


def bm25_topk(post_slot, post_tf, t_start, t_len, t_idf, q_off, doc_len, allowed, avgdl, k):
    """Per query, the k best (negated score, slot) pairs, ascending: the
    highest scores first, ties to the lower slot; a document with no score
    or not allowed comes as 0 (after every scored one), past n_pad as
    (+inf, IDX_SENTINEL). Returns ([Q, k] float32, [Q, k] int32)."""
    _check(post_slot, post_tf, t_start, t_len, t_idf, doc_len, allowed)
    q_off = np.asarray(q_off, dtype=np.int64)
    n_pad = doc_len.shape[0]
    avgdl = float(np.float32(avgdl))
    if use_plain(doc_len):
        def dense(q0, q1):
            return _bm25_dense_plain(post_slot, post_tf, t_start, t_len, t_idf, q_off[q0:q1 + 1],
                                     doc_len, allowed, avgdl)
    else:
        q_off32 = q_off.astype(np.int32)
        count_h2d(q_off32.nbytes, doc_len.device)
        q_off_dev = torch.from_numpy(q_off32).to(doc_len.device)

        def dense(q0, q1):
            return _bm25_dense_cuda(post_slot, post_tf, t_start, t_len, t_idf,
                                    q_off_dev[q0:q1 + 1], doc_len, allowed, avgdl)
    return _chunks(q_off, n_pad, k, dense, topk_rows)


def _bm25_score_plain(post_slot, post_tf, t_start, t_len, t_idf, q_off, doc_len, allowed,
                      avgdl, k):
    """Plain PyTorch version of `bm25_topk` on any device: the plain rows
    and K1's plain version."""
    _check(post_slot, post_tf, t_start, t_len, t_idf, doc_len, allowed)
    q_off = np.asarray(q_off, dtype=np.int64)
    avgdl = float(np.float32(avgdl))

    def dense(q0, q1):
        return _bm25_dense_plain(post_slot, post_tf, t_start, t_len, t_idf, q_off[q0:q1 + 1],
                                 doc_len, allowed, avgdl)
    return _chunks(q_off, doc_len.shape[0], k, dense, sortnet._topk_rows_plain)
