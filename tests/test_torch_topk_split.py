"""K1's split route (csrc/topk.cu, `split_*_kernel`): a numpy model of its
algorithm held bit-equal to the plain version, and the plain version held
to the reference's Pallas `topk_cl` (interpret mode) on a wide row.

No CPU run reaches the CUDA kernel, so the model below follows it step by
step: per-tile histograms of an 11-bit digit summed into the row's, the
digit choice, the keys below the chosen bucket written as soon as they
are known, the bucket kept in a candidate buffer once it holds at most
`cap` keys, a bucket of one value settling the row at once, and the ties
at the boundary: without indices the first `need` in column order from
the tile counts, from a candidate buffer by the final sort, with indices
by the index digits and copies of the last key. The card tests
(tests/test_torch_cuda.py, `check_k1_split`) hold the kernel to the plain
version on the same cases; this file holds the model to it on the CPU,
at the kernel's tiling and at a small tile and buffer that reach every
branch. Bar: values and indices array-equal.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comet_tpu.ops import sortnet as ref
from comet_tpu_torch.ops import edge_cases, sortnet

U64 = np.uint64
PAD_KEY = U64(0xFF800000FFFFFFFF)
SHIFTS = (53, 42, 32, 21, 10, 0)
BITS = (11, 11, 10, 11, 11, 10)
CAP = 2048     # csrc/topk.cu SPLIT_CAP
SMS = 132      # an H100's SMs, for the kernel's tiling


def pack_keys(v: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """csrc/topk.cu `pack_key`: (value, index) -> uint64 in (value, index) order."""
    u = v.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0                      # -0.0 -> +0.0
    u = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    i = idx.astype(np.int32).view(np.uint32) ^ np.uint32(0x80000000)
    return (u.astype(U64) << U64(32)) | i.astype(U64)


def unpack_keys(keys: np.ndarray):
    u = (keys >> U64(32)).astype(np.uint32)
    u = np.where(u & np.uint32(0x80000000), u & np.uint32(0x7FFFFFFF), ~u)
    i = (keys.astype(np.uint32) ^ np.uint32(0x80000000)).view(np.int32)
    return u.view(np.float32), i


def split_select_model(keys: np.ndarray, has_idx: bool, kp: int, tile: int, cap: int,
                       seen: set):
    """The split route on one row of packed keys (column c holds position
    c): the kp smallest keys in order. `seen` collects the branches taken."""
    width = keys.shape[0]
    tiles = -(-width // tile)
    tile_of = np.arange(width) // tile
    n_passes = 6 if has_idx else 3
    track = U64(0xFFFFFFFFFFFFFFFF) if has_idx else U64(0xFFFFFFFF00000000)
    prefix = hi = pprefix = phi = U64(0)
    need, count, n_dig = kp, width, 0
    whole = single = resolved = tiles_known = False
    in_cand, cand = set(), [None, None]
    sel = []
    tile_cnt = np.zeros(tiles, np.int64)
    bkey = U64(0)
    for p in range(n_passes):
        if resolved:
            break
        from_cand = p > 0 and (p - 1) in in_cand
        store = p > 0 and count <= cap
        src = cand[(p - 1) & 1] if from_cand else keys
        in_prev = (src & phi) == pprefix
        top = src & hi
        sel.append(src[in_prev & (top < prefix)])          # level p - 1's keys
        in_set = in_prev & (top == prefix)                 # B_p
        nb = 1 << BITS[p]
        hist = np.bincount(((src[in_set] >> U64(SHIFTS[p])) & U64(nb - 1)).astype(np.int64),
                           minlength=nb)
        if store:
            cand[p & 1] = src[in_set]
            seen.add("candidate buffer")
        if not from_cand:
            tile_cnt = np.bincount(tile_of[in_set], minlength=tiles)
        tr = src[in_set] & track
        one_value = tr.max() == tr.min()
        cum = np.cumsum(hist)
        d = int(np.searchsorted(cum, need))                # first bin with cum >= need
        left = need - int(cum[d] - hist[d])
        cnt = int(hist[d])
        if store:
            in_cand.add(p)
        if cnt == left:
            whole = resolved = True
        elif one_value:
            single = resolved = True
            tiles_known = not from_cand
            seen.add("one value")
        elif p + 1 == n_passes:
            resolved = True
        pprefix, phi = prefix, hi
        prefix = prefix | (U64(d) << U64(SHIFTS[p]))
        hi = hi | (U64(nb - 1) << U64(SHIFTS[p]))
        n_dig, need, count, bkey = p + 1, left, cnt, tr.min()
    from_cand = (n_dig - 1) in in_cand
    if not has_idx and not whole and not tiles_known and not from_cand:
        tile_cnt = np.bincount(tile_of[(keys & hi) == prefix], minlength=tiles)   # count launch
        seen.add("count launch")
    src = cand[(n_dig - 1) & 1] if from_cand else keys
    in_prev = (src & phi) == pprefix
    top = src & hi
    below, tie = in_prev & (top < prefix), in_prev & (top == prefix)
    sel.append(src[below])
    ties = np.zeros(0, U64)
    if whole:
        sel.append(src[tie])
        seen.add("whole bucket")
    elif from_cand:
        ties = src[tie]
        seen.add("ties kept")
    elif not has_idx:
        before = np.concatenate([[0], np.cumsum(tile_cnt)[:-1]])
        take = np.clip(need - before, 0, tile_cnt)
        tie_pos = np.flatnonzero(tie)                      # column order
        rank = np.arange(tie_pos.shape[0]) - before[tile_of[tie_pos]]
        sel.append(src[tie_pos[rank < take[tile_of[tie_pos]]]])
        seen.add("ties by tile counts")
        if ((take > 0) & (take < tile_cnt)).any():
            seen.add("a tile takes part of its ties")
    else:
        sel.append(np.full(need, bkey if single else prefix, U64))
        seen.add("copies")
    out = np.concatenate(sel)
    assert out.shape[0] <= kp, "more keys below the boundary than kp"
    assert not from_cand or ties.shape[0] <= cap
    out = np.sort(np.concatenate([out, ties]))
    assert out.shape[0] >= kp
    return out[:kp]


def model_rows(v: np.ndarray, idx, k: int, tile: int, cap: int, seen: set):
    kp = sortnet.k_pow2(k)
    rows, width = v.shape
    pos = np.broadcast_to(np.arange(width, dtype=np.int32), (rows, width))
    keys = pack_keys(v, pos if idx is None else idx)
    out = np.stack([split_select_model(keys[r], idx is not None, kp, tile, cap, seen)
                    for r in range(rows)])
    return unpack_keys(out)


# (rows, width, k, kind): every kind of edge_cases.K1_SPLIT_CASES at a width
# the CPU takes quickly, and the store's two segment widths at one row
MODEL_CASES = tuple((3, 5000, k, kind) for kind in edge_cases.K1_SPLIT_KINDS
                    for k in (10, 100)) + (
    (2, 40_000, 1000, "ties"), (1, 45_428, 10, "zeros"), (1, 286_372, 10, "zeros"),
    (1, 286_372, 100, "random"), (2, 20_000, 8192, "random"), (1, 20_000, 8192, "pairs"),
)


def _case(rows, width, k, kind):
    return edge_cases.k1_split_rows(np.random.default_rng((rows, width, k)), kind, rows, width, k)


@pytest.mark.parametrize("tiling", ["kernel", "small"])
@pytest.mark.parametrize("has_idx", [False, True])
@pytest.mark.parametrize("rows,width,k,kind", MODEL_CASES)
def test_split_model_equals_plain_rows(rows, width, k, kind, has_idx, tiling):
    """The model of the split route selects exactly what the plain version
    selects, at the kernel's tiling (ops/sortnet.split_tile on 132 SMs,
    SPLIT_CAP) and at tiles of 64 columns with 32-key buffers."""
    v, ix = _case(rows, width, k, kind)
    tile, cap = ((sortnet.split_tile(rows, width, SMS), CAP) if tiling == "kernel"
                 else (64, 32))
    idx = ix if has_idx else None
    mv, mi = model_rows(v, idx, k, tile, cap, set())
    pv, pi = sortnet._topk_rows_plain(torch.from_numpy(v),
                                      torch.from_numpy(ix) if has_idx else None, k)
    np.testing.assert_array_equal(mi, pi.numpy())
    np.testing.assert_array_equal(mv, pv.numpy())


def test_split_model_reaches_every_branch():
    """Across the small-tiling cases the model takes every branch of the
    kernel: buffers, one-value buckets, whole buckets, the count launch,
    tile-count ties (one tile taking part of its own), kept ties and
    copies."""
    seen = set()
    for rows, width, k, kind in MODEL_CASES[:2 * len(edge_cases.K1_SPLIT_KINDS)]:
        v, ix = _case(rows, width, k, kind)
        for idx in (None, ix):
            model_rows(v, idx, k, 64, 32, seen)
    assert seen == {"candidate buffer", "one value", "whole bucket", "count launch",
                    "ties by tile counts", "a tile takes part of its ties", "ties kept",
                    "copies"}, seen


@pytest.mark.parametrize("rows,width,k,split", [
    (256, 1 << 20, 10, True), (1, 286_372, 10, True), (1, 45_428, 10, True),
    (1, 65_536, 10, True), (256, 16_384, 100, False), (1, 16_384, 10, False),
    (8, 4096, 10, False), (2048, 256, 128, False), (1, 1 << 20, 16_384, False),
])
def test_split_route_takes_the_rows_wider_than_smem_keys(rows, width, k, split):
    """BM25's [256, 2^20] chunk rows and the store's one-query rows take
    the split route, in 5 launches (7 with indices); the flat path's
    [256, 16384] candidates, narrower single rows and the HNSW finalize
    keep one block a row, and k_pow2 past KP_MAX the sort in device
    memory; the workspace is a fraction of the rows' own bytes (40 KiB of
    it in fixed buffers)."""
    kp = sortnet.k_pow2(k)
    assert sortnet.split_route(rows, width, kp) == split
    if kp <= sortnet.KP_MAX:
        assert sortnet.select_launches(rows, width, k, False) == (5 if split else 1)
        assert sortnet.select_launches(rows, width, k, True) == (7 if split else 1)
    if split:
        tile = sortnet.split_tile(rows, width, SMS)
        assert sortnet.SPLIT_TILE_MIN <= tile <= sortnet.SPLIT_TILE_MAX
        per_row = 128 + 2048 * 4 + kp * 8 + 2 * CAP * 8 + 4 * -(-width // tile)
        assert per_row < width * 4 / 4


# A wide row with ties at the boundary, for the reference: BM25's zeros
# (+0.0 and -0.0, fewer than k smaller values) in two columns, values 0..3
# with permuted indices in two more
REF_C, REF_K = 17_000, 10


def _ref_inputs():
    rng = np.random.default_rng(4242)
    z, zi = edge_cases.k1_split_rows(rng, "zeros", 2, REF_C, REF_K)
    t, ti = edge_cases.k1_split_rows(rng, "ties", 2, REF_C, REF_K)
    return np.concatenate([z, t]).T.copy(), np.concatenate([zi, ti]).T.copy()


@lru_cache(maxsize=None)
def _ref_result():
    v, idx = _ref_inputs()
    rv, ri = ref.topk_cl(jnp.asarray(v), jnp.asarray(idx), REF_K, interpret=True)
    return np.asarray(rv), np.asarray(ri)


@pytest.mark.parametrize("layout", ["cl", "rows", "model"])
def test_plain_and_model_match_reference_on_a_wide_row(layout):
    """At a width past SMEM_KEYS, whose boundary falls inside a run of
    equal keys, the plain versions (which the card holds the split route
    to) and the model select what the reference selects. -0.0 comes back
    as +0.0 in the port; the reference keeps its sign; they compare equal."""
    v, idx = _ref_inputs()
    rv, ri = _ref_result()
    if layout == "cl":
        pv, pi = sortnet.topk_cl(torch.from_numpy(v), torch.from_numpy(idx), REF_K)
        pv, pi = pv.numpy(), pi.numpy()
    elif layout == "rows":
        pv, pi = sortnet.topk_rows(torch.from_numpy(v.T.copy()), torch.from_numpy(idx.T.copy()),
                                   REF_K)
        pv, pi = pv.numpy().T, pi.numpy().T
    else:
        pv, pi = model_rows(v.T.copy(), idx.T.copy(), REF_K, 1024, CAP, set())
        pv, pi = pv.T, pi.T
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pv, rv)
