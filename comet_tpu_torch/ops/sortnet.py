"""Exact top-k smallest by (value asc, index asc): kernel K1.

`topk_cl` keeps the reference's layout, [C, L] candidates x queries in and
[k_pow2, L] out, with k padded to a power of two of at least 8 and missing
candidates filled with (+inf, IDX_SENTINEL). `topk_rows` is the same
selection with a row per query, [L, C] in and [L, k_pow2] out, which is the
layout the search pipeline produces; its `idx` may be None, meaning the
index of a candidate is its position in the row.

On a CUDA tensor both launch the kernels of `csrc/topk.cu` (see the note
there) and count each launch in `LAUNCHES`. For k_pow2 <= KP_MAX a select
takes one of two routes, each a fixed launch sequence:
- one block a row: one launch, a radix select per row or, for rows no
  wider than 2 k_pow2, a direct sort;
- split (`split_route`): rows wider than SMEM_KEYS, cut into tiles of
  `split_tile` columns (2,048-65,536) with a block each: 5 launches
  without `idx`, 7 with it (`select_launches`), also counted in
  `SPLIT_LAUNCHES`; its workspace is ~40 KiB a row plus k_pow2 keys,
  never a copy of the row.
A k_pow2 above KP_MAX sorts whole rows in device memory instead: one
launch to pack the keys, one per bitonic stage and one to unpack. On a CPU
tensor they run the plain PyTorch versions, `_topk_cl_plain` and
`_topk_rows_plain`; the device alone decides. Any other device raises.

-0.0 is returned as +0.0 by both versions (it compares equal to +0.0 in
the ordering, and no distance on the search path is -0.0).
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.topk import IDX_SENTINEL, lexsort_topk

KP_MAX = 8192       # largest k_pow2 of the radix selects
SMEM_KEYS = 16384   # a row's keys held in shared memory at most (128 KiB)

# The split route's tiles: a power of two of columns between these, small
# enough that the grid has SPLIT_BLOCKS_PER_SM blocks an SM where the rows
# allow. Tiles of 65,536 ran [256, 2^20] faster than 16,384, and tiles
# below 2,048 ran one row of 286,372 slower (a one-off sweep on an H100;
# PERF.md §6). Rows of at most SMEM_KEYS keep one block a row: it beat the
# split route at 1-16 rows of 4,096-16,384 columns (PERF.md §6).
SPLIT_TILE_MIN = 2048
SPLIT_TILE_MAX = 65536
SPLIT_BLOCKS_PER_SM = 8

# Kernel launches made by `_topk_cuda` (both routes), and those of the
# split route alone.
LAUNCHES = 0
SPLIT_LAUNCHES = 0


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def k_pow2(k: int) -> int:
    """Rows a select of k returns: k padded to a power of two, at least 8."""
    return _next_pow2(max(int(k), 8))


def _check(vals: torch.Tensor, idx: torch.Tensor | None) -> None:
    if vals.ndim != 2 or vals.dtype != torch.float32:
        raise ValueError(f"vals must be a 2-D float32 tensor, got {vals.dtype} {tuple(vals.shape)}")
    if idx is not None:
        if idx.shape != vals.shape or idx.dtype != torch.int32:
            raise ValueError("idx must be an int32 tensor shaped like vals")
        if idx.device != vals.device:
            raise ValueError("vals and idx are on different devices")


def use_plain(t: torch.Tensor) -> bool:
    """True: run the plain version (CPU tensor); False: launch the kernel
    (CUDA tensor). Any other device raises: there is no fallback."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no implementation for device {t.device}")


def _topk_rows_plain(vals: torch.Tensor, idx: torch.Tensor | None, k: int):
    """Plain PyTorch version of K1, a row per query: [L, C] in, [L, k_pow2]
    out; `idx` None means the index is the position in the row."""
    if torch.isnan(vals).any():
        raise ValueError("NaN in top-k input: the search path never makes one")
    l_real, c = vals.shape
    if idx is None:
        idx = torch.arange(c, dtype=torch.int32, device=vals.device).expand(l_real, c)
    kp = k_pow2(k)
    if c < kp:
        vals = torch.cat([vals, vals.new_full((l_real, kp - c), float("inf"))], dim=1)
        idx = torch.cat([idx, idx.new_full((l_real, kp - c), IDX_SENTINEL)], dim=1)
    return lexsort_topk(vals, idx, kp)


def _topk_cl_plain(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Plain PyTorch version of K1 in the reference's layout: [C, L] in,
    [k_pow2, L] out."""
    v, i = _topk_rows_plain(vals.T, idx.T, k)
    return v.T.contiguous(), i.T.contiguous()


def _same_strides(vals, idx):
    """The kernel reads vals and idx at one offset: give them one layout."""
    if idx is not None and idx.stride() != vals.stride():
        return vals.contiguous(), idx.contiguous()
    return vals, idx


def split_route(rows: int, width: int, kp: int) -> bool:
    """Whether a select of k_pow2 `kp` over [rows, width] takes the split
    route: rows wider than one block holds in shared memory."""
    return kp <= KP_MAX and width > max(SMEM_KEYS, 2 * kp)


def split_tile(rows: int, width: int, sms: int) -> int:
    """Columns of a split-route tile: the power of two in [SPLIT_TILE_MIN,
    SPLIT_TILE_MAX] nearest above rows * width / (SPLIT_BLOCKS_PER_SM * sms)."""
    want = -(-rows * width // (SPLIT_BLOCKS_PER_SM * sms))
    return min(max(_next_pow2(want), SPLIT_TILE_MIN), SPLIT_TILE_MAX)


def select_launches(rows: int, width: int, k: int, has_idx: bool) -> int:
    """Kernel launches of one select of k_pow2(k) <= KP_MAX."""
    if not split_route(rows, width, k_pow2(k)):
        return 1
    return 7 if has_idx else 5


def _topk_cuda(vals, idx, k, rows, width, in_row, in_col, rows_out):
    """Launch K1: one select of every row (one block a row, or the split
    route) or, for k_pow2 above KP_MAX, one sort of whole rows in device
    memory."""
    global LAUNCHES, SPLIT_LAUNCHES
    lib = _build.library()
    kp = k_pow2(k)
    dev = vals.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (rows, kp) if rows_out else (kp, rows)
    out_row, out_col = (kp, 1) if rows_out else (1, rows)
    idx_ptr = idx.data_ptr() if idx is not None else None
    vout = torch.empty(shape, dtype=torch.float32, device=dev)
    iout = torch.empty(shape, dtype=torch.int32, device=dev)
    if kp > KP_MAX:
        n_pad = _next_pow2(max(width, kp))
        keys = torch.empty((rows, n_pad), dtype=torch.int64, device=dev)
        code = lib.comet_topk_rows_global(
            vals.data_ptr(), idx_ptr, in_row, in_col, rows, width, n_pad, kp,
            keys.data_ptr(), vout.data_ptr(), iout.data_ptr(),
            out_row, out_col, stream,
        )
        log_n = n_pad.bit_length() - 1
        with _build.COUNT_LOCK:
            LAUNCHES += 2 + log_n * (log_n + 1) // 2   # pack, stages, unpack
        _build.check(code, "topk_rows_global")
        return vout, iout
    if split_route(rows, width, kp):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        tile = split_tile(rows, width, sms)
        n_bytes = lib.comet_topk_split_bytes(rows, width, kp, tile)
        ws = torch.empty((n_bytes + 7) // 8, dtype=torch.int64, device=dev)
        code = lib.comet_topk_split(
            vals.data_ptr(), idx_ptr, in_row, in_col, rows, width, kp, tile,
            ws.data_ptr(), vout.data_ptr(), iout.data_ptr(), out_row, out_col, stream,
        )
        n = select_launches(rows, width, k, idx is not None)
        with _build.COUNT_LOCK:
            LAUNCHES += n
            SPLIT_LAUNCHES += n
        _build.check(code, "topk_split")
        return vout, iout
    code = lib.comet_topk_select(
        vals.data_ptr(), idx_ptr, in_row, in_col, rows, width, kp,
        vout.data_ptr(), iout.data_ptr(), out_row, out_col, stream,
    )
    with _build.COUNT_LOCK:
        LAUNCHES += 1
    _build.check(code, "topk_select")
    return vout, iout


def topk_cl(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Exact top-k smallest per COLUMN of [C, L], ties to the lower index.

    Returns ([k_pow2, L] values ascending, [k_pow2, L] int32 indices)."""
    _check(vals, idx)
    if use_plain(vals):
        return _topk_cl_plain(vals, idx, k)
    vals, idx = _same_strides(vals, idx)
    c, l_real = vals.shape
    return _topk_cuda(
        vals, idx, k, rows=l_real, width=c,
        in_row=vals.stride(1), in_col=vals.stride(0), rows_out=False,
    )


def topk_rows(vals: torch.Tensor, idx: torch.Tensor | None, k: int):
    """Exact top-k smallest per ROW of [L, C], ties to the lower index;
    `idx` None means the index is the position in the row.

    Returns ([L, k_pow2] values ascending, [L, k_pow2] int32 indices)."""
    _check(vals, idx)
    if use_plain(vals):
        return _topk_rows_plain(vals, idx, k)
    vals, idx = _same_strides(vals, idx)
    l_real, c = vals.shape
    return _topk_cuda(
        vals, idx, k, rows=l_real, width=c,
        in_row=vals.stride(0), in_col=vals.stride(1), rows_out=True,
    )
