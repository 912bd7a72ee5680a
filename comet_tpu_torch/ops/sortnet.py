"""Exact top-k smallest by (value asc, index asc): kernel K1.

`topk_cl` keeps the reference's layout, [C, L] candidates x queries in and
[k_pow2, L] out, with k padded to a power of two of at least 8 and missing
candidates filled with (+inf, IDX_SENTINEL). `topk_rows` is the same
selection with a row per query, [L, C] in and [L, k_pow2] out, which is the
layout the search pipeline produces; its `idx` may be None, meaning the
index of a candidate is its position in the row.

On a CUDA tensor both launch the kernels of `csrc/topk.cu` (see the note
there) and count each launch in `LAUNCHES`: one per pass, or, for k above
CHUNK_MAX / 2, which sorts whole rows in device memory, one to pack the
keys, one per bitonic stage and one to unpack. On a CPU tensor they run the
plain PyTorch versions, `_topk_cl_plain` and `_topk_rows_plain`; the
device alone decides. Any other device raises.

-0.0 is returned as +0.0 by both versions (it compares equal to +0.0 in
the ordering, and no distance on the search path is -0.0).
"""

from __future__ import annotations

import torch

from comet_tpu_torch.ops import _build
from comet_tpu_torch.ops.topk import IDX_SENTINEL, lexsort_topk

CHUNK_MIN = 4096    # keys per block in a multi-pass select
CHUNK_MAX = 16384   # keys per block at most: 128 KiB of shared memory

# Kernel launches made by `_topk_cuda`.
LAUNCHES = 0


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


def _topk_cuda(vals, idx, k, rows, width, in_row, in_col, rows_out):
    """Launch K1: passes over chunks in shared memory until one chunk per
    row remains, or, for k above CHUNK_MAX / 2, one sort of whole rows in
    device memory."""
    global LAUNCHES
    lib = _build.library()
    kp = k_pow2(k)
    dev = vals.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    shape = (rows, kp) if rows_out else (kp, rows)
    out_row, out_col = (kp, 1) if rows_out else (1, rows)
    idx_ptr = idx.data_ptr() if idx is not None else None
    chunk_max = max(CHUNK_MIN, 2 * kp)
    if chunk_max > CHUNK_MAX:
        n_pad = _next_pow2(max(width, kp))
        keys = torch.empty((rows, n_pad), dtype=torch.int64, device=dev)
        vout = torch.empty(shape, dtype=torch.float32, device=dev)
        iout = torch.empty(shape, dtype=torch.int32, device=dev)
        code = lib.comet_topk_rows_global(
            vals.data_ptr(), idx_ptr, in_row, in_col, rows, width, n_pad, kp,
            keys.data_ptr(), vout.data_ptr(), iout.data_ptr(),
            out_row, out_col, stream,
        )
        log_n = n_pad.bit_length() - 1
        LAUNCHES += 2 + log_n * (log_n + 1) // 2   # pack, stages, unpack
        _build.check(code, "topk_rows_global")
        return vout, iout
    keys = None
    while True:
        chunk = min(chunk_max, max(_next_pow2(width), kp))
        n_chunks = -(-width // chunk)
        final = n_chunks == 1
        if final:
            vout = torch.empty(shape, dtype=torch.float32, device=dev)
            iout = torch.empty(shape, dtype=torch.int32, device=dev)
            kout = None
        else:
            kout = torch.empty((rows, n_chunks * kp), dtype=torch.int64, device=dev)
        code = lib.comet_topk_pass(
            vals.data_ptr() if keys is None else None,
            idx_ptr if keys is None else None,
            in_row, in_col,
            keys.data_ptr() if keys is not None else None,
            rows, width, chunk, kp,
            kout.data_ptr() if kout is not None else None,
            vout.data_ptr() if final else None,
            iout.data_ptr() if final else None,
            out_row if final else 0, out_col if final else 0, stream,
        )
        LAUNCHES += 1
        _build.check(code, "topk_pass")
        if final:
            return vout, iout
        keys, width = kout, n_chunks * kp


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
