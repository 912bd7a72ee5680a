// The in-loop distance of one neighbour of an expanded HNSW node, shared by
// the scoring kernel (gather_score.cu) and K5 (fused_expand.cu), so that
// both give bit-equal distances for the same (query, slot).
//
// A node's routing row holds its W neighbour vectors (bf16, d each) and
// its aux row: W bf16 squared norms, then ndig planes of W base-128 digits
// of slot + 1 (0 for an empty adjacency entry). The blocked layout keeps
// the two in separate tables, the packed layout in one row; the callers
// pass the row pointers either way.

#pragma once

#include "scan_tile.cuh"

// Neighbour j's slot from the digit planes of the aux row, -1 when empty.
__device__ __forceinline__ int decode_slot(const bf16_t* __restrict__ arow, int W, int j,
                                           int ndig)
{
    float a1 = to_f32(arow[W + j]);
    float scale = 128.0f;
    for (int i = 1; i < ndig; ++i) {
        a1 = a1 + to_f32(arow[(1 + i) * W + j]) * scale;
        scale *= 128.0f;
    }
    return (int)a1 - 1;
}

// max((qn + nsq) - 2 <qq, x>, 0) for the bf16 query row qq and neighbour
// row x: the `dot_fma` chain from 0, depth ascending. x is read in 16-byte
// loads between a scalar head (up to its first 16-byte boundary) and a
// scalar tail, so any row address and any d work.
__device__ __forceinline__ float neighbour_dist(const bf16_t* __restrict__ qq, float qn,
                                                const bf16_t* __restrict__ x, bf16_t nsq, int d)
{
    float acc = 0.0f;
    int k = 0;
    const int head = min(d, (int)(((16 - ((size_t)x & 15)) & 15) >> 1));
    for (; k < head; ++k) acc = dot_fma(to_f32(qq[k]), to_f32(x[k]), acc);
    for (; k + 8 <= d; k += 8) {
        const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
        const unsigned xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
            acc = dot_fma(to_f32(qq[k + 2 * h]), to_f32((bf16_t)(xs[h] & 0xFFFFu)), acc);
            acc = dot_fma(to_f32(qq[k + 2 * h + 1]), to_f32((bf16_t)(xs[h] >> 16)), acc);
        }
    }
    for (; k < d; ++k) acc = dot_fma(to_f32(qq[k]), to_f32(x[k]), acc);
    return fmaxf((qn + to_f32(nsq)) - 2.0f * acc, 0.0f);
}
