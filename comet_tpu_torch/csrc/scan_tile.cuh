// The tile product and epilogue of K3 (ivf_sparse.cu). K2 (fused_scan.cu)
// runs its own 128 x 128 tile (fused_tile.cuh) with the same sum order and
// epilogue, built on the definitions here (`dot_fma`, bf16 widening,
// `scan_distance`, the modes), as are the in-loop scoring kernels
// (neighbour_score.cuh).
//
// One block of SCAN_THREADS threads computes a SCAN_BM x SCAN_BN tile of
// distances, SCAN_BM queries against SCAN_BN corpus rows (one 128-row
// selection group). The product is float32 FMA on the CUDA cores, never
// TF32: 32-wide slices of the depth are staged in shared memory and each
// thread accumulates a SCAN_TM x SCAN_TN block in registers. The epilogue
// is the reference's, in its order of operations:
//   L2:     max((qn + mask[n]) - 2 * ip, 0)     mask = squared norm, +inf if invalid
//   cosine: (1 - clip(ip, -1, 1)) + mask[n]     mask = 0, +inf if invalid
// then the threshold (dist > thr -> +inf), then the probe mask of the mode:
//   SCAN_ALL        no probe mask (flat scan);
//   SCAN_ROW_BITS   +inf unless row n's cluster assign[n] has its bit set in
//                   the query's probe bitmask (dense IVF scan; K2's tile only);
//   SCAN_QUERY      +inf for the queries flagged out in member_q, a per-query
//                   flag in shared memory (block-sparse IVF scan, where the
//                   whole tile belongs to one cluster).
// It writes the tile's distances and each query's minimum over the tile
// (the group minimum), finished with warp shuffles.
//
// The operands are float32 (T = float) or bfloat16 (T = bf16_t, K3's bf16
// mode): bf16 values are widened to float32 as they are staged, so the
// product is the same FMA chain either way. `dot_fma` is the one product
// step of every inner product in the package's kernels: an inner product
// starts at 0 and takes the depth in ascending order, one `dot_fma` per
// element. K3's bf16 mode here and the beam's in-loop scoring
// (gather_score.cu) both do so, and a bf16 x bf16 product is exact in
// float32, so the two give bit-equal distances for the same (query, row):
// the beam's duplicate kill (beam_merge.cu) relies on it.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define SCAN_BM 64        // queries per tile
#define SCAN_BN 128       // corpus rows per tile = one selection group
#define SCAN_BK 32        // depth slice staged in shared memory
#define SCAN_TM 4         // queries per thread
#define SCAN_TN 8         // corpus rows per thread
#define SCAN_THREADS 256

enum { SCAN_ALL = 0, SCAN_ROW_BITS = 1, SCAN_QUERY = 2 };

// a bfloat16 value as its raw 16 bits (the top half of a float32)
typedef unsigned short bf16_t;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_t x) { return __uint_as_float((unsigned)x << 16); }

__device__ __forceinline__ float dot_fma(float a, float b, float acc) { return fmaf(a, b, acc); }

// One distance from its inner product ip, in the reference's order of
// operations: the metric (qni the query's squared norm, m the row's mask),
// then the threshold.
__device__ __forceinline__ float scan_distance(float ip, float qni, float m, float thr,
                                               int cosine) {
    float dd;
    if (cosine) {
        const float c = fminf(fmaxf(ip, -1.0f), 1.0f);
        dd = (1.0f - c) + m;
    } else {
        const float s = qni + m;
        dd = fmaxf(s - 2.0f * ip, 0.0f);
    }
    return dd <= thr ? dd : CUDART_INF_F;
}

// q, qn: the tile's first query row (row stride d) and its squared norm;
// q_valid of the SCAN_BM queries exist. x, mask: the tile's first corpus
// row (row stride d) and its mask; all SCAN_BN rows exist. dist: entry
// (query 0, row 0) of the tile, row stride dist_stride; gmin: the group
// minimum of query 0, row stride gmin_stride. MODE SCAN_ALL or SCAN_QUERY.
template <int MODE, typename T = float>
__device__ __forceinline__ void scan_tile(
    const T* __restrict__ q, const float* __restrict__ qn, int q_valid,
    const T* __restrict__ x, const float* __restrict__ mask, int d,
    float thr, int cosine, const bool* member_q,
    float* __restrict__ dist, long long dist_stride,
    float* __restrict__ gmin, long long gmin_stride)
{
    __shared__ __align__(16) float As[SCAN_BK][SCAN_BM];
    __shared__ __align__(16) float Bs[SCAN_BK][SCAN_BN + 4];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[SCAN_TM][SCAN_TN];
#pragma unroll
    for (int i = 0; i < SCAN_TM; ++i)
#pragma unroll
        for (int j = 0; j < SCAN_TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += SCAN_BK) {
        for (int e = tid; e < SCAN_BM * SCAN_BK; e += SCAN_THREADS) {
            const int r = e / SCAN_BK;
            const int c = e % SCAN_BK;
            const int gk = k0 + c;
            As[c][r] = (r < q_valid && gk < d) ? to_f32(q[(long long)r * d + gk]) : 0.0f;
        }
        for (int e = tid; e < SCAN_BN * SCAN_BK; e += SCAN_THREADS) {
            const int r = e / SCAN_BK;
            const int c = e % SCAN_BK;
            const int gk = k0 + c;
            Bs[c][r] = gk < d ? to_f32(x[(long long)r * d + gk]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < SCAN_BK; ++kk) {
            float a[SCAN_TM];
            float b[SCAN_TN];
#pragma unroll
            for (int i = 0; i < SCAN_TM; ++i) a[i] = As[kk][ty * SCAN_TM + i];
#pragma unroll
            for (int j = 0; j < SCAN_TN; ++j) b[j] = Bs[kk][tx * SCAN_TN + j];
#pragma unroll
            for (int i = 0; i < SCAN_TM; ++i)
#pragma unroll
                for (int j = 0; j < SCAN_TN; ++j)
                    acc[i][j] = dot_fma(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float m_row[SCAN_TN];
#pragma unroll
    for (int j = 0; j < SCAN_TN; ++j) m_row[j] = mask[tx * SCAN_TN + j];

#pragma unroll
    for (int i = 0; i < SCAN_TM; ++i) {
        const int lq = ty * SCAN_TM + i;
        const bool qok = lq < q_valid;
        const float qni = qok ? qn[lq] : 0.0f;
        const bool q_in = MODE != SCAN_QUERY || (qok && member_q[lq]);
        float out[SCAN_TN];
        float m = CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < SCAN_TN; ++j) {
            float dd = scan_distance(acc[i][j], qni, m_row[j], thr, cosine);
            if (MODE == SCAN_QUERY) dd = q_in ? dd : CUDART_INF_F;
            out[j] = dd;
            m = fminf(m, dd);
        }
        if (qok) {
            float4* dst = reinterpret_cast<float4*>(
                dist + (long long)lq * dist_stride + tx * SCAN_TN);
            dst[0] = make_float4(out[0], out[1], out[2], out[3]);
            dst[1] = make_float4(out[4], out[5], out[6], out[7]);
        }
        // the 16 threads of one query row are lanes 0-15 or 16-31 of a warp
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
        if (tx == 0 && qok) gmin[(long long)lq * gmin_stride] = m;
    }
}
