// The distance tile of K2 (fused_scan.cu): 128 queries x 128 corpus rows a
// block, register-tiled on the CUDA cores with pipelined loads.
//
// What bounds it on an H100: 2 * 128 * 128 * d float32 operations against
// one 64 KiB distance write per tile, so at d = 128 the CUDA-core FMA rate
// (67 TFLOP/s) bounds it. A SIMT tile reaches that rate only when the FMA
// pipes are fed from registers: every shared-memory load, barrier and
// global-load stall comes out of it.
//
// Design:
// - One block of FT_THREADS = 256 threads owns FT_BM = 128 queries x
//   FT_BN = 128 rows, so one block is exactly one selection group and the
//   group minimum stays an in-block reduction. A 256-query chunk reads each
//   corpus tile twice (it was four times with 64-query blocks).
// - Each thread holds an 8 x 8 accumulator tile: queries ty*4..+3 and
//   ty*4+64..+67, rows tx*4..+3 and tx*4+64..+67 (tx, ty in 0..15). Its
//   operands for one depth step are four 16-byte shared-memory loads (two of
//   queries, two of rows) for 64 FMAs. The split 4 + 4 layout makes the 16
//   threads of a query row read 16 consecutive float4 of rows (no bank
//   conflict) and the two query rows of a warp broadcast.
// - Depth slices of FT_BK = 16 are staged k-major in shared memory, double
//   buffered, with one barrier a slice. The next slice's operands are
//   loaded from device memory into registers (16-byte loads through the
//   read-only cache) before this slice's products and stored to the other
//   buffer after them, so the loads overlap the FMAs. Lanes of a warp take
//   32 consecutive rows of one 16-byte column, so the transposing stores
//   into shared memory are conflict-free. Rows that are not 16-byte aligned
//   (d not a multiple of 4 floats or 8 bf16) take scalar loads instead.
// - bf16 and float16 operands (T = bf16_t, half_t; 8 values a 16-byte
//   load) and an int8 corpus (T = i8_t) are widened to float32 as they are
//   staged (`ft_unpack`), exactly, so the product is the same FMA chain
//   whatever the operand. A thread stages 8 values of a slice, so int8
//   rows take 8-byte loads (8 values) in place of 16-byte ones. The query
//   and corpus types may differ (int8 rows meet bf16 queries). K3
//   (ivf_sparse.cu) stages its chunk rows with the same loads.
// - An int8 corpus is abs-max quantised: the wrapper passes its `scale`,
//   and the inner product of the integer rows is multiplied by it before
//   the epilogue, as the reference multiplies its int8 product
//   (comet_tpu/ops/distance.py:84-88); the mask then holds squared norms
//   of the dequantised rows.
//
// Sum order: every inner product starts at 0 and takes the depth in
// ascending order, one `dot_fma` a step (scan_tile.cuh), the order of K3's
// tile and of ops/distance.bf16_dot, so distances are bit-equal to both on
// any data. Zero padding past d adds exact zeros
// to a sum that is never -0.0, which leaves it unchanged. The epilogue is
// scan_tile.cuh's `scan_distance`, then `probe_in`, in its order: L2
// max((qn + mask) - 2 ip, 0), cosine (1 - clip(ip)) + mask, the threshold,
// then the probe bit (SCAN_ROW_BITS).

#pragma once

#include <type_traits>

#include "scan_tile.cuh"

#define FT_BM 128        // queries per tile
#define FT_BN 128        // corpus rows per tile = one selection group
#define FT_BK 16         // depth slice staged in shared memory
#define FT_THREADS 256

// Operands one thread stages per slice: FT_BM x FT_BK / FT_THREADS values.
#define FT_PER_THREAD 8

// Bytes one load of an operand of type T moves: 16, but 8 for int8,
// whose 16 bytes would hold twice the 8 values a thread stages a slice.
template <typename T>
struct ft_width {
    static constexpr int BYTES = sizeof(T) == 1 ? 8 : 16;
    static constexpr int VW = BYTES / (int)sizeof(T);   // values a load
};

// The float32 values of one load: 4 float32, 8 bf16 or 8 float16 from 16
// bytes (w), or 8 int8 from the first 8 bytes (w.x, w.y), at v[0 ..).
template <typename T>
__device__ __forceinline__ void ft_unpack(uint4 w, float* v)
{
    if constexpr (sizeof(T) == 4) {
        v[0] = __uint_as_float(w.x);
        v[1] = __uint_as_float(w.y);
        v[2] = __uint_as_float(w.z);
        v[3] = __uint_as_float(w.w);
    } else if constexpr (sizeof(T) == 1) {
        // little-endian: element i is byte i % 4 of word i / 4
        const unsigned lo = w.x, hi = w.y;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            v[e] = (float)(signed char)(lo >> (8 * e));
            v[4 + e] = (float)(signed char)(hi >> (8 * e));
        }
    } else if constexpr (std::is_same<T, half_t>::value) {
        const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&words[i]));
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    } else {
        // little-endian: element 2i is the low half of word i
        v[0] = __uint_as_float(w.x << 16);
        v[1] = __uint_as_float(w.x & 0xFFFF0000u);
        v[2] = __uint_as_float(w.y << 16);
        v[3] = __uint_as_float(w.y & 0xFFFF0000u);
        v[4] = __uint_as_float(w.z << 16);
        v[5] = __uint_as_float(w.z & 0xFFFF0000u);
        v[6] = __uint_as_float(w.w << 16);
        v[7] = __uint_as_float(w.w & 0xFFFF0000u);
    }
}

// Loads this thread's share of the depth slice [k0, k0 + FT_BK) of `rows`
// rows (row stride d) starting at `base`, widened to float32; rows past
// `valid` and depths past d give 0. VEC: vector loads of
// ft_width<T>::BYTES (base aligned to them and d a multiple of the values
// a load holds).
template <typename T, bool VEC>
__device__ __forceinline__ void ft_load(
    const T* __restrict__ base, int valid, int d, int k0, float (&v)[FT_PER_THREAD])
{
    constexpr int VW = ft_width<T>::VW;
    constexpr int UNITS = FT_PER_THREAD / VW;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
        const int unit = threadIdx.x + u * FT_THREADS;
        const int row = unit % FT_BM;
        const int gk = k0 + (unit / FT_BM) * VW;
        const T* p = base + (long long)row * d + gk;
        if (VEC) {
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (row < valid && gk < d) {
                if constexpr (ft_width<T>::BYTES == 16) {
                    w = __ldg(reinterpret_cast<const uint4*>(p));
                } else {
                    const uint2 h = __ldg(reinterpret_cast<const uint2*>(p));
                    w.x = h.x;
                    w.y = h.y;
                }
            }
            ft_unpack<T>(w, v + u * VW);
        } else {
#pragma unroll
            for (int e = 0; e < VW; ++e)
                v[u * VW + e] = (row < valid && gk + e < d) ? to_f32(p[e]) : 0.0f;
        }
    }
}

// Stores what ft_load loaded into the k-major slice S[FT_BK][FT_BM].
template <typename T>
__device__ __forceinline__ void ft_store(float (*S)[FT_BM], const float (&v)[FT_PER_THREAD]) {
    constexpr int VW = ft_width<T>::VW;
    constexpr int UNITS = FT_PER_THREAD / VW;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
        const int unit = threadIdx.x + u * FT_THREADS;
        const int row = unit % FT_BM;
        const int k = (unit / FT_BM) * VW;
#pragma unroll
        for (int e = 0; e < VW; ++e) S[k + e][row] = v[u * VW + e];
    }
}

// Whether cluster a (-1: none) has its bit set in a query's probe bitmask
// of n_words words.
__device__ __forceinline__ bool probe_in(const unsigned* __restrict__ words, int n_words, int a) {
    return a >= 0 && (a >> 5) < n_words && ((__ldg(words + (a >> 5)) >> (a & 31)) & 1u);
}

// Tile position of a thread's i-th query or row (i in 0..7): t*4 + i for
// the first four, 64 + t*4 + (i - 4) for the others.
__device__ __forceinline__ int ft_pos(int t, int i) { return t * 4 + (i < 4 ? i : 60 + i); }

// q, qn: the tile's first query row (row stride d) and its squared norm;
// q_valid of the FT_BM queries exist. x, mask: the tile's first corpus row
// (row stride d) and its mask; all FT_BN rows exist. dist: entry (query 0,
// row 0) of the tile, row stride dist_stride; gmin: the group minimum of
// query 0, row stride gmin_stride. MODE SCAN_ALL or SCAN_ROW_BITS, with
// assign (the tile's first row's cluster) and words (query 0's probe
// bitmask, n_words words per query; see scan_tile.cuh). TQ and TX are the
// query and corpus operand types; an int8 corpus's inner products are
// multiplied by `scale` before the epilogue.
template <int MODE, typename TQ, typename TX, bool VEC>
__device__ __forceinline__ void fused_tile(
    const TQ* __restrict__ q, const float* __restrict__ qn, int q_valid,
    const TX* __restrict__ x, const float* __restrict__ mask, int d,
    float thr, int cosine, float scale,
    const int* __restrict__ assign, const unsigned* __restrict__ words, int n_words,
    float* __restrict__ dist, long long dist_stride,
    float* __restrict__ gmin, long long gmin_stride)
{
    __shared__ __align__(16) float As[2][FT_BK][FT_BM];
    __shared__ __align__(16) float Bs[2][FT_BK][FT_BN];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float ra[FT_PER_THREAD], rb[FT_PER_THREAD];
    ft_load<TQ, VEC>(q, q_valid, d, 0, ra);
    ft_load<TX, VEC>(x, FT_BN, d, 0, rb);
    ft_store<TQ>(As[0], ra);
    ft_store<TX>(Bs[0], rb);
    __syncthreads();

    const int n_slices = (d + FT_BK - 1) / FT_BK;
    for (int s = 0; s < n_slices; ++s) {
        const int cur = s & 1;
        const bool more = s + 1 < n_slices;
        if (more) {
            ft_load<TQ, VEC>(q, q_valid, d, (s + 1) * FT_BK, ra);
            ft_load<TX, VEC>(x, FT_BN, d, (s + 1) * FT_BK, rb);
        }
#pragma unroll
        for (int kk = 0; kk < FT_BK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4]);
            const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 4 + 64]);
            const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
            const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4 + 64]);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = dot_fma(a[i], b[j], acc[i][j]);
        }
        if (more) {
            ft_store<TQ>(As[cur ^ 1], ra);
            ft_store<TX>(Bs[cur ^ 1], rb);
        }
        __syncthreads();
    }

    float m_row[8];
    int a_row[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        m_row[j] = mask[ft_pos(tx, j)];
        a_row[j] = MODE == SCAN_ROW_BITS ? assign[ft_pos(tx, j)] : 0;
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int lq = ft_pos(ty, i);
        const bool qok = lq < q_valid;
        const float qni = qok ? qn[lq] : 0.0f;
        float out[8];
        float m = CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const float ip = sizeof(TX) == 1 ? acc[i][j] * scale : acc[i][j];
            float dd = scan_distance(ip, qni, m_row[j], thr, cosine);
            if (MODE == SCAN_ROW_BITS) {
                const bool in = qok && probe_in(words + (long long)lq * n_words, n_words, a_row[j]);
                dd = in ? dd : CUDART_INF_F;
            }
            out[j] = dd;
            m = fminf(m, dd);
        }
        if (qok) {
            float* row = dist + (long long)lq * dist_stride;
            *reinterpret_cast<float4*>(row + tx * 4) = make_float4(out[0], out[1], out[2], out[3]);
            *reinterpret_cast<float4*>(row + 64 + tx * 4) = make_float4(out[4], out[5], out[6], out[7]);
        }
        // the 16 threads of one query row are lanes 0-15 or 16-31 of a warp
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
        if (tx == 0 && qok) gmin[(long long)lq * gmin_stride] = m;
    }
}
