// The merge body of the HNSW beam, shared by K4 (beam_merge.cu) and K5
// (fused_expand.cu): both kernels run one block of MERGE_THREADS threads
// per query over 64-bit keys in shared memory.
//
// A beam row is one key, (dist bits << 32) | (slot << 1) | (1 - expanded):
// distances are >= 0 or +inf, so their bits order as their values (-0.0
// taken as +0.0, as K1 does), and SENT = 2^31 - 1 fits in 31 bits. A result
// row is (dist bits << 32) | slot. The order of a key is (dist asc, slot
// asc, expanded desc), total up to rows equal in every field, so any
// correct sort gives the reference's result bit for bit.
//
// `merge_select` is the split step on keys the caller has written: sort,
// kill the adjacent copies of a slot, compact the live rows, keep the first
// ef, select the first `expand` unexpanded rows and the query's active
// flag (module docstring of ops/beam_kernel.py).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#define MERGE_THREADS 256
#define MISC_ROWS 24
#ifndef SENT_SLOT
#define SENT_SLOT 2147483647
#endif

typedef unsigned long long u64;

__device__ __forceinline__ unsigned dist_bits(float d)
{
    return d == 0.0f ? 0u : __float_as_uint(d);    // -0.0 -> +0.0
}

__device__ __forceinline__ u64 beam_key(float d, int s, int e)
{
    return ((u64)dist_bits(d) << 32) | ((u64)(unsigned)s << 1) | (u64)(e ? 0 : 1);
}

__device__ __forceinline__ u64 res_key(float d, int s)
{
    return ((u64)dist_bits(d) << 32) | (u64)(unsigned)s;
}

// Ascending bitonic sort of n keys (n a power of two) in shared memory.
__device__ __forceinline__ void block_sort(u64* keys, int n)
{
    for (int k = 2; k <= n; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const int p = i ^ j;
                if (p > i) {
                    const u64 a = keys[i];
                    const u64 b = keys[p];
                    const bool up = (i & k) == 0;
                    if ((a > b) == up) {
                        keys[i] = b;
                        keys[p] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// Exclusive prefix sum of one int per thread over the block; *total gets
// the sum. warp_sums: 32 ints of shared memory. Ends with a barrier.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sums, int* total)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int n_warps = blockDim.x >> 5;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int w = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xFFFFFFFFu, w, o);
            if (lane >= o) w += y;
        }
        if (lane < n_warps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = warp > 0 ? warp_sums[warp - 1] : 0;
    *total = warp_sums[n_warps - 1];
    __syncthreads();
    return before + x - v;
}

// Kill and compact the n sorted keys: a row is dead when its slot (key >>
// shift, 31 bits) is SENT or equals the previous row's. The first `width`
// live keys go to out[0 .. width) in order, then `pad`. Each thread owns a
// contiguous run of rows, so the compaction keeps the sorted order.
__device__ __forceinline__ void kill_compact(const u64* keys, int n, int shift, u64* out,
                                             int width, u64 pad, int* warp_sums)
{
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int lo = min(n, (int)threadIdx.x * per);
    const int hi = min(n, lo + per);
    int live = 0;
    for (int i = lo; i < hi; ++i) {
        const unsigned s = (unsigned)(keys[i] >> shift) & 0x7FFFFFFFu;
        const bool dead = s == (unsigned)SENT_SLOT ||
            (i > 0 && s == ((unsigned)(keys[i - 1] >> shift) & 0x7FFFFFFFu));
        live += dead ? 0 : 1;
    }
    int total;
    int pos = block_exclusive_scan(live, warp_sums, &total);
    for (int i = lo; i < hi && pos < width; ++i) {
        const unsigned s = (unsigned)(keys[i] >> shift) & 0x7FFFFFFFu;
        const bool dead = s == (unsigned)SENT_SLOT ||
            (i > 0 && s == ((unsigned)(keys[i - 1] >> shift) & 0x7FFFFFFFu));
        if (!dead) out[pos++] = keys[i];
    }
    for (int i = total + (int)threadIdx.x; i < width; i += blockDim.x) out[i] = pad;
    __syncthreads();
}

// Block-shared scratch of `merge_select`.
struct MergeScratch {
    int warp_sums[32];
    int misc[MISC_ROWS];
    float d_first;
};

// The split step of query q over the n_sort keys the caller wrote to
// `keys` (beam rows, candidate rows, padding): sort, kill, compact into
// `win` (ef keys), select. Writes od / os / oe [q, ef] and misc [q,
// MISC_ROWS]: the selected slots (-1 none), the active flag at `expand`,
// the rest -1. Leaves the compacted window in `win`.
__device__ __forceinline__ void merge_select(
    u64* keys, int n_sort, u64* win, int ef, int expand, int stop, long long q,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, MergeScratch* sc)
{
    const int tid = threadIdx.x;
    const u64 pad_beam = beam_key(CUDART_INF_F, SENT_SLOT, 0);
    if (tid < MISC_ROWS) sc->misc[tid] = -1;
    if (tid == 0) sc->d_first = CUDART_INF_F;
    __syncthreads();
    block_sort(keys, n_sort);

    // kill the copies, compact, keep the first ef rows
    kill_compact(keys, n_sort, 1, win, ef, pad_beam, sc->warp_sums);

    // select the first `expand` unexpanded rows
    const int per = (ef + blockDim.x - 1) / blockDim.x;
    const int lo = min(ef, tid * per);
    const int hi = min(ef, lo + per);
    int unexp = 0;
    for (int i = lo; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        unexp += ((k & 1ull) && s != (unsigned)SENT_SLOT) ? 1 : 0;
    }
    int n_unexp;
    int rank = block_exclusive_scan(unexp, sc->warp_sums, &n_unexp);
    // the window is sorted by distance: the first unexpanded row is the best
    for (int i = lo, r = rank; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        if ((k & 1ull) && s != (unsigned)SENT_SLOT) {
            if (r == 0) sc->d_first = __uint_as_float((unsigned)(k >> 32));
            ++r;
        }
    }
    __syncthreads();
    const float d_first = sc->d_first;
    const float worst = __uint_as_float((unsigned)(win[stop - 1] >> 32));
    const bool active = d_first < CUDART_INF_F && d_first <= worst;
    for (int i = lo, r = rank; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        int e = (k & 1ull) ? 0 : 1;
        if (e == 0 && s != (unsigned)SENT_SLOT) {
            ++r;                                  // inclusive rank of this row
            if (active && r <= expand) {
                e = 1;
                sc->misc[r - 1] = (int)s;
            }
        }
        od[q * ef + i] = __uint_as_float((unsigned)(k >> 32));
        os[q * ef + i] = (int)s;
        oe[q * ef + i] = e;
    }
    if (tid == 0) sc->misc[expand] = active ? 1 : 0;
    __syncthreads();
    if (tid < MISC_ROWS) misc[q * MISC_ROWS + tid] = sc->misc[tid];
}

static inline int merge_next_pow2(int x)
{
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

// Opt a merge kernel in to `smem` bytes of dynamic shared memory (past the
// default 48 KiB with its static scratch). Returns a CUDA error code.
template <typename Kernel>
static inline int merge_smem_attr(Kernel kernel, size_t smem)
{
    if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
    if (smem + 1024 > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    return 0;
}
