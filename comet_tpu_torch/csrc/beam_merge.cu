// K4: one step of the HNSW beam: merge, duplicate kill, compaction, select.
//
// Replaces comet_tpu/ops/beam_kernel.py:_merge_kernel (body _merge_body),
// launched by _beam_merge_pallas, in its split mode (fused = 0) and its
// fused mode (fused = 1: the admitted candidates also join a result set).
//
// What bounds it on an H100: a step reads (ef + ew) x 12 bytes and writes
// ef x 12 + 24 x 4 bytes per query (the fused result set doubles that): at
// Q = 2048, ef = ew = 256 about 17 MB, 5 us at 3.35 TB/s; the sort's 24 M
// compare-exchanges are integer work far below the card's rate. So bytes
// bound it, and what costs is latency: 45 dependent sort stages per block,
// each behind a barrier. chip_smoke.py computes each run's bound from its
// inputs; PERF.md has the measured times.
//
// Per query, on the port's query-major layout ([Q, rows]):
//   1. beam (ef rows of dist, slot, expanded) and candidates (ew rows,
//      expanded = 0) sorted by (dist asc, slot asc, expanded desc);
//   2. a row whose slot equals the previous row's is killed: copies of a
//      node carry bit-equal distances (the seed scan and the in-loop
//      scoring share one FMA chain, scan_tile.cuh), so one row stays, the
//      expanded copy if any;
//   3. the live rows compacted in order, the first ef kept, the rest
//      (inf, SENT, 0);
//   4. the first `expand` unexpanded rows selected and marked expanded when
//      the best unexpanded distance is at most row stop - 1's (the query is
//      active): misc[q, 0 .. expand-1] the selected slots (-1 none),
//      misc[q, expand] the flag, the rest -1;
//   5. (fused) the result set (kr sorted rows) and the admitted candidates
//      sorted by (dist, slot), adjacent copies killed, compacted, cut to kr.
// The order of step 1 is total up to rows equal in every field, so any
// correct sort gives the reference's result bit for bit: the kernel does
// not copy the TPU's bitonic network over queries on lanes.
//
// Design: one block of 256 threads per query. A row is one 64-bit key,
// (dist bits << 32) | (slot << 1) | (1 - expanded): distances are >= 0 or
// +inf, so their bits order as their values (-0.0 taken as +0.0, as K1
// does), and SENT = 2^31 - 1 fits in 31 bits. The block sorts the
// next_pow2(ef + ew) keys with a bitonic network in shared memory, marks
// the dead rows, places the live ones by a block prefix sum and selects
// over the compacted window with a second one. The fused result set
// reuses the key buffer with (dist bits << 32) | slot keys.

#include <cuda_runtime.h>
#include <math_constants.h>

#define MERGE_THREADS 256
#define MISC_ROWS 24
#define SENT_SLOT 2147483647u

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
__device__ void block_sort(u64* keys, int n)
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
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total)
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
__device__ void kill_compact(const u64* keys, int n, int shift, u64* out, int width,
                             u64 pad, int* warp_sums)
{
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int lo = min(n, (int)threadIdx.x * per);
    const int hi = min(n, lo + per);
    int live = 0;
    for (int i = lo; i < hi; ++i) {
        const unsigned s = (unsigned)(keys[i] >> shift) & 0x7FFFFFFFu;
        const bool dead = s == SENT_SLOT ||
            (i > 0 && s == ((unsigned)(keys[i - 1] >> shift) & 0x7FFFFFFFu));
        live += dead ? 0 : 1;
    }
    int total;
    int pos = block_exclusive_scan(live, warp_sums, &total);
    for (int i = lo; i < hi && pos < width; ++i) {
        const unsigned s = (unsigned)(keys[i] >> shift) & 0x7FFFFFFFu;
        const bool dead = s == SENT_SLOT ||
            (i > 0 && s == ((unsigned)(keys[i - 1] >> shift) & 0x7FFFFFFFu));
        if (!dead) out[pos++] = keys[i];
    }
    for (int i = total + (int)threadIdx.x; i < width; i += blockDim.x) out[i] = pad;
    __syncthreads();
}

__global__ void __launch_bounds__(MERGE_THREADS) beam_merge_kernel(
    const float* __restrict__ bd, const int* __restrict__ bs, const int* __restrict__ be,
    const float* __restrict__ nd, const int* __restrict__ ns,
    const float* __restrict__ rd, const int* __restrict__ rs, const int* __restrict__ adm,
    int ef, int ew, int expand, int stop, int kr, int fused, int n_sort, int n_res,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, float* __restrict__ ord, int* __restrict__ ors)
{
    extern __shared__ u64 smem[];
    u64* keys = smem;                             // max(n_sort, n_res)
    u64* win = smem + max(n_sort, n_res);         // max(ef, kr)
    __shared__ int warp_sums[32];
    __shared__ int misc_s[MISC_ROWS];
    __shared__ float d_first;

    const int tid = threadIdx.x;
    const long long q = blockIdx.x;
    const u64 pad_beam = beam_key(CUDART_INF_F, (int)SENT_SLOT, 0);

    // 1. keys of the beam and the candidates, padded to n_sort
    for (int i = tid; i < n_sort; i += blockDim.x) {
        u64 k = pad_beam;
        if (i < ef) {
            k = beam_key(bd[q * ef + i], bs[q * ef + i], be[q * ef + i]);
        } else if (i < ef + ew) {
            const int j = i - ef;
            k = beam_key(nd[q * ew + j], ns[q * ew + j], 0);
        }
        keys[i] = k;
    }
    if (tid < MISC_ROWS) misc_s[tid] = -1;
    if (tid == 0) d_first = CUDART_INF_F;
    __syncthreads();
    block_sort(keys, n_sort);

    // 2-3. kill the copies, compact, keep the first ef rows
    kill_compact(keys, n_sort, 1, win, ef, pad_beam, warp_sums);

    // 4. select the first `expand` unexpanded rows
    const int per = (ef + blockDim.x - 1) / blockDim.x;
    const int lo = min(ef, tid * per);
    const int hi = min(ef, lo + per);
    int unexp = 0;
    for (int i = lo; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        unexp += ((k & 1ull) && s != SENT_SLOT) ? 1 : 0;
    }
    int n_unexp;
    int rank = block_exclusive_scan(unexp, warp_sums, &n_unexp);
    // the window is sorted by distance: the first unexpanded row is the best
    for (int i = lo, r = rank; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        if ((k & 1ull) && s != SENT_SLOT) {
            if (r == 0) d_first = __uint_as_float((unsigned)(k >> 32));
            ++r;
        }
    }
    __syncthreads();
    const float worst = __uint_as_float((unsigned)(win[stop - 1] >> 32));
    const bool active = d_first < CUDART_INF_F && d_first <= worst;
    for (int i = lo, r = rank; i < hi; ++i) {
        const u64 k = win[i];
        const unsigned s = (unsigned)(k >> 1) & 0x7FFFFFFFu;
        int e = (k & 1ull) ? 0 : 1;
        if (e == 0 && s != SENT_SLOT) {
            ++r;                                  // inclusive rank of this row
            if (active && r <= expand) {
                e = 1;
                misc_s[r - 1] = (int)s;
            }
        }
        od[q * ef + i] = __uint_as_float((unsigned)(k >> 32));
        os[q * ef + i] = (int)s;
        oe[q * ef + i] = e;
    }
    if (tid == 0) misc_s[expand] = active ? 1 : 0;
    __syncthreads();
    if (tid < MISC_ROWS) misc[q * MISC_ROWS + tid] = misc_s[tid];
    if (!fused) return;

    // 5. the result set: kr sorted rows + the admitted candidates
    const u64 pad_res = res_key(CUDART_INF_F, (int)SENT_SLOT);
    for (int i = tid; i < n_res; i += blockDim.x) {
        u64 k = pad_res;
        if (i < kr) {
            k = res_key(rd[q * kr + i], rs[q * kr + i]);
        } else if (i < kr + ew) {
            const int j = i - kr;
            if (adm[q * ew + j] != 0) k = res_key(nd[q * ew + j], ns[q * ew + j]);
        }
        keys[i] = k;
    }
    __syncthreads();
    block_sort(keys, n_res);
    kill_compact(keys, n_res, 0, win, kr, pad_res, warp_sums);
    for (int i = tid; i < kr; i += blockDim.x) {
        const u64 k = win[i];
        ord[q * kr + i] = __uint_as_float((unsigned)(k >> 32));
        ors[q * kr + i] = (int)(k & 0x7FFFFFFFull);
    }
}

static int next_pow2(int x)
{
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

extern "C" int comet_beam_merge(
    const float* bd, const int* bs, const int* be, const float* nd, const int* ns,
    const float* rd, const int* rs, const int* adm,
    int Q, int ef, int ew, int expand, int stop, int kr, int fused,
    float* od, int* os, int* oe, int* misc, float* ord, int* ors, void* stream)
{
    if (Q < 1 || ef < 1 || ew < 1 || expand < 1 || expand >= MISC_ROWS ||
        stop < 1 || stop > ef || (fused && kr < 1))
        return (int)cudaErrorInvalidValue;
    const int n_sort = next_pow2(ef + ew);
    const int n_res = fused ? next_pow2(kr + ew) : 0;
    const int width = ef > kr ? ef : kr;
    const size_t smem = sizeof(u64) * ((size_t)(n_sort > n_res ? n_sort : n_res) + width);
    if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
    // past 48 KiB with the static shared memory: opt in to the larger size
    if (smem + 1024 > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            beam_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    beam_merge_kernel<<<Q, MERGE_THREADS, smem, (cudaStream_t)stream>>>(
        bd, bs, be, nd, ns, rd, rs, adm, ef, ew, expand, stop, kr, fused, n_sort, n_res,
        od, os, oe, misc, ord, ors);
    return (int)cudaGetLastError();
}
