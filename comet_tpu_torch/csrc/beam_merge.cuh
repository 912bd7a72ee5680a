// The merge body of the HNSW beam, shared by K4 (beam_merge.cu) and K5
// (fused_expand.cu): both kernels run one block per query over 64-bit
// keys in shared memory, any multiple of 32 threads.
//
// A beam row is one key, (dist bits << 32) | (slot << 1) | (1 - expanded):
// distances are >= 0 or +inf, so their bits order as their values (-0.0
// taken as +0.0, as K1 does), and SENT = 2^31 - 1 fits in 31 bits. A result
// row is (dist bits << 32) | slot. The order of a key is (dist asc, slot
// asc, expanded desc), total up to rows equal in every field, so any
// correct sort or merge gives the reference's sequence bit for bit.
//
// `merge_select` is the split step: the beam arrives sorted (the previous
// step's compacted window), so only the candidates are sorted, and the two
// sorted runs are merged by merge path; then the adjacent copies of a slot
// are killed, the live rows compacted, the first ef kept, the first
// `expand` unexpanded rows selected with the query's active flag (module
// docstring of ops/beam_kernel.py). A beam that does not ascend (outside
// `beam_merge_step`'s contract, but the kernel stays equal to the plain
// version on any input) is sorted first.
//
// The sort (`block_sort`) takes runs of 32 keys, one key a lane, through a
// bitonic network of warp shuffles (no barrier), then merges pairs of runs
// by merge path, one barrier a level: each thread finds where its
// contiguous share of the output starts by a binary search on the merge
// diagonal and writes that share in order. ew = 256 candidates take three
// levels where the bitonic sort of next_pow2(ef + ew) = 512 keys took 45
// barriered stages.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

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

// Keys rounded up to whole 32-key runs.
__host__ __device__ __forceinline__ int merge_run(int n) { return (n + 31) & ~31; }

// out[k] for k in [k_lo, k_hi) of the merge of the ascending runs A[0, na)
// and (B[j] | b_or)[0, nb), A first on equal keys.
__device__ __forceinline__ void merge_range(const u64* A, int na, const u64* B, int nb,
                                            u64 b_or, u64* out, int k_lo, int k_hi)
{
    // the merge-path split of diagonal k_lo: how many of A come first
    int lo = max(0, k_lo - nb);
    int hi = min(k_lo, na);
    while (lo < hi) {
        const int i = (lo + hi) >> 1;
        if (A[i] <= (B[k_lo - 1 - i] | b_or)) lo = i + 1;
        else hi = i;
    }
    int ia = lo;
    int ib = k_lo - lo;
    for (int k = k_lo; k < k_hi; ++k) {
        const u64 b = ib < nb ? (B[ib] | b_or) : 0ull;
        if (ib >= nb || (ia < na && A[ia] <= b)) {
            out[k] = A[ia++];
        } else {
            out[k] = b;
            ++ib;
        }
    }
}

// out[0, na + nb) = the merge of A and B | b_or, each thread writing a
// contiguous share. Ends with a barrier.
__device__ __forceinline__ void block_merge(const u64* A, int na, const u64* B, int nb,
                                            u64 b_or, u64* out)
{
    const int n = na + nb;
    const int per = (n + blockDim.x - 1) / blockDim.x;
    const int lo = min(n, (int)threadIdx.x * per);
    const int hi = min(n, lo + per);
    if (lo < hi) merge_range(A, na, B, nb, b_or, out, lo, hi);
    __syncthreads();
}

// Ascending sort of the n keys at a (n a multiple of 32, written before a
// barrier), with tmp (n keys) as the other buffer. Returns where the sorted
// keys are, a or tmp. Ends with a barrier.
__device__ __forceinline__ u64* block_sort(u64* a, u64* tmp, int n)
{
    const int lane = threadIdx.x & 31;
    const int n_warps = blockDim.x >> 5;
    for (int r = threadIdx.x >> 5; r < n / 32; r += n_warps) {
        u64 v = a[r * 32 + lane];
#pragma unroll
        for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
            for (int j = k >> 1; j > 0; j >>= 1) {
                const u64 o = __shfl_xor_sync(0xFFFFFFFFu, v, j);
                const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
                v = keep_min ? (o < v ? o : v) : (o > v ? o : v);
            }
        }
        a[r * 32 + lane] = v;
    }
    __syncthreads();
    const int per = (n + blockDim.x - 1) / blockDim.x;
    for (int w = 32; w < n; w <<= 1) {
        // merge runs [base, base + w) and [base + w, base + 2w)
        int k = min(n, (int)threadIdx.x * per);
        const int hi = min(n, k + per);
        while (k < hi) {
            const int base = k / (2 * w) * (2 * w);
            const int na = min(w, n - base);
            const int nb = max(0, min(w, n - base - w));
            const int end = min(hi, base + na + nb);
            merge_range(a + base, na, a + base + w, nb, 0ull, tmp + base, k - base, end - base);
            k = end;
        }
        __syncthreads();
        u64* t = a;
        a = tmp;
        tmp = t;
    }
    return a;
}

// Whether a[0, n) ascends (the keys written before a barrier); the same
// answer in every thread. A barrier.
__device__ __forceinline__ bool block_ascends(const u64* a, int n)
{
    int bad = 0;
    for (int i = threadIdx.x + 1; i < n; i += blockDim.x) bad |= a[i - 1] > a[i] ? 1 : 0;
    return __syncthreads_or(bad) == 0;
}

// The n keys at a (room for merge_run(n)) in ascending order: a itself
// when they ascend, else sorted with pads up to the whole run (the largest
// key, so the first n sorted keys are a's). tmp: merge_run(n) keys.
// Returns where they are. Ends with a barrier.
__device__ __forceinline__ u64* block_sorted_run(u64* a, u64* tmp, int n, u64 pad)
{
    if (block_ascends(a, n)) return a;
    for (int i = n + (int)threadIdx.x; i < merge_run(n); i += blockDim.x) a[i] = pad;
    __syncthreads();
    return block_sort(a, tmp, merge_run(n));
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

// The split step's buffers in dynamic shared memory, for ef beam rows and
// ew candidates: beam and win merge_run(ef) keys, cand and tmp
// merge_run(ew), merged ef + merge_run(ew).
struct MergeBufs {
    u64* beam;
    u64* cand;
    u64* tmp;
    u64* merged;
    u64* win;
};

__host__ __device__ __forceinline__ int merge_keys(int ef, int ew)
{
    return 2 * merge_run(ef) + 3 * merge_run(ew) + ef;
}

__device__ __forceinline__ MergeBufs merge_bufs(u64* smem, int ef, int ew)
{
    MergeBufs b;
    b.beam = smem;
    b.win = b.beam + merge_run(ef);
    b.cand = b.win + merge_run(ef);
    b.tmp = b.cand + merge_run(ew);
    b.merged = b.tmp + merge_run(ew);
    return b;
}

// The split step of query q. The caller wrote the ef beam keys to
// bufs.beam and merge_run(ew) candidate keys to bufs.cand (past ew: the
// largest key). A candidate's lowest bit is ignored (taken as 1, not
// expanded), so the caller may carry a flag in it. Sorts the candidates,
// merges them with the beam, kills, compacts into bufs.win (ef keys) and
// selects: writes od / os / oe [q, ef] and misc [q, MISC_ROWS], the
// selected slots (-1 none), the active flag at `expand`, the rest -1.
// Returns the sorted candidate run (merge_run(ew) keys, flags kept).
__device__ __forceinline__ const u64* merge_select(
    const MergeBufs& bufs, int ef, int ew, int expand, int stop, long long q,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, MergeScratch* sc)
{
    const int tid = threadIdx.x;
    const int nc = merge_run(ew);
    const u64 pad_beam = beam_key(CUDART_INF_F, SENT_SLOT, 0);
    if (tid < MISC_ROWS) sc->misc[tid] = -1;
    if (tid == 0) sc->d_first = CUDART_INF_F;
    __syncthreads();
    const u64* beam = block_sorted_run(bufs.beam, bufs.win, ef, pad_beam);
    const u64* cand = block_sort(bufs.cand, bufs.tmp, nc);
    block_merge(beam, ef, cand, nc, 1ull, bufs.merged);

    // kill the copies, compact, keep the first ef rows
    u64* win = bufs.win;
    kill_compact(bufs.merged, ef + nc, 1, win, ef, pad_beam, sc->warp_sums);

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
    return cand;
}
