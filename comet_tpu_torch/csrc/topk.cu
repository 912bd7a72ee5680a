// K1: exact top-k smallest per row, ordered by (value asc, index asc).
//
// Replaces comet_tpu/ops/sortnet.py:_kernel (body topk_body), the Pallas
// bitonic top-k launched by topk_cl and cand_topk_hier.
//
// Keys: each (value, index) pair becomes one 64-bit key whose unsigned
// order is the lexicographic (value, index) order: the high word holds the
// float's bits mapped to an order-preserving unsigned integer, the low word
// the index with its sign bit flipped. Any exact selection on keys
// therefore gives the reference's output bit for bit.
//
// What bounds it on an H100: the answer needs one read of each candidate
// (8 bytes of value and index) and a write of kp keys per row, so device
// memory bounds the work (a [256, 16384] select moves 33.6 MB, 0.010 ms at
// 3.35 TB/s). What a kernel spends beyond that is latency: the barriers of
// the block that owns a row, and the two waves of 256 rows on 132 SMs.
//
// Design: one launch per select (kp <= KP_MAX), one block per row.
// - Radix select (rows wider than 2 kp). The block reads its row once,
//   coalesced, through the strides it is given (both layouts work), packs
//   the keys and keeps them in shared memory (up to SMEM_KEYS = 16384 keys,
//   128 KiB) or, past that, in a scratch row in device memory that stays
//   L2-resident. It finds the kp-th smallest key MSB first, 8 bits a pass:
//   a 256-bin shared-memory histogram of the keys that still match the
//   chosen prefix (warp-aggregated atomics; the first histogram is built as
//   the row is loaded), and a scan of the bins picks the digit. It stops as
//   soon as the chosen bucket holds exactly the keys still needed: 2-4
//   passes on float data; tied values walk into the index bits, at most 8
//   passes, and a key repeated across the boundary is the fill. The keys
//   below the boundary are compacted (warp-aggregated slot counter; their
//   order is irrelevant), copies of the boundary key fill the rest exactly
//   as a sort would repeat it, and the kp keys are bitonic-sorted in shared
//   memory and written. The work is a few looks at each key, against the
//   log2(n)^2 / 2 barrier stages of sorting whole chunks.
// - Direct sort (rows no wider than 2 kp, e.g. the HNSW finalize's
//   [2048, 256] at k = 128): the block sorts several rows at once, each
//   padded with PAD_KEY to a power of two of at least kp, and writes their
//   first kp keys. Rows shorter than kp come out padded with PAD_KEY.
// A kp above KP_MAX (2 kp above 16384) sorts whole rows in device memory,
// one launch per bitonic stage: slow, and off every main path.
//
// Ties: the reference compares values with `<`, so -0.0 and +0.0 are equal
// and fall through to the index. The key canonicalises -0.0 to +0.0 to keep
// that order, and the value written back is therefore +0.0. NaN does not
// occur on the search path and is not ordered here.

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

// Key of the padding candidate (+inf, 2^31 - 1), the largest key any real
// candidate can have.
#define PAD_KEY 0xFF800000FFFFFFFFull
#define KP_MAX 8192        // largest kp of the one-launch select
#define SMEM_KEYS 16384    // keys of a row kept in shared memory at most
#define DIRECT_ROW_KEYS 1024  // keys a direct-sort block holds when rows are short
#define LOAD_BATCH 8       // row loads a thread keeps in flight
#define FULL 0xFFFFFFFFu

__device__ __forceinline__ u64 pack_key(float v, int i) {
    unsigned u = __float_as_uint(v);
    if ((u << 1) == 0u) u = 0u;  // -0.0 -> +0.0
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((u64)u << 32) | (u64)((unsigned)i ^ 0x80000000u);
}

__device__ __forceinline__ float key_value(u64 key) {
    unsigned u = (unsigned)(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    return __uint_as_float(u);
}

__device__ __forceinline__ int key_index(u64 key) {
    return (int)((unsigned)key ^ 0x80000000u);
}

__device__ __forceinline__ u64 load_key(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long r, int c, long long in_row, long long in_col)
{
    const long long off = r * in_row + (long long)c * in_col;
    return pack_key(vals[off], idx != nullptr ? idx[off] : c);
}

// Ascending bitonic sort, block-wide, of consecutive segments of n keys (n a
// power of two) that together hold n_pairs * 2 keys. Each segment is sorted
// on its own: its stages never reach past it, and the last merge of every
// segment runs ascending.
__device__ void bitonic_sort_segments(u64* s, int n, int n_pairs) {
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = threadIdx.x; p < n_pairs; p += blockDim.x) {
                const int lo = 2 * stride * (p / stride) + (p % stride);
                const int hi = lo + stride;
                const bool asc = size == n || (lo & size) == 0;
                const u64 a = s[lo];
                const u64 b = s[hi];
                if ((a > b) == asc) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
            __syncthreads();
        }
    }
}

// Adds one to hist[bin] for every lane; bin 256 counts nothing. Lanes with
// the same bin add once, together. Every lane of the warp must call it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin) {
    if (__ballot_sync(FULL, bin < 256u) == 0u) return;
    const unsigned peers = __match_any_sync(FULL, bin);
    if (bin < 256u && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

struct RadixState {
    unsigned hist[256];
    unsigned warp_total[8];
    unsigned digit, need, count, filled;
};

// The bin that holds the need-th smallest counted key: st.digit, the keys
// still needed inside it (st.need) and its count (st.count). Needs at least
// 256 threads; ends with a barrier.
__device__ void choose_digit(RadixState& st, unsigned need) {
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    unsigned c = 0, incl = 0;
    if (tid < 256) {
        c = st.hist[tid];
        incl = c;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const unsigned v = __shfl_up_sync(FULL, incl, off);
            if (lane >= off) incl += v;
        }
        if (lane == 31) st.warp_total[tid >> 5] = incl;
    }
    __syncthreads();
    if (tid < 256) {
        for (int w = 0; w < (tid >> 5); ++w) incl += st.warp_total[w];
        const unsigned excl = incl - c;
        if (excl < need && need <= incl) {
            st.digit = (unsigned)tid;
            st.need = need - excl;
            st.count = c;
        }
    }
    __syncthreads();
}

// One select. Direct mode (n_sort > 0): block b sorts rows
// [b * rows_per_block, (b + 1) * rows_per_block), each padded to n_sort
// keys. Radix mode (n_sort == 0): block b selects from row b, holding its
// keys in shared memory, or in `scratch` [rows, width] when that is given.
// Element (r, c) of the input is at r * in_row + c * in_col (idx == nullptr:
// the index is c); element (r, t) of the output at r * out_row + t * out_col.
__global__ void topk_select_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, int rows, int width, int kp,
    int n_sort, int rows_per_block, u64* __restrict__ scratch,
    float* __restrict__ vout, int* __restrict__ iout,
    long long out_row, long long out_col)
{
    extern __shared__ u64 smem[];
    const int tid = threadIdx.x;
    const int T = blockDim.x;

    if (n_sort > 0) {
        const long long r0 = (long long)blockIdx.x * rows_per_block;
        for (int e = tid; e < rows_per_block * n_sort; e += T) {
            const long long r = r0 + e / n_sort;
            const int c = e % n_sort;
            smem[e] = (r < rows && c < width) ? load_key(vals, idx, r, c, in_row, in_col) : PAD_KEY;
        }
        __syncthreads();
        bitonic_sort_segments(smem, n_sort, rows_per_block * n_sort / 2);
        for (int e = tid; e < rows_per_block * kp; e += T) {
            const long long r = r0 + e / kp;
            const int t = e % kp;
            if (r < rows) {
                const u64 key = smem[(e / kp) * n_sort + t];
                const long long off = r * out_row + (long long)t * out_col;
                vout[off] = key_value(key);
                iout[off] = key_index(key);
            }
        }
        return;
    }

    __shared__ RadixState st;
    const long long r = blockIdx.x;
    u64* sel = smem;   // the kp selected keys
    u64* keys = scratch != nullptr ? scratch + r * width : smem + kp;
    const int per = (width + T - 1) / T;   // keys per thread: c = tid + j * T

    // load the row once, LOAD_BATCH keys a thread in flight, with the
    // histogram of the top digit
    if (tid < 256) st.hist[tid] = 0u;
    __syncthreads();
    for (int j0 = 0; j0 < per; j0 += LOAD_BATCH) {
        u64 batch[LOAD_BATCH];
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int c = tid + (j0 + u) * T;
            batch[u] = c < width ? load_key(vals, idx, r, c, in_row, in_col) : 0ull;
        }
#pragma unroll
        for (int u = 0; u < LOAD_BATCH; ++u) {
            const int c = tid + (j0 + u) * T;
            if (c < width) keys[c] = batch[u];
            hist_add(st.hist, c < width ? (unsigned)(batch[u] >> 56) : 256u);
        }
    }
    __syncthreads();

    // MSB-first digits until the chosen bucket is exactly what is needed
    u64 prefix = 0ull, hi = 0ull;   // the chosen digits, and their bits
    unsigned need = (unsigned)kp;
    int shift = 56;
    bool whole_bucket;
    for (;;) {
        choose_digit(st, need);
        need = st.need;
        prefix |= (u64)st.digit << shift;
        hi |= 0xFFull << shift;
        whole_bucket = st.count == need;
        if (whole_bucket || shift == 0) break;
        shift -= 8;
        if (tid < 256) st.hist[tid] = 0u;
        __syncthreads();
        for (int j = 0; j < per; ++j) {
            const int c = tid + j * T;
            unsigned bin = 256u;
            if (c < width) {
                const u64 key = keys[c];
                if ((key & hi) == prefix) bin = (unsigned)(key >> shift) & 0xFFu;
            }
            hist_add(st.hist, bin);
        }
        __syncthreads();
    }

    // Compact the keys below the boundary (and the whole boundary bucket
    // when it is exactly what is needed); otherwise the bucket is a single
    // key, `prefix`, repeated, and `need` copies of it fill the rest.
    if (tid == 0) st.filled = 0u;
    __syncthreads();
    for (int j = 0; j < per; ++j) {
        const int c = tid + j * T;
        bool take = false;
        u64 key = 0ull;
        if (c < width) {
            key = keys[c];
            const u64 top = key & hi;
            take = top < prefix || (whole_bucket && top == prefix);
        }
        const unsigned ballot = __ballot_sync(FULL, take);
        if (ballot == 0u) continue;
        const int lane = tid & 31;
        unsigned base = 0u;
        if (lane == __ffs(ballot) - 1) base = atomicAdd(&st.filled, __popc(ballot));
        base = __shfl_sync(FULL, base, __ffs(ballot) - 1);
        if (take) sel[base + __popc(ballot & ((1u << lane) - 1u))] = key;
    }
    __syncthreads();
    for (int t = (int)st.filled + tid; t < kp; t += T) sel[t] = prefix;
    __syncthreads();
    bitonic_sort_segments(sel, kp, kp / 2);
    for (int t = tid; t < kp; t += T) {
        const u64 key = sel[t];
        const long long off = r * out_row + (long long)t * out_col;
        vout[off] = key_value(key);
        iout[off] = key_index(key);
    }
}

// Large k (2k above SMEM_KEYS): whole rows are sorted in device memory, one
// launch per bitonic stage. Rows are padded to n_pad (a power of two).
__global__ void pack_rows_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, int rows, int width, int n_pad,
    u64* __restrict__ keys)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)rows * n_pad) return;
    const long long r = e / n_pad;
    const int c = (int)(e % n_pad);
    keys[e] = c < width ? load_key(vals, idx, r, c, in_row, in_col) : PAD_KEY;
}

__global__ void bitonic_stage_kernel(
    u64* __restrict__ keys, int rows, int n_pad, int size, int stride)
{
    const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const int half = n_pad >> 1;
    if (p >= (long long)rows * half) return;
    const long long r = p / half;
    const int q = (int)(p % half);
    const int lo = 2 * stride * (q / stride) + (q % stride);
    const bool asc = (lo & size) == 0;
    u64* row = keys + r * n_pad;
    const u64 a = row[lo];
    const u64 b = row[lo + stride];
    if ((a > b) == asc) {
        row[lo] = b;
        row[lo + stride] = a;
    }
}

__global__ void unpack_rows_kernel(
    const u64* __restrict__ keys, int rows, int n_pad, int k,
    float* __restrict__ vout, int* __restrict__ iout,
    long long out_row, long long out_col)
{
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= (long long)rows * k) return;
    const long long r = e / k;
    const int t = (int)(e % k);
    const u64 key = keys[r * n_pad + t];
    const long long off = r * out_row + (long long)t * out_col;
    vout[off] = key_value(key);
    iout[off] = key_index(key);
}

extern "C" int comet_topk_rows_global(
    const float* vals, const int* idx, long long in_row, long long in_col,
    int rows, int width, int n_pad, int k, u64* keys,
    float* vout, int* iout, long long out_row, long long out_col,
    void* stream)
{
    if (n_pad < 2 || (n_pad & (n_pad - 1)) != 0 || n_pad < width ||
        k < 1 || k > n_pad || rows < 1 || width < 1) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const long long n_keys = (long long)rows * n_pad;
    pack_rows_kernel<<<(unsigned)((n_keys + threads - 1) / threads), threads, 0, s>>>(
        vals, idx, in_row, in_col, rows, width, n_pad, keys);
    const long long n_pairs = n_keys / 2;
    const unsigned pair_blocks = (unsigned)((n_pairs + threads - 1) / threads);
    for (int size = 2; size <= n_pad; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            bitonic_stage_kernel<<<pair_blocks, threads, 0, s>>>(
                keys, rows, n_pad, size, stride);
        }
    }
    const long long n_out = (long long)rows * k;
    unpack_rows_kernel<<<(unsigned)((n_out + threads - 1) / threads), threads, 0, s>>>(
        keys, rows, n_pad, k, vout, iout, out_row, out_col);
    return (int)cudaGetLastError();
}

static int next_pow2(int x) {
    int p = 1;
    while (p < x) p <<= 1;
    return p;
}

// The one-launch select: kp (a power of two, 8 <= kp <= KP_MAX) smallest
// keys of each row. `scratch` [rows, width] is needed exactly when the row
// takes the radix mode (width > 2 kp) and does not fit shared memory
// (width > SMEM_KEYS); it must be null otherwise.
extern "C" int comet_topk_select(
    const float* vals, const int* idx, long long in_row, long long in_col,
    int rows, int width, int kp, u64* scratch,
    float* vout, int* iout, long long out_row, long long out_col,
    void* stream)
{
    if (kp < 8 || kp > KP_MAX || (kp & (kp - 1)) != 0 || rows < 1 || width < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const bool direct = width <= 2 * kp;
    if ((scratch != nullptr) != (!direct && width > SMEM_KEYS)) {
        return (int)cudaErrorInvalidValue;
    }
    int n_sort = 0, rows_per_block = 1, threads;
    long long blocks = rows;
    size_t smem;
    if (direct) {
        n_sort = next_pow2(width > kp ? width : kp);
        rows_per_block = n_sort < DIRECT_ROW_KEYS ? DIRECT_ROW_KEYS / n_sort : 1;
        if (rows_per_block > rows) rows_per_block = rows;
        const int pairs = rows_per_block * n_sort / 2;
        threads = pairs < 1024 ? (pairs < 32 ? 32 : pairs) : 1024;
        blocks = (rows + rows_per_block - 1) / rows_per_block;
        smem = (size_t)rows_per_block * n_sort * sizeof(u64);
    } else {
        threads = next_pow2((width + 7) / 8);
        threads = threads < 256 ? 256 : (threads > 1024 ? 1024 : threads);
        smem = (size_t)(kp + (scratch != nullptr ? 0 : width)) * sizeof(u64);
    }
    cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((SMEM_KEYS + KP_MAX) * sizeof(u64)));
    if (err != cudaSuccess) return (int)err;
    topk_select_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        vals, idx, in_row, in_col, rows, width, kp, n_sort, rows_per_block, scratch,
        vout, iout, out_row, out_col);
    return (int)cudaGetLastError();
}
