// K1: exact top-k smallest per row, ordered by (value asc, index asc).
//
// Replaces comet_tpu/ops/sortnet.py:_kernel (body topk_body), the Pallas
// bitonic top-k launched by topk_cl and cand_topk_hier.
//
// What bounds it on an H100: one pass reads each candidate once (8 bytes
// of value and index) and writes k keys per chunk, so device-memory traffic
// is small; the bitonic network of a chunk of n keys does
// n/2 * log2(n) * (log2(n) + 1) / 2 compare-exchanges in shared memory with a
// __syncthreads between stages, so shared-memory bandwidth and barrier
// latency bound it.
//
// Design: each (value, index) pair becomes one 64-bit key whose unsigned
// order is the lexicographic (value, index) order: the high word holds the
// float's bits mapped to an order-preserving unsigned integer, the low word
// the index with its sign bit flipped. One block loads a chunk of up to
// 16384 keys of one row into shared memory, sorts it ascending and writes
// its lowest k. The host repeats passes over the surviving keys until one
// chunk remains; the last pass writes values and indices. Keeping the k
// smallest of each chunk and then the k smallest of the survivors is exact
// because top-k is associative under that merge. A k too large for a
// shared-memory chunk (2k > 16384) sorts whole rows in device memory
// instead, one launch per bitonic stage: slow, and off the main path.
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
#define MAX_CHUNK 16384

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

// Ascending bitonic sort of n (a power of two) keys in shared memory.
__device__ void bitonic_sort(u64* s, int n) {
    const int half = n >> 1;
    for (int size = 2; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            for (int p = threadIdx.x; p < half; p += blockDim.x) {
                const int lo = 2 * stride * (p / stride) + (p % stride);
                const int hi = lo + stride;
                const bool asc = (lo & size) == 0;
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

// One pass. Block (row r = blockIdx.x, chunk b = blockIdx.y) sorts elements
// [b * chunk, (b + 1) * chunk) of row r, padded with PAD_KEY past `width`.
// Input is either (vals, idx) with element (r, c) at r * in_row + c * in_col
// (idx == nullptr: the index is c), or keys `kin` [rows, width] contiguous.
// Output is either keys `kout` [rows, gridDim.y * k] contiguous, or the
// unpacked values and indices with element (r, t) at r * out_row + t * out_col.
__global__ void topk_pass_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, const u64* __restrict__ kin,
    int width, int chunk, int k, u64* __restrict__ kout,
    float* __restrict__ vout, int* __restrict__ iout,
    long long out_row, long long out_col)
{
    extern __shared__ u64 s[];
    const long long r = blockIdx.x;
    const int c0 = blockIdx.y * chunk;
    for (int t = threadIdx.x; t < chunk; t += blockDim.x) {
        const int c = c0 + t;
        u64 key = PAD_KEY;
        if (c < width) {
            if (kin != nullptr) {
                key = kin[r * width + c];
            } else {
                const long long off = r * in_row + (long long)c * in_col;
                key = pack_key(vals[off], idx != nullptr ? idx[off] : c);
            }
        }
        s[t] = key;
    }
    __syncthreads();
    bitonic_sort(s, chunk);
    for (int t = threadIdx.x; t < k; t += blockDim.x) {
        const u64 key = s[t];
        if (kout != nullptr) {
            kout[r * gridDim.y * k + (long long)blockIdx.y * k + t] = key;
        } else {
            const long long off = r * out_row + (long long)t * out_col;
            vout[off] = key_value(key);
            iout[off] = key_index(key);
        }
    }
}

// Large k (2k above MAX_CHUNK): whole rows are sorted in device memory, one
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
    u64 key = PAD_KEY;
    if (c < width) {
        const long long off = r * in_row + (long long)c * in_col;
        key = pack_key(vals[off], idx != nullptr ? idx[off] : c);
    }
    keys[e] = key;
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

extern "C" int comet_topk_pass(
    const float* vals, const int* idx, long long in_row, long long in_col,
    const u64* kin, int rows, int width, int chunk, int k, u64* kout,
    float* vout, int* iout, long long out_row, long long out_col,
    void* stream)
{
    if (chunk < 2 || chunk > MAX_CHUNK || (chunk & (chunk - 1)) != 0 ||
        k < 1 || k > chunk || rows < 1 || width < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const int n_chunks = (width + chunk - 1) / chunk;
    if (n_chunks > 65535 || (kout == nullptr && n_chunks != 1)) {
        return (int)cudaErrorInvalidValue;
    }
    const size_t smem = (size_t)chunk * sizeof(u64);
    cudaError_t err = cudaFuncSetAttribute(
        topk_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(MAX_CHUNK * sizeof(u64)));
    if (err != cudaSuccess) return (int)err;
    const int threads = chunk / 2 < 1024 ? chunk / 2 : 1024;
    dim3 grid((unsigned)rows, (unsigned)n_chunks);
    topk_pass_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
        vals, idx, in_row, in_col, kin, width, chunk, k, kout, vout, iout,
        out_row, out_col);
    return (int)cudaGetLastError();
}
