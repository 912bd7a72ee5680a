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
// (8 bytes of value and index; 4 when the index is the position) and a
// write of kp keys per row, so device memory bounds the work (a [256,
// 16384] select moves 33.6 MB, 0.010 ms at 3.35 TB/s; a [256, 2^20] row
// block without indices 1.07 GB, 0.32 ms). What a kernel spends beyond
// that is latency: barriers, launches, and SMs left idle when a few rows
// own the card.
//
// Two routes, one launch sequence a select (kp <= KP_MAX):
// - One block a row (rows no wider than SMEM_KEYS; ops/sortnet.py
//   picks). Radix select (rows wider than 2 kp):
//   the block reads its row once, coalesced, through the strides it is
//   given (both layouts work), packs the keys and keeps them in shared
//   memory (up to SMEM_KEYS = 16384 keys, 128 KiB). It finds the kp-th
//   smallest key MSB first, 8 bits a pass: a 256-bin shared-memory
//   histogram of the keys that still match the chosen prefix
//   (warp-aggregated atomics; the first histogram is built as the row is
//   loaded), and a scan of the bins picks the digit. It stops as soon as
//   the chosen bucket holds exactly the keys still needed: 2-4 passes on
//   float data; tied values walk into the index bits, at most 8 passes,
//   and a key repeated across the boundary is the fill. The keys below
//   the boundary are compacted (warp-aggregated slot counter; their order
//   is irrelevant), copies of the boundary key fill the rest exactly as a
//   sort would repeat it, and the kp keys are bitonic-sorted in shared
//   memory and written. Direct sort (rows no wider than 2 kp, e.g. the
//   HNSW finalize's [2048, 256] at k = 128): the block sorts several rows
//   at once, each padded with PAD_KEY to a power of two of at least kp,
//   and writes their first kp keys. Rows shorter than kp come out padded
//   with PAD_KEY.
// - Split (rows wider than SMEM_KEYS, such as BM25's [256, 2^20] and a
//   store segment's one query): each row is cut into tiles with a block each, the shape of the
//   published radix select "AIR top-k". A launch a digit of 11 bits (11,
//   11, 10 bits of the value; the index's three more only when indices
//   are given): each block histograms its keys' digit in shared memory and
//   adds it into the row's histogram in device memory; the row's last
//   block to finish picks the digit there. Keys below the chosen bucket go
//   straight to the row's kp-key selection buffer; once the bucket holds
//   at most SPLIT_CAP keys it is copied to a small per-row buffer and later
//   passes read that instead of the row, so no [rows, width] scratch is
//   ever made. A bucket whose keys are all equal (BM25's run of ~10^6
//   zeros) resolves at once. Ties at the boundary are cheap without
//   indices: the index is the position, so each tile's count of boundary
//   keys, summed over the tiles before it, tells each block how many of
//   its own to take. With indices, the index digits settle them and the
//   last key is repeated as the fill. A final launch writes the keys below
//   the boundary and the ties; the row's last block sorts the kp keys in
//   shared memory and writes them. Launches: 5 a select without indices
//   (3 digits, the tie count, the write), 7 with them (6 digits, the
//   write), each a no-op for rows already settled.
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
#define KP_MAX 8192        // largest kp of the radix selects
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

// Adds one to hist[bin] for every lane; a bin of nbins or more counts
// nothing. Lanes with the same bin add once, together. Every lane of the
// warp must call it.
__device__ __forceinline__ void hist_add(unsigned* hist, unsigned bin, unsigned nbins) {
    if (__ballot_sync(FULL, bin < nbins) == 0u) return;
    const unsigned peers = __match_any_sync(FULL, bin);
    if (bin < nbins && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[bin], __popc(peers));
}

// Writes the keys of the lanes with `take` to buf, at consecutive slots
// taken from *counter (shared or device memory; the order of the slots is
// irrelevant). Every lane of the warp must call it.
__device__ __forceinline__ void warp_append(unsigned* counter, u64* buf, bool take, u64 key) {
    const unsigned ballot = __ballot_sync(FULL, take);
    if (ballot == 0u) return;
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(ballot) - 1;
    unsigned base = 0u;
    if (lane == leader) base = atomicAdd(counter, __popc(ballot));
    base = __shfl_sync(FULL, base, leader);
    if (take) buf[base + __popc(ballot & ((1u << lane) - 1u))] = key;
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
// keys in shared memory.
// Element (r, c) of the input is at r * in_row + c * in_col (idx == nullptr:
// the index is c); element (r, t) of the output at r * out_row + t * out_col.
__global__ void topk_select_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, int rows, int width, int kp,
    int n_sort, int rows_per_block,
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
    u64* keys = smem + kp;
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
            hist_add(st.hist, c < width ? (unsigned)(batch[u] >> 56) : 256u, 256u);
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
            hist_add(st.hist, bin, 256u);
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
        warp_append(&st.filled, sel, take, key);
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

// ---- The split route: a row across many blocks --------------------------
//
// Rows wider than SMEM_KEYS are split into tiles of `tile` columns with a block each (see the note at the top).
// A row's state lives in device memory (SplitRow) and passes from launch
// to launch; the last block of a row to finish a launch (an atomic count)
// makes the row's decision for the next one.
//
// B_p, the keys of a row that match its first p chosen digits, shrinks
// pass by pass (B_0 is the row). Pass p reads B_{p-1} (from a candidate
// buffer when it held at most SPLIT_CAP keys, else from the input with a
// filter), writes to `sel` the keys of B_{p-1} below the digit chosen
// there, histograms digit p of B_p, keeps B_p in the other candidate
// buffer when it fits, and counts B_p by tile and tracks its least and
// largest key. The last block picks digit p; the row is resolved when the
// chosen bucket is exactly what is needed (WHOLE), when B_p held a single
// value (SINGLE; its full key when idx is given), or after the last
// digit. The write launch then reads B_{np-1} once more, writes the keys
// below the boundary and settles the ties (see split_write_kernel), and
// the row's last block sorts the kp keys in shared memory and writes them.

#define SPLIT_THREADS 256
#define SPLIT_BINS 2048            // bins of an 11-bit digit
#define SPLIT_CAP 2048             // keys of a candidate buffer
#define SPLIT_UNROLL 4             // row loads a thread keeps in flight
#define SPLIT_VALUE_PASSES 3       // digits of the value word: 11, 11, 10 bits
#define SPLIT_KEY_PASSES 6         // and of the index word: 11, 11, 10 bits

enum : unsigned {
    SF_RESOLVED = 1u,   // no more digits: the write launch finishes the row
    SF_WHOLE = 2u,      // the boundary bucket B_np is exactly what is needed
    SF_SINGLE = 4u,     // B_np holds one tracked value (idx given: one key, bkey)
    SF_TILES = 8u,      // tile_cnt holds the count of B_np of each tile
    SF_CAND0 = 16u,     // SF_CAND0 << p: B_p is in candidate buffer p & 1
};

struct SplitRow {
    u64 prefix, hi;       // the np chosen digits: B_np = keys with (key & hi) == prefix
    u64 pprefix, phi;     // np - 1 digits: B_{np-1}
    u64 mx, nmn;          // this pass: largest and ~least tracked bits of B_p
    u64 bkey;             // least key of B_np (SINGLE)
    unsigned need;        // keys still needed inside B_np
    unsigned count;       // keys in B_np
    unsigned np;          // digits chosen
    unsigned flags;
    unsigned sel_n;       // keys in sel
    unsigned tie_n;       // ties kept by the write launch
    unsigned arrive;      // blocks of the row done with this launch
    unsigned cand_n[2];   // keys in each candidate buffer
    unsigned pad[9];
};
static_assert(sizeof(SplitRow) == 128, "SplitRow is 128 bytes");

// Digit p (0-5) of a key: bits [split_shift(p), split_shift(p) + split_bits(p)).
__device__ __forceinline__ int split_shift(int p) {
    return p == 0 ? 53 : p == 1 ? 42 : p == 2 ? 32 : p == 3 ? 21 : p == 4 ? 10 : 0;
}
__device__ __forceinline__ int split_bits(int p) { return (p == 2 || p == 5) ? 10 : 11; }

// Calls f(valid, key) on this block's share of a row's source, every
// thread of the block the same number of times (lanes past the end with
// valid false): the keys of candidate buffer `cand` (cand_n of them,
// dealt to the row's blocks in turn), or tile t of row r of the input.
// IDX: indices are given (else the index is the column). VEC: the row is
// contiguous and 16-byte aligned, read four columns a load.
template <bool IDX, bool VEC, typename F>
__device__ __forceinline__ void split_for_each(
    bool from_cand, const u64* cand, unsigned cand_n,
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long r, long long in_row, long long in_col, int width, int tile, int t, int tiles, F f)
{
    const int T = blockDim.x;
    const int tid = threadIdx.x;
    if (from_cand) {
        for (long long i0 = (long long)t * T; i0 < cand_n; i0 += (long long)tiles * T) {
            const long long i = i0 + tid;
            const bool v = i < cand_n;
            f(v, v ? cand[i] : 0ull);
        }
        return;
    }
    const int c_end = min(width, (t + 1) * tile);
    const float* vrow = vals + r * in_row;
    const int* irow = IDX ? idx + r * in_row : nullptr;
    if constexpr (VEC) {
        for (int c0 = t * tile; c0 < c_end; c0 += 4 * SPLIT_UNROLL * T) {
            float v[SPLIT_UNROLL][4];
            int ix[SPLIT_UNROLL][4];
#pragma unroll
            for (int u = 0; u < SPLIT_UNROLL; ++u) {
                const int c = c0 + 4 * (u * T + tid);
                if (c + 3 < c_end) {
                    const float4 w = __ldg(reinterpret_cast<const float4*>(vrow + c));
                    v[u][0] = w.x; v[u][1] = w.y; v[u][2] = w.z; v[u][3] = w.w;
                    if constexpr (IDX) {
                        const int4 j = __ldg(reinterpret_cast<const int4*>(irow + c));
                        ix[u][0] = j.x; ix[u][1] = j.y; ix[u][2] = j.z; ix[u][3] = j.w;
                    }
                } else {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        v[u][e] = c + e < c_end ? vrow[c + e] : 0.0f;
                        if constexpr (IDX) ix[u][e] = c + e < c_end ? irow[c + e] : 0;
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < SPLIT_UNROLL; ++u) {
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int c = c0 + 4 * (u * T + tid) + e;
                    f(c < c_end, pack_key(v[u][e], IDX ? ix[u][e] : c));
                }
            }
        }
    } else {
        for (int c0 = t * tile; c0 < c_end; c0 += SPLIT_UNROLL * T) {
            u64 k[SPLIT_UNROLL];
#pragma unroll
            for (int u = 0; u < SPLIT_UNROLL; ++u) {
                const int c = c0 + u * T + tid;
                k[u] = c < c_end ? pack_key(vrow[(long long)c * in_col],
                                            IDX ? irow[(long long)c * in_col] : c) : 0ull;
            }
#pragma unroll
            for (int u = 0; u < SPLIT_UNROLL; ++u) f(c0 + u * T + tid < c_end, k[u]);
        }
    }
}

// (key & mask) == pre and (key & mask) < pre. Without indices (IDX false)
// every mask of the split route lies in the value word, so 32 bits do.
template <bool IDX>
__device__ __forceinline__ bool kmatch(u64 key, u64 mask, u64 pre) {
    if constexpr (IDX) return (key & mask) == pre;
    return ((unsigned)(key >> 32) & (unsigned)(mask >> 32)) == (unsigned)(pre >> 32);
}
template <bool IDX>
__device__ __forceinline__ bool kless(u64 key, u64 mask, u64 pre) {
    if constexpr (IDX) return (key & mask) < pre;
    return ((unsigned)(key >> 32) & (unsigned)(mask >> 32)) < (unsigned)(pre >> 32);
}

// hist_add without __match_any_sync: a warp whose lanes all hold one bin
// (BM25's zeros, a bucket of one value) counts it in `run` (the warp's
// bin run.x, its count run.y, the same in every lane) and adds the run
// when the bin changes; otherwise each lane adds its own. A bin of nbins
// or more counts nothing. hist_flush adds what `run` holds.
__device__ __forceinline__ void hist_flush(unsigned* hist, uint2 run, unsigned nbins) {
    if ((threadIdx.x & 31) == 0 && run.x < nbins && run.y != 0u) atomicAdd(&hist[run.x], run.y);
}
__device__ __forceinline__ void hist_add_warp(unsigned* hist, unsigned bin, unsigned nbins,
                                              uint2& run) {
    const unsigned b0 = __shfl_sync(FULL, bin, 0);
    if (__all_sync(FULL, bin == b0)) {
        if (b0 != run.x) {
            hist_flush(hist, run, nbins);
            run = make_uint2(b0, 0u);
        }
        run.y += 32u;
        return;
    }
    if (bin < nbins) atomicAdd(&hist[bin], 1u);
}

// Sum of v over the block, in every thread; s holds SPLIT_THREADS / 32
// words. Ends with a barrier.
__device__ __forceinline__ unsigned block_sum(unsigned v, unsigned* s) {
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
    __syncthreads();
    unsigned total = 0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += s[w];
    __syncthreads();
    return total;
}

__device__ __forceinline__ u64 warp_max64(u64 v) {
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
        const u64 o = __shfl_xor_sync(FULL, v, off);
        v = o > v ? o : v;
    }
    return v;
}

// Whether this block is the last of its row to finish the launch; the
// writes of the row's other blocks are then visible to it.
__device__ __forceinline__ bool split_last_block(SplitRow* S, int tiles) {
    __shared__ int s_last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) s_last = atomicAdd(&S->arrive, 1u) == (unsigned)tiles - 1u;
    __syncthreads();
    if (s_last) __threadfence();
    return s_last != 0;
}

template <bool IDX, bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS) split_pass_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, int width, int kp, int tile, int tiles,
    int pass, int n_passes, SplitRow* __restrict__ st,
    unsigned* __restrict__ hist, u64* __restrict__ sel, u64* __restrict__ cand,
    unsigned* __restrict__ tile_cnt)
{
    __shared__ unsigned sh[SPLIT_BINS];
    __shared__ unsigned s_red[SPLIT_THREADS / 32];
    __shared__ unsigned s_digit, s_need, s_count;
    __shared__ u64 s_mx, s_nmn;
    const long long r = blockIdx.x / tiles;
    const int t = (int)(blockIdx.x % tiles);
    const int tid = threadIdx.x;
    SplitRow* S = st + r;
    const unsigned flags = S->flags;
    if (flags & SF_RESOLVED) return;
    const int shift = split_shift(pass);
    const int nb = 1 << split_bits(pass);
    for (int b = tid; b < nb; b += blockDim.x) sh[b] = 0u;
    if (tid == 0) {
        s_mx = 0ull;
        s_nmn = 0ull;
    }
    __syncthreads();
    const u64 prefix = S->prefix, hi = S->hi, pprefix = S->pprefix, phi = S->phi;
    const bool from_cand = pass > 0 && (flags & (SF_CAND0 << (pass - 1))) != 0u;
    const bool store = pass > 0 && S->count <= SPLIT_CAP;
    u64* my_sel = sel + r * kp;
    const u64* src = cand + (r * 2 + ((pass + 1) & 1)) * SPLIT_CAP;   // B_{pass-1}
    u64* dst = cand + (r * 2 + (pass & 1)) * SPLIT_CAP;               // B_pass
    const unsigned src_n = from_cand ? S->cand_n[(pass + 1) & 1] : 0u;
    // the tracked bits of B_pass: the whole key with indices, else the
    // value word (kept as 32 bits, and as key bits below)
    unsigned cnt = 0u, mx32 = 0u, mn32 = 0xFFFFFFFFu;
    u64 mx = 0ull, nmn = 0ull;
    uint2 run = make_uint2((unsigned)nb, 0u);
    split_for_each<IDX, VEC>(from_cand, src, src_n, vals, idx, r, in_row, in_col, width, tile,
                             t, tiles, [&](bool v, u64 key) {
        const bool in_prev = v && kmatch<IDX>(key, phi, pprefix);
        warp_append(&S->sel_n, my_sel, in_prev && kless<IDX>(key, hi, prefix), key);
        const bool in_set = in_prev && kmatch<IDX>(key, hi, prefix);
        hist_add_warp(sh, in_set ? (unsigned)(key >> shift) & (unsigned)(nb - 1) : (unsigned)nb,
                      (unsigned)nb, run);
        if (store) warp_append(&S->cand_n[pass & 1], dst, in_set, key);
        if (in_set) {
            ++cnt;
            if constexpr (IDX) {
                mx = key > mx ? key : mx;
                nmn = ~key > nmn ? ~key : nmn;
            } else {
                mx32 = max(mx32, (unsigned)(key >> 32));
                mn32 = min(mn32, (unsigned)(key >> 32));
            }
        }
    });
    hist_flush(sh, run, (unsigned)nb);
    if constexpr (!IDX) {
        mx = (u64)mx32 << 32;
        nmn = ~((u64)mn32 << 32);
    }
    mx = warp_max64(mx);
    nmn = warp_max64(nmn);
    if ((tid & 31) == 0) {
        atomicMax(&s_mx, mx);
        atomicMax(&s_nmn, nmn);
    }
    cnt = block_sum(cnt, s_red);
    unsigned* gh = hist + r * SPLIT_BINS;
    for (int b = tid; b < nb; b += blockDim.x) {
        if (sh[b] != 0u) atomicAdd(gh + b, sh[b]);
    }
    if (tid == 0) {
        if (!from_cand) tile_cnt[r * tiles + t] = cnt;
        if (cnt != 0u) {
            atomicMax(&S->mx, s_mx);
            atomicMax(&S->nmn, s_nmn);
        }
    }
    if (!split_last_block(S, tiles)) return;

    // The row's last block picks the bin that holds the need-th key of B_pass.
    const unsigned need = pass == 0 ? (unsigned)kp : S->need;
    const int per = nb / SPLIT_THREADS;   // 8 or 4 bins a thread
    unsigned loc[SPLIT_BINS / SPLIT_THREADS];
    unsigned sum = 0u;
#pragma unroll
    for (int i = 0; i < SPLIT_BINS / SPLIT_THREADS; ++i) {
        loc[i] = 0u;
        if (i < per) {
            loc[i] = __ldcg(gh + tid * per + i);
            gh[tid * per + i] = 0u;
        }
        sum += loc[i];
    }
    const int lane = tid & 31;
    unsigned incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const unsigned o = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += o;
    }
    if (lane == 31) s_red[tid >> 5] = incl;
    __syncthreads();
    for (int w = 0; w < (tid >> 5); ++w) incl += s_red[w];
    const unsigned excl = incl - sum;
    if (excl < need && need <= incl) {
        unsigned run = excl;
#pragma unroll
        for (int i = 0; i < SPLIT_BINS / SPLIT_THREADS; ++i) {
            if (i < per && run < need && need <= run + loc[i]) {
                s_digit = (unsigned)(tid * per + i);
                s_need = need - run;
                s_count = loc[i];
            }
            run += loc[i];
        }
    }
    __syncthreads();
    if (tid == 0) {
        const unsigned count = s_count, left = s_need;
        const u64 mxv = __ldcg(&S->mx), nmnv = __ldcg(&S->nmn);
        unsigned f = flags | (store ? (SF_CAND0 << pass) : 0u);
        if (count == left) {
            f |= SF_WHOLE | SF_RESOLVED;
        } else if (mxv == ~nmnv) {
            // B_pass is one tracked value; its tile counts, taken from the
            // input, are the ties'
            f |= SF_SINGLE | SF_RESOLVED | (from_cand ? 0u : SF_TILES);
        } else if (pass + 1 == n_passes) {
            f |= SF_RESOLVED;
        }
        S->pprefix = prefix;
        S->phi = hi;
        S->prefix = prefix | ((u64)s_digit << shift);
        S->hi = hi | ((u64)(nb - 1) << shift);
        S->np = (unsigned)pass + 1u;
        S->need = left;
        S->count = count;
        S->bkey = ~nmnv;
        S->mx = 0ull;
        S->nmn = 0ull;
        S->arrive = 0u;
        S->cand_n[(pass + 1) & 1] = 0u;
        S->flags = f;
    }
}

// idx null, ties read from the input: the count of B_np in each tile,
// unless the last pass left it (SF_TILES).
template <bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS) split_count_kernel(
    const float* __restrict__ vals, long long in_row, long long in_col, int width,
    int tile, int tiles, SplitRow* __restrict__ st, unsigned* __restrict__ tile_cnt)
{
    __shared__ unsigned s_red[SPLIT_THREADS / 32];
    const long long r = blockIdx.x / tiles;
    const int t = (int)(blockIdx.x % tiles);
    SplitRow* S = st + r;
    const unsigned flags = S->flags;
    const unsigned np = S->np;
    if ((flags & (SF_WHOLE | SF_TILES)) || (flags & (SF_CAND0 << (np - 1u)))) return;
    const u64 prefix = S->prefix, hi = S->hi;
    unsigned cnt = 0u;
    split_for_each<false, VEC>(false, nullptr, 0u, vals, nullptr, r, in_row, in_col, width,
                               tile, t, tiles, [&](bool v, u64 key) {
        if (v && kmatch<false>(key, hi, prefix)) ++cnt;
    });
    cnt = block_sum(cnt, s_red);
    if (threadIdx.x == 0) tile_cnt[r * tiles + t] = cnt;
}

// The last launch: the keys of B_{np-1} below the boundary to `sel`, and
// the ties at the boundary (B_np, all of it when WHOLE) by one of three
// means: kept in the free candidate buffer when B_{np-1} came from one
// (the sort below orders them); idx null: the first `need` in column
// order, each tile taking its share from the tile counts before it; idx
// given: copies of the boundary key (every tie is that one key). The
// row's last block sorts sel (and the kept ties) and writes kp keys.
template <bool IDX, bool VEC>
__global__ void __launch_bounds__(SPLIT_THREADS) split_write_kernel(
    const float* __restrict__ vals, const int* __restrict__ idx,
    long long in_row, long long in_col, int width, int kp, int tile, int tiles,
    SplitRow* __restrict__ st, u64* __restrict__ sel, u64* __restrict__ cand,
    const unsigned* __restrict__ tile_cnt,
    float* __restrict__ vout, int* __restrict__ iout, long long out_row, long long out_col)
{
    extern __shared__ u64 sk[];
    __shared__ unsigned s_red[SPLIT_THREADS / 32];
    const long long r = blockIdx.x / tiles;
    const int t = (int)(blockIdx.x % tiles);
    const int tid = threadIdx.x;
    const int T = blockDim.x;
    SplitRow* S = st + r;
    const unsigned flags = S->flags;
    const unsigned np = S->np;
    const unsigned need = S->need;
    const u64 prefix = S->prefix, hi = S->hi, pprefix = S->pprefix, phi = S->phi;
    const bool whole = (flags & SF_WHOLE) != 0u;
    const bool from_cand = (flags & (SF_CAND0 << (np - 1u))) != 0u;
    const bool keep_ties = !whole && from_cand;
    const bool ordered = !whole && !from_cand && !IDX;
    u64* my_sel = sel + r * kp;
    const u64* src = cand + (r * 2 + ((np + 1u) & 1u)) * SPLIT_CAP;   // B_{np-1}
    u64* ties = cand + (r * 2 + (np & 1u)) * SPLIT_CAP;
    const unsigned src_n = from_cand ? S->cand_n[(np + 1u) & 1u] : 0u;

    unsigned take = 0u, tcnt = 0u;
    if (ordered) {
        unsigned before = 0u;
        for (int u = tid; u < t; u += T) before += tile_cnt[r * tiles + u];
        before = block_sum(before, s_red);
        tcnt = tile_cnt[r * tiles + t];
        take = need > before ? min(need - before, tcnt) : 0u;
    }
    const bool all_ties = ordered && take == tcnt;
    split_for_each<IDX, VEC>(from_cand, src, src_n, vals, idx, r, in_row, in_col, width, tile,
                             t, tiles, [&](bool v, u64 key) {
        const bool in_prev = v && kmatch<IDX>(key, phi, pprefix);
        const bool tie = in_prev && kmatch<IDX>(key, hi, prefix);
        warp_append(&S->sel_n, my_sel,
                    (in_prev && kless<IDX>(key, hi, prefix)) || (tie && (whole || all_ties)), key);
        if (keep_ties) warp_append(&S->tie_n, ties, tie, key);
    });
    if (ordered && take > 0u && take < tcnt) {
        // the boundary tile: its first `take` ties in column order
        const int c_end = min(width, (t + 1) * tile);
        unsigned seen = 0u;
        for (int c0 = t * tile; c0 < c_end && seen < take; c0 += T) {
            const int c = c0 + tid;
            const u64 key = c < c_end ? load_key(vals, nullptr, r, c, in_row, in_col) : 0ull;
            const bool tie = c < c_end && kmatch<false>(key, hi, prefix);
            const unsigned ballot = __ballot_sync(FULL, tie);
            if ((tid & 31) == 0) s_red[tid >> 5] = __popc(ballot);
            __syncthreads();
            unsigned rank = seen + __popc(ballot & ((1u << (tid & 31)) - 1u));
            unsigned total = 0u;
            for (int w = 0; w < (T >> 5); ++w) {
                if (w < (tid >> 5)) rank += s_red[w];
                total += s_red[w];
            }
            __syncthreads();
            warp_append(&S->sel_n, my_sel, tie && rank < take, key);
            seen += total;
        }
    }
    if (!split_last_block(S, tiles)) return;

    const unsigned n_sel = __ldcg(&S->sel_n);
    const unsigned n_tie = keep_ties ? __ldcg(&S->tie_n) : 0u;
    const bool copies = !whole && !from_cand && IDX;
    const u64 fill = (flags & SF_SINGLE) ? S->bkey : prefix;
    int n = kp;
    while ((unsigned)n < n_sel + n_tie) n <<= 1;
    for (int i = tid; i < n; i += T) {
        u64 key = PAD_KEY;
        if ((unsigned)i < n_sel) key = __ldcg(my_sel + i);
        else if (copies && i < kp) key = fill;
        else if ((unsigned)i < n_sel + n_tie) key = __ldcg(ties + (i - n_sel));
        sk[i] = key;
    }
    __syncthreads();
    bitonic_sort_segments(sk, n, n / 2);
    for (int i = tid; i < kp; i += T) {
        const u64 key = sk[i];
        const long long off = r * out_row + (long long)i * out_col;
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

// The one-block select: kp (a power of two, 8 <= kp <= KP_MAX) smallest
// keys of each row, a block a row (or several short rows). Rows that take
// the radix mode (width > 2 kp) must fit shared memory (width <=
// SMEM_KEYS); wider rows take comet_topk_split.
extern "C" int comet_topk_select(
    const float* vals, const int* idx, long long in_row, long long in_col,
    int rows, int width, int kp,
    float* vout, int* iout, long long out_row, long long out_col,
    void* stream)
{
    if (kp < 8 || kp > KP_MAX || (kp & (kp - 1)) != 0 || rows < 1 || width < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const bool direct = width <= 2 * kp;
    if (!direct && width > SMEM_KEYS) return (int)cudaErrorInvalidValue;
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
        smem = (size_t)(kp + width) * sizeof(u64);
    }
    cudaError_t err = cudaFuncSetAttribute(
        topk_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)((SMEM_KEYS + KP_MAX) * sizeof(u64)));
    if (err != cudaSuccess) return (int)err;
    topk_select_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
        vals, idx, in_row, in_col, rows, width, kp, n_sort, rows_per_block,
        vout, iout, out_row, out_col);
    return (int)cudaGetLastError();
}

// The split route's launches: the digit passes, the tie count (no
// indices) and the write.
template <bool IDX, bool VEC>
static cudaError_t split_launch(
    const float* vals, const int* idx, long long in_row, long long in_col, int width, int kp,
    int tile, long long tiles, long long blocks, size_t smem, SplitRow* st, unsigned* hist,
    u64* sel, u64* cand, unsigned* tile_cnt, float* vout, int* iout, long long out_row,
    long long out_col, cudaStream_t s)
{
    const int n_passes = IDX ? SPLIT_KEY_PASSES : SPLIT_VALUE_PASSES;
    const int nt = (int)tiles;
    for (int p = 0; p < n_passes; ++p) {
        split_pass_kernel<IDX, VEC><<<(unsigned)blocks, SPLIT_THREADS, 0, s>>>(
            vals, idx, in_row, in_col, width, kp, tile, nt, p, n_passes, st, hist, sel, cand,
            tile_cnt);
    }
    if (!IDX) {
        split_count_kernel<VEC><<<(unsigned)blocks, SPLIT_THREADS, 0, s>>>(
            vals, in_row, in_col, width, tile, nt, st, tile_cnt);
    }
    if (smem > 48 * 1024) {   // kp above 1024 only
        const cudaError_t err = cudaFuncSetAttribute(
            split_write_kernel<IDX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    split_write_kernel<IDX, VEC><<<(unsigned)blocks, SPLIT_THREADS, smem, s>>>(
        vals, idx, in_row, in_col, width, kp, tile, nt, st, sel, cand, tile_cnt,
        vout, iout, out_row, out_col);
    return cudaSuccess;
}

// Bytes of the split route's workspace: a row's state and histogram
// (zeroed by each select), its kp selected keys, two candidate buffers of
// SPLIT_CAP keys and a count a tile.
static long long split_row_bytes(int width, int kp, int tile) {
    const long long tiles = ((long long)width + tile - 1) / tile;
    return (long long)sizeof(SplitRow) + SPLIT_BINS * 4LL + kp * 8LL + 2LL * SPLIT_CAP * 8
        + ((tiles * 4 + 7) / 8) * 8;
}

extern "C" long long comet_topk_split_bytes(int rows, int width, int kp, int tile) {
    if (rows < 1 || width < 1 || kp < 1 || tile < 1) return -1;
    return (long long)rows * split_row_bytes(width, kp, tile);
}

// The split select: kp (a power of two, 8 <= kp <= KP_MAX) smallest keys
// of each row of width > 2 kp, each row split into tiles of `tile`
// columns, a block a tile. `ws` holds comet_topk_split_bytes(rows, width,
// kp, tile) bytes. Launches: SPLIT_VALUE_PASSES digit passes, the count
// and the write when idx is null; SPLIT_KEY_PASSES and the write otherwise.
extern "C" int comet_topk_split(
    const float* vals, const int* idx, long long in_row, long long in_col,
    int rows, int width, int kp, int tile, void* ws,
    float* vout, int* iout, long long out_row, long long out_col,
    void* stream)
{
    if (kp < 8 || kp > KP_MAX || (kp & (kp - 1)) != 0 || rows < 1 || width <= 2 * kp ||
        tile < 1 || ws == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    const long long tiles = ((long long)width + tile - 1) / tile;
    const long long blocks = (long long)rows * tiles;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    char* base = (char*)ws;
    SplitRow* st = (SplitRow*)base;
    unsigned* hist = (unsigned*)(base + (long long)rows * sizeof(SplitRow));
    u64* sel = (u64*)((char*)hist + (long long)rows * SPLIT_BINS * 4);
    u64* cand = sel + (long long)rows * kp;
    unsigned* tile_cnt = (unsigned*)(cand + (long long)rows * 2 * SPLIT_CAP);
    cudaError_t err = cudaMemsetAsync(
        ws, 0, (size_t)rows * (sizeof(SplitRow) + SPLIT_BINS * 4), s);
    if (err != cudaSuccess) return (int)err;
    const bool vec = in_col == 1 && in_row % 4 == 0 && (uintptr_t)vals % 16 == 0 &&
                     (idx == nullptr || (uintptr_t)idx % 16 == 0);
    const size_t smem = (size_t)next_pow2(kp + SPLIT_CAP) * sizeof(u64);
    if (idx != nullptr) {
        err = vec ? split_launch<true, true>(vals, idx, in_row, in_col, width, kp, tile, tiles,
                                             blocks, smem, st, hist, sel, cand, tile_cnt, vout,
                                             iout, out_row, out_col, s)
                  : split_launch<true, false>(vals, idx, in_row, in_col, width, kp, tile, tiles,
                                              blocks, smem, st, hist, sel, cand, tile_cnt, vout,
                                              iout, out_row, out_col, s);
    } else {
        err = vec ? split_launch<false, true>(vals, idx, in_row, in_col, width, kp, tile, tiles,
                                              blocks, smem, st, hist, sel, cand, tile_cnt, vout,
                                              iout, out_row, out_col, s)
                  : split_launch<false, false>(vals, idx, in_row, in_col, width, kp, tile, tiles,
                                               blocks, smem, st, hist, sel, cand, tile_cnt, vout,
                                               iout, out_row, out_col, s);
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
