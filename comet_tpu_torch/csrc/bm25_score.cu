// BM25 batch scoring: the dense per-query score rows whose top-k K1 takes.
//
// Replaces comet_tpu/indexes/bm25.py:_bm25_device_kernel, the reference's
// XLA scorer (no Pallas kernel): [Q, MC, 512] posting-chunk gathers, the
// BM25 contribution, a scatter-add into [Q, n_pad] float32, the allowed
// mask and lax.top_k. Here the top-k is K1 (csrc/topk.cu) on the negated
// rows this kernel writes, which gives lax.top_k's order: score desc, then
// slot asc (slots are documents in ascending id order).
//
// For query q and every posting (slot, tf) of each of its terms t, in the
// query's token order, repeats included (t's float32 idf given):
//   c = idf * (tf * (K1 + 1)) / (tf + K1 * ((1 - B) + B * (dl / avgdl)))
//   row[slot] += c
// in exactly that operation order, each step rounded alone (__fmul_rn,
// __fadd_rn, __fdiv_rn, so nvcc contracts nothing into an FMA): the XLA
// expression of the reference (bm25.py:619-621), bit-equal to the plain
// version in ops/bm25.py. Every sum starts at 0.0f and takes its terms in
// query order, the reference's order (its C loop and XLA scatter add a
// document's contributions term by term); CUDA's atomic scatter-add
// (index_add_, scatter_add_) adds in an order that changes from run to
// run, so scores would differ in their last bits and tied ids swap. Then
// row[i] = allowed[i] ? -row[i] : 0: a masked document scores 0, which
// the wrapper reads as missing; an allowed one that no posting touched
// comes out as -0.0f, as in the plain version.
//
// What bounds it on an H100: bytes, the rows written once (4 bytes a
// (query, document): 1 GiB for 256 queries over 2^20 documents, 0.32 ms at
// 3.35 TB/s). The inputs it reads are each tile's lengths and mask once a
// group (5 bytes a document a group), each distinct (position, term)
// sub-run of a group once (8 bytes a posting), and the binary searches'
// probes; the arithmetic is 9 operations a posting of a distinct entry
// and one add a (query, posting). T and QG come from the wrapper
// (ops/bm25.tile_shape): QG = 8 queries (fewer when the chunk has fewer),
// T = 1024 documents, halved down to 128 while the grid has fewer than two
// blocks for each SM, so that one query over a segment of 70,000
// documents still spreads over the card. At QG = 8 and T = 1024 a block
// takes 54 KB of shared memory and 32 registers a thread, so four blocks
// (64 warps) share an SM; larger blocks, or more registers, leave fewer
// and are slower (the sweep of scripts/ab_bm25_scorer.py, in PERF.md).
//
// The design. A block owns one tile of T documents [s0, s0 + T) and one
// group of QG queries, and keeps their sums, [QG, T] float32, in shared
// memory; the grid is every (tile, group), the group varying fastest, so
// that the blocks in flight share a tile's postings and lengths in L2.
// A block:
//   1. zeroes its sums and stages, per document of the tile, the allowed
//      byte and K1 * ((1 - B) + B * (dl / avgdl)), the contribution's one
//      per-document factor (the same operations, rounded the same way);
//   2. walks its queries' term positions j = 0, 1, ... together, a window
//      of E_WIN (query, position) entries at a time. A term's postings list
//      its documents in ascending slot order (indexes/bm25.py builds them
//      from sorted keys), so the tile's share of a term is one contiguous
//      sub-run: the block finds its two ends by binary search, all
//      entries of the window at once (one thread an end), each over only
//      the window that distinct slots leave, [x - (n_pad - len), x] for
//      slot x (a step or two for a term covering nearly every document).
//      Entries of one position with the same term (the same run and idf)
//      are one entry: its sub-run is read and its contributions computed
//      once and added to each of those queries' sums, e.g. the whitespace
//      term of multi-word queries;
//   3. for each position in turn, the block's threads stride over the
//      concatenated sub-runs of the position's distinct terms. A query
//      has one term a position and a term's postings distinct slots, so
//      no two threads touch one sum; a __syncthreads() between positions
//      keeps every sum in term order. A term that every row of the group
//      has there takes a plain loop over the rows (11 % off a 10-term
//      chunk against walking the row mask bit by bit);
//   4. writes its rows once, masked on the way out, coalesced (16-byte
//      streaming stores when n_pad is a multiple of 4: a chunk's rows
//      outgrow the L2 cache before K1 reads them).
// No row is zeroed, read back or masked in device memory.

#include <cuda_runtime.h>

#include "scan_tile.cuh"   // smem_attr

constexpr int BM25_THREADS = 512;
constexpr int BM25_E_WIN = 512;     // (query, position) entries a window
constexpr int BM25_QG_MAX = 32;     // queries a block: one bit each in an entry's row mask
constexpr int BM25_T_MAX = 4096;    // documents a tile
constexpr float BM25_K1 = 1.2f;
constexpr float BM25_K1P1 = 2.2f;   // K1 + 1, rounded once as the reference's float32 constant
constexpr float BM25_B = 0.75f;
constexpr float BM25_1MB = 0.25f;   // 1 - B

// the first index i in [lo, hi) with run[i] >= x, hi if none
__device__ __forceinline__ int first_at_or_past(const int* __restrict__ run, int lo, int hi, int x)
{
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run[mid] < x) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

// Shared memory: the window's entries (e = j * qg + r for position j of
// the window and row r of the group), then the sums, the per-document
// factors and the allowed bytes.
struct Bm25Smem {
    long long key[BM25_E_WIN];    // the entry's term: its run's first posting
    int len[BM25_E_WIN];          // the run's length (0: the query has no term there)
    float idf[BM25_E_WIN];
    unsigned rows[BM25_E_WIN];    // a leader's rows, bit r for each row with its term; else 0
    int lo[BM25_E_WIN];           // the tile's sub-run [lo, hi) within the run
    int hi[BM25_E_WIN];
    int pre[BM25_E_WIN];          // postings of the position's earlier leaders
    int q_first[BM25_QG_MAX];     // a query's first term
    int q_cnt[BM25_QG_MAX];       // and its number of terms
};

static size_t bm25_smem_bytes(int T, int QG)
{
    return sizeof(Bm25Smem) + (size_t)QG * T * sizeof(float) + (size_t)T * sizeof(float) + T;
}

__global__ void __launch_bounds__(BM25_THREADS) bm25_score_kernel(
    const int* __restrict__ post_slot, const float* __restrict__ post_tf,
    const long long* __restrict__ t_start, const int* __restrict__ t_len,
    const float* __restrict__ t_idf, const int* __restrict__ q_off, int rows,
    const float* __restrict__ doc_len, const unsigned char* __restrict__ allowed,
    int n_pad, float avgdl, int T, int QG, float* __restrict__ out)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Bm25Smem& sm = *reinterpret_cast<Bm25Smem*>(smem_raw);
    float* acc = reinterpret_cast<float*>(smem_raw + sizeof(Bm25Smem));   // [QG][T]
    float* knorm = acc + (size_t)QG * T;                                    // [T]
    unsigned char* ok = reinterpret_cast<unsigned char*>(knorm + T);        // [T]

    const int tid = threadIdx.x;
    const int n_groups = (rows + QG - 1) / QG;
    const int q0 = (int)(blockIdx.x % n_groups) * QG;
    const int s0 = (int)(blockIdx.x / n_groups) * T;
    const int qg = min(QG, rows - q0);
    const int tw = min(T, n_pad - s0);   // documents of this tile
    const unsigned every_row = qg == 32 ? ~0u : (1u << qg) - 1u;

    // 1. zeroed sums, the tile's per-document factor and allowed bytes
    if (tid < qg) {
        sm.q_first[tid] = q_off[q0 + tid];
        sm.q_cnt[tid] = q_off[q0 + tid + 1] - q_off[q0 + tid];
    }
    for (int i = tid; i < qg * T; i += BM25_THREADS) acc[i] = 0.0f;
    for (int i = tid; i < tw; i += BM25_THREADS) {
        const float norm = __fadd_rn(BM25_1MB, __fmul_rn(BM25_B, __fdiv_rn(doc_len[s0 + i], avgdl)));
        knorm[i] = __fmul_rn(BM25_K1, norm);
        ok[i] = allowed[s0 + i];
    }
    __syncthreads();
    int n_pos = 0;
    for (int r = 0; r < qg; ++r) n_pos = max(n_pos, sm.q_cnt[r]);

    // 2-3. the term positions, a window of entries at a time
    const int pw = BM25_E_WIN / qg;
    for (int p0 = 0; p0 < n_pos; p0 += pw) {
        const int np = min(pw, n_pos - p0);
        const int ne = np * qg;
        for (int e = tid; e < ne; e += BM25_THREADS) {
            const int j = p0 + e / qg, r = e % qg;
            if (j < sm.q_cnt[r]) {
                const int t = sm.q_first[r] + j;
                sm.key[e] = t_start[t];
                sm.len[e] = t_len[t];
                sm.idf[e] = t_idf[t];
            } else {
                sm.key[e] = -1;
                sm.len[e] = 0;
                sm.idf[e] = 0.0f;
            }
        }
        __syncthreads();
        // the leaders (an entry whose term no earlier row of its position
        // has) take the rows that have it, and their sub-runs: one thread
        // an end of a leader's sub-run, all ends of the window at once
        for (int w = tid; w < 2 * ne; w += BM25_THREADS) {
            const int e = w >> 1, side = w & 1;
            const int r = e % qg, base = e - r;
            const long long key = sm.key[e];
            const int len = sm.len[e];
            const unsigned idf_bits = __float_as_uint(sm.idf[e]);
            bool leader = len > 0;
            unsigned mine = 0;
            for (int r2 = 0; r2 < qg; ++r2) {
                const int e2 = base + r2;
                if (sm.len[e2] == len && sm.key[e2] == key
                    && __float_as_uint(sm.idf[e2]) == idf_bits) {
                    if (r2 < r) leader = false;
                    else mine |= 1u << r2;
                }
            }
            int end = 0;
            if (leader) {
                // slots are distinct and below n_pad: the first posting at
                // or past slot x lies in [x - (n_pad - len), x]
                const int x = side ? s0 + tw : s0;
                const int top = min(len, x);
                end = first_at_or_past(post_slot + key, min(top, max(0, x - (n_pad - len))), top,
                                       x);
            }
            if (side) {
                sm.hi[e] = end;
            } else {
                sm.lo[e] = end;
                sm.rows[e] = leader ? mine : 0u;
            }
        }
        __syncthreads();
        for (int j = tid; j < np; j += BM25_THREADS) {
            int s = 0;
            for (int r = 0; r < qg; ++r) {
                const int e = j * qg + r;
                sm.pre[e] = s;
                s += sm.hi[e] - sm.lo[e];
            }
        }
        __syncthreads();
        for (int j = 0; j < np; ++j) {
            const int first = j * qg, last = first + qg - 1;
            const int total = sm.pre[last] + sm.hi[last] - sm.lo[last];
            int e = first;
            for (int f = tid; f < total; f += BM25_THREADS) {
                while (sm.pre[e] + sm.hi[e] - sm.lo[e] <= f) ++e;   // the leader holding f
                const long long p = sm.key[e] + sm.lo[e] + (f - sm.pre[e]);
                const int x = post_slot[p] - s0;
                if ((unsigned)x >= (unsigned)tw) continue;   // only on a malformed run
                const float tf = post_tf[p];
                const float den = __fadd_rn(tf, knorm[x]);
                const float c = __fdiv_rn(__fmul_rn(sm.idf[e], __fmul_rn(tf, BM25_K1P1)), den);
                const unsigned m = sm.rows[e];
                if (m == every_row) {
                    float* a = acc + x;
#pragma unroll 4
                    for (int r = 0; r < qg; ++r, a += T) *a = __fadd_rn(*a, c);
                } else {
                    for (unsigned mm = m; mm; mm &= mm - 1) {
                        float* a = acc + (__ffs(mm) - 1) * T + x;
                        *a = __fadd_rn(*a, c);
                    }
                }
            }
            __syncthreads();
        }
    }

    // 4. the rows, masked on the way out
    if ((n_pad & 3) == 0) {
        const int t4 = tw >> 2;
        for (int r = 0; r < qg; ++r) {
            float4* dst = reinterpret_cast<float4*>(out + (long long)(q0 + r) * n_pad + s0);
            const float4* src = reinterpret_cast<const float4*>(acc + r * T);
            const uchar4* msk = reinterpret_cast<const uchar4*>(ok);
            for (int i = tid; i < t4; i += BM25_THREADS) {
                const float4 v = src[i];
                const uchar4 a = msk[i];
                __stcs(dst + i, make_float4(a.x ? -v.x : 0.0f, a.y ? -v.y : 0.0f,
                                            a.z ? -v.z : 0.0f, a.w ? -v.w : 0.0f));
            }
        }
    } else {
        for (int r = 0; r < qg; ++r) {
            float* dst = out + (long long)(q0 + r) * n_pad + s0;
            for (int i = tid; i < tw; i += BM25_THREADS) dst[i] = ok[i] ? -acc[r * T + i] : 0.0f;
        }
    }
}

// post_slot [P] i32 and post_tf [P] f32: every term's postings, one run a
// term (CSR), each run in ascending slot order with distinct slots below
// n_pad; t_start [M] i64, t_len [M] i32, t_idf [M] f32: the terms of the
// Q queries, query-major; q_off [Q + 1] i32: query q's terms are
// [q_off[q], q_off[q + 1]) (absolute into the term arrays); doc_len and
// allowed [n_pad]; T documents a tile (a multiple of 32) and QG queries a
// block (ops/bm25.tile_shape); out [Q, n_pad] f32.
extern "C" int comet_bm25_score(
    const int* post_slot, const float* post_tf, const long long* t_start, const int* t_len,
    const float* t_idf, const int* q_off, int Q, const float* doc_len,
    const unsigned char* allowed, long long n_pad, float avgdl, int T, int QG, float* out,
    void* stream)
{
    if (Q < 1 || n_pad < 1 || n_pad > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (T < 32 || T > BM25_T_MAX || T % 32 || QG < 1 || QG > BM25_QG_MAX)
        return (int)cudaErrorInvalidValue;
    const long long tiles = (n_pad + T - 1) / T, groups = (Q + QG - 1) / QG;
    if (tiles * groups > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = bm25_smem_bytes(T, QG);
    const int attr = smem_attr<bm25_score_kernel>(smem);
    if (attr) return attr;
    bm25_score_kernel<<<(unsigned)(tiles * groups), BM25_THREADS, smem, (cudaStream_t)stream>>>(
        post_slot, post_tf, t_start, t_len, t_idf, q_off, Q, doc_len, allowed, (int)n_pad, avgdl,
        T, QG, out);
    return (int)cudaGetLastError();
}
