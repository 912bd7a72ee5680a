// K3: block-sparse IVF scan over a cluster-major corpus.
//
// Replaces comet_tpu/ops/ivf_sparse.py:_sparse_kernel, the Pallas kernel
// that the reference's _sparse_scan launches, in both of its modes: float32
// operands, and bf16_domain (bf16 queries and corpus, float32
// accumulation, float32 query norms), which HNSW's seed scan uses. In the
// bf16 mode the product is the FMA chain of `dot_fma` (scan_tile.cuh), so a
// seed's distance is bit-equal to the distance the beam's in-loop scoring
// (gather_score.cu) finds for the same (query, slot).
//
// What bounds it on an H100: each chunk read once for all its probing
// queries, and their products: at 1M x 128, nlist 1000, nprobe 10 and 2048
// queries, 4,400 chunks of 128 KiB (0.58 GB, 0.17 ms at 3.35 TB/s) and
// ~94,000 (query, chunk) pairs, 6.2 GFLOP (0.09 ms at 67 TFLOP/s); the row
// is 2048 x 17,920 float32, 147 MB. It runs 0.69-0.71 ms there (PERF.md): a
// block's depth slices are latency-bound at ~21 members. Writing the
// reference's whole tile (below; 4 GiB at 2048 queries and S = 2048) took
// 2.62 ms. chip_smoke.py holds it to its plain version and to a bound
// from its inputs and the card's published peaks.
//
// Queries come sorted and cut into G groups of 128. Group g walks S steps;
// step s names a 256-row chunk of the cluster-major corpus and the cluster
// it belongs to (-1: a dead step). The walk takes the group's clusters by
// (best probe rank in the group, cluster id), each cluster's chunks in
// order; that is the scan order. For a query that probes a step's cluster,
// each of the chunk's 256 distances is the reference's epilogue
// (scan_tile.cuh)
//   L2:     max((qn + mask[n]) - 2 * ip, 0);  cosine: (1 - clip(ip)) + mask[n]
// then the threshold.
//
// The reference kernel writes them into a [G, 128, S * 256] tile, +inf for
// every query that does not probe a step's cluster, and selects each
// query's best 128-row groups by (minimum, scan position). This kernel
// (`compact_scan_kernel`) writes each probing query's distances into a row
// of its own, cand[q, place * 256 .. +255], and the chunk id of each place
// into chunk_tab[q, place]. A query's places follow the scan order: the
// place of chunk i of a probed cluster c is i plus the chunk counts (each
// at most MC) of the query's probes that the group's walk takes before c.
// So a row's position order is the tile's order restricted to the query's
// own chunks, and every chunk of the tile that the row lacks is +inf there:
// K1's select of the row, ties to the lower position, keeps the same
// candidates in the same tie order as the tile's, and so do the selection
// groups of 128 places that ops/ivf_sparse.py picks from it for a
// shortlist, for which the kernel also writes each place's two group
// minima, gmin[q, 2 * place + h] over rows h * 128 .. +127 (a half-warp's
// shuffles, then a float atomicMin across the warp pair). The caller fills
// chunk_tab with 0 and, for an exact search, cand with +inf, so a place
// never scanned (a short list, a chunk the S or UC budget dropped) drops
// out as (+inf, IDX_SENTINEL); for a shortlist it fills gmin with +inf
// instead, leaves cand unfilled and masks each gathered group whose
// minimum is +inf.
//
// Design: blocks of 256 threads, SP_PARTS a chunk of the corpus (4 bf16, 2
// float32), each taking its share of the groups. A block finds its chunk's
// cluster (a binary search of chunk_start) and, for each of its groups whose
// walk reaches the chunk (first[g, c] + i < S, from the wrapper's table of
// each cluster's first step), tests the group's 128 queries (P compares a
// query) and lists its probing ("member") queries with their places: a warp
// ballot and a prefix over the four warps compact them into an ascending
// list in shared memory. Every SP_LIST - 128 members, and after its last
// group, it computes the list, so a chunk is read at most once a part (with
// one block per (group, step), ~4.7 members a step, each step read the chunk
// again and the scan ran 1.45 ms). Members fall unevenly (HNSW's seed scan
// at 1M rows: up to 1,239 on a chunk, a median of 3): with one block a chunk
// the largest ran its 39 slabs in series, 1.21 ms against 0.86 with four
// parts; a part re-reads its chunk, and float32's exact search ran fastest
// with two (PERF.md). The members' product runs in slabs of 32 against the
// chunk's 256 rows (`sp_slab_product`): a 32 x 256 register tile, 4 queries
// x 8 rows a thread (rows tr*4..+3 of each 128-row half), on K2's loads
// (fused_tile.cuh): 16-deep depth slices staged k-major in shared memory,
// double buffered, the next slice's operands loaded into registers during
// this slice's FMAs. The query rows are gathered through the member list.
// Warp w owns queries 8 (w / 2) .. +7 of the slab, so the warps whose
// queries are all past the slab's member count skip the product; a depth
// step's operands are three 16-byte shared loads that a warp serves in five
// wavefronts for 32 FMAs. Unaligned rows (d not a multiple of 4 floats or 8
// bf16) take scalar loads. The corpus is read from a cluster-major copy
// (rows contiguous per chunk) rather than through a row -> slot indirection
// into the slot store: the copy costs one more corpus of device memory (NR x
// d x 4 bytes, NR the rows padded to whole chunks) and keeps every tile load
// contiguous.

#include <stdint.h>

#include "fused_tile.cuh"

#define SPARSE_QG 128      // queries per group
#define SPARSE_CHUNK 256   // corpus rows per chunk = two selection groups
#define SP_SLAB 32         // member queries per product pass
#define SP_THREADS 256     // = FT_THREADS: the chunk's loads are K2's
#define SP_PER (SP_SLAB * FT_BK / SP_THREADS)   // scalar query loads a thread
#define SP_LIST 256        // members listed before a product pass
#define SP_PARTS(T) (sizeof(T) == 2 ? 4 : 2)   // blocks a chunk: bf16 chunks are half the bytes

// Loads this thread's share of the depth slice [k0, k0 + FT_BK) of the
// slab's query rows: slab row r is row rows[r] of q (row stride d); rows
// past m and depths past d give 0.
template <typename T, bool VEC>
__device__ __forceinline__ void sp_gather_load(const T* __restrict__ q, const int* rows, int m,
                                               int d, int k0, float (&v)[8])
{
    if constexpr (VEC) {
        constexpr int VW = 16 / sizeof(T);
        const int unit = threadIdx.x;
        if (unit < SP_SLAB * FT_BK / VW) {
            const int r = unit % SP_SLAB;
            const int gk = k0 + (unit / SP_SLAB) * VW;
            uint4 w = make_uint4(0u, 0u, 0u, 0u);
            if (r < m && gk < d) {
                w = __ldg(reinterpret_cast<const uint4*>(q + (long long)rows[r] * d + gk));
            }
            ft_unpack<T>(w, v);
        }
    } else {
#pragma unroll
        for (int u = 0; u < SP_PER; ++u) {
            const int e = threadIdx.x + u * SP_THREADS;
            const int r = e % SP_SLAB;
            const int gk = k0 + e / SP_SLAB;
            v[u] = (r < m && gk < d) ? to_f32(q[(long long)rows[r] * d + gk]) : 0.0f;
        }
    }
}

// Stores what sp_gather_load loaded into the k-major slice A[FT_BK][SP_SLAB].
template <typename T, bool VEC>
__device__ __forceinline__ void sp_gather_store(float (*A)[SP_SLAB], const float (&v)[8])
{
    if constexpr (VEC) {
        constexpr int VW = 16 / sizeof(T);
        const int unit = threadIdx.x;
        if (unit < SP_SLAB * FT_BK / VW) {
            const int r = unit % SP_SLAB;
            const int k = (unit / SP_SLAB) * VW;
#pragma unroll
            for (int e = 0; e < VW; ++e) A[k + e][r] = v[e];
        }
    } else {
#pragma unroll
        for (int u = 0; u < SP_PER; ++u) {
            const int e = threadIdx.x + u * SP_THREADS;
            A[e / SP_SLAB][e % SP_SLAB] = v[u];
        }
    }
}

// The slab's product: rows[0 .. m) of q (row stride d) against the chunk's
// 256 rows xc, accumulated into acc (queries tq*4 .. +3 and rows tr*4 .. +3
// of each 128-row half, see the design note). Every thread stages its share
// of each depth slice; a thread that is not `busy` skips the FMAs. Ends with
// a barrier after the last slice, so the caller may restage As and Bs.
template <typename T, bool VEC>
__device__ __forceinline__ void sp_slab_product(
    const T* __restrict__ q, const int* rows, int m, const T* __restrict__ xc, int d,
    float (*As)[FT_BK][SP_SLAB], float (*Bs)[2][FT_BK][FT_BN], bool busy, int tq, int tr,
    float (&acc)[4][8])
{
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const int n_slices = (d + FT_BK - 1) / FT_BK;
    float ra[8], rb0[FT_PER_THREAD], rb1[FT_PER_THREAD];
    sp_gather_load<T, VEC>(q, rows, m, d, 0, ra);
    ft_load<T, VEC>(xc, FT_BN, d, 0, rb0);
    ft_load<T, VEC>(xc + (long long)FT_BN * d, FT_BN, d, 0, rb1);
    sp_gather_store<T, VEC>(As[0], ra);
    ft_store<T>(Bs[0][0], rb0);
    ft_store<T>(Bs[0][1], rb1);
    __syncthreads();

    for (int sl = 0; sl < n_slices; ++sl) {
        const int cur = sl & 1;
        const bool more = sl + 1 < n_slices;
        if (more) {
            const int k1 = (sl + 1) * FT_BK;
            sp_gather_load<T, VEC>(q, rows, m, d, k1, ra);
            ft_load<T, VEC>(xc, FT_BN, d, k1, rb0);
            ft_load<T, VEC>(xc + (long long)FT_BN * d, FT_BN, d, k1, rb1);
        }
        if (busy) {
#pragma unroll
            for (int kk = 0; kk < FT_BK; ++kk) {
                const float4 a = *reinterpret_cast<const float4*>(&As[cur][kk][tq * 4]);
                const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][0][kk][tr * 4]);
                const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][1][kk][tr * 4]);
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = dot_fma(av[i], bv[j], acc[i][j]);
            }
        }
        if (more) {
            sp_gather_store<T, VEC>(As[cur ^ 1], ra);
            ft_store<T>(Bs[cur ^ 1][0], rb0);
            ft_store<T>(Bs[cur ^ 1][1], rb1);
        }
        __syncthreads();
    }
}

// The chunk's row masks this thread's epilogue reads: rows tr*4 .. +3 of
// each 128-row half.
__device__ __forceinline__ void sp_row_masks(const float* __restrict__ mask, long long r0, int tr,
                                             float (&m_row)[8])
{
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m_row[j] = mask[r0 + tr * 4 + j];
        m_row[4 + j] = mask[r0 + FT_BN + tr * 4 + j];
    }
}

// *a = min(*a, v) for floats not NaN: non-negative floats order as ints,
// negative ones inversely as unsigned ints, each above every non-negative
// one there. v = +inf (the caller's fill) leaves *a as it is.
__device__ __forceinline__ void atomic_min_f32(float* a, float v)
{
    if (v >= 0.0f) {
        if (v < CUDART_INF_F) atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
    } else {
        atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
    }
}

// Blocks (chunk, part) of the cluster-major corpus, part p taking groups
// [G p / parts, G (p + 1) / parts); MINIMA: also each place's two group
// minima into gmin (a shortlist), else gmin is unused.
// first [G, nlist + 1] holds each cluster's first step in each group's
// walk (2^30 where the walk does not reach it); chunk i < MC of cluster c
// is step first[g, c] + i of group g, scanned where that step is below S.
template <typename T, bool VEC, bool MINIMA>
__global__ void __launch_bounds__(SP_THREADS, 2) compact_scan_kernel(
    const T* __restrict__ q, const float* __restrict__ qn,
    const T* __restrict__ x, const float* __restrict__ mask,
    const int* __restrict__ probes, int P, int n_places,
    const int* __restrict__ first, const int* __restrict__ chunk_start,
    const int* __restrict__ nchunks, int nlist, int MC,
    float thr, int G, int S, int d, int cosine, int wc,
    float* __restrict__ cand, int* __restrict__ chunk_tab, float* __restrict__ gmin)
{
    __shared__ __align__(16) float As[2][FT_BK][SP_SLAB];
    __shared__ __align__(16) float Bs[2][2][FT_BK][FT_BN];   // [buffer][row half][depth][row]
    __shared__ int members[SP_LIST];        // member query rows, by group, ascending
    __shared__ int member_place[SP_LIST];   // each member's chunk place in its row
    __shared__ int warp_members[SPARSE_QG / 32];
    __shared__ int cluster;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int chunk = blockIdx.x;
    if (tid == 0) {
        // the chunk's cluster: the last c with chunk_start[c] <= chunk
        int lo = 0;
        int hi = nlist;
        while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (chunk_start[mid] <= chunk) lo = mid;
            else hi = mid - 1;
        }
        cluster = lo;
    }
    __syncthreads();
    const int cid = cluster;
    if (cid >= nlist) return;   // past the last cluster's chunks: padding
    const int within = chunk - chunk_start[cid];
    const long long r0 = (long long)chunk * SPARSE_CHUNK;
    const T* xc = x + r0 * d;
    const int tq = 2 * (warp >> 1) + (lane >> 4);
    const int tr = 16 * (warp & 1) + (lane & 15);
    float m_row[8];
    sp_row_masks(mask, r0, tr, m_row);

    int count = 0;   // members listed, not yet computed
    const int g_end = (int)((long long)G * (blockIdx.y + 1) / gridDim.y);
    for (int g = (int)((long long)G * blockIdx.y / gridDim.y); g < g_end; ++g) {
        const int* fg = first + (long long)g * (nlist + 1);
        const int f = fg[cid];
        const bool last = g + 1 == g_end;
        if (within < MC && f < S - within) {
            // 1. which of the group's queries probe the cluster (their first
            // such probe), and at which place of its row the chunk goes: past
            // the chunks of the query's probes that the walk takes earlier
            const long long qrow = (long long)g * SPARSE_QG + tid;
            int place = -1;
            if (tid < SPARSE_QG) {
                const int* pr = probes + qrow * P;
                int j0 = -1;
                for (int p = P - 1; p >= 0; --p) j0 = __ldg(pr + p) == cid ? p : j0;
                if (j0 >= 0 && j0 < n_places) {
                    place = within;
                    for (int p = 0; p < n_places; ++p) {
                        const int c = __ldg(pr + p);
                        if (fg[c] < f) place += min(nchunks[c], MC);
                    }
                    if (place >= wc) place = -1;   // no place in the row: not scanned
                }
            }
            const bool in = place >= 0;
            const unsigned ballot = __ballot_sync(0xFFFFFFFFu, in);
            if (tid < SPARSE_QG && lane == 0) warp_members[warp] = __popc(ballot);
            __syncthreads();
            int M = 0;
            int before = 0;
#pragma unroll
            for (int w = 0; w < SPARSE_QG / 32; ++w) {
                const int c = warp_members[w];
                before += w < warp ? c : 0;
                M += c;
            }
            if (in) {
                const int at = count + before + __popc(ballot & ((1u << lane) - 1u));
                members[at] = (int)qrow;
                member_place[at] = place;
                chunk_tab[qrow * wc + place] = chunk;
            }
            count += M;
            __syncthreads();   // the list is whole; warp_members may be rewritten
        }
        if (count == 0 || (count <= SP_LIST - SPARSE_QG && !last)) continue;

        // 2. the listed members against the chunk's rows, SP_SLAB at a time
        for (int slab = 0; slab < count; slab += SP_SLAB) {
            const int m = min(SP_SLAB, count - slab);
            const int* rows = members + slab;
            const bool busy = 8 * (warp >> 1) < m;
            float acc[4][8];
            sp_slab_product<T, VEC>(q, rows, m, xc, d, As, Bs, busy, tq, tr, acc);
            if (busy) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int pos = tq * 4 + i;
                    const bool live = pos < m;   // the same for a half-warp's 16 lanes
                    if constexpr (!MINIMA) {
                        if (!live) continue;
                    }
                    const int row = live ? rows[pos] : 0;
                    const long long at =
                        (long long)row * wc + (live ? member_place[slab + pos] : 0);
                    float out[8];
                    if (live) {
                        const float qni = qn[row];
#pragma unroll
                        for (int j = 0; j < 8; ++j)
                            out[j] = scan_distance(acc[i][j], qni, m_row[j], thr, cosine);
                        float* dst = cand + at * SPARSE_CHUNK;
                        *reinterpret_cast<float4*>(dst + tr * 4) =
                            make_float4(out[0], out[1], out[2], out[3]);
                        *reinterpret_cast<float4*>(dst + FT_BN + tr * 4) =
                            make_float4(out[4], out[5], out[6], out[7]);
                    }
                    if constexpr (MINIMA) {
                        // each selection group's minimum: over the 16 lanes
                        // of the half-warp, then the two warps of the pair
                        float lo[2];
#pragma unroll
                        for (int h = 0; h < 2; ++h) {
                            lo[h] = live ? fminf(fminf(out[4 * h], out[4 * h + 1]),
                                                 fminf(out[4 * h + 2], out[4 * h + 3]))
                                         : CUDART_INF_F;
#pragma unroll
                            for (int o = 8; o > 0; o >>= 1)
                                lo[h] = fminf(lo[h], __shfl_xor_sync(0xFFFFFFFFu, lo[h], o));
                        }
                        if (live && (lane & 15) == 0) {
                            atomic_min_f32(gmin + 2 * at, lo[0]);
                            atomic_min_f32(gmin + 2 * at + 1, lo[1]);
                        }
                    }
                }
            }
        }
        count = 0;
        __syncthreads();   // the list is read; the next group may rewrite it
    }
}

template <typename T>
static void launch(unsigned blocks, cudaStream_t st, const void* q, const float* qn,
                   const void* x, const float* mask, const int* probes, int P, int n_places,
                   const int* first, const int* chunk_start, const int* nchunks, int nlist,
                   int MC, float thr, int G, int S, int d, int cosine, int wc, float* cand,
                   int* chunk_tab, float* gmin)
{
    const bool vec = d % (16 / sizeof(T)) == 0 &&
        ((uintptr_t)q % 16 == 0) && ((uintptr_t)x % 16 == 0);
    auto kernel = gmin != nullptr
        ? (vec ? compact_scan_kernel<T, true, true> : compact_scan_kernel<T, false, true>)
        : (vec ? compact_scan_kernel<T, true, false> : compact_scan_kernel<T, false, false>);
    kernel<<<dim3(blocks, (unsigned)min(G, SP_PARTS(T))), SP_THREADS, 0, st>>>(
        (const T*)q, qn, (const T*)x, mask, probes, P, n_places, first, chunk_start, nchunks,
        nlist, MC, thr, G, S, d, cosine, wc, cand, chunk_tab, gmin);
}

// q [G * 128, d] and x [NR, d] are float32, or bfloat16 when bf16 != 0;
// qn [G * 128], mask [NR], probes [G * 128, P]; n_places the probes a
// query's row has places for (its first n_places, distinct); first
// [G, nlist + 1], chunk_start [nlist + 1], nchunks [nlist]; one block for
// each of the corpus's n_chunks chunks. Writes only the member queries'
// places of cand [G * 128, wc * 256] and chunk_tab [G * 128, wc], and, when
// gmin [G * 128, 2 * wc] is not null, their group minima into it (filled
// with +inf beforehand).
extern "C" int comet_sparse_scan_compact(
    const void* q, const float* qn, const void* x, const float* mask,
    const int* probes, int P, int n_places, const int* first, const int* chunk_start,
    const int* nchunks, int nlist, int MC, float thr, int G, int S, int n_chunks, int d,
    int cosine, int bf16, int wc, float* cand, int* chunk_tab, float* gmin, void* stream)
{
    if (G < 1 || S < 1 || d < 1 || P < 1 || n_places < 1 || n_places > P || nlist < 1 ||
        MC < 1 || n_chunks < 1 || wc < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        launch<bf16_t>((unsigned)n_chunks, st, q, qn, x, mask, probes, P, n_places, first,
                       chunk_start, nchunks, nlist, MC, thr, G, S, d, cosine, wc, cand,
                       chunk_tab, gmin);
    } else {
        launch<float>((unsigned)n_chunks, st, q, qn, x, mask, probes, P, n_places, first,
                      chunk_start, nchunks, nlist, MC, thr, G, S, d, cosine, wc, cand,
                      chunk_tab, gmin);
    }
    return (int)cudaGetLastError();
}
