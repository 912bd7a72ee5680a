// K3: block-sparse IVF scan over a cluster-major corpus.
//
// Replaces comet_tpu/ops/ivf_sparse.py:_sparse_kernel, the Pallas kernel
// launched by _sparse_scan, in both of its modes: float32 operands, and
// bf16_domain (bf16 queries and corpus, float32 accumulation, float32 query
// norms), which HNSW's seed scan uses. In the bf16 mode the product is the
// FMA chain of `dot_fma` (scan_tile.cuh), so a seed's distance is bit-equal
// to the distance the beam's in-loop scoring (gather_score.cu) finds for
// the same (query, slot).
//
// What bounds it on an H100 depends on the route (below): on the compact
// route, each chunk's one read and its probing queries' products; on the
// dense route, the +inf write of its whole distance tile.
//
// Queries come sorted and cut into G groups of 128. Group g walks S steps;
// step s names a 256-row chunk of the cluster-major corpus, chunk_ids[g, s],
// and the cluster it belongs to, cluster_ids[g, s] (-1: a dead step). The
// walk takes the group's clusters by (best probe rank in the group,
// cluster id), each cluster's chunks in order; that is the scan order. For
// a query that probes a step's cluster, each of the chunk's 256 distances
// is the reference's epilogue (scan_tile.cuh)
//   L2:     max((qn + mask[n]) - 2 * ip, 0);  cosine: (1 - clip(ip)) + mask[n]
// then the threshold. Two routes write them; ops/ivf_sparse.py picks by
// kb_cap alone.
//
// The compact route (kb_cap == 0: the exact top-k; `compact_scan_kernel`)
// writes each probing query's distances into a row of its own,
// cand[q, place * 256 .. +255], and the chunk id of each place into
// chunk_tab[q, place]. A query's places follow the scan order: the place
// of chunk i of a probed cluster c is i plus the chunk counts (each at most
// MC) of the query's probes that the group's walk takes before c. So a
// row's position order is the scan order restricted to the query's own
// chunks, and K1's one select of the row, ties to the lower position,
// keeps the same candidates in the same tie order as the dense route's
// group select and candidate select. Nothing else is written: the caller
// fills cand with +inf and chunk_tab with 0 beforehand, so a place never
// scanned (a short list, a chunk the S or UC budget dropped) drops out as
// (+inf, IDX_SENTINEL). Its bound: each chunk read once for all its
// probing queries, and their products: at 1M x 128, nlist 1000, nprobe 10
// and 2048 queries, 4,400 chunks of 128 KiB (0.58 GB, 0.17 ms at 3.35
// TB/s) and ~94,000 (query, chunk) pairs, 6.2 GFLOP (0.09 ms at 67
// TFLOP/s); the row is 2048 x 17,920 float32, 147 MB. It runs 0.69-0.71 ms
// there (PERF.md): a block's depth slices are latency-bound at ~21 members.
//
// The dense route (kb_cap > 0: HNSW's default seed scan and IVFPQ's nrefine
// shortlist, whose approximation is defined by selection-group minima;
// `sparse_scan_kernel`) writes for each (g, s) the [128 queries x 256
// rows] tile dist[g, :, s*256 : (s+1)*256], +inf for every query that does
// not probe the chunk's cluster (and every query of a dead step), and the
// minima of the tile's two 128-row selection groups into gmin[g, :, 2s +
// h]. K1 then picks each query's top-kb groups by (minimum, position 2s +
// h), which is exactly the set and order the Pallas kernel's running
// selection kept, since its group ids were these scan positions. Its
// bound: the whole [G, 128, S * 256] float32 tensor, dead steps and
// non-probing queries included: 4 GiB at 2048 queries and S = 2048, 1.28
// ms at 3.35 TB/s (2.62 ms measured, PERF.md). The port's first design
// computed the whole dense product of a 64 x 128 tile whenever any query
// of it probed the cluster and then masked it (3.6-4.0 ms at S = 512).
//
// chip_smoke.py holds each route to its plain version at the IVF path's
// shapes and computes each run's bound from its inputs and the card's
// published peaks; PERF.md has the measured times.
//
// Design, shared by both routes: blocks of 256 threads; a member test of a
// group's 128 queries (P compares a query), whose probing ("member")
// queries a warp ballot and a prefix over the four warps compact into an
// ascending list in shared memory; the members' product in slabs of 32
// against the chunk's 256 rows (`sp_slab_product`): a 32 x 256 register
// tile, 4 queries x 8 rows a thread (rows tr*4..+3 of each 128-row half),
// on K2's loads (fused_tile.cuh): 16-deep depth slices staged k-major in
// shared memory, double buffered, the next slice's operands loaded into
// registers during this slice's FMAs. The query rows are gathered through
// the member list. Warp w owns queries 8 (w / 2) .. +7 of the slab, so the
// warps whose queries are all past the slab's member count skip the
// product; a depth step's operands are three 16-byte shared loads that a
// warp serves in five wavefronts for 32 FMAs. Unaligned rows (d not a
// multiple of 4 floats or 8 bf16) take scalar loads.
// - Compact: one block per chunk of the corpus. It finds the chunk's
//   cluster (a binary search of chunk_start) and, for each group whose walk
//   reaches the chunk (first[g, c] + i < S, from the wrapper's table of
//   each cluster's first step), tests the group's queries and lists its
//   members with their places; every SP_LIST - 128 members, and after the
//   last group, it computes the list. So a chunk is read once for all the
//   groups that probe it: with one block per (group, step), ~4.7 members a
//   step, each step read the chunk again and the route ran 1.45 ms.
// - Dense: one block per (group, step), taking the steps in chunk order
//   (`order`, from the wrapper), so that the steps of different groups
//   that read one chunk run together and share its rows through L2. Every
//   other query's 256 distances are +inf: one warp writes a 128-row half in
//   16-byte streaming stores (`__stcs`, so that the write of the distance
//   tensor does not evict the corpus and the queries from L2), and its two
//   group minima are +inf. A member query's minimum of a half is reduced
//   over its warp's 16 row quads with shuffles, then over the warp pair in
//   shared memory, and written for the query the slab position names.
// The corpus is read from a cluster-major copy (rows contiguous per chunk)
// rather than through a row -> slot indirection into the slot store: the
// copy costs one more corpus of device memory (NR x d x 4 bytes, NR the
// rows padded to whole chunks) and keeps every tile load contiguous.

#include <limits.h>
#include <stdint.h>

#include "fused_tile.cuh"

#define SPARSE_QG 128      // queries per group
#define SPARSE_CHUNK 256   // corpus rows per chunk = two selection groups
#define SP_SLAB 32         // member queries per product pass
#define SP_THREADS 256     // = FT_THREADS: the chunk's loads are K2's
#define SP_PER (SP_SLAB * FT_BK / SP_THREADS)   // scalar query loads a thread
#define SP_LIST 256        // compact route: members listed before a product pass

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

// The dense route: one block per (group, step).
template <typename T, bool VEC>
__global__ void __launch_bounds__(SP_THREADS, 2) sparse_scan_kernel(
    const T* __restrict__ q, const float* __restrict__ qn,
    const T* __restrict__ x, const float* __restrict__ mask,
    const int* __restrict__ probes, int P,
    const int* __restrict__ chunk_ids, const int* __restrict__ cluster_ids,
    float thr, int S, int d, int cosine,
    const int* __restrict__ order, float* __restrict__ dist, float* __restrict__ gmin)
{
    __shared__ __align__(16) float As[2][FT_BK][SP_SLAB];
    __shared__ __align__(16) float Bs[2][2][FT_BK][FT_BN];   // [buffer][row half][depth][row]
    __shared__ float red[2][SP_SLAB][2];   // [row half of the tile's columns][query][half]
    __shared__ int members[SPARSE_QG];   // the probing queries, ascending
    __shared__ int others[SPARSE_QG];    // the rest, ascending
    __shared__ int warp_members[SPARSE_QG / 32];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long gs = order[blockIdx.x];   // g * S + s
    const int g = (int)(gs / S);
    const int s = (int)(gs % S);
    const int cid = cluster_ids[gs];
    const long long q0 = (long long)g * SPARSE_QG;
    const long long dist_stride = (long long)S * SPARSE_CHUNK;
    const long long gmin_stride = 2LL * S;
    float* dtile = dist + q0 * dist_stride + (long long)s * SPARSE_CHUNK;
    float* gtile = gmin + q0 * gmin_stride + 2 * s;

    // 1. which queries probe the chunk's cluster: two ascending lists
    bool in = false;
    if (tid < SPARSE_QG && cid >= 0) {
        const int* pr = probes + (q0 + tid) * P;
        for (int p = 0; p < P; ++p) in |= __ldg(pr + p) == cid;
    }
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
    if (tid < SPARSE_QG) {
        const int rank = before + __popc(ballot & ((1u << lane) - 1u));
        if (in) members[rank] = tid;
        else others[tid - rank] = tid;
    }
    __syncthreads();

    // 2. the other queries: +inf, streamed
    const int n_out = SPARSE_QG - M;
    const float inf = CUDART_INF_F;
    const float4 inf4 = make_float4(inf, inf, inf, inf);
    for (int u = warp; u < 2 * n_out; u += SP_THREADS / 32) {
        float* row = dtile + (long long)others[u >> 1] * dist_stride + (u & 1) * FT_BN;
        __stcs(reinterpret_cast<float4*>(row) + lane, inf4);
    }
    for (int e = tid; e < 2 * n_out; e += SP_THREADS) {
        gtile[(long long)others[e >> 1] * gmin_stride + (e & 1)] = inf;
    }
    if (M == 0) return;

    // 3. the member queries against the chunk's rows, SP_SLAB at a time
    const long long r0 = (long long)chunk_ids[gs] * SPARSE_CHUNK;
    const T* xc = x + r0 * d;
    const T* qg = q + q0 * d;
    // warp w owns slab queries 8 (w / 2) .. +7 and rows 64 (w % 2) .. +63 of
    // each half: lane l holds queries tq*4 .. +3 and rows tr*4 .. +3
    const int tq = 2 * (warp >> 1) + (lane >> 4);
    const int tr = 16 * (warp & 1) + (lane & 15);
    float m_row[8];
    sp_row_masks(mask, r0, tr, m_row);

    for (int slab = 0; slab < M; slab += SP_SLAB) {
        const int m = min(SP_SLAB, M - slab);
        const int* rows = members + slab;
        // a warp whose 8 queries are all past m stages operands but skips
        // the product and the epilogue
        const bool busy = 8 * (warp >> 1) < m;
        float acc[4][8];
        sp_slab_product<T, VEC>(qg, rows, m, xc, d, As, Bs, busy, tq, tr, acc);

        if (busy) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int pos = tq * 4 + i;
                const bool ok = pos < m;
                const int lq = ok ? rows[pos] : 0;
                const float qni = qn[q0 + lq];
                float out[8];
                float mn0 = inf;
                float mn1 = inf;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    out[j] = scan_distance(acc[i][j], qni, m_row[j], thr, cosine);
                    if (j < 4) mn0 = fminf(mn0, out[j]);
                    else mn1 = fminf(mn1, out[j]);
                }
                if (ok) {
                    float* row = dtile + (long long)lq * dist_stride;
                    *reinterpret_cast<float4*>(row + tr * 4) =
                        make_float4(out[0], out[1], out[2], out[3]);
                    *reinterpret_cast<float4*>(row + FT_BN + tr * 4) =
                        make_float4(out[4], out[5], out[6], out[7]);
                }
                // the 16 row quads of this warp's half are lanes 0-15 or 16-31
#pragma unroll
                for (int off = 1; off <= 8; off <<= 1) {
                    mn0 = fminf(mn0, __shfl_xor_sync(0xFFFFFFFFu, mn0, off));
                    mn1 = fminf(mn1, __shfl_xor_sync(0xFFFFFFFFu, mn1, off));
                }
                if ((lane & 15) == 0) {
                    red[warp & 1][pos][0] = mn0;
                    red[warp & 1][pos][1] = mn1;
                }
            }
        }
        __syncthreads();
        if (tid < 2 * SP_SLAB && (tid >> 1) < m) {
            const int pos = tid >> 1;
            const int h = tid & 1;
            gtile[(long long)rows[pos] * gmin_stride + h] = fminf(red[0][pos][h], red[1][pos][h]);
        }
        // the next slab rewrites red only after its barriers
    }
}

// The compact route: one block per chunk of the cluster-major corpus.
// first [G, nlist + 1] holds each cluster's first step in each group's
// walk (2^30 where the walk does not reach it); chunk i < MC of cluster c
// is step first[g, c] + i of group g, scanned where that step is below S.
template <typename T, bool VEC>
__global__ void __launch_bounds__(SP_THREADS, 2) compact_scan_kernel(
    const T* __restrict__ q, const float* __restrict__ qn,
    const T* __restrict__ x, const float* __restrict__ mask,
    const int* __restrict__ probes, int P, int n_places,
    const int* __restrict__ first, const int* __restrict__ chunk_start,
    const int* __restrict__ nchunks, int nlist, int MC,
    float thr, int G, int S, int d, int cosine, int wc,
    float* __restrict__ cand, int* __restrict__ chunk_tab)
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
    for (int g = 0; g < G; ++g) {
        const int* fg = first + (long long)g * (nlist + 1);
        const int f = fg[cid];
        const bool last = g + 1 == G;
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
                    if (pos >= m) continue;
                    const int row = rows[pos];
                    const float qni = qn[row];
                    float out[8];
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        out[j] = scan_distance(acc[i][j], qni, m_row[j], thr, cosine);
                    float* dst =
                        cand + ((long long)row * wc + member_place[slab + pos]) * SPARSE_CHUNK;
                    *reinterpret_cast<float4*>(dst + tr * 4) =
                        make_float4(out[0], out[1], out[2], out[3]);
                    *reinterpret_cast<float4*>(dst + FT_BN + tr * 4) =
                        make_float4(out[4], out[5], out[6], out[7]);
                }
            }
        }
        count = 0;
        __syncthreads();   // the list is read; the next group may rewrite it
    }
}

template <typename T>
static void launch(unsigned blocks, cudaStream_t st, const void* q, const float* qn,
                   const void* x, const float* mask, const int* probes, int P,
                   const int* chunk_ids, const int* cluster_ids, float thr, int S, int d,
                   int cosine, const int* order, float* dist, float* gmin)
{
    // 16-byte loads need 16-byte aligned rows
    const bool vec = d % (16 / sizeof(T)) == 0 &&
        ((uintptr_t)q % 16 == 0) && ((uintptr_t)x % 16 == 0);
    if (vec) {
        sparse_scan_kernel<T, true><<<blocks, SP_THREADS, 0, st>>>(
            (const T*)q, qn, (const T*)x, mask, probes, P, chunk_ids, cluster_ids,
            thr, S, d, cosine, order, dist, gmin);
    } else {
        sparse_scan_kernel<T, false><<<blocks, SP_THREADS, 0, st>>>(
            (const T*)q, qn, (const T*)x, mask, probes, P, chunk_ids, cluster_ids,
            thr, S, d, cosine, order, dist, gmin);
    }
}

// The dense route: q [G * 128, d] and x [NR, d] are float32, or bfloat16
// when bf16 != 0; order [G * S] the steps g * S + s in the order the blocks
// take them; dist [G, 128, S * 256] and gmin [G, 128, 2 S] written whole.
extern "C" int comet_sparse_scan(
    const void* q, const float* qn, const void* x, const float* mask,
    const int* probes, int P, const int* chunk_ids, const int* cluster_ids,
    const int* order, float thr, int G, int S, int d, int cosine, int bf16,
    float* dist, float* gmin, void* stream)
{
    if (G < 1 || S < 1 || d < 1 || P < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)G * S;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        launch<bf16_t>((unsigned)blocks, st, q, qn, x, mask, probes, P, chunk_ids, cluster_ids,
                       thr, S, d, cosine, order, dist, gmin);
    } else {
        launch<float>((unsigned)blocks, st, q, qn, x, mask, probes, P, chunk_ids, cluster_ids,
                      thr, S, d, cosine, order, dist, gmin);
    }
    return (int)cudaGetLastError();
}

template <typename T>
static void launch_compact(unsigned blocks, cudaStream_t st, const void* q, const float* qn,
                           const void* x, const float* mask, const int* probes, int P,
                           int n_places, const int* first, const int* chunk_start,
                           const int* nchunks, int nlist, int MC, float thr, int G, int S, int d,
                           int cosine, int wc, float* cand, int* chunk_tab)
{
    const bool vec = d % (16 / sizeof(T)) == 0 &&
        ((uintptr_t)q % 16 == 0) && ((uintptr_t)x % 16 == 0);
    if (vec) {
        compact_scan_kernel<T, true><<<blocks, SP_THREADS, 0, st>>>(
            (const T*)q, qn, (const T*)x, mask, probes, P, n_places, first, chunk_start, nchunks,
            nlist, MC, thr, G, S, d, cosine, wc, cand, chunk_tab);
    } else {
        compact_scan_kernel<T, false><<<blocks, SP_THREADS, 0, st>>>(
            (const T*)q, qn, (const T*)x, mask, probes, P, n_places, first, chunk_start, nchunks,
            nlist, MC, thr, G, S, d, cosine, wc, cand, chunk_tab);
    }
}

// The compact route: the same queries, corpus, mask and probes; n_places
// the probes a query's row has places for (its first n_places, distinct);
// first [G, nlist + 1], chunk_start [nlist + 1], nchunks [nlist]; one block
// for each of the corpus's n_chunks chunks. Writes only the member
// queries' rows of cand [G * 128, wc * 256] and chunk_tab [G * 128, wc],
// which the caller fills beforehand (+inf, 0).
extern "C" int comet_sparse_scan_compact(
    const void* q, const float* qn, const void* x, const float* mask,
    const int* probes, int P, int n_places, const int* first, const int* chunk_start,
    const int* nchunks, int nlist, int MC, float thr, int G, int S, int n_chunks, int d,
    int cosine, int bf16, int wc, float* cand, int* chunk_tab, void* stream)
{
    if (G < 1 || S < 1 || d < 1 || P < 1 || n_places < 1 || n_places > P || nlist < 1 ||
        MC < 1 || n_chunks < 1 || wc < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16) {
        launch_compact<bf16_t>((unsigned)n_chunks, st, q, qn, x, mask, probes, P, n_places, first,
                               chunk_start, nchunks, nlist, MC, thr, G, S, d, cosine, wc, cand,
                               chunk_tab);
    } else {
        launch_compact<float>((unsigned)n_chunks, st, q, qn, x, mask, probes, P, n_places, first,
                              chunk_start, nchunks, nlist, MC, thr, G, S, d, cosine, wc, cand,
                              chunk_tab);
    }
    return (int)cudaGetLastError();
}
