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
// Queries come sorted and cut into G groups of 128. Group g walks S steps;
// step s names a 256-row chunk of the cluster-major corpus, chunk_ids[g, s],
// and the cluster it belongs to, cluster_ids[g, s] (-1: a dead step). For
// each (g, s) it writes the [128 queries x 256 rows] distance tile
// dist[g, :, s*256 : (s+1)*256]: for a query that probes the chunk's
// cluster, the reference's epilogue (scan_tile.cuh)
//   L2:     max((qn + mask[n]) - 2 * ip, 0);  cosine: (1 - clip(ip)) + mask[n]
// then the threshold; for every other query (and every query of a dead
// step) +inf. It writes the minima of the tile's two 128-row selection
// groups into gmin[g, :, 2s + h]. K1 then picks each query's top-kb groups
// by (minimum, position 2s + h), which is exactly the set and order the
// Pallas kernel's running selection kept, since its group ids were these
// scan positions.
//
// What bounds it on an H100: the kernel must write the whole
// [G, 128, S * 256] float32 distance tensor, dead steps and non-probing
// queries included (as +inf): 16 x 128 x 512 x 256 x 4 bytes = 1 GiB at
// 2048 queries and S = 512, 0.32 ms at 3.35 TB/s, and read each listed
// chunk. The product needs 2 * 256 * d operations only for each (query,
// step) pair where the query probes the step's cluster; at 1M x 128, nlist
// 1024, nprobe 10, S = 512 about 9 % of the pairs, 6 GFLOP (0.09 ms at 67
// TFLOP/s). So bytes bound the function. The port's first design computed
// the whole dense product of a 64 x 128 tile whenever any query of it
// probed the cluster and then masked it, so the product over all 128
// queries bounded it (3.6-4.0 ms; PERF.md). This design computes only the
// probing queries; their product, at a few probing queries a step, is
// latency-bound and still costs about twice the +inf write (PERF.md).
// chip_smoke.py computes each run's bound from its inputs and the card's
// published peaks; PERF.md has the measured times.
//
// Design: one block of 256 threads per (group, step).
// - The blocks take the steps in chunk order (`order`, from the wrapper), so
//   that the steps of different groups that read one chunk run together
//   and share its rows through L2.
// - A block loads its chunk and cluster ids and tests which of the group's
//   128 queries probe the cluster (P compares a query), then compacts the
//   probing ("member") queries into an ascending list in shared memory
//   with a warp ballot and a prefix over the four warps, and the others
//   into a second list.
// - Every other query's 256 distances are +inf: one warp writes a 128-row
//   half in 16-byte streaming stores (`__stcs`, so that the write of the
//   distance tensor does not evict the corpus and the queries from L2),
//   and its two group minima are +inf.
// - The member queries are computed in slabs of 32 against the chunk's
//   256 rows: a 32 x 256 register tile, 4 queries x 8 rows a thread (rows
//   tr*4..+3 of each 128-row half), on K2's loads (fused_tile.cuh): 16-deep
//   depth slices staged k-major in shared memory, double buffered, the
//   next slice's operands loaded into registers during this slice's FMAs.
//   The query rows are gathered through the member list. Warp w owns
//   queries 8 (w / 2) .. +7 of the slab, so the warps whose queries are all
//   past the slab's member count skip the product (a step has 12 members
//   on average at the shape above); a depth step's operands are three
//   16-byte shared loads that a warp serves in five wavefronts for 32 FMAs.
//   A member query's minimum of a half is reduced over its warp's 16 row
//   quads with shuffles, then over the warp pair in shared memory, and
//   written for the query the slab position names. Unaligned rows (d not
//   a multiple of 4 floats or 8 bf16) take scalar loads.
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
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        m_row[j] = mask[r0 + tr * 4 + j];
        m_row[4 + j] = mask[r0 + FT_BN + tr * 4 + j];
    }
    const int n_slices = (d + FT_BK - 1) / FT_BK;

    for (int slab = 0; slab < M; slab += SP_SLAB) {
        const int m = min(SP_SLAB, M - slab);
        const int* rows = members + slab;
        // a warp whose 8 queries are all past m stages operands but skips
        // the product and the epilogue
        const bool busy = 8 * (warp >> 1) < m;
        float acc[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

        float ra[8], rb0[FT_PER_THREAD], rb1[FT_PER_THREAD];
        sp_gather_load<T, VEC>(qg, rows, m, d, 0, ra);
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
                sp_gather_load<T, VEC>(qg, rows, m, d, k1, ra);
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

// q [G * 128, d] and x [NR, d] are float32, or bfloat16 when bf16 != 0;
// order [G * S] the steps g * S + s in the order the blocks take them.
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
