// K3: block-sparse IVF scan over a cluster-major corpus.
//
// Replaces comet_tpu/ops/ivf_sparse.py:_sparse_kernel, the Pallas kernel
// launched by _sparse_scan (float32 distances; its bf16_domain mode is not
// ported).
//
// Queries come sorted and cut into G groups of 128. Group g walks S steps;
// step s names a 256-row chunk of the cluster-major corpus, chunk_ids[g, s],
// and the cluster it belongs to, cluster_ids[g, s] (-1: a dead step). For
// each (g, s) it computes the [128 queries x 256 rows] distance tile with
// K2's product and epilogue (scan_tile.cuh):
//   L2:     max((qn + mask[n]) - 2 * ip, 0);  cosine: (1 - clip(ip)) + mask[n]
// then the threshold, then +inf for every query whose probes do not
// contain the chunk's cluster. It writes dist[g, :, s*256 : (s+1)*256] and
// the minima of the tile's two 128-row selection groups into
// gmin[g, :, 2s + h]. K1 then picks each query's top-kb groups by
// (minimum, position 2s + h), which is exactly the set and order the
// Pallas kernel's running selection kept, since its group ids were these
// scan positions.
//
// What bounds it on an H100: the product needs 2 * 256 * d operations for
// each (query, listed chunk) pair where the query probes the chunk's
// cluster; the kernel must write the whole [G, 128, S * 256] float32
// distance tensor (dead steps included, as +inf) and read each listed chunk
// once. At 1M x 128, nlist 1024, nprobe 10, S = 512 and 2048 queries a
// query probes about 45 chunks, so the products come to about 6 GFLOP
// while the distances are 16 x 128 x 512 x 256 x 4 bytes = 1 GiB: bytes
// bound it. chip_smoke.py computes each run's bound from its inputs and
// the card's published peaks; PERF.md has the measured times.
//
// Design: one block of 256 threads per (group, step, query half, row half):
// a 64 x 128 tile, the block of K2. The block loads its own chunk and
// cluster ids (there is no scalar prefetch) and flags, in shared memory,
// which of its 64 queries probe the cluster: P compares per query, once per
// block. When no query of the tile probes the cluster (a dead step, or a
// chunk only the other half of the group wanted) the block skips the
// product and writes +inf. Otherwise it runs the K2 tile on the 128 rows
// of its half-chunk and masks whole query rows. The corpus is read from a
// cluster-major copy (rows contiguous per chunk) rather than through a
// row -> slot indirection into the slot store: the copy costs one more
// corpus of device memory (NR x d x 4 bytes, NR the rows padded to whole
// chunks) and keeps every tile load contiguous.

#include "scan_tile.cuh"

#define SPARSE_QG 128      // queries per group
#define SPARSE_CHUNK 256   // corpus rows per chunk

__global__ void __launch_bounds__(SCAN_THREADS) sparse_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ qn,
    const float* __restrict__ x, const float* __restrict__ mask,
    const int* __restrict__ probes, int P,
    const int* __restrict__ chunk_ids, const int* __restrict__ cluster_ids,
    float thr, int S, int d, int cosine,
    float* __restrict__ dist, float* __restrict__ gmin)
{
    __shared__ bool member[SCAN_BM];
    const int tid = threadIdx.x;
    const int qh = blockIdx.x & 1;            // query half of the group
    const int rh = (blockIdx.x >> 1) & 1;     // row half of the chunk
    const long long gs = blockIdx.x >> 2;     // g * S + s
    const int g = (int)(gs / S);
    const int s = (int)(gs % S);
    const int cid = cluster_ids[gs];
    const long long q0 = (long long)g * SPARSE_QG + qh * SCAN_BM;
    const long long dist_stride = (long long)S * SPARSE_CHUNK;
    float* dtile = dist + q0 * dist_stride + (long long)s * SPARSE_CHUNK + rh * SCAN_BN;
    float* gtile = gmin + q0 * (2LL * S) + 2 * s + rh;

    int in = 0;
    if (tid < SCAN_BM && cid >= 0) {
        const int* pr = probes + (q0 + tid) * P;
        for (int p = 0; p < P; ++p) in |= pr[p] == cid;
        member[tid] = in != 0;
    }
    if (!__syncthreads_or(in)) {
        // no query of this tile probes the chunk's cluster: all +inf
        const float4 inf4 = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
        for (int e = tid; e < SCAN_BM * (SCAN_BN / 4); e += SCAN_THREADS) {
            const int r = e / (SCAN_BN / 4);
            const int c = e % (SCAN_BN / 4);
            reinterpret_cast<float4*>(dtile + r * dist_stride)[c] = inf4;
        }
        if (tid < SCAN_BM) gtile[tid * (2LL * S)] = CUDART_INF_F;
        return;
    }
    const long long r0 = (long long)chunk_ids[gs] * SPARSE_CHUNK + rh * SCAN_BN;
    scan_tile<SCAN_QUERY>(
        q + q0 * d, qn + q0, SCAN_BM, x + r0 * d, mask + r0, d, thr, cosine,
        nullptr, nullptr, 0, member,
        dtile, dist_stride, gtile, 2LL * S);
}

extern "C" int comet_sparse_scan(
    const float* q, const float* qn, const float* x, const float* mask,
    const int* probes, int P, const int* chunk_ids, const int* cluster_ids,
    float thr, int G, int S, int d, int cosine, float* dist, float* gmin,
    void* stream)
{
    if (G < 1 || S < 1 || d < 1 || P < 1) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)G * S * 4;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    sparse_scan_kernel<<<(unsigned)blocks, SCAN_THREADS, 0, (cudaStream_t)stream>>>(
        q, qn, x, mask, probes, P, chunk_ids, cluster_ids, thr, S, d, cosine,
        dist, gmin);
    return (int)cudaGetLastError();
}
