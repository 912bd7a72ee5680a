// K5: one HNSW beam iteration in one launch: expand, score, merge.
//
// Replaces comet_tpu/ops/beam_kernel.py:_fused_expand_kernel (scoring in
// _score_packed_block), launched by fused_expand_merge, which the
// reference runs for unfiltered searches over the packed routing table
// (COMET_HNSW_FUSE=1). The Pallas kernel could not issue the row gather, so
// the JAX loop gathers every expanded node's packed row into an [E, Q,
// row_len] array first (8 x 2048 x 8,448 B = 138 MB written and read back
// per iteration at the 1M shapes); this kernel reads each row from the
// table itself and never writes the candidates out.
//
// One block of K5_THREADS threads per query q:
//   1. the ef beam rows become 64-bit keys in shared memory
//      (beam_merge.cuh);
//   2. the E expanded nodes (nodes[q, e], -1 for none) are staged and
//      scored by the split path's scoring code (neighbour_score.cuh): the
//      aux rows, then the live neighbours' vectors by coalesced
//      asynchronous copies in passes through a ring of buffers, each
//      candidate (e, j) one thread's `dot_fma` chain from 0, depth
//      ascending, so the distances are bit-equal to the scoring kernel's
//      and to the seed scan's (K3's bf16 mode). A node of -1 or an empty
//      entry gives (+inf, SENT) and reads nothing. Each candidate becomes
//      a key;
//   3. K4's split merge body runs on the keys in place (`merge_select`):
//      the candidates sorted and merged with the sorted beam, kill,
//      compaction, the next `expand` nodes, the active flag and the
//      `stop` window. Its window, sort and merge buffers reuse the staging
//      buffers, which scoring has left by then.
// The outputs (beam, expanded flags, misc) are those of the split pair
// (gather_score.cu, then beam_merge.cu in split mode) bit for bit.
//
// What bounds it on an H100: the E expanded rows a query reads (at most
// Q E row_len bf16, 138 MB at Q = 2048, E = 8, W = 32, d = 128) plus the
// beam read and written (ef x 12 bytes twice a query): about 151 MB, 45 us
// at 3.35 TB/s; the 2 d operations per candidate are far below the card's
// rate. One query a block: the merge of one block overlaps the copies of
// the others on its SM, so the blocks are small (K5_STAGE_BYTES of
// staging, one node a pass at W = 32, d = 128; a slice of a node's
// neighbours a pass past W d of about 4,300, as in gather_score.cu) and
// eight share an SM.

#include "beam_merge.cuh"
#include "neighbour_score.cuh"

constexpr int K5_THREADS = 128;
constexpr int K5_MIN_BLOCKS = 8;             // blocks an SM
constexpr size_t K5_STAGE_BYTES = 17 * 1024;

// Bytes of dynamic shared memory: the beam and candidate keys, then the
// staging (neighbour_score.cuh), whose buffers the merge's other keys
// (window, sort buffer, merged run) reuse.
static inline size_t k5_smem(const NbrGeom& g, int ef, int ew, size_t* base)
{
    *base = sizeof(u64) * (size_t)(merge_run(ef) + merge_run(ew));
    const NbrLayout l = nbr_layout(g, *base);
    const size_t merge = sizeof(u64) * (size_t)(merge_run(ef) + 2 * merge_run(ew) + ef);
    return l.stage + merge > l.end ? l.stage + merge : l.end;
}

__global__ void __launch_bounds__(K5_THREADS, K5_MIN_BLOCKS) fused_expand_kernel(
    const int* __restrict__ nodes, const bf16_t* __restrict__ table, long long row_len,
    const bf16_t* __restrict__ qb, const float* __restrict__ qn,
    const float* __restrict__ bd, const int* __restrict__ bs, const int* __restrict__ be,
    int ef, int expand, int stop,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, NbrGeom g, size_t base)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ MergeScratch sc;
    const int ew = g.E * g.W;
    MergeBufs bufs;
    bufs.beam = reinterpret_cast<u64*>(smem);
    bufs.cand = bufs.beam + merge_run(ef);
    bufs.win = reinterpret_cast<u64*>(smem + nbr_layout(g, base).stage);
    bufs.tmp = bufs.win + merge_run(ef);
    bufs.merged = bufs.tmp + merge_run(ew);

    const int tid = threadIdx.x;
    const long long q = blockIdx.x;
    for (int i = tid; i < ef; i += blockDim.x) {
        bufs.beam[i] = beam_key(bd[q * ef + i], bs[q * ef + i], be[q * ef + i]);
    }
    for (int c = ew + tid; c < merge_run(ew); c += blockDim.x) {
        bufs.cand[c] = beam_key(CUDART_INF_F, SENT_SLOT, 0);
    }
    u64* cand = bufs.cand;
    const int W = g.W;
    score_neighbours(
        g, smem, base, table, table + (long long)W * g.d, row_len, row_len, nodes + q * g.E,
        qb + q * g.d, qn + q, [&](int i, int j, float dist, int slot) {
            cand[i * W + j] = beam_key(dist, slot >= 0 ? slot : SENT_SLOT, 0);
        });
    merge_select(bufs, ef, ew, expand, stop, q, od, os, oe, misc, &sc);
}

// nodes [Q, E] i32 (E = expand), table [cap, row_len] bf16 packed rows
// (row_len = W d + (1 + ndig) W), qb [Q, d] bf16, qn [Q] f32, the beam
// bd / bs / be [Q, ef]; writes od / os / oe [Q, ef] and misc [Q, MISC_ROWS].
extern "C" int comet_fused_expand(
    const int* nodes, const void* table, long long row_len, const void* qb, const float* qn,
    const float* bd, const int* bs, const int* be,
    int Q, int ef, int W, int d, int ndig, int expand, int stop,
    float* od, int* os, int* oe, int* misc, void* stream)
{
    if (Q < 1 || ef < 1 || W < 1 || d < 1 || ndig < 1 || expand < 1 ||
        expand >= MISC_ROWS || stop < 1 || stop > ef ||
        row_len != (long long)W * d + (long long)(1 + ndig) * W)
        return (int)cudaErrorInvalidValue;
    const bf16_t* t = (const bf16_t*)table;
    const NbrGeom g = nbr_geom(W, d, ndig, expand, K5_STAGE_BYTES, t,
                               t + (long long)W * d, row_len, row_len);
    size_t base;
    const size_t smem = k5_smem(g, ef, expand * W, &base);
    const int attr = smem_attr<fused_expand_kernel>(smem);
    if (attr != 0) return attr;
    fused_expand_kernel<<<Q, K5_THREADS, smem, (cudaStream_t)stream>>>(
        nodes, t, row_len, (const bf16_t*)qb, qn, bd, bs, be, ef, expand, stop,
        od, os, oe, misc, g, base);
    return (int)cudaGetLastError();
}
