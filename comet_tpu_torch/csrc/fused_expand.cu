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
//   2. each of the E * W candidates (expanded node e = nodes[q, e], -1 for
//      none, neighbour j) is scored by one thread from the node's packed
//      row: the slot from the digit planes and the distance by the
//      `dot_fma` chain from 0, depth ascending (neighbour_score.cuh), the
//      code of the split path's scoring kernel, so the distances are
//      bit-equal to it and to the seed scan's (K3's bf16 mode). A node of
//      -1 or an empty entry gives (+inf, SENT) and reads nothing;
//   3. K4's split merge body runs on the keys in place (`merge_select`):
//      the candidates sorted and merged with the sorted beam, kill,
//      compaction, the next `expand` nodes, the active flag and the
//      `stop` window.
// The outputs (beam, expanded flags, misc) are those of the split pair
// (gather_score.cu, then beam_merge.cu in split mode) bit for bit.
//
// What bounds it on an H100: the E expanded rows a query reads (at most
// Q E row_len bf16, 138 MB at Q = 2048, E = 8, W = 32, d = 128) plus the
// beam read and written (ef x 12 bytes twice a query): about 151 MB, 45 us
// at 3.35 TB/s; the 2 d operations per candidate are far below the card's
// rate. The design is the simple one: one thread per candidate reads its
// neighbour's 256 bytes; the merge is K4's (a sort of the E W candidates,
// runs of 32 in registers then merge path, and one merge with the beam).

#include "beam_merge.cuh"
#include "neighbour_score.cuh"

constexpr int K5_THREADS = 256;    // threads a query: one candidate a thread

__global__ void __launch_bounds__(K5_THREADS) fused_expand_kernel(
    const int* __restrict__ nodes, const bf16_t* __restrict__ table, long long row_len,
    const bf16_t* __restrict__ qb, const float* __restrict__ qn,
    const float* __restrict__ bd, const int* __restrict__ bs, const int* __restrict__ be,
    int ef, int E, int W, int d, int ndig, int expand, int stop,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc)
{
    extern __shared__ u64 smem[];
    __shared__ MergeScratch sc;
    const int ew = E * W;
    const MergeBufs bufs = merge_bufs(smem, ef, ew);

    const int tid = threadIdx.x;
    const long long q = blockIdx.x;
    const bf16_t* qq = qb + q * d;
    const float qnq = qn[q];

    for (int i = tid; i < ef; i += blockDim.x) {
        bufs.beam[i] = beam_key(bd[q * ef + i], bs[q * ef + i], be[q * ef + i]);
    }
    for (int c = tid; c < merge_run(ew); c += blockDim.x) {
        float dist = CUDART_INF_F;
        int slot = SENT_SLOT;
        const int node = c < ew ? nodes[q * E + c / W] : -1;
        if (node >= 0) {
            const int j = c % W;
            const bf16_t* row = table + (long long)node * row_len;
            const bf16_t* arow = row + (long long)W * d;
            const int neigh = decode_slot(arow, W, j, ndig);
            if (neigh >= 0) {
                slot = neigh;
                dist = neighbour_dist(qq, qnq, row + j * d, arow[j], d);
            }
        }
        bufs.cand[c] = beam_key(dist, slot, 0);
    }
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
    const size_t smem = sizeof(u64) * (size_t)merge_keys(ef, expand * W);
    const int attr = merge_smem_attr(fused_expand_kernel, smem);
    if (attr != 0) return attr;
    fused_expand_kernel<<<Q, K5_THREADS, smem, (cudaStream_t)stream>>>(
        nodes, (const bf16_t*)table, row_len, (const bf16_t*)qb, qn, bd, bs, be,
        ef, expand, W, d, ndig, expand, stop, od, os, oe, misc);
    return (int)cudaGetLastError();
}
