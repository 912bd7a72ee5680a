// K4: one step of the HNSW beam: merge, duplicate kill, compaction, select.
//
// Replaces comet_tpu/ops/beam_kernel.py:_merge_kernel (body _merge_body),
// launched by _beam_merge_pallas, in its split mode (fused = 0) and its
// fused mode (fused = 1: the admitted candidates also join a result set).
//
// What bounds it on an H100: a step reads (ef + ew) x 12 bytes and writes
// ef x 12 + 24 x 4 bytes per query (the fused result set doubles that): at
// Q = 2048, ef = ew = 256 about 17 MB, 5 us at 3.35 TB/s; the sort's 24 M
// compare-exchanges are integer work far below the card's rate. So bytes
// bound it, and what costs is latency: 45 dependent sort stages per block,
// each behind a barrier. chip_smoke.py computes each run's bound from its
// inputs; PERF.md has the measured times.
//
// Per query, on the port's query-major layout ([Q, rows]):
//   1. beam (ef rows of dist, slot, expanded) and candidates (ew rows,
//      expanded = 0) sorted by (dist asc, slot asc, expanded desc);
//   2. a row whose slot equals the previous row's is killed: copies of a
//      node carry bit-equal distances (the seed scan and the in-loop
//      scoring share one FMA chain, scan_tile.cuh), so one row stays, the
//      expanded copy if any;
//   3. the live rows compacted in order, the first ef kept, the rest
//      (inf, SENT, 0);
//   4. the first `expand` unexpanded rows selected and marked expanded when
//      the best unexpanded distance is at most row stop - 1's (the query is
//      active): misc[q, 0 .. expand-1] the selected slots (-1 none),
//      misc[q, expand] the flag, the rest -1;
//   5. (fused) the result set (kr sorted rows) and the admitted candidates
//      sorted by (dist, slot), adjacent copies killed, compacted, cut to kr.
// The order of step 1 is total up to rows equal in every field, so any
// correct sort gives the reference's result bit for bit: the kernel does
// not copy the TPU's bitonic network over queries on lanes.
//
// Design: one block of 256 threads per query over 64-bit keys in shared
// memory (beam_merge.cuh, whose merge body K5 shares). The block sorts the
// next_pow2(ef + ew) keys with a bitonic network, marks the dead rows,
// places the live ones by a block prefix sum and selects over the
// compacted window with a second one. The fused result set reuses the key
// buffer with (dist bits << 32) | slot keys.

#include "beam_merge.cuh"

__global__ void __launch_bounds__(MERGE_THREADS) beam_merge_kernel(
    const float* __restrict__ bd, const int* __restrict__ bs, const int* __restrict__ be,
    const float* __restrict__ nd, const int* __restrict__ ns,
    const float* __restrict__ rd, const int* __restrict__ rs, const int* __restrict__ adm,
    int ef, int ew, int expand, int stop, int kr, int fused, int n_sort, int n_res,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, float* __restrict__ ord, int* __restrict__ ors)
{
    extern __shared__ u64 smem[];
    u64* keys = smem;                             // max(n_sort, n_res)
    u64* win = smem + max(n_sort, n_res);         // max(ef, kr)
    __shared__ MergeScratch sc;

    const int tid = threadIdx.x;
    const long long q = blockIdx.x;
    const u64 pad_beam = beam_key(CUDART_INF_F, SENT_SLOT, 0);

    // 1. keys of the beam and the candidates, padded to n_sort
    for (int i = tid; i < n_sort; i += blockDim.x) {
        u64 k = pad_beam;
        if (i < ef) {
            k = beam_key(bd[q * ef + i], bs[q * ef + i], be[q * ef + i]);
        } else if (i < ef + ew) {
            const int j = i - ef;
            k = beam_key(nd[q * ew + j], ns[q * ew + j], 0);
        }
        keys[i] = k;
    }
    // 2-4. sort, kill, compact, select
    merge_select(keys, n_sort, win, ef, expand, stop, q, od, os, oe, misc, &sc);
    if (!fused) return;

    // 5. the result set: kr sorted rows + the admitted candidates
    const u64 pad_res = res_key(CUDART_INF_F, SENT_SLOT);
    for (int i = tid; i < n_res; i += blockDim.x) {
        u64 k = pad_res;
        if (i < kr) {
            k = res_key(rd[q * kr + i], rs[q * kr + i]);
        } else if (i < kr + ew) {
            const int j = i - kr;
            if (adm[q * ew + j] != 0) k = res_key(nd[q * ew + j], ns[q * ew + j]);
        }
        keys[i] = k;
    }
    __syncthreads();
    block_sort(keys, n_res);
    kill_compact(keys, n_res, 0, win, kr, pad_res, sc.warp_sums);
    for (int i = tid; i < kr; i += blockDim.x) {
        const u64 k = win[i];
        ord[q * kr + i] = __uint_as_float((unsigned)(k >> 32));
        ors[q * kr + i] = (int)(k & 0x7FFFFFFFull);
    }
}

extern "C" int comet_beam_merge(
    const float* bd, const int* bs, const int* be, const float* nd, const int* ns,
    const float* rd, const int* rs, const int* adm,
    int Q, int ef, int ew, int expand, int stop, int kr, int fused,
    float* od, int* os, int* oe, int* misc, float* ord, int* ors, void* stream)
{
    if (Q < 1 || ef < 1 || ew < 1 || expand < 1 || expand >= MISC_ROWS ||
        stop < 1 || stop > ef || (fused && kr < 1))
        return (int)cudaErrorInvalidValue;
    const int n_sort = merge_next_pow2(ef + ew);
    const int n_res = fused ? merge_next_pow2(kr + ew) : 0;
    const int width = ef > kr ? ef : kr;
    const size_t smem = sizeof(u64) * ((size_t)(n_sort > n_res ? n_sort : n_res) + width);
    const int attr = merge_smem_attr(beam_merge_kernel, smem);
    if (attr != 0) return attr;
    beam_merge_kernel<<<Q, MERGE_THREADS, smem, (cudaStream_t)stream>>>(
        bd, bs, be, nd, ns, rd, rs, adm, ef, ew, expand, stop, kr, fused, n_sort, n_res,
        od, os, oe, misc, ord, ors);
    return (int)cudaGetLastError();
}
