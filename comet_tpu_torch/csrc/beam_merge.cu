// K4: one step of the HNSW beam: merge, duplicate kill, compaction, select.
//
// Replaces comet_tpu/ops/beam_kernel.py:_merge_kernel (body _merge_body),
// launched by _beam_merge_pallas, in its split mode (fused = 0) and its
// fused mode (fused = 1: the admitted candidates also join a result set).
//
// What bounds it on an H100: a step reads (ef + ew) x 12 bytes and writes
// ef x 12 + 24 x 4 bytes per query (the fused result set doubles that): at
// Q = 2048, ef = ew = 256 about 17 MB, 5 us at 3.35 TB/s; the compares are
// integer work far below the card's rate. So bytes bound it, and what
// costs is latency: the dependent steps of one query's block, each behind a
// barrier. The port's first design sorted all next_pow2(ef + ew) = 512 keys
// with a bitonic network, 45 barriered stages; this one sorts only the
// candidates and merges. chip_smoke.py computes each run's bound from its
// inputs; PERF.md has the measured times.
//
// Per query, on the port's query-major layout ([Q, rows]):
//   1. beam (ef rows of dist, slot, expanded) and candidates (ew rows,
//      expanded = 0) in the order (dist asc, slot asc, expanded desc);
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
//      in (dist, slot) order, adjacent copies killed, compacted, cut to kr.
// The order of step 1 is total up to rows equal in every field, so the
// merge of two sorted runs gives the full sort's sequence bit for bit.
//
// Design: one block of K4_THREADS = 128 threads per query over 64-bit keys
// in shared memory (beam_merge.cuh, whose merge body K5 shares; 128 threads
// took less device time than 64 or 256, PERF.md). The beam arrives
// sorted (the previous step's window): one pass of adjacent compares
// checks it, and only a beam that does not ascend is sorted. The ew
// candidates are sorted as runs of 32 in registers (warp shuffles) and
// merged by merge path, log2(ew / 32) barriered levels; one more merge
// path joins them with the beam. Then the dead rows are marked, the live
// ones placed by a block prefix sum, and the selection runs over the
// compacted window with a second one. Fused mode carries each candidate's
// admission flag in the lowest bit of its key while it is sorted (the bit
// is "not expanded", 1 for every candidate, and is restored for the beam
// merge), so the admitted candidates come out of the sorted run already
// in (dist, slot) order: a prefix sum compacts them, and one merge path
// joins them with the result set (sorted when it does not ascend).

#include "beam_merge.cuh"
#include "scan_tile.cuh"

constexpr int K4_THREADS = 128;    // threads a query (one query a block)

__global__ void __launch_bounds__(K4_THREADS) beam_merge_kernel(
    const float* __restrict__ bd, const int* __restrict__ bs, const int* __restrict__ be,
    const float* __restrict__ nd, const int* __restrict__ ns,
    const float* __restrict__ rd, const int* __restrict__ rs, const int* __restrict__ adm,
    int ef, int ew, int expand, int stop, int kr, int fused,
    float* __restrict__ od, int* __restrict__ os, int* __restrict__ oe,
    int* __restrict__ misc, float* __restrict__ ord, int* __restrict__ ors)
{
    extern __shared__ u64 smem[];
    __shared__ MergeScratch sc;
    const MergeBufs bufs = merge_bufs(smem, ef, ew);

    const int tid = threadIdx.x;
    const long long q = blockIdx.x;
    const int nc = merge_run(ew);
    const u64 pad_beam = beam_key(CUDART_INF_F, SENT_SLOT, 0);

    // 1. the beam's keys and the candidates' (fused: the admission flag in
    //    the lowest bit), the candidates padded to whole runs
    for (int i = tid; i < ef; i += blockDim.x) {
        bufs.beam[i] = beam_key(bd[q * ef + i], bs[q * ef + i], be[q * ef + i]);
    }
    for (int i = tid; i < nc; i += blockDim.x) {
        u64 k = pad_beam;
        if (i < ew) k = beam_key(nd[q * ew + i], ns[q * ew + i], 0);
        if (fused) k = (k & ~1ull) | (i < ew && adm[q * ew + i] != 0 ? 1ull : 0ull);
        bufs.cand[i] = k;
    }
    // 2-4. sort the candidates, merge, kill, compact, select
    const u64* cand = merge_select(bufs, ef, ew, expand, stop, q, od, os, oe, misc, &sc);
    if (!fused) return;

    // 5. the result set: kr sorted rows + the admitted candidates
    const int nr = merge_run(kr);
    u64* res = bufs.merged + ef + nc;      // nr
    u64* rtmp = res + nr;                  // nr
    u64* adm_run = rtmp + nr;              // nc
    u64* rmerged = adm_run + nc;           // kr + nc
    u64* rwin = rmerged + kr + nc;         // kr
    const u64 pad_res = res_key(CUDART_INF_F, SENT_SLOT);
    for (int i = tid; i < kr; i += blockDim.x) res[i] = res_key(rd[q * kr + i], rs[q * kr + i]);
    const int per = (nc + blockDim.x - 1) / blockDim.x;
    const int lo = min(nc, tid * per);
    const int hi = min(nc, lo + per);
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += (int)(cand[i] & 1ull);
    int n_adm;
    int pos = block_exclusive_scan(mine, sc.warp_sums, &n_adm);
    for (int i = lo; i < hi; ++i) {
        const u64 k = cand[i];
        if (k & 1ull) adm_run[pos++] = ((k >> 32) << 32) | ((k >> 1) & 0x7FFFFFFFull);
    }
    __syncthreads();
    const u64* rsorted = block_sorted_run(res, rtmp, kr, pad_res);
    block_merge(rsorted, kr, adm_run, n_adm, 0ull, rmerged);
    kill_compact(rmerged, kr + n_adm, 0, rwin, kr, pad_res, sc.warp_sums);
    for (int i = tid; i < kr; i += blockDim.x) {
        const u64 k = rwin[i];
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
    size_t keys = (size_t)merge_keys(ef, ew);
    if (fused) keys += 2 * (size_t)merge_run(kr) + 2 * (size_t)merge_run(ew) + 2 * (size_t)kr;
    const size_t smem = sizeof(u64) * keys;
    const int attr = smem_attr<beam_merge_kernel>(smem);
    if (attr != 0) return attr;
    beam_merge_kernel<<<Q, K4_THREADS, smem, (cudaStream_t)stream>>>(
        bd, bs, be, nd, ns, rd, rs, adm, ef, ew, expand, stop, kr, fused,
        od, os, oe, misc, ord, ors);
    return (int)cudaGetLastError();
}
