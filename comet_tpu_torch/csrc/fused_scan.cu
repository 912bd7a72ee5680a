// K2: fused exact distance scan with masking and per-group minima.
//
// Replaces comet_tpu/ops/pallas_scan.py:_kernel, the Pallas kernel launched
// by fused_dist_select, in its three forms: the flat mode and the nprobe
// (IVF) mode over a float32 corpus, and the flat mode's bf16 operand
// (:82-93, flat `storage="bfloat16"`), where the queries are rounded to
// bf16 for the product, the products accumulate in float32 and qn stays
// the norm of the float32 queries (:187).
//
// For every query q and corpus row n it computes ip = q . x_n in float32
// with FMA on the CUDA cores (no TF32: a lower-precision product flips
// neighbour order, see ops/distance.py), then the reference's epilogue in
// its order of operations (scan_tile.cuh):
//   L2:     max((qn + mask[n]) - 2 * ip, 0)     mask = squared norm, +inf if invalid
//   cosine: (1 - clip(ip, -1, 1)) + mask[n]     mask = 0, +inf if invalid
// followed by the threshold (dist > thr -> +inf) and, in nprobe mode, +inf
// where row n's cluster assign[n] is not among query q's probes. It writes
// dist [Q, N] and the minimum of every 128-row group into gmin [Q, N / 128].
// The top-kb group choice runs afterwards, in K1 (topk.cu): the TPU kernel
// kept a running top-kb only because its grid ran in order, while these
// blocks run independently.
//
// What bounds it on an H100: 2 * Q * N * d float32 operations against a
// Q * N * 4-byte distance write and an N * d * 4-byte corpus read per
// query block, so at d = 128 the CUDA-core FMA rate bounds it (about 64
// operations per byte written). In nprobe mode the function needs only the
// products of rows in a query's probed clusters (about 1 % of them at
// nprobe 10 of 1024 lists), so the distance write bounds it; this kernel
// still computes every product, adding one 4-byte cluster id per row and
// one bit test per distance, and so takes the flat mode's time.
//
// bf16 operand: the same tile with T = bf16_t. scan_tile.cuh widens bf16
// to float32 as it stages the slices, so each distance is the `dot_fma`
// chain from 0 in ascending depth over exact bf16 products, the order of
// ops/distance.bf16_dot, the plain version's. Bytes halve on the corpus;
// the CUDA-core FMA rate bounds it as in float32 (the TPU's bf16 MXU pass
// has no counterpart here: a tensor-core product would sum in another
// order).
//
// Design: a classic register-tiled product (scan_tile.cuh). A block owns
// 64 queries x 128 corpus rows (exactly one selection group), stages
// 32-wide slices of the depth through shared memory, and each of its 256
// threads accumulates a 4 x 8 tile in registers. The epilogue reduces each
// thread's 8 distances to a minimum and finishes the group minimum with
// warp shuffles, so gmin costs no extra pass over dist. Blocks are ordered
// query-block fastest, so the blocks that read one corpus tile run close
// together and share it through L2.
//
// nprobe mode: the Pallas kernel ORs nprobe compares per element. Here the
// wrapper turns each query's probes into a bitmask of ceil(nlist / 32)
// words (ops/fused_scan._probe_words, nlist / 8 bytes per query),
// so membership is one bit test per element whatever nprobe is: the row's
// cluster id is loaded once per thread and row, the word through the
// read-only cache, where a 256-query chunk's masks (256 x nlist / 8 bytes)
// stay resident.

#include "scan_tile.cuh"

template <int MODE, typename T>
__global__ void __launch_bounds__(SCAN_THREADS) fused_scan_kernel(
    const T* __restrict__ q, const float* __restrict__ qn,
    const T* __restrict__ x, const float* __restrict__ mask, float thr,
    int Q, int N, int d, int cosine, const int* __restrict__ assign,
    const unsigned* __restrict__ words, int n_words,
    float* __restrict__ dist, float* __restrict__ gmin)
{
    const int n_qblocks = (Q + SCAN_BM - 1) / SCAN_BM;
    const int qb = blockIdx.x % n_qblocks;
    const int g = blockIdx.x / n_qblocks;
    const int q0 = qb * SCAN_BM;
    const long long n0 = (long long)g * SCAN_BN;
    scan_tile<MODE, T>(
        q + (long long)q0 * d, qn + q0, min(SCAN_BM, Q - q0),
        x + n0 * d, mask + n0, d, thr, cosine,
        MODE == SCAN_ROW_BITS ? assign + n0 : nullptr,
        MODE == SCAN_ROW_BITS ? words + (long long)q0 * n_words : nullptr,
        n_words, nullptr,
        dist + (long long)q0 * N + n0, N,
        gmin + (long long)q0 * (N / SCAN_BN) + g, N / SCAN_BN);
}

// assign == NULL: flat mode; otherwise nprobe mode with `words`, n_words
// 32-bit words of probe bits per query. q [Q, d] and x [N, d] are float32,
// or bfloat16 when bf16 != 0 (flat mode only).
extern "C" int comet_fused_scan(
    const void* q, const float* qn, const void* x, const float* mask,
    float thr, int Q, int N, int d, int cosine, int bf16, const int* assign,
    const unsigned* words, int n_words, float* dist, float* gmin,
    void* stream)
{
    if (Q < 1 || N < SCAN_BN || N % SCAN_BN != 0 || d < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (assign != nullptr && (words == nullptr || n_words < 1 || bf16)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = (long long)((Q + SCAN_BM - 1) / SCAN_BM) * (N / SCAN_BN);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (bf16) {
        fused_scan_kernel<SCAN_ALL, bf16_t><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(
            (const bf16_t*)q, qn, (const bf16_t*)x, mask, thr, Q, N, d, cosine, nullptr,
            nullptr, 0, dist, gmin);
    } else if (assign == nullptr) {
        fused_scan_kernel<SCAN_ALL, float><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(
            (const float*)q, qn, (const float*)x, mask, thr, Q, N, d, cosine, nullptr,
            nullptr, 0, dist, gmin);
    } else {
        fused_scan_kernel<SCAN_ROW_BITS, float><<<(unsigned)blocks, SCAN_THREADS, 0, s>>>(
            (const float*)q, qn, (const float*)x, mask, thr, Q, N, d, cosine, assign, words,
            n_words, dist, gmin);
    }
    return (int)cudaGetLastError();
}
