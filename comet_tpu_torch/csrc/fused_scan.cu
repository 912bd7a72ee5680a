// K2: fused exact distance scan with masking and per-group minima.
//
// Replaces comet_tpu/ops/pallas_scan.py:_kernel, the Pallas kernel launched
// by fused_dist_select, in its three forms: the flat mode and the nprobe
// (IVF) mode over a float32 corpus, and the flat mode's bf16 operand
// (:82-93, flat `storage="bfloat16"`), where the queries are rounded to
// bf16 for the product, the products accumulate in float32 and qn stays
// the norm of the float32 queries (:187); and the float16 and int8 scans
// of flat storage, which the reference runs in XLA (see below).
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
// 128-query block, so at d = 128 the CUDA-core FMA rate bounds it (256 x 1M
// x 128 is 68.7 GFLOP, 1.026 ms at 67 TFLOP/s; the 1 GiB distance write
// alone is 0.32 ms). In nprobe mode the function needs only the products
// of rows in a query's probed clusters (about 1 % of them at nprobe 10 of
// 1024 lists), so the distance write bounds it; this kernel still computes
// every product, adding one 4-byte cluster id per row and one bit test per
// distance, and so takes the flat mode's time. The bf16 operand halves the
// corpus bytes and float16 as well, int8 quarters them; the CUDA-core FMA
// rate bounds them all as in float32 (the TPU's bf16 MXU pass has no
// counterpart here: a tensor-core product would sum in another order).
// Every product of two bf16, two float16 or a bf16 and an int8 value is
// exact in float32, so each operand's distances are bit-equal to its plain
// version (ops/distance.bf16_dot, f16_dot), which adds them in the same
// ascending order.
//
// float16 and int8: the reference scans these storages outside Pallas
// (`block_topk`, comet_tpu/ops/topk.py:155, through
// `pairwise_scores_from_norms`, comet_tpu/ops/distance.py:60-96):
//   float16: queries rounded to float16, float16 x float16 products summed
//            in float32, qn of the float32 queries;
//   int8:    queries rounded to bf16, the int8 rows widened exactly, the
//            float32 sum multiplied by the corpus's abs-max `scale` before
//            the epilogue, whose mask holds the dequantised squared norms.
// A library matrix product does neither: a float16 torch.matmul returns a
// float16 product, and int8 x bf16 has no single library call.
//
// Design: the register-tiled product of fused_tile.cuh (see the note
// there): a block owns 128 queries x 128 corpus rows (exactly one
// selection group), 256 threads each accumulate an 8 x 8 tile, 16-deep
// slices are double-buffered in shared memory with the next slice's loads
// in flight during this slice's FMAs. Each distance is the `dot_fma` chain
// from 0 in ascending depth, as in K3's tile (ivf_sparse.cu), so both give
// bit-equal distances. The epilogue reduces
// each thread's 8 distances of a query to a minimum and finishes the group
// minimum with warp shuffles, so gmin costs no extra pass over dist. Blocks
// are ordered query-block fastest, so the blocks that read one corpus tile
// run close together and share it through L2. No TF32 and no tensor-core
// product: a lower-precision product or another sum order flips neighbour
// order (ops/distance.py).
//
// nprobe mode: the Pallas kernel ORs nprobe compares per element. Here the
// wrapper turns each query's probes into a bitmask of ceil(nlist / 32)
// words (ops/fused_scan._probe_words, nlist / 8 bytes per query),
// so membership is one bit test per element whatever nprobe is: the row's
// cluster id is loaded once per thread and row, the word through the
// read-only cache, where a 256-query chunk's masks (256 x nlist / 8 bytes)
// stay resident.

#include <stdint.h>

#include "fused_tile.cuh"

template <int MODE, typename TQ, typename TX, bool VEC>
__global__ void __launch_bounds__(FT_THREADS, 2) fused_scan_kernel(
    const TQ* __restrict__ q, const float* __restrict__ qn,
    const TX* __restrict__ x, const float* __restrict__ mask, float thr,
    int Q, int N, int d, int cosine, float scale, const int* __restrict__ assign,
    const unsigned* __restrict__ words, int n_words,
    float* __restrict__ dist, float* __restrict__ gmin)
{
    const int n_qblocks = (Q + FT_BM - 1) / FT_BM;
    const int qb = blockIdx.x % n_qblocks;
    const int g = blockIdx.x / n_qblocks;
    const int q0 = qb * FT_BM;
    const long long n0 = (long long)g * FT_BN;
    fused_tile<MODE, TQ, TX, VEC>(
        q + (long long)q0 * d, qn + q0, min(FT_BM, Q - q0),
        x + n0 * d, mask + n0, d, thr, cosine, scale,
        MODE == SCAN_ROW_BITS ? assign + n0 : nullptr,
        MODE == SCAN_ROW_BITS ? words + (long long)q0 * n_words : nullptr, n_words,
        dist + (long long)q0 * N + n0, N,
        gmin + (long long)q0 * (N / FT_BN) + g, N / FT_BN);
}

// Whether rows of d values of type T starting at p take vector loads.
template <typename T>
static bool vec_ok(const void* p, int d)
{
    return d % ft_width<T>::VW == 0 && (uintptr_t)p % ft_width<T>::BYTES == 0;
}

template <int MODE, typename TQ, typename TX>
static void launch(unsigned blocks, cudaStream_t s, const void* q, const float* qn,
                   const void* x, const float* mask, float thr, int Q, int N, int d,
                   int cosine, float scale, const int* assign, const unsigned* words,
                   int n_words, float* dist, float* gmin)
{
    if (vec_ok<TQ>(q, d) && vec_ok<TX>(x, d)) {
        fused_scan_kernel<MODE, TQ, TX, true><<<blocks, FT_THREADS, 0, s>>>(
            (const TQ*)q, qn, (const TX*)x, mask, thr, Q, N, d, cosine, scale, assign,
            words, n_words, dist, gmin);
    } else {
        fused_scan_kernel<MODE, TQ, TX, false><<<blocks, FT_THREADS, 0, s>>>(
            (const TQ*)q, qn, (const TX*)x, mask, thr, Q, N, d, cosine, scale, assign,
            words, n_words, dist, gmin);
    }
}

// Operand codes of comet_fused_scan: the types of q [Q, d] and x [N, d].
enum { OP_F32 = 0, OP_BF16 = 1, OP_F16 = 2, OP_INT8 = 3 };

// assign == NULL: flat mode; otherwise nprobe mode with `words`, n_words
// 32-bit words of probe bits per query (float32 operands only). `operand`:
// OP_F32 (q, x float32), OP_BF16 (both bfloat16), OP_F16 (both float16) or
// OP_INT8 (q bfloat16, x int8, inner products times `scale`).
extern "C" int comet_fused_scan(
    const void* q, const float* qn, const void* x, const float* mask,
    float thr, int Q, int N, int d, int cosine, int operand, float scale,
    const int* assign, const unsigned* words, int n_words, float* dist, float* gmin,
    void* stream)
{
    if (Q < 1 || N < FT_BN || N % FT_BN != 0 || d < 1 || operand < OP_F32 ||
        operand > OP_INT8) {
        return (int)cudaErrorInvalidValue;
    }
    if (assign != nullptr && (words == nullptr || n_words < 1 || operand != OP_F32)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = (long long)((Q + FT_BM - 1) / FT_BM) * (N / FT_BN);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const unsigned b = (unsigned)blocks;
    if (operand == OP_BF16) {
        launch<SCAN_ALL, bf16_t, bf16_t>(b, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                         nullptr, nullptr, 0, dist, gmin);
    } else if (operand == OP_F16) {
        launch<SCAN_ALL, half_t, half_t>(b, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                         nullptr, nullptr, 0, dist, gmin);
    } else if (operand == OP_INT8) {
        launch<SCAN_ALL, bf16_t, i8_t>(b, s, q, qn, x, mask, thr, Q, N, d, cosine, scale,
                                       nullptr, nullptr, 0, dist, gmin);
    } else if (assign == nullptr) {
        launch<SCAN_ALL, float, float>(b, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                       nullptr, nullptr, 0, dist, gmin);
    } else {
        launch<SCAN_ROW_BITS, float, float>(b, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                            assign, words, n_words, dist, gmin);
    }
    return (int)cudaGetLastError();
}
