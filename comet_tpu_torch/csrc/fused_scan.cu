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
//
// A few queries (Q <= FEWQ_Q_MAX; ops/fused_scan.py picks the route): one
// query over a corpus needs one read of it (524,288 x 128 float32 rows are
// 268 MB, 81 us at 3.35 TB/s) and 2 N d operations, so device memory bounds
// it, and a 128-query tile would compute 127 query rows of FMAs for
// nothing. The few-query tile (`fewq_scan_kernel`) owns one 128-row group
// and streams it through shared memory in stages of FQ_ROW_BYTES of every
// row (32 float32, 64 bf16 or float16, 128 int8 depths), FQ_STAGES - 1 of
// them in flight (cp.async, 16 bytes a copy, eight lanes a row's 128
// contiguous bytes, so every line fetched is used whole at once) while one
// is multiplied; the queries' same depths are copied beside them. Each
// thread keeps one row and QPT queries (the block's two halves take
// queries [0, QPT) and [QPT, 2 QPT)): it reads its row 16 bytes at a time
// (a pitch of FQ_PITCH keeps eight rows' reads on distinct banks), widens
// the values exactly, and reads each query's as broadcasts. Rows that are
// not 16-byte aligned are copied element by element instead. Every
// distance is the same dot_fma chain from 0 in ascending depth, with the
// same epilogue (depth past d pads with zeros, which leave a sum that is
// never -0.0 unchanged), so both routes give bit-equal dist and gmin on
// any data. The group minimum is a warp reduction and one across the
// block's four warps of a half.

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

#define FEWQ_Q_MAX 32   // queries the few-query tile takes at most
#define FQ_STAGES 3     // depth stages a block has in flight
#define FQ_ROW_BYTES 128                 // bytes of each row a stage holds
#define FQ_PITCH (FQ_ROW_BYTES + 16)     // their pitch in shared memory

// One 16-byte copy from device to shared memory, past L1; zeros when !ok.
__device__ __forceinline__ void fq_copy16(void* dst, const void* src, bool ok)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void fq_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fq_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The float32 values of 16 bytes of T: 4, 8 or 16 of them.
template <typename T>
__device__ __forceinline__ void fq_unpack(uint4 w, float* v)
{
    ft_unpack<T>(w, v);
    if constexpr (sizeof(T) == 1) ft_unpack<T>(make_uint4(w.z, w.w, 0u, 0u), v + 8);
}

// An element of T as raw bits, for the scalar copies.
template <int B> struct fq_bits;
template <> struct fq_bits<1> { typedef unsigned char T; };
template <> struct fq_bits<2> { typedef unsigned short T; };
template <> struct fq_bits<4> { typedef unsigned T; };

// A stage's layout: K depths of the group's FT_BN rows (FQ_ROW_BYTES each,
// at FQ_PITCH), then the same depths of 2 QPT queries (Q_ROW bytes each).
template <typename TQ, typename TX, int QPT>
struct fq_smem {
    static constexpr int K = FQ_ROW_BYTES / (int)sizeof(TX);
    static constexpr int X_BYTES = FT_BN * FQ_PITCH;
    static constexpr int Q_ROW = K * (int)sizeof(TQ);
    static constexpr int STAGE = X_BYTES + 2 * QPT * Q_ROW;
    static constexpr int BYTES = FQ_STAGES * STAGE;
};

// Starts the copy of depths [k0, k0 + K) of the group's rows (xg, row
// stride d) and of the queries into stage `st`, zeros past d and past Q:
// cp.async where rows are 16-byte aligned (VEC), else element by element.
template <typename TQ, typename TX, bool VEC, int QPT>
__device__ __forceinline__ void fq_stage_load(unsigned char* st, const TX* __restrict__ xg,
                                              const TQ* __restrict__ q, int Q, int d, int k0)
{
    typedef fq_smem<TQ, TX, QPT> S;
    unsigned char* qs = st + S::X_BYTES;
    if constexpr (VEC) {
        constexpr int XV = 16 / (int)sizeof(TX), XC = FQ_ROW_BYTES / 16;
#pragma unroll
        for (int i = 0; i < FT_BN * XC / FT_THREADS; ++i) {
            const int u = threadIdx.x + i * FT_THREADS;
            const int row = u / XC, k = k0 + (u % XC) * XV;
            fq_copy16(st + row * FQ_PITCH + (u % XC) * 16,
                      k < d ? (const void*)(xg + (long long)row * d + k) : (const void*)xg, k < d);
        }
        constexpr int QV = 16 / (int)sizeof(TQ), QC = S::Q_ROW / 16;
        for (int u = threadIdx.x; u < 2 * QPT * QC; u += FT_THREADS) {
            const int qi = u / QC, k = k0 + (u % QC) * QV;
            const bool ok = qi < Q && k < d;
            fq_copy16(qs + qi * S::Q_ROW + (u % QC) * 16,
                      ok ? (const void*)(q + (long long)qi * d + k) : (const void*)q, ok);
        }
    } else {
        typedef typename fq_bits<sizeof(TX)>::T BX;
        typedef typename fq_bits<sizeof(TQ)>::T BQ;
        for (int u = threadIdx.x; u < FT_BN * S::K; u += FT_THREADS) {
            const int row = u / S::K, kk = u % S::K;
            reinterpret_cast<BX*>(st + row * FQ_PITCH)[kk] = k0 + kk < d
                ? reinterpret_cast<const BX*>(xg)[(long long)row * d + k0 + kk] : BX(0);
        }
        for (int u = threadIdx.x; u < 2 * QPT * S::K; u += FT_THREADS) {
            const int qi = u / S::K, kk = u % S::K;
            reinterpret_cast<BQ*>(qs + qi * S::Q_ROW)[kk] = qi < Q && k0 + kk < d
                ? reinterpret_cast<const BQ*>(q)[(long long)qi * d + k0 + kk] : BQ(0);
        }
    }
}

template <int MODE, typename TQ, typename TX, bool VEC, int QPT>
__global__ void __launch_bounds__(FT_THREADS) fewq_scan_kernel(
    const TQ* __restrict__ q, const float* __restrict__ qn,
    const TX* __restrict__ x, const float* __restrict__ mask, float thr,
    int Q, int N, int d, int cosine, float scale, const int* __restrict__ assign,
    const unsigned* __restrict__ words, int n_words,
    float* __restrict__ dist, float* __restrict__ gmin)
{
    typedef fq_smem<TQ, TX, QPT> S;
    extern __shared__ __align__(16) unsigned char fq_stages[];
    __shared__ float s_min[2 * QPT][FT_BN / 32];
    const int tid = threadIdx.x;
    const int row = tid % FT_BN;
    const int h = tid / FT_BN;
    const int g = blockIdx.x;
    const long long n0 = (long long)g * FT_BN;
    const TX* xg = x + n0 * d;
    const int n_st = (d + S::K - 1) / S::K;

    float acc[QPT];
#pragma unroll
    for (int j = 0; j < QPT; ++j) acc[j] = 0.0f;
    // This thread's row against its QPT queries over one stage, in
    // ascending depth: 16 bytes of the row at a time (conflict-free at
    // FQ_PITCH), each query's values read as broadcasts.
    auto compute = [&](const unsigned char* st) {
        constexpr int XV = 16 / (int)sizeof(TX), QB = XV * (int)sizeof(TQ);
        constexpr int QV = 16 / (int)sizeof(TQ);
        const unsigned char* xr = st + row * FQ_PITCH;
        const unsigned char* qb = st + S::X_BYTES + h * QPT * S::Q_ROW;
#pragma unroll
        for (int c = 0; c < FQ_ROW_BYTES / 16; ++c) {
            float xv[XV];
            fq_unpack<TX>(*reinterpret_cast<const uint4*>(xr + c * 16), xv);
#pragma unroll
            for (int j = 0; j < QPT; ++j) {
                float qv[XV];
#pragma unroll
                for (int t = 0; t < QB / 16; ++t) {
                    const unsigned char* p = qb + j * S::Q_ROW + c * QB + t * 16;
                    fq_unpack<TQ>(*reinterpret_cast<const uint4*>(p), qv + t * QV);
                }
#pragma unroll
                for (int e = 0; e < XV; ++e) acc[j] = dot_fma(qv[e], xv[e], acc[j]);
            }
        }
    };

    // FQ_STAGES - 1 stages in flight while one is multiplied.
#pragma unroll
    for (int s = 0; s < FQ_STAGES - 1; ++s) {
        if (s < n_st)
            fq_stage_load<TQ, TX, VEC, QPT>(fq_stages + s * S::STAGE, xg, q, Q, d, s * S::K);
        fq_commit();
    }
    for (int s = 0; s < n_st; ++s) {
        fq_wait<FQ_STAGES - 2>();
        __syncthreads();   // stage s is in; stage s - 1's buffer is free
        const int nx = s + FQ_STAGES - 1;
        if (nx < n_st)
            fq_stage_load<TQ, TX, VEC, QPT>(fq_stages + (nx % FQ_STAGES) * S::STAGE, xg, q, Q, d,
                                            nx * S::K);
        fq_commit();
        compute(fq_stages + (s % FQ_STAGES) * S::STAGE);
    }

    const float m_row = mask[n0 + row];
    const int a_row = MODE == SCAN_ROW_BITS ? assign[n0 + row] : 0;
#pragma unroll
    for (int j = 0; j < QPT; ++j) {
        const int qi = h * QPT + j;
        const bool qok = qi < Q;
        const float ip = sizeof(TX) == 1 ? acc[j] * scale : acc[j];
        float dd = scan_distance(ip, qok ? qn[qi] : 0.0f, m_row, thr, cosine);
        if (MODE == SCAN_ROW_BITS) {
            const bool in = qok && probe_in(words + (long long)qi * n_words, n_words, a_row);
            dd = in ? dd : CUDART_INF_F;
        }
        if (qok) dist[(long long)qi * N + n0 + row] = dd;
        float m = dd;
#pragma unroll
        for (int off = 16; off >= 1; off >>= 1) m = fminf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
        if ((tid & 31) == 0) s_min[qi][row >> 5] = m;
    }
    __syncthreads();
    const long long n_groups = N / FT_BN;
    for (int qi = tid; qi < Q && qi < 2 * QPT; qi += FT_THREADS) {
        float m = s_min[qi][0];
#pragma unroll
        for (int w = 1; w < FT_BN / 32; ++w) m = fminf(m, s_min[qi][w]);
        gmin[qi * n_groups + g] = m;
    }
}

// Whether rows of d values of type T starting at p take the 128-query
// tile's vector loads.
template <typename T>
static bool vec_ok(const void* p, int d)
{
    return d % ft_width<T>::VW == 0 && (uintptr_t)p % ft_width<T>::BYTES == 0;
}

// Whether rows of d values of type T starting at p take 16-byte copies.
template <typename T>
static bool vec16_ok(const void* p, int d)
{
    return (d * (int)sizeof(T)) % 16 == 0 && (uintptr_t)p % 16 == 0;
}

template <int MODE, typename TQ, typename TX, bool VEC, int QPT>
static int launch_fewq(unsigned blocks, cudaStream_t s, const void* q, const float* qn,
                       const void* x, const float* mask, float thr, int Q, int N, int d,
                       int cosine, float scale, const int* assign, const unsigned* words,
                       int n_words, float* dist, float* gmin)
{
    constexpr int smem = fq_smem<TQ, TX, QPT>::BYTES;
    const int err = smem_attr<fewq_scan_kernel<MODE, TQ, TX, VEC, QPT>>(smem);
    if (err != 0) return err;
    fewq_scan_kernel<MODE, TQ, TX, VEC, QPT><<<blocks, FT_THREADS, smem, s>>>(
        (const TQ*)q, qn, (const TX*)x, mask, thr, Q, N, d, cosine, scale, assign,
        words, n_words, dist, gmin);
    return 0;
}

template <int MODE, typename TQ, typename TX, int QPT>
static int launch_fewq_vec(unsigned blocks, cudaStream_t s, const void* q, const float* qn,
                           const void* x, const float* mask, float thr, int Q, int N, int d,
                           int cosine, float scale, const int* assign, const unsigned* words,
                           int n_words, float* dist, float* gmin)
{
    if (vec16_ok<TQ>(q, d) && vec16_ok<TX>(x, d)) {
        return launch_fewq<MODE, TQ, TX, true, QPT>(blocks, s, q, qn, x, mask, thr, Q, N, d,
                                                    cosine, scale, assign, words, n_words, dist,
                                                    gmin);
    }
    return launch_fewq<MODE, TQ, TX, false, QPT>(blocks, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                                 scale, assign, words, n_words, dist, gmin);
}

// The 128-query tile, or (fewq) the few-query tile with the fewest
// queries a thread that cover Q. Returns a CUDA error code.
template <int MODE, typename TQ, typename TX>
static int launch(bool fewq, cudaStream_t s, const void* q, const float* qn,
                  const void* x, const float* mask, float thr, int Q, int N, int d,
                  int cosine, float scale, const int* assign, const unsigned* words,
                  int n_words, float* dist, float* gmin)
{
    const unsigned groups = (unsigned)(N / FT_BN);
    if (!fewq) {
        const unsigned blocks = (unsigned)((Q + FT_BM - 1) / FT_BM) * groups;
        if (vec_ok<TQ>(q, d) && vec_ok<TX>(x, d)) {
            fused_scan_kernel<MODE, TQ, TX, true><<<blocks, FT_THREADS, 0, s>>>(
                (const TQ*)q, qn, (const TX*)x, mask, thr, Q, N, d, cosine, scale, assign,
                words, n_words, dist, gmin);
        } else {
            fused_scan_kernel<MODE, TQ, TX, false><<<blocks, FT_THREADS, 0, s>>>(
                (const TQ*)q, qn, (const TX*)x, mask, thr, Q, N, d, cosine, scale, assign,
                words, n_words, dist, gmin);
        }
        return 0;
    }
    if (Q <= 2) {
        return launch_fewq_vec<MODE, TQ, TX, 1>(groups, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                                scale, assign, words, n_words, dist, gmin);
    } else if (Q <= 8) {
        return launch_fewq_vec<MODE, TQ, TX, 4>(groups, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                                scale, assign, words, n_words, dist, gmin);
    } else if (Q <= 16) {
        return launch_fewq_vec<MODE, TQ, TX, 8>(groups, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                                scale, assign, words, n_words, dist, gmin);
    }
    return launch_fewq_vec<MODE, TQ, TX, 16>(groups, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                             scale, assign, words, n_words, dist, gmin);
}

// Operand codes of comet_fused_scan: the types of q [Q, d] and x [N, d].
enum { OP_F32 = 0, OP_BF16 = 1, OP_F16 = 2, OP_INT8 = 3 };

// assign == NULL: flat mode; otherwise nprobe mode with `words`, n_words
// 32-bit words of probe bits per query (float32 operands only). `operand`:
// OP_F32 (q, x float32), OP_BF16 (both bfloat16), OP_F16 (both float16) or
// OP_INT8 (q bfloat16, x int8, inner products times `scale`). `fewq`: the
// few-query tile (Q <= FEWQ_Q_MAX), else the 128-query tile.
extern "C" int comet_fused_scan(
    const void* q, const float* qn, const void* x, const float* mask,
    float thr, int Q, int N, int d, int cosine, int operand, float scale,
    const int* assign, const unsigned* words, int n_words, float* dist, float* gmin,
    int fewq, void* stream)
{
    if (Q < 1 || N < FT_BN || N % FT_BN != 0 || d < 1 || operand < OP_F32 ||
        operand > OP_INT8 || (fewq && Q > FEWQ_Q_MAX)) {
        return (int)cudaErrorInvalidValue;
    }
    if (assign != nullptr && (words == nullptr || n_words < 1 || operand != OP_F32)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = (long long)((Q + FT_BM - 1) / FT_BM) * (N / FT_BN);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const bool fq = fewq != 0;
    int err;
    if (operand == OP_BF16) {
        err = launch<SCAN_ALL, bf16_t, bf16_t>(fq, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                               nullptr, nullptr, 0, dist, gmin);
    } else if (operand == OP_F16) {
        err = launch<SCAN_ALL, half_t, half_t>(fq, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                               nullptr, nullptr, 0, dist, gmin);
    } else if (operand == OP_INT8) {
        err = launch<SCAN_ALL, bf16_t, i8_t>(fq, s, q, qn, x, mask, thr, Q, N, d, cosine, scale,
                                             nullptr, nullptr, 0, dist, gmin);
    } else if (assign == nullptr) {
        err = launch<SCAN_ALL, float, float>(fq, s, q, qn, x, mask, thr, Q, N, d, cosine, 1.0f,
                                             nullptr, nullptr, 0, dist, gmin);
    } else {
        err = launch<SCAN_ROW_BITS, float, float>(fq, s, q, qn, x, mask, thr, Q, N, d, cosine,
                                                  1.0f, assign, words, n_words, dist, gmin);
    }
    if (err != 0) return err;
    return (int)cudaGetLastError();
}
