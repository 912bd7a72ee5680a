// K2: fused exact distance scan with masking and per-group minima.
//
// Replaces comet_tpu/ops/pallas_scan.py:_kernel, the Pallas kernel launched
// by fused_dist_select (flat mode, float32 corpus).
//
// For every query q and corpus row n it computes ip = q . x_n in float32
// with FMA on the CUDA cores (no TF32: a lower-precision product flips
// neighbour order, see ops/distance.py), then the reference's epilogue in
// its order of operations:
//   L2:     max((qn + mask[n]) - 2 * ip, 0)     mask = squared norm, +inf if invalid
//   cosine: (1 - clip(ip, -1, 1)) + mask[n]     mask = 0, +inf if invalid
// followed by the threshold (dist > thr -> +inf). It writes dist [Q, N] and
// the minimum of every 128-row group into gmin [Q, N / 128]. The top-kb
// group choice runs afterwards, in K1 (topk.cu): the TPU kernel kept a
// running top-kb only because its grid ran in order, while these blocks
// run independently.
//
// What bounds it on an H100: 2 * Q * N * d float32 operations against a
// Q * N * 4-byte distance write and an N * d * 4-byte corpus read per
// query block, so at d = 128 the CUDA-core FMA rate bounds it (about 64
// operations per byte written).
//
// Design: a classic register-tiled product. A block owns 64 queries x 128
// corpus rows (exactly one selection group), stages 32-wide slices of the
// depth through shared memory, and each of its 256 threads accumulates a
// 4 x 8 tile in registers. The epilogue reduces each thread's 8 distances to
// a minimum and finishes the group minimum with warp shuffles, so gmin
// costs no extra pass over dist. Blocks are ordered query-block fastest, so
// the blocks that read one corpus tile run close together and share it
// through L2.

#include <cuda_runtime.h>
#include <math_constants.h>

#define BM 64    // queries per block
#define BN 128   // corpus rows per block = one selection group
#define BK 32    // depth slice staged in shared memory
#define TM 4     // queries per thread
#define TN 8     // corpus rows per thread

__global__ void __launch_bounds__(256) fused_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ qn,
    const float* __restrict__ x, const float* __restrict__ mask, float thr,
    int Q, int N, int d, int cosine, float* __restrict__ dist,
    float* __restrict__ gmin)
{
    __shared__ __align__(16) float As[BK][BM];
    __shared__ __align__(16) float Bs[BK][BN + 4];

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int n_qblocks = (Q + BM - 1) / BM;
    const int qb = blockIdx.x % n_qblocks;
    const int g = blockIdx.x / n_qblocks;
    const int q0 = qb * BM;
    const long long n0 = (long long)g * BN;

    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < d; k0 += BK) {
        for (int e = tid; e < BM * BK; e += 256) {
            const int r = e / BK;
            const int c = e % BK;
            const int gq = q0 + r;
            const int gk = k0 + c;
            As[c][r] = (gq < Q && gk < d) ? q[(long long)gq * d + gk] : 0.0f;
        }
        for (int e = tid; e < BN * BK; e += 256) {
            const int r = e / BK;
            const int c = e % BK;
            const int gk = k0 + c;
            Bs[c][r] = gk < d ? x[(n0 + r) * d + gk] : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM];
            float b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j)
                    acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

    float m_row[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) m_row[j] = mask[n0 + tx * TN + j];

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int gq = q0 + ty * TM + i;
        const float qni = gq < Q ? qn[gq] : 0.0f;
        float out[TN];
        float m = CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const float ip = acc[i][j];
            float dd;
            if (cosine) {
                const float c = fminf(fmaxf(ip, -1.0f), 1.0f);
                dd = (1.0f - c) + m_row[j];
            } else {
                const float s = qni + m_row[j];
                dd = fmaxf(s - 2.0f * ip, 0.0f);
            }
            dd = dd <= thr ? dd : CUDART_INF_F;
            out[j] = dd;
            m = fminf(m, dd);
        }
        if (gq < Q) {
            float4* dst = reinterpret_cast<float4*>(
                dist + (long long)gq * N + n0 + tx * TN);
            dst[0] = make_float4(out[0], out[1], out[2], out[3]);
            dst[1] = make_float4(out[4], out[5], out[6], out[7]);
        }
        // the 16 threads of one query row are lanes 0-15 or 16-31 of a warp
#pragma unroll
        for (int off = 8; off >= 1; off >>= 1)
            m = fminf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
        if (tx == 0 && gq < Q) gmin[(long long)gq * (N / BN) + g] = m;
    }
}

extern "C" int comet_fused_scan(
    const float* q, const float* qn, const float* x, const float* mask,
    float thr, int Q, int N, int d, int cosine, float* dist, float* gmin,
    void* stream)
{
    if (Q < 1 || N < BN || N % BN != 0 || d < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const long long blocks = (long long)((Q + BM - 1) / BM) * (N / BN);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    fused_scan_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        q, qn, x, mask, thr, Q, N, d, cosine, dist, gmin);
    return (int)cudaGetLastError();
}
