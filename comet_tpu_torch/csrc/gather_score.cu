// The beam's in-loop scoring: gather the expanded nodes' neighbourhood
// blocks and score them against the queries.
//
// Replaces the scoring of comet_tpu/ops/beam_kernel.py:_gather_score and
// _score_rows (blocked layout), which the reference runs as XLA ops (a row
// gather and a grouped bf16 einsum with a diagonal extract, an MXU trick),
// not as a Pallas kernel. It is here because the seed scan (K3's bf16
// mode) and this scoring must give bit-equal distances for the same
// (query, slot): both use `dot_fma` of scan_tile.cuh, one FMA per depth
// element in ascending order from 0, and every bf16 x bf16 product is
// exact in float32.
//
// For query q, expanded node e = nodes[q, e] (-1 for none) and neighbour
// j < W of that node, with c = e * W + j:
//   slot  = the base-128 digits of aux[node, (1 + i) W + j], i < ndig,
//           minus 1 (-1: an empty adjacency entry)
//   ip    = sum over k of qb[q, k] * nbr_vecs[node, j, k]      (bf16, fp32 FMA)
//   nd    = max((qn[q] + aux[node, j]) - 2 ip, 0)              (aux[node, j] = bf16 sqnorm)
// and where the node is -1 or the slot empty, nd = +inf and ns = SENT.
// With `fused` it also writes the admission flag
//   adm = ok && allowed[slot] && nd <= thr.
// Outputs are query-major [Q, E * W], K4's candidate layout.
//
// What bounds it on an H100: every live candidate reads its d bf16 values
// (256 bytes at d = 128) and the aux row, and writes 12 bytes; at Q =
// 2048, E = 8, W = 32 that is about 137 MB an iteration, 41 us at 3.35
// TB/s, against 2 d operations per candidate (134 MFLOP, 2 us at 67
// TFLOP/s): bytes bound it. The kernel is simple on purpose: one thread
// per candidate runs the FMA chain over its neighbour's row, reading the
// row in 16-byte loads between a scalar head (up to the row's first
// 16-byte boundary) and a scalar tail, so the same code serves every d.

#include "scan_tile.cuh"

#define SCORE_THREADS 256
#define SENT_SLOT 2147483647

__global__ void __launch_bounds__(SCORE_THREADS) gather_score_kernel(
    const bf16_t* __restrict__ qb, const float* __restrict__ qn,
    const bf16_t* __restrict__ nbr_vecs, const bf16_t* __restrict__ aux,
    const int* __restrict__ nodes, const unsigned char* __restrict__ allowed, float thr,
    long long total, int E, int W, int d, int ndig, int fused,
    float* __restrict__ nd, int* __restrict__ ns, int* __restrict__ adm)
{
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int ew = E * W;
    const long long q = t / ew;
    const int c = (int)(t % ew);
    const int e = c / W;
    const int j = c % W;
    const int node = nodes[q * E + e];
    float dist = CUDART_INF_F;
    int slot = SENT_SLOT;
    bool ok = false;
    if (node >= 0) {
        const bf16_t* arow = aux + (long long)node * (1 + ndig) * W;
        float a1 = to_f32(arow[W + j]);
        float scale = 128.0f;
        for (int i = 1; i < ndig; ++i) {
            a1 = a1 + to_f32(arow[(1 + i) * W + j]) * scale;
            scale *= 128.0f;
        }
        const int neigh = (int)a1 - 1;
        if (neigh >= 0) {
            ok = true;
            slot = neigh;
            const bf16_t* x = nbr_vecs + ((long long)node * W + j) * d;
            const bf16_t* qq = qb + q * d;
            float acc = 0.0f;
            int k = 0;
            const int head = min(d, (int)(((16 - ((size_t)x & 15)) & 15) >> 1));
            for (; k < head; ++k) acc = dot_fma(to_f32(qq[k]), to_f32(x[k]), acc);
            for (; k + 8 <= d; k += 8) {
                const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
                const unsigned xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
                for (int h = 0; h < 4; ++h) {
                    acc = dot_fma(to_f32(qq[k + 2 * h]), to_f32((bf16_t)(xs[h] & 0xFFFFu)), acc);
                    acc = dot_fma(to_f32(qq[k + 2 * h + 1]), to_f32((bf16_t)(xs[h] >> 16)), acc);
                }
            }
            for (; k < d; ++k) acc = dot_fma(to_f32(qq[k]), to_f32(x[k]), acc);
            dist = fmaxf((qn[q] + to_f32(arow[j])) - 2.0f * acc, 0.0f);
        }
    }
    nd[t] = dist;
    ns[t] = slot;
    if (fused) adm[t] = (ok && allowed[slot] && dist <= thr) ? 1 : 0;
}

// qb [Q, d] bf16, qn [Q] f32, nbr_vecs [cap, W, d] bf16, aux [cap, (1 +
// ndig) W] bf16, nodes [Q, E] i32, allowed [cap] bool (fused only).
extern "C" int comet_gather_score(
    const void* qb, const float* qn, const void* nbr_vecs, const void* aux,
    const int* nodes, const unsigned char* allowed, float thr,
    int Q, int E, int W, int d, int ndig, int fused,
    float* nd, int* ns, int* adm, void* stream)
{
    if (Q < 1 || E < 1 || W < 1 || d < 1 || ndig < 1) return (int)cudaErrorInvalidValue;
    const long long total = (long long)Q * E * W;
    const long long blocks = (total + SCORE_THREADS - 1) / SCORE_THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    gather_score_kernel<<<(unsigned)blocks, SCORE_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16_t*)qb, qn, (const bf16_t*)nbr_vecs, (const bf16_t*)aux, nodes, allowed,
        thr, total, E, W, d, ndig, fused, nd, ns, adm);
    return (int)cudaGetLastError();
}
