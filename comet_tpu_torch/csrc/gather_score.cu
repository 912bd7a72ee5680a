// The beam's in-loop scoring: gather the expanded nodes' neighbourhood
// blocks and score them against the queries.
//
// Replaces the scoring of comet_tpu/ops/beam_kernel.py:_gather_score and
// _score_rows (both layouts), which the reference runs as XLA ops (a row
// gather and a grouped bf16 einsum with a diagonal extract, an MXU trick),
// not as a Pallas kernel. It is here because the seed scan (K3's bf16
// mode) and this scoring must give bit-equal distances for the same
// (query, slot): both use `dot_fma` of scan_tile.cuh, one FMA per depth
// element in ascending order from 0, and every bf16 x bf16 product is
// exact in float32.
//
// For query q, expanded node e = nodes[q, e] (-1 for none) and neighbour
// j < W of that node, with c = e * W + j (neighbour_score.cuh):
//   slot  = the base-128 digits of aux[node, (1 + i) W + j], i < ndig,
//           minus 1 (-1: an empty adjacency entry)
//   ip    = sum over k of qb[q, k] * vecs[node, j, k]          (bf16, fp32 FMA)
//   nd    = max((qn[q] + aux[node, j]) - 2 ip, 0)              (aux[node, j] = bf16 sqnorm)
// and where the node is -1 or the slot empty, nd = +inf and ns = SENT.
// With `fused` it also writes the admission flag
//   adm = ok && allowed[slot] && nd <= thr.
// Outputs are query-major [Q, E * W], K4's candidate layout.
//
// Two table layouts, one kernel: node p's W neighbour vectors start at
// vecs + p * vec_stride and its aux row at aux + p * aux_stride. The
// blocked layout has vec_stride = W d and a separate aux table of stride
// (1 + ndig) W; the packed layout (one row of W d + (1 + ndig) W bf16 per
// node) passes the same table twice, aux offset by W d, both strides the
// row length. A packed row is not 16-byte aligned in general (W = 4,
// d = 16, ndig = 2: 152 bytes), which the row dot's scalar head absorbs.
//
// What bounds it on an H100: every live candidate reads its d bf16 values
// (256 bytes at d = 128) and the aux row, and writes 12 bytes; at Q =
// 2048, E = 8, W = 32 that is about 137 MB an iteration, 41 us at 3.35
// TB/s, against 2 d operations per candidate (134 MFLOP, 2 us at 67
// TFLOP/s): bytes bound it. The kernel is simple on purpose: one thread
// per candidate runs the FMA chain over its neighbour's row.

#define SENT_SLOT 2147483647
#include "neighbour_score.cuh"

#define SCORE_THREADS 256

__global__ void __launch_bounds__(SCORE_THREADS) gather_score_kernel(
    const bf16_t* __restrict__ qb, const float* __restrict__ qn,
    const bf16_t* __restrict__ vecs, const bf16_t* __restrict__ aux,
    long long vec_stride, long long aux_stride,
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
        const bf16_t* arow = aux + (long long)node * aux_stride;
        const int neigh = decode_slot(arow, W, j, ndig);
        if (neigh >= 0) {
            ok = true;
            slot = neigh;
            dist = neighbour_dist(qb + q * d, qn[q], vecs + (long long)node * vec_stride + j * d,
                                  arow[j], d);
        }
    }
    nd[t] = dist;
    ns[t] = slot;
    if (fused) adm[t] = (ok && allowed[slot] && dist <= thr) ? 1 : 0;
}

// qb [Q, d] bf16, qn [Q] f32, vecs / aux the row tables (see above, strides
// in elements), nodes [Q, E] i32, allowed [cap] bool (fused only).
extern "C" int comet_gather_score(
    const void* qb, const float* qn, const void* vecs, const void* aux,
    long long vec_stride, long long aux_stride,
    const int* nodes, const unsigned char* allowed, float thr,
    int Q, int E, int W, int d, int ndig, int fused,
    float* nd, int* ns, int* adm, void* stream)
{
    if (Q < 1 || E < 1 || W < 1 || d < 1 || ndig < 1 || vec_stride < (long long)W * d ||
        aux_stride < (long long)(1 + ndig) * W)
        return (int)cudaErrorInvalidValue;
    const long long total = (long long)Q * E * W;
    const long long blocks = (total + SCORE_THREADS - 1) / SCORE_THREADS;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    gather_score_kernel<<<(unsigned)blocks, SCORE_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16_t*)qb, qn, (const bf16_t*)vecs, (const bf16_t*)aux, vec_stride, aux_stride,
        nodes, allowed, thr, total, E, W, d, ndig, fused, nd, ns, adm);
    return (int)cudaGetLastError();
}
