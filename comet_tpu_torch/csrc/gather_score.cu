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
// d = 16, ndig = 2: 152 bytes), which the staging's narrower copies absorb.
//
// What bounds it on an H100: every live node's aux row and live
// neighbours' d bf16 values (256 bytes at d = 128) are read, and 12 bytes a
// candidate written; at Q = 2048, E = 8, W = 32 that is about 137 MB an
// iteration, 41 us at 3.35 TB/s, against 2 d operations per candidate (134
// MFLOP, 2 us at 67 TFLOP/s): bytes bound it. So the rows are staged
// (neighbour_score.cuh): each expanded node's row comes into shared memory
// by coalesced asynchronous copies, the first passes of a block in flight
// before the first is scored, and one thread a candidate runs the FMA
// chain from shared memory. A block takes one query and stages at most
// SCORE_STAGE_BYTES in its two staging buffers: 3 nodes a pass at
// W = 32, d = 128, two passes in flight, about 56 KB of shared memory, so
// four blocks share an SM (PERF.md §6 has the shapes that were measured
// against it). Past W d of about 13,000 (W = 32 at d = 1536, W = 64 at
// d = 768) two buffers of one node pass that budget, and a pass holds a
// slice of a node's neighbours, down to one vector. What still grows with
// d is the float32 query row and two staged vectors, about 8 d bytes, so
// a block fits the 200 KB a launch may take up to d of about 24,500;
// past it the launch is refused.

#define SENT_SLOT 2147483647
#include "neighbour_score.cuh"

constexpr int SCORE_THREADS = 256;
constexpr int SCORE_MIN_BLOCKS = 4;          // blocks an SM
constexpr size_t SCORE_STAGE_BYTES = 52 * 1024;

__global__ void __launch_bounds__(SCORE_THREADS, SCORE_MIN_BLOCKS) gather_score_kernel(
    const bf16_t* __restrict__ qb, const float* __restrict__ qn,
    const bf16_t* __restrict__ vecs, const bf16_t* __restrict__ aux,
    long long vec_stride, long long aux_stride,
    const int* __restrict__ nodes, const unsigned char* __restrict__ allowed, float thr,
    int fused, float* __restrict__ nd, int* __restrict__ ns, int* __restrict__ adm,
    NbrGeom g)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const long long q = blockIdx.x;
    const long long t0 = q * g.E * g.W;
    score_neighbours(
        g, smem, 0, vecs, aux, vec_stride, aux_stride, nodes + q * g.E, qb + q * g.d, qn + q,
        [&](int i, int j, float dist, int slot) {
            const long long t = t0 + (long long)i * g.W + j;
            nd[t] = dist;
            ns[t] = slot >= 0 ? slot : SENT_SLOT;
            if (fused) adm[t] = (slot >= 0 && allowed[slot] && dist <= thr) ? 1 : 0;
        });
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
    const NbrGeom g = nbr_geom(W, d, ndig, E, SCORE_STAGE_BYTES, vecs, aux,
                               vec_stride, aux_stride);
    const size_t smem = nbr_layout(g, 0).end;
    const int attr = smem_attr<gather_score_kernel>(smem);
    if (attr != 0) return attr;
    gather_score_kernel<<<Q, SCORE_THREADS, smem, (cudaStream_t)stream>>>(
        (const bf16_t*)qb, qn, (const bf16_t*)vecs, (const bf16_t*)aux, vec_stride, aux_stride,
        nodes, allowed, thr, fused, nd, ns, adm, g);
    return (int)cudaGetLastError();
}
