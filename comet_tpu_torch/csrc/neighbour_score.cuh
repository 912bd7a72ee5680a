// The in-loop distances of the neighbours of expanded HNSW nodes, shared by
// the scoring kernel (gather_score.cu) and K5 (fused_expand.cu), so that
// both give bit-equal distances for the same (query, slot).
//
// A node's routing row holds its W neighbour vectors (bf16, d each) and
// its aux row: W bf16 squared norms, then ndig planes of W base-128 digits
// of slot + 1 (0 for an empty adjacency entry). The blocked layout keeps
// the two in separate tables, the packed layout in one row; the callers
// pass the two row bases and strides either way.
//
// `score_neighbours` runs one block over the E expanded nodes of one
// query (-1 for none) in three steps:
//   1. the query, converted once to float32, and the nodes' aux rows go
//      to shared memory; the aux rows come by asynchronous copies, and the
//      slots are decoded from them (-1: no node or an empty entry);
//   2. the live neighbours' vectors are staged in passes of `pass`
//      candidates (whole nodes where two buffers of a node fit the
//      staging budget, else slices of a node's neighbours, down to one
//      vector, so the buffers stay within the budget whatever W d is)
//      through two buffers: the copies of the next pass are in flight
//      while the current one is scored. A vector is copied by groups of up to 32 threads, each moving `unit` bytes a
//      copy (16-byte `cp.async` where the table's rows allow it; 8 and 4
//      bytes, then plain 2-byte copies, for rows off those boundaries, e.g.
//      packed rows of 152 bytes or d not a multiple of 8). A -1 node and an
//      empty entry read nothing;
//   3. each candidate (node, neighbour) is one thread's `dot_fma` chain
//      from 0 over the depth in ascending order (scan_tile.cuh), the query
//      read from shared memory as float32 broadcasts and the neighbour's
//      bf16 values widened by shift, two a 32-bit word; then
//      max((qn + nsq) - 2 ip, 0).
// A neighbour's vector lies in shared memory at a stride of an odd number
// of 16-byte units (2 d + 16 bytes at d = 128), so the 8 threads of a
// quarter warp reading 16 bytes of 8 consecutive neighbours at one depth
// hit 8 distinct bank groups.

#pragma once

#include "scan_tile.cuh"

struct NbrGeom {
    int W, d, ndig, E;
    int unit;         // bytes a copy: 16, 8, 4 or 2
    int lanes_log2;   // log2 of the threads that copy one neighbour vector
    int vec_elems;    // bf16 elements a staged neighbour vector
    int aux_len;      // bf16 elements an aux row, (1 + ndig) W
    int aux_elems;    // aux_len rounded up to 16 bytes
    int pass;         // candidates (node, neighbour) a staging pass
    int nbuf;         // staging buffers in use: 2, or 1 when one pass holds every candidate
};

// Byte offsets of the regions: the query row, its norm, nodes, slots, aux
// rows, then the staging buffers (last, so a caller may reuse them).
struct NbrLayout {
    size_t qs, qn, nodes, slots, aux, stage, end;
};

__host__ __device__ __forceinline__ size_t nbr_align16(size_t n) { return (n + 15) & ~(size_t)15; }

__host__ __device__ __forceinline__ NbrLayout nbr_layout(const NbrGeom& g, size_t base)
{
    NbrLayout l;
    l.qs = nbr_align16(base);
    l.qn = l.qs + nbr_align16(sizeof(float) * (size_t)g.d);
    l.nodes = l.qn + 16;
    l.slots = l.nodes + nbr_align16(sizeof(int) * (size_t)g.E);
    l.aux = l.slots + nbr_align16(sizeof(int) * (size_t)g.E * g.W);
    l.stage = l.aux + 2 * (size_t)g.E * g.aux_elems;
    l.end = l.stage + 2 * (size_t)g.nbuf * g.pass * g.vec_elems;
    return l;
}

// The geometry of a block of E expanded nodes, with at most `stage_bytes`
// in two staging buffers: whole nodes a pass where a node fits, else as
// many of a node's neighbours as fit (at least one).
static inline NbrGeom nbr_geom(int W, int d, int ndig, int E, size_t stage_bytes,
                               const void* vecs, const void* aux,
                               long long vec_stride, long long aux_stride)
{
    NbrGeom g;
    g.W = W;
    g.d = d;
    g.ndig = ndig;
    g.E = E;
    g.aux_len = (1 + ndig) * W;
    g.aux_elems = (g.aux_len + 7) & ~7;
    const unsigned long long m = (unsigned long long)vecs | (unsigned long long)aux |
        (unsigned long long)(2 * vec_stride) | (unsigned long long)(2 * aux_stride) |
        (unsigned long long)(2 * d) | (unsigned long long)(2 * g.aux_len);
    g.unit = 16;
    while (g.unit > 2 && m % g.unit != 0) g.unit >>= 1;
    const int chunks = 2 * d / g.unit;
    g.lanes_log2 = 0;
    while (g.lanes_log2 < 5 && (1 << g.lanes_log2) < chunks) ++g.lanes_log2;
    g.vec_elems = (((2 * d + 15) / 16) | 1) * 8;
    const size_t vec_bytes = 2 * (size_t)g.vec_elems;
    const size_t nodes_fit = stage_bytes / (2 * W * vec_bytes);
    const size_t vecs_fit = stage_bytes / (2 * vec_bytes);
    const size_t n_cand = (size_t)E * W;
    size_t pass = nodes_fit >= 1 ? nodes_fit * W : (vecs_fit >= 1 ? vecs_fit : 1);
    if (pass > n_cand) pass = n_cand;
    g.pass = (int)pass;
    g.nbuf = pass < n_cand ? 2 : 1;
    return g;
}

// Neighbour j's slot from the digit planes of the aux row, -1 when empty.
__device__ __forceinline__ int decode_slot(const bf16_t* __restrict__ arow, int W, int j,
                                           int ndig)
{
    float a1 = to_f32(arow[W + j]);
    float scale = 128.0f;
    for (int i = 1; i < ndig; ++i) {
        a1 = a1 + to_f32(arow[(1 + i) * W + j]) * scale;
        scale *= 128.0f;
    }
    return (int)a1 - 1;
}

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }

// max((qn + nsq) - 2 <q, x>, 0) for the staged float32 query row q and the
// staged neighbour vector x (both 16-byte aligned): the `dot_fma` chain from 0,
// depth ascending.
__device__ __forceinline__ float staged_dist(const float* __restrict__ q, float qn,
                                             const bf16_t* __restrict__ x, bf16_t nsq, int d)
{
    float acc = 0.0f;
    int k = 0;
#pragma unroll 4
    for (; k + 8 <= d; k += 8) {
        const uint4 xv = *reinterpret_cast<const uint4*>(x + k);
        const float4 qa = *reinterpret_cast<const float4*>(q + k);
        const float4 qc = *reinterpret_cast<const float4*>(q + k + 4);
        acc = dot_fma(qa.x, bf16_lo(xv.x), acc);
        acc = dot_fma(qa.y, bf16_hi(xv.x), acc);
        acc = dot_fma(qa.z, bf16_lo(xv.y), acc);
        acc = dot_fma(qa.w, bf16_hi(xv.y), acc);
        acc = dot_fma(qc.x, bf16_lo(xv.z), acc);
        acc = dot_fma(qc.y, bf16_hi(xv.z), acc);
        acc = dot_fma(qc.z, bf16_lo(xv.w), acc);
        acc = dot_fma(qc.w, bf16_hi(xv.w), acc);
    }
    for (; k < d; ++k) acc = dot_fma(q[k], to_f32(x[k]), acc);
    return fmaxf((qn + to_f32(nsq)) - 2.0f * acc, 0.0f);
}

// -- copies -------------------------------------------------------------------

// One U-byte copy from device memory to shared memory: asynchronous for
// U = 16 (past L1), 8 and 4, a plain load and store for U = 2.
template <int U>
__device__ __forceinline__ void copy_unit(void* dst, const void* src)
{
    if constexpr (U == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
    } else if constexpr (U == 8) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                     ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
    } else if constexpr (U == 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
    } else {
        *static_cast<unsigned short*>(dst) = *static_cast<const unsigned short*>(src);
    }
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct NbrSmem {
    float* qs;
    float* qn;
    int* nodes;
    int* slots;
    bf16_t* aux;
    bf16_t* stage;
};

__device__ __forceinline__ NbrSmem nbr_smem(unsigned char* smem, const NbrGeom& g, size_t base)
{
    const NbrLayout l = nbr_layout(g, base);
    NbrSmem s;
    s.qs = reinterpret_cast<float*>(smem + l.qs);
    s.qn = reinterpret_cast<float*>(smem + l.qn);
    s.nodes = reinterpret_cast<int*>(smem + l.nodes);
    s.slots = reinterpret_cast<int*>(smem + l.slots);
    s.aux = reinterpret_cast<bf16_t*>(smem + l.aux);
    s.stage = reinterpret_cast<bf16_t*>(smem + l.stage);
    return s;
}

// The aux rows of the n_nodes nodes, the U-byte pieces of all rows spread
// over the block.
template <int U>
__device__ __forceinline__ void issue_aux(const NbrGeom& g, const NbrSmem& s,
                                          const bf16_t* __restrict__ aux, long long aux_stride,
                                          int n_nodes)
{
    const int per = 2 * g.aux_len / U;
    for (int f = threadIdx.x; f < n_nodes * per; f += blockDim.x) {
        const int i = f / per;
        const int c = f - i * per;
        const int node = s.nodes[i];
        if (node >= 0) {
            copy_unit<U>(reinterpret_cast<char*>(s.aux + (size_t)i * g.aux_elems) + c * U,
                         reinterpret_cast<const char*>(aux + node * aux_stride) + c * U);
        }
    }
}

// The live neighbour vectors of pass p's candidates into buffer p % nbuf,
// node by node (whole nodes, or a slice of one): the 2 d / U chunks of a
// vector go to a group of 2^lanes_log2 threads.
template <int U>
__device__ __forceinline__ void issue_pass(const NbrGeom& g, const NbrSmem& s,
                                           const bf16_t* __restrict__ vecs, long long vec_stride,
                                           int n_cand, int p)
{
    const int chunks = 2 * g.d / U;
    const int lg = g.lanes_log2;
    const int c0 = p * g.pass;
    const int c1 = min(n_cand, c0 + g.pass);
    bf16_t* buf = s.stage + (size_t)(p % g.nbuf) * g.pass * g.vec_elems;
    for (int i = c0 / g.W; i * g.W < c1; ++i) {
        const int node = s.nodes[i];
        if (node < 0) continue;
        const int j0 = max(c0 - i * g.W, 0);
        const int j1 = min(c1 - i * g.W, g.W);
        const char* src = reinterpret_cast<const char*>(vecs + node * vec_stride);
        for (int f = threadIdx.x; f < ((j1 - j0) << lg); f += blockDim.x) {
            const int j = j0 + (f >> lg);
            if (s.slots[i * g.W + j] < 0) continue;
            char* dst = reinterpret_cast<char*>(buf + (size_t)(i * g.W + j - c0) * g.vec_elems);
            for (int k = f & ((1 << lg) - 1); k < chunks; k += 1 << lg) {
                copy_unit<U>(dst + k * U, src + 2 * j * g.d + k * U);
            }
        }
    }
}

__device__ __forceinline__ void issue_aux_any(const NbrGeom& g, const NbrSmem& s,
                                              const bf16_t* aux, long long aux_stride, int n)
{
    switch (g.unit) {
        case 16: issue_aux<16>(g, s, aux, aux_stride, n); break;
        case 8: issue_aux<8>(g, s, aux, aux_stride, n); break;
        case 4: issue_aux<4>(g, s, aux, aux_stride, n); break;
        default: issue_aux<2>(g, s, aux, aux_stride, n); break;
    }
}

__device__ __forceinline__ void issue_pass_any(const NbrGeom& g, const NbrSmem& s,
                                               const bf16_t* vecs, long long vec_stride, int n,
                                               int p)
{
    switch (g.unit) {
        case 16: issue_pass<16>(g, s, vecs, vec_stride, n, p); break;
        case 8: issue_pass<8>(g, s, vecs, vec_stride, n, p); break;
        case 4: issue_pass<4>(g, s, vecs, vec_stride, n, p); break;
        default: issue_pass<2>(g, s, vecs, vec_stride, n, p); break;
    }
}

// Score every neighbour of the query's nodes: node i < E is nodes[i], the
// query's bf16 row qb and its norm *qn; calls emit(i, j, dist, slot) once
// for each neighbour j < W, with
// (+inf, -1) for a -1 node or an empty entry, in the order of i W + j
// within a pass across the threads. The staging starts at byte `base` of
// smem (nbr_layout). Ends with a barrier after the last read of the
// staging buffers, with no copy in flight.
template <typename Emit>
__device__ __forceinline__ void score_neighbours(
    const NbrGeom& g, unsigned char* smem, size_t base,
    const bf16_t* __restrict__ vecs, const bf16_t* __restrict__ aux,
    long long vec_stride, long long aux_stride,
    const int* __restrict__ nodes, const bf16_t* __restrict__ qb,
    const float* __restrict__ qn, Emit emit)
{
    const NbrSmem s = nbr_smem(smem, g, base);
    const int tid = threadIdx.x;
    const int n_nodes = g.E;
    const int n_cand = n_nodes * g.W;
    for (int i = tid; i < n_nodes; i += blockDim.x) s.nodes[i] = nodes[i];
    for (int k = tid; k < g.d; k += blockDim.x) s.qs[k] = to_f32(qb[k]);
    if (tid == 0) s.qn[0] = *qn;
    __syncthreads();
    issue_aux_any(g, s, aux, aux_stride, n_nodes);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int f = tid; f < n_cand; f += blockDim.x) {
        const int i = f / g.W;
        const int j = f - i * g.W;
        s.slots[f] = s.nodes[i] >= 0
            ? decode_slot(s.aux + (size_t)i * g.aux_elems, g.W, j, g.ndig) : -1;
    }
    __syncthreads();

    const int n_pass = (n_cand + g.pass - 1) / g.pass;
    issue_pass_any(g, s, vecs, vec_stride, n_cand, 0);
    cp_async_commit();
    for (int p = 0; p < n_pass; ++p) {
        issue_pass_any(g, s, vecs, vec_stride, n_cand, p + 1);
        cp_async_commit();
        cp_async_wait<1>();               // pass p has landed, pass p + 1 may be in flight
        __syncthreads();
        const int c0 = p * g.pass;
        const int np = min(n_cand - c0, g.pass);
        const bf16_t* buf = s.stage + (size_t)(p % g.nbuf) * g.pass * g.vec_elems;
        for (int f = tid; f < np; f += blockDim.x) {
            const int c = c0 + f;
            const int i = c / g.W;
            const int j = c - i * g.W;
            const int slot = s.slots[c];
            float dist = CUDART_INF_F;
            if (slot >= 0) {
                dist = staged_dist(s.qs, s.qn[0], buf + (size_t)f * g.vec_elems,
                                   s.aux[(size_t)i * g.aux_elems + j], g.d);
            }
            emit(i, j, dist, slot);
        }
        __syncthreads();                  // buffer p % nbuf is free again
    }
    cp_async_wait<0>();
}
