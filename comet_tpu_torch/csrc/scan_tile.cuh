// Definitions shared by the distance kernels: K2's tile (fused_tile.cuh),
// K3 (ivf_sparse.cu) and the in-loop scoring (neighbour_score.cuh); and
// `smem_attr`, which K4, K5 and the scoring kernel use to take more than
// 48 KiB of shared memory.
//
// The epilogue is the reference's, in its order of operations:
//   L2:     max((qn + mask[n]) - 2 * ip, 0)     mask = squared norm, +inf if invalid
//   cosine: (1 - clip(ip, -1, 1)) + mask[n]     mask = 0, +inf if invalid
// then the threshold (dist > thr -> +inf), then the probe mask of the mode:
//   SCAN_ALL        no probe mask (flat scan);
//   SCAN_ROW_BITS   +inf unless row n's cluster assign[n] has its bit set in
//                   the query's probe bitmask (dense IVF scan, K2's tile).
// K3 needs no per-row mask: its tile belongs to one cluster, so it computes
// only the rows of the queries that probe it and writes +inf for the rest.
//
// The operands are float32 (T = float), bfloat16 (T = bf16_t), float16
// (T = half_t) or int8 (T = i8_t, K2's corpus only): narrow values are
// widened to float32 as they are staged, exactly, so the product is the
// same FMA chain whatever the operand. `dot_fma` is the one product step of every
// inner product in the package's kernels: an inner product starts at 0 and
// takes the depth in ascending order, one `dot_fma` per element. K3's bf16
// mode and the beam's in-loop scoring (gather_score.cu) both do so, and a
// bf16 x bf16 product is exact in float32, so the two give bit-equal
// distances for the same (query, row): the beam's duplicate kill
// (beam_merge.cu) relies on it.

#pragma once

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

enum { SCAN_ALL = 0, SCAN_ROW_BITS = 1 };

// a bfloat16 value as its raw 16 bits (the top half of a float32)
typedef unsigned short bf16_t;
typedef __half half_t;
typedef signed char i8_t;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16_t x) { return __uint_as_float((unsigned)x << 16); }
__device__ __forceinline__ float to_f32(half_t x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(i8_t x) { return (float)x; }

__device__ __forceinline__ float dot_fma(float a, float b, float acc) { return fmaf(a, b, acc); }

// One distance from its inner product ip, in the reference's order of
// operations: the metric (qni the query's squared norm, m the row's mask),
// then the threshold.
__device__ __forceinline__ float scan_distance(float ip, float qni, float m, float thr,
                                               int cosine) {
    float dd;
    if (cosine) {
        const float c = fminf(fmaxf(ip, -1.0f), 1.0f);
        dd = (1.0f - c) + m;
    } else {
        const float s = qni + m;
        dd = fmaxf(s - 2.0f * ip, 0.0f);
    }
    return dd <= thr ? dd : CUDART_INF_F;
}

// Opt `Kernel` in to `smem` bytes of dynamic shared memory (past the
// default 48 KiB with its static scratch) on the current device, once for
// each larger size a device: the attribute stays set on that device, and
// the call is host time on every launch of the beam's loop. Returns a
// CUDA error code.
template <auto Kernel>
static inline int smem_attr(size_t smem)
{
    constexpr int MAX_DEVICES = 64;
    static size_t raised[MAX_DEVICES] = {};
    if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
    if (smem + 1024 <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES && smem <= raised[dev]) return 0;
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) raised[dev] = smem;
    return 0;
}
