// Split scoring shared by the level path (K3, fit.cu) and the whole-tree
// kernel (K6, tree.cu): in-place prefix sums of staged histogram rows, the
// node totals and parent score, one candidate's score, and the block
// reductions of the tolerance argmax.  Both kernels run this code, so on the
// same histogram they choose the same splits bit for bit, and the plain
// PyTorch versions (ops/kernels.py level_score_rows / level_score_plain)
// repeat its arithmetic step for step.
//
// The order of operations is the JAX package's where it decides the result:
// sequential f32 prefix sums in bucket order from +0, the node totals taken
// from feature 0's full prefix, s * w before the blocked mask, parent 0 at
// the root, the node sum (oblivious) before NaN -> -inf.  Products that feed
// a sum use __fmul_rn / __fadd_rn so nvcc does not contract them into FMAs;
// division and sqrtf are IEEE (no fast-math).
//
// What bounded the earlier version was a chain of global loads: each of the
// 2 (O + 1) scanning threads of a block loaded h[b], added and stored, 257
// times, and could not issue a load before the previous store (the pointers
// might alias), so every step waited on an L2 round trip.  Here all threads
// of a block first stage the rows into shared memory with every load in
// flight; then one thread per row runs the same sequential chain from shared
// memory.  The association is unchanged, so no plain version changes.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gbrl {

// Rows of n floats staged in shared memory with an odd stride, so the
// threads that scan neighbouring rows read different banks.
__host__ __device__ inline int odd_stride(int n) { return n | 1; }

// In-place prefix sums of n_rows rows [n] at `stride`, one thread per row
// (rows beyond blockDim.x taken in turn): acc = acc + row[b] in bucket order
// from +0, exactly as the plain version's loop.  Unrolled 32 deep, so the
// compiler issues the shared-memory loads ahead of the chain of adds (faster
// on an H100 than a rolled loop or explicit batches of loads).  The caller
// synchronises.
__device__ inline void scan_rows(float* rows, int n_rows, int n, int stride) {
  for (int r = threadIdx.x; r < n_rows; r += blockDim.x) {
    float* row = rows + (size_t)r * stride;
    float acc = 0.0f;
#pragma unroll 32
    for (int b = 0; b < n; ++b) {
      acc = __fadd_rn(acc, row[b]);
      row[b] = acc;
    }
  }
}

// The parent score of a node from its totals tot[0..O] (tot[O] the count).
__device__ __forceinline__ float node_parent(const float* tot, int O,
                                             int cosine) {
  const float ct = tot[O];
  float sq = 0.0f;
  for (int o = 0; o < O; ++o) sq = __fadd_rn(sq, __fmul_rn(tot[o], tot[o]));
  float p = ct > 0.0f ? sq / ct : 0.0f;
  if (cosine) p = p > 0.0f ? sqrtf(p) : 0.0f;
  return p;
}

// The score of candidate b of one (node, feature): cs points at the prefix
// row of output column 0, the rows of columns 1..O follow at `stride` (O the
// weights); tot the node totals.  Returns s * w with the min-data mask, before
// the blocked mask and the parent subtraction.
__device__ __forceinline__ float candidate_score(const float* cs, int stride,
                                                 const float* tot, int O,
                                                 int b, int cosine,
                                                 float min_data, float fw) {
  const float ct = tot[O];
  const float cl = cs[(size_t)O * stride + b];
  const float cr = ct - cl;
  float l2l = 0.0f, l2r = 0.0f;
  for (int o = 0; o < O; ++o) {
    const float lo = cs[(size_t)o * stride + b];
    const float ro = tot[o] - lo;
    l2l = __fadd_rn(l2l, __fmul_rn(lo, lo));
    l2r = __fadd_rn(l2r, __fmul_rn(ro, ro));
  }
  const float sL = cl > 0.0f ? l2l / cl : 0.0f;
  const float sR = cr > 0.0f ? l2r / cr : 0.0f;
  float s = __fadd_rn(sL, sR);
  if (cosine) s = s > 0.0f ? sqrtf(s) : 0.0f;
  if (min_data > 0.0f && (cl < min_data || cr < min_data)) s = -INFINITY;
  return __fmul_rn(s, fw);                    // -inf * 0 -> NaN -> -inf later
}

// A greedy candidate's adjusted score: blocked -> -inf, minus the parent,
// NaN -> -inf.
__device__ __forceinline__ float greedy_value(float s, bool blocked,
                                              float parent) {
  if (blocked) s = -INFINITY;
  s = __fsub_rn(s, parent);
  return isnan(s) ? -INFINITY : s;
}

// The tie band's lower limit: the max, less 2e-6 of (|max| + scale) when the
// max is finite (scale: |parent| for a greedy node, 0 for an oblivious level).
__device__ __forceinline__ float band_limit(float m, float scale) {
  const float tol = isfinite(m) ? __fmul_rn(__fadd_rn(fabsf(m), scale), 2e-6f)
                                : 0.0f;
  return __fsub_rn(m, tol);
}

// Max over the block (exact in any order).  sh: 32 floats of scratch.  Every
// thread must call it; all get the result.
__device__ __forceinline__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) sh[w] = v;
  __syncthreads();
  v = l < (int)(blockDim.x >> 5) ? sh[l] : -INFINITY;
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int block_min(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();
  if (l == 0) sh[w] = v;
  __syncthreads();
  v = l < (int)(blockDim.x >> 5) ? sh[l] : 0x7fffffff;
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace gbrl
