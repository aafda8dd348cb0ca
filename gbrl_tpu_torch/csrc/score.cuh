// Split scoring shared by the level path (K3, fit.cu) and the whole-tree
// kernel (K6, tree.cu): one (feature, node) block's prefix sums and
// candidate scores, and one node's tolerance argmax.  Both kernels run this
// code, so on the same histogram they choose the same splits bit for bit,
// and the plain PyTorch versions (ops/kernels.py level_score_rows /
// level_score_plain) repeat its arithmetic step for step.
//
// The order of operations is the JAX package's where it decides the result:
// s * w before the blocked mask, parent 0 at the root, the node sum before
// NaN -> -inf.  Products that feed a sum use __fmul_rn / __fadd_rn so nvcc
// does not contract them into FMAs; division and sqrtf are IEEE (no
// fast-math).
//
// Buffers that a kernel writes and reads back in one launch (K6) must not be
// read through the non-coherent cache, so no pointer here is __restrict__.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gbrl {

// Allows a kernel `bytes` of dynamic shared memory (above 48 KB only so).
inline int set_smem(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = l < (int)(blockDim.x >> 5) ? sh[l] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (l == 0) sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_min(int v, int* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  if (l == 0) sh[w] = v;
  __syncthreads();
  if (w == 0) {
    v = l < (int)(blockDim.x >> 5) ? sh[l] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1)
      v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (l == 0) sh[0] = v;
  }
  __syncthreads();
  v = sh[0];
  __syncthreads();
  return v;
}

// Dynamic shared memory of score_feature_node: prefix sums [K][NB] and the
// node totals [K].
__host__ __device__ inline size_t score_smem_floats(int O, int NB) {
  return (size_t)(O + 1) * NB + O + 1;
}

// One (feature f, node) block of a level's scoring.  hist [F, n_nodes * K,
// NB] (K = O + 1, column node * K + o, o == O the sample weights).  Writes
// adj[node * F * B + f * B + b] for b < B: the greedy adjusted score (parent
// subtracted, NaN -> -inf) or the oblivious raw masked score; the block of
// feature 0 writes stats[node] = (node sums [O], count, parent).
// blocked(b) says whether candidate (f, b) is blocked for this node.  Every
// thread of the block must call it (it synchronises).
template <class Blocked>
__device__ inline void score_feature_node(
    const float* hist, const float* feat_w, float* adj, float* stats, int f,
    int node, int n_nodes, int F, int O, int NB, int B, int cosine,
    float min_data, int oblivious, int is_root, float* sm, Blocked blocked) {
  const int K = O + 1;
  const size_t C = (size_t)n_nodes * K;
  float* cs = sm;             // [K][NB] prefix sums of this feature
  float* tot = sm + K * NB;   // [K] node totals (feature 0's full prefix)
  for (int r = threadIdx.x; r < 2 * K; r += blockDim.x) {
    const bool own = r < K;
    const int o = own ? r : r - K;
    const float* h =
        hist + ((size_t)(own ? f : 0) * C + (size_t)node * K + o) * NB;
    float acc = 0.0f;
    if (own) {
      for (int b = 0; b < NB; ++b) {
        acc = __fadd_rn(acc, h[b]);
        cs[o * NB + b] = acc;
      }
    } else {
      for (int b = 0; b < NB; ++b) acc = __fadd_rn(acc, h[b]);
      tot[o] = acc;
    }
  }
  __syncthreads();
  const float ct = tot[O];
  float sq = 0.0f;
  for (int o = 0; o < O; ++o) sq = __fadd_rn(sq, __fmul_rn(tot[o], tot[o]));
  float p = ct > 0.0f ? sq / ct : 0.0f;
  if (cosine) p = p > 0.0f ? sqrtf(p) : 0.0f;
  const float parent = is_root ? 0.0f : p;
  if (f == 0 && threadIdx.x == 0) {
    float* st = stats + (size_t)node * (O + 2);
    for (int o = 0; o < O; ++o) st[o] = tot[o];
    st[O] = ct;
    st[O + 1] = parent;
  }
  const float fw = feat_w[f];
  const size_t M = (size_t)F * B;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float cl = cs[O * NB + b];
    const float cr = ct - cl;
    float l2l = 0.0f, l2r = 0.0f;
    for (int o = 0; o < O; ++o) {
      const float lo = cs[o * NB + b];
      const float ro = tot[o] - lo;
      l2l = __fadd_rn(l2l, __fmul_rn(lo, lo));
      l2r = __fadd_rn(l2r, __fmul_rn(ro, ro));
    }
    const float sL = cl > 0.0f ? l2l / cl : 0.0f;
    const float sR = cr > 0.0f ? l2r / cr : 0.0f;
    float s = __fadd_rn(sL, sR);
    if (cosine) s = s > 0.0f ? sqrtf(s) : 0.0f;
    if (min_data > 0.0f && (cl < min_data || cr < min_data)) s = -INFINITY;
    s = __fmul_rn(s, fw);                     // -inf * 0 -> NaN -> -inf
    const size_t q = (size_t)f * B + b;
    if (blocked(b)) s = -INFINITY;
    if (!oblivious) {
      s = __fsub_rn(s, parent);
      if (isnan(s)) s = -INFINITY;
    }
    adj[(size_t)node * M + q] = s;
  }
}

__device__ __forceinline__ float level_value(const float* adj, int node,
                                             int n_nodes, size_t M, size_t q,
                                             int oblivious) {
  if (!oblivious) return adj[(size_t)node * M + q];
  float s = 0.0f;
  for (int n = 0; n < n_nodes; ++n) s = __fadd_rn(s, adj[(size_t)n * M + q]);
  return isnan(s) ? -INFINITY : s;
}

// The choice of one node (greedy) or of the level (oblivious, node 0): the
// row's max, then the first index within the 2e-6 relative band (the parent
// score in the band's base).  Max and min are exact in any order, so the
// result is deterministic.  Every thread of the block must call it; all get
// the (index, value) pair.
__device__ inline void argmax_node(const float* adj, const float* stats,
                                   int node, int n_nodes, int M, int O,
                                   int oblivious, float* shf, int* shi,
                                   int* q_out, float* v_out) {
  float m = -INFINITY;
  for (int q = threadIdx.x; q < M; q += blockDim.x)
    m = fmaxf(m, level_value(adj, node, n_nodes, M, q, oblivious));
  m = block_max(m, shf);
  const float scale =
      oblivious ? 0.0f : fabsf(stats[(size_t)node * (O + 2) + O + 1]);
  const float tol = isfinite(m) ? __fmul_rn(__fadd_rn(fabsf(m), scale), 2e-6f)
                                : 0.0f;
  const float lim = __fsub_rn(m, tol);
  int qi = M;
  for (int q = threadIdx.x; q < M; q += blockDim.x)
    if (level_value(adj, node, n_nodes, M, q, oblivious) >= lim) {
      qi = q;
      break;
    }
  qi = block_min(qi, shi);
  *q_out = qi;
  *v_out = level_value(adj, node, n_nodes, M, qi, oblivious);
}

}  // namespace gbrl
