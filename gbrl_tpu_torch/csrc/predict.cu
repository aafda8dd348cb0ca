// Ensemble predict kernels: sum_t w[t, leaf(n, t), :] over the live trees.
//
// Replaces (gbrl_tpu/ops/pallas_kernels.py):
//   gbrl_k4_leaf_sum  <- weighted_leaf_sum_pallas  (general heap walk, K4)
//   gbrl_k5_leaf_sum  <- oblivious_leaf_sum_pallas (oblivious bit index, K5)
//
// What bounds them on an H100: at the serving shape (N = 4096 samples,
// F = 16, depth 4, O = 3, 1600 live trees) the tree tables are ~0.5 MB and
// X is 256 KB, both resident in the 50 MB L2, so HBM bytes are no limit.
// The work is N * n_trees * depth dependent node visits (a shared-memory
// load of the node, a load of x[feat], a compare) plus O adds per tree:
// a latency-bound chain per (sample, tree), not a bandwidth stream.
//
// What the design does about it:
//   * a block owns TILE_N = 32 samples (one per lane) and GROUPS = 8 warps;
//     warp g walks the trees t with t % GROUPS == g, so each sample's trees
//     are spread over 8 independent chains and N = 4096 still fills ~128
//     blocks;
//   * the live trees are staged chunk by chunk (C trees, a multiple of
//     GROUPS) into shared memory: node tables and leaf weights are read
//     from device memory once per block, then every lane walks its heap by
//     direct index p = 2p + 1 + go;
//   * sums stay in f32 registers; the 8 per-warp partials are added in
//     warp order through shared memory.  No atomics: the order of every add
//     is fixed, so K4 and K5 give the same bits on oblivious ensembles
//     (both are instances of one template: they share the tree-to-warp
//     assignment, the accumulation and the reduction);
//   * the one limit is shared memory: a block holds X's tile (128 (F + 1)
//     bytes) and a chunk of C >= 8 trees (9 bytes per staged node, 4 O per
//     leaf).  The wrapper halves C until the block fits and raises when even
//     C = 8 exceeds the device's opt-in maximum (227 KB on an H100: K4
//     past depth 10 at F = 16, O = 3).
//
// Semantics (as the TPU kernels): x > thr routes right (strict f32 compare,
// NaN goes left), nodes with is_split == 0 route left, feat is clamped to
// [0, F) before x is read (pass-through nodes carry feat == -1), only trees
// t < *n_trees contribute (stale weights beyond it are never read), and
// n_trees is read from device memory, so the host never waits for it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast-math: the compares and adds must stay IEEE f32).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_N = 32;    // samples per block, one per lane
constexpr int GROUPS = 8;     // warps per block; tree t -> warp t % GROUPS
constexpr int THREADS = TILE_N * GROUPS;
constexpr int MAX_O = 8;      // output columns per launch (wider O: slices)

struct Smem {
  float* x;          // [TILE_N][F + 1]      (row padded against bank conflicts)
  float* red;        // [GROUPS][TILE_N][MAX_O]
  float* thr;        // [C][K]
  float* w;          // [C][L][Oc]
  int32_t* feat;     // [C][K]
  uint8_t* spl;      // [C][K]
};

// K = nodes staged per tree: 2^D - 1 for K4, D (level leads) for K5.
__device__ __forceinline__ Smem carve(unsigned char* base, int F, int C, int K,
                                      int L, int Oc) {
  Smem s;
  float* f = reinterpret_cast<float*>(base);
  s.x = f;
  f += TILE_N * (F + 1);
  s.red = f;
  f += GROUPS * TILE_N * MAX_O;
  s.thr = f;
  f += C * K;
  s.w = f;
  f += C * L * Oc;
  s.feat = reinterpret_cast<int32_t*>(f);
  s.spl = reinterpret_cast<uint8_t*>(s.feat + C * K);
  return s;
}

size_t smem_bytes(int F, int C, int K, int L, int Oc) {
  return sizeof(float) * ((size_t)TILE_N * (F + 1) + GROUPS * TILE_N * MAX_O +
                          (size_t)C * K + (size_t)C * L * Oc) +
         sizeof(int32_t) * (size_t)C * K + (size_t)C * K;
}

__device__ __forceinline__ void stage_x(const Smem& s, const float* X, int N,
                                        int F, int n0) {
  for (int i = threadIdx.x; i < TILE_N * F; i += THREADS) {
    const int r = i / F, c = i - r * F;
    const int n = n0 + r;
    s.x[r * (F + 1) + c] = n < N ? X[(size_t)n * F + c] : 0.0f;
  }
}

__device__ __forceinline__ void stage_w(const Smem& s, const float* w, int c0,
                                        int cn, int L, int O, int o_off,
                                        int Oc) {
  const int total = cn * L * Oc;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int tl = i / Oc, o = i - tl * Oc;
    s.w[i] = w[((size_t)c0 * L + tl) * O + o_off + o];
  }
}

// Adds this warp's partials in warp order and writes the tile's outputs.
__device__ __forceinline__ void reduce_write(const Smem& s, const float* acc,
                                             float* out, int N, int O,
                                             int o_off, int Oc, int n0) {
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  float* mine = s.red + (g * TILE_N + lane) * MAX_O;
#pragma unroll
  for (int o = 0; o < MAX_O; ++o)
    if (o < Oc) mine[o] = acc[o];
  __syncthreads();
  for (int i = threadIdx.x; i < TILE_N * Oc; i += THREADS) {
    const int r = i / Oc, o = i - r * Oc;
    float v = s.red[r * MAX_O + o];
    for (int gg = 1; gg < GROUPS; ++gg) v += s.red[(gg * TILE_N + r) * MAX_O + o];
    const int n = n0 + r;
    if (n < N) out[(size_t)n * O + o_off + o] = v;
  }
}

__device__ __forceinline__ int live_trees(const int32_t* n_trees, int T_cap) {
  const int nt = *n_trees;
  return nt < 0 ? 0 : (nt > T_cap ? T_cap : nt);
}

// One kernel for both TPU kernels, so the add order that makes K5 equal K4
// bit for bit lives in one place.  OBLIVIOUS = false (K4): stage every node
// (K = 2^D - 1 per tree) and walk the heap p = 2p + 1 + go.  OBLIVIOUS = true
// (K5): stage only the level-lead slot 2^d - 1 of each level (K = D; an
// oblivious tree shares one (feat, thr, is_split) across a level) and build
// the leaf bit index leaf = 2 leaf + go.
template <bool OBLIVIOUS>
__global__ void __launch_bounds__(THREADS)
leaf_sum_kernel(const float* __restrict__ X, const int32_t* __restrict__ feat,
                const float* __restrict__ thr,
                const uint8_t* __restrict__ is_split,
                const float* __restrict__ w,
                const int32_t* __restrict__ n_trees, float* __restrict__ out,
                int N, int F, int T_cap, int depth, int O, int o_off, int Oc,
                int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int IN = (1 << depth) - 1, L = 1 << depth;
  const int K = OBLIVIOUS ? depth : IN;
  const Smem s = carve(smem_raw, F, C, K, L, Oc);
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int n0 = blockIdx.x * TILE_N;
  stage_x(s, X, N, F, n0);
  const float* xrow = s.x + lane * (F + 1);
  const int nt = live_trees(n_trees, T_cap);

  float acc[MAX_O];
#pragma unroll
  for (int o = 0; o < MAX_O; ++o) acc[o] = 0.0f;

  for (int c0 = 0; c0 < nt; c0 += C) {
    const int cn = min(C, nt - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < cn * K; i += THREADS) {
      size_t src = (size_t)c0 * IN + i;
      if (OBLIVIOUS) {
        const int j = i / K, d = i - j * K;
        src = (size_t)(c0 + j) * IN + (1 << d) - 1;
      }
      s.feat[i] = feat[src];
      s.thr[i] = thr[src];
      s.spl[i] = is_split[src];
    }
    stage_w(s, w, c0, cn, L, O, o_off, Oc);
    __syncthreads();
    // c0 is a multiple of GROUPS, so local tree j belongs to warp j % GROUPS
    for (int j = g; j < cn; j += GROUPS) {
      const int32_t* ft = s.feat + j * K;
      const float* th = s.thr + j * K;
      const uint8_t* sp = s.spl + j * K;
      int p = 0;
      for (int d = 0; d < depth; ++d) {
        const int k = OBLIVIOUS ? d : p;
        const int f = min(max(ft[k], 0), F - 1);
        const int go = (sp[k] != 0) & (xrow[f] > th[k]);
        p = OBLIVIOUS ? 2 * p + go : 2 * p + 1 + go;
      }
      const int leaf = OBLIVIOUS ? p : p - IN;
      const float* wl = s.w + (j * L + leaf) * Oc;
#pragma unroll
      for (int o = 0; o < MAX_O; ++o)
        if (o < Oc) acc[o] += wl[o];
    }
  }
  __syncthreads();
  reduce_write(s, acc, out, N, O, o_off, Oc, n0);
}

typedef void (*LeafSumKernel)(const float*, const int32_t*, const float*,
                              const uint8_t*, const float*, const int32_t*,
                              float*, int, int, int, int, int, int, int, int);

int launch(LeafSumKernel kernel, int K, const float* X, const int32_t* feat,
           const float* thr, const uint8_t* is_split, const float* w,
           const int32_t* n_trees, float* out, int N, int F, int T_cap,
           int depth, int O, int C, void* stream) {
  const int L = 1 << depth;
  const size_t bytes = smem_bytes(F, C, K, L, MAX_O < O ? MAX_O : O);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TILE_N - 1) / TILE_N);
  for (int o_off = 0; o_off < O; o_off += MAX_O) {
    const int Oc = O - o_off < MAX_O ? O - o_off : MAX_O;
    kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
        X, feat, thr, is_split, w, n_trees, out, N, F, T_cap, depth, O, o_off,
        Oc, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shared memory one block needs; the wrapper picks the chunk size C with it.
size_t gbrl_leaf_sum_smem_bytes(int F, int C, int K, int depth, int O) {
  return smem_bytes(F, C, K, 1 << depth, MAX_O < O ? MAX_O : O);
}

int gbrl_leaf_sum_group() { return GROUPS; }

// The most dynamic shared memory one block may opt in to on the device
// (227 KB on an H100); -1 if the device cannot be queried.
int gbrl_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// X [N, F] f32; feat [T_cap, 2^D-1] i32; thr [T_cap, 2^D-1] f32;
// is_split [T_cap, 2^D-1] u8; w [T_cap, 2^D, O] f32; n_trees [1] i32 on the
// device; out [N, O] f32.  C: trees per shared-memory chunk (multiple of 8).
// Returns cudaGetLastError() of the launches (0 on success).
int gbrl_k4_leaf_sum(const float* X, const int32_t* feat, const float* thr,
                     const uint8_t* is_split, const float* w,
                     const int32_t* n_trees, float* out, int N, int F,
                     int T_cap, int depth, int O, int C, void* stream) {
  return launch(leaf_sum_kernel<false>, (1 << depth) - 1, X, feat, thr,
                is_split, w, n_trees, out, N, F, T_cap, depth, O, C, stream);
}

int gbrl_k5_leaf_sum(const float* X, const int32_t* feat, const float* thr,
                     const uint8_t* is_split, const float* w,
                     const int32_t* n_trees, float* out, int N, int F,
                     int T_cap, int depth, int O, int C, void* stream) {
  return launch(leaf_sum_kernel<true>, depth, X, feat, thr, is_split, w,
                n_trees, out, N, F, T_cap, depth, O, C, stream);
}

const char* gbrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
