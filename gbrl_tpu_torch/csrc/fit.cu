// Fit-path kernels: bucketize (K1), level histogram (K2), level split
// score (K3).
//
// Replaces (gbrl_tpu/ops/pallas_kernels.py):
//   gbrl_k1_bucketize       <- bucketize_pallas       (K1)
//   gbrl_k2_level_histogram <- level_histogram_pallas (K2)
//   gbrl_k3_level_score     <- level_score_pallas     (K3)
//
// Shapes at the PPO training width: N = 4096 samples, F = 16 features,
// B = 256 candidates per feature (NB = B + 1 = 257 buckets), O = 3 outputs,
// depth 4, so C = n_nodes * (O + 1) = 4, 8, 16, 32 histogram columns at
// levels 0-3.
//
// What bounds them on an H100, and what the design does about it:
//
// K1 (bucket = number of candidates strictly below x).  N F B compares
//   (16.8 M) against 256 KB in and out: operations, far below the card's
//   rate.  One thread per (n, f) counts `cand < x` over all B from a copy of
//   the candidate grid in shared memory (rows padded to B + 1 floats so the
//   features of a warp fall on different banks).  No binary search: the
//   count is the JAX function by construction, NaN (count 0) and x equal to
//   a candidate included, so the result is exact.  Wide grids are cut into
//   feature chunks that fit the shared-memory budget (grid dimension y);
//   a feature with more candidates than fit is staged in ranges, each
//   range's count added to the element by the thread that owns it.
//
// K2 (hist[f, c, b] = sum_n [Xb[n, f] == b] nd[n, c]).  The TPU kernel
//   contracts a one-hot [N, F * 128k] against nd on the MXU; here the sum is
//   a scatter.  It must be deterministic: split choice rests on a 2e-6
//   relative tie band, so run-to-run noise from float atomics would make
//   tree structure flaky.  So no atomics:
//     pass 1: a block owns a tile of samples and 64 (f, c) pairs, one per
//             thread; each thread keeps a private histogram row of the
//             bucket range in shared memory and adds nd[n, c] into bucket
//             Xb[n, f] for n in increasing order (it alone writes the row),
//             then the block writes its rows to partial[tile];
//     pass 2: out = sum over tiles in tile order, one thread per bin.
//   The same inputs give the same bits on every launch.  Any C (grid
//   dimension y) and any number of buckets (bucket ranges, grid dimension z)
//   run by tiling; zero entries of nd (other nodes' columns) are skipped,
//   which leaves the sums' bits unchanged.  Bound: bytes (Xb and nd read,
//   the histogram written); the design is latency-bound on shared-memory
//   read-modify-writes.
//
// K3 (one level's split choice).  Reads the histogram [F, C, NB] that K2
//   writes, with no reshuffle.  Two launches:
//     score:  one block per (feature, node): sequential f32 prefix sums
//             over the buckets for the O + 1 columns of the node (and for
//             feature 0, whose totals are the node totals), then one thread
//             per candidate: L2 / cosine score, min-data mask, feature
//             weight, no-reuse mask, parent subtraction and NaN -> -inf
//             (greedy); the raw masked score (oblivious);
//     argmax: one block per node (greedy) or one block (oblivious, which
//             first sums the node rows in node order, then NaN -> -inf):
//             the row's max, then the first index within the 2e-6 relative
//             band (the parent score in the band's base).  Max and min are
//             exact in any order, so the argmax is deterministic.
//   Both steps are the device functions of score.cuh, which K6 (tree.cu)
//   runs too; their arithmetic repeats the plain PyTorch version's bit for
//   bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC
// (no fast-math: IEEE division and sqrtf).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_MAX_BLOCKS = 2048;
constexpr int K2_THREADS = 64;     // (f, c) pairs per pass-1 block
constexpr int K2_REDUCE_THREADS = 256;
constexpr int K3_THREADS = 256;

using gbrl::set_smem;

// ------------------------------------------------------------------- K1
__global__ void __launch_bounds__(K1_THREADS)
bucketize_kernel(const float* __restrict__ X, const float* __restrict__ cand,
                 int32_t* __restrict__ out, int N, int F, int B, int fc,
                 int bc) {
  // Candidates are staged bc at a time; each output element belongs to one
  // thread, which adds the count of every range to it (integer, exact).
  extern __shared__ float s_cand[];  // [fc][bc + 1]
  const int f0 = blockIdx.y * fc;
  const int nf = min(fc, F - f0);
  const size_t total = (size_t)N * nf;
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int nb = min(bc, B - b0);
    __syncthreads();
    for (int i = threadIdx.x; i < nf * nb; i += K1_THREADS) {
      const int r = i / nb, b = i - r * nb;
      s_cand[r * (bc + 1) + b] = cand[(size_t)(f0 + r) * B + b0 + b];
    }
    __syncthreads();
    for (size_t i = (size_t)blockIdx.x * K1_THREADS + threadIdx.x;
         i < total; i += (size_t)gridDim.x * K1_THREADS) {
      const size_t n = i / nf;
      const int r = (int)(i - n * nf);
      const size_t at = n * F + f0 + r;
      const float x = X[at];
      const float* c = s_cand + r * (bc + 1);
      int cnt = 0;
      for (int b = 0; b < nb; ++b) cnt += c[b] < x ? 1 : 0;
      out[at] = b0 == 0 ? cnt : out[at] + cnt;
    }
  }
}

// ------------------------------------------------------------------- K2
__global__ void __launch_bounds__(K2_THREADS)
level_hist_partial_kernel(const int32_t* __restrict__ Xb,
                          const float* __restrict__ nd,
                          float* __restrict__ part, int N, int F, int C,
                          int NB, int tile, int BR) {
  extern __shared__ float rows[];  // [K2_THREADS][BR]
  const int FC = F * C;
  const int j0 = blockIdx.y * K2_THREADS;
  const int j = j0 + threadIdx.x;
  const int b0 = blockIdx.z * BR;
  const int br = min(BR, NB - b0);
  float* row = rows + threadIdx.x * BR;
  for (int b = 0; b < br; ++b) row[b] = 0.0f;
  if (j < FC) {
    const int f = j / C, c = j - f * C;
    const int n0 = blockIdx.x * tile, n1 = min(N, n0 + tile);
    for (int n = n0; n < n1; ++n) {
      const float v = nd[(size_t)n * C + c];
      const int b = Xb[(size_t)n * F + f] - b0;
      // a zero term would leave the row's bits as they are: skip it
      if (v != 0.0f && (unsigned)b < (unsigned)br) row[b] += v;
    }
  }
  __syncthreads();
  const int jn = min(K2_THREADS, FC - j0);
  float* dst = part + ((size_t)blockIdx.x * FC + j0) * NB + b0;
  for (int i = threadIdx.x; i < jn * br; i += K2_THREADS) {
    const int r = i / br, b = i - r * br;
    dst[(size_t)r * NB + b] = rows[r * BR + b];
  }
}

__global__ void __launch_bounds__(K2_REDUCE_THREADS)
level_hist_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ out, int n_tiles, size_t M) {
  for (size_t i = (size_t)blockIdx.x * K2_REDUCE_THREADS + threadIdx.x; i < M;
       i += (size_t)gridDim.x * K2_REDUCE_THREADS) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t) s += part[(size_t)t * M + i];
    out[i] = s;
  }
}

// ------------------------------------------------------------------- K3
// stats[node] = (node gradient sums [O], node count, parent score)
__global__ void __launch_bounds__(K3_THREADS)
level_score_kernel(const float* __restrict__ hist,
                   const uint8_t* __restrict__ blocked,
                   const float* __restrict__ feat_w, float* __restrict__ adj,
                   float* __restrict__ stats, int F, int O, int NB, int B,
                   int cosine, float min_data, int oblivious, int is_root) {
  extern __shared__ float sm[];
  const int f = blockIdx.x, node = blockIdx.y, n_nodes = gridDim.y;
  const uint8_t* blk = blocked + ((size_t)node * F + f) * B;
  gbrl::score_feature_node(hist, feat_w, adj, stats, f, node, n_nodes, F, O,
                           NB, B, cosine, min_data, oblivious, is_root, sm,
                           [&](int b) { return blk[b] != 0; });
}

__global__ void __launch_bounds__(K3_THREADS)
level_argmax_kernel(const float* __restrict__ adj,
                    const float* __restrict__ stats,
                    int32_t* __restrict__ best_idx,
                    float* __restrict__ best_val, int n_nodes, int M, int O,
                    int oblivious) {
  __shared__ float shf[32];
  __shared__ int shi[32];
  const int node = blockIdx.x;
  int qi;
  float v;
  gbrl::argmax_node(adj, stats, node, n_nodes, M, O, oblivious, shf, shi, &qi,
                    &v);
  if (threadIdx.x == 0) {
    if (oblivious) {
      for (int n = 0; n < n_nodes; ++n) {
        best_idx[n] = qi;
        best_val[n] = v;
      }
    } else {
      best_idx[node] = qi;
      best_val[node] = v;
    }
  }
}

int last_error() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// Dynamic shared memory of one K1 / K2 / K3 block; the wrapper sizes the
// feature chunk, the candidate and bucket ranges and checks the device's
// limit with these.
size_t gbrl_k1_smem_bytes(int fc, int bc) {
  return sizeof(float) * (size_t)fc * (bc + 1);
}
size_t gbrl_k2_smem_bytes(int br) {
  return sizeof(float) * (size_t)K2_THREADS * br;
}
size_t gbrl_k3_smem_bytes(int O, int NB) {
  return sizeof(float) * gbrl::score_smem_floats(O, NB);
}
int gbrl_k2_block_pairs() { return K2_THREADS; }

// X [N, F] f32, cand [F, B] f32 ascending per row, out [N, F] i32.
// fc: features per block; bc: candidates per staged range (fc rows of bc
// candidates fit the shared memory).
int gbrl_k1_bucketize(const float* X, const float* cand, int32_t* out, int N,
                      int F, int B, int fc, int bc, void* stream) {
  const size_t bytes = gbrl_k1_smem_bytes(fc, bc);
  int err = set_smem((const void*)bucketize_kernel, bytes);
  if (err) return err;
  const size_t per_chunk = (size_t)N * fc;
  size_t blocks = (per_chunk + K1_THREADS - 1) / K1_THREADS;
  if (blocks > K1_MAX_BLOCKS) blocks = K1_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)((F + fc - 1) / fc));
  bucketize_kernel<<<grid, K1_THREADS, bytes, (cudaStream_t)stream>>>(
      X, cand, out, N, F, B, fc, bc);
  return last_error();
}

// Xb [N, F] i32, nd [N, C] f32 -> out [F, C, NB] f32 (layout [F * C][NB]).
// part: scratch [n_tiles, F * C, NB] (unused and may be out when
// n_tiles == 1); tile: samples per pass-1 block; BR: buckets per range.
int gbrl_k2_level_histogram(const int32_t* Xb, const float* nd, float* part,
                            float* out, int N, int F, int C, int NB, int tile,
                            int n_tiles, int BR, void* stream) {
  const size_t bytes = gbrl_k2_smem_bytes(BR);
  int err = set_smem((const void*)level_hist_partial_kernel, bytes);
  if (err) return err;
  float* dst = n_tiles == 1 ? out : part;
  const dim3 grid((unsigned)n_tiles,
                  (unsigned)((F * C + K2_THREADS - 1) / K2_THREADS),
                  (unsigned)((NB + BR - 1) / BR));
  level_hist_partial_kernel<<<grid, K2_THREADS, bytes, (cudaStream_t)stream>>>(
      Xb, nd, dst, N, F, C, NB, tile, BR);
  err = last_error();
  if (err || n_tiles == 1) return err;
  const size_t M = (size_t)F * C * NB;
  size_t blocks = (M + K2_REDUCE_THREADS - 1) / K2_REDUCE_THREADS;
  if (blocks > 4096) blocks = 4096;
  level_hist_reduce_kernel<<<(unsigned)blocks, K2_REDUCE_THREADS, 0,
                             (cudaStream_t)stream>>>(part, out, n_tiles, M);
  return last_error();
}

// hist [F, n_nodes * (O + 1), NB] f32; blocked [n_nodes, F, B] u8;
// feat_w [F] f32; adj: scratch [n_nodes, F * B] f32; stats [n_nodes, O + 2]
// f32 (sums, count, parent); best_idx [n_nodes] i32 (f * B + b);
// best_val [n_nodes] f32.  min_data <= 0 disables the min-data mask.
int gbrl_k3_level_score(const float* hist, const uint8_t* blocked,
                        const float* feat_w, float* adj, float* stats,
                        int32_t* best_idx, float* best_val, int F,
                        int n_nodes, int O, int NB, int B, int cosine,
                        float min_data, int oblivious, int is_root,
                        void* stream) {
  const size_t bytes = gbrl_k3_smem_bytes(O, NB);
  int err = set_smem((const void*)level_score_kernel, bytes);
  if (err) return err;
  level_score_kernel<<<dim3((unsigned)F, (unsigned)n_nodes), K3_THREADS, bytes,
                       (cudaStream_t)stream>>>(hist, blocked, feat_w, adj,
                                               stats, F, O, NB, B, cosine,
                                               min_data, oblivious, is_root);
  err = last_error();
  if (err) return err;
  level_argmax_kernel<<<oblivious ? 1 : n_nodes, K3_THREADS, 0,
                        (cudaStream_t)stream>>>(adj, stats, best_idx, best_val,
                                                n_nodes, F * B, O, oblivious);
  return last_error();
}

}  // extern "C"
