// Whole-tree kernel (K6): one cooperative launch fits one numeric tree.
//
// Replaces (gbrl_tpu/ops/pallas_kernels.py):
//   gbrl_k6_tree_build <- tree_build_pallas (K6)
//
// For each level d < D (at most NPMAX = 8 nodes, so depth <= 4) the kernel
// builds the (feature, node, bucket) gradient histogram, takes the prefix
// sums, scores the candidates, applies the no-reuse and min-data masks and
// the feature weights, picks each node's split (greedy) or the level's
// (oblivious) with the tolerance argmax, and the next level routes its
// samples through the stored choices; at the end it sums the leaves.  One
// launch per tree, where the level path (K2 + K3 and the glue between them)
// takes about fifty.
//
// Shapes on the PPO path: a minibatch of N = 512 rows, F = 4 features,
// B = 256 candidates (NB = 257 buckets), O = 3 outputs, depth 4; the bench
// shape is N = 4096, F = 16.
//
// What bounds it on an H100: the function reads Xb, bgw and wg once (under
// 0.5 MB) and does about N F D + F B D (O + 8) operations: a few
// microseconds of bytes or operations at most.  This design is bound by
// latency instead: sixteen grid barriers, sequential per-thread sums
// (deterministic by construction), and few busy threads at the top levels.
//
// The design, one persistent grid of resident blocks (a cooperative launch;
// blocks take work items in a grid-stride loop, so any N and F run), per
// level:
//   H  histograms: a work item is (sample tile, feature).  The block routes
//      the tile's samples through the choices of the levels above (into
//      shared memory, ROUTE_CHUNK at a time); thread c owns column
//      c = node * (O + 1) + k and a private histogram row of NB buckets in
//      shared memory, and adds bgw[n, k] into bucket Xb[n, f] for the
//      tile's samples of that node in increasing n.  The rows go to
//      part[tile].  No atomics.
//   R  one thread per (feature, column, bucket) sums part over the tiles in
//      tile order -> hist [F, 2^d (O + 1), NB], the layout K3 reads;
//   S  a work item is (node, feature): score.cuh's score_feature_node, the
//      same code as K3's, with the no-reuse mask read from the ancestors'
//      choices (a candidate is blocked when an ancestor split on its feature
//      at the same threshold value, node.cpp:153-166);
//   A  a work item is a node (greedy) or the level (oblivious):
//      score.cuh's argmax_node (the global max over all F B candidates, then
//      the first index within the band), then the split flag: greedy
//      val >= 0 and count > 0, oblivious alive (the previous level's flag)
//      and val > -inf.  Nodes 2^d..NPMAX-1 never split.
// with a grid barrier after each step.  Then the leaves: each tile's
// samples routed through all D levels, wg summed per leaf in sample order
// into lpart[tile], a barrier, and the tiles summed in tile order.
//
// Every sum has a fixed order, so two launches give the same bits, and the
// plain PyTorch version (ops/kernels.py tree_build_plain) repeats each
// order exactly: per tile in sample order, then over the tiles in order;
// prefix sums and scores as K3.  Zero terms are skipped, which leaves a sum
// starting at +0 unchanged.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC
// (no fast-math; grid.sync() needs no -rdc).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NPMAX = 8;           // nodes per level: depth <= 4
constexpr int K6_THREADS = 256;
constexpr int ROUTE_CHUNK = 1024;  // samples routed into shared memory at once

struct TreeArgs {
  // inputs
  const int32_t* Xb;     // [N, F] bucket ids in [0, B]
  const float* cand;     // [F, B] candidate values
  const float* feat_w;   // [F]
  const float* bgw;      // [N, O + 1] build_grads * w | w (scores)
  const float* wg;       // [N, O + 1] grads * w | w (leaves)
  // scratch (written and read back inside the launch)
  float* part;           // [n_tiles, F, 2^(D-1) (O + 1), NB]
  float* hist;           // [F, 2^(D-1) (O + 1), NB]
  float* adj;            // [2^(D-1), F B]
  float* nstat;          // [NPMAX, O + 2] node sums, count, parent
  float* lpart;          // [n_tiles, 2^D, O + 1]
  // outputs
  int32_t* best_idx;     // [D, NPMAX] f * B + b
  uint8_t* do_split;     // [D, NPMAX]
  float* stats;          // [D, NPMAX, O + 3] best, count, parent, sums [O]
  float* leaf;           // [2^D, O + 1] wg sums per leaf
  int N, F, B, O, D, tile, n_tiles, cosine, oblivious;
  float min_data;
};

// Level-`upto` node of sample n under the stored choices of levels < upto:
// right when the node splits and the bucket is above the chosen one.
__device__ __forceinline__ int route(const TreeArgs& a, int n, int upto) {
  int rel = 0;
  for (int l = 0; l < upto; ++l) {
    const int i = l * NPMAX + rel;
    int go = 0;
    if (a.do_split[i]) {
      const int q = a.best_idx[i];
      const int f = q / a.B;
      go = a.Xb[(size_t)n * a.F + f] > q - f * a.B;
    }
    rel = 2 * rel + go;
  }
  return rel;
}

// Candidate (f, b) of a level-d node is blocked when an ancestor that split
// chose feature f at the same candidate value.
__device__ __forceinline__ bool blocked(const TreeArgs& a, int d, int node,
                                        int f, int b) {
  const float v = a.cand[(size_t)f * a.B + b];
  for (int l = 0; l < d; ++l) {
    const int i = l * NPMAX + (node >> (d - l));
    if (!a.do_split[i]) continue;
    const int q = a.best_idx[i];
    if (q / a.B == f && a.cand[q] == v) return true;
  }
  return false;
}

// Samples [n0, n1) of one work item, routed to level `upto`, ROUTE_CHUNK at
// a time into rel_s; body(c0, c1) consumes each chunk.
template <class Body>
__device__ void for_routed_chunks(const TreeArgs& a, int n0, int n1, int upto,
                                  int* rel_s, Body body) {
  for (int c0 = n0; c0 < n1; c0 += ROUTE_CHUNK) {
    const int c1 = min(n1, c0 + ROUTE_CHUNK);
    __syncthreads();   // the previous chunk is consumed
    for (int n = c0 + threadIdx.x; n < c1; n += blockDim.x)
      rel_s[n - c0] = route(a, n, upto);
    __syncthreads();
    body(c0, c1);
  }
}

__device__ void histogram_step(const TreeArgs& a, int d, int* rel_s,
                               float* rows) {
  const int K = a.O + 1, NB = a.B + 1, Cd = (1 << d) * K;
  for (int item = blockIdx.x; item < a.F * a.n_tiles; item += gridDim.x) {
    const int t = item / a.F, f = item - t * a.F;
    const int n0 = t * a.tile, n1 = min(a.N, n0 + a.tile);
    __syncthreads();   // the previous item's rows are written out
    for (int i = threadIdx.x; i < Cd * NB; i += blockDim.x) rows[i] = 0.0f;
    for_routed_chunks(a, n0, n1, d, rel_s, [&](int c0, int c1) {
      for (int c = threadIdx.x; c < Cd; c += blockDim.x) {
        const int node = c / K, k = c - node * K;
        float* row = rows + c * NB;
        for (int n = c0; n < c1; ++n) {
          if (rel_s[n - c0] != node) continue;
          const float v = a.bgw[(size_t)n * K + k];
          const int b = a.Xb[(size_t)n * a.F + f];
          // a zero term would leave the row's bits as they are: skip it
          if (v != 0.0f && (unsigned)b < (unsigned)NB) row[b] += v;
        }
      }
    });
    __syncthreads();
    float* dst = a.part + ((size_t)t * a.F + f) * Cd * NB;
    for (int i = threadIdx.x; i < Cd * NB; i += blockDim.x) dst[i] = rows[i];
  }
}

__device__ void reduce_tiles(const float* part, float* out, int n_tiles,
                             size_t M) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += stride) {
    float s = 0.0f;
    for (int t = 0; t < n_tiles; ++t) s = __fadd_rn(s, part[(size_t)t * M + i]);
    out[i] = s;
  }
}

__device__ void score_step(const TreeArgs& a, int d, float* work) {
  const int nact = 1 << d;
  for (int item = blockIdx.x; item < a.F * nact; item += gridDim.x) {
    const int node = item / a.F, f = item - node * a.F;
    __syncthreads();   // the previous item's shared memory is consumed
    gbrl::score_feature_node(a.hist, a.feat_w, a.adj, a.nstat, f, node, nact,
                             a.F, a.O, a.B + 1, a.B, a.cosine, a.min_data,
                             a.oblivious, d == 0, work,
                             [&](int b) { return blocked(a, d, node, f, b); });
  }
}

__device__ void put_choice(const TreeArgs& a, int d, int n, int q, float v,
                           bool split) {
  const int i = d * NPMAX + n;
  a.best_idx[i] = q;
  a.do_split[i] = split ? 1 : 0;
  float* st = a.stats + (size_t)i * (a.O + 3);
  const float* ns = a.nstat + (size_t)n * (a.O + 2);
  st[0] = v;
  st[1] = ns[a.O];
  st[2] = ns[a.O + 1];
  for (int o = 0; o < a.O; ++o) st[3 + o] = ns[o];
}

__device__ void select_step(const TreeArgs& a, int d, float* shf, int* shi) {
  const int nact = 1 << d;
  const int items = a.oblivious ? 1 : nact;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    int q;
    float v;
    gbrl::argmax_node(a.adj, a.nstat, item, nact, a.F * a.B, a.O, a.oblivious,
                      shf, shi, &q, &v);
    if (threadIdx.x != 0) continue;
    if (a.oblivious) {
      const bool alive =
          (d == 0 || a.do_split[(d - 1) * NPMAX]) && v > -INFINITY;
      for (int n = 0; n < nact; ++n) put_choice(a, d, n, q, v, alive);
    } else {
      const float ct = a.nstat[(size_t)item * (a.O + 2) + a.O];
      put_choice(a, d, item, q, v, v >= 0.0f && ct > 0.0f);
    }
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (int n = nact + threadIdx.x; n < NPMAX; n += blockDim.x) {
      const int i = d * NPMAX + n;
      a.best_idx[i] = 0;
      a.do_split[i] = 0;
      for (int j = 0; j < a.O + 3; ++j) a.stats[(size_t)i * (a.O + 3) + j] = 0.0f;
    }
  }
}

__device__ void leaf_step(const TreeArgs& a, int* rel_s, float* lacc) {
  const int K = a.O + 1, LK = (1 << a.D) * K;
  for (int t = blockIdx.x; t < a.n_tiles; t += gridDim.x) {
    const int n0 = t * a.tile, n1 = min(a.N, n0 + a.tile);
    __syncthreads();   // the previous tile's sums are written out
    for (int i = threadIdx.x; i < LK; i += blockDim.x) lacc[i] = 0.0f;
    for_routed_chunks(a, n0, n1, a.D, rel_s, [&](int c0, int c1) {
      for (int c = threadIdx.x; c < LK; c += blockDim.x) {
        const int l = c / K, k = c - l * K;
        float s = lacc[c];
        for (int n = c0; n < c1; ++n) {
          if (rel_s[n - c0] != l) continue;
          const float v = a.wg[(size_t)n * K + k];
          if (v != 0.0f) s += v;
        }
        lacc[c] = s;
      }
    });
    __syncthreads();
    for (int i = threadIdx.x; i < LK; i += blockDim.x)
      a.lpart[(size_t)t * LK + i] = lacc[i];
  }
}

__global__ void __launch_bounds__(K6_THREADS) tree_build_kernel(TreeArgs a) {
  extern __shared__ float sm[];
  __shared__ float shf[32];
  __shared__ int shi[32];
  int* rel_s = reinterpret_cast<int*>(sm);     // [ROUTE_CHUNK]
  float* work = sm + ROUTE_CHUNK;              // rows / scores / leaf sums
  cg::grid_group grid = cg::this_grid();
  const int K = a.O + 1, NB = a.B + 1;
  for (int d = 0; d < a.D; ++d) {
    histogram_step(a, d, rel_s, work);
    grid.sync();
    reduce_tiles(a.part, a.hist, a.n_tiles, (size_t)a.F * (1 << d) * K * NB);
    grid.sync();
    score_step(a, d, work);
    grid.sync();
    select_step(a, d, shf, shi);
    grid.sync();
  }
  leaf_step(a, rel_s, work);
  grid.sync();
  reduce_tiles(a.lpart, a.leaf, a.n_tiles, (size_t)(1 << a.D) * K);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one K6 block: the routed nodes of a chunk, then
// the largest of the deepest level's histogram rows, K3's scoring space and
// the leaf sums.
size_t gbrl_k6_smem_bytes(int O, int B, int D) {
  const size_t K = O + 1, NB = B + 1;
  size_t work = ((size_t)1 << (D - 1)) * K * NB;
  const size_t leaf = ((size_t)1 << D) * K;
  if (leaf > work) work = leaf;
  if (gbrl::score_smem_floats(O, NB) > work) work = gbrl::score_smem_floats(O, NB);
  return sizeof(float) * (ROUTE_CHUNK + work);
}

// Xb [N, F] i32; cand [F, B] f32; feat_w [F]; bgw, wg [N, O + 1] f32;
// scratch and outputs as TreeArgs (the wrapper allocates them); tile:
// samples per work item, n_tiles = ceil(N / tile).  min_data <= 0 disables
// the min-data mask.  Returns 0 or the CUDA error of the launch (a grid the
// card cannot hold resident is refused, never run in part).
int gbrl_k6_tree_build(const int32_t* Xb, const float* cand,
                       const float* feat_w, const float* bgw, const float* wg,
                       float* part, float* hist, float* adj, float* nstat,
                       float* lpart, int32_t* best_idx, uint8_t* do_split,
                       float* stats, float* leaf, int N, int F, int B, int O,
                       int D, int tile, int n_tiles, int cosine,
                       float min_data, int oblivious, void* stream) {
  TreeArgs a{Xb,   cand,     feat_w,   bgw,   wg,   part,   hist,
             adj,  nstat,    lpart,    best_idx, do_split, stats, leaf,
             N,    F,        B,        O,     D,    tile,   n_tiles,
             cosine, oblivious, min_data};
  const size_t bytes = gbrl_k6_smem_bytes(O, B, D);
  int err = gbrl::set_smem((const void*)tree_build_kernel, bytes);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (err) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, tree_build_kernel, K6_THREADS, bytes);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  int want = F * n_tiles;
  if (F * (1 << (D - 1)) > want) want = F * (1 << (D - 1));
  const int grid = want < per_sm * sms ? (want > 0 ? want : 1) : per_sm * sms;
  void* args[] = {&a};
  err = (int)cudaLaunchCooperativeKernel((const void*)tree_build_kernel, grid,
                                         K6_THREADS, args, bytes,
                                         (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"
