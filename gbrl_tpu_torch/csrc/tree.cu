// Whole-tree kernel (K6): one thread-block cluster fits one numeric tree.
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
// microseconds of bytes or operations at most.  It is bound by latency:
// barriers, the 257-step prefix chains, the samples each block walks.
//
// The design: one cluster of S <= 16 blocks per tree (16 is past the
// portable 8: the kernel allows non-portable sizes, the launch is checked
// once per shape with cudaOccupancyMaxActiveClusters, and on an H100 16
// ranks beat 8 on greedy trees at both shapes), launched with
// cudaLaunchKernelEx; a cluster's blocks are co-resident by construction,
// so cluster.sync() (a hardware barrier) separates the steps and no grid
// barrier or cooperative launch is needed.
// Rank r takes the samples [r tile, (r + 1) tile) (rank order = sample
// order).  Per level, per group of g_d features (as many as the histogram
// budget holds):
//   H  each rank walks its tile K6_SUB samples at a time: it routes them
//      through the stored choices, stages their gradient rows and bucket
//      ids with every load in flight, and lists each node's samples (a
//      ballot per 32); warp w owns the (feature, column) pairs w, w + 16, ...
//      and takes its node's list 32 samples at a time, lanes with equal
//      buckets grouped by one ballot per bucket bit and added by the lowest
//      in lane order (K2's pattern): every bin of a rank is the sequential
//      sum of its terms in sample order, zero terms skipped;
//   R  after cluster.sync() each rank owns units of the group, round robin:
//      a (feature, node) with its O + 1 rows (greedy) or a feature with all
//      its nodes' rows (oblivious); it sums each row over the ranks' copies
//      in rank order through distributed shared memory and takes the prefix
//      sums from shared memory (score.cuh scan_rows); the owners of feature
//      0 publish the node totals;
//   S  after a second cluster.sync() every rank reads the node totals from
//      their owners and scores its units' candidates with score.cuh's
//      candidate_score (greedy: greedy_value; oblivious: the sum over the
//      nodes in node order, then NaN -> -inf), the values kept in shared
//      memory (in global memory only where a rank's candidates outgrow its
//      budget, read back by the same block).
// Then the choice of each node: the ranks' maxima per node exchanged and
// reduced, every rank's first index within the 2e-6 band, the lowest over
// the ranks (max and min are exact in any order); every rank stores the
// choices in its own shared memory for the next level's routing and the
// no-reuse mask (a candidate is blocked when an ancestor split on its
// feature at the same candidate value, node.cpp:153-166); rank 0 writes
// them out.  After the last level each rank sums wg per leaf over its tile
// in sample order and rank 0 sums the ranks in rank order.
//
// Every sum has a fixed order, so two launches give the same bits, and the
// plain PyTorch version (ops/kernels.py tree_build_plain) repeats each order
// exactly with the plan's tile: per tile in sample order, then over the tiles
// in order; prefix sums and scores as K3.  Zero terms are skipped, which
// leaves a sum that starts at +0 unchanged.  The plan (cluster size, tile,
// groups, shared-memory layout) comes from the shapes alone
// (ops/kernels.py _tree_plan) and is passed as an int array.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC
// (no fast-math).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NPMAX = 8;           // nodes per level: depth <= 4
constexpr int K6_WARPS = 16;       // ops/kernels.py TREE_WARPS
constexpr int K6_THREADS = 32 * K6_WARPS;
constexpr int K6_SUB = 256;        // samples per staged sub-tile (TREE_SUB)
constexpr int K6_MAX_CLUSTER = 16;   // TREE_MAX_CLUSTER (non-portable)
constexpr int K6_RANKS_AT_ONCE = 8;  // remote loads in flight per element
constexpr int BIG = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

// The plan's int array (ops/kernels.py _tree_params), in this order.
enum {
  P_N, P_F, P_B, P_O, P_D, P_COSINE, P_OBLIVIOUS, P_S, P_TILE, P_G0,
  P_SLOTS = P_G0 + 4, P_SC_GLOBAL, P_PART_GLOBAL, P_RED_GLOBAL, P_PART_SIZE,
  P_RED_SIZE, P_GMAX, P_PART, P_RED, P_SC, P_SLOT, P_V,
  P_XB, P_REL, P_LIST, P_CNT, P_TOTOWN, P_TOT, P_XCH, P_CHOICE, P_LEAF,
  P_SHF, P_SHI, P_SCR, P_SMEM, P_COUNT
};

struct TreeArgs {
  const int32_t* Xb;     // [N, F] bucket ids in [0, B]
  const float* cand;     // [F, B] candidate values
  const float* feat_w;   // [F]
  const float* bgw;      // [N, O + 1] build_grads * w | w (scores)
  const float* wg;       // [N, O + 1] grads * w | w (leaves)
  float* scg;            // global scratch where the plan needs it: [S] x
                         // candidate values | histograms | reduced rows
  int32_t* best_idx;     // [D, NPMAX] f * B + b
  uint8_t* do_split;     // [D, NPMAX]
  float* stats;          // [D, NPMAX, O + 3] best, count, parent, sums [O]
  float* leaf;           // [2^D, O + 1] wg sums per leaf
  float min_data;
  int p[P_COUNT];
};

// Level-`upto` node of sample n under the stored choices of levels < upto:
// right when the node splits and the bucket is above the chosen one.
__device__ __forceinline__ int route(const TreeArgs& a, const int* cq,
                                     const int* csp, int n, int upto) {
  const int B = a.p[P_B];
  int rel = 0;
  for (int l = 0; l < upto; ++l) {
    const int i = l * NPMAX + rel;
    int go = 0;
    if (csp[i]) {
      const int q = cq[i], f = q / B;
      go = __ldg(a.Xb + (size_t)n * a.p[P_F] + f) > q - f * B;
    }
    rel = 2 * rel + go;
  }
  return rel;
}

// Candidate (f, b) of a level-d node is blocked when an ancestor that split
// chose feature f at the same candidate value.
__device__ __forceinline__ bool blocked(const TreeArgs& a, const int* cq,
                                        const int* csp, int d, int node,
                                        int f, int b) {
  if (d == 0) return false;
  const int B = a.p[P_B];
  const float v = __ldg(a.cand + (size_t)f * B + b);
  for (int l = 0; l < d; ++l) {
    const int i = l * NPMAX + (node >> (d - l));
    if (!csp[i]) continue;
    const int q = cq[i];
    if (q / B == f && __ldg(a.cand + q) == v) return true;
  }
  return false;
}

// Stages samples [s0, s0 + ns): their node at level `upto`, their rows of
// `src` [ns][K] (at the odd stride K | 1) and their bucket ids of features
// [ga, ga + ng) [ns][gmax | 1] (odd strides: the lanes of a warp, on
// neighbouring samples, read different banks).
__device__ void stage_sub(const TreeArgs& a, int s0, int ns, int upto,
                          const float* src, int ga, int ng, const int* cq,
                          const int* csp, int* rel, float* v, int* xb) {
  const int K = a.p[P_O] + 1, F = a.p[P_F];
  const int Kp = gbrl::odd_stride(K), gp = gbrl::odd_stride(a.p[P_GMAX]);
  for (int i = threadIdx.x; i < ns; i += K6_THREADS)
    rel[i] = route(a, cq, csp, s0 + i, upto);
#pragma unroll 8
  for (int i = threadIdx.x; i < ns * K; i += K6_THREADS) {
    const int n = i / K;
    v[n * Kp + i - n * K] = __ldg(src + (size_t)s0 * K + i);
  }
#pragma unroll 8
  for (int i = threadIdx.x; i < ns * ng; i += K6_THREADS) {
    const int n = i / ng, j = i - n * ng;
    xb[n * gp + j] = __ldg(a.Xb + (size_t)(s0 + n) * F + ga + j);
  }
}

// Warp w < n_lists lists the staged samples whose node is w, in order.
__device__ void build_lists(int ns, int n_lists, const int* rel,
                            uint16_t* list, int* cnt) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int L = w; L < n_lists; L += K6_WARPS) {
    int c = 0;
    for (int m0 = 0; m0 < ns; m0 += 32) {
      const int n = m0 + lane;
      const bool in = n < ns && rel[n] == L;
      const unsigned bal = __ballot_sync(FULL, in);
      if (in)
        list[L * K6_SUB + c + __popc(bal & ((1u << lane) - 1u))] =
            (uint16_t)n;
      c += __popc(bal);
    }
    if (lane == 0) cnt[L] = c;
  }
}

// Per-node max (lm) and min (mq) over the block, into out[0..NPMAX).
__device__ __forceinline__ void node_max(const float (&lm)[NPMAX], float* shf,
                                         float* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NPMAX; ++i) {
    float v = lm[i];
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
    if (lane == 0) shf[w * NPMAX + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NPMAX) {
    float v = -INFINITY;
    for (int ww = 0; ww < K6_WARPS; ++ww)
      v = fmaxf(v, shf[ww * NPMAX + threadIdx.x]);
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

__device__ __forceinline__ void node_min(const int (&mq)[NPMAX], int* shi,
                                         int* out) {
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < NPMAX; ++i) {
    int v = mq[i];
    for (int o = 16; o > 0; o >>= 1)
      v = min(v, __shfl_xor_sync(FULL, v, o));
    if (lane == 0) shi[w * NPMAX + i] = v;
  }
  __syncthreads();
  if (threadIdx.x < NPMAX) {
    int v = BIG;
    for (int ww = 0; ww < K6_WARPS; ++ww)
      v = min(v, shi[ww * NPMAX + threadIdx.x]);
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(K6_THREADS) tree_build_kernel(
    const TreeArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int* p = a.p;
  const int N = p[P_N], F = p[P_F], B = p[P_B], O = p[P_O], D = p[P_D];
  const int K = O + 1, NB = B + 1, NBp = gbrl::odd_stride(NB);
  const int NBq = (NB + 3) & ~3;           // part's rows: float4 aligned
  const int cosine = p[P_COSINE], obl = p[P_OBLIVIOUS];
  const int Kp = gbrl::odd_stride(K), gp = gbrl::odd_stride(p[P_GMAX]);
  // global scratch, where shared memory cannot hold a region: each rank's
  // candidate values, then histograms (read by the other ranks after the
  // cluster barrier, which orders global memory too), then reduced rows
  // (each section rounded up to whole float4, as ops/kernels.py sizes it)
  const size_t gsc = p[P_SC_GLOBAL] ? ((size_t)p[P_SLOTS] * B + 3) & ~3 : 0;
  const size_t gpart = p[P_PART_GLOBAL] ? ((size_t)p[P_PART_SIZE] + 3) & ~3
                                        : 0;
  float* gpart0 = a.scg + S * gsc;         // rank 0's histograms
  float* part = p[P_PART_GLOBAL] ? gpart0 + rank * gpart
                                 : sm + p[P_PART];  // [g][Cd][NBq]
  float* red = p[P_RED_GLOBAL]
                   ? gpart0 + S * gpart + (size_t)rank * p[P_RED_SIZE]
                   : sm + p[P_RED];        // owned units' rows [.][NBp]
  float* sc = p[P_SC_GLOBAL] ? a.scg + rank * gsc
                             : sm + p[P_SC];  // candidate values [slots][B]
  int* slot = reinterpret_cast<int*>(sm + p[P_SLOT]);  // [slots][2] f, node
  float* sv = sm + p[P_V];                 // [K6_SUB][K | 1]
  int* sxb = reinterpret_cast<int*>(sm + p[P_XB]);     // [K6_SUB][gmax | 1]
  int* srel = reinterpret_cast<int*>(sm + p[P_REL]);   // [K6_SUB]
  uint16_t* list = reinterpret_cast<uint16_t*>(sm + p[P_LIST]);
  int* cnt = reinterpret_cast<int*>(sm + p[P_CNT]);    // [2^D]
  float* totown = sm + p[P_TOTOWN];        // [NPMAX][K] published totals
  float* tot = sm + p[P_TOT];              // [NPMAX][K + 1] totals, parent
  float* xmax = sm + p[P_XCH];             // [NPMAX] exchanged maxima
  int* xq = reinterpret_cast<int*>(xmax + NPMAX);      // [NPMAX] indices
  float* xv = xmax + 2 * NPMAX;            // [NPMAX] values there
  float* lim = xmax + 3 * NPMAX;           // [NPMAX] band limits
  int* selq = reinterpret_cast<int*>(xmax + 4 * NPMAX);
  float* selv = xmax + 5 * NPMAX;
  int* cq = reinterpret_cast<int*>(sm + p[P_CHOICE]);  // [4][NPMAX]
  int* csp = cq + 4 * NPMAX;                           // [4][NPMAX]
  float* lp = sm + p[P_LEAF];              // [2^D][K]
  float* shf = sm + p[P_SHF];
  int* shi = reinterpret_cast<int*>(sm + p[P_SHI]);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  float* scr = sm + p[P_SCR] + 32 * w;     // [K6_WARPS][32] lanes' terms
  const int n0 = min(N, rank * p[P_TILE]), n1 = min(N, n0 + p[P_TILE]);
  const int kbits = NB > 1 ? 32 - __clz(NB - 1) : 0;

  for (int d = 0; d < D; ++d) {
    const int nact = 1 << d, Cd = nact * K, g = p[P_G0 + d];
    const int nu = obl ? 1 : nact, ru = (obl ? nact : 1) * K;
    int slot0 = 0;
    for (int ga = 0; ga < F; ga += g) {
      const int ng = min(g, F - ga), U = ng * nu;
      const int own = U > rank ? (U - rank + S - 1) / S : 0;
      // H: this rank's histogram of the group over its tile
      for (int i = tid; i < ng * Cd * NBq; i += K6_THREADS) part[i] = 0.0f;
      for (int s0 = n0; s0 < n1; s0 += K6_SUB) {
        const int ns = min(K6_SUB, n1 - s0);
        __syncthreads();
        stage_sub(a, s0, ns, d, a.bgw, ga, ng, cq, csp, srel, sv, sxb);
        __syncthreads();
        build_lists(ns, nact, srel, list, cnt);
        __syncthreads();
        for (int pr = w; pr < ng * Cd; pr += K6_WARPS) {
          const int j = pr / Cd, c = pr - j * Cd;
          const int node = c / K, k = c - node * K;
          float* row = part + ((size_t)j * Cd + c) * NBq;
          const uint16_t* L = list + node * K6_SUB;
          const int len = cnt[node];
          for (int i0 = 0; i0 < len; i0 += 32) {
            const int i = i0 + lane;
            int key = -1;
            float v = 0.0f;
            if (i < len) {
              const int n = L[i];
              v = sv[n * Kp + k];
              const int bl = sxb[n * gp + j];
              if (v != 0.0f && (unsigned)bl < (unsigned)NB) key = bl;
            }
            scr[lane] = v;
            unsigned grp = __ballot_sync(FULL, key >= 0);
            for (int bit = 0; bit < kbits; ++bit) {
              const bool on = (key >> bit) & 1;
              const unsigned m = __ballot_sync(FULL, on);
              grp &= on ? m : ~m;
            }
            __syncwarp();
            if (key >= 0 && lane == __ffs(grp) - 1) {
              float acc = row[key];
              for (unsigned m = grp; m; m &= m - 1u)
                acc = __fadd_rn(acc, scr[__ffs(m) - 1]);
              row[key] = acc;
            }
            __syncwarp();
          }
        }
      }
      cluster.sync();
      // R: the owned units' rows summed over the ranks in rank order, four
      // buckets at a time
      const int nq = NBq / 4;
      for (int e = tid; e < own * ru * nq; e += K6_THREADS) {
        const int row = e / nq, q = e - row * nq;
        const int t = row / ru, rr = row - t * ru, u = rank + t * S;
        const int j = u / nu, node = obl ? rr / K : u - j * nu;
        const size_t at = ((size_t)j * Cd + node * K + rr % K) * nq + q;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int r0 = 0; r0 < S; r0 += K6_RANKS_AT_ONCE) {
          float4 v[K6_RANKS_AT_ONCE];
#pragma unroll
          for (int r = 0; r < K6_RANKS_AT_ONCE; ++r)
            if (r0 + r < S)
              v[r] = reinterpret_cast<const float4*>(
                  p[P_PART_GLOBAL] ? gpart0 + (r0 + r) * gpart
                                   : cluster.map_shared_rank(part, r0 + r))[at];
#pragma unroll
          for (int r = 0; r < K6_RANKS_AT_ONCE; ++r) {
            if (r0 + r < S) {
              acc.x = __fadd_rn(acc.x, v[r].x);
              acc.y = __fadd_rn(acc.y, v[r].y);
              acc.z = __fadd_rn(acc.z, v[r].z);
              acc.w = __fadd_rn(acc.w, v[r].w);
            }
          }
        }
        float* dst = red + (size_t)row * NBp + 4 * q;
        const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (4 * q + c < NB) dst[c] = vals[c];
      }
      __syncthreads();
      gbrl::scan_rows(red, own * ru, NB, NBp);
      __syncthreads();
      if (ga == 0) {
        // the owners of feature 0 publish the node totals
        for (int e = tid; e < own * ru; e += K6_THREADS) {
          const int t = e / ru, rr = e - t * ru, u = rank + t * S;
          if (u < nu) {                       // feature 0
            const int node = obl ? rr / K : u;
            totown[node * K + rr % K] = red[(size_t)e * NBp + NB - 1];
          }
        }
      }
      cluster.sync();
      if (ga == 0) {
        for (int e = tid; e < nact * K; e += K6_THREADS) {
          const int node = e / K;
          tot[node * (K + 1) + e % K] =
              cluster.map_shared_rank(totown, obl ? 0 : node % S)[e];
        }
        __syncthreads();
        for (int node = tid; node < nact; node += K6_THREADS) {
          float* t = tot + node * (K + 1);
          t[K] = d == 0 ? 0.0f : gbrl::node_parent(t, O, cosine);
        }
        __syncthreads();
      }
      // S: the owned units' candidate values
      for (int e = tid; e < own * B; e += K6_THREADS) {
        const int t = e / B, b = e - t * B, u = rank + t * S;
        const int j = u / nu, f = ga + j;
        const float fw = __ldg(a.feat_w + f);
        float v;
        if (!obl) {
          const int node = u - j * nu;
          const float* tn = tot + node * (K + 1);
          const float s = gbrl::candidate_score(
              red + (size_t)t * K * NBp, NBp, tn, O, b, cosine, a.min_data,
              fw);
          v = gbrl::greedy_value(s, blocked(a, cq, csp, d, node, f, b),
                                 tn[K]);
        } else {
          float acc = 0.0f;
          for (int node = 0; node < nact; ++node) {
            float s = gbrl::candidate_score(
                red + ((size_t)t * ru + node * K) * NBp, NBp,
                tot + node * (K + 1), O, b, cosine, a.min_data, fw);
            if (blocked(a, cq, csp, d, node, f, b)) s = -INFINITY;
            acc = __fadd_rn(acc, s);
          }
          v = isnan(acc) ? -INFINITY : acc;
        }
        sc[(size_t)(slot0 + t) * B + b] = v;
      }
      for (int t = tid; t < own; t += K6_THREADS) {
        const int u = rank + t * S, j = u / nu;
        slot[2 * (slot0 + t)] = ga + j;
        slot[2 * (slot0 + t) + 1] = obl ? 0 : u - j * nu;
      }
      slot0 += own;
    }
    __syncthreads();
    // the choice: max per node over the cluster, then the first index
    // within the band, the lowest over the ranks
    const int nsel = obl ? 1 : nact;
    float lm[NPMAX];
#pragma unroll
    for (int i = 0; i < NPMAX; ++i) lm[i] = -INFINITY;
    for (int e = tid; e < slot0 * B; e += K6_THREADS) {
      const int node = slot[2 * (e / B) + 1];
      const float v = sc[e];
#pragma unroll
      for (int i = 0; i < NPMAX; ++i)
        if (node == i) lm[i] = fmaxf(lm[i], v);
    }
    node_max(lm, shf, xmax);
    cluster.sync();
    if (tid < nsel) {
      float m = -INFINITY;
      for (int r = 0; r < S; ++r)
        m = fmaxf(m, cluster.map_shared_rank(xmax, r)[tid]);
      lim[tid] = gbrl::band_limit(
          m, obl ? 0.0f : fabsf(tot[tid * (K + 1) + K]));
    }
    __syncthreads();
    int mq[NPMAX];
#pragma unroll
    for (int i = 0; i < NPMAX; ++i) mq[i] = BIG;
    for (int e = tid; e < slot0 * B; e += K6_THREADS) {
      const int t = e / B, node = slot[2 * t + 1];
      const int q = slot[2 * t] * B + (e - t * B);
      const float v = sc[e];
#pragma unroll
      for (int i = 0; i < NPMAX; ++i)
        if (node == i && i < nsel && v >= lim[i] && q < mq[i]) mq[i] = q;
    }
    node_min(mq, shi, xq);
    if (tid < nsel) {
      const int q = xq[tid];
      float v = -INFINITY;
      if (q != BIG) {
        for (int t = 0; t < slot0; ++t)
          if (slot[2 * t + 1] == tid && slot[2 * t] == q / B)
            v = sc[(size_t)t * B + q % B];
      }
      xv[tid] = v;
    }
    cluster.sync();
    if (tid < nsel) {
      int q = BIG;
      float v = -INFINITY;
      for (int r = 0; r < S; ++r) {
        const int rq = cluster.map_shared_rank(xq, r)[tid];
        if (rq < q) {
          q = rq;
          v = cluster.map_shared_rank(xv, r)[tid];
        }
      }
      selq[tid] = q;
      selv[tid] = v;
    }
    __syncthreads();
    if (tid < NPMAX) {
      const int i = d * NPMAX + tid;
      int q = 0, split = 0;
      float v = 0.0f;
      const float* tn = tot + tid * (K + 1);
      if (tid < nact) {
        q = selq[obl ? 0 : tid];
        v = selv[obl ? 0 : tid];
        split = obl ? (d == 0 || csp[(d - 1) * NPMAX]) && v > -INFINITY
                    : v >= 0.0f && tn[O] > 0.0f;
      }
      cq[i] = q;
      csp[i] = split;
      if (rank == 0) {
        a.best_idx[i] = q;
        a.do_split[i] = (uint8_t)split;
        float* st = a.stats + (size_t)i * (O + 3);
        const bool live = tid < nact;
        st[0] = live ? v : 0.0f;
        st[1] = live ? tn[O] : 0.0f;
        st[2] = live ? tn[K] : 0.0f;
        for (int o = 0; o < O; ++o) st[3 + o] = live ? tn[o] : 0.0f;
      }
    }
    __syncthreads();
  }
  // the leaves: wg summed per leaf over this rank's tile in sample order,
  // then over the ranks in rank order
  const int LK = (1 << D) * K;
  for (int c = tid; c < LK; c += K6_THREADS) lp[c] = 0.0f;
  for (int s0 = n0; s0 < n1; s0 += K6_SUB) {
    const int ns = min(K6_SUB, n1 - s0);
    __syncthreads();
    stage_sub(a, s0, ns, D, a.wg, 0, 0, cq, csp, srel, sv, sxb);
    __syncthreads();
    build_lists(ns, 1 << D, srel, list, cnt);
    __syncthreads();
    for (int c = tid; c < LK; c += K6_THREADS) {
      const int l = c / K, k = c - l * K;
      float acc = lp[c];
      for (int i = 0; i < cnt[l]; ++i) {
        const float v = sv[list[l * K6_SUB + i] * Kp + k];
        if (v != 0.0f) acc = __fadd_rn(acc, v);
      }
      lp[c] = acc;
    }
  }
  cluster.sync();
  if (rank == 0) {
    for (int c = tid; c < LK; c += K6_THREADS) {
      float acc = 0.0f;
      for (int r = 0; r < S; ++r)
        acc = __fadd_rn(acc, cluster.map_shared_rank(lp, r)[c]);
      a.leaf[c] = acc;
    }
  }
  cluster.sync();   // every rank's leaf sums stay alive until rank 0 has read
}

cudaLaunchConfig_t k6_config(int S, size_t bytes, cudaLaunchAttribute* attr,
                             void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S);
  cfg.blockDim = dim3(K6_THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

extern "C" {

// Once per device and process: allows K6 up to `bytes` of dynamic shared
// memory (the device's opt-in maximum), so no launch sets it again.
int gbrl_k6_prepare(int bytes) {
  const int err = (int)cudaFuncSetAttribute(
      (const void*)tree_build_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err) return err;
  return (int)cudaFuncSetAttribute(
      (const void*)tree_build_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of S K6 blocks of `bytes` shared memory the device can
// hold at once (>= 1 when the launch can run), or -(CUDA error).
int gbrl_k6_max_clusters(int S, int bytes) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k6_config(S, (size_t)bytes, &attr, nullptr);
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveClusters(
      &n, (const void*)tree_build_kernel, &cfg);
  return err ? -err : n;
}

// Xb [N, F] i32; cand [F, B] f32; feat_w [F]; bgw, wg [N, O + 1] f32; scg:
// f32 scratch for the regions the plan keeps in global memory (else
// unused); outputs as TreeArgs; plan: the int array of
// ops/kernels.py _tree_params (shapes, flags, cluster, tile, groups,
// shared-memory layout).  min_data <= 0 disables the min-data mask.
// Returns 0 or the CUDA error of the launch.
int gbrl_k6_tree_build(const int32_t* Xb, const float* cand,
                       const float* feat_w, const float* bgw, const float* wg,
                       float* scg, int32_t* best_idx, uint8_t* do_split,
                       float* stats, float* leaf, const int* plan,
                       float min_data, void* stream) {
  TreeArgs a{Xb, cand, feat_w, bgw, wg, scg, best_idx, do_split, stats, leaf,
             min_data, {}};
  for (int i = 0; i < P_COUNT; ++i) a.p[i] = plan[i];
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      k6_config(a.p[P_S], (size_t)a.p[P_SMEM], &attr, stream);
  const int err = (int)cudaLaunchKernelEx(&cfg, tree_build_kernel, a);
  return err ? err : (int)cudaGetLastError();
}

}  // extern "C"
