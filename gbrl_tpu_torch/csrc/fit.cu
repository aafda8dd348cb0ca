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
// K1 (bucket = number of candidates strictly below x).  N F inputs and
//   outputs (256 KB at N = 4096, F = 16) against N F ceil(log2(B + 1))
//   compares: bytes bound it, and at these sizes the launch itself is most of
//   the time.  The candidate grid of a feature chunk is staged in shared
//   memory (rows padded to B + 1 floats so the features of a warp fall on
//   different banks); a thread takes K1_EPT samples of one feature and runs a
//   branchless lower-bound search of the row for each (binary lifting: 9
//   steps at B = 256, the K1_EPT searches interleaved).  The search gives
//   the count #{b : cand[b] < x} whenever `cand[b] < x` holds on a prefix of
//   the row, which every grid the port builds satisfies (ascending, NaN last,
//   +-inf and -0.0 / +0.0 included; a NaN x counts 0), so the result equals
//   the JAX function bit for bit.  Wide grids are cut into feature chunks
//   that fit the shared-memory budget (grid dimension y); a feature with more
//   candidates than fit is staged in ranges, each range's count added to the
//   element by the thread that owns it.
//
// K2 (hist[f, c, b] = sum_n [Xb[n, f] == b] nd[n, c]).  The TPU kernel
//   contracts a one-hot [N, F * 128k] against nd on the MXU.  Here that would
//   multiply 7 zero columns for every useful one at level 3 (nd holds one
//   node's O + 1 columns per row) and need three bf16 passes for f32
//   accuracy, about 3.3 GFLOP per level against 262 k adds: the work is
//   bound by latency and launches, not by FLOPs, so it is a scatter.  It must
//   be deterministic (split choice rests on a 2e-6 relative tie band), so no
//   float atomics.  One launch:
//     - a slice of the output is (fs features, cs columns, br buckets); the
//       S blocks that share a slice form a thread-block cluster and each
//       takes one contiguous tile of the samples (rank order = sample
//       order); each block holds one copy of the slice in shared memory;
//     - a block walks its tile in sub-tiles of K2_SUB samples: it stages
//       the sub-tile's bucket ids and its columns of nd with every load in
//       flight at once, then lists, for each column, the samples whose
//       entry is nonzero (a ballot per 32 samples), so the work is in
//       proportion to the nonzero terms; a zero term is skipped, which
//       leaves a sum's bits as they are (-0.0 included);
//     - warp w of K2_WARPS owns the (feature, column) pairs w, w + K2_WARPS,
//       ... of the slice (no two warps write one bin) and takes its
//       column's list 32 samples at a time; lanes whose buckets are equal
//       are found with one ballot per bit of the bucket (9 at 257 buckets;
//       __match_any_sync's cost grows with the number of distinct keys)
//       and the lowest of them adds the
//       group's values in lane order, so every bin of a tile is the
//       sequential sum of its terms in sample order;
//     - after cluster.sync() block r sums its share of the slice's bins over
//       the cluster's blocks through distributed shared memory, in rank order
//       0..S-1, and writes out; a second cluster.sync() keeps every block's
//       shared memory alive until all have read it.
//   The launch plan (S, tile, fs, cs, br) comes from the shapes alone
//   (ops/kernels.py _hist_plan), never from the SM count, so the same
//   inputs give the same bits on any H100.  Bound: bytes (Xb and nd read,
//   the histogram written) and the nonzero adds; the kernel is bound by the
//   latency of its shared-memory read-modify-writes and two cluster barriers.
//
// K3 (one level's split choice).  Reads the histogram [F, C, NB] that K2
//   writes, with no reshuffle, and writes one packed [O + 4, n_nodes] result.
//   The function reads F C NB floats once and does a few tens of operations
//   per candidate: well under a microsecond of bytes or operations, so what
//   bounds it is latency: the 257-step prefix chain, the barriers, the
//   launch.  One launch of thread-block clusters:
//     - a cluster of S <= 16 blocks (non-portable past 8, allowed once per
//       device by gbrl_fit_prepare) owns one node (greedy) or the whole
//       level (oblivious); block r owns the contiguous features
//       [r fpb, (r + 1) fpb), so the candidates' order is rank order;
//     - a block stages its (node, feature) histogram rows g features x nc
//       nodes at a time into shared memory with every load in flight (and,
//       with the first group, feature 0's rows of those nodes, whose full
//       prefix gives the node totals; fed by a first pass instead where they
//       do not fit), then one thread per row runs the sequential prefix sum
//       from shared memory (score.cuh scan_rows);
//     - one thread per candidate scores it (score.cuh candidate_score and
//       greedy_value: the arithmetic of the plain version); an oblivious
//       candidate's value is the sum of its nodes' scores in node order,
//       then NaN -> -inf; the values stay in shared memory (no global
//       scratch), or, where a block's features do not fit, a second pass
//       recomputes them group by group (the same arithmetic, the same bits);
//     - the cluster takes the max of its blocks' maxima through distributed
//       shared memory, every block finds its first index within the 2e-6
//       band, and rank 0 takes the lowest rank's hit and writes the result.
//       Max and min are exact in any order, so the result is deterministic
//       and does not depend on the plan.
//   Each block stages the node totals of its own nodes (K more rows per
//   node, in the same flight of loads and the same parallel scan); taking
//   them from rank 0 instead would put a cluster barrier between every
//   block's scan and its scoring.  Past the shared-memory budget even at one
//   (node, feature) a group (wide O: one row set is (O + 1) x 257 floats at
//   256 bins) the staged rows live in the block's slice of global scratch
//   (glob), read and written by the same code and ordered by the same block
//   barriers: the same sequential f32 chains, so the same bits.  The plan
//   (S, fpb, g, nc, keep, fuse, glob) comes from the shapes alone
//   (ops/kernels.py _score_plan).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC
// (no fast-math: IEEE division and sqrtf).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int K1_THREADS = 256;
constexpr int K1_MAX_BLOCKS = 2048;
constexpr int K1_EPT = 4;          // samples of one feature per thread
constexpr int K2_WARPS = 16;       // ops/kernels.py HIST_WARPS
constexpr int K2_THREADS = 32 * K2_WARPS;
constexpr int K2_SUB = 512;        // samples per staged sub-tile (HIST_SUB)
constexpr int K2_MAX_CLUSTER = 8;  // HIST_MAX_CLUSTER: the portable size
constexpr int K3_THREADS = 256;
constexpr int K3_MAX_CLUSTER = 16;  // ops/kernels.py SCORE_MAX_CLUSTER
constexpr unsigned FULL = 0xffffffffu;

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
  const size_t groups = (size_t)((N + K1_EPT - 1) / K1_EPT) * nf;
  for (int b0 = 0; b0 < B; b0 += bc) {
    const int nb = min(bc, B - b0);
    int top = 1;                       // the largest power of two <= nb
    while (2 * top <= nb) top *= 2;
    __syncthreads();
#pragma unroll 8
    for (int i = threadIdx.x; i < nf * nb; i += K1_THREADS) {
      const int r = i / nb, b = i - r * nb;
      s_cand[r * (bc + 1) + b] = cand[(size_t)(f0 + r) * B + b0 + b];
    }
    __syncthreads();
    for (size_t g = (size_t)blockIdx.x * K1_THREADS + threadIdx.x; g < groups;
         g += (size_t)gridDim.x * K1_THREADS) {
      const size_t q = g / nf;
      const int r = (int)(g - q * nf);
      const float* c = s_cand + r * (bc + 1);
      float x[K1_EPT];
      int pos[K1_EPT];
#pragma unroll
      for (int e = 0; e < K1_EPT; ++e) {
        const size_t n = q * K1_EPT + e;
        x[e] = n < (size_t)N ? X[n * F + f0 + r] : NAN;
        pos[e] = 0;
      }
      // binary lifting: pos grows to the length of the prefix on which
      // c[b] < x holds (NaN x: no step is taken)
      for (int step = top; step > 0; step >>= 1) {
#pragma unroll
        for (int e = 0; e < K1_EPT; ++e) {
          const int p = pos[e] + step;
          if (p <= nb && c[p - 1] < x[e]) pos[e] = p;
        }
      }
#pragma unroll
      for (int e = 0; e < K1_EPT; ++e) {
        const size_t n = q * K1_EPT + e;
        if (n < (size_t)N) {
          const size_t at = n * F + f0 + r;
          out[at] = b0 == 0 ? pos[e] : out[at] + pos[e];
        }
      }
    }
  }
}

// ------------------------------------------------------------------- K2
// Shared memory of one block: the slice [fs][cs][br] f32 (padded to a
// multiple of 4 for the float4 reads of the reduction), the sub-tile's rows
// of nd [K2_SUB][cs + 1] f32 (padded against bank conflicts), the warps'
// scratch [K2_WARPS][32] f32, the columns' list lengths [cs] i32, the
// sub-tile's bucket ids [K2_SUB][fs] i32 and the columns' sample lists
// [cs][K2_SUB] u16.
__host__ __device__ inline size_t k2_hist_words(int fs, int cs, int br) {
  return ((size_t)fs * cs * br + 3) & ~(size_t)3;
}
__host__ __device__ inline size_t k2_smem_bytes(int fs, int cs, int br) {
  return 4 * (k2_hist_words(fs, cs, br) + (size_t)K2_SUB * (cs + 1) +
              32 * K2_WARPS + cs + (size_t)K2_SUB * fs) +
         2 * (size_t)K2_SUB * cs;
}

__global__ void __launch_bounds__(K2_THREADS)
level_hist_kernel(const int32_t* __restrict__ Xb,
                  const float* __restrict__ nd, float* __restrict__ out,
                  int N, int F, int C, int NB, int tile, int fs, int cs,
                  int br) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int f0 = (int)(blockIdx.x / S) * fs, nfs = min(fs, F - f0);
  const int c0 = blockIdx.y * cs, ncs = min(cs, C - c0);
  const int b0 = blockIdx.z * br, nbr = min(br, NB - b0);
  const int hw = (int)k2_hist_words(fs, cs, br), ndw = cs + 1;
  float* hist = sm;                                   // [fs][cs][br]
  float* s_nd = sm + hw;                              // [K2_SUB][cs + 1]
  float* s_scr = s_nd + K2_SUB * ndw;                 // [K2_WARPS][32]
  int* s_cnt = (int*)(s_scr + 32 * K2_WARPS);         // [cs]
  int* s_xb = s_cnt + cs;                             // [K2_SUB][fs]
  uint16_t* s_list = (uint16_t*)(s_xb + K2_SUB * fs); // [cs][K2_SUB]
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  float* scr = s_scr + 32 * w;

  for (int i = tid; i < hw / 4; i += K2_THREADS)
    reinterpret_cast<float4*>(hist)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // lanes with equal buckets are found by one ballot per bit of the bucket
  const int kbits = nbr > 1 ? 32 - __clz(nbr - 1) : 0;
  const int n0 = rank * tile, n1 = min(N, n0 + tile);
  for (int s0 = n0; s0 < n1; s0 += K2_SUB) {
    const int ns = min(K2_SUB, n1 - s0);
    // stage the sub-tile: every load independent, several in flight
#pragma unroll 4
    for (int i = tid; i < ns * nfs; i += K2_THREADS) {
      const int n = i / nfs, j = i - n * nfs;
      s_xb[n * fs + j] = Xb[(size_t)(s0 + n) * F + f0 + j] - b0;
    }
#pragma unroll 4
    for (int i = tid; i < ns * ncs; i += K2_THREADS) {
      const int n = i / ncs, c = i - n * ncs;
      s_nd[n * ndw + c] = nd[(size_t)(s0 + n) * C + c0 + c];
    }
    __syncthreads();
    // each column's list of the samples whose entry is nonzero, in sample
    // order (a ballot per 32 samples)
    for (int c = w; c < ncs; c += K2_WARPS) {
      int cnt = 0;
      for (int m0 = 0; m0 < ns; m0 += 32) {
        const int n = m0 + lane;
        const bool nz = n < ns && s_nd[n * ndw + c] != 0.0f;
        const unsigned bal = __ballot_sync(FULL, nz);
        if (nz)
          s_list[c * K2_SUB + cnt + __popc(bal & ((1u << lane) - 1u))] =
              (uint16_t)n;
        cnt += __popc(bal);
      }
      if (lane == 0) s_cnt[c] = cnt;
    }
    __syncthreads();
    // warp w owns the (feature, column) pairs w, w + K2_WARPS, ...: it alone
    // writes their bins; lanes with equal buckets are added in lane order
    for (int p = w; p < nfs * ncs; p += K2_WARPS) {
      const int j = p / ncs, c = p - j * ncs;
      float* row = hist + ((size_t)j * cs + c) * br;
      const uint16_t* list = s_list + c * K2_SUB;
      const int len = s_cnt[c];
      for (int i0 = 0; i0 < len; i0 += 32) {
        const int i = i0 + lane;
        int key = -1;
        float v = 0.0f;
        if (i < len) {
          const int n = list[i];
          const int bl = s_xb[n * fs + j];
          v = s_nd[n * ndw + c];
          if ((unsigned)bl < (unsigned)nbr) key = bl;
        }
        scr[lane] = v;
        unsigned grp = __ballot_sync(FULL, key >= 0);
        for (int b = 0; b < kbits; ++b) {
          const bool bit = (key >> b) & 1;
          const unsigned m = __ballot_sync(FULL, bit);
          grp &= bit ? m : ~m;
        }
        __syncwarp();
        if (key >= 0 && lane == __ffs(grp) - 1) {
          float acc = row[key];
          for (unsigned m = grp; m; m &= m - 1u) acc += scr[__ffs(m) - 1];
          row[key] = acc;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  cluster.sync();
  // this block's share of the slice, summed over the ranks in rank order
  const int q4 = hw / 4, per = (q4 + S - 1) / S;
  const int qa = rank * per, qb = min(q4, qa + per);
  const int rowlen = cs * br;
  for (int q = qa + tid; q < qb; q += K2_THREADS) {
    float4 v[K2_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < K2_MAX_CLUSTER; ++r)
      if (r < S) v[r] = cluster.map_shared_rank((const float4*)sm, r)[q];
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < K2_MAX_CLUSTER; ++r) {
      if (r < S) {
        acc.x += v[r].x;
        acc.y += v[r].y;
        acc.z += v[r].z;
        acc.w += v[r].w;
      }
    }
    const float vals[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int flat = 4 * q + k;
      const int j = flat / rowlen, rem = flat - j * rowlen;
      const int c = rem / br, bl = rem - c * br;
      if (j < nfs && c < ncs && bl < nbr)
        out[((size_t)(f0 + j) * C + c0 + c) * NB + b0 + bl] = vals[k];
    }
  }
  cluster.sync();
}

// ------------------------------------------------------------------- K3
// Shared memory of one K3 block, in floats (ops/kernels.py _score_words):
// the staged rows [rows][NBp] (unless `glob`: then they are the block's
// slice of global scratch), the node totals and parents [NS][O + 2], the
// candidate values (keep: the block's [fpb * B]; else only an oblivious
// level staged in node chunks keeps its group's sums [g * B]), block scratch
// [32] and the cluster exchange [4].
__host__ __device__ inline size_t k3_rows(int g, int nc, int K, int fuse) {
  return (size_t)nc * g * K + (fuse ? (size_t)nc * K : 0);
}
__host__ __device__ inline size_t k3_vals(int B, int NS, int fpb, int g,
                                          int nc, int keep) {
  return keep ? (size_t)fpb * B : nc < NS ? (size_t)g * B : 0;
}
__host__ __device__ inline size_t k3_smem_words(int NB, int K, int B, int NS,
                                                int fpb, int g, int nc,
                                                int keep, int fuse,
                                                int glob) {
  return (glob ? 0 : k3_rows(g, nc, K, fuse) * gbrl::odd_stride(NB)) +
         (size_t)NS * (K + 1) + k3_vals(B, NS, fpb, g, nc, keep) + 36;
}

// The shapes, flags and plan of one K3 launch (ops/kernels.py
// _score_params), in this order.
enum { Q_F, Q_NODES, Q_O, Q_B, Q_COSINE, Q_OBLIVIOUS, Q_ROOT, Q_S, Q_FPB, Q_G,
       Q_NC, Q_KEEP, Q_FUSE, Q_GLOBAL, Q_SMEM, Q_COUNT };

struct K3Args {
  const float* hist;       // [F, n_nodes * K, NB]
  const uint8_t* blocked;  // [n_nodes, F, B]
  const float* feat_w;     // [F]
  float* out;              // [O + 4, n_nodes]: idx bits, best, count, parent,
                           // sums [O]
  float* scratch;          // glob: [blocks][rows][NBp] staged rows
  int F, n_nodes, O, NB, B, cosine, oblivious, is_root;
  float min_data;
  int fpb, g, nc, keep, fuse, glob;   // the plan (ops/kernels.py _score_plan)
};

// Stages rows [r0, r0 + n) of the list row(r) -> hist row into shared memory
// at stride NBp, every load independent.
template <class Row>
__device__ __forceinline__ void k3_stage(float* stage, int n_rows, int NB,
                                         int NBp, Row row) {
#pragma unroll 8
  for (int i = threadIdx.x; i < n_rows * NB; i += K3_THREADS) {
    const int r = i / NB, b = i - r * NB;
    stage[(size_t)r * NBp + b] = __ldg(row(r) + b);
  }
}

__global__ void __launch_bounds__(K3_THREADS, 1)
level_score_kernel(const K3Args a) {
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int K = a.O + 1, NB = a.NB, NBp = gbrl::odd_stride(NB), B = a.B;
  const size_t C = (size_t)a.n_nodes * K;
  const int NS = a.oblivious ? a.n_nodes : 1;
  const int node0 = a.oblivious ? 0 : (int)(blockIdx.x / S);
  const int fa = rank * a.fpb, fb = min(a.F, fa + a.fpb);
  const int rows_max = (int)k3_rows(a.g, a.nc, K, a.fuse);
  // [rows_max][NBp]: in shared memory, or past its budget (wide O) in the
  // block's slice of global scratch, ordered by the same block barriers
  float* stage = a.glob ? a.scratch + (size_t)blockIdx.x * rows_max * NBp
                        : sm;
  float* tot = a.glob ? sm : stage + (size_t)rows_max * NBp;   // [NS][K + 1]
  float* sc = tot + (size_t)NS * (K + 1);             // candidate values
  float* shf = sc + k3_vals(B, NS, a.fpb, a.g, a.nc, a.keep);
  int* shi = reinterpret_cast<int*>(shf);             // (shares shf)
  float* xch = shf + 32;                              // max, index, value
  const int tid = threadIdx.x;
  auto hrow = [&](int f, int node, int k) {
    return a.hist + ((size_t)f * C + (size_t)node * K + k) * NB;
  };
  // the totals' parents, once the totals of nodes [c0, c0 + nn) are in
  auto parents = [&](int c0, int nn) {
    for (int j = tid; j < nn; j += K3_THREADS) {
      float* t = tot + (size_t)(c0 + j) * (K + 1);
      t[K] = a.is_root ? 0.0f : gbrl::node_parent(t, a.O, a.cosine);
    }
  };
  if (!a.fuse) {
    // the node totals first: feature 0's rows of as many nodes as fit
    const int per = max(1, rows_max / K);
    for (int c0 = 0; c0 < NS; c0 += per) {
      const int nn = min(per, NS - c0);
      __syncthreads();
      k3_stage(stage, nn * K, NB, NBp, [&](int r) {
        return hrow(0, node0 + c0 + r / K, r % K);
      });
      __syncthreads();
      gbrl::scan_rows(stage, nn * K, NB, NBp);
      __syncthreads();
      for (int r = tid; r < nn * K; r += K3_THREADS)
        tot[(size_t)(c0 + r / K) * (K + 1) + r % K] =
            stage[(size_t)r * NBp + NB - 1];
      __syncthreads();
      parents(c0, nn);
    }
  }
  const int n_groups = (fb - fa + a.g - 1) / a.g;
  float lmax = -INFINITY, m = -INFINITY, lim = 0.0f;
  int qi = 0x7fffffff;
  float vi = -INFINITY;
  const bool store = a.keep || a.nc < NS;   // an oblivious chunked sum
  for (int pass = 0; pass < (a.keep ? 1 : 2); ++pass) {
    for (int gi = 0; gi < n_groups; ++gi) {
      const int ga = fa + gi * a.g, ng = min(a.g, fb - ga);
      const bool want_tot = a.fuse && gi == 0 && pass == 0;
      float* vals = a.keep ? sc + (size_t)(ga - fa) * B : sc;
      for (int c0 = 0; c0 < NS; c0 += a.nc) {
        const int nn = min(a.nc, NS - c0);
        const int own = nn * ng * K;
        const int extra = want_tot && ga != 0 ? nn * K : 0;
        __syncthreads();   // the previous chunk's rows are consumed
        k3_stage(stage, own + extra, NB, NBp, [&](int r) {
          if (r >= own) {
            r -= own;
            return hrow(0, node0 + c0 + r / K, r % K);
          }
          const int jn = r / (ng * K), rem = r - jn * ng * K;
          return hrow(ga + rem / K, node0 + c0 + jn, rem % K);
        });
        __syncthreads();
        gbrl::scan_rows(stage, own + extra, NB, NBp);
        __syncthreads();
        if (want_tot) {
          for (int r = tid; r < nn * K; r += K3_THREADS) {
            const int jn = r / K, k = r - jn * K;
            const int at = extra ? own + r : jn * ng * K + k;  // feature 0
            tot[(size_t)(c0 + jn) * (K + 1) + k] =
                stage[(size_t)at * NBp + NB - 1];
          }
          __syncthreads();
          parents(c0, nn);
          __syncthreads();
        }
        const bool last = c0 + nn == NS;
        for (int i = tid; i < ng * B; i += K3_THREADS) {
          const int j = i / B, b = i - j * B, f = ga + j;
          const float fw = __ldg(a.feat_w + f);
          float v;
          if (!a.oblivious) {
            const float* t = tot;
            const float s = gbrl::candidate_score(
                stage + (size_t)j * K * NBp, NBp, t, a.O, b, a.cosine,
                a.min_data, fw);
            v = gbrl::greedy_value(
                s, a.blocked[((size_t)node0 * a.F + f) * B + b] != 0, t[K]);
          } else {
            float acc = c0 == 0 ? 0.0f : vals[i];
            for (int jn = 0; jn < nn; ++jn) {
              const int node = c0 + jn;
              float s = gbrl::candidate_score(
                  stage + ((size_t)jn * ng + j) * K * NBp, NBp,
                  tot + (size_t)node * (K + 1), a.O, b, a.cosine, a.min_data,
                  fw);
              if (a.blocked[((size_t)node * a.F + f) * B + b]) s = -INFINITY;
              acc = __fadd_rn(acc, s);
            }
            v = last && isnan(acc) ? -INFINITY : acc;
          }
          if (store) vals[i] = v;
          if (last) {
            if (pass == 0) {
              lmax = fmaxf(lmax, v);
            } else if (v >= lim && f * B + b < qi) {
              qi = f * B + b;   // this thread's first hit and its value
              vi = v;
            }
          }
        }
      }
      if (pass == 1) {
        // the first hit of this group, if any, is the block's; its thread
        // publishes the value
        const int q = gbrl::block_min(qi, shi);
        if (q != 0x7fffffff) {
          if (qi == q) xch[3] = vi;
          __syncthreads();
          qi = q;
          vi = xch[3];
          break;
        }
      }
    }
    if (pass == 0) {
      // the level's max over the cluster (exact in any order)
      lmax = gbrl::block_max(lmax, shf);
      if (tid == 0) xch[0] = lmax;
      cluster.sync();
      float x[K3_MAX_CLUSTER];                 // every remote load in flight
#pragma unroll
      for (int r = 0; r < K3_MAX_CLUSTER; ++r)
        x[r] = r < S ? cluster.map_shared_rank(xch, r)[0] : -INFINITY;
      m = -INFINITY;
#pragma unroll
      for (int r = 0; r < K3_MAX_CLUSTER; ++r) m = fmaxf(m, x[r]);
      lim = gbrl::band_limit(m, a.oblivious ? 0.0f : fabsf(tot[K]));
      if (a.keep) {
        __syncthreads();
        for (int i = tid; i < (fb - fa) * B; i += K3_THREADS)
          if (sc[i] >= lim) {
            qi = fa * B + i;
            break;
          }
        qi = gbrl::block_min(qi, shi);
        if (qi != 0x7fffffff) vi = sc[qi - fa * B];
      }
    }
  }
  // the first hit over the cluster: the lowest rank that has one
  if (tid == 0) {
    reinterpret_cast<int*>(xch)[1] = qi;
    xch[2] = vi;
  }
  cluster.sync();
  if (rank == 0) {
    int rq[K3_MAX_CLUSTER];
    float rv[K3_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < K3_MAX_CLUSTER; ++r) {
      const float* x = cluster.map_shared_rank(xch, r < S ? r : 0);
      rq[r] = r < S ? reinterpret_cast<const int*>(x)[1] : 0x7fffffff;
      rv[r] = x[2];
    }
    int q = 0x7fffffff;
    float v = -INFINITY;
#pragma unroll
    for (int r = K3_MAX_CLUSTER - 1; r >= 0; --r) {
      if (rq[r] != 0x7fffffff) {      // the lowest rank with a hit wins
        q = rq[r];
        v = rv[r];
      }
    }
    const size_t n = a.n_nodes;
    for (int j = tid; j < NS; j += K3_THREADS) {
      const int node = node0 + j;
      const float* t = tot + (size_t)j * (K + 1);
      reinterpret_cast<int*>(a.out)[node] = q;
      a.out[n + node] = v;
      a.out[2 * n + node] = t[a.O];
      a.out[3 * n + node] = t[K];
      for (int o = 0; o < a.O; ++o) a.out[(4 + o) * n + node] = t[o];
    }
  }
  cluster.sync();   // every rank's exchange stays alive until rank 0 has read
}

int last_error() { return (int)cudaGetLastError(); }

// K2's launch: the grid of clusters of S blocks along x.
cudaLaunchConfig_t k2_config(int n_slices, int n_col, int n_br, int S, int fs,
                             int cs, int br, cudaLaunchAttribute* attr,
                             void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_slices * S), (unsigned)n_col,
                     (unsigned)n_br);
  cfg.blockDim = dim3(K2_THREADS);
  cfg.dynamicSmemBytes = k2_smem_bytes(fs, cs, br);
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// K3's launch: one cluster of S blocks per node (greedy) or one for the
// level (oblivious).
cudaLaunchConfig_t k3_config(int units, int S, size_t bytes,
                             cudaLaunchAttribute* attr, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(units * S));
  cfg.blockDim = dim3(K3_THREADS);
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

// Once per device and process: allows K1, K2 and K3 up to `bytes` of
// dynamic shared memory (the device's opt-in maximum), so no launch sets the
// attribute again.
int gbrl_fit_prepare(int bytes) {
  const void* kernels[] = {(const void*)bucketize_kernel,
                           (const void*)level_hist_kernel,
                           (const void*)level_score_kernel};
  for (const void* k : kernels) {
    const int err = (int)cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err) return err;
  }
  return (int)cudaFuncSetAttribute(
      (const void*)level_score_kernel,
      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of S K2 blocks with this slice the device can hold at
// once (>= 1 when the launch can run), or -(CUDA error).
int gbrl_k2_max_clusters(int S, int fs, int cs, int br) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k2_config(1, 1, 1, S, fs, cs, br, &attr,
                                           nullptr);
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveClusters(
      &n, (const void*)level_hist_kernel, &cfg);
  return err ? -err : n;
}

// X [N, F] f32, cand [F, B] f32 (c < x holding on a prefix of each row),
// out [N, F] i32.  fc: features per block; bc: candidates per staged range
// (fc rows of bc + 1 floats fit the shared memory).
int gbrl_k1_bucketize(const float* X, const float* cand, int32_t* out, int N,
                      int F, int B, int fc, int bc, void* stream) {
  const size_t bytes = sizeof(float) * (size_t)fc * (bc + 1);
  const size_t groups = (size_t)((N + K1_EPT - 1) / K1_EPT) * fc;
  size_t blocks = (groups + K1_THREADS - 1) / K1_THREADS;
  if (blocks > K1_MAX_BLOCKS) blocks = K1_MAX_BLOCKS;
  if (blocks < 1) blocks = 1;
  const dim3 grid((unsigned)blocks, (unsigned)((F + fc - 1) / fc));
  bucketize_kernel<<<grid, K1_THREADS, bytes, (cudaStream_t)stream>>>(
      X, cand, out, N, F, B, fc, bc);
  return last_error();
}

// Xb [N, F] i32, nd [N, C] f32 -> out [F, C, NB] f32 (layout [F * C][NB]).
// The plan (ops/kernels.py _hist_plan): S blocks per cluster, tile samples
// per block, slices of fs features x cs columns x br buckets.
int gbrl_k2_level_histogram(const int32_t* Xb, const float* nd, float* out,
                            int N, int F, int C, int NB, int S, int tile,
                            int fs, int cs, int br, void* stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      k2_config((F + fs - 1) / fs, (C + cs - 1) / cs, (NB + br - 1) / br, S,
                fs, cs, br, &attr, stream);
  const int err = (int)cudaLaunchKernelEx(&cfg, level_hist_kernel, Xb, nd,
                                          out, N, F, C, NB, tile, fs, cs, br);
  return err ? err : last_error();
}

// How many clusters of S K3 blocks of `bytes` shared memory the device can
// hold at once (>= 1 when the launch can run), or -(CUDA error).
int gbrl_k3_max_clusters(int S, int bytes) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = k3_config(1, S, (size_t)bytes, &attr,
                                           nullptr);
  int n = 0;
  const int err = (int)cudaOccupancyMaxActiveClusters(
      &n, (const void*)level_score_kernel, &cfg);
  return err ? -err : n;
}

// hist [F, n_nodes * (O + 1), B + 1] f32; blocked [n_nodes, F, B] u8;
// feat_w [F] f32; out [O + 4, n_nodes] f32: the chosen index f * B + b (its
// int32 bits), the value there, the node count, the parent score (0 at the
// root), the node sums [O].  q: the int array of ops/kernels.py
// _score_params (Q_*): shapes, flags and the plan (S blocks per cluster, fpb
// features per block, staged g features x nc nodes at a time; keep: every
// candidate value of the block held in shared memory, else a second pass
// recomputes them; fuse: the node totals staged with the first group, else
// a first pass; glob: the staged rows live in `scratch`, [blocks][rows of
// one (node, feature)'s O + 1 columns][NBp], else in shared memory).
// min_data <= 0 disables the min-data mask.
int gbrl_k3_level_score(const float* hist, const uint8_t* blocked,
                        const float* feat_w, float* out, float* scratch,
                        const int* q, float min_data, void* stream) {
  const K3Args a{hist, blocked, feat_w, out, scratch, q[Q_F], q[Q_NODES],
                 q[Q_O], q[Q_B] + 1, q[Q_B], q[Q_COSINE], q[Q_OBLIVIOUS],
                 q[Q_ROOT], min_data, q[Q_FPB], q[Q_G], q[Q_NC], q[Q_KEEP],
                 q[Q_FUSE], q[Q_GLOBAL]};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      k3_config(a.oblivious ? 1 : a.n_nodes, q[Q_S], (size_t)q[Q_SMEM], &attr,
                stream);
  const int err = (int)cudaLaunchKernelEx(&cfg, level_score_kernel, a);
  return err ? err : last_error();
}

}  // extern "C"
