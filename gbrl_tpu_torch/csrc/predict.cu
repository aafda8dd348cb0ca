// Ensemble predict kernels: sum_t w[t, leaf(n, t), :] over the live trees,
// w = leaf_values * coeff.
//
// Replaces (gbrl_tpu/ops/pallas_kernels.py):
//   gbrl_k4_leaf_sum  <- weighted_leaf_sum_pallas  (general heap walk, K4)
//   gbrl_k5_leaf_sum  <- oblivious_leaf_sum_pallas (oblivious bit index, K5)
//
// What bounds them on an H100: at the serving shape (N = 4096 samples,
// F = 16, depth 4, O = 3, 1600 live trees of 2048) the tree tables are
// ~0.5 MB and X is 256 KB, all resident in the 50 MB L2, so HBM bytes are no
// limit (bound ~1.4 us of operations).  The work is 6.55 M (sample, tree)
// walks, each D dependent node visits (a node load, a load of x[feat], a
// compare) and O leaf loads and adds: ~11 warp-wide shared-memory loads per
// 32 walks, so the SMs' shared-memory pipes (one warp-wide load per clock)
// set a floor near 10 us however the walk is written.  What held the first
// version far above it: 128 blocks of 8 warps for 132 SMs (one block
// and 2 warps per scheduler to hide each chain's latency), synchronous
// staging that every block repeated for the whole ensemble (~67 MB of L2
// reads), three loads per node, a runtime depth, one relaunch per 8 output
// columns, and host work on every call.
//
// What the design does about it:
//   * thread-block clusters split the trees as well as the samples: a block
//     owns `tile` samples (one per thread, up to 256) and is rank r of a
//     cluster of S <= 16 (non-portable past 8); the trees come in chunks of
//     CHUNK = 8 and chunk c belongs to rank c % S, so the live trees spread
//     evenly over the ranks whatever n_trees is.  Each rank walks its
//     chunks in order into one f32 sum per (sample, column); the ranks'
//     partial sums are then added in rank order 0..S-1 through distributed
//     shared memory (or global scratch for very wide O).  S comes from
//     (N, T_cap) alone, so the add order, and with it every bit, depends
//     only on the shapes: two launches agree, and K5 equals K4 on an
//     oblivious ensemble (both run this one template).  No float atomics.
//     Up to 2048 samples (a small request, A2C's 1024 rows) a cluster's
//     barriers cost more than they save: a block then takes 32 samples and
//     G = 8 warp groups, group g walking the block's positions q % G == g,
//     and the groups' sums are added in group order in shared memory;
//   * each thread walks ILP = 4 trees at once (independent chains), so a
//     chain's load latency hides behind the others'; at most 80 registers a
//     thread keep three blocks an SM, so the serving grid is one wave;
//   * the rank's trees are staged in a ring of two shared-memory buffers of
//     `sb` trees (up to 32): the next stage's global loads are issued into
//     registers before the current stage is walked and land while it runs;
//     they are written to the other buffer afterwards, so one barrier per
//     stage remains and no copy waits on a walk.  (The staging transforms
//     what it copies, see below, so it goes through registers rather than
//     cp.async, which copies raw bytes.)  X's tile is staged once,
//     transposed [F][tile], so every lane reads its own bank;
//   * a node is staged packed as int2 (feat * tile, thr): one 8-byte load a
//     level.  is_split == 0 is folded in as (0, +inf): x > +inf is false for
//     every x, NaN included, so the route is the same; feat is clamped to
//     [0, F) while staging;
//   * leaf values are multiplied by the optimizer coefficient while staging
//     (__fmul_rn: one rounded f32 product, never contracted into an FMA, the
//     bits of ops/predict.py's `leaf_values * coeff`), so no [T_cap, L, O]
//     product is built per request;
//   * depths 1..8 have their own instances, so the walk unrolls and K5
//     issues its D level loads together; within each, O = 1, 2 and 3 have
//     their own body (constant divisors while staging, unrolled adds);
//   * every output column is summed from one walk per (sample, tree): up
//     to OREG = 8 columns in registers, wider O in a per-block [O][tile]
//     region (shared memory, or global scratch past the budget);
//   * past the shared-memory budget (a group of 8 trees, two buffers, does
//     not fit: depth >= 9 at F = 16, O = 3, or very wide O) the global
//     instance reads X, the node tables and the leaf values straight from
//     global memory (L2) in the same tree order, so any depth and F run and
//     give the bits the staged instance would;
//   * the host passes shapes and plan as one cached int array (ops/kernels.py
//     _predict_params), sets attributes once per device and makes one ctypes
//     call per launch.
//
// What bounds it now (H100, serving shape; PERF.md): the walk runs
// near the shared-memory pipe's rate, and a block's fixed costs (X and the
// first stage, the rank reduction and its two cluster barriers, the slowest
// rank) are about as large again.
//
// Semantics (as the TPU kernels): x > thr routes right (strict f32 compare,
// NaN goes left), nodes with is_split == 0 route left, feat is clamped to
// [0, F) before x is read (pass-through nodes carry feat == -1), only trees
// t < *n_trees contribute (stale weights beyond it are never read), and
// n_trees is read from device memory, so the host never waits for it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (no fast-math: the compares, products and adds must stay IEEE f32).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_TILE = 256;     // ops/kernels.py PREDICT_MAX_TILE
constexpr int MAX_CLUSTER = 16;   // PREDICT_MAX_CLUSTER
constexpr int OREG = 8;           // PREDICT_OREG: columns summed in registers
constexpr int CHUNK = 8;          // PREDICT_CHUNK: chunk c -> rank c % S
constexpr int PF = 4;             // PREDICT_PREFETCH: staged units per thread
constexpr int ILP = 4;            // trees one thread walks at once
constexpr int MAX_STAGED_DEPTH = 8;   // PREDICT_MAX_STAGED_DEPTH

// The shapes and plan of one launch (ops/kernels.py _predict_params), in
// this order.
enum { P_N, P_F, P_TCAP, P_D, P_O, P_S, P_G, P_CH, P_TILE, P_SB, P_GLOBAL,
       P_RED_GLOBAL, P_X_OFF, P_RING_OFF, P_BUF, P_RED_OFF, P_SMEM, P_COUNT };

struct Args {
  const float* X;          // [N, F]
  const int32_t* feat;     // [T_cap, 2^D - 1]
  const float* thr;        // [T_cap, 2^D - 1]
  const uint8_t* spl;      // [T_cap, 2^D - 1]
  const float* lv;         // [T_cap, 2^D, O]
  const float* coeff;      // [T_cap, O], or null: lv is already scaled
  const int32_t* n_trees;  // [1] on the device
  float* out;              // [N, O]
  float* scratch;          // [blocks][O][tile] when red_global
  int N, F, T_cap, D, O, S, G, tile, sb, red_global;
  int x_off, ring_off, buf, red_off;   // shared-memory layout (bytes)
};

// n / d for the small n of a stage (n (d - 1) < 2^32) by one multiply:
// m = ceil(2^32 / d), the staging loops' divisors being launch constants.
struct Divisor {
  uint32_t m;
  int d;
};
__device__ __forceinline__ Divisor divisor(int d) {
  return {d > 1 ? 0xffffffffu / (uint32_t)d + 1u : 0u, d};
}
__device__ __forceinline__ int quot(int n, const Divisor& v) {
  return v.d == 1 ? n : (int)__umulhi((uint32_t)n, v.m);
}

__device__ __forceinline__ int live_trees(const int32_t* n_trees, int T_cap) {
  const int nt = *n_trees;
  return nt < 0 ? 0 : (nt > T_cap ? T_cap : nt);
}

// The trees of rank r in walking order: position q is tree
// (r + (q / CHUNK) S) CHUNK + q % CHUNK, the rank's chunks in order.
__device__ __forceinline__ int tree_at(int q, int rank, int S) {
  return (rank + (q / CHUNK) * S) * CHUNK + q % CHUNK;
}

// How many of the rank's positions hold live trees (t < nt).
__device__ __forceinline__ int rank_trees(int nt, int rank, int S) {
  const int chunks = (nt + CHUNK - 1) / CHUNK;
  const int mine = chunks > rank ? (chunks - rank + S - 1) / S : 0;
  const bool last = mine && (chunks - 1) % S == rank;
  return mine * CHUNK - (last ? chunks * CHUNK - nt : 0);
}

// The block's partial sums [O][tile]: its shared-memory region, or its slice
// of the global scratch.
__device__ __forceinline__ float* partials(const Args& a, unsigned char* sm) {
  return a.red_global
             ? a.scratch + (size_t)blockIdx.x * a.O * a.tile
             : reinterpret_cast<float*>(sm + a.red_off);
}

// Adds one leaf's columns to this thread's sums (registers up to OREG
// columns, else its column of the partials).  `scale` null: w is scaled.
__device__ __forceinline__ void add_leaf(const float* w, const float* scale,
                                         int O, float (&acc)[OREG],
                                         float* red, int tile) {
  if (O <= OREG) {
#pragma unroll
    for (int o = 0; o < OREG; ++o)
      if (o < O) acc[o] += scale ? __fmul_rn(w[o], __ldg(scale + o)) : w[o];
  } else {
    float* r = red + threadIdx.x;
    for (int o = 0; o < O; ++o)
      r[(size_t)o * tile] += scale ? __fmul_rn(w[o], __ldg(scale + o)) : w[o];
  }
}

// Writes the tile's outputs.  G > 1 (one block, no cluster, O <= OREG):
// the groups' sums are added in group order 0..G-1 through shared memory.
// Alone (S == 1): from the thread's own sums.  In a cluster, every rank's
// partials are summed in rank order 0..S-1, rank r taking the elements r,
// r + S, ... of the [O][tile] region.
__device__ __forceinline__ void finish(const Args& a, float* red,
                                       const float (&acc)[OREG], int n0) {
  const int S = a.S, tile = a.tile, O = a.O, tid = threadIdx.x;
  if (a.G > 1) {
    const int g = tid / tile, lane = tid - g * tile;
#pragma unroll
    for (int o = 0; o < OREG; ++o)
      if (o < O) red[(g * O + o) * tile + lane] = acc[o];
    __syncthreads();
    if (g == 0 && n0 + lane < a.N) {
      float* dst = a.out + (size_t)(n0 + lane) * O;
      for (int o = 0; o < O; ++o) {
        float v = red[o * tile + lane];
        for (int gg = 1; gg < a.G; ++gg) v += red[(gg * O + o) * tile + lane];
        dst[o] = v;
      }
    }
    return;
  }
  if (S == 1) {
    const int n = n0 + tid;
    if (n < a.N) {
      float* dst = a.out + (size_t)n * O;
      if (O <= OREG) {
#pragma unroll
        for (int o = 0; o < OREG; ++o)
          if (o < O) dst[o] = acc[o];
      } else {
        for (int o = 0; o < O; ++o) dst[o] = red[(size_t)o * tile + tid];
      }
    }
    return;
  }
  if (O <= OREG) {
#pragma unroll
    for (int o = 0; o < OREG; ++o)
      if (o < O) red[o * tile + tid] = acc[o];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();   // every rank's partials are written
  const int rank = (int)cluster.block_rank();
  const float* part[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q) {
    const int qq = q < S ? q : 0;
    part[q] = a.red_global
                  ? a.scratch + (size_t)(blockIdx.x - rank + qq) * O * tile
                  : cluster.map_shared_rank(red, qq);
  }
  const int E = O * tile;
  for (int e = rank + S * tid; e < E; e += S * tile) {
    float x[MAX_CLUSTER];                  // every remote load in flight
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      x[q] = q >= S ? 0.0f : a.red_global ? __ldcg(part[q] + e) : part[q][e];
    float v = x[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q)
      if (q < S) v += x[q];
    const int o = e / tile, n = n0 + (e - o * tile);
    if (n < a.N) a.out[(size_t)n * O + o] = v;
  }
  cluster.sync();   // no rank leaves while another still reads its partials
}

// ------------------------------------------------------------ staged walk
// A stage holds `cnt` <= sb trees: nodes int2 [sb][K], then leaves
// f32 [sb][L][O].  Staging unit u < cnt K is node (u / K, u % K); past that,
// leaf value u - cnt K.  Thread t of the block's tile * G loads units
// base + p * tile * G + t, p < PF, into registers (ra, rb, rc) and stores
// them packed.
template <bool OBL, int OC>
__device__ __forceinline__ void load_units(const Args& a, int q0, int cnt,
                                           int rank, int K, int IN, int LO,
                                           const Divisor& by_lo,
                                           const Divisor& by_o, int base,
                                           uint32_t (&ra)[PF],
                                           uint32_t (&rb)[PF],
                                           uint32_t (&rc)[PF]) {
  const int nu = cnt * K, total = nu + cnt * LO;
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int u = base + p * a.tile * a.G + (int)threadIdx.x;
    if (u < nu) {
      const int j = u / K, k = u - j * K;
      const size_t src = (size_t)tree_at(q0 + j, rank, a.S) * IN +
                         (OBL ? (1 << k) - 1 : k);
      ra[p] = (uint32_t)__ldg(a.feat + src);
      rb[p] = __float_as_uint(__ldg(a.thr + src));
      rc[p] = __ldg(a.spl + src);
    } else if (u < total) {
      // OC: LO and O are constants, so are the divisions
      const int v = u - nu, j = OC ? v / LO : quot(v, by_lo), r = v - j * LO;
      const size_t t = (size_t)tree_at(q0 + j, rank, a.S);
      ra[p] = __float_as_uint(__ldg(a.lv + t * LO + r));
      if (a.coeff) {
        const int O = OC ? OC : a.O;
        rb[p] = __float_as_uint(__ldg(
            a.coeff + t * O + (r - (OC ? r / OC : quot(r, by_o)) * O)));
      }
    }
  }
}

__device__ __forceinline__ void store_units(const Args& a, unsigned char* buf,
                                            int cnt, int K, int LO, int base,
                                            const uint32_t (&ra)[PF],
                                            const uint32_t (&rb)[PF],
                                            const uint32_t (&rc)[PF]) {
  int2* nodes = reinterpret_cast<int2*>(buf);
  float* leaves = reinterpret_cast<float*>(buf + (size_t)a.sb * K * 8);
  const int nu = cnt * K, total = nu + cnt * LO;
#pragma unroll
  for (int p = 0; p < PF; ++p) {
    const int u = base + p * a.tile * a.G + (int)threadIdx.x;
    if (u < nu) {
      int2 q;
      if (rc[p]) {
        q.x = min(max((int)ra[p], 0), a.F - 1) * a.tile;
        q.y = (int)rb[p];
      } else {                      // unsplit: routes left for every x
        q.x = 0;
        q.y = __float_as_int(INFINITY);
      }
      nodes[u] = q;
    } else if (u < total) {
      const float w = __uint_as_float(ra[p]);
      leaves[u - nu] = a.coeff ? __fmul_rn(w, __uint_as_float(rb[p])) : w;
    }
  }
}

// Walks group g's trees of one staged buffer (stage positions g, g + G,
// ...: the rank's positions q with q % G == g, as a stage starts at a
// multiple of G) for this thread's sample, ILP at a time, and adds their
// leaves in tree order.  OC: the output columns when the kernel has an
// instance for them (1-3: the adds unroll), else 0 (a.O columns).
template <bool OBL, int D, int OC>
__device__ __forceinline__ void walk_stage(const Args& a,
                                           const unsigned char* buf, int cnt,
                                           int g, const float* xt,
                                           float (&acc)[OREG], float* red) {
  constexpr int IN = (1 << D) - 1, L = 1 << D, K = OBL ? D : IN;
  const int2* nodes = reinterpret_cast<const int2*>(buf);
  const float* leaves =
      reinterpret_cast<const float*>(buf + (size_t)a.sb * K * 8);
  const int O = OC ? OC : a.O, G = a.G;
  for (int j = g; j < cnt; j += ILP * G) {
    int p[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) p[u] = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int jj = min(j + u * G, cnt - 1);
        const int2 q = nodes[jj * K + (OBL ? d : p[u])];
        const int go = xt[q.x] > __int_as_float(q.y);
        p[u] = OBL ? 2 * p[u] + go : 2 * p[u] + 1 + go;
      }
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      if (j + u * G < cnt) {
        const int leaf = OBL ? p[u] : p[u] - IN;
        const float* w = leaves + ((size_t)(j + u * G) * L + leaf) * O;
        if (OC) {
#pragma unroll
          for (int o = 0; o < OC; ++o) acc[o] += w[o];
        } else {
          add_leaf(w, nullptr, O, acc, red, a.tile);
        }
      }
    }
  }
}

// Staged instance (depth D <= MAX_STAGED_DEPTH): X's tile and the rank's
// trees in shared memory.  OC as walk_stage's: the body has an instance
// for O = 1..3, so its staging indices and adds use constant divisors.
template <bool OBL, int D, int OC>
__device__ __forceinline__ void staged_body(const Args& a, unsigned char* sm,
                                            int rank, int n0) {
  constexpr int IN = (1 << D) - 1, K = OBL ? D : IN;
  const int S = a.S, tile = a.tile, tid = threadIdx.x;
  const int g = tid / tile, lane = tid - g * tile;        // group, sample
  const int O = OC ? OC : a.O, LO = (1 << D) * O;
  float* xs = reinterpret_cast<float*>(sm + a.x_off);   // [F][tile]
  unsigned char* ring = sm + a.ring_off;
  float* red = partials(a, sm);
  // X's tile first: its loads do not wait for n_trees
  if (n0 + lane < a.N) {                  // group g stages features g, g + G
    const float* x = a.X + (size_t)(n0 + lane) * a.F;
#pragma unroll 16
    for (int f = g; f < a.F; f += a.G) xs[f * tile + lane] = __ldg(x + f);
  } else {
    for (int f = g; f < a.F; f += a.G) xs[f * tile + lane] = 0.0f;
  }
  // the rank's live trees, positions [0, nr), staged sb at a time
  const int nr = rank_trees(live_trees(a.n_trees, a.T_cap), rank, S);
  const int per_round = PF * tile * a.G, units = K + LO;
  const Divisor by_lo = divisor(LO), by_o = divisor(O);

  float acc[OREG];
#pragma unroll
  for (int o = 0; o < OREG; ++o) acc[o] = 0.0f;
  if (O > OREG)
    for (int o = 0; o < O; ++o) red[(size_t)o * tile + tid] = 0.0f;
  uint32_t ra[PF], rb[PF], rc[PF];

  const int cnt0 = min(a.sb, nr);
  if (cnt0) {
    load_units<OBL, OC>(a, 0, cnt0, rank, K, IN, LO, by_lo, by_o, 0, ra, rb,
                        rc);
    store_units(a, ring, cnt0, K, LO, 0, ra, rb, rc);
    for (int base = per_round; base < cnt0 * units; base += per_round) {
      load_units<OBL, OC>(a, 0, cnt0, rank, K, IN, LO, by_lo, by_o, base, ra,
                          rb, rc);
      store_units(a, ring, cnt0, K, LO, base, ra, rb, rc);
    }
  }
  __syncthreads();
  const float* xt = xs + lane;
  for (int i = 0, q0 = 0; q0 < nr; ++i, q0 += a.sb) {
    const int cnt = min(a.sb, nr - q0), q1 = q0 + a.sb;
    const int cnt1 = q1 < nr ? min(a.sb, nr - q1) : 0;
    const unsigned char* cur = ring + (size_t)(i & 1) * a.buf;
    unsigned char* nxt = ring + (size_t)((i + 1) & 1) * a.buf;
    // the next stage's first round is in flight while this one is walked
    if (cnt1)
      load_units<OBL, OC>(a, q1, cnt1, rank, K, IN, LO, by_lo, by_o, 0, ra,
                          rb, rc);
    walk_stage<OBL, D, OC>(a, cur, cnt, g, xt, acc, red);
    if (cnt1) {
      store_units(a, nxt, cnt1, K, LO, 0, ra, rb, rc);
      for (int base = per_round; base < cnt1 * units; base += per_round) {
        load_units<OBL, OC>(a, q1, cnt1, rank, K, IN, LO, by_lo, by_o, base,
                            ra, rb, rc);
        store_units(a, nxt, cnt1, K, LO, base, ra, rb, rc);
      }
    }
    __syncthreads();   // `nxt` is written and `cur` is free again
  }
  finish(a, red, acc, n0);
}

// At most 80 registers a thread (three blocks of 256 an SM), so every
// cluster of the serving grid is resident at once.
template <bool OBL, int D>
__global__ void __launch_bounds__(MAX_TILE, 3) leaf_sum_staged(const Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int rank = a.S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int n0 = (int)(blockIdx.x / a.S) * a.tile;
  switch (a.O) {
    case 1: staged_body<OBL, D, 1>(a, sm, rank, n0); break;
    case 2: staged_body<OBL, D, 2>(a, sm, rank, n0); break;
    case 3: staged_body<OBL, D, 3>(a, sm, rank, n0); break;
    default: staged_body<OBL, D, 0>(a, sm, rank, n0);
  }
}

// ------------------------------------------------------------ global walk
// Any depth, F and O: X, the node tables and the leaf values are read from
// global memory (L2) in the staged instance's tree order, with the same
// route and the same rounded products, so the bits are the ones it would
// give.
template <bool OBL>
__global__ void __launch_bounds__(MAX_TILE) leaf_sum_global(const Args a) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int S = a.S, G = a.G, tile = a.tile, tid = threadIdx.x;
  const int g = tid / tile, lane = tid - g * tile;        // group, sample
  const int rank = S > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int D = a.D, IN = (1 << D) - 1, L = 1 << D, O = a.O;
  const int n0 = (int)(blockIdx.x / S) * tile;
  const float* xrow = a.X + (size_t)min(n0 + lane, a.N - 1) * a.F;
  float* red = partials(a, sm);
  const int nr = rank_trees(live_trees(a.n_trees, a.T_cap), rank, S);

  float acc[OREG];
#pragma unroll
  for (int o = 0; o < OREG; ++o) acc[o] = 0.0f;
  if (O > OREG)
    for (int o = 0; o < O; ++o) red[(size_t)o * tile + tid] = 0.0f;
  for (int q = g; q < nr; q += ILP * G) {    // group g: positions q % G == g
    int p[ILP];
#pragma unroll
    for (int u = 0; u < ILP; ++u) p[u] = 0;
    for (int d = 0; d < D; ++d) {
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const size_t k = (size_t)tree_at(min(q + u * G, nr - 1), rank, S) * IN +
                         (OBL ? (1 << d) - 1 : p[u]);
        const int f = min(max(__ldg(a.feat + k), 0), a.F - 1);
        const int go = (__ldg(a.spl + k) != 0) &
                       (__ldg(xrow + f) > __ldg(a.thr + k));
        p[u] = OBL ? 2 * p[u] + go : 2 * p[u] + 1 + go;
      }
    }
#pragma unroll
    for (int u = 0; u < ILP; ++u) {
      if (q + u * G < nr) {
        const int t = tree_at(q + u * G, rank, S);
        const int leaf = OBL ? p[u] : p[u] - IN;
        add_leaf(a.lv + ((size_t)t * L + leaf) * O,
                 a.coeff ? a.coeff + (size_t)t * O : nullptr, O, acc, red,
                 tile);
      }
    }
  }
  finish(a, red, acc, n0);
}

typedef void (*LeafSumKernel)(const Args);

template <bool OBL>
LeafSumKernel pick(int depth, int global) {
  if (global) return leaf_sum_global<OBL>;
  switch (depth) {
    case 1: return leaf_sum_staged<OBL, 1>;
    case 2: return leaf_sum_staged<OBL, 2>;
    case 3: return leaf_sum_staged<OBL, 3>;
    case 4: return leaf_sum_staged<OBL, 4>;
    case 5: return leaf_sum_staged<OBL, 5>;
    case 6: return leaf_sum_staged<OBL, 6>;
    case 7: return leaf_sum_staged<OBL, 7>;
    case 8: return leaf_sum_staged<OBL, 8>;
    default: return nullptr;   // the plan stages depths <= 8 only
  }
}

LeafSumKernel pick_kernel(int oblivious, const int* q) {
  return oblivious ? pick<true>(q[P_D], q[P_GLOBAL])
                   : pick<false>(q[P_D], q[P_GLOBAL]);
}

// One cluster of S blocks of tile * G threads per sample tile (`cluster`
// false and S == 1: a plain launch, no cluster attribute).
cudaLaunchConfig_t config(const int* q, cudaLaunchAttribute* attr,
                          void* stream, bool cluster = true) {
  cudaLaunchConfig_t cfg = {};
  const int tiles = (q[P_N] + q[P_TILE] - 1) / q[P_TILE];
  cfg.gridDim = dim3((unsigned)(tiles * q[P_S]));
  cfg.blockDim = dim3((unsigned)(q[P_TILE] * q[P_G]));
  cfg.dynamicSmemBytes = (size_t)q[P_SMEM];
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)q[P_S];
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster || q[P_S] > 1 ? 1 : 0;
  return cfg;
}

int launch(int oblivious, const float* X, const int32_t* feat,
           const float* thr, const uint8_t* is_split, const float* lv,
           const float* coeff, const int32_t* n_trees, float* out,
           float* scratch, const int* q, void* stream) {
  const LeafSumKernel kernel = pick_kernel(oblivious, q);
  if (!kernel || q[P_CH] != CHUNK) return (int)cudaErrorInvalidValue;
  const Args a{X, feat, thr, is_split, lv, coeff, n_trees, out, scratch,
               q[P_N], q[P_F], q[P_TCAP], q[P_D], q[P_O], q[P_S], q[P_G],
               q[P_TILE], q[P_SB], q[P_RED_GLOBAL], q[P_X_OFF],
               q[P_RING_OFF], q[P_BUF], q[P_RED_OFF]};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(q, &attr, stream, false);
  const int err = (int)cudaLaunchKernelEx(&cfg, kernel, a);
  return err ? err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The most dynamic shared memory one block may opt in to on the device
// (227 KB on an H100); -1 if the device cannot be queried.
int gbrl_max_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Once per device and process: every predict instance may use up to
// `bytes` of dynamic shared memory and clusters past the portable 8 blocks.
int gbrl_predict_prepare(int bytes) {
  for (int obl = 0; obl < 2; ++obl) {
    for (int depth = 0; depth <= MAX_STAGED_DEPTH; ++depth) {
      int q[P_COUNT] = {};
      q[P_D] = depth;
      q[P_GLOBAL] = depth == 0;
      const void* k = (const void*)pick_kernel(obl, q);
      int err = (int)cudaFuncSetAttribute(
          k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (!err)
        err = (int)cudaFuncSetAttribute(
            k, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err) return err;
    }
  }
  return 0;
}

// How many clusters of the plan `q` the device can hold at once (>= 1 when
// the launch can run), or -(CUDA error).
int gbrl_predict_max_clusters(int oblivious, const int* q) {
  const LeafSumKernel kernel = pick_kernel(oblivious, q);
  if (!kernel) return -(int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(q, &attr, nullptr);
  int n = 0;
  const int err =
      (int)cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg);
  return err ? -err : n;
}

// X [N, F] f32; feat [T_cap, 2^D-1] i32; thr [T_cap, 2^D-1] f32;
// is_split [T_cap, 2^D-1] u8; lv [T_cap, 2^D, O] f32; coeff [T_cap, O] f32
// or null (lv already scaled); n_trees [1] i32 on the device; out [N, O]
// f32; scratch: the plan's per-block partials when they live in global
// memory, else null; q: ops/kernels.py _predict_params (P_*).  Returns the
// launch's CUDA error (0 on success).
int gbrl_k4_leaf_sum(const float* X, const int32_t* feat, const float* thr,
                     const uint8_t* is_split, const float* lv,
                     const float* coeff, const int32_t* n_trees, float* out,
                     float* scratch, const int* q, void* stream) {
  return launch(0, X, feat, thr, is_split, lv, coeff, n_trees, out, scratch,
                q, stream);
}

int gbrl_k5_leaf_sum(const float* X, const int32_t* feat, const float* thr,
                     const uint8_t* is_split, const float* lv,
                     const float* coeff, const int32_t* n_trees, float* out,
                     float* scratch, const int* q, void* stream) {
  return launch(1, X, feat, thr, is_split, lv, coeff, n_trees, out, scratch,
                q, stream);
}

const char* gbrl_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
