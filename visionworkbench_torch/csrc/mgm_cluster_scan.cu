// MGM line scans of wide search windows, for Hopper (sm_90a): a line's
// lanes split over the blocks of one thread-block cluster, each block
// exchanging its edge lanes with the neighbour blocks through distributed
// shared memory. A plain C interface loaded through ctypes
// (visionworkbench_torch/ops/sgm_scan.py).
//
// Replaces two TPU kernels of visionworkbench_tpu/ops/sgm_scan.py on the
// grids of more than VW_MGM_MAX_CELLS disparity cells, which csrc/mgm_scan.cu
// (one thread a lane, its cells in registers; longer lines over a cluster
// too) does not take:
//   * kBidir, pallas_mgm_bidir (pl.pallas_call at :222): the forward and
//     reverse diagonal-pair tasks, prior lane shifts (+1, -1), summed;
//   * kFwd, pallas_mgm_fwd (:272): the sheared forward scan over B
//     orientations, prior lane shifts (0, +1), every step stored.
// An MGM step at lane l is floor((L(l - s0) + L(l - s1)) / 2), reset to
// the cost C where the guard is false and forced to bad where C >= bad,
// with the path update of the prior of source lane m
//   L(m) = C + min(P(m), min3x3(P(m)) + P1, min_prior(m) + P2') - min_prior(m)
// and P2' = max(floor(P2 / max(|dI(l)|, 1)), P1) (an IEEE quotient); a
// source lane outside the line has an all-bad prior, an out-of-grid 3x3
// neighbour reads bad along an axis of size > 1. These are the functions of
// mgm_bidir_plain / mgm_fwd_plain; every value is an integer-valued fp32
// below 2^24, so the kernels equal them bit for bit.
//
// The difference from SGM. An SGM path line is one chain per lane
// (csrc/sgm_path_scan.cu gives each its own warp). An MGM step averages two
// source lanes, so every lane of a line depends on its neighbours at every
// step, and a line's whole state (sy * sx * L floats: 512 KB at the 64x8
// search over 256 lanes) must take part in every step. One SM holds 227 KB
// of shared memory and 256 KB of registers, which is why the first kernel
// for these shapes (line_scan_kernel<1> of csrc/sgm_scan.cu) kept the carry
// in global scratch and paid ~0.72 ms a step (chip_smoke.py, NVIDIA H100
// 80GB HBM3, 700 W). Here one cluster of up to VW_CLUSTER_MAX_BLOCKS blocks
// holds one line (group or orientation): the lanes are split over its
// blocks, each lane's carry stays in registers (over a warp or half of
// one), and only what a neighbouring lane reads crosses lanes.
//
// What crosses lanes (csrc/mgm_scan.cu's decomposition). Each lane computes
// once a step, from its own prior, min_prior mp and m1 = min(P, min3x3(P) +
// P1) per cell, and posts them to a double-buffered array in its block's
// shared memory; a reader takes best = min(m1, mp + P2') with its own
// |dI| and L = C + (best - mp): the plain version's operations in its
// order. A block's first and last lane store theirs into the neighbour
// blocks' halos through distributed shared memory (map_shared_rank) as
// they post them. The line's two end lanes read a row of what a lane
// outside the line gives. With the arrays double-buffered, one cluster
// barrier (barrier.cluster.arrive.release / wait.acquire) a step orders
// every post before its reads and every read before the buffer is posted
// again. A first cluster barrier orders every block's initialisation before
// any read and before any store into it; a last one keeps every block's
// shared memory alive until its neighbours are done with it.
//
// cluster_wide_kernel<T, K, MODE>, one instance a cell count and a mode:
// grids of more than VW_MGM_MAX_CELLS cells (the 64x8 search of
// calc_disparity_sgm(use_mgm=True): 512). A lane's cells go over T threads
// (16, or 32 past 256 cells), K a thread, cell c = j + T * i in thread j.
// The separable 3x3 grid min
// (run-time sy, sx) goes through a padded copy of the lane's grid in shared
// memory, as in path_scan_kernel; mp is a min over the K cells and log2(T)
// xor shuffles. cost and out put lanes last, so a lane's cells are L floats
// apart: the block stages each step's (cells x its lanes) slab of costs with
// cp.async, double-buffered (step t + 1's loads run under step t), each lane
// writes its result over its costs, and after a block barrier the block
// stores (fwd, streaming stores) or adds (bidir) the slab into the output a
// cell row of its lanes at a time. |dI| and guard are loaded into registers
// a step ahead. Grids of up to VW_MGM_MAX_CELLS cells on lines past one
// block (config 6's level 0 at 1024^2) run csrc/mgm_scan.cu's kernel as a
// cluster instead.
// bidir adds its two groups into a zeroed output with atomics (integer
// terms onto 0: exact in any order); at the 64x8 search the two groups'
// lines cannot share a cluster (each fills 16 blocks), so storing once
// would need a second pass.
//
// What bounds it on the H100: one step's latency times the N steps, as for
// every scan here; only 2 (bidir) or B (fwd) clusters run. Taken out one
// at a time (visionworkbench_torch/tools/mgm_cluster_ablation.py; NVIDIA
// H100 80GB HBM3, 700 W; PERF.md), a 6.6 us step of bidir at the 64x8
// search spends ~1.4 us on its atomics, ~1.0 on the grid
// min, ~0.6 on the cluster barrier and ~0.15 on distributed shared
// memory; the rest is the ~13 shared accesses a cell on 16 warps an SM.
// Spreading a line over more blocks (fewer warps an SM) is faster at every
// measured width: the wrapper takes up to 16.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

#if !defined(VW_CLUSTER_MAX_CELLS) || !defined(VW_CLUSTER_MAX_BLOCKS) || \
    !defined(VW_CLUSTER_MAX_THREADS)
#error "needs -DVW_CLUSTER_MAX_CELLS, -DVW_CLUSTER_MAX_BLOCKS and -DVW_CLUSTER_MAX_THREADS (ops/_build.py)"
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = VW_CLUSTER_MAX_CELLS / 32;  // cells a thread
constexpr int kMaxBlocks = VW_CLUSTER_MAX_BLOCKS;   // blocks a cluster
constexpr int kMaxThreads = VW_CLUSTER_MAX_THREADS;  // threads a block
constexpr int kMaxSmem = 232448;  // bytes of shared memory a block may use

// The modes, numbered as vw_mgm_cluster_scan's mode argument (and as
// csrc/mgm_scan.cu's).
enum Mode { kFwd = 0, kBidir = 1 };

struct ClusterArgs {
  const float* cost[2];
  const float* pd[2];
  const unsigned char* guard[2];
  float* out[2];
  int N, L, sy, sx;
  long long cost_n, cost_b, pd_n, pd_b, out_n, out_b;  // strides, elements
  // lanes a block (a power of two) and its log2; the exchange row, padded grid and slab row strides, in floats
  int lanes, lg, rs, pgs, ss;
  float p1, p2, bad;
};

// The line a cluster scans and its place: bidir's group g (group 1 walks
// n = N - 1 - t), fwd's orientation b. The group picks a pointer by a
// select: a run-time index into the parameter arrays copies them to the
// stack.
struct Line {
  const float* cost;
  const float* pd;
  const unsigned char* guard;
  float* out;
  bool rev;
};

template <int MODE>
__device__ __forceinline__ Line line_of(const ClusterArgs& a, int line) {
  const bool g = MODE == kBidir && line == 1;
  const int b = MODE == kBidir ? 0 : line;
  return Line{(g ? a.cost[1] : a.cost[0]) + b * a.cost_b,
              (g ? a.pd[1] : a.pd[0]) + b * a.pd_b,
              (g ? a.guard[1] : a.guard[0]) + b * a.pd_b,
              (g ? a.out[1] : a.out[0]) + b * a.out_b, g};
}

// ---- a lane over T threads, K cells a thread ---------------------------------

// A 4-byte asynchronous copy global -> shared; bytes 0 fills with zeros
// and reads nothing.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Block rank r of a line's cluster holds lanes r * lanes + lb, lane lb on
// threads lb * T ... lb * T + T - 1. Shared memory (floats): the exchange
// rows xb[2][lanes][rs] (m1 of each cell, mp at [cells]); the outside row
// [rs]; each lane's padded (sy + 2) x (sx + 2) grid [lanes][pgs]; the slab
// [2][cells][ss] of costs and results, lanes last (ss = lanes + 1); the
// halo [2][2][rs]: [buffer][0] the previous block's last lane's row,
// [buffer][1] the next block's first lane's row, which those lanes store
// there through distributed shared memory as they post their own. Stores
// need no wait, and every read of the update is a local shared-memory load
// (the neighbour's rows read in the update, each load waiting for the
// store before it, cost ~1.5 us a step at the 64x8 search; copied into a
// halo by the reader, the copy's registers spilled at K = 16).
template <int T, int K, int MODE>
__global__ void __launch_bounds__(kMaxThreads, 1)
    cluster_wide_kernel(ClusterArgs a) {
  constexpr bool BIDIR = MODE == kBidir;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nb = cluster.num_blocks(), rank = cluster.block_rank();
  const Line ln = line_of<MODE>(a, blockIdx.x / nb);
  const int N = a.N, L = a.L, sx = a.sx, cells = a.sy * a.sx;
  const int lanes = a.lanes, rs = a.rs, ss = a.ss, w2 = sx + 2;
  const int tid = threadIdx.x, j = tid % T, lb = tid / T;
  const int l0 = rank * lanes, lane = l0 + lb;
  const float p1 = a.p1, p2 = a.p2, bad = a.bad;
  float* const xb = sm;
  float* const outside = xb + 2 * lanes * rs;
  float* const grids = outside + rs;
  float* const grid = grids + lb * a.pgs;
  float* const slab = grids + lanes * a.pgs;
  float* const halo = slab + 2 * cells * ss;
  const bool push_next = lb == lanes - 1 && rank < nb - 1;
  const bool push_prev = lb == 0 && rank > 0;
  for (int i = tid; i < rs; i += blockDim.x)
    outside[i] = i < cells ? fminf(bad, bad + p1) : bad;
  for (int i = tid; i < lanes * a.pgs; i += blockDim.x) grids[i] = bad;
  // every warp's grid border and every block of the cluster set up before
  // step 0 reads the border or stores into a neighbour's halo
  cluster.sync();

  // The rows this lane reads, buffer 0, and the stride to buffer 1: lane
  // l - 1 (up) and lane l + 1 (dn), in this block, the halo (the
  // neighbour block's row) or the outside row.
  const bool up_halo = lane > 0 && lb == 0;
  const bool dn_halo = lane + 1 < L && lb == lanes - 1;
  const float* up = lane == 0 ? outside : up_halo ? halo : xb + (lb - 1) * rs;
  const float* dn = lane + 1 >= L ? outside : dn_halo ? halo + rs : xb + (lb + 1) * rs;
  const int up_buf = lane == 0 ? 0 : up_halo ? 2 * rs : lanes * rs;
  const int dn_buf = lane + 1 >= L ? 0 : dn_halo ? 2 * rs : lanes * rs;

  // The thread's cells c = j + T i: their place in the padded grid, two
  // 16-bit indices a register (the grid is at most 3 x 514 floats), and the
  // carry (cells past sy * sx hold +inf, so min_prior ignores them).
  unsigned pk[(K + 1) / 2];
  float P[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = j + T * i;
    const int y = c / sx;
    const unsigned p = (y + 1) * w2 + (c - y * sx) + 1;
    pk[i / 2] = i % 2 ? pk[i / 2] | (p << 16) : p;
    P[i] = c < cells ? bad : __int_as_float(0x7f800000);
  }
  auto pidx = [&](int i) -> int { return (pk[i / 2] >> (16 * (i % 2))) & 0xffffu; };

  // Staging and output role of thread tid: lane sl of the block's lanes,
  // cells sc0 + T r (the block's threads are T x lanes); both walk their
  // cells by a running pointer.
  const int sl = tid & (lanes - 1), sc0 = tid >> a.lg;
  const bool s_in = l0 + sl < L;
  const long long cell_step = (long long)T * L;
  const float* const cost0 = ln.cost + (long long)sc0 * L + (s_in ? l0 + sl : 0);
  float* const out0 = ln.out + (long long)sc0 * L + l0 + sl;
  auto row_of = [&](int t) -> long long { return ln.rev ? N - 1 - t : t; };
  auto stage = [&](int t, int buf) {
    const float* src = cost0 + row_of(t) * a.cost_n;
    float* dst = slab + (buf * cells + sc0) * ss + sl;
#pragma unroll
    for (int r = 0; r < K; ++r, src += cell_step)
      if (sc0 + T * r < cells) cp_async4(dst + T * r * ss, src, s_in ? 4 : 0);
    cp_async_commit();
  };

  const bool active = lane < L;
  const unsigned char* const gp = ln.guard + lane;
  const float* const pdp = ln.pd + lane;
  float pdn = 1.f;
  bool gn = false;
  auto load = [&](int t) {
    if (active) {
      const long long n = row_of(t);
      pdn = __ldg(pdp + n * a.pd_n);
      gn = __ldg(gp + n * a.pd_n) != 0;
    }
  };
  load(0);
  stage(0, 0);

  for (int t = 0; t < N; ++t) {
    const int cur = t & 1;
    const float pdv = pdn;
    const bool keep = gn;
    if (t + 1 < N) load(t + 1);

    // min_prior over the lane's T threads
    float mp = P[0];
#pragma unroll
    for (int i = 1; i < K; ++i) mp = fminf(mp, P[i]);
#pragma unroll
    for (int o = T / 2; o > 0; o >>= 1)
      mp = fminf(mp, __shfl_xor_sync(kFull, mp, o));
    // the separable 3x3 grid min through the padded grid (its border
    // stays bad): the y pass, then the x pass over its result
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (j + T * i < cells) grid[pidx(i)] = P[i];
    __syncwarp();
    float q[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      q[i] = P[i];
      if (a.sy > 1 && j + T * i < cells)
        q[i] = fminf(fminf(q[i], grid[pidx(i) - w2]), grid[pidx(i) + w2]);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (j + T * i < cells) grid[pidx(i)] = q[i];
    __syncwarp();
    // m1 = min(P, grid_min + P1), posted with mp to this step's row and,
    // from the block's edge lanes, to the neighbour blocks' halos (fwd
    // reads its own back from its row: K registers fewer, no spill at K 16)
    float* const row = xb + (cur * lanes + lb) * rs;
    float* const to_next =
        push_next ? cluster.map_shared_rank(halo + cur * 2 * rs, rank + 1) : nullptr;
    float* const to_prev =
        push_prev ? cluster.map_shared_rank(halo + (cur * 2 + 1) * rs, rank - 1)
                  : nullptr;
    auto post = [&](int c, float v) {
      row[c] = v;
      if (push_next) to_next[c] = v;
      if (push_prev) to_prev[c] = v;
    };
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int c = j + T * i;
      if (c < cells) {
        float r = q[i];
        if (sx > 1) r = fminf(fminf(r, grid[pidx(i) - 1]), grid[pidx(i) + 1]);
        post(c, fminf(P[i], r + p1));
      }
    }
    if (j == 0) post(cells, mp);
    cp_async_wait_all();
    cluster.sync();  // the rows are posted, step t's slab is in
    if (t + 1 < N) stage(t + 1, cur ^ 1);

    const float* const ru = up + cur * up_buf;
    const float* const rd = dn + cur * dn_buf;
    const float p2m = fmaxf(floorf(p2 / fmaxf(pdv, 1.f)), p1);
    float mp0, mp1;
    if (BIDIR) {
      mp0 = ru[cells];
      mp1 = rd[cells];
    } else {
      mp0 = mp;
      mp1 = ru[cells];
    }
    const float lim0 = mp0 + p2m, lim1 = mp1 + p2m;
    float* const col = slab + cur * cells * ss + lb;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const int c = j + T * i;
      if (c < cells) {
        const float s0 = BIDIR ? ru[c] : row[c];
        const float s1 = BIDIR ? rd[c] : ru[c];
        const float C = col[c * ss];
        const float va = C + (fminf(s0, lim0) - mp0);
        const float vb = C + (fminf(s1, lim1) - mp1);
        float v = keep ? floorf((va + vb) * 0.5f) : C;
        if (C >= bad) v = bad;
        P[i] = v;
        col[c * ss] = v;
      }
    }
    __syncthreads();  // the block's results are in the slab
    if (s_in) {
      float* dst = out0 + row_of(t) * a.out_n;
      const float* src = slab + (cur * cells + sc0) * ss + sl;
      // 4 at a time: unrolled whole, the K = 16 instances spill registers
      // (3 % faster with the spills, 25 % slower one at a time)
#pragma unroll 4
      for (int r = 0; r < K; ++r, dst += cell_step)
        if (sc0 + T * r < cells) {
          if (BIDIR)
            atomicAdd(dst, src[T * r * ss]);
          else
            __stcs(dst, src[T * r * ss]);
        }
    }
  }
  cluster.sync();  // the neighbours' last reads of this block's rows
}

// ---- launch -----------------------------------------------------------------

// Launch `kernel` as clusters of `blocks` blocks of `threads`, one cluster
// a line; refuse a cluster the card cannot schedule.
template <typename Kernel>
cudaError_t launch(Kernel kernel, const ClusterArgs& a, int lines, int blocks,
                   int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && blocks > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks * lines);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The instance of K cells a thread over T threads a lane, from the first K
// the picker gives T (2 for 16, kMaxK for 32) to kMaxK.
template <int T, int K>
cudaError_t dispatch(int k, int mode, const ClusterArgs& a, int lines,
                          int blocks, int threads, int smem, cudaStream_t s) {
  if constexpr (K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (k != K)
      return dispatch<T, 2 * K>(k, mode, a, lines, blocks, threads, smem, s);
    if (mode == kFwd)
      return launch(cluster_wide_kernel<T, K, kFwd>, a, lines, blocks, threads,
                    smem, s);
    return launch(cluster_wide_kernel<T, K, kBidir>, a, lines, blocks, threads,
                  smem, s);
  }
}

// Smallest n >= v with n % 32 == 16: a row stride that puts the two lanes
// of a warp (T = 16) on disjoint banks.
int stride16(int v) { return v + ((16 - v % 32) + 32) % 32; }

}  // namespace

// Returns a cudaError_t (0 on success). The caller checks shapes, types and
// contiguity. mode 1: mgm_bidir, lines 2 (line g: group g, group 1
// reverse), adding into a zeroed output; mode 0: mgm_fwd, lines B (line b:
// orientation b), storing every step. Line g or b reads cost_g / pd_g /
// guard_g at offset b * (cost_b, pd_b) and writes out_g at b * out_b; step
// n at n * (cost_n, pd_n, out_n). t: threads a lane, 16 or 32; k: cells a
// thread, a power of two, t * k >= sy * sx; threads: threads a block (a
// multiple of 32, at most VW_CLUSTER_MAX_THREADS; lanes a block threads /
// t, a power of two); blocks: blocks a cluster (at most
// VW_CLUSTER_MAX_BLOCKS), whose lanes cover L.
extern "C" int vw_mgm_cluster_scan(
    int mode, const float* cost0, const float* cost1, const float* pd0,
    const float* pd1, const unsigned char* guard0,
    const unsigned char* guard1, float* out0, float* out1, int lines, int N,
    int sy, int sx, int L, long long cost_n, long long cost_b, long long pd_n,
    long long pd_b, long long out_n, long long out_b, float p1, float p2,
    float bad, int t, int k, int threads, int blocks, void* stream) {
  const int cells = sy * sx;
  if ((mode != kFwd && mode != kBidir) || lines < 1 || N < 1 || L < 1 ||
      sy < 1 || sx < 1 || threads < 32 || threads % 32 != 0 ||
      threads > kMaxThreads || blocks < 1 || blocks > kMaxBlocks)
    return cudaErrorInvalidValue;
  ClusterArgs a;
  a.cost[0] = cost0;
  a.cost[1] = cost1;
  a.pd[0] = pd0;
  a.pd[1] = pd1;
  a.guard[0] = guard0;
  a.guard[1] = guard1;
  a.out[0] = out0;
  a.out[1] = out1;
  a.N = N;
  a.L = L;
  a.sy = sy;
  a.sx = sx;
  a.cost_n = cost_n;
  a.cost_b = cost_b;
  a.pd_n = pd_n;
  a.pd_b = pd_b;
  a.out_n = out_n;
  a.out_b = out_b;
  a.p1 = p1;
  a.p2 = p2;
  a.bad = bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((t != 16 && t != 32) || cells > 32 * kMaxK) return cudaErrorInvalidValue;
  const int lanes = threads / t;
  if ((lanes & (lanes - 1)) != 0 || (long long)t * k < cells ||
      (long long)lanes * blocks < L)
    return cudaErrorInvalidValue;
  a.lanes = lanes;
  a.lg = 0;
  while ((1 << a.lg) < lanes) ++a.lg;
  a.rs = stride16(cells + 1);
  a.pgs = stride16((sy + 2) * (sx + 2));
  a.ss = lanes + 1;
  const long long smem =
      4LL * (2LL * lanes * a.rs + a.rs + (long long)lanes * a.pgs +
             2LL * cells * a.ss + 4LL * a.rs);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (t == 16)
    return dispatch<16, 2>(k, mode, a, lines, blocks, threads, (int)smem, s);
  return dispatch<32, kMaxK>(k, mode, a, lines, blocks, threads, (int)smem, s);
}
