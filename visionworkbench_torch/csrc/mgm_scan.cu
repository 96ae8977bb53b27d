// SGM and MGM line scans for Hopper (sm_90a) with each lane's carry in
// registers, with a plain C interface loaded through ctypes
// (visionworkbench_torch/ops/sgm_scan.py).
//
// Replaces three TPU kernels of visionworkbench_tpu/ops/sgm_scan.py on the
// shapes the SGM and MGM main paths give them (up to VW_MGM_MAX_CELLS
// disparity cells a lane, up to VW_MGM_MAX_LANES lanes a block, both set by
// ops/_build.py; MGM lines of more lanes over a cluster, below), one mode
// each:
//   * kSgm, pallas_scan_bidir (pl.pallas_call at :149): B <= 3 path
//     directions, each with one prior lane shift s of {0, +1, -1}, forward
//     and reverse, all 2 * B lines summed;
//   * kBidir, pallas_mgm_bidir (:222): the forward and reverse
//     diagonal-pair tasks, prior lane shifts (+1, -1), summed;
//   * kFwd, pallas_mgm_fwd (:272): the sheared forward scan over B
//     orientations, prior lane shifts (0, +1), every step stored.
// The path update is
//   L(prior) = C + min(prior, min3x3(prior) + P1, min_prior + P2') - min_prior
// with  P2' = max(floor(P2 / max(|dI|, 1)), P1). An SGM step is L of the
// prior shifted by s; an MGM step is floor((L(shift s0) + L(shift s1)) / 2),
// reset to C where the guard is false. Every step is forced to bad where
// C >= bad; a prior lane shifted in from outside the line, and an
// out-of-grid 3x3 neighbour, read bad. Wider MGM grids run
// csrc/mgm_cluster_scan.cu, other SGM grids and longer SGM lines
// csrc/sgm_path_scan.cu; what neither takes (and other MGM shift pairs)
// runs line_scan_kernel<0> / <1> of csrc/sgm_scan.cu. All compute the same
// functions.
//
// Lines past VW_MGM_MAX_LANES lanes (MGM modes only; config 6's level 0 at
// 1024^2: 1024 lanes) run the same kernel as a thread-block cluster of up to
// VW_CLUSTER_MAX_BLOCKS blocks a line, its CLUSTER instances: block rank r
// holds lanes r * blockDim.x + threadIdx.x, the step is the one below, a
// cluster barrier (barrier.cluster.arrive.release / wait.acquire) takes the
// place of the block barrier, and the block's first warp reads the previous
// block's last edge row and its last warp the next block's first, through
// distributed shared memory (map_shared_rank). A last cluster barrier keeps
// every block's rows alive until its neighbours have read them. The cluster
// code is compiled out of the one-block instances: carried at run time, it
// slowed either the one-block scans (512^2: +8.5 %) or the cluster ones
// (1024^2: +13-20 %) (chip_smoke.py, tools/mgm_scan_ablation.py; PERF.md).
// A 1024-lane step over 16 blocks of 64 takes ~1.56 us, ~0.5 of it the
// cluster barrier (NVIDIA H100 80GB HBM3, 700 W); spreading a line over
// more blocks (fewer warps an SM) is faster at every width measured past
// 512 lanes, so the wrapper takes up to 16.
//
// What bounds it on the H100: the time of one step times the N steps. The
// work is tiny and sequential; only 2 * B (SGM), B (fwd) or 2 (bidir) blocks
// run, one per SM. The earlier kernels (line_scan_kernel<0>, <1>) kept the
// carry in shared memory and re-read, for every cell of every lane, the
// source lane's priors and its 3x3 neighbours, once per shift: ~70 (SGM) or
// ~140 (MGM) dependent shared loads and mins per lane and step, ~5.4 / ~9 us
// per step at config 6's level 0. Here an MGM step takes ~1.6 us and an
// SGM step ~1.08 us (x-scan; ~0.77 us for the shift-0 y-scan)
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W). Taken out one at a time
// (visionworkbench_torch/tools/mgm_scan_ablation.py), the next step's loads
// cost ~0.45-0.6 us of an MGM step (~0.33 of an SGM x-scan step), the
// barrier ~0.4 (~0.28), the stores or atomics ~0.2-0.27 (~0.26); the rest
// is issue: the (2, 5) instances are 632 (fwd), 704 (bidir) and 568 (SGM)
// SASS instructions, most of them the step's, for 16 warps on one SM's
// four schedulers. Here:
//   * The grid (SY, SX) is a template argument, so every per-lane loop
//     unrolls and the lane's carry P[SY * SX] lives in registers.
//   * One thread per lane. Each lane computes once per step, from its own
//     prior, what any lane that reads it needs: min_prior mp and
//     m1 = min(P, min3x3(P) + P1) per cell (the separable 3x3 grid min, as
//     the plain version). The reader takes best = min(m1, mp + P2'), where
//     P2' comes from its own |dI|, and L = C + (best - mp): the plain
//     version's operations in its order, so the result is bit for bit.
//   * The source lane's m1 and mp arrive by warp shuffles (shfl_up for
//     lane l - 1, shfl_down for lane l + 1; SGM: one shfl_idx from lane
//     l - s, the block's shift s being uniform). Only a warp's edge lane
//     crosses warps: lane 31 (and lane 0, bidir; SGM: lane 31 for s = +1,
//     lane 0 for s = -1) posts its CELLS + 1 values as float4s to a
//     double-buffered shared array, so a step costs one __syncthreads (SGM
//     with s = 0 exchanges nothing and needs none). Two extra rows hold
//     what a lane outside the line gives (bad priors), so no lane tests
//     whether its source is inside.
//   * Step t + 1's costs, |dI| and guard are loaded (read-only path) into
//     registers before step t computes; fwd stores each step with
//     streaming stores, bidir and SGM add their lines into a zeroed output
//     with fire-and-forget atomics (integer-valued terms below 2^24 onto
//     0: exact in any order, and one launch instead of 2 * B outputs and a
//     sum). The lane's pointers advance by one step each and one branch per
//     step skips lanes past L: no 64-bit product and no per-cell branch in
//     the step (mgm_fwd took 19 % longer with them).
// Lanes past L (the partial last warp) run the loop with the block, so the
// shuffles and the barrier stay converged; they load and store nothing, and
// their carry stays bad, so lane L - 1 reads from lane L what a lane outside
// the line gives.
//
// SGM is a mode here, not a source of its own: it is the MGM step with one
// path update and no guard, and shares the MGM kernel's loads, source terms,
// edge rows, instance limits and dispatch (one build, 150 one-block
// instances and the MGM modes' 100 cluster instances).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

#if !defined(VW_MGM_MAX_CELLS) || !defined(VW_MGM_MAX_LANES) || \
    !defined(VW_CLUSTER_MAX_BLOCKS)
#error "needs -DVW_MGM_MAX_CELLS, -DVW_MGM_MAX_LANES and -DVW_CLUSTER_MAX_BLOCKS (ops/_build.py)"
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxCells = VW_MGM_MAX_CELLS;  // grids with sy * sx <= this
constexpr int kMaxLanes = VW_MGM_MAX_LANES;  // threads a block, 32 | this
constexpr int kMaxBlocks = VW_CLUSTER_MAX_BLOCKS;  // blocks a line (MGM)

// The modes, numbered as vw_mgm_scan's mode argument.
enum Mode { kFwd = 0, kBidir = 1, kSgm = 2 };

struct MgmArgs {
  const float* cost[2];
  const float* pd[2];
  const unsigned char* guard[2];  // null for kSgm
  float* out[2];
  int N, L;
  int shift[3];  // kSgm: the prior lane shift of direction b
  long long cost_n, cost_b, pd_n, pd_b, out_n, out_b;  // strides, elements
  float p1, p2, bad;
};

// kSgm: block (b, g) sources lane l - shift[b]; group 1 walks n = N-1-t,
// atomicAdd into a zeroed output. kBidir: sources lane l - 1 (shift +1) and
// l + 1 (shift -1), group 1 walks n = N-1-t, atomicAdd into a zeroed
// output. kFwd: sources lane l (shift 0) and l - 1 (shift +1), one group,
// each step stored. CLUSTER (MGM modes): line (b, g) is the cluster of nb
// blocks nb * b ... nb * b + nb - 1 of grid row g.
template <int SY, int SX, int MODE, bool CLUSTER>
__global__ void __launch_bounds__(kMaxLanes, 1) mgm_scan_kernel(MgmArgs a) {
  static_assert(!CLUSTER || MODE != kSgm, "SGM lines run one block each");
  constexpr bool SGM = MODE == kSgm, BIDIR = MODE == kBidir;
  constexpr int CELLS = SY * SX;
  constexpr int SIDES = BIDIR ? 2 : 1;
  constexpr int ROW = (CELLS + 4) / 4 * 4;  // m1 of each cell, mp; float4s
  // [buffer][warp + 1][0: lane 31's row (SGM: the posting lane's), 1: lane
  // 0's]; rows 0 and warps + 1 hold what the lanes outside the line give
  __shared__ __align__(16) float edge[2][kMaxLanes / 32 + 2][SIDES][ROW];

  const int L = a.L, N = a.N;
  const int nb = CLUSTER ? cg::this_cluster().num_blocks() : 1;
  const int rank = CLUSTER ? cg::this_cluster().block_rank() : 0;
  const int b = blockIdx.x / nb, g = blockIdx.y;
  const int l = rank * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const bool active = l < L;
  // SGM: the block's shift (uniform), the lane it reads in the warp, and
  // whether that lane is in the next or previous warp (read from its row).
  const int s = SGM ? a.shift[b] : 0;
  const int src_lane = (lane - s) & 31;
  const bool src_row = lane - s != src_lane;
  // The lane's inputs and output at step 0, and their steps: group 1 of
  // bidir and SGM walks n = N-1-t. Pointers advance by a step each;
  // nothing is multiplied in the loop.
  const bool rev = MODE != kFwd && g == 1;
  const long long n0 = rev ? N - 1 : 0, dir = rev ? -1 : 1;
  const float* __restrict__ cost = a.cost[g] + b * a.cost_b + n0 * a.cost_n + l;
  const float* __restrict__ pd = a.pd[g] + b * a.pd_b + n0 * a.pd_n + l;
  const unsigned char* __restrict__ guard = nullptr;
  if constexpr (!SGM) guard = a.guard[g] + b * a.pd_b + n0 * a.pd_n + l;
  float* __restrict__ out = a.out[g] + b * a.out_b + n0 * a.out_n + l;
  const long long dcost = dir * a.cost_n, dpd = dir * a.pd_n,
                  dout = dir * a.out_n;
  const float p1 = a.p1, p2 = a.p2, bad = a.bad;
  // What a source lane outside the line gives (every prior bad): the rows
  // beside the first and last warp. Lanes past L in the last warp give the
  // same: their carry stays bad (their cost is bad), and they compute it
  // with the same operations.
  if (threadIdx.x < ROW) {
    const float v = threadIdx.x < CELLS ? fminf(bad, bad + p1) : bad;
    for (int buf = 0; buf < 2; ++buf) {
      edge[buf][0][0][threadIdx.x] = v;
      edge[buf][warps + 1][SIDES - 1][threadIdx.x] = v;
    }
  }
  // The rows the warp reads, buffer 0 (buffer 1 is kBuf floats on): the
  // previous warp's lane-31 row and the next warp's lane-0 row, or the
  // outside rows; over a cluster, the block's first warp reads the previous
  // block's last row and its last warp the next block's first.
  constexpr int kBuf = (kMaxLanes / 32 + 2) * SIDES * ROW;
  const float* up_row = &edge[0][warp][0][0];
  const float* dn_row = &edge[0][warp + 2][SIDES - 1][0];
  if constexpr (CLUSTER) {
    if (warp == 0 && rank > 0)
      up_row = cg::this_cluster().map_shared_rank(&edge[0][warps][0][0], rank - 1);
    if (warp == warps - 1 && rank < nb - 1)
      dn_row = cg::this_cluster().map_shared_rank(&edge[0][1][SIDES - 1][0], rank + 1);
  }

  float P[CELLS], Cn[CELLS];
#pragma unroll
  for (int c = 0; c < CELLS; ++c) P[c] = Cn[c] = bad;
  float pdn = 1.f;
  bool gn = false;
  // the next step's inputs (lanes past L keep bad costs), then one step on
  auto load = [&]() {
    if (active) {
      const float* cn = cost;
#pragma unroll
      for (int c = 0; c < CELLS; ++c, cn += L) Cn[c] = __ldg(cn);
      pdn = __ldg(pd);
      if constexpr (!SGM) gn = __ldg(guard) != 0;
    }
    cost += dcost;
    pd += dpd;
    if constexpr (!SGM) guard += dpd;
  };
  load();

  for (int t = 0; t < N; ++t) {
    float C[CELLS];
#pragma unroll
    for (int c = 0; c < CELLS; ++c) C[c] = Cn[c];
    const float pdv = pdn;
    const bool keep = gn;
    if (t + 1 < N) load();

    // The lane's own source terms: min_prior, and m1 = min(P, grid_min + P1)
    // with the grid min as the plain version's two separable passes.
    float mp = P[0];
#pragma unroll
    for (int c = 1; c < CELLS; ++c) mp = fminf(mp, P[c]);
    float q[CELLS], m1[CELLS];
#pragma unroll
    for (int y = 0; y < SY; ++y)
#pragma unroll
      for (int x = 0; x < SX; ++x) {
        float v = P[y * SX + x];
        if (SY > 1) {
          v = fminf(v, y > 0 ? P[(y - 1) * SX + x] : bad);
          v = fminf(v, y < SY - 1 ? P[(y + 1) * SX + x] : bad);
        }
        q[y * SX + x] = v;
      }
#pragma unroll
    for (int y = 0; y < SY; ++y)
#pragma unroll
      for (int x = 0; x < SX; ++x) {
        float v = q[y * SX + x];
        if (SX > 1) {
          v = fminf(v, x > 0 ? q[y * SX + x - 1] : bad);
          v = fminf(v, x < SX - 1 ? q[y * SX + x + 1] : bad);
        }
        m1[y * SX + x] = fminf(P[y * SX + x], v + p1);
      }

    // Post the warp's edge lanes (float4 stores), then one barrier for
    // the block (the cluster's, over a cluster).
    const int buf = t & 1;
    float(*eb)[SIDES][ROW] = edge[buf];
    auto post = [&](float* row) {
      float e[ROW];
#pragma unroll
      for (int k = 0; k < ROW; ++k) e[k] = k < CELLS ? m1[k] : mp;
#pragma unroll
      for (int k = 0; k < ROW; k += 4)
        *reinterpret_cast<float4*>(row + k) =
            make_float4(e[k], e[k + 1], e[k + 2], e[k + 3]);
    };
    if (SGM ? (s != 0 && lane == (s > 0 ? 31 : 0)) : lane == 31)
      post(eb[warp + 1][0]);
    if (BIDIR && lane == 0) post(eb[warp + 1][SIDES - 1]);
    if constexpr (CLUSTER)
      cg::this_cluster().sync();
    else if (!SGM || s != 0)
      __syncthreads();
    // Lane l - 1's value and lane l + 1's, by shuffles (every lane takes
    // part); lane 0 takes the row of the previous warp's lane 31, and lane
    // 31 that of the next warp's lane 0, read by the warp as float4
    // broadcasts. SGM: lane l - s's value; the lane whose source is in the
    // neighbour warp reads that warp's row (row warp + 1 - s). k: the
    // cell, or CELLS for mp.
    const float4* row_up = reinterpret_cast<const float4*>(eb[warp][0]);
    const float4* row_dn =
        reinterpret_cast<const float4*>(eb[warp + 2][SIDES - 1]);
    if constexpr (CLUSTER) {
      row_up = reinterpret_cast<const float4*>(up_row + buf * kBuf);
      row_dn = reinterpret_cast<const float4*>(dn_row + buf * kBuf);
    }
    const float4* row_src =
        reinterpret_cast<const float4*>(eb[warp + 1 - s][0]);
    float4 up4, dn4, src4;
    auto pick = [](const float4& v, int k) {
      return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    };
    auto from_up = [&](float v, int k) {
      if (k % 4 == 0 || k == CELLS) up4 = row_up[k / 4];
      const float u = __shfl_up_sync(kFull, v, 1);
      return lane == 0 ? pick(up4, k % 4) : u;
    };
    auto from_dn = [&](float v, int k) {
      if (k % 4 == 0 || k == CELLS) dn4 = row_dn[k / 4];
      const float d = __shfl_down_sync(kFull, v, 1);
      return lane == 31 ? pick(dn4, k % 4) : d;
    };
    auto from_src = [&](float v, int k) {
      if (src_row && (k % 4 == 0 || k == CELLS)) src4 = row_src[k / 4];
      const float u = __shfl_sync(kFull, v, src_lane);
      return src_row ? pick(src4, k % 4) : u;
    };

    const float p2m = fmaxf(floorf(p2 / fmaxf(pdv, 1.f)), p1);
    if constexpr (SGM) {
      const float mps = from_src(mp, CELLS);
      const float lim = mps + p2m;
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        float v = C[c] + (fminf(from_src(m1[c], c), lim) - mps);
        if (C[c] >= bad) v = bad;
        P[c] = v;
      }
    } else {
      float mp0, mp1;
      if (BIDIR) {
        mp0 = from_up(mp, CELLS);
        mp1 = from_dn(mp, CELLS);
      } else {
        mp0 = mp;
        mp1 = from_up(mp, CELLS);
      }
      const float lim0 = mp0 + p2m, lim1 = mp1 + p2m;
#pragma unroll
      for (int c = 0; c < CELLS; ++c) {
        float s0, s1;
        if (BIDIR) {
          s0 = from_up(m1[c], c);
          s1 = from_dn(m1[c], c);
        } else {
          s0 = m1[c];
          s1 = from_up(m1[c], c);
        }
        const float va = C[c] + (fminf(s0, lim0) - mp0);
        const float vb = C[c] + (fminf(s1, lim1) - mp1);
        float v = keep ? floorf((va + vb) * 0.5f) : C[c];
        if (C[c] >= bad) v = bad;
        P[c] = v;
      }
    }
    if (active) {
      float* on = out;
#pragma unroll
      for (int c = 0; c < CELLS; ++c, on += L) {
        if (MODE != kFwd)
          atomicAdd(on, P[c]);
        else
          __stcs(on, P[c]);
      }
    }
    out += dout;
  }
  if constexpr (CLUSTER) cg::this_cluster().sync();  // the neighbours' last reads
}

// A cluster of `blocks` blocks a line (MGM modes); a cluster the card
// cannot schedule is refused.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, const MgmArgs& a, int B, int groups,
                           int threads, int blocks, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (blocks > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * blocks, groups);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
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

// One block a line, or (blocks > 1, MGM modes) one cluster a line.
template <int SY, int SX, int MODE>
cudaError_t launch(const MgmArgs& a, int B, int groups, int threads,
                   int blocks, cudaStream_t s) {
  if (blocks == 1) {
    mgm_scan_kernel<SY, SX, MODE, false><<<dim3(B, groups), threads, 0, s>>>(a);
    return cudaGetLastError();
  }
  if constexpr (MODE == kSgm) {
    return cudaErrorInvalidValue;
  } else {
    return launch_cluster(mgm_scan_kernel<SY, SX, MODE, true>, a, B, groups,
                          threads, blocks, s);
  }
}

// The instance of grid (sy, sx): every SY * SX <= kMaxCells, in turn.
template <int SY, int SX>
cudaError_t dispatch(int sy, int sx, int mode, const MgmArgs& a, int B,
                     int groups, int threads, int blocks, cudaStream_t s) {
  if constexpr (SY > kMaxCells) {
    return cudaErrorInvalidValue;
  } else if constexpr (SY * SX > kMaxCells) {
    return dispatch<SY + 1, 1>(sy, sx, mode, a, B, groups, threads, blocks, s);
  } else {
    if (sy != SY || sx != SX)
      return dispatch<SY, SX + 1>(sy, sx, mode, a, B, groups, threads, blocks,
                                  s);
    switch (mode) {
      case kFwd: return launch<SY, SX, kFwd>(a, B, groups, threads, blocks, s);
      case kBidir:
        return launch<SY, SX, kBidir>(a, B, groups, threads, blocks, s);
      case kSgm: return launch<SY, SX, kSgm>(a, B, groups, threads, blocks, s);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// Returns a cudaError_t (0 on success). The caller checks shapes, types and
// contiguity and passes a grid of at most kMaxCells cells, threads a block
// (a multiple of 32, at most kMaxLanes) and blocks a line (1, or for the
// MGM modes up to kMaxBlocks, one cluster a line) with threads * blocks >=
// L. mode 2: scan_bidir, groups 2 (group 1 reverse), B <= 3 directions with
// lane shifts shift0..2 (each of -1, 0, +1), no guards; mode 1: mgm_bidir,
// groups 2 (group 1 reverse); mode 0: mgm_fwd, groups 1. Line (b, g) reads
// cost_g / pd_g / guard_g at offset b * (cost_b, pd_b) and writes out_g at
// b * out_b.
extern "C" int vw_mgm_scan(int mode, const float* cost0, const float* cost1,
                           const float* pd0, const float* pd1,
                           const unsigned char* guard0,
                           const unsigned char* guard1, float* out0,
                           float* out1, int groups, int B, int N, int sy,
                           int sx, int L, long long cost_n, long long cost_b,
                           long long pd_n, long long pd_b, long long out_n,
                           long long out_b, int shift0, int shift1,
                           int shift2, float p1, float p2, float bad,
                           int threads, int blocks, void* stream) {
  if (threads < 32 || threads % 32 != 0 || threads > kMaxLanes ||
      blocks < 1 || blocks > kMaxBlocks || (mode == kSgm && blocks > 1) ||
      (long long)threads * blocks < L)
    return cudaErrorInvalidValue;
  const int shift[3] = {shift0, shift1, shift2};
  if (mode == kSgm) {
    if (B > 3) return cudaErrorInvalidValue;
    for (int i = 0; i < B; ++i)
      if (shift[i] < -1 || shift[i] > 1) return cudaErrorInvalidValue;
  }
  MgmArgs a;
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
  for (int i = 0; i < 3; ++i) a.shift[i] = shift[i];
  a.cost_n = cost_n;
  a.cost_b = cost_b;
  a.pd_n = pd_n;
  a.pd_b = pd_b;
  a.out_n = out_n;
  a.out_b = out_b;
  a.p1 = p1;
  a.p2 = p2;
  a.bad = bad;
  return dispatch<1, 1>(sy, sx, mode, a, B, groups, threads, blocks,
                        static_cast<cudaStream_t>(stream));
}
