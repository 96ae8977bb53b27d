// SGM/MGM aggregation scans for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (visionworkbench_torch/ops/sgm_scan.py).
//
// Replaces the three TPU kernels of visionworkbench_tpu/ops/sgm_scan.py:
//   * pallas_scan_bidir (pl.pallas_call at :149): mode 0 below, the SGM path
//     recurrence  L = C + min(prior, min3x3(prior) + P1, min_prior + P2')
//     - min_prior  with  P2' = max(floor(P2 / max(|dI|, 1)), P1), over B
//     directions whose carry is lane-shifted by {0, +-1}, forward and
//     reverse, summed over directions and both groups. Mode 0 runs the
//     shapes that the register-carry kernel of csrc/mgm_scan.cu (mode
//     kSgm) does not take (more than 16 disparity cells, such as
//     calc_disparity_sgm's 64x8 search, or longer lines); that kernel runs
//     every scan_bidir of the SGM main path;
//   * pallas_mgm_bidir (:222) and pallas_mgm_fwd (:272): mode 1, the MGM
//     step floor((L(shift0) + L(shift1)) / 2), reset to the local cost where
//     the guard is false; summed over the two groups (bidir) or stored per
//     step and orientation (fwd). Mode 1 runs the shapes that neither the
//     register-carry kernel of csrc/mgm_scan.cu (up to 16 disparity cells
//     over up to 512 lanes) nor the cluster kernel of
//     csrc/mgm_cluster_scan.cu (up to 512 cells, a line over the blocks of
//     one cluster) takes: wider grids, lines longer than a cluster holds,
//     other shift pairs. Those two run every MGM scan of the main paths.
// Every step then forces absent candidates (C >= bad) to exactly bad, and a
// prior lane shifted in from outside the line reads bad. The semantics are
// those of the lax.scan engines of visionworkbench_tpu/stereo/sgm.py
// (_scan_bidir, _mgm_plain_scan, _mgm_sheared_scan).
//
// Parallel and sequential axes: one block per (group, direction) line; its
// threads cover the line's L lanes (several lanes per thread above 1024),
// each lane all sy*sx disparity cells. Only the N steps are sequential. The
// carry (sy, sx, L) is double-buffered, so each step is one __syncthreads:
// step t reads one buffer (lane l - shift of every cell, for the min and the
// 3x3 grid min) and writes the other. The buffers live in shared memory when
// 2 * sy * sx * L * 4 B fits a block's opt-in limit (40 KB at the 512^2
// level 0; above 48 KB through the opt-in attribute), else in the block's
// own slice of a global scratch buffer (a 64x8 search over 256 lanes needs
// 1 MB): one block owns the line either way, and __syncthreads orders its
// global accesses as it does its shared ones. The (N, sy, sx, L) layout
// puts lanes last, so each step's cost loads, output stores and atomics are
// coalesced.
//
// Exactness: every value is an integer-valued fp32 below 2^24 (census costs
// <= 64, bad = 255 + P2, sums of 8 paths), so the fp32 atomicAdd of the
// directions and groups into a zeroed output is exact in any order and the
// kernel equals its plain PyTorch version bit for bit. The division
// P2 / max(|dI|, 1) is an IEEE division (no fast math; --fmad=false).
//
// What bounds it on the H100: per-step latency. The work is tiny (a few
// hundred KB per scan), but the N steps depend on each other and only
// groups x directions blocks run (2 to 8 SMs of 132). Measured with
// chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power limit, a step
// takes ~5.4 us per path-update pass over 10 cells x 512 lanes
// (~9 us for MGM's two), whatever the number of blocks or atomics, and
// staging the next step's inputs with cp.async did not make it faster: the
// time is most likely each lane's chain of dependent shared loads and mins
// at 16 warps per SM.
// csrc/mgm_scan.cu keeps each lane's priors in registers for grids of up to
// 16 cells; csrc/sgm_path_scan.cu spreads a wide SGM grid over a warp and
// csrc/mgm_cluster_scan.cu an MGM line over a thread-block cluster with
// distributed shared memory. The TPU kernel's pltpu.roll lane shifts,
// (N, 1, L) guard layout and VMEM scratch are not carried over.

#include <cuda_runtime.h>

namespace {

struct Args {
  const float* cost[2];
  const float* pd[2];
  const unsigned char* guard[2];  // null in mode 0
  float* out[2];
  float* scratch;  // global carry, 2 * sy * sx * L per block; null: shared
  int B, N, sy, sx, L;
  long long cost_n, cost_b, pd_n, pd_b, out_n, out_b;  // strides, elements
  int reverse1;   // group 1 walks n = N-1-t (cost, pd, guard and out)
  int shift[3];   // mode 0: lane shift of direction b; mode 1: shift[0..1]
  int store;      // 1: store each step; 0: atomicAdd into a zeroed output
  float p1, p2, bad;
};

// Minimum over the cells of the prior at lane src (bad outside the line).
__device__ __forceinline__ float min_prior(const float* P, int cells, int L,
                                           int src, bool ok, float bad) {
  if (!ok) return bad;
  float m = P[src];
  for (int c = 1; c < cells; ++c) m = fminf(m, P[c * L + src]);
  return m;
}

// Path update of cell (y, x) from the prior at lane src.
__device__ __forceinline__ float path_cell(const float* P, int L, int sy,
                                           int sx, int y, int x, int src,
                                           bool ok, float cost, float mp,
                                           float p2m, float p1, float bad) {
  float center = bad, nb = bad;
  if (ok) {
    center = P[(y * sx + x) * L + src];
    nb = center;
    for (int yy = max(y - 1, 0); yy <= min(y + 1, sy - 1); ++yy)
      for (int xx = max(x - 1, 0); xx <= min(x + 1, sx - 1); ++xx)
        nb = fminf(nb, P[(yy * sx + xx) * L + src]);
    // out-of-grid neighbours count as bad, as in the separable form
    if ((sy > 1 && (y == 0 || y == sy - 1)) ||
        (sx > 1 && (x == 0 || x == sx - 1)))
      nb = fminf(nb, bad);
  }
  nb = nb + p1;
  const float best = fminf(fminf(center, nb), mp + p2m);
  return cost + (best - mp);
}

// SCRATCH is a template argument, not a run-time test of a.scratch, so the
// shared-memory instance keeps shared loads and stores: a pointer that may
// point to either space compiles to generic loads and stores.
template <int MODE, bool SCRATCH>
__global__ void line_scan_kernel(Args a) {
  extern __shared__ float sm[];
  const int L = a.L, sy = a.sy, sx = a.sx, cells = sy * sx;
  const int b = blockIdx.x, g = blockIdx.y;
  const bool rev = g == 1 && a.reverse1;
  const float* cost = a.cost[g] + b * a.cost_b;
  const float* pd = a.pd[g] + b * a.pd_b;
  const unsigned char* guard = MODE == 1 ? a.guard[g] + b * a.pd_b : nullptr;
  float* out = a.out[g] + b * a.out_b;
  const float p1 = a.p1, p2 = a.p2, bad = a.bad;
  const int s0 = MODE == 0 ? a.shift[b] : a.shift[0];
  const int s1 = a.shift[1];

  float* carry = SCRATCH
                     ? a.scratch + (long long)(g * gridDim.x + b) * 2 * cells * L
                     : sm;

  for (int i = threadIdx.x; i < cells * L; i += blockDim.x) carry[i] = bad;
  __syncthreads();

  for (int t = 0; t < a.N; ++t) {
    const long long n = rev ? a.N - 1 - t : t;
    const float* P = carry + (t & 1) * cells * L;
    float* Q = carry + ((t + 1) & 1) * cells * L;
    const float* cn = cost + n * a.cost_n;
    float* on = out + n * a.out_n;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const float p2m = fmaxf(floorf(p2 / fmaxf(pd[n * a.pd_n + l], 1.f)), p1);
      const int src0 = l - s0, src1 = l - s1;
      const bool ok0 = src0 >= 0 && src0 < L, ok1 = src1 >= 0 && src1 < L;
      const float mp0 = min_prior(P, cells, L, src0, ok0, bad);
      const float mp1 = MODE == 1 ? min_prior(P, cells, L, src1, ok1, bad) : 0.f;
      const bool keep = MODE == 1 ? guard[n * a.pd_n + l] != 0 : true;
      for (int y = 0; y < sy; ++y) {
        for (int x = 0; x < sx; ++x) {
          const int c = (y * sx + x) * L + l;
          const float C = cn[c];
          float v = path_cell(P, L, sy, sx, y, x, src0, ok0, C, mp0, p2m, p1,
                              bad);
          if (MODE == 1) {
            const float w = path_cell(P, L, sy, sx, y, x, src1, ok1, C, mp1,
                                      p2m, p1, bad);
            v = keep ? floorf((v + w) * 0.5f) : C;
          }
          if (C >= bad) v = bad;
          Q[c] = v;
          if (a.store)
            on[c] = v;
          else
            atomicAdd(on + c, v);
        }
      }
    }
    __syncthreads();
  }
}

template <int MODE, bool SCRATCH>
cudaError_t launch(const Args& a, int groups, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      line_scan_kernel<MODE, SCRATCH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  line_scan_kernel<MODE, SCRATCH>
      <<<dim3(a.B, groups), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). The caller checks shapes, types and
// contiguity, and either sizes smem = 2 * sy * sx * L * 4 bytes with a null
// scratch, or passes smem = 0 and a scratch of groups * B * 2 * sy * sx * L
// floats. mode 0: SGM (scan_bidir), mode 1: MGM (mgm_bidir, mgm_fwd). Group
// g of the (B, groups) grid reads cost_g / pd_g / guard_g and writes out_g.
extern "C" int vw_line_scan(int mode, const float* cost0, const float* cost1,
                            const float* pd0, const float* pd1,
                            const unsigned char* guard0,
                            const unsigned char* guard1, float* out0,
                            float* out1, float* scratch, int groups, int B,
                            int N, int sy, int sx, int L, long long cost_n,
                            long long cost_b,
                            long long pd_n, long long pd_b, long long out_n,
                            long long out_b, int reverse1, int shift0,
                            int shift1, int shift2, int store, float p1,
                            float p2, float bad, int threads, long long smem,
                            void* stream) {
  Args a;
  a.cost[0] = cost0;
  a.cost[1] = cost1;
  a.pd[0] = pd0;
  a.pd[1] = pd1;
  a.guard[0] = guard0;
  a.guard[1] = guard1;
  a.out[0] = out0;
  a.out[1] = out1;
  a.scratch = scratch;
  a.B = B;
  a.N = N;
  a.sy = sy;
  a.sx = sx;
  a.L = L;
  a.cost_n = cost_n;
  a.cost_b = cost_b;
  a.pd_n = pd_n;
  a.pd_b = pd_b;
  a.out_n = out_n;
  a.out_b = out_b;
  a.reverse1 = reverse1;
  a.shift[0] = shift0;
  a.shift[1] = shift1;
  a.shift[2] = shift2;
  a.store = store;
  a.p1 = p1;
  a.p2 = p2;
  a.bad = bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (scratch != nullptr) {
    if (mode == 0) return launch<0, true>(a, groups, threads, sm, s);
    return launch<1, true>(a, groups, threads, sm, s);
  }
  if (mode == 0) return launch<0, false>(a, groups, threads, sm, s);
  return launch<1, false>(a, groups, threads, sm, s);
}
