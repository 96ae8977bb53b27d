// SGM path scan for wide search windows on Hopper (sm_90a): one warp per
// path line, with a plain C interface loaded through ctypes
// (visionworkbench_torch/ops/sgm_scan.py).
//
// Replaces the TPU kernel visionworkbench_tpu/ops/sgm_scan.py:
// pallas_scan_bidir (pl.pallas_call at :149) on the shapes the
// register-carry kernel of csrc/mgm_scan.cu does not take: more than
// VW_MGM_MAX_CELLS disparity cells a lane (calc_disparity_sgm's 64x8
// search: 512), or lines of more than VW_MGM_MAX_LANES lanes, up to
// VW_PATH_MAX_CELLS cells (both limits set by ops/_build.py). For each of
// B <= 3 directions with lane shift s of {0, +1, -1}, forward (group 0,
// step t at line n = t) and reverse (group 1, n = N - 1 - t), a step is
//   L = C + min(prior, min3x3(prior) + P1, min_prior + P2') - min_prior
// with P2' = max(floor(P2 / max(|dI|, 1)), P1) (an IEEE quotient), forced
// to bad where C >= bad; the prior of lane l is lane l - s of the last
// step, bad outside the line; out-of-grid 3x3 neighbours count as bad
// along an axis of size > 1. The output is the sum over the directions and
// both groups, added with fp32 atomics into a zeroed (N, sy, sx, L)
// volume: every term is an integer-valued fp32 below 2^24, so the sum is
// exact in any order and equals scan_bidir_plain bit for bit.
//
// The design. Every path line is its own chain: lane l's carry at step t
// comes only from lane l - s at step t - 1, and a prior shifted in from
// outside the line is all bad, which gives the same step as a fresh start.
// So the chains of a (group, direction) are its lines k, at lane k + s * t
// at step t: L lines for s = 0, L + N - 1 diagonals for s = +-1 (k from
// 1 - N for s = +1). One warp owns one line and keeps its sy * sx cells in
// registers, cell c = j + 32 * i in thread j (i < K, K a template argument
// of 1 to VW_PATH_MAX_CELLS / 32). A step of a line:
//   * min_prior: a min over the thread's K cells, then 5 __shfl_xor_sync;
//   * the separable 3x3 grid min, exact in any order: the warp writes its
//     carry into its own copy of the grid in shared memory, padded by one
//     cell of bad on every side, reads the two y neighbours (skipped when
//     sy = 1), writes that min into a second padded copy and reads the two
//     x neighbours (skipped when sx = 1). Registers cannot be indexed by
//     a run-time sx, so the neighbours come from shared memory; the
//     padding makes the edge rule a read of bad, with no test per cell;
//   * the update, in the plain version's operations.
// A warp whose line is outside [0, L) at a step holds bad and does nothing.
//
// Traffic. cost and out put lanes last, so one line's cells are L * 4 B
// apart: a warp reading its own lane would touch 32 sectors for 128 B. A
// block therefore holds G adjacent lines of one (group, direction) (G a
// power of two, chosen by the wrapper); lines with one shift stay adjacent
// at every step, at lanes k0 + s * t ... k0 + s * t + G - 1. The block
// stages each step's slab (the cells x G lanes of cost, and G |dI|) into
// shared memory with cp.async, double-buffered, so step t + 1's loads run
// under step t's arithmetic; each warp writes its results over its own
// cost column, and after a barrier the block adds the slab into the output
// with the same coalesced pattern (G lanes a cell row, 32 B at G = 8). The
// slab's rows are (G, cells) with a stride chosen so that both the staging
// (G lanes x 32 / G cells a warp) and a warp's own column are free of bank
// conflicts. A block runs only the steps at which one of its lines is in
// the frame. Two __syncthreads a step.
//
// What bounds it on the H100: memory requests, not arithmetic. At
// calc_disparity_sgm's 64x8 search on 256^2 (chip_smoke.py; the parts by
// visionworkbench_torch/tools/path_scan_ablation.py; PERF.md), a step's
// arithmetic is hidden almost entirely under the two streams of 4-byte
// requests: the slab's cp.async (one 32-byte sector per cell row at G = 8)
// and the atomic adds (an x-scan adds every output element 6 times: 2
// groups x 3 shifts; float4 atomics, 16 B a request against a sector's
// 32, were slower at the x-scan). The earlier kernel for these shapes
// (line_scan_kernel<0> of csrc/sgm_scan.cu) ran one block per
// (group, direction), 6 blocks for an x-scan, each lane's 512 cells in
// series, and is kept for wider grids and as the yardstick.

#include <cuda_runtime.h>

namespace {

#if !defined(VW_PATH_MAX_CELLS) || !defined(VW_PATH_MAX_LINES)
#error "needs -DVW_PATH_MAX_CELLS and -DVW_PATH_MAX_LINES (ops/_build.py)"
#endif

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = VW_PATH_MAX_CELLS / 32;  // cells a thread, at most
constexpr int kMaxLines = VW_PATH_MAX_LINES;   // lines (warps) a block
constexpr int kMaxDirections = 3;
constexpr int kMaxSets = 2 * kMaxDirections;  // (group, direction) pairs

// The order of the blocks: first those of the shift-0 sets (every line in
// the frame at every step: the longest), then those of the diagonal sets,
// interleaved (block m of them: set m % n_diag, its block m / n_diag). The
// hardware starts blocks in about the order of their index, and an x-scan
// holds more blocks than the SMs hold at once: set after set, the last
// sets' long diagonal blocks start last (tools/path_scan_ablation.py,
// variant set_order; PERF.md).
struct PathArgs {
  const float* cost;   // (N, sy, sx, L)
  const float* pd[2];  // (N, B, L): group 0 forward, group 1 reverse
  float* out;          // (N, sy, sx, L), zeroed
  int N, sy, sx, L, B;
  int G, lg;                  // lines a block, log2(G)
  int shift[kMaxDirections];  // lane shift of direction b
  int n_flat, n_diag;         // shift-0 sets and diagonal sets
  int nb_flat, nb_diag;       // blocks a set of each kind
  int flat[kMaxSets], diag[kMaxSets];  // their sets e = g * B + b
  int cp, pg;  // slab row stride and padded grid size, in floats
  float p1, p2, bad;
};

// v[i] of a parameter array without a run-time index (which would copy the
// parameters to the stack).
__device__ __forceinline__ int pick(const int (&v)[kMaxSets], int i) {
  int r = v[0];
#pragma unroll
  for (int k = 1; k < kMaxSets; ++k)
    if (i == k) r = v[k];
  return r;
}

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

// Block (of the flat grid) -> (group, direction) e = g * B + b and its
// lines k0 .. k0 + G - 1, G lines a block. Launch bounds: two blocks of
// kMaxLines warps an SM, so at most 128 registers a thread.
template <int K>
__global__ void __launch_bounds__(32 * kMaxLines, 2)
    path_scan_kernel(PathArgs a) {
  extern __shared__ float sm[];
  const int N = a.N, L = a.L, sx = a.sx, G = a.G, cells = a.sy * a.sx;
  const int tid = threadIdx.x, w = tid >> 5, j = tid & 31;
  // The block's set e = g * B + b and its place jb among the set's blocks
  // (the order: PathArgs).
  const int blk = blockIdx.x;
  int e, jb;
  if (blk < a.n_flat * a.nb_flat) {
    e = pick(a.flat, blk / a.nb_flat);
    jb = blk % a.nb_flat;
  } else {
    const int m = blk - a.n_flat * a.nb_flat;
    e = pick(a.diag, m % a.n_diag);
    jb = m / a.n_diag;
  }
  const int grp = e >= a.B, b = e - grp * a.B;
  const int s = b == 0 ? a.shift[0] : b == 1 ? a.shift[1] : a.shift[2];
  const int k0 = (s > 0 ? 1 - N : 0) + jb * G;
  // the steps at which one of the block's lines is inside the frame
  int t_lo = 0, t_hi = N;
  if (s > 0) {
    t_lo = max(0, 1 - k0 - G);
    t_hi = min(N, L - k0);
  } else if (s < 0) {
    t_lo = max(0, k0 - L + 1);
    t_hi = min(N, k0 + G);
  }
  if (t_lo >= t_hi) return;

  const float p1 = a.p1, p2 = a.p2, bad = a.bad;
  const int cp = a.cp, pg = a.pg, w2 = sx + 2;
  // shared memory: slab[2][G][cp], the |dI| of the slab pdb[2][G], then
  // each warp's two padded grids (sy + 2) x (sx + 2)
  float* const slab = sm;
  float* const pdb = sm + 2 * G * cp;
  float* const gp = pdb + 2 * G + w * 2 * pg;  // the carry
  float* const gq = gp + pg;                   // its min over y neighbours
  for (int i = j; i < 2 * pg; i += 32) gp[i] = bad;

  // The thread's cells c = j + 32 i: their place in the padded grid, and
  // the carry (cells past sy * sx hold +inf, so min_prior ignores them).
  int pidx[K];
  float P[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = j + 32 * i;
    const int y = c / sx;
    pidx[i] = (y + 1) * w2 + (c - y * sx) + 1;
    P[i] = c < cells ? bad : __int_as_float(0x7f800000);
  }

  // Staging and output role of thread tid: lane sg of the block's lines,
  // cells sc0 + 32 r.
  // Both walk their cells by a running pointer: 32 cells are 32 * L floats
  // apart (offsets c * L kept for the whole scan spilled registers).
  const int sg = tid & (G - 1), sc0 = tid >> a.lg;
  const long long row_n = (long long)cells * L, pd_n = (long long)a.B * L;
  const long long warp_cells = 32LL * L, first_cell = (long long)sc0 * L;
  const float* const pdp = (grp ? a.pd[1] : a.pd[0]) + b * L;
  const bool rev = grp == 1;
  auto stage = [&](int t, int buf) {
    const long long n = rev ? N - 1 - t : t;
    const int lane = k0 + s * t + sg;
    const bool ok = lane >= 0 && lane < L;
    const float* src = a.cost + n * row_n + first_cell + (ok ? lane : 0);
    float* dst = slab + (buf * G + sg) * cp + sc0;
#pragma unroll
    for (int r = 0; r < K; ++r, src += warp_cells)
      if (sc0 + 32 * r < cells) cp_async4(dst + 32 * r, src, ok ? 4 : 0);
    if (tid < G) {
      const int pl = k0 + s * t + tid;
      const bool pok = pl >= 0 && pl < L;
      cp_async4(pdb + buf * G + tid, pdp + n * pd_n + (pok ? pl : 0),
                pok ? 4 : 0);
    }
    cp_async_commit();
  };

  __syncthreads();  // the grids' bad padding
  stage(t_lo, 0);
  const int k = k0 + w;  // the warp's line
  for (int t = t_lo; t < t_hi; ++t) {
    const int cur = (t - t_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // step t's slab is in; step t - 1's output is added
    if (t + 1 < t_hi) stage(t + 1, cur ^ 1);

    const int lane = k + s * t;
    if (lane >= 0 && lane < L) {  // uniform in the warp
      float* const col = slab + (cur * G + w) * cp;
      const float p2m =
          fmaxf(floorf(p2 / fmaxf(pdb[cur * G + w], 1.f)), p1);
      float mp = P[0];
#pragma unroll
      for (int i = 1; i < K; ++i) mp = fminf(mp, P[i]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mp = fminf(mp, __shfl_xor_sync(kFull, mp, o));
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (j + 32 * i < cells) gp[pidx[i]] = P[i];
      __syncwarp();
      float q[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        q[i] = P[i];
        if (j + 32 * i < cells) {
          if (a.sy > 1)
            q[i] = fminf(fminf(q[i], gp[pidx[i] - w2]), gp[pidx[i] + w2]);
          gq[pidx[i]] = q[i];
        }
      }
      __syncwarp();
      const float lim = mp + p2m;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int c = j + 32 * i;
        if (c < cells) {
          float r = q[i];
          if (sx > 1) r = fminf(fminf(r, gq[pidx[i] - 1]), gq[pidx[i] + 1]);
          const float C = col[c];
          float v = C + (fminf(fminf(P[i], r + p1), lim) - mp);
          if (C >= bad) v = bad;
          P[i] = v;
          col[c] = v;
        }
      }
    }
    __syncthreads();  // every line's step t is in the slab
    {
      const long long n = rev ? N - 1 - t : t;
      const int ol = k0 + s * t + sg;
      if (ol >= 0 && ol < L) {
        float* dst = a.out + n * row_n + first_cell + ol;
        const float* const src = slab + (cur * G + sg) * cp + sc0;
#pragma unroll
        for (int r = 0; r < K; ++r, dst += warp_cells)
          if (sc0 + 32 * r < cells) atomicAdd(dst, src[32 * r]);
      }
    }
  }
}

template <int K>
cudaError_t launch(const PathArgs& a, int blocks, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      path_scan_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  path_scan_kernel<K><<<blocks, 32 * a.G, smem, stream>>>(a);
  return cudaGetLastError();
}

// The instance of K cells a thread: 1, 2, 4, ... kMaxK, in turn.
template <int K>
cudaError_t dispatch(int k, const PathArgs& a, int blocks, size_t smem,
                     cudaStream_t stream) {
  if constexpr (K > kMaxK) {
    return cudaErrorInvalidValue;
  } else {
    if (k != K) return dispatch<2 * K>(k, a, blocks, smem, stream);
    return launch<K>(a, blocks, smem, stream);
  }
}

// The slab's row stride in floats: the cells rounded up to a warp, plus
// 32 / lines, so that a staging warp's G lanes x 32 / G cells fall in 32
// banks.
int slab_stride(int cells, int lines) {
  return (cells + 31) / 32 * 32 + (32 / lines) % 32;
}

// Shared memory (bytes) of a block of `lines` warps over a (sy, sx) grid:
// the double-buffered slab and |dI|, and each warp's two padded grids (as
// ops/sgm_scan.py:_path_scan_smem).
long long smem_bytes(int sy, int sx, int lines) {
  const long long pg = (long long)(sy + 2) * (sx + 2);
  return 4 * (2LL * lines * (slab_stride(sy * sx, lines) + 1) +
              2 * lines * pg);
}

}  // namespace

// Returns a cudaError_t (0 on success). The caller checks shapes, types and
// contiguity, and passes k = the instance's cells a thread (a power of two,
// 32 * k >= sy * sx, at most VW_PATH_MAX_CELLS / 32), lines = lines a block
// (a power of two, at most VW_PATH_MAX_LINES) whose shared memory
// (smem_bytes) fits a block, B <= 3 directions with lane shifts
// shift0..2 (each of -1, 0, +1). cost and out are (N, sy, sx, L), out
// zeroed; pd_f and pd_r (N, B, L).
extern "C" int vw_path_scan(const float* cost, const float* pd_f,
                            const float* pd_r, float* out, int B, int N,
                            int sy, int sx, int L, int shift0, int shift1,
                            int shift2, float p1, float p2, float bad, int k,
                            int lines, void* stream) {
  if (B < 1 || B > kMaxDirections || lines < 1 || lines > kMaxLines ||
      (lines & (lines - 1)) != 0 || 32 * k < sy * sx || N < 1 || L < 1)
    return cudaErrorInvalidValue;
  PathArgs a;
  a.cost = cost;
  a.pd[0] = pd_f;
  a.pd[1] = pd_r;
  a.out = out;
  a.N = N;
  a.sy = sy;
  a.sx = sx;
  a.L = L;
  a.B = B;
  a.G = lines;
  a.lg = 0;
  while ((1 << a.lg) < lines) ++a.lg;
  const int shift[kMaxDirections] = {shift0, shift1, shift2};
  a.n_flat = a.n_diag = 0;
  for (int e = 0; e < kMaxSets; ++e) a.flat[e] = a.diag[e] = 0;
  for (int e = 0; e < 2 * B; ++e) {
    const int s = shift[e % B];
    if (s < -1 || s > 1) return cudaErrorInvalidValue;
    if (s == 0)
      a.flat[a.n_flat++] = e;
    else
      a.diag[a.n_diag++] = e;
  }
  a.nb_flat = (L + lines - 1) / lines;
  a.nb_diag = (L + N - 1 + lines - 1) / lines;
  const int blocks = a.n_flat * a.nb_flat + a.n_diag * a.nb_diag;
  for (int b = 0; b < kMaxDirections; ++b) a.shift[b] = b < B ? shift[b] : 0;
  a.cp = slab_stride(sy * sx, lines);
  a.pg = (sy + 2) * (sx + 2);
  a.p1 = p1;
  a.p2 = p2;
  a.bad = bad;
  const long long smem = smem_bytes(sy, sx, lines);
  if (smem > 232448) return cudaErrorInvalidValue;
  return dispatch<1>(k, a, blocks, (size_t)smem,
                     static_cast<cudaStream_t>(stream));
}
