// SGM / MGM winner-take-all and subpixel step on Hopper (sm_90a), with a
// plain C interface loaded through ctypes (visionworkbench_torch/ops/sgm_wta.py).
//
// Replaces no TPU kernel: the JAX package runs this step as XLA tensor work
// (visionworkbench_tpu/stereo/sgm.py:_volume_argmin_subpixel). On the card
// its plain version (ops/sgm_wta.py:volume_argmin_subpixel_plain) made
// ~25 whole-volume passes for each of the cascade's six iterations and one
// pageable copy of the parabola's matrix, which waited for the stream. This
// kernel is the whole step in one launch, with no host copy.
//
// Per pixel of an (H, W, sy, sx) fp32 accumulated volume, n = sy * sx cells
// (ref create_disparity_view + _subpixel, SGM.cc:1159-1614):
//   * allowed = acc < thr (thr = 8 * bad - 0.5; absent candidates carry
//     8 * bad); the minimum over the allowed cells (3e38 for the others),
//     its multiplicity over all n cells and the first cell that holds it;
//   * where the minimum is not unique, select_best_disparity's cascade:
//     up to five passes along sx, then one along sy, each the masked 3-tap
//     mean of masked_mean3 below; the first iteration whose minimum is
//     unique (else the sixth) gives the winner and the selected volume;
//   * the selected volume's 3x3 neighbourhood of the winner, indices
//     clamped into the grid, a neighbour absent (>= thr) or past the grid
//     marking a bound, onto which the neighbour collapses;
//   * the subpixel mode (none, parabola, linear, poly4, cosine, lc_blend)
//     in the plain version's operations and order (ops/sgm_wta.py).
// Built with --fmad=false, so no product is contracted into an FMA and
// every operation rounds as the plain version's separate tensor ops do:
// the kernel equals the plain version on the card bit for bit (winner,
// offsets). The parabola fits in float64 with the float32-rounded
// pseudoinverse's rows a..e compiled in (kPinv), its nine terms summed in
// index order, its scalar divisors taken as products with their reciprocals
// (kErfX, kErfY), as the plain version computes them.
//
// What bounds it on the H100: bytes. A pixel reads its n cells once and
// writes 8 bytes: at the MGM cell's level 0 (1536^2, 3 x 5) 141.6 MB in and
// 18.9 MB out, 0.048 ms at 3.35 TB/s. The cascade touches only the pixel's
// own cells, so nothing but the volume goes through device memory:
//   * register variant (n <= 32: every SGM / MGM pyramid level), templated
//     on the padded cell count N (4, 8, 16, 32): one thread a pixel holds
//     its N cells in registers, every index static (row ends come from
//     masks built once on the host). A block of kRegThreads pixels stages
//     its pixels' cells, contiguous in device memory, through shared memory
//     with coalesced reads (thread e of the block reads cell e % N of pixel
//     e / N); the thread's row of shared memory (stride N + 1, free of bank
//     conflicts) serves the one sy pass and the 3x3 gather, whose indices
//     are run-time values;
//   * wide variant (n > 32: calc_disparity_sgm's 64 x 8 = 512): a warp a
//     pixel, cells striped over the lanes, the volume's two working copies
//     and the allowed bits in shared memory (or, past the block's shared
//     memory, a global scratch buffer per warp), warp shuffles for the
//     minimum, the count and the first argmin.
// Both variants share masked_mean3 and wta_offset.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRegThreads = 128;     // pixels a block, register variant
constexpr int kWideWarps = 4;        // pixels a block at a time, wide variant
constexpr int kWideBlocks = 2048;    // blocks of the wide variant (grid-stride)
constexpr int kMaxSmem = 232448;     // bytes of shared memory a block may opt into
constexpr int kIters = 6;            // cascade: 5 passes along sx, then 1 along sy

// The modes of ops/sgm_wta.py:_MODES.
enum Mode { kNone = 0, kParabola = 1, kLinear = 2, kPoly4 = 3, kCosine = 4, kLcBlend = 5 };

// The plain version's constants, rounded as PyTorch rounds a Python float
// into a float32 operation (double first, then float).
constexpr float kInf = static_cast<float>(3e38);
constexpr float kPi3 = static_cast<float>(3.141592653589793 / 3.0);
constexpr float kPi23 = static_cast<float>(3.141592653589793 / 2.3);
constexpr float kBlend = static_cast<float>(1.195);

// Rows a..e of the 9-point quadratic fit's pseudoinverse (ref
// ParabolaFit2d, SGMAssist.h:86-94; ops/sgm_wta.py:PINV_A), the
// float32 values exactly, as doubles: 1/6, -1/3, 1/4, -1/4, -1/6, 0.
#define P6 0x1.555556p-3
#define M3 (-0x1.555556p-2)
#define M6 (-0x1.555556p-3)
__constant__ double kPinv[5][9] = {
    {P6, M3, P6, P6, M3, P6, P6, M3, P6},
    {P6, P6, P6, M3, M3, M3, P6, P6, P6},
    {0x1p-2, 0.0, -0x1p-2, 0.0, 0.0, 0.0, -0x1p-2, 0.0, 0x1p-2},
    {M6, 0.0, P6, M6, 0.0, P6, M6, 0.0, P6},
    {M6, M6, M6, 0.0, 0.0, 0.0, P6, P6, P6},
};
#undef P6
#undef M3
#undef M6
// 1 / (0.34574 sqrt 2) and 1 / (0.38944 sqrt 2), as Python computes them.
constexpr double kErfX = 0x1.05c90ce722013p+1;
constexpr double kErfY = 0x1.d0d1cfc8c6d10p+0;

// One select_best_disparity smoothing step of an allowed cell (SGM.cc:
// 1223-1268), in _masked_mean3's order: the cell v plus its neighbours
// along the pass's axis where they exist and are allowed (al, ar; a tap
// left out adds 0, as the plain version's masked taps and zero fill do),
// times the reciprocal of the taps' count (1, 1/2 or 1/3, the IEEE
// quotients), rounded half up. A cell that is not allowed keeps its value.
constexpr float kThird = 1.f / 3.f;
__device__ __forceinline__ float masked_mean3(float v, float vl, float vr, bool al, bool ar) {
  const float s = (v + (al ? vl : 0.f)) + (ar ? vr : 0.f);
  const float inv = al ? (ar ? kThird : 0.5f) : (ar ? 0.5f : 1.f);
  return floorf(s * inv + 0.5f);
}

// compute_subpixel_offset (SGM.cc:1440-1479) in _subpixel_1d's operations:
// three bound-collapsed costs, the all-equal case first, then the bounds.
__device__ float subpixel_1d(float sm1, float s0, float sp1, int mode, bool lb, bool rb) {
  const float ld = sm1 - s0, rd = sp1 - s0;
  if (ld == 0.f && rd == 0.f) return 0.f;
  if (lb) return 0.5f * s0 / (sp1 == 0.f ? 1.f : sp1);
  if (rb) return -0.5f * s0 / (sm1 == 0.f ? 1.f : sm1);
  const bool use_pos = ld < rd;
  const float x = use_pos ? ld / (rd == 0.f ? 1.f : rd) : rd / (ld == 0.f ? 1.f : ld);
  const float linear = 0.5f * x;
  float value;
  if (mode == kLinear) {
    value = linear;
  } else if (mode == kPoly4) {
    value = (x * x * x * x + x) * 0.25f;
  } else if (mode == kCosine) {
    value = 1.f - cosf(x * kPi3);
  } else {
    const float factor = kBlend - cosf(x * kPi23);
    const float cosv = 1.f - cosf(x * kPi3);
    value = cosv * factor + linear * (1.f - factor);
  }
  return (value - 0.5f) * (use_pos ? 1.f : -1.f);
}

// ParabolaFit2d::find_peak (SGMAssist.h:97-135) in _parabola_2d's
// operations, in float64; |denom| < 0.01 keeps the integer disparity.
__device__ float2 parabola_2d(const float (&z)[9]) {
  double v[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    double s = static_cast<double>(z[0]) * kPinv[j][0];
#pragma unroll
    for (int i = 1; i < 9; ++i) s = s + static_cast<double>(z[i]) * kPinv[j][i];
    v[j] = s;
  }
  const double a = v[0], b = v[1], c = v[2], d = v[3], e = v[4];
  const double denom = 4.0 * a * b - c * c;
  if (!(fabs(denom) >= 0.01)) return make_float2(0.f, 0.f);
  double ox = static_cast<float>((c * e - 2.0 * b * d) / denom);
  double oy = static_cast<float>((c * d - 2.0 * a * e) / denom);
  ox = erf(ox * kErfX) / 2.0;
  oy = erf(oy * kErfY) / 2.0;
  const double norm = hypot(ox, oy);
  const double scale = norm >= 0.5 ? norm / 0.5 : 1.0;
  return make_float2(static_cast<float>(ox / scale), static_cast<float>(oy / scale));
}

// The subpixel offset of winner (dx, dy) from its 3x3 neighbourhood z in the
// selected volume (dx fastest, z[4] the winner), indices already clamped.
__device__ float2 wta_offset(float (&z)[9], int dx, int dy, int sx, int sy, float thr,
                             int mode) {
  const bool lb = dx == 0 || z[3] >= thr, rb = dx == sx - 1 || z[5] >= thr;
  const bool tb = dy == 0 || z[1] >= thr, bb = dy == sy - 1 || z[7] >= thr;
  if (lb) { z[0] = z[1]; z[3] = z[4]; z[6] = z[7]; }
  if (rb) { z[2] = z[1]; z[5] = z[4]; z[8] = z[7]; }
  if (tb) { z[0] = z[3]; z[1] = z[4]; z[2] = z[5]; }
  if (bb) { z[6] = z[3]; z[7] = z[4]; z[8] = z[5]; }
  if (mode == kParabola) return parabola_2d(z);
  return make_float2(subpixel_1d(z[3], z[4], z[5], mode, lb, rb),
                     subpixel_1d(z[1], z[4], z[7], mode, tb, bb));
}

// The disparity of a pixel: winner cell `arg` plus its offset, reading the
// selected volume's cells through sel(c).
template <class Sel>
__device__ float2 pixel_result(int arg, int sx, int sy, float thr, int mode, Sel sel) {
  const int dx = arg % sx, dy = arg / sx;
  float2 r = make_float2(static_cast<float>(dx), static_cast<float>(dy));
  if (mode == kNone) return r;
  float z[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int yy = min(max(dy + k / 3 - 1, 0), sy - 1);
    const int xx = min(max(dx + k % 3 - 1, 0), sx - 1);
    z[k] = sel(yy * sx + xx);
  }
  const float2 off = wta_offset(z, dx, dy, sx, sy, thr, mode);
  return make_float2(r.x + off.x, r.y + off.y);
}

// Minimum of the allowed cells (kInf for the others), its multiplicity over
// the n cells and its first cell, over a thread's N registers.
template <int N>
__device__ __forceinline__ void reg_stats(const float (&v)[N], uint32_t am, int n, int& cnt,
                                          int& arg) {
  float mn = kInf;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (c < n) mn = fminf(mn, (am >> c) & 1u ? v[c] : kInf);
  cnt = 0;
  arg = n;
#pragma unroll
  for (int c = N - 1; c >= 0; --c)
    if (c < n && ((am >> c) & 1u ? v[c] : kInf) == mn) {
      ++cnt;
      arg = c;
    }
}

// Register variant: one thread a pixel, n <= N cells. xfirst / xlast mark
// the cells at the start / end of an sx row.
template <int N>
__global__ void __launch_bounds__(kRegThreads) sgm_wta_kernel(
    const float* __restrict__ acc, long long npix, int n, int sx, int sy, float thr, int mode,
    uint32_t xfirst, uint32_t xlast, float2* __restrict__ out) {
  constexpr int S = N + 1;
  __shared__ float sm[kRegThreads * S];
  const long long p0 = static_cast<long long>(blockIdx.x) * kRegThreads;
  const int np = static_cast<int>(min(static_cast<long long>(kRegThreads), npix - p0));
  const float* src = acc + p0 * n;
  for (int e = threadIdx.x; e < kRegThreads * N; e += kRegThreads) {
    const int p = e / N, c = e % N;
    if (c < n && p < np) sm[p * S + c] = src[static_cast<long long>(p) * n + c];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= np) return;
  float* row = sm + threadIdx.x * S;
  float v[N];
  uint32_t am = 0;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    v[c] = c < n ? row[c] : 0.f;
    if (c < n && v[c] < thr) am |= 1u << c;
  }
  int cnt, arg;
  reg_stats<N>(v, am, n, cnt, arg);
  if (cnt > 1) {
    // the cells whose left / right neighbour along sx, and up / down
    // neighbour along sy, exists and is allowed
    const uint32_t xl = ~xfirst & (am << 1), xr = ~xlast & (am >> 1);
    const uint32_t yl = sx < 32 ? am << sx : 0u, yr = sx < 32 ? am >> sx : 0u;
#pragma unroll 1
    for (int k = 1; k <= kIters; ++k) {
      if (k < kIters) {
        // along sx, in place: `prev` keeps the left neighbour's old value
        float prev = 0.f;
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float old = v[c];
          if ((am >> c) & 1u)
            v[c] = masked_mean3(old, prev, v[c + 1 < N ? c + 1 : c], (xl >> c) & 1u,
                                (xr >> c) & 1u);
          prev = old;
        }
      } else {
        // along sy: the neighbours sx cells away, through the thread's row
#pragma unroll
        for (int c = 0; c < N; ++c)
          if (c < n) row[c] = v[c];
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const bool up = (yl >> c) & 1u, dn = (yr >> c) & 1u;
          if ((am >> c) & 1u)
            v[c] = masked_mean3(v[c], up ? row[c - sx] : 0.f, dn ? row[c + sx] : 0.f, up, dn);
        }
      }
      reg_stats<N>(v, am, n, cnt, arg);
      if (cnt <= 1) break;
    }
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (c < n) row[c] = v[c];
  }
  out[p0 + threadIdx.x] = pixel_result(arg, sx, sy, thr, mode, [&](int c) { return row[c]; });
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fminf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool bit(const uint32_t* m, int c) { return (m[c >> 5] >> (c & 31)) & 1u; }

// A warp's minimum, multiplicity and first argmin over the n cells of v.
__device__ void warp_stats(const float* v, const uint32_t* m, int n, int lane, int& cnt,
                           int& arg) {
  float mn = kInf;
  for (int c = lane; c < n; c += 32) mn = fminf(mn, bit(m, c) ? v[c] : kInf);
  mn = warp_min(mn);
  int k = 0, first = n;
  for (int c = lane; c < n; c += 32)
    if ((bit(m, c) ? v[c] : kInf) == mn) {
      ++k;
      first = min(first, c);
    }
  cnt = warp_sum(k);
  arg = warp_min_int(first);
}

// Floats of a wide-variant warp's working set: the volume's two copies
// and the allowed bits, 16-byte aligned.
__host__ __device__ inline long long wide_words(int n) {
  return ((2LL * n + (n + 31) / 32) + 3) / 4 * 4;
}

// Wide variant: one warp a pixel, a grid-stride loop over the pixels. The
// warp's working set is in shared memory, or at ws + its global warp index
// times wide_words(n) where ws is not null.
__global__ void __launch_bounds__(kWideWarps * 32) sgm_wta_wide_kernel(
    const float* __restrict__ acc, long long npix, int n, int sx, int sy, float thr, int mode,
    float* ws, float2* __restrict__ out) {
  extern __shared__ float wsm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long words = wide_words(n);
  float* base = ws != nullptr
                    ? ws + (static_cast<long long>(blockIdx.x) * kWideWarps + warp) * words
                    : wsm + warp * words;
  float* a = base;
  float* b = base + n;
  uint32_t* m = reinterpret_cast<uint32_t*>(base + 2 * n);
  for (long long pix = static_cast<long long>(blockIdx.x) * kWideWarps + warp; pix < npix;
       pix += static_cast<long long>(gridDim.x) * kWideWarps) {
    const float* src = acc + pix * n;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      const float x = c < n ? src[c] : 0.f;
      if (c < n) a[c] = x;
      const uint32_t bits = __ballot_sync(0xffffffffu, c < n && x < thr);
      if (lane == 0) m[c0 >> 5] = bits;
    }
    __syncwarp();
    int cnt, arg;
    warp_stats(a, m, n, lane, cnt, arg);
    for (int k = 1; k <= kIters && cnt > 1; ++k) {
      const int d = k < kIters ? 1 : sx;
      for (int c = lane; c < n; c += 32) {
        const int i = c % sx;
        const bool al = (k < kIters ? i > 0 : c >= sx) && bit(m, c - d);
        const bool ar = (k < kIters ? i < sx - 1 : c + sx < n) && bit(m, c + d);
        b[c] = bit(m, c) ? masked_mean3(a[c], al ? a[c - d] : 0.f, ar ? a[c + d] : 0.f, al, ar)
                         : a[c];
      }
      __syncwarp();
      float* t = a;
      a = b;
      b = t;
      warp_stats(a, m, n, lane, cnt, arg);
    }
    if (lane == 0) out[pix] = pixel_result(arg, sx, sy, thr, mode, [&](int c) { return a[c]; });
    __syncwarp();
    a = base;
    b = base + n;
  }
}

template <int N>
cudaError_t launch_reg(const float* acc, long long npix, int sy, int sx, float thr, int mode,
                       float2* out, cudaStream_t s) {
  const int n = sy * sx;
  uint32_t xfirst = 0, xlast = 0;
  for (int c = 0; c < n; ++c) {
    if (c % sx == 0) xfirst |= 1u << c;
    if (c % sx == sx - 1) xlast |= 1u << c;
  }
  const long long blocks = (npix + kRegThreads - 1) / kRegThreads;
  sgm_wta_kernel<N><<<static_cast<unsigned>(blocks), kRegThreads, 0, s>>>(
      acc, npix, n, sx, sy, thr, mode, xfirst, xlast, out);
  return cudaGetLastError();
}

// Shared memory a wide-variant block needs, 0 where its warps' working sets
// go to the global scratch buffer.
long long wide_smem(int n) {
  const long long bytes = kWideWarps * wide_words(n) * 4;
  return bytes <= kMaxSmem ? bytes : 0;
}

long long wide_grid(long long npix) {
  const long long blocks = (npix + kWideWarps - 1) / kWideWarps;
  return blocks < kWideBlocks ? blocks : kWideBlocks;
}

}  // namespace

// Bytes of global scratch that vw_sgm_wta needs for an (npix, n) volume:
// 0 unless the wide variant's working sets pass a block's shared memory.
extern "C" long long vw_sgm_wta_scratch_bytes(long long npix, int sy, int sx) {
  const int n = sy * sx;
  if (n <= 32 || wide_smem(n) > 0 || npix < 1) return 0;
  return wide_grid(npix) * kWideWarps * wide_words(n) * 4;
}

// Returns a cudaError_t (0 on success). acc is the (npix, sy * sx) fp32
// volume, out the (npix, 2) fp32 disparities (dx, dy); scratch as
// vw_sgm_wta_scratch_bytes says (may be null where it says 0).
extern "C" int vw_sgm_wta(const float* acc, long long npix, int sy, int sx, float thr, int mode,
                          void* scratch, void* out, void* stream) {
  if (sy < 1 || sx < 1 || mode < kNone || mode > kLcBlend || npix < 0)
    return cudaErrorInvalidValue;
  if (npix == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* o = static_cast<float2*>(out);
  const int n = sy * sx;
  if (n <= 4) return launch_reg<4>(acc, npix, sy, sx, thr, mode, o, s);
  if (n <= 8) return launch_reg<8>(acc, npix, sy, sx, thr, mode, o, s);
  if (n <= 16) return launch_reg<16>(acc, npix, sy, sx, thr, mode, o, s);
  if (n <= 32) return launch_reg<32>(acc, npix, sy, sx, thr, mode, o, s);
  const long long smem = wide_smem(n);
  if (smem == 0 && scratch == nullptr) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sgm_wta_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sgm_wta_wide_kernel<<<static_cast<unsigned>(wide_grid(npix)), kWideWarps * 32,
                        static_cast<size_t>(smem), s>>>(
      acc, npix, n, sx, sy, thr, mode, smem == 0 ? static_cast<float*>(scratch) : nullptr, o);
  return cudaGetLastError();
}
