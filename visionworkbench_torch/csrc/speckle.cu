// Neighbour-agreement speckle stencil for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (visionworkbench_torch/ops/speckle.py).
//
// Replaces the TPU kernel visionworkbench_tpu/ops/speckle.py:
// speckle_keep_mask (pl.pallas_call at :93, body _make_kernel :47). Input
// is the packed code plane (dx + 8192) << 14 | (dy + 8192), 0 for invalid
// pixels; a pixel keeps iff at least min_match of its (2h+1) x (2v+1)
// edge-replicated neighbours (itself included) agree within t in both
// fields (code >> 14 and code & 0x3FFF, an invalid pixel's fields are 0
// like any other code's). Any H and W, any half windows.
//
// What bounds it on the H100: issuing the per-pair work, (2h+1)(2v+1)
// pairs a pixel (121 at the level-0 11 x 11 window) against 8 bytes of
// device traffic a pixel. The design cuts a pair to five fp32 instructions
// and shares every shared-memory load among several centres:
//   * each block stages its 32 x kTileH tile plus the halo once, with
//     indices clamped to the frame (edge replication), each code unpacked
//     into its two fields as floats (exact: a field has at most 18 bits);
//   * a thread owns a strip of kStrip pixels of one column. Per neighbour
//     column it loads the kStrip + R - 1 staged rows that R window rows
//     reach into registers once, and each centre of the strip reads its R
//     from them (R = 2v + 1 up to kMaxRows, else passes of kMaxRows rows,
//     the last one cut by a test uniform over the block);
//   * a pair is two subtracts, the larger absolute difference (one max),
//     sat(t + 1 - max), which is 1 exactly when both fields agree within t
//     (all operands integers), and an add into the centre's count.
// The count is an integer, exact in any order. The TPU kernel's full-width
// row slabs and pltpu.roll shifts are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kBx = 32;                  // threads a block in x: a column each
constexpr int kBy = 4;                   // threads a block in y
constexpr int kStrip = 8;                // output rows a thread
constexpr int kTileH = kBy * kStrip;     // output rows a block
constexpr int kMaxRows = 11;             // window rows a pass, at most

// R window rows a pass. Shared memory: (kBx + 2 hh) x (kTileH + passes * R
// - 1) staged (hi, lo) field pairs, rows past the window clamped like any
// other row and never counted.
template <int R>
__global__ void __launch_bounds__(kBx * kBy) speckle_kernel(
    const int* __restrict__ code, int H, int W, int hh, int hv, float tp1,
    int min_match, int* __restrict__ keep) {
  extern __shared__ float2 sm[];
  const int passes = (2 * hv + R) / R;     // ceil((2 hv + 1) / R)
  const int sw = kBx + 2 * hh, sh = kTileH + passes * R - 1;
  const int gx0 = blockIdx.x * kBx, gy0 = blockIdx.y * kTileH;
  for (int i = threadIdx.y * kBx + threadIdx.x; i < sw * sh; i += kBx * kBy) {
    const int r = i / sw, c = i - r * sw;
    const int gy = min(max(gy0 - hv + r, 0), H - 1);
    const int gx = min(max(gx0 - hh + c, 0), W - 1);
    const int v = code[(size_t)gy * W + gx];
    sm[i] = make_float2(static_cast<float>(v >> 14), static_cast<float>(v & 0x3FFF));
  }
  __syncthreads();
  // centre p of the strip: tile row ry + p, staged at (ry + p + hv, tx + hh);
  // its window row i, column j: staged at (ry + p + i, tx + j)
  const int tx = threadIdx.x, ry = threadIdx.y * kStrip;
  float chi[kStrip], clo[kStrip], cnt[kStrip];
#pragma unroll
  for (int p = 0; p < kStrip; ++p) {
    const float2 c = sm[(ry + p + hv) * sw + tx + hh];
    chi[p] = c.x;
    clo[p] = c.y;
    cnt[p] = 0.f;
  }
  for (int i0 = 0; i0 <= 2 * hv; i0 += R) {
    const int rows = min(R, 2 * hv + 1 - i0);
    const float2* col = sm + (ry + i0) * sw + tx;
    for (int j = 0; j <= 2 * hh; ++j, ++col) {
      float nhi[kStrip + R - 1], nlo[kStrip + R - 1];
#pragma unroll
      for (int k = 0; k < kStrip + R - 1; ++k) {
        const float2 n = col[k * sw];
        nhi[k] = n.x;
        nlo[k] = n.y;
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        if (i < rows) {
#pragma unroll
          for (int p = 0; p < kStrip; ++p) {
            const float m = fmaxf(fabsf(nhi[p + i] - chi[p]), fabsf(nlo[p + i] - clo[p]));
            cnt[p] += __saturatef(tp1 - m);        // one FADD.SAT
          }
        }
      }
    }
  }
  const int x = gx0 + tx;
  if (x >= W) return;
#pragma unroll
  for (int p = 0; p < kStrip; ++p) {
    const int y = gy0 + ry + p;
    if (y < H) keep[(size_t)y * W + x] = static_cast<int>(cnt[p]) >= min_match ? 1 : 0;
  }
}

template <int R>
cudaError_t launch(const int* code, int H, int W, int hh, int hv, float tp1,
                   int min_match, int* keep, cudaStream_t stream) {
  const int passes = (2 * hv + R) / R;
  const size_t smem = (size_t)(kBx + 2 * hh) * (kTileH + passes * R - 1) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      speckle_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((W + kBx - 1) / kBx, (H + kTileH - 1) / kTileH);
  speckle_kernel<R><<<grid, dim3(kBx, kBy), smem, stream>>>(code, H, W, hh, hv, tp1,
                                                            min_match, keep);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success), or -1 for negative half windows.
// code and keep are (H, W) int32.
extern "C" int vw_speckle(const int* code, int H, int W, int hh, int hv, int t,
                          int min_match, int* keep, void* stream) {
  if (hh < 0 || hv < 0) return -1;
  // A field difference is below 2^18 in magnitude: t past it agrees as
  // 2^18 does, t below 0 never; so t + 1 is exact as a float.
  const int tc = t < -1 ? -1 : t > (1 << 18) ? (1 << 18) : t;
  const float tp1 = static_cast<float>(tc + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * hv + 1 < kMaxRows ? 2 * hv + 1 : kMaxRows) {
    case 1: return launch<1>(code, H, W, hh, hv, tp1, min_match, keep, s);
    case 3: return launch<3>(code, H, W, hh, hv, tp1, min_match, keep, s);
    case 5: return launch<5>(code, H, W, hh, hv, tp1, min_match, keep, s);
    case 7: return launch<7>(code, H, W, hh, hv, tp1, min_match, keep, s);
    case 9: return launch<9>(code, H, W, hh, hv, tp1, min_match, keep, s);
    default: return launch<kMaxRows>(code, H, W, hh, hv, tp1, min_match, keep, s);
  }
}
