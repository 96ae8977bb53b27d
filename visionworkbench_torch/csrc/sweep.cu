// Per-tile block-matching sweep for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (visionworkbench_torch/ops/sweep.py).
//
// Replaces the TPU kernel visionworkbench_tpu/ops/sweep.py:_pallas_sweep
// (pl.pallas_call at :603, body _make_sweep_kernel :193) for the absolute-
// and squared-difference costs. Semantics are those of the JAX package's
// _tiled_search / _tiled_search_patches:
//   * one block per T x T output tile; the tile reads its left block at
//     (ty*T, tx*T) and its right window at (ty*T + off_y, tx*T + off_x),
//     the start clamped into the frame like lax.dynamic_slice;
//   * for each candidate (dx, dy) of the window, in dy-major then dx order,
//     the cost plane |l - r| or (l - r)^2 is summed over kh x kw: column
//     sums over kh rows (top to bottom), then row sums of those over kw
//     columns (left to right), in exact fp32 -- the order of the plain
//     PyTorch version, so the two agree bit for bit (built with
//     --fmad=false, so no product is fused into a sum);
//   * best = strict-improvement min (first best wins), worst = max,
//     valid = best != worst; the in-window arg is zeroed where invalid
//     before the tile offset is added (sweep.py:620-630);
//   * with ring = 1 the window carries a +-1 ring, and a second pass
//     recomputes the nine costs at each winner +-1 (in the same order, so
//     the patch holds exactly the sweep's costs) for the parabola fit.
//
// What bounds it on the H100: shared-memory loads. The left tile and the
// right window are staged once per block in shared memory (about 24 KB +
// 31 KB at the 1024^2 bench's level 0, above the 48 KB static limit, hence
// dynamic shared memory with the opt-in attribute), so device memory sees
// each input about once; every candidate then re-reads the staged planes
// (about 2*kh + kw shared loads per pixel and candidate). Sliding running
// sums would cut that to O(1) per pixel but change the fp32 summation
// order; this first kernel keeps the order exact. The TPU kernel's bf16
// hi/lo split matmuls, (8, 128) alignment, pltpu.roll and SMEM (2, N)
// offset layout are TPU workarounds and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kPer = 16;  // output pixels per thread

template <int COST>
__device__ __forceinline__ float cost_of(float l, float r) {
  const float d = l - r;
  if (COST == 0) return fabsf(d);
  return d * d;
}

// Window sum of the cost of candidate (ex, ey) at tile pixel (y, x), in the
// sweep's order (column sums first, then across columns).
template <int COST>
__device__ float window_cost(const float* L, int lw, const float* R, int rw,
                             int y, int x, int ey, int ex, int kw, int kh) {
  float s = 0.f;
  for (int j = 0; j < kw; ++j) {
    float col = 0.f;
    for (int i = 0; i < kh; ++i)
      col += cost_of<COST>(L[(y + i) * lw + x + j],
                           R[(y + i + ey) * rw + x + j + ex]);
    s += col;
  }
  return s;
}

template <int COST>
__global__ void sweep_kernel(const float* __restrict__ base, int wb,
                             const float* __restrict__ match, int hm, int wm,
                             const int* __restrict__ offsets, int ntx,
                             int T, int sx, int sy, int kw, int kh, int ring,
                             int* __restrict__ disp,
                             unsigned char* __restrict__ valid,
                             float* __restrict__ patches) {
  extern __shared__ float smem[];
  const int lh = T + kh - 1, lw = T + kw - 1;
  const int sx_e = sx + 2 * ring, sy_e = sy + 2 * ring;
  const int rh = lh + sy_e - 1, rw = lw + sx_e - 1;
  float* L = smem;          // lh x lw left block
  float* R = L + lh * lw;   // rh x rw right window
  float* C = R + rh * rw;   // T x lw column sums of one candidate

  const int tx = blockIdx.x, ty = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t = ty * ntx + tx;
  const int off_x = offsets[2 * t], off_y = offsets[2 * t + 1];
  const int by0 = ty * T, bx0 = tx * T;
  const int ry0 = min(max(by0 + off_y, 0), hm - rh);
  const int rx0 = min(max(bx0 + off_x, 0), wm - rw);

  for (int i = tid; i < lh * lw; i += nt) {
    const int r = i / lw, c = i - r * lw;
    L[i] = base[(size_t)(by0 + r) * wb + bx0 + c];
  }
  for (int i = tid; i < rh * rw; i += nt) {
    const int r = i / rw, c = i - r * rw;
    R[i] = match[(size_t)(ry0 + r) * wm + rx0 + c];
  }
  __syncthreads();

  const int npix = T * T;
  float best[kPer], worst[kPer];
  int arg[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    best[q] = __int_as_float(0x7f800000);    // +inf
    worst[q] = __int_as_float(0xff800000);   // -inf
    arg[q] = 0;
  }

  for (int ey = ring; ey < ring + sy; ++ey) {
    for (int ex = ring; ex < ring + sx; ++ex) {
      for (int i = tid; i < T * lw; i += nt) {
        const int r = i / lw, c = i - r * lw;
        const float* lp = L + r * lw + c;
        const float* rp = R + (r + ey) * rw + c + ex;
        float acc = 0.f;
        for (int k = 0; k < kh; ++k) acc += cost_of<COST>(lp[k * lw], rp[k * rw]);
        C[i] = acc;
      }
      __syncthreads();
      const int cand = (ey - ring) * sx + (ex - ring);
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int p = tid + q * nt;
        if (p < npix) {
          const int y = p / T, x = p - y * T;
          const float* cp = C + y * lw + x;
          float s = 0.f;
          for (int j = 0; j < kw; ++j) s += cp[j];
          if (s < best[q]) {
            best[q] = s;
            arg[q] = cand;
          }
          if (s > worst[q]) worst[q] = s;
        }
      }
      __syncthreads();
    }
  }

  const int w_out = gridDim.x * T;
  int* A = reinterpret_cast<int*>(C);  // each thread's winners, T*T <= T*lw
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = tid + q * nt;
    if (p < npix) {
      const int y = p / T, x = p - y * T;
      const size_t o = (size_t)(by0 + y) * w_out + bx0 + x;
      const bool v = best[q] != worst[q];
      const int ax = arg[q] % sx, ay = arg[q] / sx;
      disp[2 * o] = (v ? ax : 0) + off_x;
      disp[2 * o + 1] = (v ? ay : 0) + off_y;
      valid[o] = v ? 1 : 0;
      A[p] = arg[q];
    }
  }
  if (!ring) return;
  // Patch pass: each thread reads back only the winners it wrote above.
  const size_t plane = (size_t)gridDim.y * T * w_out;
  for (int p = tid; p < npix; p += nt) {
    const int y = p / T, x = p - y * T;
    const size_t o = (size_t)(by0 + y) * w_out + bx0 + x;
    const int ax = A[p] % sx, ay = A[p] / sx;
    for (int dy = -1; dy <= 1; ++dy)
      for (int dx = -1; dx <= 1; ++dx)
        patches[(size_t)((dy + 1) * 3 + dx + 1) * plane + o] =
            window_cost<COST>(L, lw, R, rw, y, x, ay + 1 + dy, ax + 1 + dx,
                              kw, kh);
  }
}

template <int COST>
cudaError_t launch(const float* base, int wb, const float* match, int hm,
                   int wm, const int* offsets, int nty, int ntx, int T,
                   int sx, int sy, int kw, int kh, int ring, int* disp,
                   unsigned char* valid, float* patches, int threads,
                   size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<COST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_kernel<COST><<<dim3(ntx, nty), threads, smem, stream>>>(
      base, wb, match, hm, wm, offsets, ntx, T, sx, sy, kw, kh, ring, disp,
      valid, patches);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vw_sweep_pixels_per_thread() { return kPer; }

// Returns a cudaError_t (0 on success). Shapes are checked by the caller:
// base (hb, wb) with hb >= nty*T + kh - 1 and wb >= ntx*T + kw - 1; match
// (hm, wm) at least one right window; outputs sized (nty*T, ntx*T).
extern "C" int vw_sweep(const float* base, int wb, const float* match,
                        int hm, int wm, const int* offsets, int nty, int ntx,
                        int T, int sx, int sy, int kw, int kh, int cost,
                        int ring, int* disp, unsigned char* valid,
                        float* patches, int threads, long long smem,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cost == 0)
    return launch<0>(base, wb, match, hm, wm, offsets, nty, ntx, T, sx, sy,
                     kw, kh, ring, disp, valid, patches, threads,
                     (size_t)smem, s);
  return launch<1>(base, wb, match, hm, wm, offsets, nty, ntx, T, sx, sy, kw,
                   kh, ring, disp, valid, patches, threads, (size_t)smem, s);
}
