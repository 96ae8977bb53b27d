// Neighbour-agreement speckle stencil for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (visionworkbench_torch/ops/speckle.py).
//
// Replaces the TPU kernel visionworkbench_tpu/ops/speckle.py:
// speckle_keep_mask (pl.pallas_call at :93, body _make_kernel :47). Input
// is the packed code plane (dx + 8192) << 14 | (dy + 8192), 0 for invalid
// pixels; a pixel keeps iff at least min_match of its (2h+1) x (2v+1)
// edge-replicated neighbours (itself included) agree within t in both
// fields. Any H and W.
//
// What bounds it on the H100: integer ALU work, (2h+1)(2v+1) compares per
// pixel (121 at the level-0 11 x 11 window) against 8 bytes of device
// traffic per pixel. One thread per output pixel; each block stages its
// tile plus the halo once in shared memory, with indices clamped to the
// frame (edge replication), so device memory sees each code about once
// and every window read comes from shared memory. The TPU kernel's
// full-width row slabs and pltpu.roll shifts are not carried over.

#include <cuda_runtime.h>

namespace {

__global__ void speckle_kernel(const int* __restrict__ code, int H, int W,
                               int hh, int hv, int t, int min_match,
                               int* __restrict__ keep) {
  extern __shared__ int sm[];
  const int bx = blockDim.x, by = blockDim.y;
  const int sw = bx + 2 * hh, sh = by + 2 * hv;
  const int x0 = blockIdx.x * bx - hh, y0 = blockIdx.y * by - hv;
  for (int i = threadIdx.y * bx + threadIdx.x; i < sw * sh; i += bx * by) {
    const int r = i / sw, c = i - r * sw;
    const int gy = min(max(y0 + r, 0), H - 1);
    const int gx = min(max(x0 + c, 0), W - 1);
    sm[i] = code[(size_t)gy * W + gx];
  }
  __syncthreads();
  const int x = blockIdx.x * bx + threadIdx.x;
  const int y = blockIdx.y * by + threadIdx.y;
  if (x >= W || y >= H) return;
  const int center = sm[(threadIdx.y + hv) * sw + threadIdx.x + hh];
  const int cdx = center >> 14, cdy = center & 0x3FFF;
  int count = 0;
  for (int i = 0; i <= 2 * hv; ++i) {
    const int* row = sm + (threadIdx.y + i) * sw + threadIdx.x;
    for (int j = 0; j <= 2 * hh; ++j) {
      const int nb = row[j];
      count += (abs(cdx - (nb >> 14)) <= t) & (abs(cdy - (nb & 0x3FFF)) <= t);
    }
  }
  keep[(size_t)y * W + x] = count >= min_match ? 1 : 0;
}

}  // namespace

// Returns a cudaError_t (0 on success). code and keep are (H, W) int32.
extern "C" int vw_speckle(const int* code, int H, int W, int hh, int hv,
                          int t, int min_match, int* keep, int block_x,
                          int block_y, void* stream) {
  const size_t smem = (size_t)(block_x + 2 * hh) * (block_y + 2 * hv) *
                      sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      speckle_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 block(block_x, block_y);
  const dim3 grid((W + block_x - 1) / block_x, (H + block_y - 1) / block_y);
  speckle_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      code, H, W, hh, hv, t, min_match, keep);
  return cudaGetLastError();
}
