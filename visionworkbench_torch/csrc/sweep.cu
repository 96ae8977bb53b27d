// Per-tile block-matching sweep for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (visionworkbench_torch/ops/sweep.py).
// ops/_build.py sets the band kernel's limits (VW_SWEEP_*).
//
// Replaces the TPU kernel visionworkbench_tpu/ops/sweep.py:_pallas_sweep
// (pl.pallas_call at :603, body _make_sweep_kernel :193; census branches
// :353, :379-393) for all
// five costs -- absolute and squared difference, NCC, binary and ternary census
// (every window, 1-2 code words) -- and, as entry points onto the same
// kernel, the first-generation sweeps of ops/cost_volume.py
// (pallas_best_of_search :165, pallas_tiled_search :332). Semantics are
// those of the JAX package's _tiled_search / _tiled_search_patches:
//   * one block per T x T output tile; the tile reads its left block at
//     (ty*T, tx*T) and its right window at (ty*T + off_y, tx*T + off_x),
//     the start clamped into the frame like lax.dynamic_slice;
//   * for each candidate (dx, dy) of the window, in dy-major then dx order,
//     the cost plane is summed over kh x kw: column sums over kh rows (top
//     to bottom), then row sums of those over kw columns (left to right),
//     the order of the plain PyTorch version, so the two agree bit for bit
//     (built with --fmad=false, so no product is fused into a sum);
//   * costs: |l - r|, (l - r)^2, l * r for NCC, or popcount(xor) over the
//     census words (an int32 sum, exact in any order). Census codes come
//     either from the staged crop itself -- pixels quantized to
//     (int)clip(x * 255, 0, 255), neighbours clamped to the crop, as the
//     XLA engine computes them per tile -- or, with codes_in, from code
//     planes (h, w, n_words) the wrapper computed over the whole frames;
//   * NCC scales each window sum by sqrtf(lprec * rprec), lprec = 1 / the
//     left window energy (once per tile pixel), rprec = 1 / the right
//     window energy at the candidate (once per window position), both IEEE
//     quotients; it is a max metric, and a NaN metric (0 * inf on a
//     zero-energy window) counts as greater than any number, so the first
//     NaN wins and the pixel stays valid (the JAX package's one-chunk
//     jnp.max / jnp.argmax);
//   * otherwise best = strict-improvement min (first best wins), worst =
//     max; valid = best != worst; the in-window arg is zeroed where invalid
//     before the tile offset is added (sweep.py:620-630); optionally the
//     best metric is written out (pallas_best_of_search's third output);
//   * with ring = 1 the window carries a +-1 ring, and a second pass
//     recomputes the nine costs at each winner +-1 (in the same order, so
//     the patch holds exactly the sweep's costs) for the parabola fit.
//
// Three kernels; ops/sweep.py:_sweep_variant picks one by cost and shape:
//   * band_sweep_kernel<cost, K>: abs, sq and NCC (every abs/sq/NCC sweep
//     of the main paths);
//   * band_census_kernel<n_words, K>: census and ternary census, codes
//     from the float crops or code planes (every census sweep of the main
//     paths);
//   * sweep_kernel<cost, n_words>: any shape past the band kernels' limits
//     (a kernel past the largest K, a tile not a multiple of kSeg, more
//     threads or shared memory than a block has).
//
// band_sweep_kernel: one block per (tile, band of kBand output rows), so
// even a pyramid's coarse levels launch enough blocks (level 2 of the bench
// frame: 64 instead of 16). Only the band's right rows are staged in shared
// memory; each thread of the column pass owns one of the T + kw - 1
// columns, holds that column's left values in registers for the whole
// sweep, and per candidate loads its right column once (consecutive lanes,
// consecutive words) to form the band's kBand column sums, each over kh
// terms top to bottom. Each thread of the row pass owns kSeg consecutive
// output pixels of one row, reads the kSeg + kw - 1 column sums once and
// forms each window sum over kw left to right: the plain order, so the
// outputs equal sweep_kernel's and the plain version's bit for bit on any
// input. Running sums are not taken for abs/sq: fp32 sums in another
// order differ in their last bits, and the plain version's order is shared
// with ops/box_filter.py, NCC and the patch. The column sums are
// double-buffered (one barrier a candidate); the row threads' lanes span 8
// rows x 4 segments and the buffer's row stride is odd, so their loads do
// not conflict. The patch pass marks, in a bit set, the candidates that
// some pixel of the band needs (its winner +-1) and runs the same two
// passes over those only, each pixel keeping the sums of its own nine: a
// smooth disparity field needs few of the ring window's candidates, a noisy
// one up to all of them. What bounds it: the issue of the exact-order adds
// (kh per column sum, kw per window sum; ~60 instructions per pixel and
// candidate in all, at about half the card's issue rate on the H100), not
// loads or bytes.
//
// NCC on band_sweep_kernel: the column pass forms l * r, the row pass scales
// each window sum by sqrtf(lprec * rprec) and keeps the max (NaN first), as
// sweep_kernel does. Before the sweep the block makes its energies in the
// same order: rprec = 1 / box(r * r) at each of the band's (kBand + sy - 1)
// x (T + sx - 1) right positions, from the staged right rows (column sums
// over kh into the column-sum buffers, then window sums over kw) into one
// shared plane read per candidate; lprec = 1 / box(l * l) once per output
// pixel, the column threads' l * l sums from their registers, the row
// threads keeping their kSeg values in registers. Per pixel and candidate
// NCC adds a product, a multiply and a correctly rounded square root (no
// fast math) to the abs kernel's adds.
//
// band_census_kernel: the same grid, thread map, double buffer and patch
// pass. Census sums are int32 and exact in any order, so both passes take
// running sums: a column thread slides its kh-row sum down the band (add
// the entering row's popcount, subtract the leaving one's, which it keeps
// from its left codes of the band's first rows, held in registers), a row
// thread slides its kw-wide sum across its kSeg pixels; the best is kept
// as an int and cast to float once (at most 64 * 24 * 24 < 2^24, exact).
// A pixel's code is one word: 32 bits, or 64 for two-word variants (word 0
// the low half; one __popcll equals the two words' __popc). The band makes
// its codes once: it stages the quantized crop rows it needs (its own and
// rad more on each side, and rad more columns, edges replicated: clamped to
// the tile's crop, never to the band, so no code needs a clamp), codes its
// left and right rows into shared memory, then reuses the pixel bytes for
// the column sums; with code planes it loads the words. What bounds it on
// the H100 (NVIDIA H100 80GB HBM3, 700.00 W; python3 -m
// visionworkbench_torch.tools.sweep_census_ablation at the census 5x5 R->L
// shape, 0.2947 ms a launch): the column pass (0.117 ms when taken out),
// whose popcounts (2.3 a pixel and candidate, and the popcount pipe does
// 16 a clock an SM) alone need ~0.064 ms; the codes (0.058 ms; one shared
// byte load and compare a sample position), which are half of a coarse
// level (level 4: 0.0118 of 0.0241 ms); the row pass (0.037 ms). Taller
// bands would cut the popcounts and codes a pixel (rows staged over rows
// output), at the cost of registers and of the coarse levels' blocks.
//
// sweep_kernel: one block per T x T tile with the whole left block and
// right window staged; every candidate re-reads the staged planes (about
// 2*kh + kw shared loads per pixel and candidate), which bounds it. Where
// its launch bound or shared memory cap a block below T * T / kPer threads
// (a tile of 128), it runs the tile's pixels in rounds, each with the
// column sums (and NCC's right precisions) of its own rows. The TPU
// kernel's bf16 hi/lo split matmuls, (8, 128) alignment, pltpu.roll and
// SMEM (2, N) offset layout are TPU workarounds and are not carried over;
// nor are its full-frame codes, roll-tree window sums and banded integer
// matmuls for census.

#include <cuda_runtime.h>

namespace {

constexpr int kPer = 16;           // output pixels per thread
constexpr int kMaxPositions = 48;  // census samples (binary 7x7 dense)
constexpr int kTernaryThreshold = 2;

enum { kAbs = 0, kSq = 1, kNcc = 2, kCensus = 3 };

struct Pattern {             // census sample offsets from the centre, bit order
  int n;                     // positions
  int ternary;               // 2 bits a position: >= c - thr, > c + thr
  signed char dc[kMaxPositions], dr[kMaxPositions];
};

struct Args {
  const void* base;          // float frame, or (hb, wb, n_words) code planes
  int hb, wb;
  const void* match;
  int hm, wm;
  const int* offsets;        // (nty, ntx, 2) per-tile (dx, dy)
  int ntx, T, sx, sy, kw, kh, ring, codes_in;
  Pattern pat;
  int* disp;                 // (nty*T, ntx*T, 2)
  unsigned char* valid;      // (nty*T, ntx*T)
  float* patches;            // (9, nty*T, ntx*T) with ring, else null
  float* best;               // (nty*T, ntx*T) or null
};

template <int COST> struct Traits { using E = float; using Acc = float; };
template <> struct Traits<kCensus> { using E = unsigned; using Acc = int; };

// Cost of left element li against right element ri; census codes are NW
// planes of lplane / rplane words.
template <int COST, int NW>
__device__ __forceinline__ typename Traits<COST>::Acc cost_at(
    const typename Traits<COST>::E* L, int li, int lplane,
    const typename Traits<COST>::E* R, int ri, int rplane) {
  if constexpr (COST == kCensus) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) c += __popc(L[w * lplane + li] ^ R[w * rplane + ri]);
    return c;
  } else if constexpr (COST == kNcc) {
    return L[li] * R[ri];
  } else {
    const float d = L[li] - R[ri];
    if constexpr (COST == kAbs) return fabsf(d);
    return d * d;
  }
}

// Window sum of the cost of candidate (ex, ey) at tile pixel (y, x), in the
// sweep's order (column sums first, then across columns).
template <int COST, int NW>
__device__ float window_cost(const typename Traits<COST>::E* L, int lw, int lplane,
                             const typename Traits<COST>::E* R, int rw, int rplane,
                             int y, int x, int ey, int ex, int kw, int kh) {
  using Acc = typename Traits<COST>::Acc;
  Acc s = 0;
  for (int j = 0; j < kw; ++j) {
    Acc col = 0;
    for (int i = 0; i < kh; ++i)
      col += cost_at<COST, NW>(L, (y + i) * lw + x + j, lplane,
                               R, (y + i + ey) * rw + x + j + ex, rplane);
    s += col;
  }
  return static_cast<float>(s);
}

__device__ __forceinline__ unsigned char quantize(float x) {
  return static_cast<unsigned char>(static_cast<int>(fminf(fmaxf(x * 255.f, 0.f), 255.f)));
}

// Census codes of an h x w crop of quantized pixels Q, neighbours clamped
// to the crop, into NW planes of h*w words.
template <int NW>
__device__ void crop_codes(const unsigned char* Q, int h, int w, const Pattern& p,
                           unsigned* out, int tid, int nt) {
  for (int i = tid; i < h * w; i += nt) {
    const int r = i / w, c = i - r * w;
    const int center = Q[i];
    unsigned w0 = 0u, w1 = 0u;
    for (int k = 0; k < p.n; ++k) {
      const int rr = min(max(r + p.dr[k], 0), h - 1);
      const int cc = min(max(c + p.dc[k], 0), w - 1);
      const int v = Q[rr * w + cc];
      if (p.ternary) {
        const int lo = 2 * k, hi = 2 * k + 1;
        if (v >= center - kTernaryThreshold) {
          if (lo < 32) w0 |= 1u << lo; else w1 |= 1u << (lo - 32);
        }
        if (v > center + kTernaryThreshold) {
          if (hi < 32) w0 |= 1u << hi; else w1 |= 1u << (hi - 32);
        }
      } else if (v > center) {
        if (k < 32) w0 |= 1u << k; else w1 |= 1u << (k - 32);
      }
    }
    out[i] = w0;
    if (NW > 1) out[h * w + i] = w1;
  }
}

// Shared memory, in order: NW planes of the left block (lh x lw), NW planes
// of the right window (rh x rw), the column sums of a round's rows (rr x
// lw, rr = min(T, ceil(kPer * nt / T) + 1)), then for NCC the right
// precisions of a round ((rr + sy - 1) x (T + sx - 1)), or for census codes
// from pixels the quantized crops (lh*lw + rh*rw bytes). ops/sweep.py
// sizes it, and lowers the threads (more rounds, fewer rows each) until it
// fits a block.
// At most kSweepMaxThreads threads, two blocks an SM: unbounded, the NCC
// instance took 141 registers, one block of 256 threads an SM, and ran
// config 3's NCC sweep 1.6x slower. A tile past kPer * kSweepMaxThreads
// pixels (128) runs in rounds.
constexpr int kSweepMaxThreads = 256;
template <int COST, int NW>
__global__ void __launch_bounds__(kSweepMaxThreads, 2) sweep_kernel(const Args a) {
  using E = typename Traits<COST>::E;
  using Acc = typename Traits<COST>::Acc;
  constexpr bool kMax = COST == kNcc;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, kw = a.kw, kh = a.kh, sx = a.sx, sy = a.sy, ring = a.ring;
  const int lh = T + kh - 1, lw = T + kw - 1;
  const int sx_e = sx + 2 * ring, sy_e = sy + 2 * ring;
  const int rh = lh + sy_e - 1, rw = lw + sx_e - 1;
  const int lplane = lh * lw, rplane = rh * rw;
  E* L = reinterpret_cast<E*>(smem);
  E* R = L + NW * lplane;
  const int rr = min(T, (kPer * blockDim.x + T - 1) / T + 1);  // rows a round
  Acc* C = reinterpret_cast<Acc*>(R + NW * rplane);
  float* RP = reinterpret_cast<float*>(C + rr * lw);          // NCC only
  unsigned char* Q = reinterpret_cast<unsigned char*>(C + rr * lw);  // census only
  const int pw = T + sx - 1;                                 // RP row (NCC: no ring)

  const int tx = blockIdx.x, ty = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t = ty * a.ntx + tx;
  const int off_x = a.offsets[2 * t], off_y = a.offsets[2 * t + 1];
  const int by0 = ty * T, bx0 = tx * T;
  const int ry0 = min(max(by0 + off_y, 0), a.hm - rh);
  const int rx0 = min(max(bx0 + off_x, 0), a.wm - rw);

  if constexpr (COST == kCensus) {
    if (a.codes_in) {
      const unsigned* B = static_cast<const unsigned*>(a.base);
      const unsigned* M = static_cast<const unsigned*>(a.match);
      for (int i = tid; i < lplane; i += nt) {
        const int r = i / lw, c = i - r * lw;
        const size_t g = ((size_t)(by0 + r) * a.wb + bx0 + c) * NW;
#pragma unroll
        for (int w = 0; w < NW; ++w) L[w * lplane + i] = B[g + w];
      }
      for (int i = tid; i < rplane; i += nt) {
        const int r = i / rw, c = i - r * rw;
        const size_t g = ((size_t)(ry0 + r) * a.wm + rx0 + c) * NW;
#pragma unroll
        for (int w = 0; w < NW; ++w) R[w * rplane + i] = M[g + w];
      }
    } else {
      const float* B = static_cast<const float*>(a.base);
      const float* M = static_cast<const float*>(a.match);
      unsigned char* QL = Q;
      unsigned char* QR = Q + lplane;
      for (int i = tid; i < lplane; i += nt) {
        const int r = i / lw, c = i - r * lw;
        QL[i] = quantize(B[(size_t)(by0 + r) * a.wb + bx0 + c]);
      }
      for (int i = tid; i < rplane; i += nt) {
        const int r = i / rw, c = i - r * rw;
        QR[i] = quantize(M[(size_t)(ry0 + r) * a.wm + rx0 + c]);
      }
      __syncthreads();
      crop_codes<NW>(QL, lh, lw, a.pat, L, tid, nt);
      crop_codes<NW>(QR, rh, rw, a.pat, R, tid, nt);
    }
  } else {
    const float* B = static_cast<const float*>(a.base);
    const float* M = static_cast<const float*>(a.match);
    for (int i = tid; i < lplane; i += nt) {
      const int r = i / lw, c = i - r * lw;
      L[i] = B[(size_t)(by0 + r) * a.wb + bx0 + c];
    }
    for (int i = tid; i < rplane; i += nt) {
      const int r = i / rw, c = i - r * rw;
      R[i] = M[(size_t)(ry0 + r) * a.wm + rx0 + c];
    }
  }
  __syncthreads();

  const int npix = T * T;
  const float inf = __int_as_float(0x7f800000);
  const int w_out = gridDim.x * T;
  const size_t plane = (size_t)gridDim.y * T * w_out;
  // The tile's pixels in rounds of kPer * nt (one round unless the block
  // has fewer than T * T / kPer threads: kSweepMaxThreads caps them, or
  // shared memory); a round's column sums and right precisions cover
  // only the rows of its pixels (r0 .. r1 - 1, at most rr).
  for (int p0 = 0; p0 < npix; p0 += kPer * nt) {
    const int r0 = p0 / T, r1 = min(T, (p0 + kPer * nt + T - 1) / T);
    if constexpr (kMax) {    // NCC: 1 / right window energy at each position
      for (int i = tid; i < (r1 - r0 + sy - 1) * pw; i += nt) {
        const int y = r0 + i / pw, x = i % pw;
        RP[i] = 1.f / window_cost<kNcc, 1>(R, rw, 0, R, rw, 0, y, x, 0, 0, kw, kh);
      }
    }
    float lp[kPer];          // NCC: 1 / left window energy of each pixel
    if constexpr (kMax) {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int p = p0 + tid + q * nt;
        lp[q] = 0.f;
        if (p < npix) {
          const int y = p / T, x = p - y * T;
          lp[q] = 1.f / window_cost<kNcc, 1>(L, lw, 0, L, lw, 0, y, x, 0, 0, kw, kh);
        }
      }
    }
    float best[kPer], worst[kPer];
    int arg[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      best[q] = kMax ? -inf : inf;
      worst[q] = kMax ? inf : -inf;
      arg[q] = 0;
    }

    for (int ey = ring; ey < ring + sy; ++ey) {
      for (int ex = ring; ex < ring + sx; ++ex) {
        for (int i = tid; i < (r1 - r0) * lw; i += nt) {
          const int r = r0 + i / lw, c = i % lw;
          Acc acc = 0;
          for (int k = 0; k < kh; ++k)
            acc += cost_at<COST, NW>(L, (r + k) * lw + c, lplane,
                                     R, (r + k + ey) * rw + c + ex, rplane);
          C[(r - r0) * lw + c] = acc;
        }
        __syncthreads();
        const int cand = (ey - ring) * sx + (ex - ring);
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int p = p0 + tid + q * nt;
          if (p < npix) {
            const int y = p / T, x = p - y * T;
            const Acc* cp = C + (y - r0) * lw + x;
            Acc s = 0;
            for (int j = 0; j < kw; ++j) s += cp[j];
            float m = static_cast<float>(s);
            if constexpr (kMax) {
              m = m * sqrtf(lp[q] * RP[(y + ey - r0) * pw + x + ex]);
              if (m > best[q] || (isnan(m) && !isnan(best[q]))) {
                best[q] = m;
                arg[q] = cand;
              }
              if (isnan(m) || m < worst[q]) worst[q] = m;
            } else {
              if (m < best[q]) {
                best[q] = m;
                arg[q] = cand;
              }
              if (m > worst[q]) worst[q] = m;
            }
          }
        }
        __syncthreads();
      }
    }

    int* A = reinterpret_cast<int*>(C);  // the round's winners: kPer*nt <= rr*lw
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = p0 + tid + q * nt;
      if (p < npix) {
        const int y = p / T, x = p - y * T;
        const size_t o = (size_t)(by0 + y) * w_out + bx0 + x;
        const bool v = best[q] != worst[q];   // true for NaN
        const int ax = arg[q] % sx, ay = arg[q] / sx;
        a.disp[2 * o] = (v ? ax : 0) + off_x;
        a.disp[2 * o + 1] = (v ? ay : 0) + off_y;
        a.valid[o] = v ? 1 : 0;
        if (a.best) a.best[o] = best[q];
        A[p - p0] = arg[q];
      }
    }
    if (ring) {
      // Patch pass: each thread reads back only the winners it wrote above.
      for (int q = 0; q < kPer; ++q) {
        const int p = p0 + tid + q * nt;
        if (p >= npix) break;
        const int y = p / T, x = p - y * T;
        const size_t o = (size_t)(by0 + y) * w_out + bx0 + x;
        const int ax = A[p - p0] % sx, ay = A[p - p0] / sx;
        for (int dy = -1; dy <= 1; ++dy)
          for (int dx = -1; dx <= 1; ++dx)
            a.patches[(size_t)((dy + 1) * 3 + dx + 1) * plane + o] =
                window_cost<COST, NW>(L, lw, lplane, R, rw, rplane, y, x,
                                      ay + 1 + dy, ax + 1 + dx, kw, kh);
      }
    }
    __syncthreads();         // the next round's sums overwrite A and RP
  }
}

template <int COST, int NW>
cudaError_t launch(const Args& a, int nty, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<COST, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  sweep_kernel<COST, NW><<<dim3(a.ntx, nty), threads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ---- band_sweep_kernel: the abs, sq and NCC costs ---------------------------

constexpr int kBand = VW_SWEEP_BAND_ROWS;     // output rows a block
constexpr int kSeg = VW_SWEEP_SEG;            // output pixels a row thread
constexpr int kBandMaxThreads = VW_SWEEP_BAND_MAX_THREADS;
static_assert(kBand % 8 == 0, "row threads span 8 rows a warp");

struct BandArgs {
  const float* base;         // (>= nty*T + kh - 1, wb)
  int wb;
  const float* match;        // (hm, wm)
  int hm, wm;
  const int* offsets;        // (nty, ntx, 2) per-tile (dx, dy)
  int ntx, T, sx, sy, kw, kh, ring;
  int* disp;                 // (nty*T, ntx*T, 2)
  unsigned char* valid;      // (nty*T, ntx*T)
  float* patches;            // (9, nty*T, ntx*T) with ring, else null
  float* best;               // (nty*T, ntx*T) or null
};

// The kBand column sums of the terms d (band rows 0 .. kBand + K - 2), or
// with ABS of their absolute values, over kh rows, each top to bottom,
// stored cs apart from Cc.
template <int K, bool ABS = false>
__device__ __forceinline__ void band_sums(const float (&d)[kBand + K - 1], int kh,
                                          float* Cc, int cs) {
  float acc[kBand];
#pragma unroll
  for (int o = 0; o < kBand; ++o) acc[o] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < kh) {
#pragma unroll
      for (int o = 0; o < kBand; ++o) acc[o] += ABS ? fabsf(d[o + i]) : d[o + i];
    }
  }
#pragma unroll
  for (int o = 0; o < kBand; ++o) Cc[o * cs] = acc[o];
}

// Column pass of one candidate for one column: lv holds the column's left
// values (band rows 0 .. kBand + K - 2), Rc points at the staged right value
// of band row 0 at the candidate, rw apart a row; writes the kBand column
// sums of the cost over kh rows, each top to bottom, cs apart.
template <int COST, int K>
__device__ __forceinline__ void band_columns(const float (&lv)[kBand + K - 1],
                                             const float* Rc, int rw, int kh,
                                             float* Cc, int cs) {
  constexpr int NR = kBand + K - 1;
  float d[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    if constexpr (COST == kNcc) {
      d[r] = lv[r] * Rc[r * rw];
    } else {
      const float v = lv[r] - Rc[r * rw];
      d[r] = COST == kSq ? v * v : v;
    }
  }
  band_sums<K, COST == kAbs>(d, kh, Cc, cs);
}

// Row pass: the kSeg window sums starting at Cr, each over kw column sums
// left to right.
template <int K>
__device__ __forceinline__ void band_windows(const float* Cr, int kw, float (&s)[kSeg]) {
  constexpr int NC = kSeg + K - 1;
  float cw[NC];
#pragma unroll
  for (int m = 0; m < NC; ++m) cw[m] = Cr[m];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) s[q] = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < kw) {
#pragma unroll
      for (int q = 0; q < kSeg; ++q) s[q] += cw[q + j];
    }
  }
}

// Shared memory, in order: the band's right rows ((kBand + K - 1 + sy_e - 1)
// x rw, zero past the window), two buffers of kBand x cs column sums (for
// NCC at least (kBand + sy - 1) x rw floats: they first hold the right
// energies' column sums), the patch pass's bit set over the ring window's
// candidates, then for NCC the right precisions ((kBand + sy - 1) x ps, ps =
// (T + sx - 1) | 1). ops/sweep.py (_band_geometry) sizes it and picks the
// threads: at least T + kw - 1 (column threads) and kBand * T / kSeg (row
// threads). K bounds kw and kh.
template <int COST, int K>
__global__ void __launch_bounds__(kBandMaxThreads) band_sweep_kernel(const BandArgs a) {
  constexpr int NR = kBand + K - 1;
  constexpr bool kMax = COST == kNcc;        // NCC: a max metric, no patch mode
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, kw = a.kw, kh = a.kh, sx = a.sx, sy = a.sy, ring = a.ring;
  const int sx_e = sx + 2 * ring, sy_e = sy + 2 * ring;
  const int lh = T + kh - 1, lw = T + kw - 1;
  const int rh = lh + sy_e - 1, rw = lw + sx_e - 1;
  const int rrows = NR + sy_e - 1;
  const int cs = (T + K - 1) | 1;            // odd: row threads' loads do not conflict
  const int prows = kBand + sy - 1, ps = (T + sx - 1) | 1;   // NCC's right precisions
  const int n_ext = sx_e * sy_e;
  float* R = reinterpret_cast<float*>(smem);
  float* C = R + rrows * rw;
  unsigned* need = reinterpret_cast<unsigned*>(
      C + (kMax ? max(2 * kBand * cs, prows * rw) : 2 * kBand * cs));
  float* RP = reinterpret_cast<float*>(need + (n_ext + 31) / 32);

  const int tx = blockIdx.x, ty = blockIdx.y, y0 = blockIdx.z * kBand;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t = ty * a.ntx + tx;
  const int off_x = a.offsets[2 * t], off_y = a.offsets[2 * t + 1];
  const int by0 = ty * T, bx0 = tx * T;
  const int ry0 = min(max(by0 + off_y, 0), a.hm - rh);
  const int rx0 = min(max(bx0 + off_x, 0), a.wm - rw);

  for (int i = tid; i < rrows * rw; i += nt) {
    const int r = i / rw, c = i - r * rw;
    R[i] = y0 + r < rh ? a.match[(size_t)(ry0 + y0 + r) * a.wm + rx0 + c] : 0.f;
  }
  for (int i = tid; i < (n_ext + 31) / 32; i += nt) need[i] = 0u;
  // column thread tid: its left column, in registers for the whole sweep
  const bool colt = tid < lw;
  float lv[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r)
    lv[r] = colt && y0 + r < lh ? a.base[(size_t)(by0 + y0 + r) * a.wb + bx0 + tid] : 0.f;
  // row thread tid: band row o, pixels x0 .. x0 + kSeg - 1; a warp spans
  // 8 rows x 4 segments
  const int nseg = T / kSeg;
  const int o = (tid & 7) + 8 * ((tid >> 3) / nseg);
  const int x0 = ((tid >> 3) % nseg) * kSeg;
  const bool rowt = tid < kBand * nseg;
  const bool outp = rowt && y0 + o < T;
  __syncthreads();

  float lp[kSeg];                             // NCC: 1 / left window energy
  if constexpr (kMax) {
    // 1 / right window energy at each right position of the band, in the
    // plain order: column sums of r * r over kh (top to bottom) into the
    // column-sum buffers, then window sums over kw (left to right)
    for (int i = tid; i < prows * rw; i += nt) {
      const float* p = R + i;
      float acc = 0.f;
      for (int j = 0; j < kh; ++j) acc += p[j * rw] * p[j * rw];
      C[i] = acc;
    }
    __syncthreads();
    for (int i = tid; i < prows * (T + sx - 1); i += nt) {
      const int r = i / (T + sx - 1), x = i - r * (T + sx - 1);
      const float* p = C + r * rw + x;
      float acc = 0.f;
      for (int j = 0; j < kw; ++j) acc += p[j];
      RP[r * ps + x] = 1.f / acc;
    }
    __syncthreads();
    // 1 / left window energy of each output pixel: the l * l column sums
    // into buffer 1 (the first candidate writes buffer 0)
    if (colt) {
      float d[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r) d[r] = lv[r] * lv[r];
      band_sums<K>(d, kh, C + kBand * cs + tid, cs);
    }
    __syncthreads();
    if (rowt) {
      band_windows<K>(C + kBand * cs + o * cs + x0, kw, lp);
#pragma unroll
      for (int q = 0; q < kSeg; ++q) lp[q] = 1.f / lp[q];
    }
  }

  const float inf = __int_as_float(0x7f800000);
  float best[kSeg], worst[kSeg];
  int arg[kSeg];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    best[q] = kMax ? -inf : inf;
    worst[q] = kMax ? inf : -inf;
    arg[q] = 0;
  }
  int k = 0;                                  // candidates run: buffer k & 1
  for (int ey = ring; ey < ring + sy; ++ey) {
    for (int ex = ring; ex < ring + sx; ++ex, ++k) {
      float* Cb = C + (k & 1) * kBand * cs;
      if (colt) band_columns<COST, K>(lv, R + ey * rw + ex + tid, rw, kh, Cb + tid, cs);
      __syncthreads();
      if (rowt) {
        float s[kSeg];
        band_windows<K>(Cb + o * cs + x0, kw, s);
        const int cand = (ey - ring) * sx + (ex - ring);
        if constexpr (kMax) {
          // NCC (ring 0): a NaN metric counts as greater than any number
          const float* rp = RP + (o + ey) * ps + x0 + ex;
#pragma unroll
          for (int q = 0; q < kSeg; ++q) {
            const float m = s[q] * sqrtf(lp[q] * rp[q]);
            if (m > best[q] || (isnan(m) && !isnan(best[q]))) {
              best[q] = m;
              arg[q] = cand;
            }
            if (isnan(m) || m < worst[q]) worst[q] = m;
          }
        } else {
#pragma unroll
          for (int q = 0; q < kSeg; ++q) {
            if (s[q] < best[q]) {
              best[q] = s[q];
              arg[q] = cand;
            }
            if (s[q] > worst[q]) worst[q] = s[q];
          }
        }
      }
    }
  }

  const int w_out = gridDim.x * T;
  const size_t row0 = (size_t)(by0 + y0 + o) * w_out + bx0 + x0;
  if (outp) {
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      const size_t p = row0 + q;
      const bool v = best[q] != worst[q];    // true for NaN
      const int ax = arg[q] % sx, ay = arg[q] / sx;
      a.disp[2 * p] = (v ? ax : 0) + off_x;
      a.disp[2 * p + 1] = (v ? ay : 0) + off_y;
      a.valid[p] = v ? 1 : 0;
      if (a.best) a.best[p] = best[q];
    }
  }
  if (kMax || !ring) return;                  // uniform over the block
  // Patch pass. The winner's window index (ax, ay) is the ring window's
  // index of its patch's top-left candidate.
  int px[kSeg], py[kSeg];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    py[q] = arg[q] / sx;
    px[q] = arg[q] - py[q] * sx;
    if (outp) {
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          const int c = (py[q] + dy) * sx_e + px[q] + dx;
          atomicOr(&need[c >> 5], 1u << (c & 31));
        }
    }
  }
  __syncthreads();
  const size_t plane = (size_t)gridDim.y * T * w_out;
  for (int ey = 0; ey < sy_e; ++ey) {
    for (int ex = 0; ex < sx_e; ++ex) {
      const int c = ey * sx_e + ex;
      if (!((need[c >> 5] >> (c & 31)) & 1u)) continue;   // uniform
      float* Cb = C + (k & 1) * kBand * cs;
      ++k;
      if (colt) band_columns<COST, K>(lv, R + ey * rw + ex + tid, rw, kh, Cb + tid, cs);
      __syncthreads();
      if (outp) {
        float s[kSeg];
        band_windows<K>(Cb + o * cs + x0, kw, s);
#pragma unroll
        for (int q = 0; q < kSeg; ++q) {
          const unsigned ky = ey - py[q], kx = ex - px[q];
          if (ky < 3u && kx < 3u) a.patches[(size_t)(ky * 3 + kx) * plane + row0 + q] = s[q];
        }
      }
    }
  }
}

template <int COST, int K>
cudaError_t launch_band(const BandArgs& a, int nty, int bands, int threads,
                        size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_sweep_kernel<COST, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  band_sweep_kernel<COST, K><<<dim3(a.ntx, nty, bands), threads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ---- band_census_kernel: census and ternary census --------------------------

// A pixel's census code as one word: 32 bits for one-word variants, 64 for
// two (word 0 the low half, so one __popcll equals __popc of each word).
template <int NW> struct CodeWord { using W = unsigned; };
template <> struct CodeWord<2> { using W = unsigned long long; };

template <int NW>
__device__ __forceinline__ int popc_word(typename CodeWord<NW>::W x) {
  if constexpr (NW == 1) return __popc(x);
  else return __popcll(x);
}

struct CensusBandArgs {
  const void* base;          // float frame (>= nty*T + kh - 1, wb), or code planes
  int wb;
  const void* match;         // float (hm, wm), or (hm, wm, NW) code planes
  int hm, wm;
  const int* offsets;        // (nty, ntx, 2) per-tile (dx, dy)
  int ntx, T, sx, sy, kw, kh, ring, codes_in, rad;
  Pattern pat;
  int* disp;                 // (nty*T, ntx*T, 2)
  unsigned char* valid;      // (nty*T, ntx*T)
  float* patches;            // (9, nty*T, ntx*T) with ring, else null
  float* best;               // (nty*T, ntx*T) or null
};

// Code of the pixel at q of a staged crop whose neighbours lie at q + off[k]
// (the staging replicates the crop's edges, so no neighbour needs a clamp).
template <typename W>
__device__ __forceinline__ W pixel_code(const unsigned char* q, const Pattern& p,
                                        const int* off) {
  const int center = *q;
  W code = 0, bit = 1;
  if (p.ternary) {
#pragma unroll 4
    for (int k = 0; k < p.n; ++k, bit <<= 2) {
      const int v = q[off[k]];
      if (v >= center - kTernaryThreshold) code |= bit;
      if (v > center + kTernaryThreshold) code |= bit << 1;
    }
  } else {
#pragma unroll 8
    for (int k = 0; k < p.n; ++k, bit <<= 1)
      if (q[off[k]] > center) code |= bit;
  }
  return code;
}

// Stages the quantized rows of an h x w crop (origin F, ld a row) that the
// codes of crop rows y0 .. y0 + rows - 1 read: buffer row b holds crop row
// clamp(y0 - rad + b), buffer column j crop column clamp(j - rad), both
// clamped to the crop (never to the band), as the crop's codes replicate
// its edges.
__device__ __forceinline__ void stage_crop(const float* F, size_t ld, int h, int w,
                                           int y0, int rows, int rad,
                                           unsigned char* Q, int tid, int nt) {
  const int pw = w + 2 * rad;
#pragma unroll 4
  for (int i = tid; i < (rows + 2 * rad) * pw; i += nt) {
    const int b = i / pw, j = i - b * pw;
    const int r = min(max(y0 - rad + b, 0), h - 1), c = min(max(j - rad, 0), w - 1);
    Q[i] = quantize(F[r * ld + c]);
  }
}

// Column pass of one candidate for one column: the kBand column sums over
// kh rows as a running sum down the band (add the entering row's term,
// subtract the leaving one's). lt holds the terms of band rows 0 .. kBand -
// 2 (left codes from registers against Rc); rows past them come from the
// staged codes Lc / Rc, lw / rw apart a row.
template <int NW, int K>
__device__ __forceinline__ void census_columns(
    const typename CodeWord<NW>::W (&lv)[kBand - 1], const typename CodeWord<NW>::W* Lc,
    int lw, const typename CodeWord<NW>::W* Rc, int rw, int kh, int* Cc, int cs) {
  int lt[kBand - 1];
#pragma unroll
  for (int o = 0; o < kBand - 1; ++o) lt[o] = popc_word<NW>(lv[o] ^ Rc[o * rw]);
  int acc = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < kh) {
      if (i < kBand - 1) acc += lt[i < kBand - 1 ? i : 0];
      else acc += popc_word<NW>(Lc[i * lw] ^ Rc[i * rw]);
    }
  }
  int out[kBand];            // stored after the loads, which then run ahead
  out[0] = acc;
#pragma unroll
  for (int o = 1; o < kBand; ++o) {
    const int e = o + kh - 1;
    acc += popc_word<NW>(Lc[e * lw] ^ Rc[e * rw]) - lt[o - 1];
    out[o] = acc;
  }
#pragma unroll
  for (int o = 0; o < kBand; ++o) Cc[o * cs] = out[o];
}

// Row pass: the kSeg window sums starting at Cr, the first over kw column
// sums, each next one a step of the running sum.
template <int K>
__device__ __forceinline__ void census_windows(const int* Cr, int kw, int (&s)[kSeg]) {
  int c0[kSeg - 1];
#pragma unroll
  for (int q = 0; q < kSeg - 1; ++q) c0[q] = Cr[q];
  int acc = 0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < kw) acc += j < kSeg - 1 ? c0[j < kSeg - 1 ? j : 0] : Cr[j];
  }
  s[0] = acc;
#pragma unroll
  for (int q = 1; q < kSeg; ++q) {
    acc += Cr[q + kw - 1] - c0[q - 1];
    s[q] = acc;
  }
}

// One block per (tile, band of kBand output rows), as band_sweep_kernel.
// Shared memory, in order: the band's left codes ((kBand + kh - 1) x lw
// words) and right codes ((kBand + kh - 1 + sy_e - 1) x rw), zero for rows
// past the crop; then either what the codes are made from -- the quantized
// crop rows (the band's rows and rad more on each side, and rad more
// columns, edges replicated: stage_crop) and, 4-byte aligned, the
// pattern's neighbour offsets in each staged crop (2 x n_pos ints) -- or,
// once the codes are made, two buffers of kBand x cs column sums and the
// patch pass's bit set. ops/sweep.py (_census_band_geometry) sizes it.
template <int NW, int K>
__global__ void __launch_bounds__(kBandMaxThreads) band_census_kernel(const CensusBandArgs a) {
  using W = typename CodeWord<NW>::W;
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = a.T, kw = a.kw, kh = a.kh, sx = a.sx, sy = a.sy, ring = a.ring;
  const int sx_e = sx + 2 * ring, sy_e = sy + 2 * ring;
  const int lh = T + kh - 1, lw = T + kw - 1;
  const int rh = lh + sy_e - 1, rw = lw + sx_e - 1;
  const int lrows = kBand + kh - 1, rrows = lrows + sy_e - 1;
  const int cs = lw | 1;                     // odd: row threads' loads do not conflict
  W* L = reinterpret_cast<W*>(smem);
  W* R = L + lrows * lw;
  unsigned char* U = reinterpret_cast<unsigned char*>(R + rrows * rw);
  int* C = reinterpret_cast<int*>(U);
  unsigned* need = reinterpret_cast<unsigned*>(C + 2 * kBand * cs);

  const int tx = blockIdx.x, ty = blockIdx.y, y0 = blockIdx.z * kBand;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int t = ty * a.ntx + tx;
  const int off_x = a.offsets[2 * t], off_y = a.offsets[2 * t + 1];
  const int by0 = ty * T, bx0 = tx * T;
  const int ry0 = min(max(by0 + off_y, 0), a.hm - rh);
  const int rx0 = min(max(bx0 + off_x, 0), a.wm - rw);

  if (a.codes_in) {
    const unsigned* B = static_cast<const unsigned*>(a.base);
    const unsigned* M = static_cast<const unsigned*>(a.match);
#pragma unroll 4
    for (int i = tid; i < lrows * lw; i += nt) {
      const int r = i / lw, c = i - r * lw;
      W v = 0;
      if (y0 + r < lh) {
        const size_t g = ((size_t)(by0 + y0 + r) * a.wb + bx0 + c) * NW;
        v = B[g];
        if constexpr (NW == 2) v |= static_cast<W>(B[g + 1]) << 32;
      }
      L[i] = v;
    }
#pragma unroll 4
    for (int i = tid; i < rrows * rw; i += nt) {
      const int r = i / rw, c = i - r * rw;
      W v = 0;
      if (y0 + r < rh) {
        const size_t g = ((size_t)(ry0 + y0 + r) * a.wm + rx0 + c) * NW;
        v = M[g];
        if constexpr (NW == 2) v |= static_cast<W>(M[g + 1]) << 32;
      }
      R[i] = v;
    }
  } else {
    // crop rows q0 .. of each crop, as far as the crop goes: a band's codes
    // clamp their neighbours to the crop, never to the band
    const float* B = static_cast<const float*>(a.base);
    const float* M = static_cast<const float*>(a.match);
    const int rad = a.rad, lpw = lw + 2 * rad, rpw = rw + 2 * rad;
    const int lq = (lrows + 2 * rad) * lpw, rq = (rrows + 2 * rad) * rpw;
    unsigned char* QL = U;
    unsigned char* QR = U + lq;
    int* offL = reinterpret_cast<int*>(U + ((lq + rq + 3) & ~3));
    int* offR = offL + a.pat.n;
    for (int k = tid; k < a.pat.n; k += nt) {
      offL[k] = a.pat.dr[k] * lpw + a.pat.dc[k];
      offR[k] = a.pat.dr[k] * rpw + a.pat.dc[k];
    }
    stage_crop(B + (size_t)by0 * a.wb + bx0, a.wb, lh, lw, y0, lrows, rad, QL, tid, nt);
    stage_crop(M + (size_t)ry0 * a.wm + rx0, a.wm, rh, rw, y0, rrows, rad, QR, tid, nt);
    __syncthreads();
    // the code of band row r, column c: staged at (r + rad, c + rad)
    for (int i = tid; i < lrows * lw; i += nt) {
      const int r = i / lw, c = i - r * lw;
      L[i] = y0 + r < lh ? pixel_code<W>(QL + (r + rad) * lpw + c + rad, a.pat, offL)
                         : W(0);
    }
    for (int i = tid; i < rrows * rw; i += nt) {
      const int r = i / rw, c = i - r * rw;
      R[i] = y0 + r < rh ? pixel_code<W>(QR + (r + rad) * rpw + c + rad, a.pat, offR)
                         : W(0);
    }
  }
  __syncthreads();                           // the pixels are dropped: C reuses them
  const int n_ext = sx_e * sy_e;
  for (int i = tid; i < (n_ext + 31) / 32; i += nt) need[i] = 0u;
  // column thread tid: its left codes of band rows 0 .. kBand - 2
  const bool colt = tid < lw;
  W lv[kBand - 1];
#pragma unroll
  for (int o = 0; o < kBand - 1; ++o) lv[o] = colt ? L[o * lw + tid] : W(0);
  const int nseg = T / kSeg;
  const int o = (tid & 7) + 8 * ((tid >> 3) / nseg);
  const int x0 = ((tid >> 3) % nseg) * kSeg;
  const bool rowt = tid < kBand * nseg;
  const bool outp = rowt && y0 + o < T;
  // census sums are exact int32: best as an int, cast once at the end
  int best[kSeg], worst[kSeg], arg[kSeg];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    best[q] = 0x7fffffff;
    worst[q] = -1;
    arg[q] = 0;
  }
  int k = 0;                                  // candidates run: buffer k & 1
  for (int ey = ring; ey < ring + sy; ++ey) {
    for (int ex = ring; ex < ring + sx; ++ex, ++k) {
      int* Cb = C + (k & 1) * kBand * cs;
      if (colt)
        census_columns<NW, K>(lv, L + tid, lw, R + ey * rw + ex + tid, rw, kh, Cb + tid, cs);
      __syncthreads();
      if (rowt) {
        int s[kSeg];
        census_windows<K>(Cb + o * cs + x0, kw, s);
        const int cand = (ey - ring) * sx + (ex - ring);
#pragma unroll
        for (int q = 0; q < kSeg; ++q) {
          if (s[q] < best[q]) {
            best[q] = s[q];
            arg[q] = cand;
          }
          if (s[q] > worst[q]) worst[q] = s[q];
        }
      }
    }
  }

  const int w_out = gridDim.x * T;
  const size_t row0 = (size_t)(by0 + y0 + o) * w_out + bx0 + x0;
  if (outp) {
#pragma unroll
    for (int q = 0; q < kSeg; ++q) {
      const size_t p = row0 + q;
      const bool v = best[q] != worst[q];
      const int ax = arg[q] % sx, ay = arg[q] / sx;
      a.disp[2 * p] = (v ? ax : 0) + off_x;
      a.disp[2 * p + 1] = (v ? ay : 0) + off_y;
      a.valid[p] = v ? 1 : 0;
      if (a.best) a.best[p] = static_cast<float>(best[q]);
    }
  }
  if (!ring) return;                          // uniform over the block
  // Patch pass, as band_sweep_kernel's: the ring candidates some winner of
  // the band needs, through the same two passes.
  int px[kSeg], py[kSeg];
#pragma unroll
  for (int q = 0; q < kSeg; ++q) {
    py[q] = arg[q] / sx;
    px[q] = arg[q] - py[q] * sx;
    if (outp) {
      for (int dy = 0; dy < 3; ++dy)
        for (int dx = 0; dx < 3; ++dx) {
          const int c = (py[q] + dy) * sx_e + px[q] + dx;
          atomicOr(&need[c >> 5], 1u << (c & 31));
        }
    }
  }
  __syncthreads();
  const size_t plane = (size_t)gridDim.y * T * w_out;
  for (int ey = 0; ey < sy_e; ++ey) {
    for (int ex = 0; ex < sx_e; ++ex) {
      const int c = ey * sx_e + ex;
      if (!((need[c >> 5] >> (c & 31)) & 1u)) continue;   // uniform
      int* Cb = C + (k & 1) * kBand * cs;
      ++k;
      if (colt)
        census_columns<NW, K>(lv, L + tid, lw, R + ey * rw + ex + tid, rw, kh, Cb + tid, cs);
      __syncthreads();
      if (outp) {
        int s[kSeg];
        census_windows<K>(Cb + o * cs + x0, kw, s);
#pragma unroll
        for (int q = 0; q < kSeg; ++q) {
          const unsigned ky = ey - py[q], kx = ex - px[q];
          if (ky < 3u && kx < 3u)
            a.patches[(size_t)(ky * 3 + kx) * plane + row0 + q] = static_cast<float>(s[q]);
        }
      }
    }
  }
}

template <int NW, int K>
cudaError_t launch_census(const CensusBandArgs& a, int nty, int bands, int threads,
                          size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      band_census_kernel<NW, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  band_census_kernel<NW, K><<<dim3(a.ntx, nty, bands), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int vw_sweep_pixels_per_thread() { return kPer; }

// Returns a cudaError_t (0 on success), or -1 for arguments it does not
// take. Shapes are checked by the caller: base (hb, wb) with
// hb >= nty*T + kh - 1 and wb >= ntx*T + kw - 1; match (hm, wm) at least
// one right window; outputs sized (nty*T, ntx*T). cost: 0 abs, 1 sq,
// 2 ncc, 3 census (n_words 1 or 2; positions = n_pos (dc, dr) pairs).
extern "C" int vw_sweep(const void* base, int hb, int wb, const void* match,
                        int hm, int wm, const int* offsets, int nty, int ntx,
                        int T, int sx, int sy, int kw, int kh, int cost,
                        int ring, int n_words, int codes_in,
                        const int* positions, int n_pos, int ternary,
                        int* disp, unsigned char* valid, float* patches,
                        float* best, int threads, long long smem, void* stream) {
  Args a{};
  a.base = base; a.hb = hb; a.wb = wb;
  a.match = match; a.hm = hm; a.wm = wm;
  a.offsets = offsets; a.ntx = ntx; a.T = T; a.sx = sx; a.sy = sy;
  a.kw = kw; a.kh = kh; a.ring = ring; a.codes_in = codes_in;
  a.disp = disp; a.valid = valid; a.patches = patches; a.best = best;
  if (n_pos < 0 || n_pos > kMaxPositions) return -1;
  a.pat.n = n_pos;
  a.pat.ternary = ternary;
  for (int k = 0; k < n_pos; ++k) {
    a.pat.dc[k] = static_cast<signed char>(positions[2 * k]);
    a.pat.dr[k] = static_cast<signed char>(positions[2 * k + 1]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  switch (cost) {
    case kAbs: return launch<kAbs, 1>(a, nty, threads, sm, s);
    case kSq: return launch<kSq, 1>(a, nty, threads, sm, s);
    case kNcc: return launch<kNcc, 1>(a, nty, threads, sm, s);
    case kCensus:
      if (n_words == 1) return launch<kCensus, 1>(a, nty, threads, sm, s);
      if (n_words == 2) return launch<kCensus, 2>(a, nty, threads, sm, s);
      return -1;
    default: return -1;
  }
}

// The abs (cost 0), sq (cost 1) and NCC (cost 2, no ring) sweep on
// band_sweep_kernel<cost, k>, k one of VW_SWEEP_BAND_K (bounds kw and kh):
// bands blocks a tile of threads, smem bytes (ops/sweep.py:_band_geometry).
// Arguments and return as vw_sweep's.
extern "C" int vw_band_sweep(const float* base, int hb, int wb, const float* match,
                             int hm, int wm, const int* offsets, int nty, int ntx,
                             int T, int sx, int sy, int kw, int kh, int cost,
                             int ring, int k, int* disp, unsigned char* valid,
                             float* patches, float* best, int bands, int threads,
                             long long smem, void* stream) {
  if (T % kSeg || kw > k || kh > k || threads > kBandMaxThreads || (cost == kNcc && ring))
    return -1;
  BandArgs a{};
  a.base = base; a.wb = wb;
  a.match = match; a.hm = hm; a.wm = wm;
  a.offsets = offsets; a.ntx = ntx; a.T = T; a.sx = sx; a.sy = sy;
  a.kw = kw; a.kh = kh; a.ring = ring;
  a.disp = disp; a.valid = valid; a.patches = patches; a.best = best;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (k == VW_SWEEP_BAND_K0) {
    if (cost == kAbs) return launch_band<kAbs, VW_SWEEP_BAND_K0>(a, nty, bands, threads, sm, s);
    if (cost == kSq) return launch_band<kSq, VW_SWEEP_BAND_K0>(a, nty, bands, threads, sm, s);
    if (cost == kNcc) return launch_band<kNcc, VW_SWEEP_BAND_K0>(a, nty, bands, threads, sm, s);
  } else if (k == VW_SWEEP_BAND_K1) {
    if (cost == kAbs) return launch_band<kAbs, VW_SWEEP_BAND_K1>(a, nty, bands, threads, sm, s);
    if (cost == kSq) return launch_band<kSq, VW_SWEEP_BAND_K1>(a, nty, bands, threads, sm, s);
    if (cost == kNcc) return launch_band<kNcc, VW_SWEEP_BAND_K1>(a, nty, bands, threads, sm, s);
  }
  return -1;
}

// The census (ternary: 2 bits a position) sweep on band_census_kernel<
// n_words, k>, k one of VW_SWEEP_BAND_K (bounds kw and kh): bands blocks a
// tile of threads, smem bytes (ops/sweep.py:_census_band_geometry).
// Arguments and return as vw_sweep's.
extern "C" int vw_band_census(const void* base, int wb, const void* match, int hm,
                              int wm, const int* offsets, int nty, int ntx, int T,
                              int sx, int sy, int kw, int kh, int ring, int k,
                              int n_words, int codes_in, const int* positions,
                              int n_pos, int ternary, int* disp, unsigned char* valid,
                              float* patches, float* best, int bands, int threads,
                              long long smem, void* stream) {
  if (T % kSeg || kw > k || kh > k || threads > kBandMaxThreads || n_pos < 0 ||
      n_pos > kMaxPositions)
    return -1;
  CensusBandArgs a{};
  a.base = base; a.wb = wb;
  a.match = match; a.hm = hm; a.wm = wm;
  a.offsets = offsets; a.ntx = ntx; a.T = T; a.sx = sx; a.sy = sy;
  a.kw = kw; a.kh = kh; a.ring = ring; a.codes_in = codes_in;
  a.disp = disp; a.valid = valid; a.patches = patches; a.best = best;
  a.pat.n = n_pos;
  a.pat.ternary = ternary;
  a.rad = 0;
  for (int i = 0; i < n_pos; ++i) {
    a.pat.dc[i] = static_cast<signed char>(positions[2 * i]);
    a.pat.dr[i] = static_cast<signed char>(positions[2 * i + 1]);
    const int dr = positions[2 * i + 1] < 0 ? -positions[2 * i + 1] : positions[2 * i + 1];
    if (dr > a.rad) a.rad = dr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (k == VW_SWEEP_BAND_K0) {
    if (n_words == 1) return launch_census<1, VW_SWEEP_BAND_K0>(a, nty, bands, threads, sm, s);
    if (n_words == 2) return launch_census<2, VW_SWEEP_BAND_K0>(a, nty, bands, threads, sm, s);
  } else if (k == VW_SWEEP_BAND_K1) {
    if (n_words == 1) return launch_census<1, VW_SWEEP_BAND_K1>(a, nty, bands, threads, sm, s);
    if (n_words == 2) return launch_census<2, VW_SWEEP_BAND_K1>(a, nty, bands, threads, sm, s);
  }
  return -1;
}

// The most threads a block of sweep_kernel<cost, n_words> can launch with
// (kSweepMaxThreads), a multiple of 32; -1 for a cost it does not take, or
// a negated cudaError_t.
extern "C" int vw_sweep_max_threads(int cost, int n_words) {
  cudaFuncAttributes attr;
  cudaError_t err;
  switch (cost) {
    case kAbs: err = cudaFuncGetAttributes(&attr, sweep_kernel<kAbs, 1>); break;
    case kSq: err = cudaFuncGetAttributes(&attr, sweep_kernel<kSq, 1>); break;
    case kNcc: err = cudaFuncGetAttributes(&attr, sweep_kernel<kNcc, 1>); break;
    case kCensus:
      if (n_words == 1) { err = cudaFuncGetAttributes(&attr, sweep_kernel<kCensus, 1>); break; }
      if (n_words == 2) { err = cudaFuncGetAttributes(&attr, sweep_kernel<kCensus, 2>); break; }
      return -1;
    default: return -1;
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  return attr.maxThreadsPerBlock / 32 * 32;
}
