// The separable Gaussian blur for Hopper (sm_90a): out[p] = T_h @ X[p] @ T_w
// for every plane p of a (P, H, W) float32 stack, in one launch, the
// intermediate T_h @ X[p] kept in shared memory.
//
// Replaces the Pallas TPU kernel blurred_gan_tpu/ops/blur_pallas.py
// (_blur_plane_kernel, launched by _pallas_impl). Two entry points:
//
// sigma mode (blur_sigma_f32), the main path. T is the banded Gaussian of
// ops/blur.py's blur_matrix, T[i, j] = tap(j - i), and the kernel takes sigma
// itself: a pointer to a float32 on the device (nothing reads it back to the
// host, so a CUDA graph replays with a new sigma) and the policy resolution
// max(h, w). Each block derives the policy from sigma in float32, as
// effective_blur_params does, and builds the 2 * half + 1 taps in shared
// memory, normalised by their sum as masked_gaussian_taps does; both axes use
// that one tap vector. It reads no T and scans nothing. T is exactly symmetric
// (tap(d) is a function of d * d), so the backward is this launch again.
//
// T mode (blur_planes_f32): arbitrary T_h (H x H) and T_w (W x W), the
// counterpart of the primitive blur_planes_p. The autograd transpose passes
// T_h^T, T_w^T; a sigma that needs its gradient takes this route.
//
// What bounds sigma mode. An output costs 2 * (2 * half + 1) FMAs for 8 bytes
// read and written: at 128^2 and sigma = 5 (31 taps) ~15.5 FLOP per byte, at
// sigma = 2.5 (17 taps) ~8.5, under the ~20 FLOP per byte ridge of the card's
// float32 CUDA cores (67 TFLOP/s over 3.35 TB/s). So the kernel is bound by
// bytes at the path's sigma, and its design is about memory and latency. No
// tensor cores: TF32 would lose the float32 sums, and a 3xTF32 split would
// add passes to a kernel that waits on memory.
//
// Sigma mode's design. At these sizes a launch is one wave of blocks that all
// start together, so what a block waits on in sequence is the kernel's time;
// the design shortens that chain. A block of 256 threads owns kR output rows
// of one plane (a plane's row tiles adjacent in the grid, so the halo rows
// they share come from L2).
//   set-up:  before sigma has arrived, thread 0 copies the tile's rows and
//            kHalo rows either side (a window no sigma < 5.5 outgrows: the
//            training runs' range) into the ring with the copy engine,
//            one bulk copy per half onto its own mbarrier. Meanwhile warps
//            1-7 build the taps: every warp sums the band in the same order
//            (no barrier), and warps 1-7 fill two small tables, tap(d) and
//            tap(e - m) by offset, over the band only.
//   phase 1: Y = T_h[rows, :] @ X. A thread owns kM = 4 rows x 4 columns of Y
//            in registers and waits on the mbarrier of each half its rows
//            read, never on another thread. Per input row it reads one float4
//            of X and the 4 taps tap(a - i0 - m) as one load, for 16 FMAs.
//   phase 2: out = Y @ T_w from Y in shared memory. A thread owns the same
//            4 rows x 4 columns; per 4 input columns it reads 4 float4 of Y
//            and 8 taps (two float4, one address for the warp), for 64 FMAs.
//            Where a row's column quads lie within one warp (a width of 4,
//            8, ..., 128 columns), each warp reads only the Y it wrote, so it
//            goes on to phase 2 without waiting for the others; else Y lies
//            on the read-out ring after a block barrier. Lanes own adjacent
//            columns, so the stores are coalesced float4.
// A wider band streams through the ring in chunks of half the ring, one bulk
// copy each, a slot refilled once the block has read it; columns past one pass
// (128 at 32-row tiles, 256 at 16-row tiles) run in further passes, each
// copying only its columns row by row. Phase 1 clamps its rows to the plane
// and phase 2 reads columns outside it as 0; offsets past the band read taps
// that are exactly 0. Each sum is float32 fmaf in ascending k, every added
// term an exact zero, so the result is the dense sum (parity with the
// reference's Precision.HIGHEST). Where w % 4 != 0 or the planes are not
// 16-byte aligned, every thread copies its share of a chunk instead and the
// block waits at a barrier.
//
// T mode's design (skip the zeros, with ranges read from T itself on the device).
// A block owns one plane and a tile of kRows output rows; the grid is
// (row tiles, planes).
//   phase 1: Y = T_h[rows, :] @ X[p]. The block first finds the first and last
//            non-zero column of its rows of T_h (a block-wide min/max), then
//            stages only that range of T_h and of X's rows through shared
//            memory, in chunks of kK. Y stays in shared memory, as on the TPU.
//   phase 2: out[p][rows, :] = Y @ T_w. Each warp owns kWarpCols output
//            columns, finds the first and last non-zero row of T_w over those
//            columns (a warp-wide min/max), and runs k over that range only,
//            staging its T_w rows in its own slice of shared memory.
// Ranges are rounded out to multiples of 4, so the inner loop runs in steps of
// 4. An empty range writes zeros. The products are plain float32 fmaf in
// ascending k with no split of k, so the skipped terms are exact zeros and the
// result equals the dense sum. Every block reads all of its T_h rows and all
// of T_w to find its ranges: where h and w are multiples of 4 and the operands
// 16-byte aligned (the float4 path, kVec), each thread of a block issues its
// T_h loads as one batch of float4, and each warp scans its columns of T_w as
// float4 too. Each thread holds an 8 x 4 tile of outputs in registers. With
// kK = 16 a block needs ~29 KB of shared memory at 128^2 and at most 80
// registers a thread, so 6 blocks fit an SM.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// ============================================================================
// T mode: arbitrary T_h, T_w
// ============================================================================

constexpr int kThreads = 128;                  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                      // output rows per block (8 per thread)
constexpr int kRowsPad = 36;                   // k-major row stride, float4-aligned
constexpr int kWarpCols = 32;                  // output columns per warp (4 per thread)
constexpr int kCols = kWarps * kWarpCols;      // output columns per pass
constexpr int kK = 16;                         // depth of one staged chunk
constexpr int kMinBlocks = 6;                  // blocks per SM the registers must allow

// Shared memory floats: Y (w_pad x kRowsPad), the T_h chunk, the B chunk.
size_t smem_floats(int w) {
  const size_t w_pad = (size_t)(w + kCols - 1) / kCols * kCols;
  return w_pad * kRowsPad + (size_t)kK * kRowsPad + (size_t)kK * kCols;
}

// acc[i][j] += sum_{kk < n} a[kk][row0 + i] * b[kk][col0 + j], a k-major with
// row stride kRowsPad, b with row stride ldb; n is a multiple of 4.
__device__ __forceinline__ void mac(float (&acc)[8][4], const float* __restrict__ a,
                                    const float* __restrict__ b, int ldb, int n,
                                    int row0, int col0) {
  for (int kk = 0; kk < n; kk += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* ak = a + (kk + u) * kRowsPad + row0;
      const float4 a0 = *reinterpret_cast<const float4*>(ak);
      const float4 a1 = *reinterpret_cast<const float4*>(ak + 4);
      const float4 bv = *reinterpret_cast<const float4*>(b + (kk + u) * ldb + col0);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bw[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
      }
    }
  }
}

// bs[kk][j] = X[k0 + kk][c0 + j] for kk < kK, j < kCols; zero outside h x w.
// kVec: w % 4 == 0 and X 16-byte aligned, so one float4 per load.
template <bool kVec>
__device__ __forceinline__ void stage_x(float* __restrict__ bs, const float* __restrict__ xp,
                                        int h, int w, int k0, int c0) {
  if (kVec) {
    constexpr int kQuads = kCols / 4;
    for (int idx = threadIdx.x; idx < kK * kQuads; idx += kThreads) {
      const int kk = idx / kQuads, j = idx % kQuads * 4;
      const int k = k0 + kk, c = c0 + j;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < h && c < w) v = __ldg(reinterpret_cast<const float4*>(xp + (size_t)k * w + c));
      *reinterpret_cast<float4*>(bs + kk * kCols + j) = v;
    }
  } else {
    for (int idx = threadIdx.x; idx < kK * kCols; idx += kThreads) {
      const int kk = idx / kCols, j = idx % kCols;
      const int k = k0 + kk, c = c0 + j;
      bs[idx] = (k < h && c < w) ? __ldg(xp + (size_t)k * w + c) : 0.f;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blur_planes_kernel(const float* __restrict__ x, const float* __restrict__ th,
                   const float* __restrict__ tw, float* __restrict__ out,
                   int h, int w) {
  extern __shared__ __align__(16) float smem[];
  const int w_pad = (w + kCols - 1) / kCols * kCols;
  float* ys = smem;                       // [w_pad][kRowsPad]  Y, k-major
  float* as = ys + w_pad * kRowsPad;      // [kK][kRowsPad]     T_h chunk, k-major
  float* bs = as + kK * kRowsPad;         // [kK][kCols]        X chunk (phase 1),
                                          // [kWarps][kK][kWarpCols] T_w (phase 2)
  __shared__ int range_lo[kWarps], range_hi[kWarps];

  const int p = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, h - r0);
  const float* xp = x + (size_t)p * h * w;
  float* op = out + (size_t)p * h * w;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (lane >> 3) * 8;       // this thread's 8 rows of the tile
  const int col0 = (lane & 7) * 4;        // its 4 columns of the warp's 32

  // ---- range of phase 1: non-zero columns of T_h[r0 : r0 + rows, :] ----
  int lo = INT_MAX, hi = -1;
  if (kVec) {
    // Quad q of each row: the range is rounded out to 4, so only whether the
    // quad holds a non-zero matters. One batch of kRows / 4 float4 loads.
    for (int q = lane; q < h / 4; q += 32) {
      unsigned bits = 0;
#pragma unroll
      for (int i = warp; i < kRows; i += kWarps) {
        if (i < rows) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(th + (size_t)(r0 + i) * h) + q);
          bits |= __float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
                  __float_as_uint(v.w);
        }
      }
      if (bits << 1) {  // some bit other than a sign bit: a non-zero
        lo = min(lo, 4 * q);
        hi = max(hi, 4 * q + 3);
      }
    }
  } else {
    for (int k = threadIdx.x; k < h; k += kThreads) {
      bool nz = false;  // any of the tile's rows non-zero at column k
#pragma unroll 8
      for (int i = 0; i < kRows; ++i) nz |= i < rows && __ldg(th + (size_t)(r0 + i) * h + k) != 0.f;
      if (nz) {
        lo = min(lo, k);
        hi = max(hi, k);
      }
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    range_lo[warp] = lo;
    range_hi[warp] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    lo = min(lo, range_lo[i]);
    hi = max(hi, range_hi[i]);
  }
  if (hi < 0) {  // these rows of T_h are all zero, so are these rows of out
    for (int idx = threadIdx.x; idx < rows * w; idx += kThreads) op[(size_t)r0 * w + idx] = 0.f;
    return;
  }
  const int k_begin = lo & ~3, k_end = (hi + 4) & ~3;  // <= h rounded up to 4

  // ---- phase 1: Y[:, c] = T_h[r0 : r0 + kRows, k_begin : k_end] @ X[p][k_begin : k_end, c] ----
  for (int c0 = 0; c0 < w; c0 += kCols) {
    float acc[8][4] = {};
    for (int k0 = k_begin; k0 < k_end; k0 += kK) {
      __syncthreads();  // the previous chunk has been consumed
      for (int idx = threadIdx.x; idx < kRows * kK; idx += kThreads) {
        const int i = idx / kK, kk = idx % kK;  // coalesced along T_h's rows
        const int r = r0 + i, k = k0 + kk;
        as[kk * kRowsPad + i] = (r < h && k < h) ? __ldg(th + (size_t)r * h + k) : 0.f;
      }
      stage_x<kVec>(bs, xp, h, w, k0, c0);
      __syncthreads();
      mac(acc, as, bs, kCols, min(kK, k_end - k0), row0, warp * kWarpCols + col0);
    }
    // Columns c >= w come out 0 (their X entries were 0): phase 2 relies on it.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* y = ys + (size_t)(c0 + warp * kWarpCols + col0 + j) * kRowsPad + row0;
      *reinterpret_cast<float4*>(y) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(y + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }
  __syncthreads();  // Y is complete; the staging buffers are free

  // ---- phase 2: out[p][rows, cw : cw + 32] = Y[:, range] @ T_w[range, cw : cw + 32] ----
  float* ws = bs + warp * kK * kWarpCols;  // this warp's T_w chunk
  for (int cw = warp * kWarpCols; cw < w; cw += kCols) {
    const int c = cw + lane;  // the column this lane scans and stages (scalar)
    const int q = cw + col0;  // the 4 columns it scans and stages (float4)
    lo = INT_MAX;
    hi = -1;
    if (kVec) {
      if (q < w) {
#pragma unroll 8
        for (int k = lane >> 3; k < w; k += 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(tw + (size_t)k * w + q));
          // Any of the 4 non-zero: some bit other than a sign bit is set.
          if (((__float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z) |
                __float_as_uint(v.w)) << 1) != 0u) {
            lo = min(lo, k);
            hi = max(hi, k);
          }
        }
      }
    } else if (c < w) {
#pragma unroll 16
      for (int k = 0; k < w; ++k) {
        if (__ldg(tw + (size_t)k * w + c) != 0.f) {
          lo = min(lo, k);
          hi = max(hi, k);
        }
      }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    float acc[8][4] = {};
    const int k_stop = (hi + 4) & ~3;  // 0 for an empty range: acc stays 0
    for (int k0 = lo & ~3; k0 < k_stop; k0 += kK) {
      const int n = min(kK, k_stop - k0);
      __syncwarp();  // the previous chunk has been consumed
      if (kVec) {
#pragma unroll
        for (int i = 0; i < kK / 4; ++i) {
          const int kk = (lane >> 3) + 4 * i, k = k0 + kk;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (kk < n && k < w && q < w) v = __ldg(reinterpret_cast<const float4*>(tw + (size_t)k * w + q));
          *reinterpret_cast<float4*>(ws + kk * kWarpCols + col0) = v;
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) {
          const int k = k0 + kk;
          ws[kk * kWarpCols + lane] = (kk < n && k < w && c < w) ? __ldg(tw + (size_t)k * w + c) : 0.f;
        }
      }
      __syncwarp();
      // Y's columns in [w, k_stop) are 0 (phase 1), so are T_w's rows there.
      mac(acc, ys + (size_t)k0 * kRowsPad, ws, kWarpCols, n, row0, col0);
    }
    const int cc = cw + col0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + row0 + i;
      if (r >= h) break;
      float* o = op + (size_t)r * w + cc;
      if (kVec) {
        if (cc < w) *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (cc + j < w) o[j] = acc[i][j];
        }
      }
    }
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

using Kernel = decltype(&blur_planes_kernel<true>);

// The kernel for these operands, with its dynamic shared memory allowed.
cudaError_t select_kernel(const float* planes, const float* th, const float* tw,
                          const float* out, int h, int w, Kernel* kernel, size_t* smem) {
  *kernel = (h % 4 == 0 && w % 4 == 0 && aligned16(planes) && aligned16(th) &&
             aligned16(tw) && aligned16(out))
                ? blur_planes_kernel<true> : blur_planes_kernel<false>;
  *smem = sizeof(float) * smem_floats(w);
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return cudaSuccess;
}


// ============================================================================
// sigma mode: the band built from σ on the device
// ============================================================================

namespace sigma_mode {

constexpr int kThreads = 256;  // 8 warps
constexpr int kHalo = 16;      // halo rows a side of the window copied before sigma is known
constexpr int kMinBlocks = 4;  // blocks per SM the registers must allow (<= 64 a thread)
constexpr int kM = 4;          // rows of a thread's item, in both phases

// Rows of a block's tile (kR) for width w. A 16-row tile's pass covers 256
// columns, a 32-row tile's 128, for one item a thread: 16 rows past 128
// columns, so that one pass covers a row (the faster height at each of the
// main path's sizes, measured on the card).
int tile_rows(int w) { return w <= 128 ? 32 : 16; }

// Input rows the ring holds: the tile and kHalo rows either side. A band
// wider than that streams through it in two chunks' slots.
__host__ __device__ constexpr int ring_rows(int kR) { return kR + 2 * kHalo; }
constexpr int kStages = 2;

// Largest half-width the policy gives at `res` (kernel size clipped to res),
// and the same rounded up to 4.
__host__ __device__ inline int half_max(int res) { return res / 2; }
__host__ __device__ inline int half_max4(int res) { return (res / 2 + 3) & ~3; }

// Shared memory floats of a block, in the kernel's order:
//   t1: tap(d) at t1[h4 + 4 + d], d in [-(h4 + 4), h4 + 3], zero off the band;
//   tm: tap(e - m) at tm[(hm + e) * kM + m], e in [-hm, hm + kM - 1], m < kM;
//   xs: the ring, ring_rows(kR) input rows of one pass's columns at row
//       stride xs_row (the width, where one pass covers a row);
//   ys: Y, kR rows of the width rounded up to 4. Where one pass covers a row
//       it lies on the ring once phase 1 is done, unless each warp's phase 2
//       reads only what it wrote (warp_local: a row's quads within one warp),
//       so that no warp waits for another between the phases.
struct Layout {
  int t1, tm, xs_row, xs, ys, passes, nq;
  bool warp_local;
  __host__ __device__ Layout(int res, int w, int kR) {
    const int qp = kThreads * kM / kR;  // column quads of one pass
    const int yw = (w + 3) & ~3;
    nq = yw / 4;
    passes = (nq + qp - 1) / qp;
    warp_local = passes == 1 && 32 % nq == 0 && kR / kM * nq <= kThreads;
    t1 = 2 * half_max4(res) + 8;
    tm = ((2 * half_max(res) + kM) * kM + 3) & ~3;
    xs_row = passes == 1 ? yw : 4 * qp;
    xs = ring_rows(kR) * xs_row;
    ys = passes == 1 && !warp_local ? 0 : kR * yw;
  }
  __host__ __device__ int floats() const { return t1 + tm + xs + ys; }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asks L2 for `bytes` (a multiple of 16) from 16-byte aligned `src`.
__device__ __forceinline__ void prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

// The one arrival of this phase of `bar`, which then completes when `bytes`
// have landed.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to shared
// `dst` by the copy engine, completing on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// N consecutive floats p[0 .. N) from 16-byte aligned p, as float4 loads.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    t[i] = v.x; t[i + 1] = v.y; t[i + 2] = v.z; t[i + 3] = v.w;
  }
}

// acc[m][j] += tap(a - i0 - m) * X[a][4q + j] over input rows a in [lo, hi),
// in ascending a: row a of X at xr + (a - base) * stride, its taps at
// tm[(a + toff) * kM ..], toff = hm - i0.
__device__ __forceinline__ void accumulate(float (&acc)[kM][4], const float* __restrict__ xr,
                                           int base, int stride, const float* __restrict__ tm,
                                           int toff, int lo, int hi) {
#pragma unroll 4
  for (int a = lo; a < hi; ++a) {
    const float4 xv = *reinterpret_cast<const float4*>(xr + (a - base) * stride);
    float t[kM];
    load_vec<kM>(tm + (a + toff) * kM, t);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      acc[m][0] = fmaf(t[m], xv.x, acc[m][0]);
      acc[m][1] = fmaf(t[m], xv.y, acc[m][1]);
      acc[m][2] = fmaf(t[m], xv.z, acc[m][2]);
      acc[m][3] = fmaf(t[m], xv.w, acc[m][3]);
    }
  }
}

// kVec: w % 4 == 0 and planes and out 16-byte aligned: bulk copies and float4
// stores. Otherwise every thread loads its share of a chunk and the block
// waits at a barrier.
template <int kR, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
blur_sigma_kernel(const float* __restrict__ x, const float* __restrict__ sigma,
                  float* __restrict__ out, int h, int w, int res, int tiles) {
  constexpr int kG = kR / kM;                // row items of a tile
  constexpr int kQp = kThreads / kG;         // column quads of one phase-1 pass
  constexpr int kKC = ring_rows(kR) / kStages;  // input rows a chunk
  static_assert(kR % kM == 0 && kThreads % kG == 0 && ring_rows(kR) % kStages == 0, "tiling");

  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t window[2];     // the window's two halves
  __shared__ __align__(8) uint64_t full[kStages];  // chunks, for a wider band
  const Layout lay(res, w, kR);
  const int hm = half_max(res), h4m = half_max4(res);
  float* t1 = smem;
  float* tm = t1 + lay.t1;
  float* xs = tm + lay.tm;
  float* ys = lay.ys == 0 ? xs : xs + lay.xs;
  const int xs_row = lay.xs_row;
  const int yw = (w + 3) & ~3;  // Y's row stride; its columns >= w are 0
  const int nq = lay.nq;        // quads of a row

  const int tid = threadIdx.x, lane = tid & 31;
  const int p = blockIdx.x / tiles;
  const int r0 = (blockIdx.x - p * tiles) * kR;
  const float* xp = x + (size_t)p * h * w;
  float* op = out + (size_t)p * h * w;
  const float s = __ldg(sigma);

  // ---- the window: the tile's rows and kHalo rows either side ----
  // Contiguous where one pass covers a row, so thread 0 copies it before
  // sigma has arrived, in two halves (the top rows' warps start on the
  // first) unless it is no taller than a tile; ring row j holds input row
  // wbase + j.
  const int wbase = r0 - kHalo;
  const int w_lo = max(0, wbase), w_hi = min(h, r0 + kR + kHalo);
  const int w_mid = w_hi - w_lo <= kR ? w_hi : min(h, r0 + kR / 2);
  const bool windowed = kVec && lay.passes == 1;
  if (kVec && tid == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) mbar_init(&window[i]);
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (windowed) {
      const int cuts[3] = {w_lo, w_mid, w_hi};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (cuts[i + 1] > cuts[i]) {
          const unsigned bytes = (unsigned)(cuts[i + 1] - cuts[i]) * w * 4u;
          mbar_expect(&window[i], bytes);
          bulk_copy(xs + (cuts[i] - wbase) * xs_row, xp + (size_t)cuts[i] * w, bytes, &window[i]);
        }
      }
    } else {
      prefetch_l2(xp + (size_t)w_lo * w, (unsigned)(w_hi - w_lo) * w * 4u);
    }
  }

  // ---- the policy, in float32 as ops/blur.py effective_blur_params ----
  // kernel_size = clamp(floor(6 sigma) + 1, 3, res); sigma_eff = max((k - 1) /
  // 6, 0.01); half = floor(k / 2), in [0, hm] (0 at res = 1, where k = 1). A
  // NaN sigma stays NaN in sigma_eff, so the taps are NaN, as the reference's
  // are; its half is then 0, which only bounds the loops.
  float ks = floorf(6.0f * s) + 1.0f;
  ks = ks < 3.0f ? 3.0f : ks;
  ks = ks > (float)res ? (float)res : ks;
  float se = (ks - 1.0f) / 6.0f;
  se = se < 0.01f ? 0.01f : se;
  const float hf = floorf(ks / 2.0f);
  const int half = hf >= 1.0f ? min((int)hf, hm) : 0;  // the tables hold [-hm, hm]
  const float denom = 2.0f * (se * se);

  // ---- phase 1's input rows: the window, or chunks of kKC rows ----
  const int a_lo = max(0, r0 - half), a_hi = min(h, r0 + kR + half);
  const bool fast = windowed && half <= kHalo;  // the window holds them all
  const int nc = (a_hi - a_lo + kKC - 1) / kKC;  // chunks of a pass
  const int total = lay.passes * nc;

  // Chunk i: pass i / nc, input rows from a_lo + (i % nc) * kKC, that pass's
  // columns, into ring slot i % kStages. Issued by one thread.
  auto issue = [&](int i) {
    const int pass = i / nc, row0 = a_lo + (i - pass * nc) * kKC;
    const int rows = min(kKC, a_hi - row0);
    const int q0 = pass * kQp, qn = min(kQp, nq - q0);
    float* dst = xs + (i % kStages) * (kKC * xs_row);
    uint64_t* bar = &full[i % kStages];
    mbar_expect(bar, (unsigned)rows * qn * 16u);
    if (lay.passes == 1) {  // whole rows: one contiguous run
      bulk_copy(dst, xp + (size_t)row0 * w, (unsigned)rows * w * 4u, bar);
    } else {
      for (int rr = 0; rr < rows; ++rr) {
        bulk_copy(dst + rr * xs_row, xp + (size_t)(row0 + rr) * w + 4 * q0, (unsigned)qn * 16u,
                  bar);
      }
    }
  };
  // Without bulk copies: every thread copies its share of chunk i, zeros past w.
  auto load = [&](int i) {
    const int pass = i / nc, row0 = a_lo + (i - pass * nc) * kKC;
    const int rows = min(kKC, a_hi - row0);
    const int c0 = 4 * pass * kQp, cn = 4 * min(kQp, nq - pass * kQp);
    float* dst = xs + (i % kStages) * (kKC * xs_row);
    for (int idx = tid; idx < rows * cn; idx += kThreads) {
      const int rr = idx / cn, c = idx - rr * cn;
      dst[rr * xs_row + c] = c0 + c < w ? __ldg(xp + (size_t)(row0 + rr) * w + c0 + c) : 0.0f;
    }
  };
  // Warp 0 issues the chunks of a band wider than the window (one thread,
  // once the window's copies have landed in the ring it reuses) while the
  // other warps build the taps. Without copies every warp builds them.
  const int producers = kVec ? 32 : 0;
  if (kVec && !fast && tid == 0) {
    if (windowed) {
      mbar_wait(&window[0], 0);
      if (w_hi > w_mid) mbar_wait(&window[1], 0);
    }
    for (int i = 0; i < min(total, kStages); ++i) issue(i);
  }

  // ---- the taps, while the input is in flight ----
  // Every warp sums the band in the same fixed order, so each has the norm
  // without a barrier; then the other warps fill the tap tables.
  float norm = 0.0f;
  for (int d = lane - half; d <= half; d += 32) {
    const float df = (float)d;
    norm += expf(-(df * df) / denom);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) norm += __shfl_xor_sync(0xffffffffu, norm, off);
  auto tap = [&](int d) {
    const float df = (float)d;
    return abs(d) <= half ? expf(-(df * df) / denom) / norm : 0.0f;
  };
  // Only the entries this sigma reads: t1 over d in [-(h4 + 4), h4 + 3] (phase
  // 2), tm over e in [-half, half + kM - 1] (phase 1).
  const int h4 = (half + 3) & ~3;
  const int filler = tid - producers, fillers = kThreads - producers;
  for (int i = filler; i >= 0 && i < 2 * h4 + 8; i += fillers) {
    t1[h4m + i - h4] = tap(i - h4 - 4);
  }
  for (int i = filler; i >= 0 && i < (2 * half + kM) * kM; i += fillers) {
    const int e = i / kM - half, m = i - (i / kM) * kM;
    tm[(hm + e) * kM + m] = tap(e - m);
  }
  __syncthreads();  // the tables and the barriers are ready

  // ---- phase 1: Y[i0 + m][c .. c + 4) = sum_a tap(a - i0 - m) * X[a][c .. c + 4) ----
  float acc[kM][4];
  int g = 0, q = 0;
  bool active = false;
  if (fast) {
    // Each thread waits only for the window's halves its rows need, and no
    // thread waits for another.
    g = tid / nq;
    q = tid - g * nq;
    const int i0 = r0 + g * kM;
    active = g < kG && i0 < h;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
    }
    if (active) {
      const int cuts[3] = {a_lo, max(a_lo, w_mid), a_hi};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int lo = max(cuts[i], i0 - half), hi = min(cuts[i + 1], i0 + kM + half);
        if (lo < hi) {
          mbar_wait(&window[i], 0);
          accumulate(acc, xs + 4 * q, wbase, xs_row, tm, hm - i0, lo, hi);
        }
      }
    }
  } else {
    for (int i = 0; i < total; ++i) {
      if (kVec) {
        mbar_wait(&full[i % kStages], (i / kStages) & 1);
      } else {
        __syncthreads();  // the previous chunk is consumed
        load(i);
        __syncthreads();
      }
      const int pass = i / nc, c = i - pass * nc;
      const int q0 = pass * kQp, qn = min(kQp, nq - q0);
      g = tid / qn;
      q = tid - g * qn;
      const int i0 = r0 + g * kM;
      active = g < kG && i0 < h;
      if (c == 0) {
#pragma unroll
        for (int m = 0; m < kM; ++m) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
        }
      }
      if (active) {
        const int row0 = a_lo + c * kKC;
        const int lo = max(row0, i0 - half);
        const int hi = min(min(row0 + kKC, a_hi), i0 + kM + half);
        accumulate(acc, xs + (i % kStages) * (kKC * xs_row) + 4 * q, row0, xs_row, tm,
                   hm - i0, lo, hi);
        if (c == nc - 1 && lay.passes > 1) {
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            *reinterpret_cast<float4*>(ys + (g * kM + m) * yw + 4 * (q0 + q)) =
                make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
          }
        }
      }
      if (kVec && i + kStages < total) {  // refill this slot once the block has read it
        __syncthreads();
        if (tid == 0) issue(i + kStages);
      }
    }
  }
  if (lay.passes == 1) {
    if (!lay.warp_local) __syncthreads();  // the ring is read out: Y goes onto it
    if (active) {
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        *reinterpret_cast<float4*>(ys + (g * kM + m) * yw + 4 * q) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      }
    }
  }
  if (lay.warp_local) {
    __syncwarp();  // this warp's rows of Y, all it reads in phase 2, are written
  } else {
    __syncthreads();  // Y is complete
  }

  // ---- phase 2: out[i][j0 + jj] = sum_b Y[i][b] * tap(j0 + jj - b) ----
  // b0 = j0 - D runs up in steps of 4, D over [-h4, h4]; tap(D + jj - u) is
  // t8[4 + jj - u], t8 = tap(D - 4 .. D + 3).
  for (int item = tid; item < kG * nq; item += kThreads) {
    const int gi = item / nq, qi = item - gi * nq;
    const int il = gi * kM;  // the item's first row in the tile
    if (r0 + il >= h) continue;
    const int j0 = 4 * qi;
    float acc2[kM][4];
#pragma unroll
    for (int m = 0; m < kM; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc2[m][j] = 0.0f;
    }
#pragma unroll 2
    for (int dd = h4; dd >= -h4; dd -= 4) {
      const int b0 = j0 - dd;
      float t8[8];
      load_vec<8>(t1 + h4m + dd, t8);
      const bool inside = b0 >= 0 && b0 < yw;
#pragma unroll
      for (int m = 0; m < kM; ++m) {
        float4 yv = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (inside) yv = *reinterpret_cast<const float4*>(ys + (il + m) * yw + b0);
        const float yu[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc2[m][j] = fmaf(yu[u], t8[4 + j - u], acc2[m][j]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const int r = r0 + il + m;
      if (r >= h) break;
      float* o = op + (size_t)r * w + j0;
      if (kVec) {
        *reinterpret_cast<float4*>(o) = make_float4(acc2[m][0], acc2[m][1], acc2[m][2], acc2[m][3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j0 + j < w) o[j] = acc2[m][j];
        }
      }
    }
  }
}

using Kernel = decltype(&blur_sigma_kernel<32, true>);

template <int kR>
Kernel pick(bool vec) {
  return vec ? blur_sigma_kernel<kR, true> : blur_sigma_kernel<kR, false>;
}

// The kernel for these operands, its tile's rows tile_rows(w) written to
// *rows, with its dynamic shared memory allowed.
cudaError_t select(const float* planes, const float* out, int w, int res, int* rows,
                   Kernel* kernel, size_t* smem) {
  *rows = tile_rows(w);
  const bool vec = w % 4 == 0 && aligned16(planes) && aligned16(out);
  *kernel = *rows == 32 ? pick<32>(vec) : pick<16>(vec);
  *smem = sizeof(float) * (size_t)Layout(res, w, *rows).floats();
  if (*smem > 48 * 1024) {
    return cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  }
  return cudaSuccess;
}

}  // namespace sigma_mode
}  // namespace

extern "C" {

// Launches the T-mode blur on `stream` and returns cudaGetLastError() (0 =
// success). planes, out: (n_planes, h, w); th: (h, h); tw: (w, w); all
// float32, contiguous, on CUDA device `device`. Does not synchronise.
int blur_planes_f32(const float* planes, const float* th, const float* tw,
                    float* out, int n_planes, int h, int w, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Kernel kernel;
  size_t smem;
  err = select_kernel(planes, th, tw, out, h, w, &kernel, &smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  const dim3 grid((h + kRows - 1) / kRows, n_planes);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(planes, th, tw, out, h, w);
  return (int)cudaGetLastError();
}

// Launches the sigma-mode blur on `stream` and returns cudaGetLastError().
// planes, out: (n_planes, h, w) float32, contiguous; sigma: one float32; all
// on CUDA device `device`. res: the policy resolution, max(h, w). Does not
// synchronise.
int blur_sigma_f32(const float* planes, const float* sigma, float* out, int n_planes, int h,
                   int w, int res, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  sigma_mode::Kernel kernel;
  size_t smem;
  int rows;
  err = sigma_mode::select(planes, out, w, res, &rows, &kernel, &smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  const int tiles = (h + rows - 1) / rows;
  kernel<<<(unsigned)n_planes * tiles, sigma_mode::kThreads, smem, (cudaStream_t)stream>>>(
      planes, sigma, out, h, w, res, tiles);
  return (int)cudaGetLastError();
}

// What the kernel of one mode (0: T mode, 1: sigma mode at the tile height
// it takes for w) is for h x w planes at policy resolution res (the float4 path when
// w % 4 == 0): its registers a thread, local memory a thread (spills), blocks
// that fit one SM and dynamic shared memory a block. Returns a cudaError_t.
int blur_kernel_attributes(int mode, int h, int w, int res, int device, int* regs,
                           int* local_bytes, int* blocks_per_sm, int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn;
  size_t smem;
  int threads;
  if (mode == 0) {
    Kernel kernel;
    err = select_kernel(nullptr, nullptr, nullptr, nullptr, h, w, &kernel, &smem);
    fn = (const void*)kernel;
    threads = kThreads;
  } else {
    sigma_mode::Kernel kernel;
    int rows;
    err = sigma_mode::select(nullptr, nullptr, w, res, &rows, &kernel, &smem);
    fn = (const void*)kernel;
    threads = sigma_mode::kThreads;
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, or the next launch would report it
    return (int)err;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
}

const char* blur_planes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
