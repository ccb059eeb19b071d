// Fused separable Gaussian blur for Hopper (sm_90a): out[p] = T_h @ X[p] @ T_w.
//
// Replaces the Pallas TPU kernel blurred_gan_tpu/ops/blur_pallas.py
// (_blur_plane_kernel, launched by _pallas_impl). Like that kernel it takes
// arbitrary T_h (H x H) and T_w (W x W): the autograd transpose passes
// T_h^T, T_w^T, and nothing here assumes symmetry or a band.
//
// What bounds it. A dense T at 128 x 128 costs 2 * (H*H*W + H*W*W) =
// 8.4 MFLOP per plane for 128 KB read and written: ~64 FLOP per byte, above
// the ~20 FLOP/byte ridge of the card's float32 CUDA-core rate, so a dense T
// is bounded by arithmetic. The training run's T is a band: at sigma = 5 each
// row has 31 non-zero taps of 128, ~15 FLOP per byte, so the band's work is
// bounded by memory (25 MB for 192 planes, ~7.5 us at 3.35 TB/s). Multiplying
// every zero of the band, as a dense kernel does, makes the band as slow as a
// dense T.
//
// Design: skip the zeros, with ranges read from T itself on the device. No
// sigma, half-width or host read enters the kernel, so a sigma held in a
// device tensor needs no host sync, and the kernel stays right for any T.
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
// 4; at 128^2 and sigma = 5 a tile runs 64 of the 128 k. An empty range
// writes zeros. The products are plain float32 fmaf in ascending k with no
// split of k, so the skipped terms are exact zeros and the result equals the
// dense sum (parity with the reference's Precision.HIGHEST).
//
// Every block reads all of its T_h rows and all of T_w to find its ranges, so
// the scans must not serialise: where h and w are multiples of 4 and the
// operands 16-byte aligned (the float4 path, kVec), each thread of a block
// issues its T_h loads as one batch of float4, testing only whether a quad
// holds a non-zero, and each warp scans its columns of T_w as float4 too.
// Each thread holds an 8 x 4 tile of outputs in registers: A operands (the T_h
// chunk, Y) are k-major, one float4 load broadcast to 8 lanes; B operands are
// one float4 per lane, lane-consecutive. With kK = 16 a block needs ~29 KB of
// shared memory at 128^2 and at most 80 registers a thread, so 6 blocks fit an
// SM and 192 planes (768 blocks) run in one wave on 132 SMs. Tensor cores,
// TMA and double-buffered staging are left to later work.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

}  // namespace

extern "C" {

// Launches the blur on `stream` and returns cudaGetLastError() (0 = success).
// planes, out: (n_planes, h, w); th: (h, h); tw: (w, w); all float32,
// contiguous, on CUDA device `device`. Does not synchronise.
int blur_planes_f32(const float* planes, const float* th, const float* tw,
                    float* out, int n_planes, int h, int w, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Kernel kernel;
  size_t smem;
  err = select_kernel(planes, th, tw, out, h, w, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((h + kRows - 1) / kRows, n_planes);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(planes, th, tw, out, h, w);
  return (int)cudaGetLastError();
}

// Blocks of the kernel that fit one SM for w x w planes (the float4 path when
// w % 4 == 0), and the dynamic shared memory each uses. Returns a cudaError_t
// (0 = success).
int blur_planes_occupancy(int w, int device, int* blocks_per_sm, int* smem_bytes) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Kernel kernel;
  size_t smem;
  err = select_kernel(nullptr, nullptr, nullptr, nullptr, w, w, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  *smem_bytes = (int)smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
}

const char* blur_planes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
