// Fused separable Gaussian blur for Hopper (sm_90a): out[p] = T_h @ X[p] @ T_w.
//
// Replaces the Pallas TPU kernel blurred_gan_tpu/ops/blur_pallas.py
// (_blur_plane_kernel, launched by _pallas_impl). Like that kernel it takes
// arbitrary T_h (H x H) and T_w (W x W): the autograd transpose passes
// T_h^T, T_w^T, and nothing here assumes symmetry or a band.
//
// What bounds it. At 128 x 128 each plane reads and writes 128 KB and costs
// 2 * (H*H*W + H*W*W) = 8.4 MFLOP: about 64 FLOP per byte of device memory.
// That is above the ~20 FLOP/byte ridge of the card's float32 CUDA-core rate,
// so a float32 FFMA kernel is bounded by arithmetic, not by memory. (It is
// below the TF32 tensor-core ridge, so a later tensor-core version becomes
// bounded by memory.) One training-step call at batch 32 is only ~1.6 GFLOP
// over 96-192 planes, so occupancy and launch cost matter as much as the
// inner loop.
//
// Design, simple first. A block owns one plane and a tile of kRows output
// rows; the grid is (row tiles, planes), 768 blocks for 192 planes at 128^2.
//   phase 1: Y = T_h[rows, :] @ X[p] for all W columns, K-chunks of T_h and X
//            staged through shared memory, Y kept in shared memory;
//   phase 2: out[p][rows, :] = Y @ T_w, K-chunks of T_w staged the same way.
// So the intermediate never goes to device memory, as on the TPU. Products
// are plain float32 FFMA (parity with the reference's Precision.HIGHEST),
// accumulated in registers: each of the 4 warps owns 8 rows, each lane 4
// columns (lane + 32 j) of a 128-column pass, an 8 x 4 register tile. A
// operands (T_h chunk, Y) are stored k-major so one float4 load broadcasts 4
// rows to the warp; B operands are read lane-consecutive, free of bank
// conflicts. Tensor cores, TMA, double buffering and skipping the zero band
// are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 32;      // output rows per block (8 per warp)
constexpr int kRowsPad = 36;   // k-major row stride: float4-aligned, no conflicts
constexpr int kCols = 128;     // output columns per pass (4 per lane)
constexpr int kK = 32;         // depth of one staged chunk

// Bs[kk][j] = B[(k0 + kk) * ldb + c0 + j], zero outside K x N.
__device__ __forceinline__ void stage_b(float* __restrict__ bs,
                                        const float* __restrict__ b, int ldb,
                                        int k0, int k_end, int c0, int n) {
  for (int idx = threadIdx.x; idx < kK * kCols; idx += kThreads) {
    const int kk = idx / kCols, j = idx % kCols;
    const int k = k0 + kk, c = c0 + j;
    bs[idx] = (k < k_end && c < n) ? __ldg(b + (size_t)k * ldb + c) : 0.f;
  }
}

// acc[i][j] += sum_kk A[kk][row0 + i] * Bs[kk][lane + 32 j], A k-major.
__device__ __forceinline__ void mac_chunk(float (&acc)[8][4],
                                          const float* __restrict__ a_kmajor,
                                          const float* __restrict__ bs,
                                          int row0, int lane) {
#pragma unroll 8
  for (int kk = 0; kk < kK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_kmajor + kk * kRowsPad + row0);
    const float4 a1 = *reinterpret_cast<const float4*>(a_kmajor + kk * kRowsPad + row0 + 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bs[kk * kCols + lane + 32 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
blur_planes_kernel(const float* __restrict__ x, const float* __restrict__ th,
                   const float* __restrict__ tw, float* __restrict__ out,
                   int h, int w) {
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                   // [kK][kRowsPad]   T_h chunk, k-major
  float* bs = as + kK * kRowsPad;     // [kK][kCols]      B chunk
  float* ys = bs + kK * kCols;        // [w_pad][kRowsPad] Y, k-major

  const int p = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const float* xp = x + (size_t)p * h * w;
  float* op = out + (size_t)p * h * w;
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 8;

  // ---- phase 1: Y[:, c] = T_h[r0:r0+kRows, :] @ X[p][:, c] ----
  for (int c0 = 0; c0 < w; c0 += kCols) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < h; k0 += kK) {
      __syncthreads();  // the previous chunk has been consumed
      for (int idx = threadIdx.x; idx < kRows * kK; idx += kThreads) {
        const int i = idx / kK, kk = idx % kK;  // coalesced along T_h's rows
        const int r = r0 + i, k = k0 + kk;
        as[kk * kRowsPad + i] = (r < h && k < h) ? __ldg(th + (size_t)r * h + k) : 0.f;
      }
      stage_b(bs, xp, w, k0, h, c0, w);
      __syncthreads();
      mac_chunk(acc, as, bs, row0, lane);
    }
    // Columns c >= w come out 0 (their B entries were 0): phase 2 relies on it.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* y = ys + (size_t)(c0 + lane + 32 * j) * kRowsPad + row0;
      *reinterpret_cast<float4*>(y) = make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
      *reinterpret_cast<float4*>(y + 4) = make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
    }
  }

  // ---- phase 2: out[p][r0:r0+kRows, c] = Y @ T_w[:, c] ----
  for (int c0 = 0; c0 < w; c0 += kCols) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < w; k0 += kK) {
      __syncthreads();  // Y complete / the previous chunk has been consumed
      stage_b(bs, tw, w, k0, w, c0, w);
      __syncthreads();
      mac_chunk(acc, ys + (size_t)k0 * kRowsPad, bs, row0, lane);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + row0 + i;
      if (r >= h) break;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < w) op[(size_t)r * w + c] = acc[i][j];
      }
    }
  }
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
  const int w_pad = (w + kCols - 1) / kCols * kCols;
  const size_t smem = sizeof(float) *
      ((size_t)kK * kRowsPad + (size_t)kK * kCols + (size_t)w_pad * kRowsPad);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(blur_planes_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((h + kRows - 1) / kRows, n_planes);
  blur_planes_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      planes, th, tw, out, h, w);
  return (int)cudaGetLastError();
}

const char* blur_planes_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
