// Fused skip-concat matmul for Hopper:  y = [h | s] @ W = h @ W[:D] + s @ W[D:]
//
// Replaces the Pallas TPU kernel src/repro/kernels/skip_matmul/kernel.py
// (skip_concat_matmul_fwd, body _kernel), the decoder skip-in projection of
// every UViT decoder block (models/diffusion.py::_skip_project).
//
// h, s: (M, D) row-major; W: (2D, N) row-major; y: (M, N) in the input type.
// fp32 accumulation for both input types.
//
// What bounds it on an H100: at UViT-H (D = N = 2560, M = 258 * b) the
// product does 4*M*D*N operations on 2*M*D + 2*D*N + M*N bf16 elements,
// ~400 operations per byte at b = 2 and more at larger b, above the bf16
// ridge of ~295 op/B: the tensor cores bound it, not HBM.
// What the design does about that: both operand pairs stream through one
// fp32 accumulator tile, so the (M, 2D) concat the reference builds in HBM
// (written once, read once) never exists; the bf16 path feeds the tensor
// cores through warp-level mma (wmma 16x16x16, fp32 accumulate) from
// shared-memory tiles.  It is the simple first version: one shared-memory
// stage, no cp.async/TMA pipelining and no wgmma -- those come later.
//
// Unlike the TPU kernel, which asserts M % 128 == N % 128 == D % 128 == 0,
// every edge is masked: tiles are zero-filled past M, N and D, and stores
// are bounds-checked (M = 258 * b is ragged at UViT-H).
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile cols

// ---------------------------------------------------------------- bf16 path
constexpr int BK16 = 32;     // K step of the bf16 tiles
constexpr int APAD = 8;      // row padding (elements) of the A tile
constexpr int BPAD = 8;      // row padding (elements) of the B tile
constexpr int CPAD = 4;      // row padding (floats) of the epilogue tile

// 8 consecutive bf16 of row r, cols [c, c+8) of a (rows, cols) row-major
// matrix with leading dimension ld, zero past the edges.  ``vec`` says the
// whole matrix allows 16-byte loads (aligned base, ld % 8 == 0).
__device__ __forceinline__ void load8_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int r,
                                           int c, int rows, int cols, int ld,
                                           bool vec) {
  if (vec && r < rows && c + 8 <= cols) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    dst[i] = (r < rows && c + i < cols) ? src[(size_t)r * ld + c + i] : zero;
}

// 128 threads = 4 warps; warp w owns the 32x32 quadrant (w / 2, w % 2) of
// the 64x64 output tile as 2x2 wmma accumulator fragments.
__global__ void __launch_bounds__(128)
skip_mm_bf16_kernel(const __nv_bfloat16* __restrict__ h,
                    const __nv_bfloat16* __restrict__ s,
                    const __nv_bfloat16* __restrict__ w,
                    __nv_bfloat16* __restrict__ y, int M, int D, int N,
                    int vec) {
  __shared__ __align__(128) __nv_bfloat16 As[BM][BK16 + APAD];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK16][BN + BPAD];
  __shared__ __align__(128) float Cs[BM][BN + CPAD];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  // half 0 streams (h, W[:D]), half 1 streams (s, W[D:]) into the same
  // accumulator; each half runs its own masked K loop, so no tile straddles
  // the h/s boundary when D is not a multiple of the K step.
  for (int half = 0; half < 2; ++half) {
    const __nv_bfloat16* a = half ? s : h;
    const __nv_bfloat16* b = w + (size_t)half * D * N;
    for (int k0 = 0; k0 < D; k0 += BK16) {
      for (int c = tid; c < BM * BK16 / 8; c += 128) {
        const int r = c / (BK16 / 8), cc = (c % (BK16 / 8)) * 8;
        load8_bf16(&As[r][cc], a, m0 + r, k0 + cc, M, D, D, vec);
      }
      for (int c = tid; c < BK16 * BN / 8; c += 128) {
        const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
        // rows past D are zero: (k0 + r) is masked against D, not 2D
        load8_bf16(&Bs[r][cc], b, k0 + r, n0 + cc, D, N, N, vec);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &As[wm + 16 * i][kk], BK16 + APAD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &Bs[kk][wn + 16 * j], BN + BPAD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j],
                              BN + CPAD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += 128) {
    const int r = e / BN, c = e % BN;
    const int gm = m0 + r, gn = n0 + c;
    if (gm < M && gn < N) y[(size_t)gm * N + gn] = __float2bfloat16(Cs[r][c]);
  }
}

// ---------------------------------------------------------------- fp32 path
// fp32 has no tensor-core path that keeps full fp32 precision (TF32 keeps
// ~3 digits), so this is a register-tiled FMA GEMM: 256 threads as 16x16,
// each computing a 4x4 block of the 64x64 output tile.
constexpr int BK32 = 16;

__global__ void __launch_bounds__(256)
skip_mm_f32_kernel(const float* __restrict__ h, const float* __restrict__ s,
                   const float* __restrict__ w, float* __restrict__ y, int M,
                   int D, int N) {
  __shared__ __align__(16) float As[BK32][BM + 4];   // transposed: [k][m]
  __shared__ __align__(16) float Bs[BK32][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int half = 0; half < 2; ++half) {
    const float* a = half ? s : h;
    const float* b = w + (size_t)half * D * N;
    for (int k0 = 0; k0 < D; k0 += BK32) {
      for (int e = tid; e < BM * BK32; e += 256) {
        const int r = e / BK32, k = e % BK32;
        const int gm = m0 + r, gk = k0 + k;
        As[k][r] = (gm < M && gk < D) ? a[(size_t)gm * D + gk] : 0.0f;
      }
      for (int e = tid; e < BK32 * BN; e += 256) {
        const int k = e / BN, c = e % BN;
        const int gk = k0 + k, gn = n0 + c;
        Bs[k][c] = (gk < D && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK32; ++k) {
        const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn < N) y[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* pulse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  vec: 16-byte loads allowed (bf16 only;
// the caller checks pointer alignment and D % 8 == N % 8 == 0).
int skip_concat_matmul_launch(const void* h, const void* s, const void* w,
                              void* y, int M, int D, int N, int dtype,
                              int vec, void* stream) {
  if (M <= 0 || D <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    skip_mm_f32_kernel<<<grid, 256, 0, st>>>(
        static_cast<const float*>(h), static_cast<const float*>(s),
        static_cast<const float*>(w), static_cast<float*>(y), M, D, N);
  } else if (dtype == 1) {
    skip_mm_bf16_kernel<<<grid, 128, 0, st>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(s),
        static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
        M, D, N, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
