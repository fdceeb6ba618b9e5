// Fused skip-concat matmul for Hopper:  y = [h | s] @ W = h @ W[:D] + s @ W[D:]
//
// Replaces the Pallas TPU kernel src/repro/kernels/skip_matmul/kernel.py
// (skip_concat_matmul_fwd, body _kernel), the decoder skip-in projection of
// every UViT and Hunyuan-DiT decoder block (models/diffusion.py::_skip_project).
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
// never exists.  The bf16 path is a Hopper GEMM: TMA loads 128-byte-swizzled
// tiles into a 4-slot mbarrier ring, one producer thread keeps them in
// flight, and two consumer warpgroups issue wgmma m64n64k16 with the sums in
// registers.  h and s are K-major A operands; W (N contiguous) is an N-major
// B operand read through wgmma's transpose bit.  128 x 64 output tiles give
// 200 blocks at M = 516, N = 2560, two resident per SM.
//
// Unlike the TPU kernel, which asserts M % 128 == N % 128 == D % 128 == 0,
// every edge is handled: TMA zero-fills rows past M and the K edge of each
// half, and stores are bounds-checked (M = 258 * b is ragged at UViT-H).
// The bf16 path needs D % 8 == N % 8 == 0 and 16-byte-aligned bases (TMA's
// stride rule); the wrapper raises on anything else.
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------- bf16 path
// A 128 x 64 output tile per block: two consumer warpgroups of 64 rows each
// and one producer warp.  The K loop walks (h, W[:D]) and then (s, W[D:])
// in 64-deep steps, one tensor map per half of each operand, so the ragged
// K edge of each half is zero-filled by TMA and no tile straddles the h/s
// boundary.  A ring of SSTAGES slots, each an A tile (128 x 64, K-major)
// and a B tile (64 x 64 of W, N-major), with full/empty mbarriers.
constexpr int SBM = 128;                         // tile rows (2 x m64)
constexpr int SBN = 64;                          // tile cols (n64)
constexpr int SBK = 64;                          // K step: 128 bytes of bf16
constexpr int SSTAGES = 4;                       // ring slots
constexpr int SA_BYTES = SBM * SBK * 2;          // 16 KB
constexpr int SB_BYTES = SBK * SBN * 2;          // 8 KB
constexpr int SSTAGE_BYTES = SA_BYTES + SB_BYTES;
constexpr int SCONSUMER_WARPS = 8;
constexpr int STHREADS = SCONSUMER_WARPS * 32 + 32;
constexpr int SKIP_SMEM = SSTAGES * SSTAGE_BYTES + 2 * SSTAGES * 8 + 1024;

__global__ void __launch_bounds__(STHREADS, 2)
skip_mm_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                     const __grid_constant__ CUtensorMap tm_s,
                     const __grid_constant__ CUtensorMap tm_w0,
                     const __grid_constant__ CUtensorMap tm_w1,
                     __nv_bfloat16* __restrict__ y, int M, int D, int N) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors need 1024-byte tiles
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + SSTAGES * SSTAGE_BYTES);
  uint64_t* empty = full + SSTAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.y * SBM, n0 = blockIdx.x * SBN;
  const int kt_half = (D + SBK - 1) / SBK, n_k = 2 * kt_half;

  if (tid == 0) {
    for (int i = 0; i < SSTAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], SCONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == SCONSUMER_WARPS) {
    // producer: one thread keeps up to SSTAGES tiles in flight
    if (lane == 0) {
      for (int it = 0; it < n_k; ++it) {
        const int st = it % SSTAGES;
        hopper::mbar_wait(&empty[st], ((it / SSTAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], SSTAGE_BYTES);
        const int half = it >= kt_half;
        const int k0 = (it - half * kt_half) * SBK;
        uint8_t* a = smem + st * SSTAGE_BYTES;
        hopper::tma_load_2d(a, half ? &tm_s : &tm_h, &full[st], k0, m0);
        hopper::tma_load_2d(a + SA_BYTES, half ? &tm_w1 : &tm_w0, &full[st],
                            n0, k0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = warp / 4;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
  for (int it = 0; it < n_k; ++it) {
    const int st = it % SSTAGES;
    hopper::mbar_wait(&full[st], (it / SSTAGES) & 1);
    const uint8_t* a = smem + st * SSTAGE_BYTES + wg * 64 * 128;
    const uint8_t* b = smem + st * SSTAGE_BYTES + SA_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SBK / 16; ++kk)
      hopper::wgmma_m64n64k16_ss<1>(acc, hopper::desc_sw128(a + kk * 32),
                                    hopper::desc_sw128(b + kk * 2048));
    hopper::wgmma_commit();
    // keep this step's products in flight; the previous step's are done,
    // so its slot goes back to the producer
    hopper::wgmma_wait<1>();
    if (it > 0 && lane == 0) hopper::mbar_arrive(&empty[(it - 1) % SSTAGES]);
  }
  hopper::wgmma_wait<0>();

  // epilogue: bounds-checked bf16x2 stores (N % 8 == 0, so col + 1 < N)
  const int row0 = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < SBN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < M)
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
    }
  }
}

int launch_bf16(const void* h, const void* s, const void* w, void* y, int M,
                int D, int N, cudaStream_t st) {
  // the TMA stride rule: 16-byte aligned bases and row strides
  const bool aligned = D % 8 == 0 && N % 8 == 0 &&
                       ((uintptr_t)h | (uintptr_t)s | (uintptr_t)w |
                        (uintptr_t)y) % 16 == 0;
  if (!aligned) return (int)cudaErrorInvalidValue;
  CUtensorMap th, ts, tw0, tw1;
  const uint64_t da[2] = {(uint64_t)D, (uint64_t)M}, sa[1] = {(uint64_t)D * 2};
  const uint32_t ba[2] = {SBK, SBM};
  const uint64_t db[2] = {(uint64_t)N, (uint64_t)D}, sb[1] = {(uint64_t)N * 2};
  const uint32_t bb[2] = {SBN, SBK};
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(w) + (size_t)D * N;
  int err;
  if ((err = hopper::make_tma_bf16(&th, h, 2, da, sa, ba)) ||
      (err = hopper::make_tma_bf16(&ts, s, 2, da, sa, ba)) ||
      (err = hopper::make_tma_bf16(&tw0, w, 2, db, sb, bb)) ||
      (err = hopper::make_tma_bf16(&tw1, w1, 2, db, sb, bb)))
    return err;
  static std::atomic<uint64_t> opted{0};
  cudaError_t e = hopper::opt_in_smem(
      opted, (const void*)skip_mm_wgmma_kernel, SKIP_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + SBN - 1) / SBN, (M + SBM - 1) / SBM);
  skip_mm_wgmma_kernel<<<grid, STHREADS, SKIP_SMEM, st>>>(
      th, ts, tw0, tw1, static_cast<__nv_bfloat16*>(y), M, D, N);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path
// fp32 has no tensor-core path that keeps full fp32 precision (TF32 keeps
// ~3 digits), so this is a register-tiled FMA GEMM: 256 threads as 16x16,
// each computing a 4x4 block of the 64x64 output tile.
constexpr int BM = 64;   // output tile rows
constexpr int BN = 64;   // output tile cols
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

// dtype: 0 = float32, 1 = bfloat16 (D % 8 == N % 8 == 0 and 16-byte-aligned
// pointers, else cudaErrorInvalidValue).
int skip_concat_matmul_launch(const void* h, const void* s, const void* w,
                              void* y, int M, int D, int N, int dtype,
                              void* stream) {
  if (M <= 0 || D <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_bf16(h, s, w, y, M, D, N, st);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  skip_mm_f32_kernel<<<grid, 256, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(s),
      static_cast<const float*>(w), static_cast<float*>(y), M, D, N);
  return (int)cudaGetLastError();
}

// The bf16 kernel's tiling: {tile rows, tile cols, K step, ring slots,
// threads per block, dynamic shared memory bytes, resident blocks per SM}.
int skip_concat_matmul_bf16_config(int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      skip_mm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SKIP_SMEM);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, skip_mm_wgmma_kernel, STHREADS, SKIP_SMEM);
  const int v[7] = {SBM, SBN, SBK, SSTAGES, STHREADS, SKIP_SMEM, blocks};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return (int)e;
}

}  // extern "C"
