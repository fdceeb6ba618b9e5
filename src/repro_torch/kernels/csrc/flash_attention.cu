// Flash-attention forward for Hopper: softmax(q k^T / sqrt(D) + mask) v
// with an online softmax, so the (S, T) score matrix never reaches HBM.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel), wired into the self-attention of
// every UViT and Hunyuan-DiT block and Hunyuan-DiT's cross-attention over
// the text tokens (models/layers.py::apply_attention with use_flash).
//
// Layout: q (B, S, Hq, D), k and v (B, T, Hkv, D), out (B, S, Hq, D), all
// contiguous -- the model's own layout, so no transpose is materialised.
// GQA reads kv head h / (Hq / Hkv) directly instead of repeating K/V.
// Causal and sliding-window masks as in the reference (key k is visible to
// query q iff k <= q when causal, and k > q - window with a window); the
// ragged tail past T is masked too (T = 258 at UViT-H is not a multiple of
// any power-of-two tile, where the TPU kernel asserts T % block_k == 0).
// A query row that sees no key at all writes zeros, as the reference does.
//
// What bounds it on an H100: at UViT-H (S = T = 258, D = 128) one (b, h)
// pair does 4*S*T*D operations on 4*S*D elements, ~130 operations per bf16
// byte, below the bf16 ridge (~295 op/B) but far above what this kernel's
// fp32 FMA arithmetic reaches, so its own arithmetic bounds it.  What the
// design does: one block per (b*h, 16-query tile); 4 warps x 4 query rows;
// K/V tiles of 32 keys staged in shared memory as fp32; lane j scores key j
// (all four rows reuse each K element it loads) and lanes split the output
// dims for the P.V update; running max and sum are fp32.  Blocks skip the
// K/V tiles their causal/window mask hides entirely.  The simple first
// version: tensor cores (mma/wgmma) and TMA come in a later version.
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NWARP = 4;           // warps per block
constexpr int ROWS = 4;            // query rows per warp
constexpr int BQ = NWARP * ROWS;   // query rows per block
constexpr int BKV = 32;            // keys per K/V tile (one per lane)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DH, typename T>
__global__ void __launch_bounds__(NWARP * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int Tk,
                 int Hq, int Hkv, int causal, int has_window, int window,
                 float scale) {
  constexpr int DPL = (DH + 31) / 32;   // output dims per lane
  __shared__ float qs[BQ][DH];
  __shared__ float ks[BKV][DH + 1];     // +1: lane j reads row j conflict-free
  __shared__ float vs[BKV][DH + 1];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * BQ;

  for (int e = tid; e < BQ * DH; e += NWARP * 32) {
    const int r = e / DH, d = e % DH, sq = q0 + r;
    qs[r][d] = sq < S ? to_f(q[(((size_t)b * S + sq) * Hq + hq) * DH + d]) *
                            scale
                      : 0.0f;
  }

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[r][c] = 0.0f;
  }

  // keys any row of this block can see: causal stops at the last row,
  // a window starts after the first row's horizon
  int kv_hi = Tk;
  if (causal) kv_hi = min(Tk, q0 + BQ);
  int kv_lo = 0;
  if (has_window) kv_lo = max(0, q0 - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  for (int kt = kv_lo; kt < kv_hi; kt += BKV) {
    __syncthreads();   // previous tile fully consumed (and qs written)
    for (int e = tid; e < BKV * DH; e += NWARP * 32) {
      const int j = e / DH, d = e % DH, kj = kt + j;
      const bool in = kj < Tk;
      const size_t off = (((size_t)b * Tk + kj) * Hkv + hk) * DH + d;
      ks[j][d] = in ? to_f(k[off]) : 0.0f;
      vs[j][d] = in ? to_f(v[off]) : 0.0f;
    }
    __syncthreads();

    const int kj = kt + lane;
    float sc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) sc[r] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float kd = ks[lane][d];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        sc[r] = fmaf(qs[warp * ROWS + r][d], kd, sc[r]);
    }

    float p[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
      const bool valid = kj < Tk && (!causal || kj <= qpos) &&
                         (!has_window || kj > qpos - window);
      const float sv = valid ? sc[r] : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(sv));
      p[r] = valid ? expf(sv - m_new) : 0.0f;
      // m[r] = -inf: nothing seen yet (acc and l are still zero)
      const float alpha = m[r] == -INFINITY ? 0.0f : expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DPL; ++c) acc[r][c] *= alpha;
    }

#pragma unroll 4
    for (int j = 0; j < BKV; ++j) {
      float vj[DPL];
#pragma unroll
      for (int c = 0; c < DPL; ++c) {
        const int d = lane + 32 * c;
        vj[c] = d < DH ? vs[j][d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= S) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < DH)
        o[(((size_t)b * S + qpos) * Hq + hq) * DH + d] =
            from_f<T>(acc[r][c] * inv);
    }
  }
}

template <int DH, typename T>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int S, int Tk, int Hq, int Hkv, int causal, int has_window,
            int window, float scale, cudaStream_t st) {
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_fwd_kernel<DH, T><<<grid, NWARP * 32, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hkv, causal,
      has_window, window, scale);
}

template <typename T>
int launch_dh(int D, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Tk, int Hq, int Hkv, int causal,
              int has_window, int window, float scale, cudaStream_t st) {
  switch (D) {
    case 8: launch<8, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, window, scale, st); break;
    case 16: launch<16, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, window, scale, st); break;
    case 32: launch<32, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, window, scale, st); break;
    case 64: launch<64, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, window, scale, st); break;
    case 128: launch<128, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, window, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pulse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  D in {8, 16, 32, 64, 128};
// Hq % Hkv == 0.
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int Tk, int Hq,
                               int Hkv, int D, int causal, int has_window,
                               int window, float scale, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(D, q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                            has_window, window, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(D, q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                                    has_window, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
