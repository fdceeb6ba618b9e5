// Gated linear scan for Hopper: h_t = a_t * h_{t-1} + x_t over (R, T, C),
// elementwise in the channels, with h_{-1} = 0 and an fp32 carry.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan/kernel.py
// (gated_linear_scan_fwd, body _kernel).  The TPU kernel puts channels on
// the 128-wide lanes and walks (block_t, block_c) tiles of time in order
// on one core, carrying the state in VMEM scratch from one grid step to
// the next; it asserts T % block_t == 0 and C % block_c == 0.  On the card
// blocks run in parallel and in no order, so the sequential grid dimension
// becomes a loop inside the thread: one thread per (r, c) column walks t
// from 0 to T-1 with the carry in a register.  Neighbouring threads hold
// neighbouring channels, and C is the contiguous dimension, so every load
// and store of a warp is coalesced.  Ragged T and C are masked: a thread
// past C returns, and the last chunk of time stops at T.
//
// What bounds it on an H100: bytes.  It reads a and x once and writes h
// once, 3 * R * T * C * itemsize bytes, against 2 * R * T * C operations:
// 1/3 operation per fp32 byte, far below the ridge, so the least time is
// 3 * R * T * C * itemsize / 3.35e12 B/s.  What the design does about it:
// each thread loads the next UNROLL steps of a and x into registers before
// it runs the recurrence over them (the loads do not depend on the carry),
// so UNROLL * 2 loads per thread are in flight instead of two.  The serial
// loop still leaves the card latency-bound when R * C is small against the
// card's 132 SMs x 2048 threads (zamba2's R=4, C=5120 gives 20480 threads).
// A chunked parallel scan is the redesign for that: split T into chunks,
// scan each chunk in parallel from a zero state while keeping the chunk's
// product of a, then propagate the chunk carries (a short scan over
// T / chunk values) and fix each chunk up with carry * cumulative a.  It
// trades one more pass over the data for T / chunk times more threads;
// that is later work.
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;   // channels per block: R*C/64 blocks
constexpr int UNROLL = 8;     // time steps loaded ahead of the recurrence

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
gated_linear_scan_kernel(const T* __restrict__ a, const T* __restrict__ x,
                         T* __restrict__ h, int Tn, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int r = blockIdx.y;
  if (c >= C) return;
  const size_t base = (size_t)r * Tn * C + c;
  float carry = 0.0f;
  for (int t0 = 0; t0 < Tn; t0 += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = t0 + u < Tn;
      const size_t off = base + (size_t)(t0 + u) * C;
      av[u] = in ? to_f(a[off]) : 0.0f;
      xv[u] = in ? to_f(x[off]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < Tn) {
        carry = av[u] * carry + xv[u];
        h[base + (size_t)(t0 + u) * C] = from_f<T>(carry);
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* x, void* h, int R, int Tn, int C,
           cudaStream_t st) {
  const dim3 grid((C + THREADS - 1) / THREADS, R);
  gated_linear_scan_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(x), static_cast<T*>(h),
      Tn, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* pulse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16; a, x and h share it.  R rows go on the
// grid's y dimension, so R <= 65535.
int gated_linear_scan_launch(const void* a, const void* x, void* h, int R,
                             int Tn, int C, int dtype, void* stream) {
  if (R <= 0 || Tn <= 0 || C <= 0 || R > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, x, h, R, Tn, C, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, x, h, R, Tn, C, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
