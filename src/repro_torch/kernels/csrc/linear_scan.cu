// Gated linear scan for Hopper: h_t = a_t * h_{t-1} + x_t over (R, T, C),
// elementwise in the channels, with h_{-1} = 0 and an fp32 carry; and, in
// its backward mode, the gradient of that scan in one pass.
//
// Replaces the Pallas TPU kernel src/repro/kernels/linear_scan/kernel.py
// (gated_linear_scan_fwd, body _kernel) and the JAX custom VJP around it
// (linear_scan/ops.py::_bwd).  The TPU kernel puts channels on the 128-wide
// lanes and walks (block_t, block_c) tiles of time in order on one core,
// carrying the state in VMEM scratch from one grid step to the next.  On
// the card blocks run in parallel and in no order, so the sequential grid
// dimension becomes a single-pass chunked scan with decoupled look-back.
//
// What bounds it on an H100: bytes.  The forward reads a and x once and
// writes h once (3 N elements, N = R*T*C) for 2 N operations; the backward
// reads a, g and h and writes dx and da (5 N).  Far below the ridge, so the
// least time is the bytes over 3.35 TB/s.  Reaching it is a matter of
// bytes in flight (Little's law asks for ~2-3 MB across the card): the
// recurrence is serial in t, and one thread per (row, channel) column, as
// the first port of this kernel had, leaves zamba2's R = 4, C = 5120 with
// 20,480 threads and a few hundred KB in flight.  What the design does:
//
// - Tiles.  One block owns a row r, a tile of 256 channels (32 lanes x 8
//   contiguous channels: 16-byte accesses in bf16) and a chunk of L time
//   steps, so zamba2's shape has R * C/256 * T/L = 5,120 blocks at L = 64.
//   Four warps split the chunk's steps among themselves.  L is the
//   largest multiple of 16, up to 64, whose tiles fit in 96 KB: bf16
//   forward 64 (64 KB of tiles, three blocks resident on an SM), fp32
//   forward 48, bf16 backward 64 and fp32 backward 32 (96 KB, two blocks).
//   Longer chunks mean fewer look-backs and less scratch traffic; on the
//   card they beat more, shorter ones (PERF.md).
// - Loads.  One thread loads the chunk's tiles of a and x (backward: a, g
//   and h) into shared memory with TMA over the 3-D (R, T, C) tensor, one
//   mbarrier for all of them: up to 192 KB in flight per SM.  TMA's
//   out-of-bounds zero fill covers the ragged T and C edges.  Where a base
//   or a row breaks TMA's 16-byte rule (C % 8 != 0 in bf16, C % 4 != 0 in
//   fp32, a misaligned view), the block loads the same tiles with masked
//   scalar loads and stores with masked scalar stores: one kernel, one
//   layout in shared memory, and no fallback outside it.
// - Local pass.  Each thread scans its steps from a zero state, keeping
//   the pair (A = prod a, B = local h) in fp32 for each of its channels; the
//   warps combine their pairs through shared memory, (A2 A1, A2 B1 + B2).
// - Look-back.  A global atomic ticket hands out the chunks in launch
//   order (all chunks k before any chunk k + 1), so a block waits only on
//   blocks that have already started.  A fifth warp walks back over its
//   predecessors' flags, combining their aggregates until it meets an
//   inclusive prefix, to get the chunk's carry-in, then publishes the
//   chunk's inclusive prefix: one flag word per (row, channel tile, chunk),
//   values in an fp32 scratch buffer.  It starts as soon as the block has
//   its ticket, so the walk runs while the tiles load, and it publishes the
//   chunk's aggregate only where a predecessor keeps it waiting after the
//   local pass is done.  The wrapper zeroes the flags and the ticket
//   (torch.zeros) and the kernel allocates nothing, so a CUDA graph
//   captures the whole call.  A wait of more than 10 s traps, so a fault
//   is a launch error, not a hung card.
// - Fix-up.  Each thread runs its steps again from its carry-in (the
//   chunk's carry through the warps before it) and writes h in the output
//   dtype with 16-byte stores.
// - Tensor cores are not used: the decay differs per channel, so there is
//   no shared triangular matrix to multiply, as Mamba2's SSD form has.
// - Dtypes.  a and x each take fp32 or bf16 on their own; h takes x's.
// - Backward mode: the same template scans in reverse,
//   dX_t = round_a(g_t) + a_{t+1} dX_{t+1}, and its epilogue writes
//   dx_t = dX_t rounded to a's dtype, then to g's, and da_t = that rounded
//   dX_t * h_{t-1} rounded to a's dtype: the JAX VJP's rounding chain.  The
//   tiles of a and h are loaded one step off (t + 1 and t - 1), so TMA's
//   zero fill gives a_T = 0 and h_{-1} = 0: no concatenation, no flip.
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <climits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TILE_C = 256;            // channels per block
constexpr int VEC = 8;                 // contiguous channels per lane
constexpr int WARPS = 4;                // compute warps; one more looks back
constexpr int COMPUTE = WARPS * 32;
constexpr int THREADS = COMPUTE + 32;
constexpr int TILE_BUDGET = 96 * 1024; // bytes of input tiles per block
constexpr int MAX_L = 64;               // time steps per chunk, at most
constexpr uint64_t TIMEOUT_NS = 10000000000ull;

template <typename TA, typename TX, bool BWD>
struct Cfg {
  // bytes of one time step of the tiles: a and x (backward: a, g and h)
  static constexpr int STEP_BYTES =
      TILE_C * (int)(sizeof(TA) + sizeof(TX) * (BWD ? 2 : 1));
  // the most steps, a multiple of 16, whose tiles fit in the budget
  static constexpr int L_FIT = TILE_BUDGET / STEP_BYTES / 16 * 16;
  static constexpr int L = L_FIT < MAX_L ? L_FIT : MAX_L;
  static_assert(L >= 16 && L % WARPS == 0, "a chunk per warp");
  static constexpr int S = L / WARPS;  // steps per warp
  static constexpr int A_BYTES = L * TILE_C * (int)sizeof(TA);
  static constexpr int X_BYTES = L * TILE_C * (int)sizeof(TX);
  static constexpr int TILE_BYTES = L * STEP_BYTES;
  // tiles, the warps' pairs, the carry-in, two mbarriers and the ticket,
  // plus 128 bytes to align the TMA destination
  static constexpr int SMEM =
      TILE_BYTES + WARPS * TILE_C * 8 + TILE_C * 4 + 32 + 128;
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(
    __nv_bfloat16 x) {
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
// x rounded to T and back: the dtype cast of the JAX VJP
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// 8 contiguous elements of a shared-memory tile (16-byte aligned) as fp32
__device__ __forceinline__ void ld8(const float* p, float* v) {
  const float4 u = reinterpret_cast<const float4*>(p)[0];
  const float4 w = reinterpret_cast<const float4*>(p)[1];
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
}
__device__ __forceinline__ void ld8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 fp32 values to global memory as T: 16-byte stores where the lane's
// channels are whole and the row allows it, masked scalar stores elsewhere
__device__ __forceinline__ void st8_vec(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void st8_vec(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) b[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
template <typename T>
__device__ __forceinline__ void st8(T* p, const float* v, int valid,
                                    bool vec) {
  if (vec && valid >= VEC) {
    st8_vec(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      if (i < valid) p[i] = from_f<T>(v[i]);
  }
}

// the masked path's tile load: steps t0 + shift .. + L of row r, zeros
// outside the tensor, in the layout TMA writes
template <typename T, int L>
__device__ __forceinline__ void load_masked(T* dst, const T* src, int r,
                                            int t0, int c0, int Tn, int C) {
  for (int e = threadIdx.x; e < L * TILE_C; e += COMPUTE) {
    const int t = t0 + e / TILE_C, c = c0 + e % TILE_C;
    dst[e] = (t >= 0 && t < Tn && c < C) ? src[((size_t)r * Tn + t) * C + c]
                                         : from_f<T>(0.0f);
  }
}

// ------------------------------------------------------------ look-back
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

constexpr int AGGREGATE = 1, INCLUSIVE = 2;   // flag values; 0: not yet
constexpr unsigned FULL = 0xffffffffu;

// Warp-wide: the lanes' writes of a chunk's values, then its flag.
__device__ __forceinline__ void publish(int* flag, int value, int lane) {
  __threadfence();
  __syncwarp();
  if (lane == 0) st_release(flag, value);
}

// Warp-wide: the flag as lane 0 reads it.  Where it is set, every lane
// then acquires it too, so each lane's reads of the values that follow see
// what was published under the value returned (flags only grow: a chunk's
// aggregate, if it is published at all, comes before its inclusive prefix).
__device__ __forceinline__ int poll_flag(const int* flag, int lane) {
  int v = lane == 0 ? ld_acquire(flag) : 0;
  v = __shfl_sync(FULL, v, 0);
  if (v != 0) (void)ld_acquire(flag);
  return v;
}

__device__ __forceinline__ void ldcg8(const float* p, float* v) {
  const float4 u = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 w = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
}
__device__ __forceinline__ void stcg8(float* p, const float* v) {
  __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  __stcg(reinterpret_cast<float4*>(p) + 1, make_float4(v[4], v[5], v[6], v[7]));
}

// Named barriers (0 is __syncthreads'): the compute warps among
// themselves, and the look-back warp's carry-in to the compute warps.
constexpr int BAR_COMPUTE = 1, BAR_CARRY = 2;
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// The warps' pairs are laid out [warp][channel i of the lane][lane].
// (pA, pB): the pairs of the warps before ``warp`` in scan order combined;
// with warp = -1 (backward: WARPS), all of them, the chunk's aggregate.
template <bool BWD>
__device__ __forceinline__ void combine_pairs(const float2* pairs, int warp,
                                              int lane, float* pA,
                                              float* pB) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) { pA[i] = 1.0f; pB[i] = 0.0f; }
#pragma unroll
  for (int q = 0; q < WARPS; ++q) {
    const int w = BWD ? WARPS - 1 - q : q;
    if (BWD ? w <= warp : w >= warp) continue;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float2 p = pairs[(w * VEC + i) * 32 + lane];
      pB[i] = p.x * pB[i] + p.y;
      pA[i] *= p.x;
    }
  }
}

// The look-back warp.  It walks back over the flags of the chunks before
// chunk k (in scan order) of its (row, channel tile), combining published
// aggregates until it meets a published inclusive prefix, writes the
// carry-in for the compute warps, then publishes the chunk's own inclusive
// prefix.  It starts as soon as the block has its ticket, so the walk runs
// while the tiles load; if a predecessor has published nothing yet and
// the local pass is done (``done``), it publishes the chunk's aggregate
// first, so that its successors need not wait for its carry.  A walk of
// more than 10 s traps.
template <bool BWD>
__device__ __forceinline__ void look_back(const float2* pairs,
                                          float* carry_in, uint64_t* done,
                                          float* vals, int* flags, int col,
                                          int k, int nch, int lane) {
  const size_t first = (size_t)col * nch;   // chunk 0 of this column
  float* mine = vals + (first + k) * 3 * TILE_C + lane * VEC;
  const bool last = k + 1 == nch;           // no chunk reads what it publishes
  bool have_total = false, aggregate_out = last;
  float tA[VEC], tB[VEC], carry[VEC], accA[VEC], accB[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { carry[i] = 0.0f; accA[i] = 1.0f; accB[i] = 0.0f; }
  uint32_t spins = 0;
  uint64_t t0 = 0;
  for (int j = k - 1; j >= 0;) {
    const float* theirs = vals + (first + j) * 3 * TILE_C + lane * VEC;
    const int f = poll_flag(flags + first + j, lane);
    if (f == INCLUSIVE) {
      float hv[VEC];
      ldcg8(theirs + 2 * TILE_C, hv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) carry[i] = accA[i] * hv[i] + accB[i];
      break;
    }
    if (f == AGGREGATE) {
      float av[VEC], bv[VEC];
      ldcg8(theirs, av);
      ldcg8(theirs + TILE_C, bv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        accB[i] = accA[i] * bv[i] + accB[i];
        accA[i] *= av[i];
      }
      --j;
      continue;
    }
    if (!aggregate_out && __all_sync(FULL, hopper::mbar_test(done, 0))) {
      combine_pairs<BWD>(pairs, BWD ? -1 : WARPS, lane, tA, tB);
      have_total = aggregate_out = true;
      stcg8(mine, tA);
      stcg8(mine + TILE_C, tB);
      publish(flags + first + k, AGGREGATE, lane);
    }
    if ((++spins & 1023) == 0) {
      const uint64_t t = hopper::globaltimer_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > TIMEOUT_NS) __trap();
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) carry_in[i * 32 + lane] = carry[i];
  bar_arrive(BAR_CARRY, THREADS);
  if (last) return;
  if (!have_total) {
    hopper::mbar_wait(done, 0);
    combine_pairs<BWD>(pairs, BWD ? -1 : WARPS, lane, tA, tB);
  }
  float hv[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) hv[i] = tA[i] * carry[i] + tB[i];
  stcg8(mine + 2 * TILE_C, hv);
  publish(flags + first + k, INCLUSIVE, lane);
}

// ---------------------------------------------------------------- kernel
// Forward (BWD = false): a (TA), x = the scanned input (TX), out = h (TX).
// Backward (BWD = true): a (TA), x = g (TX), hin = h (TX); out = dx (TX),
// out_da = da (TA).  vals holds 3 x 256 floats per (row, channel tile,
// chunk) (aggregate A, aggregate B, inclusive prefix), flags one word each
// and, after them, the ticket.  Warps 0..WARPS-1 load, scan and write;
// warp WARPS looks back.
template <typename TA, typename TX, bool BWD>
__global__ void __launch_bounds__(THREADS, 3)
gated_linear_scan_kernel(const __grid_constant__ CUtensorMap tm_a,
                         const __grid_constant__ CUtensorMap tm_x,
                         const __grid_constant__ CUtensorMap tm_h,
                         const TA* __restrict__ a, const TX* __restrict__ x,
                         const TX* __restrict__ hin, TX* __restrict__ out,
                         TA* __restrict__ out_da, float* __restrict__ vals,
                         int* __restrict__ flags, int Tn, int C, int ntiles,
                         int nch, int use_tma) {
  using K = Cfg<TA, TX, BWD>;
  constexpr int L = K::L, S = K::S;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (hopper::smem_u32(smem_raw) & 127)) & 127);
  TA* tile_a = reinterpret_cast<TA*>(smem);
  TX* tile_x = reinterpret_cast<TX*>(smem + K::A_BYTES);
  TX* tile_h = reinterpret_cast<TX*>(smem + K::A_BYTES + K::X_BYTES);
  float2* pairs = reinterpret_cast<float2*>(smem + K::TILE_BYTES);
  float* carry_in = reinterpret_cast<float*>(pairs + WARPS * TILE_C);  // [i][lane]
  uint64_t* loaded = reinterpret_cast<uint64_t*>(carry_in + TILE_C);
  uint64_t* done = loaded + 1;              // the local pass's pairs
  int* ticket = reinterpret_cast<int*>(done + 1);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ncols = gridDim.x / nch;
  if (tid == 0) {
    *ticket = atomicAdd(flags + (size_t)ncols * nch, 1);
    hopper::mbar_init(loaded, 1);
    hopper::mbar_init(done, COMPUTE);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  // k: the chunk's place in scan order (0 first: t = 0 forward, the last
  // chunk backward); col: (row, channel tile)
  const int k = *ticket / ncols, col = *ticket % ncols;
  if (warp == WARPS) {
    look_back<BWD>(pairs, carry_in, done, vals, flags, col, k, nch, lane);
    return;
  }
  const int r = col / ntiles, c0 = (col % ntiles) * TILE_C;
  const int t0 = (BWD ? nch - 1 - k : k) * L;
  if (use_tma) {
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(loaded, K::TILE_BYTES);
      hopper::tma_load_3d(tile_a, &tm_a, loaded, c0, t0 + (BWD ? 1 : 0), r);
      hopper::tma_load_3d(tile_x, &tm_x, loaded, c0, t0, r);
      if (BWD) hopper::tma_load_3d(tile_h, &tm_h, loaded, c0, t0 - 1, r);
    }
    hopper::mbar_wait(loaded, 0);
  } else {
    load_masked<TA, L>(tile_a, a, r, t0 + (BWD ? 1 : 0), c0, Tn, C);
    load_masked<TX, L>(tile_x, x, r, t0, c0, Tn, C);
    if (BWD) load_masked<TX, L>(tile_h, hin, r, t0 - 1, c0, Tn, C);
    bar_sync(BAR_COMPUTE, COMPUTE);
  }

  // local pass over this warp's S steps, in scan order, from a zero state
  const int j0 = lane * VEC;
  float A[VEC], B[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) { A[i] = 1.0f; B[i] = 0.0f; }
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int s = warp * S + (BWD ? S - 1 - q : q);
    float av[VEC], xv[VEC];
    ld8(tile_a + s * TILE_C + j0, av);
    ld8(tile_x + s * TILE_C + j0, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float xi = BWD ? round_to<TA>(xv[i]) : xv[i];
      B[i] = av[i] * B[i] + xi;
      A[i] *= av[i];
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    pairs[(warp * VEC + i) * 32 + lane] = make_float2(A[i], B[i]);
  hopper::mbar_arrive(done);
  hopper::mbar_wait(done, 0);
  // this warp's carry through the warps before it in scan order
  float pA[VEC], pB[VEC];
  combine_pairs<BWD>(pairs, warp, lane, pA, pB);
  bar_sync(BAR_CARRY, THREADS);

  // fix-up: this warp's steps again, from its carry-in, written out
  const int valid = C - (c0 + j0);           // this lane's channels in C
  const bool vec = use_tma != 0;
  float h[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) h[i] = pA[i] * carry_in[i * 32 + lane] + pB[i];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int s = warp * S + (BWD ? S - 1 - q : q);
    float av[VEC], xv[VEC];
    ld8(tile_a + s * TILE_C + j0, av);
    ld8(tile_x + s * TILE_C + j0, xv);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      h[i] = av[i] * h[i] + (BWD ? round_to<TA>(xv[i]) : xv[i]);
    const int t = t0 + s;
    if (t >= Tn || valid <= 0) continue;
    const size_t off = ((size_t)r * Tn + t) * C + c0 + j0;
    if (BWD) {
      float hp[VEC], dx[VEC], da[VEC];
      ld8(tile_h + s * TILE_C + j0, hp);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        dx[i] = round_to<TA>(h[i]);
        da[i] = dx[i] * hp[i];
      }
      st8(out + off, dx, valid, vec);
      st8(out_da + off, da, valid, vec);
    } else {
      st8(out + off, h, valid, vec);
    }
  }
}

template <typename T> constexpr CUtensorMapDataType tma_dtype() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A 3-D map over (R, T, C) with a (1, L, 256) box, no swizzle.
template <typename T>
int make_map(CUtensorMap* map, const void* base, int R, int Tn, int C, int L) {
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)Tn, (uint64_t)R};
  const uint64_t strides[2] = {(uint64_t)C * sizeof(T),
                               (uint64_t)Tn * C * sizeof(T)};
  const uint32_t box[3] = {TILE_C, (uint32_t)L, 1};
  return hopper::make_tma(map, tma_dtype<T>(), base, 3, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <typename TA, typename TX, bool BWD>
int launch(const void* a, const void* x, const void* hin, void* out,
           void* out_da, void* vals, void* flags, int R, int Tn, int C,
           cudaStream_t st) {
  using K = Cfg<TA, TX, BWD>;
  auto kernel = gated_linear_scan_kernel<TA, TX, BWD>;
  const int ntiles = (C + TILE_C - 1) / TILE_C, nch = (Tn + K::L - 1) / K::L;
  const long long blocks = (long long)R * ntiles * nch;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // TMA and 16-byte stores need 16-byte-aligned bases and rows
  uintptr_t bases = (uintptr_t)a | (uintptr_t)x | (uintptr_t)out;
  if (BWD) bases |= (uintptr_t)hin | (uintptr_t)out_da;
  const bool use_tma = bases % 16 == 0 && C * sizeof(TA) % 16 == 0 &&
                       C * sizeof(TX) % 16 == 0;
  CUtensorMap tm_a{}, tm_x{}, tm_h{};
  if (use_tma) {
    int err;
    if ((err = make_map<TA>(&tm_a, a, R, Tn, C, K::L)) ||
        (err = make_map<TX>(&tm_x, x, R, Tn, C, K::L)) ||
        (BWD && (err = make_map<TX>(&tm_h, hin, R, Tn, C, K::L))))
      return err;
  }
  static std::atomic<uint64_t> opted{0};
  cudaError_t e = hopper::opt_in_smem(opted, (const void*)kernel, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)blocks, THREADS, K::SMEM, st>>>(
      tm_a, tm_x, tm_h, static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<const TX*>(hin), static_cast<TX*>(out),
      static_cast<TA*>(out_da), static_cast<float*>(vals),
      static_cast<int*>(flags), Tn, C, ntiles, nch, use_tma ? 1 : 0);
  return (int)cudaGetLastError();
}

template <typename TA, typename TX, bool BWD>
int config(int* out) {
  using K = Cfg<TA, TX, BWD>;
  auto kernel = gated_linear_scan_kernel<TA, TX, BWD>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS,
                                                    K::SMEM);
  const int v[5] = {K::L, TILE_C, THREADS, K::SMEM, blocks};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return (int)e;
}

// dtype codes: 0 = float32, 1 = bfloat16; (dtype of a, dtype of x) picks
// one of four instantiations of each direction
template <typename F>
int dispatch(int dtype_a, int dtype_x, F&& f) {
  if (dtype_a == 0 && dtype_x == 0) return f(float{}, float{});
  if (dtype_a == 0 && dtype_x == 1) return f(float{}, __nv_bfloat16{});
  if (dtype_a == 1 && dtype_x == 0) return f(__nv_bfloat16{}, float{});
  if (dtype_a == 1 && dtype_x == 1)
    return f(__nv_bfloat16{}, __nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* pulse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// h = scan(a, x), h in x's dtype.  vals: 3 * 256 floats and flags: one
// int per (row, 256-channel tile, chunk of gated_linear_scan_config's L
// steps), flags plus one more int for the ticket, all zero.
int gated_linear_scan_launch(const void* a, const void* x, void* h,
                             void* vals, void* flags, int R, int Tn, int C,
                             int dtype_a, int dtype_x, void* stream) {
  if (R <= 0 || Tn <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype_a, dtype_x, [&](auto ta, auto tx) {
    return launch<decltype(ta), decltype(tx), false>(
        a, x, nullptr, h, nullptr, vals, flags, R, Tn, C, st);
  });
}

// (da, dx) of h = scan(a, x) for the cotangent g: da in a's dtype, dx in
// g's (= h's = x's) dtype.  Scratch as above, with the backward's L.
int gated_linear_scan_bwd_launch(const void* a, const void* h, const void* g,
                                 void* da, void* dx, void* vals, void* flags,
                                 int R, int Tn, int C, int dtype_a,
                                 int dtype_x, void* stream) {
  if (R <= 0 || Tn <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(dtype_a, dtype_x, [&](auto ta, auto tx) {
    return launch<decltype(ta), decltype(tx), true>(a, g, h, dx, da, vals,
                                                    flags, R, Tn, C, st);
  });
}

// The tiling of one instantiation: {chunk steps L, channels per block,
// threads per block, dynamic shared memory bytes, resident blocks per SM}.
int gated_linear_scan_config(int dtype_a, int dtype_x, int backward,
                             int* out) {
  auto f = [&](auto ta, auto tx) {
    return backward ? config<decltype(ta), decltype(tx), true>(out)
                    : config<decltype(ta), decltype(tx), false>(out);
  };
  return dispatch(dtype_a, dtype_x, f);
}

}  // extern "C"
