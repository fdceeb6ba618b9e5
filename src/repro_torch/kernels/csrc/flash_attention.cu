// Flash-attention forward for Hopper: softmax(q k^T / sqrt(D) + mask) v
// with an online softmax, so the (S, T) score matrix never reaches HBM.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_fwd, body _attn_kernel), wired into the self-attention of
// every UViT and Hunyuan-DiT block, Hunyuan-DiT's cross-attention over
// the text tokens, the SDv2 UNet's self- and cross-attention, the decoder
// LMs', whisper's and Zamba2's attention (models/layers.py::apply_attention
// with use_flash), and their attention over a KV cache at prefill and at
// every decode step (apply_attention with a cache).
//
// A KV cache is read in place: k and v are the whole (B, Tk, Hkv, D)
// cache, of which the first kv_len rows hold keys, and query row r sits at
// position q_off + r (the JAX attention's q_offset and kv_valid_len).  The
// key loop stops at kv_len; keys past it are masked, so the rows of the
// cache not yet written are never summed.  At a decode step S = 1: one
// query row of a 64-row tile works and each of a KV head's Hq / Hkv query
// heads reads the cache again (a decode kernel's design is later work).
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
// What bounds it on an H100: at Hunyuan-DiT self-attention (S = T = 1024,
// D = 128) one (b, h) pair does 4*S*T*D operations on 4*S*D bf16 elements,
// ~500 operations per byte, above the bf16 ridge (~295 op/B): the tensor
// cores bound it.  At UViT-H's S = T = 258, at the cross-attention's
// T = 77 and at every SDv2 UNet shape the bytes do: there one (b, h) pair
// does S*T*D*4 operations on 2*(S + T)*D*2 bytes, S*T/(S + T) op/B, at
// most 128 at S = T = 256 (D = 112, B = 16, H = 8: 29.4 MB of Q, K, V
// and O, 0.0088 ms at 3.35 TB/s; D = 224, S = T = 64: 14.7 MB, 0.0044 ms).
// What the design does about it: TMA brings Q once and K and V once per
// 64-query tile (the repeats hit L2: K and V of one (b, h) are 115 KB at
// D = 112), O is written once, and the (S, T) scores stay in registers;
// what is left is latency (a 64-query tile walks at most 4 K/V tiles at
// the UNet's shapes), not bandwidth.
//
// Two routes, a pure function of (dtype, D) (flash_route in ops.py):
//
// - bf16 at D in {64, 80, 112, 128, 224}: tensor cores.  One block per (b*h,
//   64-query tile): one consumer warpgroup and one producer warp.  Q, K
//   and V come in by TMA through 4-D tensor maps over (B, S|T, H, D),
//   128-byte swizzled, the head as 64-column boxes; K/V tiles of 64 keys
//   run through a 2-slot mbarrier ring, so the next tile loads while this
//   one is computed.  S = Q K^T is wgmma m64n64k16 from shared memory (K is
//   K-major: D is contiguous), D/16 k-steps.  The online softmax runs in
//   fp32 registers on the accumulator, in base 2 with log2(e) folded into
//   the scale (1/sqrt(D) of the true head dim).  P is rounded to bf16 in
//   registers and fed as wgmma's register A operand (one k16 column slice
//   of the S accumulator is exactly the A fragment), so P never touches
//   shared memory; V (T x D, D contiguous) is N-major and read through the
//   transpose bit; O accumulates in fp32.  Rounding P to bf16 is the one
//   numeric change from the Pallas body, which multiplies P V in fp32.
//   The SDv2 UNet's heads, 112 (896 / 8) and 224 (1792 / 8), and the
//   80-wide heads of zamba2-2.7b's shared attention and h2o-danube-1.8b
//   are padded in shared memory to whole boxes, DP = 128 and 256: the box
//   at column 64 (or 192) runs past the tensor's inner dimension D and TMA
//   fills the columns past D with zeros (and counts them in the barrier's
//   bytes).  Rows past S (a decode step's S = 1) are zero-filled the same
//   way and never stored.
//   Q K^T stops at D; P V computes DP columns, those past D zero, and the
//   epilogue stores only d < D (at D = 112 columns 112-127 of head h would
//   be columns 0-15 of head h + 1).  Shared memory: 83 KB at DP = 128
//   (2 blocks an SM, as at 128), 161 KB at DP = 256 (1 block an SM, with
//   up to 255 registers a thread for the 128-register O accumulator); at
//   the UNet's D = 224 shapes the grid is B*H = 128 blocks, under 132 SMs,
//   so a second resident block (32-key tiles would fit two) would find
//   nothing to run.  ptxas: 139 registers at D = 112 (as at 128), 200 at
//   224, no spills.  The last box runs a full n64 P V, its pad columns
//   zero: n48/n32 tails would save 1/8 of P V's work, under the noise of
//   a latency-bound tile.
// - fp32 at any D, and bf16 at D in {8, 16, 32} (the small test configs):
//   SIMT.  One block per (b*h, 16-query tile); 4 warps x 4 query rows;
//   K/V tiles of 32 keys staged in dynamic shared memory as fp32 (72 KB at
//   D = 224, past the 48 KB static limit); lane j scores key j and lanes
//   split the output dims for the P.V update, ceil(D / 32) each, those
//   past D masked (at D = 112 lanes 16-31 hold no fourth dim).  fp32 stays
//   off the tensor cores: TF32 would keep ~3 digits.
//
// Both routes skip the K/V tiles their causal/window mask hides entirely,
// mask inside the rest, and keep the running max and sum in fp32.
//
// Plain C interface, loaded with ctypes (see kernels/build.py); the launch
// runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NWARP = 4;           // warps per block
constexpr int ROWS = 4;            // query rows per warp
constexpr int BQ = NWARP * ROWS;   // query rows per block
constexpr int BKV = 32;            // keys per K/V tile (one per lane)

// the SIMT kernel's shared memory at head dim DH: the scaled Q tile and the
// K and V tiles in fp32, rows padded by one word
template <int DH>
struct SimtSmem {
  static constexpr int BYTES = (BQ * DH + 2 * BKV * (DH + 1)) * 4;
};

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
                 int q_off, int kv_len, float scale) {
  constexpr int DPL = (DH + 31) / 32;   // output dims per lane
  // dynamic shared memory (SimtSmem<DH>): at DH = 224 the tiles take 72 KB,
  // over the 48 KB a static array may hold
  extern __shared__ float simt_smem[];
  float(*qs)[DH] = reinterpret_cast<float(*)[DH]>(simt_smem);
  // +1: lane j reads row j conflict-free
  float(*ks)[DH + 1] = reinterpret_cast<float(*)[DH + 1]>(simt_smem + BQ * DH);
  float(*vs)[DH + 1] = ks + BKV;

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

  // keys any row of this block can see: none at or past kv_len; causal
  // stops at the last row, a window starts after the first row's horizon
  // (row r sits at position q_off + r)
  int kv_hi = kv_len;
  if (causal) kv_hi = min(kv_len, q_off + q0 + BQ);
  int kv_lo = 0;
  if (has_window) kv_lo = max(0, q_off + q0 - window + 1);
  kv_lo = (kv_lo / BKV) * BKV;

  for (int kt = kv_lo; kt < kv_hi; kt += BKV) {
    __syncthreads();   // previous tile fully consumed (and qs written)
    for (int e = tid; e < BKV * DH; e += NWARP * 32) {
      const int j = e / DH, d = e % DH, kj = kt + j;
      const bool in = kj < kv_len;
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
      const int qpos = q_off + q0 + warp * ROWS + r;
      const bool valid = kj < kv_len && (!causal || kj <= qpos) &&
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
    const int row = q0 + warp * ROWS + r;
    if (row >= S) continue;
    const float inv = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int d = lane + 32 * c;
      if (d < DH)
        o[(((size_t)b * S + row) * Hq + hq) * DH + d] =
            from_f<T>(acc[r][c] * inv);
    }
  }
}

// ------------------------------------------- bf16 tensor-core route
constexpr int FBQ = 64;          // query rows per block: one m64 warpgroup
constexpr int FBKV = 64;         // keys per K/V tile
constexpr int FSTAGES = 2;       // K/V ring slots
constexpr int FTHREADS = 160;    // consumer warpgroup + producer warp

// The tensor-core route's shared memory at head dim DH: a row is DP =
// 64 * ceil(DH / 64) columns, whole 64-column boxes, the columns past DH
// zero-filled by TMA (and counted in each box's bytes).
template <int DH>
struct FlashSmem {
  static constexpr int BOXES = (DH + 63) / 64;    // 64-column boxes a row
  static constexpr int DP = 64 * BOXES;           // padded head width
  static constexpr int Q_BYTES = FBQ * DP * 2;
  static constexpr int KV_BYTES = FBKV * DP * 2;  // one K or V tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int TOTAL =
      Q_BYTES + FSTAGES * STAGE_BYTES + (1 + 2 * FSTAGES) * 8 + 1024;
  // resident blocks an SM asks of the register allocator: 2 while two
  // blocks' shared memory fits in the SM's 228 KB (DP <= 128), else 1,
  // which lets a thread keep DP = 256's 128 fp32 O registers unspilled
  static constexpr int MIN_BLOCKS = 2 * TOTAL <= 228 * 1024 ? 2 : 1;
};

template <int DH>
__global__ void __launch_bounds__(FTHREADS, FlashSmem<DH>::MIN_BLOCKS)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ o, int S, int Hq,
                       int Hkv, int causal, int has_window, int window,
                       int q_off, int kv_len, float scale_log2) {
  using L = FlashSmem<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* skv = smem + L::Q_BYTES;   // slot i: K, then V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(skv + FSTAGES * L::STAGE_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + FSTAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / Hq, hq = bh % Hq;
  const int hk = hq / (Hq / Hkv);
  const int q0 = blockIdx.y * FBQ;

  // keys any row of this block can see (row r sits at q_off + r)
  int kv_hi = kv_len;
  if (causal) kv_hi = min(kv_len, q_off + q0 + FBQ);
  int kv_lo = 0;
  if (has_window) kv_lo = max(0, q_off + q0 - window + 1);
  kv_lo = (kv_lo / FBKV) * FBKV;
  const int n_t = kv_hi > kv_lo ? (kv_hi - kv_lo + FBKV - 1) / FBKV : 0;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int i = 0; i < FSTAGES; ++i) {
      hopper::mbar_init(&full[i], 1);
      hopper::mbar_init(&empty[i], 4);   // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q once, then K/V tiles through the ring
    if (lane == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < L::BOXES; ++c)
        hopper::tma_load_4d(sq + c * FBQ * 128, &tm_q, q_full, c * 64, hq, q0,
                            b);
      for (int it = 0; it < n_t; ++it) {
        const int st = it % FSTAGES;
        hopper::mbar_wait(&empty[st], ((it / FSTAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], L::STAGE_BYTES);
        const int kt = kv_lo + it * FBKV;
        uint8_t* kb = skv + st * L::STAGE_BYTES;
        for (int c = 0; c < L::BOXES; ++c) {
          hopper::tma_load_4d(kb + c * FBKV * 128, &tm_k, &full[st], c * 64,
                              hk, kt, b);
          hopper::tma_load_4d(kb + L::KV_BYTES + c * FBKV * 128, &tm_v,
                              &full[st], c * 64, hk, kt, b);
        }
      }
    }
    return;
  }

  // consumer warpgroup: thread owns rows r_lo and r_lo + 8 of the tile
  const int r_lo = 16 * warp + lane / 4;
  float oacc[L::BOXES][32];
#pragma unroll
  for (int h = 0; h < L::BOXES; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[h][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  hopper::mbar_wait(q_full, 0);
  for (int it = 0; it < n_t; ++it) {
    const int st = it % FSTAGES;
    hopper::mbar_wait(&full[st], (it / FSTAGES) & 1);
    const uint8_t* kb = skv + st * L::STAGE_BYTES;
    const uint8_t* vb = kb + L::KV_BYTES;

    // S = Q K^T over D, 64 x 64 fp32: DH / 16 k-steps, four to a box (the
    // zero pad columns past DH need no step)
    float sacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::wgmma_m64n64k16_ss<0>(
          sacc, hopper::desc_sw128(sq + (kk / 4) * FBQ * 128 + (kk % 4) * 32),
          hopper::desc_sw128(kb + (kk / 4) * FBKV * 128 + (kk % 4) * 32));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();

    // mask and scale (base 2), then the online softmax per row
    const int kt = kv_lo + it * FBKV;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = kt + 8 * j + 2 * (lane % 4) + (i & 1);
        const int qpos = q_off + q0 + r_lo + 8 * (i >> 1);
        const bool valid = key < kv_len && (!causal || key <= qpos) &&
                           (!has_window || key > qpos - window);
        const float x = valid ? sacc[4 * j + i] * scale_log2 : -INFINITY;
        sacc[4 * j + i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    float alpha[2], m_use[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // m_new = -inf: no key seen yet by this row (oacc and l still zero)
      alpha[r] = m_new == -INFINITY ? 1.0f : exp2f(m[r] - m_new);
      m_use[r] = m_new == -INFINITY ? 0.0f : m_new;
      m[r] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      const float p = exp2f(sacc[i] - m_use[r]);
      sacc[i] = p;
      ls[r] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + ls[r];
#pragma unroll
    for (int h = 0; h < L::BOXES; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[h][i] *= alpha[(i >> 1) & 1];

    // P (bf16, registers) as the A operand of O += P V
    uint32_t pa[FBKV / 16][4];
#pragma unroll
    for (int c = 0; c < FBKV / 16; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[c][e] = hopper::pack_bf16(sacc[8 * c + 2 * e],
                                     sacc[8 * c + 2 * e + 1]);
    hopper::wgmma_fence();
#pragma unroll
    for (int c = 0; c < FBKV / 16; ++c)
#pragma unroll
      for (int h = 0; h < L::BOXES; ++h)
        hopper::wgmma_m64n64k16_rs<1>(
            oacc[h], pa[c],
            hopper::desc_sw128(vb + h * FBKV * 128 + c * 2048));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    if (lane == 0) hopper::mbar_arrive(&empty[st]);
  }

  // epilogue: a row that saw no key writes zeros; the pad columns past DH
  // are never stored (DH is even, so a bf16 pair never straddles DH)
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r_lo + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* orow = o + (((size_t)b * S + row) * Hq + hq) * DH;
#pragma unroll
    for (int h = 0; h < L::BOXES; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = h * 64 + 8 * j + 2 * (lane % 4);
        if (d < DH)
          *reinterpret_cast<__nv_bfloat162*>(orow + d) =
              __floats2bfloat162_rn(oacc[h][4 * j + 2 * r] * inv[r],
                                    oacc[h][4 * j + 2 * r + 1] * inv[r]);
      }
  }
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int Tk, int Hq, int Hkv, int causal, int has_window,
                 int window, int q_off, int kv_len, float scale,
                 cudaStream_t st) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return (int)cudaErrorInvalidValue;   // TMA needs 16-byte-aligned bases
  using L = FlashSmem<DH>;
  CUtensorMap tq, tk, tv;
  const uint64_t dq[4] = {DH, (uint64_t)Hq, (uint64_t)S, (uint64_t)B};
  const uint64_t sq[3] = {DH * 2, (uint64_t)Hq * DH * 2,
                          (uint64_t)S * Hq * DH * 2};
  const uint32_t bq[4] = {64, 1, FBQ, 1};
  const uint64_t dk[4] = {DH, (uint64_t)Hkv, (uint64_t)Tk, (uint64_t)B};
  const uint64_t sk[3] = {DH * 2, (uint64_t)Hkv * DH * 2,
                          (uint64_t)Tk * Hkv * DH * 2};
  const uint32_t bk[4] = {64, 1, FBKV, 1};
  int err;
  if ((err = hopper::make_tma_bf16(&tq, q, 4, dq, sq, bq)) ||
      (err = hopper::make_tma_bf16(&tk, k, 4, dk, sk, bk)) ||
      (err = hopper::make_tma_bf16(&tv, v, 4, dk, sk, bk)))
    return err;
  static std::atomic<uint64_t> opted{0};
  cudaError_t e = hopper::opt_in_smem(
      opted, (const void*)flash_fwd_wgmma_kernel<DH>, L::TOTAL);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * Hq, (S + FBQ - 1) / FBQ);
  flash_fwd_wgmma_kernel<DH><<<grid, FTHREADS, L::TOTAL, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, causal,
      has_window, window, q_off, kv_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- SIMT launch
template <int DH, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int Tk, int Hq, int Hkv, int causal, int has_window,
           int window, int q_off, int kv_len, float scale, cudaStream_t st) {
  constexpr int smem = SimtSmem<DH>::BYTES;
  if constexpr (smem > 48 * 1024) {
    // past 48 KB a kernel must opt in
    static std::atomic<uint64_t> opted{0};
    cudaError_t e = hopper::opt_in_smem(
        opted, (const void*)flash_fwd_kernel<DH, T>, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_fwd_kernel<DH, T><<<grid, NWARP * 32, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, Hq, Hkv, causal,
      has_window, window, q_off, kv_len, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(int D, const void* q, const void* k, const void* v, void* o,
              int B, int S, int Tk, int Hq, int Hkv, int causal,
              int has_window, int window, int q_off, int kv_len, float scale,
              cudaStream_t st) {
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
#define PULSE_SIMT(DH)                                                  \
  return launch<DH, T>(q, k, v, o, B, S, Tk, Hq, Hkv, causal, has_window, \
                       window, q_off, kv_len, scale, st)
// bf16 takes the tensor-core route at these head dims, fp32 the SIMT one
#define PULSE_BOTH(DH)                                                  \
  if constexpr (bf16)                                                   \
    return launch_wgmma<DH>(q, k, v, o, B, S, Tk, Hq, Hkv, causal,      \
                            has_window, window, q_off, kv_len, scale, st); \
  else                                                                  \
    PULSE_SIMT(DH)
  switch (D) {
    case 8: PULSE_SIMT(8);
    case 16: PULSE_SIMT(16);
    case 32: PULSE_SIMT(32);
    case 64: PULSE_BOTH(64);
    case 80: PULSE_BOTH(80);
    case 112: PULSE_BOTH(112);
    case 128: PULSE_BOTH(128);
    case 224: PULSE_BOTH(224);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PULSE_BOTH
#undef PULSE_SIMT
}

template <int DH>
int wgmma_config(int* out) {
  using L = FlashSmem<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::TOTAL);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, flash_fwd_wgmma_kernel<DH>, FTHREADS, L::TOTAL);
  const int v[6] = {FBQ, FBKV, FSTAGES, FTHREADS, L::TOTAL, blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)e;
}

}  // namespace

extern "C" {

const char* pulse_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = float32, 1 = bfloat16.  D in {8, 16, 32, 64, 80, 112, 128,
// 224}; Hq % Hkv == 0.  k and v are (B, Tk, Hkv, D), of which the first
// kv_len rows (0 < kv_len <= Tk) hold keys: a KV cache of Tk rows is read
// in place.  Query row r sits at position q_off + r (q_off >= 0).  bf16 at
// D = 64, 80, 112, 128 or 224 takes the tensor-core route and needs
// 16-byte-aligned pointers (else cudaErrorInvalidValue).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int Tk, int Hq,
                               int Hkv, int D, int causal, int has_window,
                               int window, int q_off, int kv_len, float scale,
                               int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Tk <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      q_off < 0 || kv_len <= 0 || kv_len > Tk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(D, q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                            has_window, window, q_off, kv_len, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(D, q, k, v, o, B, S, Tk, Hq, Hkv, causal,
                                    has_window, window, q_off, kv_len, scale,
                                    st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 tensor-core route's tiling at head dim D (64, 80, 112, 128 or
// 224): {query rows, keys per tile, ring slots, threads per block, dynamic
// shared memory bytes, resident blocks per SM}.
int flash_attention_bf16_config(int D, int* out) {
  switch (D) {
    case 64: return wgmma_config<64>(out);
    case 80: return wgmma_config<80>(out);
    case 112: return wgmma_config<112>(out);
    case 128: return wgmma_config<128>(out);
    case 224: return wgmma_config<224>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
