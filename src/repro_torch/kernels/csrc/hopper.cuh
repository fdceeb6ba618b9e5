// Hopper (sm_90a) primitives shared by the kernels of the port: mbarriers,
// TMA tile loads, wgmma shared-memory descriptors for the 128-byte swizzle,
// wgmma fences, and the m64nNk16 bf16 wgmma issue wrappers.
//
// Included by skip_matmul.cu, flash_attention.cu and linear_scan.cu (each
// is built into its own shared library with a plain C interface; see
// kernels/build.py, whose source hash covers this header).
//
// Tensor maps are encoded on the host inside each C launch function, from
// the raw pointers and strides, through cuTensorMapEncodeTiled fetched with
// cudaGetDriverEntryPoint: no -lcuda at link time and no change to the
// ctypes signatures.
//
// Shared-memory tiles that wgmma reads are laid out exactly as TMA writes
// them with CU_TENSOR_MAP_SWIZZLE_128B: rows of 128 bytes (64 bf16), the
// 16-byte chunks of row r XOR-ed with r % 8, in 1024-byte atoms of 8 rows.
// Every tile base is 1024-byte aligned, so the descriptor's base offset is 0.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace hopper {

// ------------------------------------------------------------------ basics

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two fp32 values as one register of two bf16, x in the low half (the
// lower column index of a wgmma A fragment).
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ----------------------------------------------------- launch-time set-up

// Opts ``kernel`` into ``bytes`` of dynamic shared memory, once per device:
// the attribute holds for the device's context, so a later launch only
// reads the bit of its device in ``done``, a flag word that each launch
// function keeps as its own static.  Devices past 63 set it every time.
inline cudaError_t opt_in_smem(std::atomic<uint64_t>& done,
                               const void* kernel, int bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return e;
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA) and to
// the other threads; follow it with __syncthreads().
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces ``bytes`` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Whether the phase of parity ``parity`` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Spin until the phase of parity ``parity`` has completed.  A fresh
// barrier is in phase 0: waiting with parity 1 passes at once (the
// producer's first wait on an empty slot), with parity 0 it blocks until
// the first phase completes.  A wait that lasts more than 10 s (a ring
// that can never fill: a fault, not a slow tile) traps, so the launch fails
// with an error instead of hanging the card.
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done, spins = 0;
  uint64_t t0 = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (!done && (++spins & 0xFFFF) == 0) {
      const uint64_t t = globaltimer_ns();
      if (t0 == 0) t0 = t;
      else if (t - t0 > 10000000000ull) __trap();
    }
  } while (!done);
}

// --------------------------------------------------------------------- TMA
// One thread asks for a whole box; the copy reports its bytes to ``bar``.
// Coordinates are in elements, innermost dimension first.  Elements of the
// box outside the tensor are written as zeros and still counted.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Host side: a tensor map of element type ``dtype`` and ``swizzle``.
// ``dims`` and ``box`` innermost first; ``strides_bytes`` are the rank - 1
// outer strides.  Returns 0 or a CUDA error code.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn lookup_encode_tiled() {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                          cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess
             ? reinterpret_cast<EncodeTiledFn>(p)
             : nullptr;
}

// one process-wide lookup (the driver's entry point is the same for every
// device); a function-local static initialises once, thread-safely
inline EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = lookup_encode_tiled();
  return fn;
}

inline int make_tma(CUtensorMap* map, CUtensorMapDataType dtype,
                    const void* base, int rank, const uint64_t* dims,
                    const uint64_t* strides_bytes, const uint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], es[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    es[i] = 1;
    if (i + 1 < rank) st[i] = strides_bytes[i];
  }
  CUresult r = fn(map, dtype, (cuuint32_t)rank, const_cast<void*>(base), d,
                  st, bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// a bf16 tensor map with a 128-byte swizzle, as wgmma reads its tiles
inline int make_tma_bf16(CUtensorMap* map, const void* base, int rank,
                         const uint64_t* dims, const uint64_t* strides_bytes,
                         const uint32_t* box) {
  return make_tma(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims,
                  strides_bytes, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// ------------------------------------------------------------------- wgmma
// Shared-memory matrix descriptor for a tile in the 128-byte swizzle:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128B swizzle) in bits 62-63.
//
// K-major operand (K contiguous; rows of 64 bf16 = 128 bytes): the stride
// byte offset is 1024, the step between 8-row groups; the leading offset is
// unused.  A k16 slice within a 64-wide row starts 32 bytes further.
//
// MN-major operand (M or N contiguous, used with the transpose bit): each
// k row holds 64 MN values in 128 bytes, 8 k rows make a 1024-byte atom and
// the atoms of successive k groups are 1024 bytes apart.  Both offsets are
// set to 1024: with one 64-wide MN chunk per instruction (n64) the chunk
// stride is never used, so the descriptor is right whichever of the two
// fields the hardware reads as the k-group stride.  A k16 slice starts 16
// rows (2048 bytes) further.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Accumulator layout of m64nNk16 (fp32), thread t of the warpgroup:
// warp w = t / 32, lane l = t % 32; d[4j + i] holds row 16w + l/4 + 8*(i/2),
// column 8j + 2*(l%4) + i%2, for j in [0, N/8).
#define HOPPER_ACC32(d)                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31])

#define HOPPER_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// The accumulate flag (scale-d) is a predicate set true: callers zero the
// accumulator themselves.
//
// d (64 x 64, fp32) += A (64 x 16, smem, K-major) * B (16 x 64, smem;
// K-major if TransB = 0, N-major if TransB = 1).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_ACC32(d)
      : "l"(da), "l"(db), "r"(1), "n"(TransB));
}

// d (64 x 64, fp32) += A (64 x 16, registers: the bf16 A fragment) *
// B (16 x 64, smem; TransB as above).  The A fragment of thread t is the
// accumulator layout of one 16-column slice of an m64 result: a[0] packs
// (row r, cols c, c+1), a[1] (r + 8, c, c+1), a[2] (r, c+8, c+9),
// a[3] (r + 8, c+8, c+9), with r = 16w + l/4 and c = 2*(l%4).
template <int TransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
        "n"(TransB));
}

#undef HOPPER_D32
#undef HOPPER_ACC32

}  // namespace hopper
