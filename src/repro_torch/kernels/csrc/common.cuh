// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// dtype codes passed from Python (kernels/paged_attention.py)
enum QDtype { Q_F32 = 0, Q_BF16 = 1 };
// KV pool element kinds: fp pools in f32 or bf16, int8 codes with a
// per-position scale, or the sc coarse code + residual + scale
enum KvKind { KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2, KV_SC = 3 };

constexpr int SC_SHIFT = 4;            // core/kv_quant.py
constexpr float NEG_BIG = -1e30f;      // the reference's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// One element of a K or V pool as float, dequantized exactly as
// core/kv_quant.kv_dequant: int8 -> code * scale; sc -> (resid + code *
// 2^SC_SHIFT) * (scale * 2^-SC_SHIFT).  `e` indexes the (N, page, Hkv, D)
// pool, `si` the parallel (N, page, Hkv) scale pool.
template <int KIND>
__device__ __forceinline__ float kv_value(const void* pool,
                                          const float* scale,
                                          const int8_t* resid, size_t e,
                                          size_t si) {
  if constexpr (KIND == KV_F32) {
    return static_cast<const float*>(pool)[e];
  } else if constexpr (KIND == KV_BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[e]);
  } else if constexpr (KIND == KV_INT8) {
    return static_cast<float>(static_cast<const int8_t*>(pool)[e]) *
           scale[si];
  } else {
    const int fused = static_cast<int>(resid[e]) +
                      static_cast<int>(static_cast<const int8_t*>(pool)[e]) *
                          (1 << SC_SHIFT);
    return static_cast<float>(fused) * (scale[si] * (1.0f / (1 << SC_SHIFT)));
  }
}

// Record why an entry point refuses its arguments (printf-style, read by
// repro_kernels_error_string) and return cudaErrorInvalidValue (errors.cu).
int refuse(const char* fmt, ...) __attribute__((format(printf, 1, 2)));

// Dynamic shared memory one H100 block can have.
constexpr size_t SMEM_CAP = 227 * 1024;

// A launch's geometry.  Each launcher computes it in one function that
// its launch uses and that its `*_geometry` entry point reports, so the
// Python plans (kernels/plan.py) can be held equal to what launches.
// `kernel` names the kernel instance the launcher picked (each launcher
// documents its codes); a grid of zeros means nothing is launched.
struct Geometry {
  long long kernel = 0;
  long long grid[3] = {0, 0, 0};   // blocks (x, y, z)
  long long threads = 0;           // threads a block
  long long smem = 0;              // dynamic shared memory a block, bytes
  long long splits = 1;            // splits of the work whose partials
                                   // are merged (paged) or summed (K)
  long long per_split = 0;         // K groups / slices a split covers
  long long block = 0;             // rows a block, where that is a knob
  long long combine_grid = 0;      // blocks of the merge launch, 0: none
  long long combine_threads = 0;
};
constexpr int GEOMETRY_FIELDS = 11;

// The fields in declaration order, as the `*_geometry` entry points
// write them (kernels/plan.GEOMETRY_FIELDS).
inline void write_geometry(const Geometry& g, long long* out) {
  const long long v[GEOMETRY_FIELDS] = {
      g.kernel, g.grid[0], g.grid[1], g.grid[2], g.threads, g.smem,
      g.splits, g.per_split, g.block, g.combine_grid, g.combine_threads};
  for (int i = 0; i < GEOMETRY_FIELDS; ++i) out[i] = v[i];
}

// Raise kernel `name`'s dynamic shared-memory cap when it needs more than
// the default 48 KB, or refuse a layout above SMEM_CAP; returns the CUDA
// error code (0 on success).
template <typename Kernel>
inline int prepare_smem(Kernel kernel, size_t bytes, const char* name) {
  if (bytes > SMEM_CAP) {
    return refuse("%s needs %zu bytes of shared memory per block, above "
                  "the %zu a block can have", name, bytes, SMEM_CAP);
  }
  if (bytes > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Hopper building blocks of the tensor-core kernels (flash_attention.cu,
// paged_attention.cu): async copies, ldmatrix, mma.sync, ex2, bf16 split
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled (nothing read) when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared (through L1), zero-filled when !in
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, float32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as bf16 pairs hi = bf16(x, y) and lo = bf16(residuals); x in the
// low half, as the mma fragments hold the lower column there
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// split_bf16's numbers in fewer instructions: the hi halves back as
// float32 by a shift and a mask (a bf16 is the top 16 bits of the float32
// it stands for).  The wgmma kernels' form; the mma.sync paged prefill
// kernel keeps split_bf16, with which it uses no local memory at D 64.
__device__ __forceinline__ void wg_split(float x, float y, uint32_t& hi,
                                         uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x - __uint_as_float(hi << 16), y - __uint_as_float(hi & 0xffff0000u));
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// Hopper's asynchronous units (ternary_matmul.cu, flash_attention.cu,
// paged_attention.cu): wgmma's ordering, mbarriers, TMA, register
// rebalancing
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin wgmma's accumulators at this point of the program: no read of them
// is moved above the wait that precedes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// generic-proxy shared-memory writes, made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, layout (1: 128B swizzle, 2: 64B, 3: 32B)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// d (64 x 64 float32, the warpgroup's fragments) (+)= a (64 x 16) *
// b (16 x 64), both bf16 K-major in shared memory; d is overwritten when
// `accumulate` is 0
__device__ __forceinline__ void wgmma_n64_ss(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 float32) += a (64 x 16 bf16, this thread's A fragment in
// registers) * b (16 x 64 bf16, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// a TMA box of a rank-4 tensor map (coordinates innermost first) into
// shared memory; its bytes count against `bar`'s expected transactions
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
// named barrier `id` (1..15; 0 is __syncthreads) of `threads` threads:
// wait there, or arrive without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// TMA tensor maps, built on the host (tensor_map.cu)
// ---------------------------------------------------------------------------

// A rank-4 tensor map over `base` (dims and box innermost first, strides
// in bytes of dims 1..3), zero-filling boxes past the dims, from
// cuTensorMapEncodeTiled looked up through the CUDA runtime (nothing links
// against libcuda), encoded anew on every call (a few maps a launch; see
// tensor_map.cu for its host cost).  Returns 0 or refuses, naming `who`.
int tensor_map_4d(CUtensorMap* map, const char* who, CUtensorMapDataType type,
                  const void* base, const cuuint64_t (&dims)[4],
                  const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4],
                  CUtensorMapSwizzle swizzle);
