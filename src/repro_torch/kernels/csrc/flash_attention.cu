// Flash attention forward (causal or bidirectional GQA) for Hopper
// (sm_90a), with the per-row log-sum-exp the backward reads.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_kernel)
// with its numerics: logits = q . k in float32, scaled by `scale`
// (1/sqrt(D) unless the caller pre-scaled q), causal positions
// k_col > q_row masked, an online softmax (m, l, acc) in float32 over key
// tiles, output acc / max(l, 1e-30) cast to q's dtype; lse = m + log(l)
// per row.
//
// What bounds it: operations.  At the training shape (B 2, S 4096, 32 q
// heads, D 64) a call does 2 * 2 * B*Hq * S^2/2 * D = 137 GFLOP against
// 0.17 GB of q, k, v, o and lse, far above the H100's 295 flop/byte
// balance point, so the kernel is as fast as its two products and the
// softmax between them.  Three kernels, by dtype and head width
// (flash_geometry):
//
// bfloat16 at D 64, 80 and 128: flash_fwd_wgmma_kernel, warp-specialised.
// - A block of 384 threads owns 128 query rows of one (batch, q head);
//   q tiles are scheduled longest first.  Warpgroup 2 is the producer:
//   it gives its registers away (setmaxnreg 24) and one of its threads
//   issues every TMA load, the q tile once, then 128-key K and V tiles
//   into a ring of three stages, each with a full barrier for K, one for
//   V and an empty barrier that the consumers' 256 threads arrive at.
//   Warpgroups 0 and 1 are the consumers (setmaxnreg 240), 64 query rows
//   each.  They take turns at the tensor cores over two named barriers:
//   one issues P V of tile t and q K^T of tile t + 1 while the other runs
//   its softmax (ping-pong).  No wgmma sits in a runtime branch, or ptxas
//   serializes every wgmma of the kernel (C7520): the loop peels the first
//   q K^T and the last P V.
// - Tensor maps are rank 4 over (D, H, S, B), built on the host by
//   cuTensorMapEncodeTiled (tensor_map_4d, tensor_map.cu: found through
//   cudaGetDriverEntryPoint, so nothing links against libcuda), passed as
//   __grid_constant__ parameters.  TMA zero-fills rows past S inside each
//   batch, so a ragged tile reads no other row's data.  A row of a tile
//   lands as 64-column boxes in 128B swizzle (one at D 64, two at D 128);
//   hubert's D 80 adds a 16-column box in 32B swizzle, which wgmma reads
//   as a K-major (q, K) or MN-major (V) operand of its own: no padding, no
//   wasted products.
// - S = q K^T: wgmma m64n128k16, both operands K-major from shared
//   memory, float32 sums (products of bf16 values are exact, only the
//   order of the sums differs from the plain version's).
// - The online softmax runs on the accumulator registers, the row max
//   reduced over the quad with two shuffles.  The scale goes into the
//   exponent: p = 2^(c s - base), c = |scale| log2(e), base = c m, one FFMA
//   and one MUFU.EX2 a weight; a negative scale negates q in shared memory
//   once (exact in bf16), so the row max of the raw logits stays the max
//   of the scaled ones.  l sums the float32 weights; O is rescaled only
//   when some row max of the warp moved.  Only tiles that reach the causal
//   diagonal or the end of S are masked; tiles past the causal horizon are
//   never loaded.
// - O += P V: wgmma m64n64k16 (and m64n16k16 for D 80's last 16 columns)
//   with P as the A operand straight from the accumulator registers (the
//   C layout of S is the A layout of its 16-key slices) and V read
//   MN-major through the transpose bit.  P goes in as two bf16 terms, hi =
//   bf16(p) and lo = bf16(p - hi), two products into one accumulator: one
//   bf16 term (8 bits) moves O by up to 2^-9 of |v|, which at |o| >= 2
//   turns a bf16 output into its neighbour a whole ulp (1.6e-2) from the
//   plain version, above its 1e-2 tolerance; with the lo term P carries 16
//   bits.  fp16 P would need V in fp16 (which overflows above 65504) and
//   tf32 would need V transposed, so the kernel does 1.5x the bound's
//   products.  On the H100 its raw tensor rate (second product counted)
//   is SDPA's; the softmax is issue-bound (one consumer warp a scheduler),
//   so descriptors are built once and moved by adds, and the bf16 split
//   takes a shift and a mask (wg_split).
// - A row's arithmetic depends on its (batch, head), S, causal and scale
//   only: one block takes all of a row's keys, in key order.
//
// bfloat16 at D 16 and 32: flash_fwd_mma_kernel (mma.sync).  A block of
// 8 warps owns 128 query rows, 16 a warp; K and V reach shared memory
// through a ring of three 64-key tiles fed by cp.async, rows padded to
// D + 8 elements so every ldmatrix is free of bank conflicts; S = q k^T
// with mma.sync m16n8k16, the same online softmax and hi + lo P as above,
// V through ldmatrix.trans.
//
// float32: flash_fwd_kernel, float32 FMAs on the CUDA cores (the float32
// callers check the card against the CPU to 1e-5, which bf16 products
// would not meet): a block owns BQ = 64 query rows; two threads share a
// row, each holding it scaled in registers; per 64-key tile K and V are
// staged in shared memory and the tile's weights go through shared memory
// to the P.V loop.

#include <cuda.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// The weights' base for a row max m of raw logits, in log2 units: c m,
// rounded the same way for every tile (__fmul_rn: never fused into the
// subtraction that follows); 0 while the row has no key.
__device__ __forceinline__ float flash_base(float m, float c) {
  return m == -INFINITY ? 0.f : __fmul_rn(m, c);
}

// ---------------------------------------------------------------------------
// bfloat16 at D 64, 80, 128: warp-specialised wgmma + TMA kernel
// ---------------------------------------------------------------------------

constexpr int WG_CONSUMERS = 2;                // warpgroups of 64 q rows
constexpr int WG_BQ = 64 * WG_CONSUMERS;       // query rows per block
constexpr int WG_BK = 128;                     // keys per tile
constexpr int WG_STAGES = 3;                   // K / V tiles in the ring
constexpr int WG_THREADS = 128 * (WG_CONSUMERS + 1);
constexpr int WG_PRODUCER_REGS = 24;
constexpr int WG_CONSUMER_REGS = 240;

// Shared memory (from a 1024-byte aligned base): the q tile, then
// WG_STAGES x (K tile, V tile), then the barriers (q full, K full x
// stages, V full x stages, empty x stages).  A tile of R rows holds its
// 64-column boxes one after another (R x 128 bytes each, 128B swizzle),
// then at D 80 its 16-column box (R x 32 bytes, 32B swizzle); every box
// starts 1024-byte aligned, as the swizzles' phase needs.
template <int D>
struct WgLayout {
  static_assert(D == 64 || D == 80 || D == 128, "D must be 64, 80 or 128");
  static constexpr int N64 = D / 64;           // 64-column boxes
  static constexpr int N16 = D % 64 / 16;      // 16-column box (D 80)
  static constexpr int Q_BYTES = WG_BQ * D * 2;
  static constexpr int KV_BYTES = WG_BK * D * 2;   // one K or V tile
  static constexpr int BAR = Q_BYTES + 2 * WG_STAGES * KV_BYTES;
  static constexpr size_t BYTES = 1024 + BAR + 8 * (1 + 3 * WG_STAGES);
};

// d (64 x 128 float32, the warpgroup's fragments) (+)= a (64 x 16) *
// b (16 x 128), both bf16 K-major in shared memory; d is overwritten when
// `accumulate` is 0
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 16 float32) += a (64 x 16 bf16, this thread's A fragment in
// registers) * b (16 x 16 bf16, MN-major in shared memory: the transpose bit)
__device__ __forceinline__ void wgmma_n16_rs(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// The online softmax of one 64 x 128 tile of S, in two steps.
// wg_weights (MASK: the tile reaches the causal diagonal or the end of
// S): s[4 j + e] is row r_lo (+ 8 for e >= 2), key key0 + 8 j + 2 tq +
// (e & 1).  The row max of the raw logits, reduced over the quad; l moved
// to the new base (by corr = 2^(old - new)); the weights p = 2^(c s -
// base) in float32, in place of s and into l.
template <bool MASK>
__device__ __forceinline__ void wg_weights(float (&s)[64], float (&m_r)[2],
                                           float (&l_r)[2], float (&corr)[2],
                                           float c, int key0, int S,
                                           int causal, int r_lo, int tq) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int j = 0; j < WG_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK) {
        const int col = key0 + 8 * j + 2 * tq + (e & 1);
        if (col >= S || (causal && col > r_lo + 8 * (e >> 1)))
          s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = flash_base(mx[i], c);
    // before a row's first key l and O are 0: any finite factor will do
    corr[i] = m_r[i] == -INFINITY ? 1.f
                                  : ex2(flash_base(m_r[i], c) - base[i]);
    m_r[i] = mx[i];
    l_r[i] *= corr[i];
  }
#pragma unroll
  for (int j = 0; j < WG_BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], c, -base[e >> 1]));
      l_r[e >> 1] += s[4 * j + e];
    }
  }
}

// wg_pack, once the previous P V has landed: O moved to the new base
// (only when some row max of the warp moved), and the weights as bf16 hi
// + lo A fragments of 16 keys each (the C layout of S is the A layout of
// its 16-key slices)
template <int D>
__device__ __forceinline__ void wg_pack(const float (&s)[64],
                                        const float (&corr)[2],
                                        float (&o)[WgLayout<D>::N64][32],
                                        float (&o16)[8],
                                        uint32_t (&p_hi)[WG_BK / 16][4],
                                        uint32_t (&p_lo)[WG_BK / 16][4]) {
  using L = WgLayout<D>;
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int cc = 0; cc < L::N64; ++cc)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[cc][e] *= corr[(e >> 1) & 1];
#pragma unroll
    for (int e = 0; e < 8; ++e) o16[e] *= corr[(e >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < WG_BK / 16; ++kk) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {            // n8 blocks 2 kk, 2 kk + 1
      const float* sn = s + 4 * (2 * kk + hh);
      wg_split(sn[0], sn[1], p_hi[kk][2 * hh], p_lo[kk][2 * hh]);
      wg_split(sn[2], sn[3], p_hi[kk][2 * hh + 1], p_lo[kk][2 * hh + 1]);
    }
  }
}

// O += P V for the 16 keys kk of a stage's V tile: A is P's fragment, V
// is MN-major; dv / dv16 describe the tile's 64-column boxes (8-key groups
// 1024 bytes apart) and D 80's 16-column box (256 bytes apart).
// Descriptors move by adding the byte offset / 16 to their address field.
template <int D>
__device__ __forceinline__ void wg_pv(float (&o)[WgLayout<D>::N64][32],
                                      float (&o16)[8], const uint32_t (&a)[4],
                                      uint64_t dv, uint64_t dv16, int kk) {
  using L = WgLayout<D>;
#pragma unroll
  for (int cc = 0; cc < L::N64; ++cc)
    wgmma_n64_rs(o[cc], a, dv + ((cc * WG_BK * 128 + kk * 16 * 128) >> 4));
  if constexpr (L::N16 > 0) wgmma_n16_rs(o16, a, dv16 + ((kk * 16 * 32) >> 4));
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap q_tail,
                       const __grid_constant__ CUtensorMap k_tail,
                       const __grid_constant__ CUtensorMap v_tail,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int Hq, int Hkv,
                       float scale, int causal) {
  using L = WgLayout<D>;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t q_s = (smem_u32(wg_smem) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + L::Q_BYTES;
  const uint32_t q_full = q_s + L::BAR;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * WG_STAGES;
  const uint32_t empty = v_full + 8 * WG_STAGES;

  const int bh = blockIdx.x;                       // b * Hq + hq
  const int b = bh / Hq, hq = bh - b * Hq;
  const int h = hq / (Hq / Hkv);                   // its KV head
  const int qt = gridDim.y - 1 - blockIdx.y;       // longest tiles first
  const int row0 = qt * WG_BQ;
  const int k_end = causal ? min(S, row0 + WG_BQ) : S;
  const int n_tiles = (k_end + WG_BK - 1) / WG_BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 128 * WG_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == WG_CONSUMERS) {
    // the producer: one thread keeps the ring full
    setmaxnreg_dec<WG_PRODUCER_REGS>();
    if (threadIdx.x == 128 * WG_CONSUMERS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
#pragma unroll
      for (int c = 0; c < L::N64; ++c)
        tma_load_4d(q_s + c * WG_BQ * 128, &q_map, q_full, 64 * c, hq, row0,
                    b);
      if constexpr (L::N16 > 0)
        tma_load_4d(q_s + L::N64 * WG_BQ * 128, &q_tail, q_full,
                    64 * L::N64, hq, row0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % WG_STAGES;
        // the stage's tile t - WG_STAGES is consumed
        if (t >= WG_STAGES) mbar_wait(empty + 8 * st, (t / WG_STAGES - 1) & 1);
        const uint32_t kd = kv_s + st * 2 * L::KV_BYTES;
        const uint32_t vd = kd + L::KV_BYTES;
        const int key0 = t * WG_BK;
        mbar_expect_tx(k_full + 8 * st, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::N64; ++c)
          tma_load_4d(kd + c * WG_BK * 128, &k_map, k_full + 8 * st, 64 * c,
                      h, key0, b);
        if constexpr (L::N16 > 0)
          tma_load_4d(kd + L::N64 * WG_BK * 128, &k_tail, k_full + 8 * st,
                      64 * L::N64, h, key0, b);
        mbar_expect_tx(v_full + 8 * st, L::KV_BYTES);
#pragma unroll
        for (int c = 0; c < L::N64; ++c)
          tma_load_4d(vd + c * WG_BK * 128, &v_map, v_full + 8 * st, 64 * c,
                      h, key0, b);
        if constexpr (L::N16 > 0)
          tma_load_4d(vd + L::N64 * WG_BK * 128, &v_tail, v_full + 8 * st,
                      64 * L::N64, h, key0, b);
      }
    }
  } else {
    // a consumer: 64 query rows, 16 a warp
    setmaxnreg_inc<WG_CONSUMER_REGS>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tq = lane & 3;
    const int wrow0 = row0 + 64 * wg;              // the warpgroup's rows
    const int r_lo = wrow0 + 16 * warp + (lane >> 2);  // and r_lo + 8
    // this warpgroup's q rows: 8-row groups 1024 (32) bytes apart in the
    // 64-column boxes (the 16-column box)
    const uint32_t qa = q_s + wg * 64 * 128;
    const uint32_t qa16 = q_s + L::N64 * WG_BQ * 128 + wg * 64 * 32;
    mbar_wait(q_full, 0);
    if (scale < 0.f) {
      // -q against |scale|: each thread flips its 16-byte units of the
      // warpgroup's rows, then the warpgroup's wgmma may read them
      unsigned char* sp = wg_smem + (q_s - smem_u32(wg_smem));
      for (int i = tid; i < 64 * D / 8; i += 128) {
        const uint32_t off =
            i < L::N64 * 512
                ? (i / 512) * WG_BQ * 128 + wg * 64 * 128 + (i % 512) * 16
                : L::N64 * WG_BQ * 128 + wg * 64 * 32 + (i - L::N64 * 512) * 16;
        uint4* c4 = reinterpret_cast<uint4*>(sp + off);
        const uint4 x = *c4;
        *c4 = make_uint4(x.x ^ 0x80008000u, x.y ^ 0x80008000u,
                         x.z ^ 0x80008000u, x.w ^ 0x80008000u);
      }
      fence_async_smem();
      named_sync(1 + wg, 128);
    }

    float o[L::N64][32];
    float o16[8];                                  // D 80's last columns
#pragma unroll
    for (int cc = 0; cc < L::N64; ++cc)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[cc][e] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) o16[e] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};   // row max of the raw logits
    float l_r[2] = {0.f, 0.f};               // this thread's share of l
    const float c = fabsf(scale) * LOG2E;    // raw logits -> log2 units
    float s[64];                             // S of the tile in flight
    uint32_t p_hi[WG_BK / 16][4], p_lo[WG_BK / 16][4];

    // the operands' descriptors, built once: q's boxes, and stage 0's K
    // and V boxes (K-major: 8-row groups 1024 bytes apart in 128B swizzle,
    // 256 in 32B; V MN-major, as wg_pv)
    const uint64_t dq = wgmma_desc(qa, 16, 1024, 1);
    const uint64_t dq16 = wgmma_desc(qa16, 16, 256, 3);
    const uint64_t dk = wgmma_desc(kv_s, 16, 1024, 1);
    const uint64_t dk16 =
        wgmma_desc(kv_s + L::N64 * WG_BK * 128, 16, 256, 3);
    const uint64_t dv = wgmma_desc(kv_s + L::KV_BYTES, 1024, 1024, 1);
    const uint64_t dv16 = wgmma_desc(
        kv_s + L::KV_BYTES + L::N64 * WG_BK * 128, 256, 256, 3);
    // S = q K^T of tile t into s (the products issued, not awaited)
    auto issue_qk = [&](int t) {
      const uint32_t st = ((t % WG_STAGES) * 2 * L::KV_BYTES) >> 4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        if (ks < 4 * L::N64) {
          const uint32_t off = 32 * (ks % 4);
          wgmma_n128_ss(s, dq + (((ks / 4) * WG_BQ * 128 + off) >> 4),
                        dk + st + (((ks / 4) * WG_BK * 128 + off) >> 4),
                        ks > 0);
        } else {
          wgmma_n128_ss(s, dq16, dk16 + st, ks > 0);
        }
      }
    };
    float corr[2];
    // the weights of tile t's S (wg_weights)
    auto weights = [&](int t) {
      const int key0 = t * WG_BK;
      if (key0 + WG_BK > S || (causal && key0 + WG_BK - 1 > wrow0))
        wg_weights<true>(s, m_r, l_r, corr, c, key0, S, causal, r_lo, tq);
      else
        wg_weights<false>(s, m_r, l_r, corr, c, key0, S, causal, r_lo, tq);
    };

    // O += P V of tile t, the hi products then the lo ones
    auto issue_pv = [&](int t) {
      const uint32_t st = ((t % WG_STAGES) * 2 * L::KV_BYTES) >> 4;
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_pv<D>(o, o16, p_hi[kk], dv + st, dv16 + st, kk);
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
        wg_pv<D>(o, o16, p_lo[kk], dv + st, dv16 + st, kk);
    };
    // after a wait: the accumulators hold the products' sums
    auto landed = [&]() {
      fence_regs(s);
#pragma unroll
      for (int cc = 0; cc < L::N64; ++cc) fence_regs(o[cc]);
      if constexpr (L::N16 > 0) fence_regs(o16);
    };

    // The warpgroups take turns at the tensor cores (named barriers 3 and
    // 4): one issues P V of tile t and q K^T of tile t + 1 while the other
    // runs its softmax.  Warpgroup 1 lets warpgroup 0 go first; a
    // warpgroup hands the turn on after each of its issues but its last.
    // No wgmma sits in a branch (ptxas would serialize them all), so the
    // first q K^T and the last P V have steps of their own.
    const int turn = 3 + wg, other = 4 - wg;
    if (wg == 1) named_arrive(other, 256);
    mbar_wait(k_full, 0);
    named_sync(turn, 256);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    named_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(s);
    weights(0);
    wg_pack<D>(s, corr, o, o16, p_hi, p_lo);
    for (int t = 0; t < n_tiles - 1; ++t) {
      const int st = t % WG_STAGES;
      mbar_wait(v_full + 8 * st, (t / WG_STAGES) & 1);
      mbar_wait(k_full + 8 * ((t + 1) % WG_STAGES),
                ((t + 1) / WG_STAGES) & 1);
      named_sync(turn, 256);
      wgmma_fence();
      issue_pv(t);
      issue_qk(t + 1);
      wgmma_commit();
      named_arrive(other, 256);
      wgmma_wait<0>();
      landed();
      mbar_arrive(empty + 8 * st);             // K and V of stage st read
      weights(t + 1);
      wg_pack<D>(s, corr, o, o16, p_hi, p_lo);
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full + 8 * (last % WG_STAGES), (last / WG_STAGES) & 1);
    named_sync(turn, 256);
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    if (wg == 0) named_arrive(other, 256);
    wgmma_wait<0>();
    landed();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
      const int row = r_lo + 8 * i;
      if (row >= S) continue;
      const float lc = fmaxf(l_r[i], 1e-30f);
      __nv_bfloat16* op =
          out + ((static_cast<size_t>(b) * S + row) * Hq + hq) * D + 2 * tq;
#pragma unroll
      for (int cc = 0; cc < L::N64; ++cc)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(op + 64 * cc + 8 * j) =
              __floats2bfloat162_rn(o[cc][4 * j + 2 * i] / lc,
                                    o[cc][4 * j + 2 * i + 1] / lc);
#pragma unroll
      for (int j = 0; j < 2 * L::N16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(op + 64 * L::N64 + 8 * j) =
            __floats2bfloat162_rn(o16[4 * j + 2 * i] / lc,
                                  o16[4 * j + 2 * i + 1] / lc);
      if (tq == 0) {
        lse[static_cast<size_t>(bh) * S + row] =
            flash_base(m_r[i], c) * LN2 + logf(l_r[i]);
      }
    }
  }
}

// A bf16 (B, S, H, D) tensor as a rank-4 map over (D, H, S, B): boxes of
// `cols` columns x `rows` positions of one head, rows past S zero-filled
int tensor_map(CUtensorMap* map, const void* base, int B, int S, int H,
               int D, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(H) * D * 2,
                                 static_cast<cuuint64_t>(S) * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1,
                             static_cast<cuuint32_t>(rows), 1};
  return tensor_map_4d(map, "flash_attention",
                       CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides,
                       box, swizzle);
}

template <int D>
int launch_wgmma(const Geometry& g, const void* q, const void* k,
                 const void* v, void* out, float* lse, int B, int S, int Hq,
                 int Hkv, float scale, int causal, cudaStream_t stream) {
  using L = WgLayout<D>;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return refuse("flash_attention: bf16 q, k, v and out must be 16-byte "
                  "aligned");
  // q, k, v in 64-column boxes, then (D 80) 16-column ones; where D has
  // no 16-column box its maps are copies nothing reads
  CUtensorMap maps[6];
  const void* src[3] = {q, k, v};
  const int heads[3] = {Hq, Hkv, Hkv};
  const int rows[3] = {WG_BQ, WG_BK, WG_BK};
  for (int i = 0; i < 3; ++i) {
    if (int rc = tensor_map(&maps[i], src[i], B, S, heads[i], D, 64, rows[i],
                            CU_TENSOR_MAP_SWIZZLE_128B))
      return rc;
    if (L::N16 == 0) {
      maps[3 + i] = maps[i];
    } else if (int rc = tensor_map(&maps[3 + i], src[i], B, S, heads[i], D,
                                   16, rows[i], CU_TENSOR_MAP_SWIZZLE_32B)) {
      return rc;
    }
  }
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(flash_fwd_wgmma_kernel<D>, smem, "flash_attention");
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]));
  flash_fwd_wgmma_kernel<D><<<grid, static_cast<int>(g.threads), smem,
                              stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5],
      static_cast<__nv_bfloat16*>(out), lse, S, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16 at D 16, 32: mma.sync kernel
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_BQ = 16 * TC_WARPS;     // query rows per block
constexpr int TC_BK = 64;                // keys per tile
constexpr int TC_STAGES = 3;             // K/V tiles in the ring
constexpr int TC_THREADS = 32 * TC_WARPS;

// shared memory of the tensor-core kernel, in bf16 elements: the q tile,
// then TC_STAGES x (K tile, V tile); rows padded to D + 8 elements
// (a row is an odd number of 16-byte units, so the 8 rows an ldmatrix
// reads fall in 8 different bank groups)
template <int D>
struct TcLayout {
  static constexpr int STRIDE = D + 8;
  static constexpr int Q_ELEMS = TC_BQ * STRIDE;
  static constexpr int KV_ELEMS = TC_BK * STRIDE;
  static constexpr size_t BYTES =
      sizeof(__nv_bfloat16) *
      (static_cast<size_t>(Q_ELEMS) + 2 * TC_STAGES * KV_ELEMS);
};

// One 64-key tile of one warp's 16 rows: S = q k^T on the tensor cores,
// the online softmax on the accumulator fragments, O += P V.  MASK: the
// tile reaches the causal diagonal or the end of S.  This thread's rows
// are r_lo and r_lo + 8, its columns 2 tq, 2 tq + 1 of each n tile.
template <int D, bool MASK>
__device__ __forceinline__ void flash_tile(
    uint32_t q_base, float (&o)[D / 8][4], float (&m_r)[2], float (&l_r)[2],
    uint32_t k_base, uint32_t v_base, float c, int key0, int S, int causal,
    int r_lo, int tq) {
  constexpr int ST = TcLayout<D>::STRIDE;
  constexpr int NS = TC_BK / 8;            // n tiles of S
  float s[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t qf[4];                        // q's A fragment, k step ks
    ldsm_x4(qf, q_base + ks * 16 * 2);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t kf[4];
      ldsm_x4(kf, k_base + (np * 16 * ST + ks * 16) * 2);
      mma_bf16(s[2 * np], qf, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
    }
  }

  // mask, row max over the quad (of the raw logits: c > 0)
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (MASK) {
        const int col = key0 + n * 8 + 2 * tq + (e & 1);
        if (col >= S || (causal && col > r_lo + 8 * (e >> 1)))
          s[n][e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
  }
  // p = 2^(c s - base), base = c m rounded: one FFMA and one MUFU.EX2
  // per weight; l and O move to a new base by 2^(old - new)
  float base[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = flash_base(mx[i], c);
    // before a row's first key l and O are 0: any finite factor will do
    corr[i] = m_r[i] == -INFINITY ? 1.f : ex2(flash_base(m_r[i], c) - base[i]);
    m_r[i] = mx[i];
    l_r[i] *= corr[i];
  }
  // most tiles leave every row max of the warp where it was
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
  }

  // per 16 keys: the weights in float32 into l, as bf16 hi + lo pairs
  // (the A operand, straight from the C fragments) into P V
#pragma unroll
  for (int kk = 0; kk < TC_BK / 16; ++kk) {
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {               // n tiles 2 kk, 2 kk + 1
      const float* sn = s[2 * kk + h];
      const float p0 = ex2(fmaf(sn[0], c, -base[0]));
      const float p1 = ex2(fmaf(sn[1], c, -base[0]));
      const float p2 = ex2(fmaf(sn[2], c, -base[1]));
      const float p3 = ex2(fmaf(sn[3], c, -base[1]));
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      split_bf16(p0, p1, a_hi[2 * h], a_lo[2 * h]);
      split_bf16(p2, p3, a_hi[2 * h + 1], a_lo[2 * h + 1]);
    }
    // the two n tiles' hi products, then their lo ones: no mma waits on
    // the one just before it
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, v_base + (kk * 16 * ST + dp * 16) * 2);
      mma_bf16(o[2 * dp], a_hi, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], a_hi, vf[2], vf[3]);
      mma_bf16(o[2 * dp], a_lo, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], a_lo, vf[2], vf[3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int S, int Hq, int Hkv, float scale, int causal) {
  static_assert(D == 16 || D == 32, "D must be 16 or 32");
  using Lay = TcLayout<D>;
  constexpr int ST = Lay::STRIDE;
  constexpr int CH = D / 8;                // 16-byte chunks of a row
  constexpr int RSTEP = TC_THREADS / CH;   // rows one pass of copies covers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + Lay::Q_ELEMS;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.x;                       // b * Hq + hq
  const int b = bh / Hq, hq = bh - b * Hq;
  const int h = hq / (Hq / Hkv);                   // its KV head
  const int qt = gridDim.y - 1 - blockIdx.y;       // longest tiles first
  const int row0 = qt * TC_BQ;
  const int k_end = causal ? min(S, row0 + TC_BQ) : S;
  const int n_tiles = (k_end + TC_BK - 1) / TC_BK;

  const size_t q_stride = static_cast<size_t>(Hq) * D;
  const size_t kv_stride = static_cast<size_t>(Hkv) * D;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * S * Hq + hq) * D;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * D;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * D;

  // this thread's copies: 16-byte chunk cc of rows cr, cr + RSTEP, ...
  const int cr = tid / CH, cc = (tid % CH) * 8;
  const uint32_t q_dst = smem_u32(q_s + cr * ST + cc);
  const uint32_t kv_dst = smem_u32(kv_s + cr * ST + cc);
#pragma unroll
  for (int i = 0; i < (TC_BQ + RSTEP - 1) / RSTEP; ++i) {
    const int r = cr + i * RSTEP;
    const bool in = row0 + r < S;
    if (r < TC_BQ)
      cp_async16(q_dst + i * RSTEP * ST * 2,
                 in ? qb + (row0 + r) * q_stride + cc : qb, in);
  }
  auto load_kv = [&](int t) {
    const uint32_t dst = kv_dst + 2 * (t % TC_STAGES) * Lay::KV_ELEMS * 2;
    const size_t off = (static_cast<size_t>(t) * TC_BK + cr) * kv_stride + cc;
#pragma unroll
    for (int i = 0; i < (TC_BK + RSTEP - 1) / RSTEP; ++i) {
      const int r = cr + i * RSTEP;
      const bool in = t * TC_BK + r < S;
      const size_t e = in ? off + static_cast<size_t>(i) * RSTEP * kv_stride
                          : 0;
      if (r < TC_BK) {
        cp_async16(dst + i * RSTEP * ST * 2, kb + e, in);
        cp_async16(dst + (Lay::KV_ELEMS + i * RSTEP * ST) * 2, vb + e, in);
      }
    }
  };
  load_kv(0);
  cp_async_commit();                               // q and tile 0
#pragma unroll
  for (int t = 1; t < TC_STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // ldmatrix lane offsets (elements).  Matrix i = lane / 8 of an x4 load
  // takes its 8 row addresses from lanes 8i..8i+7.  A operand (q) and
  // the transposed B operand (V): matrix i at rows + 8 (i & 1), columns
  // + 8 (i >> 1).  B operand K (keys as rows): rows + 8 (i >> 1), columns
  // + 8 (i & 1).
  const int lr = lane & 7, lm = lane >> 3;
  const int a_off = ((lm & 1) * 8 + lr) * ST + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * ST + (lm & 1) * 8;

  // for a negative scale, -q (exact in bf16) against |scale|, so that the
  // row max of the raw logits is the max of the scaled ones: each thread
  // flips the q chunks it copied, and the loop's first barrier publishes
  // them.
  if (scale < 0.f) {
    cp_async_wait<TC_STAGES - 2>();
#pragma unroll
    for (int i = 0; i < (TC_BQ + RSTEP - 1) / RSTEP; ++i) {
      const int r = cr + i * RSTEP;
      if (r < TC_BQ) {
        uint4* c4 = reinterpret_cast<uint4*>(q_s + r * ST + cc);
        const uint4 x = *c4;
        *c4 = make_uint4(x.x ^ 0x80008000u, x.y ^ 0x80008000u,
                         x.z ^ 0x80008000u, x.w ^ 0x80008000u);
      }
    }
  }
  const uint32_t q_base = smem_u32(q_s + warp * 16 * ST + a_off);

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // this thread's rows: g and g + 8 of the warp's 16 (C fragment layout)
  const int tq = lane & 3;
  const int wrow0 = row0 + warp * 16;
  const int r_lo = wrow0 + (lane >> 2);
  float m_r[2] = {-INFINITY, -INFINITY};   // row max of the raw logits
  float l_r[2] = {0.f, 0.f};               // this thread's share of l
  const float c = fabsf(scale) * LOG2E;    // raw logits -> log2 units
  const uint32_t k_off = smem_u32(kv_s + b_off);
  const uint32_t v_off = smem_u32(kv_s + Lay::KV_ELEMS + a_off);

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<TC_STAGES - 2>();        // tile t has landed ...
    __syncthreads();                       // ... for every thread, and
    if (t + TC_STAGES - 1 < n_tiles)       // tile t - 1 is consumed
      load_kv(t + TC_STAGES - 1);
    cp_async_commit();
    const int key0 = t * TC_BK;
    // a warp past S, or whose rows all precede the tile's keys, skips it
    if (wrow0 >= S || (causal && key0 > wrow0 + 15)) continue;
    const uint32_t st = 2 * (t % TC_STAGES) * Lay::KV_ELEMS * 2;
    if (key0 + TC_BK > S || (causal && key0 + TC_BK - 1 > wrow0))
      flash_tile<D, true>(q_base, o, m_r, l_r, k_off + st, v_off + st, c,
                          key0, S, causal, r_lo, tq);
    else
      flash_tile<D, false>(q_base, o, m_r, l_r, k_off + st, v_off + st, c,
                           key0, S, causal, r_lo, tq);
  }
  cp_async_wait<0>();                      // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = r_lo + 8 * i;
    if (row >= S) continue;
    const float lc = fmaxf(l_r[i], 1e-30f);
    __nv_bfloat16* op =
        out + ((static_cast<size_t>(b) * S + row) * Hq + hq) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
          __floats2bfloat162_rn(o[n][2 * i] / lc, o[n][2 * i + 1] / lc);
    }
    if (tq == 0) {
      lse[static_cast<size_t>(bh) * S + row] =
          flash_base(m_r[i], c) * LN2 + logf(l_r[i]);
    }
  }
}

template <int D>
int launch_mma(const Geometry& g, const void* q, const void* k,
               const void* v, void* out, float* lse, int S, int Hq, int Hkv,
               float scale, int causal, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) %
      16)
    return refuse("flash_attention: bf16 q, k, v and out must be 16-byte "
                  "aligned");
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(flash_fwd_mma_kernel<D>, smem, "flash_attention");
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]));
  flash_fwd_mma_kernel<D><<<grid, static_cast<int>(g.threads), smem,
                            stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, S, Hq, Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per shared-memory tile
constexpr int THREADS = 2 * BQ;  // two threads per query row

// shared-memory floats: K tile rows padded to D + 4 (16-byte aligned,
// neighbouring rows on neighbouring banks), V tile, weights tile padded
// to BK + 1.
inline size_t smem_bytes(int D) {
  return sizeof(float) * (static_cast<size_t>(BK) * (D + 4) +
                          static_cast<size_t>(BK) * D +
                          static_cast<size_t>(BQ) * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int S, int Hq, int Hkv, float scale,
    int causal) {
  static_assert(D % 8 == 0, "D must be a multiple of 8");
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + BK * (D + 4);
  float* p_s = v_s + BK * D;

  const int bh = blockIdx.x;                       // b * Hq + hq
  const int b = bh / Hq, hq = bh - b * Hq;
  const int h = hq / (Hq / Hkv);                   // its KV head
  const int qt = gridDim.y - 1 - blockIdx.y;       // longest tiles first
  const int row0 = qt * BQ;
  const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
  const int row = row0 + r;
  const bool live = row < S;

  // this thread's q row, scaled in float32
  float4 qv[D / 4];
  {
    const float* qp = q + ((static_cast<size_t>(b) * S + (live ? row : 0)) *
                               Hq + hq) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      qv[i] = make_float4(qp[4 * i] * scale, qp[4 * i + 1] * scale,
                          qp[4 * i + 2] * scale, qp[4 * i + 3] * scale);
    }
  }
  float4 acc[D / 8];                                // columns 8i + 4half..
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_BIG, l = 0.f;

  const int k_end = causal ? min(S, row0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;   // stride of a key
  const float* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * D;
  const float* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BK;
    __syncthreads();                 // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      const bool in = key0 + j < S;
      const size_t e = static_cast<size_t>(key0 + j) * kv_row + d;
      k_s[j * (D + 4) + d] = in ? kb[e] : 0.f;
      v_s[j * D + d] = in ? vb[e] : 0.f;
    }
    __syncthreads();

    // logits of keys key0 + 2jj + half
    float s[BK / 2];
    float tmax = NEG_BIG;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int j = 2 * jj + half;
      const float4* kr = reinterpret_cast<const float4*>(k_s + j * (D + 4));
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 kk = kr[i];
        dot += qv[i].x * kk.x;
        dot += qv[i].y * kk.y;
        dot += qv[i].z * kk.z;
        dot += qv[i].w * kk.w;
      }
      const int col = key0 + j;
      const bool masked = col >= S || (causal && col > row);
      s[jj] = masked ? NEG_BIG : dot;
      tmax = fmaxf(tmax, s[jj]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BK / 2; ++jj) {
      const int col = key0 + 2 * jj + half;
      const bool masked = col >= S || (causal && col > row);
      const float p = masked ? 0.f : expf(s[jj] - m_new);
      psum += p;
      p_s[r * (BK + 1) + 2 * jj + half] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    const float corr = expf(m - m_new);
    m = m_new;
    l = l * corr + psum;
    __syncwarp();                    // the pair's weights are in p_s

#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      acc[i].x *= corr;
      acc[i].y *= corr;
      acc[i].z *= corr;
      acc[i].w *= corr;
    }
    const int n_keys = min(BK, k_end - key0);
    for (int j = 0; j < n_keys; ++j) {
      const float p = p_s[r * (BK + 1) + j];
      const float4* vr = reinterpret_cast<const float4*>(v_s + j * D);
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        const float4 vv = vr[2 * i + half];
        acc[i].x += p * vv.x;
        acc[i].y += p * vv.y;
        acc[i].z += p * vv.z;
        acc[i].w += p * vv.w;
      }
    }
  }

  if (!live) return;
  const float lc = fmaxf(l, 1e-30f);
  float* op = out + ((static_cast<size_t>(b) * S + row) * Hq + hq) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + 4 * half;
    op[c] = acc[i].x / lc;
    op[c + 1] = acc[i].y / lc;
    op[c + 2] = acc[i].z / lc;
    op[c + 3] = acc[i].w / lc;
  }
  if (half == 0) {
    lse[static_cast<size_t>(bh) * S + row] = m + logf(l);
  }
}

template <int D>
int launch_f32(const Geometry& g, const void* q, const void* k,
               const void* v, void* out, float* lse, int S, int Hq, int Hkv,
               float scale, int causal, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(flash_fwd_kernel<D>, smem, "flash_attention");
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]));
  flash_fwd_kernel<D><<<grid, static_cast<int>(g.threads), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), lse, S, Hq,
      Hkv, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Geometry::kernel of the flash launcher: the CUDA-core float32 kernel,
// the mma.sync bf16 one (D 16, 32) or the wgmma bf16 one (D 64, 80, 128)
enum FlashKernel { FL_F32 = 0, FL_MMA = 1, FL_WGMMA = 2 };

// The launch's geometry, after the checks of its sizes: grid (B Hq,
// q tiles), the rows a block (Geometry::block) of the kernel that the
// dtype and D pick.
int flash_geometry(int B, int S, int Hq, int Hkv, int D, int dtype,
                   Geometry& g) {
  if (B < 1 || S < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv)
    return refuse("flash_attention: B, S, Hq and Hkv must be positive and "
                  "Hq a multiple of Hkv (got Hq %d, Hkv %d)", Hq, Hkv);
  if (dtype != Q_F32 && dtype != Q_BF16)
    return refuse("flash_attention: unknown dtype %d", dtype);
  if (D != 16 && D != 32 && D != 64 && D != 80 && D != 128)
    return refuse("flash_attention: head dim %d is not one of 16, 32, "
                  "64, 80, 128", D);
  const int kernel = dtype == Q_F32 ? FL_F32 : D <= 32 ? FL_MMA : FL_WGMMA;
  const int bq = kernel == FL_F32 ? BQ : kernel == FL_MMA ? TC_BQ : WG_BQ;
  if ((static_cast<long long>(S) + bq - 1) / bq > 65535)
    return refuse("flash_attention: S = %d needs more than 65535 q tiles",
                  S);
  g = Geometry{};
  g.kernel = kernel;
  g.grid[0] = B * Hq;
  g.grid[1] = (S + bq - 1) / bq;
  g.grid[2] = 1;
  g.block = bq;
  if (kernel == FL_F32) {
    g.threads = THREADS;
    g.smem = smem_bytes(D);
  } else if (kernel == FL_MMA) {
    g.threads = TC_THREADS;
    g.smem = D == 16 ? TcLayout<16>::BYTES : TcLayout<32>::BYTES;
  } else {
    g.threads = WG_THREADS;
    g.smem = D == 64   ? WgLayout<64>::BYTES
             : D == 80 ? WgLayout<80>::BYTES
                       : WgLayout<128>::BYTES;
  }
  return 0;
}

template <int D>
int launch_typed(const Geometry& g, const void* q, const void* k,
                 const void* v, void* out, float* lse, int B, int S, int Hq,
                 int Hkv, float scale, int causal, cudaStream_t stream) {
  if (g.kernel == FL_F32)
    return launch_f32<D>(g, q, k, v, out, lse, S, Hq, Hkv, scale, causal,
                         stream);
  if constexpr (D <= 32)
    return launch_mma<D>(g, q, k, v, out, lse, S, Hq, Hkv, scale, causal,
                         stream);
  else
    return launch_wgmma<D>(g, q, k, v, out, lse, B, S, Hq, Hkv, scale,
                           causal, stream);
}

}  // namespace

// The geometry flash_attention_launch would launch with for these sizes
// (GEOMETRY_FIELDS values into out; Geometry::kernel is a FlashKernel),
// or the refusal it would make.
extern "C" int flash_attention_geometry(int B, int S, int Hq, int Hkv, int D,
                                        int dtype, long long* out) {
  Geometry g;
  if (int rc = flash_geometry(B, S, Hq, Hkv, D, dtype, g)) return rc;
  write_geometry(g, out);
  return 0;
}

// q (B, S, Hq, D), k / v (B, S, Hkv, D), out like q, lse (B, Hq, S)
// float32; all contiguous.  dtype 0 = float32 (the CUDA-core kernel),
// 1 = bfloat16 (the tensor-core kernels), for q, k, v and out alike.
// Returns a CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  Geometry g;
  if (int rc = flash_geometry(B, S, Hq, Hkv, D, dtype, g)) return rc;
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch_typed<16>(g, q, k, v, out, l, B, S, Hq, Hkv,
                                     scale, causal, st);
    case 32: return launch_typed<32>(g, q, k, v, out, l, B, S, Hq, Hkv,
                                     scale, causal, st);
    case 64: return launch_typed<64>(g, q, k, v, out, l, B, S, Hq, Hkv,
                                     scale, causal, st);
    case 80: return launch_typed<80>(g, q, k, v, out, l, B, S, Hq, Hkv,
                                     scale, causal, st);
    default: return launch_typed<128>(g, q, k, v, out, l, B, S, Hq, Hkv,
                                      scale, causal, st);
  }
}
