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
// softmax between them.  One kernel per dtype:
//
// bfloat16: flash_fwd_mma_kernel, both products on the tensor cores.  A
// block of 8 warps owns 128 query rows of one (batch, q head), 16 rows a
// warp; q tiles are scheduled longest first, and the kernel is capped at
// 128 registers (D <= 64) so that two blocks share an SM.  K and V stay
// bf16 and reach shared memory through a ring of three 64-key tiles fed
// by cp.async, so tiles t+1 and t+2 load while tile t is computed (one
// barrier a tile); rows are padded to D + 8 elements so every ldmatrix
// is free of bank conflicts (at D 80, hubert's head, a row is 11 units of
// 16 bytes, and a pass of copies covers 25 rows of 10 chunks with 6
// threads idle).  Each warp reads its q rows as mma A
// fragments (ldmatrix, again each tile: holding them would push the
// kernel past 128 registers) and forms S = q k^T with mma.sync m16n8k16
// (bf16 in, float32 sums: the products of bf16 values are exact, only
// the order of the sums differs).  The online softmax runs on the
// accumulator fragments, the row max reduced over the quad with two
// shuffles.  The scale goes into the exponent, never into a bf16 q:
// p = 2^(c s - base) with c = |scale| log2(e) and base = c m, one FFMA
// and one MUFU.EX2 per weight (a negative scale negates q in registers,
// which is exact, so that the row max of the raw logits stays the max
// of the scaled ones); l sums the float32 weights, and O is rescaled
// only when some row max of the warp moved.  P never leaves registers:
// the C layout of m16n8k16 is the A layout of its k halves, so P is
// packed to bf16 in place and multiplies V, which comes in through
// ldmatrix.trans.  P goes in as two bf16 terms, hi = bf16(p) and lo =
// bf16(p - hi), two products into one accumulator, issued so that no
// mma waits on the one before it: one bf16 term (8 bits) moves O by up
// to 2^-9 of |v|, which at |o| >= 2 turns a bf16 output into its
// neighbour a whole ulp (1.6e-2) from the plain version, above its 1e-2
// tolerance; with the lo term P carries 16 bits.  Only the tiles that
// reach the causal diagonal or the ragged end of S are masked, and a
// warp skips the tiles beyond its last row.
//
// float32: flash_fwd_kernel, float32 FMAs on the CUDA cores (the float32
// callers check the card against the CPU to 1e-5, which bf16 products
// would not meet): a block owns BQ = 64 query rows; two threads share a
// row, each holding it scaled in registers; per 64-key tile K and V are
// staged in shared memory and the tile's weights go through shared memory
// to the P.V loop.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bfloat16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_WARPS = 8;
constexpr int TC_BQ = 16 * TC_WARPS;     // query rows per block
constexpr int TC_BK = 64;                // keys per tile
constexpr int TC_STAGES = 3;             // K/V tiles in the ring
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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
// The weights' base for a row max m of raw logits, in log2 units: c m,
// rounded the same way for every tile (__fmul_rn: never fused into the
// subtraction that follows); 0 while the row has no key.
__device__ __forceinline__ float flash_base(float m, float c) {
  return m == -INFINITY ? 0.f : __fmul_rn(m, c);
}

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
__global__ void __launch_bounds__(TC_THREADS, D <= 64 ? 2 : 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                     int S, int Hq, int Hkv, float scale, int causal) {
  static_assert(D % 16 == 0 && D <= 128,
                "D must be 16, 32, 64, 80 or 128");
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

  // this thread's copies: 16-byte chunk cc of rows cr, cr + RSTEP, ...;
  // where CH does not divide the block (D 80) the spare threads copy
  // nothing, so that no chunk has two owners
  const int cr = tid / CH, cc = (tid % CH) * 8;
  const bool copier = TC_THREADS % CH == 0 || cr < RSTEP;
  const uint32_t q_dst = smem_u32(q_s + cr * ST + cc);
  const uint32_t kv_dst = smem_u32(kv_s + cr * ST + cc);
#pragma unroll
  for (int i = 0; i < (TC_BQ + RSTEP - 1) / RSTEP; ++i) {
    const int r = cr + i * RSTEP;
    const bool in = row0 + r < S;
    if (copier && r < TC_BQ)
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
      if (copier && r < TC_BK) {
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
      if (copier && r < TC_BQ) {
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

// Geometry::kernel of the flash launcher: the CUDA-core float32 kernel
// or the tensor-core bf16 one
enum FlashKernel { FL_F32 = 0, FL_MMA = 1 };

// The launch's geometry, after the checks of its sizes: grid (B Hq,
// q tiles), the bf16 kernel's TC_BQ rows or the float32 kernel's BQ a
// block (Geometry::block).
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
  const bool mma = dtype == Q_BF16;
  const int bq = mma ? TC_BQ : BQ;
  if ((static_cast<long long>(S) + bq - 1) / bq > 65535)
    return refuse("flash_attention: S = %d needs more than 65535 q tiles",
                  S);
  g = Geometry{};
  g.kernel = mma ? FL_MMA : FL_F32;
  g.grid[0] = B * Hq;
  g.grid[1] = (S + bq - 1) / bq;
  g.grid[2] = 1;
  g.threads = mma ? TC_THREADS : THREADS;
  switch (D) {
    case 16: g.smem = mma ? TcLayout<16>::BYTES : smem_bytes(16); break;
    case 32: g.smem = mma ? TcLayout<32>::BYTES : smem_bytes(32); break;
    case 64: g.smem = mma ? TcLayout<64>::BYTES : smem_bytes(64); break;
    case 80: g.smem = mma ? TcLayout<80>::BYTES : smem_bytes(80); break;
    default: g.smem = mma ? TcLayout<128>::BYTES : smem_bytes(128); break;
  }
  g.block = bq;
  return 0;
}

template <int D>
int launch_typed(const Geometry& g, const void* q, const void* k,
                 const void* v, void* out, float* lse, int S, int Hq,
                 int Hkv, float scale, int causal, cudaStream_t stream) {
  return g.kernel == FL_MMA
             ? launch_mma<D>(g, q, k, v, out, lse, S, Hq, Hkv, scale, causal,
                             stream)
             : launch_f32<D>(g, q, k, v, out, lse, S, Hq, Hkv, scale, causal,
                             stream);
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
// 1 = bfloat16 (the tensor-core kernel), for q, k, v and out alike.
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
    case 16: return launch_typed<16>(g, q, k, v, out, l, S, Hq, Hkv, scale,
                                     causal, st);
    case 32: return launch_typed<32>(g, q, k, v, out, l, S, Hq, Hkv, scale,
                                     causal, st);
    case 64: return launch_typed<64>(g, q, k, v, out, l, S, Hq, Hkv, scale,
                                     causal, st);
    case 80: return launch_typed<80>(g, q, k, v, out, l, S, Hq, Hkv, scale,
                                     causal, st);
    default: return launch_typed<128>(g, q, k, v, out, l, S, Hq, Hkv, scale,
                                      causal, st);
  }
}
