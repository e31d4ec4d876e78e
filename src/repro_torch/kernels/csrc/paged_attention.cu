// Paged GQA attention over the serving engine's page pools, for Hopper
// (sm_90a): one-token decode and chunked causal prefill.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attn_decode_pallas  (_decode_kernel, _load_kv_block, and the
//                              log-sum-exp merge of its splits)
//   paged_attn_prefill_pallas (_prefill_kernel, _load_kv_block)
// All of them read K/V straight through the page tables, dequantize
// compressed pools (kv_format int8 / sc) on load, and run a float32
// online softmax (m, l, acc) with the reference's numerics: logits =
// (q . k) / sqrt(D), positions past the live length / causal horizon
// masked to -1e30 before the exp and their weight zeroed after it, output
// acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds them.  Decode reads every live position of K and V once
// per KV head and does 4 G D flops per position (G = 4 query rows a KV
// head), far below the H100's 295 flop/byte balance point: bytes.
// Prefill does C times more flops per byte; at C = 64 and Gq = 4 its
// bytes and its bf16 products take about the same time at the H100's
// peaks (fp: bytes; int8: operations).
//
// bfloat16 q with bf16 / int8 / sc pools (the serving path): tensor-core
// kernels, S = q k^T and O += P V with bf16 operands and float32 sums, P
// entering P V as two bf16 terms hi + lo (one term moves O past its 1e-2
// tolerance, see flash_attention.cu).  int8 pools: the codes are exact in
// bf16, the per-key scale multiplies the float32 logit (K) and folds into
// P (V).
//
// paged_prefill_wgmma_kernel (bf16 q at D 64 and 128 on 16-position
// pages: granite, qwen3-moe and jamba on every format).  A block owns one
// (request, KV head, q-block) and all Gq query heads of that KV head,
// rows position-major (row i = position i / Gq, head i % Gq), so each K /
// V tile is read once for the whole GQA group.
// - Warpgroups.  One or two consumer warpgroups of 64 rows (wgmma's M;
//   128 / Gq positions at most, block_q's rows rounded up to 64) and a
//   producer warpgroup; setmaxnreg gives the producer's registers to the
//   consumers (24 / 240 over bf16 pools, 72 / 216 over int8 / sc).
// - Producer.  It reads the split's table lanes into shared memory once
//   (a page at or past the chunk's last is never looked up: its lane reads
//   as the page index N, one past the pool, where TMA reads nothing and
//   fills zeros), then one thread keeps a ring of key tiles of PF_BK = 64
//   absolute positions (4 pages) in flight with TMA: rank-4 tensor maps
//   over the pools as (D, Hkv, page, N), one box a page.  bf16 pools land
//   in the stage itself, 64-column boxes in 128B swizzle (two a page at D
//   128), and full / empty mbarriers pass the stages (4 of them).  int8 /
//   sc pools land raw (codes, residuals: D-byte rows, 3 raw stages); the
//   whole warpgroup widens each raw tile into the swizzled bf16 stage
//   wgmma reads (3 of them) without I2F (one PRMT puts a byte in a float's
//   mantissa), fences the generic proxy's writes for wgmma
//   (fence.proxy.async) and arrives.  The per-key scales (4 bytes of one
//   KV head a key: below a TMA box's 16-byte minimum) are plain loads, one
//   key of K or V a producer thread, issued a tile ahead of their use;
//   they land beside the stage.  The tensor maps (two; four for sc's
//   residuals) are encoded on the host at every launch (tensor_map_4d,
//   tensor_map.cu).
// - sc's joined operand.  A sc element is (16 code + resid) * scale / 16
//   (core/kv_quant.kv_dequant).  kv_quant writes every code and residual
//   clipped to +-SC_COARSE_BSL / 2 = +-8 (core/kv_quant.py:30-33, :73-79;
//   quantize_levels clamps), so 16 code + resid lies in [-136, 136], and
//   bf16 holds every integer up to 256 exactly: the producer widens the
//   joined value itself, bit-identical to the two exact terms the
//   mma.sync kernel multiplies apart, and sc costs int8's products (one K
//   product, hi + lo V products, not two and four).  A pool with a code or
//   residual past +-8 is not one kv_quant writes; there the join rounds
//   (|value| > 256), which no test or caller feeds (tests/
//   test_torch_paged_prefill.py holds kv_quant to the range).
// - Products.  S = q K^T: wgmma m64n64k16, q (loaded once by each
//   consumer with cp.async into its own swizzled boxes) and K K-major from
//   shared memory.  The logit x = s (fp) or s times the key's K scale
//   (int8; times 2^-4 for sc), the online softmax on the accumulator
//   registers in log2 units, p = 2^(c x - c m), c = log2(e) / sqrt(D): the
//   divide by sqrt(D) is folded into the exponent's FFMA.  O += P V:
//   wgmma m64n64k16 a 64-column box, P from registers as bf16 hi + lo
//   (times the key's V scale), V MN-major through the transpose bit.  Two
//   consumer warpgroups take turns at the tensor cores (ping-pong over
//   two named barriers, as flash_attention.cu's): one issues P V of a
//   tile and q K^T of the next while the other runs its softmax; within a
//   warpgroup the next tile's q K^T is committed before this tile's P V,
//   so the next weights are computed while P V runs.  No wgmma sits in a
//   runtime branch (ptxas would serialize every wgmma of the kernel,
//   C7520): the loop peels the first q K^T and the last P V.
// - Bound.  The last 64-token chunk of a 4096-token prompt (G 4, Hkv 8,
//   Gq 4, D 64) reads 33.6 MB of bf16 K / V (16.8 MB of int8 codes, 33.6
//   MB of sc codes and residuals, 1 MB of scales) and does 8.5 GFLOP of
//   bf16 products (12.8 with the lo term): 10.0 / 8.6 / 10.3 us at the
//   H100's peaks, bytes for fp and sc, operations for int8.
//
// paged_prefill_mma_kernel (bf16 q at D 16 / 32, or pages other than 16):
// the same blocks, 16 rows a warp, at most 128 rows; key tiles of 64
// absolute positions gathered through the page table by cp.async into a
// ring of three, keys past the chunk's end zero-filled; the tile routine
// attn_tile (mma.sync m16n8k16, ldmatrix) with sc's 16 code and resid as
// two products, codes widened to bf16 in shared memory by the same warps
// (widen16).
//
// Both prefills split the keys by absolute position (PF_SPLIT_KEYS a
// split, a block each), so that a long cache fills the card; tiles past a
// block's causal horizon are never loaded and the causal mask is applied
// only on tiles that reach a warp's first position; a block writes only
// the rows whose position reaches its split: rows whose position lies in
// split 0 write their output, the others' splits are merged by
// paged_prefill_combine_kernel in split order.  A row's result depends on
// its own position and the tiles before it only, not on block_q, C,
// start or the other requests; the kernel is chosen by dtype, D and page
// size alone (wgmma_route).
//
// paged_decode_split_kernel: a lane's positions are split by absolute
// position, split j covering [j SPLIT_TOKENS, (j + 1) SPLIT_TOKENS), so a
// lane's arithmetic depends on its own length and pages only (never on
// S, maxp or the other lanes: batched == sequential).  A block owns one
// (lane, KV head, split); splits past the lane's length do nothing.  Its
// 4 warps take the split's 16-position chunks in a fixed order (warp w:
// chunks w, w + 4, ...); each warp stages its chunks in its own ring of
// 3 shared-memory slots by cp.async (16-byte copies of whole K / V rows,
// 4-byte copies of the scales; rows of pages past the length are zero-
// filled, their table lanes never read), so two chunks load while one is
// computed.  The G <= 16 query rows of the KV head are the rows of one
// mma tile, held as A fragments in registers; the tile routine is
// attn_tile's.  The warps' partials merge in warp order through shared
// memory; a lane with one split writes its output, otherwise each split
// writes (acc, m, l) to scratch and paged_decode_combine_kernel merges the
// splits in split order with the reference's exact log-sum-exp combine
// (launched only when maxp pages hold more than one split).
//
// float32 q, or float32 pools: the CUDA-core kernels decode_kernel and
// prefill_kernel (the float32 callers hold the card against the CPU to
// 1e-5, which bf16 products would not meet): a block owns one (slot, KV
// head) for decode or one (request, q head, q-block) for prefill and
// walks its pages in order, each page of K and V staged in shared memory
// as float.  The launch functions choose by dtype; one launch count a
// call either way.

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;

// One page of K and V for KV head h -> shared memory as float.
template <int KIND>
__device__ __forceinline__ void load_page(
    float* k_s, float* v_s, const void* kp, const void* vp,
    const float* ks, const float* vs, const int8_t* kr, const int8_t* vr,
    int phys, int page, int Hkv, int h, int D) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < page * D; i += blockDim.x) {
    const int t = i / D, d = i - t * D;
    const size_t si = (static_cast<size_t>(phys) * page + t) * Hkv + h;
    const size_t e = si * D + d;
    k_s[t * Dp + d] = kv_value<KIND>(kp, ks, kr, e, si);
    v_s[t * D + d] = kv_value<KIND>(vp, vs, vr, e, si);
  }
}

// One online-softmax step over a staged page for `rows` query rows.
// logit(r, t) is live iff live(r, t); w_s holds the (rows, page) tile.
template <typename Live>
__device__ __forceinline__ void softmax_step(
    const float* q_s, const float* k_s, const float* v_s, float* w_s,
    float* acc, float* m_s, float* l_s, float* c_s, int rows, int page,
    int D, float scale, Live live) {
  const int Dp = D + 1;
  for (int i = threadIdx.x; i < rows * page; i += blockDim.x) {
    const int r = i / page, t = i - r * page;
    float dot = 0.f;
    for (int d = 0; d < D; ++d) dot += q_s[r * D + d] * k_s[t * Dp + d];
    w_s[i] = live(r, t) ? dot / scale : NEG_BIG;
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float m_prev = m_s[r];
    float m_new = m_prev;
    for (int t = 0; t < page; ++t) m_new = fmaxf(m_new, w_s[r * page + t]);
    float sum = 0.f;
    for (int t = 0; t < page; ++t) {
      const float w = live(r, t) ? expf(w_s[r * page + t] - m_new) : 0.f;
      w_s[r * page + t] = w;
      sum += w;
    }
    const float corr = expf(m_prev - m_new);
    m_s[r] = m_new;
    l_s[r] = l_s[r] * corr + sum;
    c_s[r] = corr;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    float a = acc[i] * c_s[r];
    for (int t = 0; t < page; ++t) a += w_s[r * page + t] * v_s[t * D + d];
    acc[i] = a;
  }
  __syncthreads();
}

// shared-memory floats: q + acc (rows*D each), K page (page*(D+1)),
// V page (page*D), logits tile (rows*page), m/l/corr (rows each).  The
// launch refuses a layout above SMEM_CAP (prepare_smem), naming the bytes.
inline size_t smem_bytes(int rows, int page, int D) {
  return sizeof(float) * (2 * static_cast<size_t>(rows) * D +
                          static_cast<size_t>(page) * (2 * D + 1) +
                          static_cast<size_t>(rows) * page + 3 * rows);
}

// ---------------------------------------------------------------------------
// float32 q or float32 pools, on the CUDA cores.  decode: grid (S, Hkv);
// block (s, h) walks the slot's table lanes in order (no split: one block
// per slot and KV head).
// ---------------------------------------------------------------------------
template <typename QT, int KIND>
__global__ void __launch_bounds__(THREADS) decode_kernel(
    const QT* __restrict__ q, const void* kp, const void* vp,
    const float* ks, const float* vs, const int8_t* kr, const int8_t* vr,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    QT* out, int Hkv, int G, int D, int page, int maxp, float scale) {
  extern __shared__ float sm[];
  const int s = blockIdx.x, h = blockIdx.y;
  float* q_s = sm;
  float* acc = q_s + G * D;
  float* k_s = acc + G * D;
  float* v_s = k_s + page * (D + 1);
  float* w_s = v_s + page * D;
  float* m_s = w_s + G * page;
  float* l_s = m_s + G;
  float* c_s = l_s + G;

  const size_t head = (static_cast<size_t>(s) * Hkv + h) * G;   // row 0
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    q_s[i] = to_float(q[head * D + i]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < G; r += blockDim.x) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }
  const int length = lengths[s];
  __syncthreads();

  for (int p = 0; p < maxp; ++p) {
    const int base = p * page;
    if (base > length) break;            // page holds no live token
    load_page<KIND>(k_s, v_s, kp, vp, ks, vs, kr, vr,
                    tables[static_cast<size_t>(s) * maxp + p], page, Hkv, h,
                    D);
    __syncthreads();
    softmax_step(q_s, k_s, v_s, w_s, acc, m_s, l_s, c_s, G, page, D, scale,
                 [&](int, int t) { return base + t <= length; });
  }

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int r = i / D;
    out[head * D + i] = from_float<QT>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// prefill: q (G, C, Hkv, Gq, D); grid (G * Hq, ceil(C / bq)).  Block
// (bh, qi) serves q head bh % Hq of request bh / Hq, rows
// [qi*bq, qi*bq + bq), against pages [0, (start + C) / page) up to the
// block's causal horizon; causal mask k_pos <= start + row.
// ---------------------------------------------------------------------------
template <typename QT, int KIND>
__global__ void __launch_bounds__(THREADS) prefill_kernel(
    const QT* __restrict__ q, const void* kp, const void* vp,
    const float* ks, const float* vs, const int8_t* kr, const int8_t* vr,
    const int* __restrict__ tables, QT* out, int C, int Hkv, int Gq, int D,
    int page, int width, int start, int bq, float scale) {
  extern __shared__ float sm[];
  const int Hq = Hkv * Gq;
  const int bh = blockIdx.x, qi = blockIdx.y;
  const int g = bh / Hq, hq = bh - g * Hq, h = hq / Gq;
  const int row0 = qi * bq;
  const int rows = min(bq, C - row0);
  float* q_s = sm;
  float* acc = q_s + bq * D;
  float* k_s = acc + bq * D;
  float* v_s = k_s + page * (D + 1);
  float* w_s = v_s + page * D;
  float* m_s = w_s + bq * page;
  float* l_s = m_s + bq;
  float* c_s = l_s + bq;

  // element (g, c, hq, d) of q / out
  auto at = [&](int r, int d) {
    return ((static_cast<size_t>(g) * C + row0 + r) * Hq + hq) * D + d;
  };
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    q_s[i] = to_float(q[at(r, d)]);
    acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    m_s[r] = NEG_BIG;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int n_pg = (start + C) / page;
  const int q_lo = start + row0;
  const int q_hi = q_lo + rows - 1;      // last q position of the block
  for (int pg = 0; pg < n_pg; ++pg) {
    const int base = pg * page;
    if (base > q_hi) break;              // causal early exit
    load_page<KIND>(k_s, v_s, kp, vp, ks, vs, kr, vr,
                    tables[static_cast<size_t>(g) * width + pg], page, Hkv,
                    h, D);
    __syncthreads();
    softmax_step(q_s, k_s, v_s, w_s, acc, m_s, l_s, c_s, rows, page, D,
                 scale, [&](int r, int t) { return base + t <= q_lo + r; });
  }

  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    out[at(r, d)] = from_float<QT>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q: the tensor-core tile both kernels run
// ---------------------------------------------------------------------------

constexpr float LOG2E = 1.4426950408889634f;

// sqrt(D) as the float the reference divides by (sqrtf is exact-rounded)
template <int D>
__host__ __device__ constexpr float sqrt_d() {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128, "head dim");
  return D == 16   ? 4.0f
         : D == 32 ? 5.65685424949238019520f
         : D == 64 ? 8.0f
                   : 11.3137084989847603904f;
}

// One K or V pool as the raw rows the kernels copy: bf16 values or int8
// codes; sc pools add the int8 residual rows.  NARR arrays are staged:
// K, V (and K resid, V resid for sc), then K and V scales (int8, sc).
template <int D, int KIND>
struct Raw {
  static constexpr int ROW = KIND == KV_BF16 ? 2 * D : D;   // bytes a row
  static constexpr int NARR = KIND == KV_SC ? 4 : 2;
  static constexpr bool SCALED = KIND != KV_BF16;
};

// The pool arrays in staging order (see Raw).
struct Pools {
  const void* arr[4];
  const float* scale[2];
};

// 16 int8 codes (shared memory) -> 16 bf16 values code * mul, exact for
// mul 1 or 2^SC_SHIFT.  Each byte b is biased to u = b + 128 and placed
// in the mantissa of 2^23 (f = 2^23 + u, one PRMT), so that
// f mul - (2^23 + 128) mul is exactly b mul (one FFMA): no I2F.
__device__ __forceinline__ void widen16(const unsigned char* src, float mul,
                                        unsigned char* dst) {
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const uint32_t in[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u,
                          u.z ^ 0x80808080u, u.w ^ 0x80808080u};
  const float bias = -8388736.0f * mul;             // -(2^23 + 128) mul
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = fmaf(__uint_as_float(__byte_perm(in[i], 0x4B000000u,
                                              0x7440u + b)),
                  mul, bias);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    w[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
    w[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

// One tile of BK keys (absolute positions key0 ..) for one warp's 16
// query rows, on the tensor cores: S = q k^T, the online softmax on the
// accumulator fragments, O += P V with P as bf16 hi + lo terms.
// qfrag(kk, a) gives q's A fragment for dims [16 kk, 16 kk + 16); ks / vs:
// the tile's K and V scales (unused for bf16 pools); kb / vb: the bf16 K
// and V tiles (ldmatrix lane addresses, rows padded to D + 8); kb2 / vb2
// the resid tiles of sc pools.  This thread's rows (lane / 4 and + 8) sit
// at absolute positions p_row[0], p_row[1]; MASK: some key of the tile
// lies past some row's position.
template <int D, int KIND, bool MASK, int BK, typename QF>
__device__ __forceinline__ void attn_tile(
    QF qfrag, float (&o)[D / 8][4], float (&m_r)[2], float (&l_r)[2],
    uint32_t kb, uint32_t vb, uint32_t kb2, uint32_t vb2,
    const float* ks, const float* vs, int key0, const int (&p_row)[2],
    int tq) {
  constexpr int ST = D + 8;
  constexpr int NS = BK / 8;
  constexpr float SCL = KIND == KV_SC ? 1.0f / (1 << SC_SHIFT) : 1.0f;
  float s[NS][4];
#pragma unroll
  for (int n = 0; n < NS; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qf[4];
    qfrag(kk, qf);
#pragma unroll
    for (int np = 0; np < NS / 2; ++np) {
      uint32_t kf[4];
      ldsm_x4(kf, kb + (np * 16 * ST + kk * 16) * 2);
      mma_bf16(s[2 * np], qf, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      if constexpr (KIND == KV_SC) {
        ldsm_x4(kf, kb2 + (np * 16 * ST + kk * 16) * 2);
        mma_bf16(s[2 * np], qf, kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf, kf[2], kf[3]);
      }
    }
  }

  // logits = (q . k) / sqrt(D), masked; the row max over the quad
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int cl = n * 8 + 2 * tq + (e & 1);
      float x = s[n][e];
      if constexpr (KIND != KV_BF16) x *= ks[cl] * SCL;
      x = x / sqrt_d<D>();
      if constexpr (MASK) {
        if (key0 + cl > p_row[e >> 1]) x = NEG_BIG;
      }
      s[n][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  // p = e^(x - m) as 2^(x log2e - m log2e), m log2e rounded once a tile
  float base[2], corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = __fmul_rn(mx[i], LOG2E);
    corr[i] = ex2(__fmul_rn(m_r[i], LOG2E) - base[i]);
    m_r[i] = mx[i];
    l_r[i] *= corr[i];
  }
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
  }

  // per 16 keys: the weights into l, p (times V's scale) as bf16 hi + lo
  // into P V
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a_hi[4], a_lo[4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 2 * kk + hh;
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(fmaf(s[n][e], LOG2E, -base[e >> 1]));
        if constexpr (MASK) {
          if (s[n][e] == NEG_BIG) p[e] = 0.f;
        }
      }
      l_r[0] += p[0] + p[1];
      l_r[1] += p[2] + p[3];
      if constexpr (KIND != KV_BF16) {
        const int cl = n * 8 + 2 * tq;
        const float v0 = vs[cl] * SCL, v1 = vs[cl + 1] * SCL;
        p[0] *= v0;
        p[1] *= v1;
        p[2] *= v0;
        p[3] *= v1;
      }
      split_bf16(p[0], p[1], a_hi[2 * hh], a_lo[2 * hh]);
      split_bf16(p[2], p[3], a_hi[2 * hh + 1], a_lo[2 * hh + 1]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t vf[4];
      ldsm_x4_trans(vf, vb + (kk * 16 * ST + dp * 16) * 2);
      mma_bf16(o[2 * dp], a_hi, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], a_hi, vf[2], vf[3]);
      mma_bf16(o[2 * dp], a_lo, vf[0], vf[1]);
      mma_bf16(o[2 * dp + 1], a_lo, vf[2], vf[3]);
      if constexpr (KIND == KV_SC) {
        ldsm_x4_trans(vf, vb2 + (kk * 16 * ST + dp * 16) * 2);
        mma_bf16(o[2 * dp], a_hi, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], a_hi, vf[2], vf[3]);
        mma_bf16(o[2 * dp], a_lo, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], a_lo, vf[2], vf[3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q: split decode + combine
// ---------------------------------------------------------------------------

constexpr int SPLIT_TOKENS = 512;   // positions a decode split covers
constexpr int DEC_CT = 16;          // positions a warp stages at a time
constexpr int DEC_WARPS = 4;
constexpr int DEC_THREADS = 32 * DEC_WARPS;
constexpr int DEC_STAGES = 3;       // chunks in each warp's ring
constexpr int DEC_MAX_G = 16;       // query rows a KV head: one mma tile

// Shared memory of the split kernel, in bytes.  Each warp: a ring of
// DEC_STAGES slots (a chunk's raw rows: bf16 rows padded to D + 8
// elements, the tiles ldmatrix reads; int8 / sc codes and residuals as
// copied, then the K and V scales) and, for int8 / sc, the bf16 tiles
// the products read (int8: K, V; sc: 16 code and resid of K, then of V).
// Then the warps' partials: m and l (G floats each), acc (G x D).
template <int D, int KIND>
struct DecLayout {
  using R = Raw<D, KIND>;
  static constexpr int ST = D + 8;
  static constexpr int TILE = DEC_CT * ST * 2;
  static constexpr int RAW_ROW = KIND == KV_BF16 ? ST * 2 : R::ROW;
  static constexpr int SLOT =
      R::NARR * DEC_CT * RAW_ROW + (R::SCALED ? 2 * DEC_CT * 4 : 0);
  static constexpr int NCT = KIND == KV_BF16 ? 0 : R::NARR;
  static constexpr int WARP = DEC_STAGES * SLOT + NCT * TILE;
  static size_t bytes(int G) {
    return static_cast<size_t>(DEC_WARPS) * WARP +
           sizeof(float) * DEC_WARPS * G * (D + 2);
  }
};

// Stage the DEC_CT positions from pos0 of lane `tab` (KV head h) into a
// warp's ring slot: rows whose page starts past `length` are zero-filled
// and their table lanes never read.
template <int D, int KIND>
__device__ __forceinline__ void dec_load(uint32_t slot, const Pools& p,
                                         const int* tab, int pos0,
                                         int length, int pshift, int Hkv,
                                         int h, int lane) {
  using R = Raw<D, KIND>;
  using L = DecLayout<D, KIND>;
  constexpr int CT = DEC_CT, CPR = R::ROW / 16;
  const int pmask = (1 << pshift) - 1;
#pragma unroll
  for (int i = lane; i < CT * CPR; i += 32) {
    const int t = i / CPR, c = i % CPR, pos = pos0 + t;
    const bool in = (pos & ~pmask) <= length;
    const size_t phys = in ? tab[pos >> pshift] : 0;
    const size_t off =
        in ? (((phys << pshift) + (pos & pmask)) * Hkv + h) * R::ROW + c * 16
           : 0;
#pragma unroll
    for (int a = 0; a < R::NARR; ++a)
      cp_async16(slot + (a * CT + t) * L::RAW_ROW + c * 16,
                 static_cast<const unsigned char*>(p.arr[a]) + off, in);
  }
  if constexpr (R::SCALED) {
#pragma unroll
    for (int i = lane; i < 2 * CT; i += 32) {
      const int t = i % CT, pos = pos0 + t;
      const bool in = (pos & ~pmask) <= length;
      const size_t phys = in ? tab[pos >> pshift] : 0;
      const size_t row = ((phys << pshift) + (pos & pmask)) * Hkv + h;
      cp_async4(slot + R::NARR * CT * L::RAW_ROW + i * 4,
                (i < CT ? p.scale[0] : p.scale[1]) + (in ? row : 0), in);
    }
  }
}

// Block (lane s, KV head h, split j); the G <= 16 query rows of the KV
// head are the rows of one mma tile (rows past G are zero).  part:
// scratch, acc (S, Hkv, NS, G, D) then m and l (S, Hkv, NS, G).
template <int D, int KIND>
__global__ void __launch_bounds__(DEC_THREADS) paged_decode_split_kernel(
    const __nv_bfloat16* __restrict__ q, Pools pools,
    const int* __restrict__ tables, const int* __restrict__ lengths,
    __nv_bfloat16* __restrict__ out, float* __restrict__ part, int S,
    int Hkv, int G, int pshift, int maxp) {
  using L = DecLayout<D, KIND>;
  using R = Raw<D, KIND>;
  constexpr int ST = L::ST;
  constexpr int CH_SPLIT = SPLIT_TOKENS / DEC_CT;   // chunks a split
  extern __shared__ __align__(16) unsigned char smem[];

  const int s = blockIdx.x / Hkv, h = blockIdx.x - s * Hkv;
  const int j = blockIdx.y, NS = gridDim.y;
  const int length = lengths[s];
  const int n_split = length / SPLIT_TOKENS + 1;    // splits with work
  if (j >= n_split) return;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3, r_lo = lane >> 2;
  const int* tab = tables + static_cast<size_t>(s) * maxp;

  // q's A fragments: rows r_lo and r_lo + 8, dims 2 tq (+1) and + 8
  const size_t head = (static_cast<size_t>(s) * Hkv + h) * G;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r_lo + 8 * (i & 1);
      qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(
                                q + (head + row) * D + kk * 16 + 2 * tq +
                                8 * (i >> 1))
                          : 0u;
    }
  }
  auto qfrag = [&](int kk, uint32_t(&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qa[kk][i];
  };

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG};
  float l_r[2] = {0.f, 0.f};
  const int p_row[2] = {length, length};

  // this warp's chunks: c0 + warp, c0 + warp + DEC_WARPS, ... up to the
  // chunk holding `length`
  const int c0 = j * CH_SPLIT;
  const int c_end = min(c0 + CH_SPLIT, length / DEC_CT + 1);
  const int n_mine = c_end - c0 > warp
                         ? (c_end - c0 - warp + DEC_WARPS - 1) / DEC_WARPS
                         : 0;
  unsigned char* ring = smem + warp * L::WARP;
  unsigned char* ctile = ring + DEC_STAGES * L::SLOT;
  const uint32_t ring_u = smem_u32(ring);
  const int lr = lane & 7, lm = lane >> 3;
  const int a_off = ((lm & 1) * 8 + lr) * ST + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * ST + (lm & 1) * 8;
#pragma unroll
  for (int k = 0; k < DEC_STAGES - 1; ++k) {
    if (k < n_mine)
      dec_load<D, KIND>(ring_u + k * L::SLOT, pools, tab,
                        (c0 + warp + k * DEC_WARPS) * DEC_CT, length, pshift,
                        Hkv, h, lane);
    cp_async_commit();
  }
  for (int k = 0; k < n_mine; ++k) {
    cp_async_wait<DEC_STAGES - 2>();   // chunk k has landed ...
    __syncwarp();                      // ... for every lane; k - 1 is read
    if (k + DEC_STAGES - 1 < n_mine)
      dec_load<D, KIND>(
          ring_u + ((k + DEC_STAGES - 1) % DEC_STAGES) * L::SLOT, pools, tab,
          (c0 + warp + (k + DEC_STAGES - 1) * DEC_WARPS) * DEC_CT, length,
          pshift, Hkv, h, lane);
    cp_async_commit();
    const unsigned char* slot = ring + (k % DEC_STAGES) * L::SLOT;
    const int pos0 = (c0 + warp + k * DEC_WARPS) * DEC_CT;
    const float* ks = nullptr;
    const float* vs = nullptr;
    uint32_t kb, vb, kb2 = 0, vb2 = 0;
    if constexpr (KIND == KV_BF16) {
      kb = smem_u32(slot) + b_off * 2;
      vb = smem_u32(slot) + L::TILE + a_off * 2;
    } else {
      constexpr int CPR = R::ROW / 16;
#pragma unroll
      for (int a = 0; a < R::NARR; ++a) {
        const float mul =
            KIND == KV_SC && a < 2 ? static_cast<float>(1 << SC_SHIFT) : 1.f;
#pragma unroll
        for (int i = lane; i < DEC_CT * CPR; i += 32) {
          const int t = i / CPR, c = i % CPR;
          widen16(slot + (a * DEC_CT + t) * R::ROW + c * 16, mul,
                  ctile + a * L::TILE + (t * ST + c * 16) * 2);
        }
      }
      __syncwarp();
      ks = reinterpret_cast<const float*>(slot +
                                          R::NARR * DEC_CT * R::ROW);
      vs = ks + DEC_CT;
      const uint32_t ct = smem_u32(ctile);
      kb = ct + b_off * 2;
      vb = ct + L::TILE + a_off * 2;
      kb2 = ct + 2 * L::TILE + b_off * 2;
      vb2 = ct + 3 * L::TILE + a_off * 2;
    }
    if (pos0 + DEC_CT - 1 > length)
      attn_tile<D, KIND, true, DEC_CT>(qfrag, o, m_r, l_r, kb, vb, kb2, vb2,
                                       ks, vs, pos0, p_row, tq);
    else
      attn_tile<D, KIND, false, DEC_CT>(qfrag, o, m_r, l_r, kb, vb, kb2,
                                        vb2, ks, vs, pos0, p_row, tq);
  }
  cp_async_wait<0>();                  // no copy outlives the block

  // this warp's partials, rows < G, into shared memory
  float* wm = reinterpret_cast<float*>(smem + DEC_WARPS * L::WARP);
  float* wl = wm + DEC_WARPS * G;
  float* wacc = wl + DEC_WARPS * G;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = r_lo + 8 * i;
    if (row >= G) continue;
    float* ap = wacc + (warp * G + row) * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(ap + n * 8) =
          make_float2(o[n][2 * i], o[n][2 * i + 1]);
    if (tq == 0) {
      wm[warp * G + row] = m_r[i];
      wl[warp * G + row] = l_r[i];
    }
  }
  __syncthreads();

  // merge the warps in warp order (a warp without a chunk weighs 0)
  for (int e = threadIdx.x; e < G * D; e += DEC_THREADS) {
    const int r = e / D, d = e - r * D;
    float ms = NEG_BIG;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) ms = fmaxf(ms, wm[w * G + r]);
    float Ls = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < DEC_WARPS; ++w) {
      const float a = expf(wm[w * G + r] - ms);
      Ls += wl[w * G + r] * a;
      A += wacc[(w * G + r) * D + d] * a;
    }
    if (n_split == 1) {
      out[(head + r) * D + d] = __float2bfloat16(A / fmaxf(Ls, 1e-30f));
    } else {
      const size_t pr = ((static_cast<size_t>(s) * Hkv + h) * NS + j) * G + r;
      part[pr * D + d] = A;
      if (d == 0) {
        const size_t n_rows = static_cast<size_t>(S) * Hkv * NS * G;
        part[n_rows * D + pr] = ms;
        part[n_rows * (D + 1) + pr] = Ls;
      }
    }
  }
}

// The log-sum-exp merge of a lane's splits, in split order (the
// reference's flash-decoding combine); lanes with one split are done.
// Block (lane, KV head), its threads striding over (row, dim).
constexpr int DEC_COMBINE_THREADS = 256;
__global__ void __launch_bounds__(DEC_COMBINE_THREADS)
paged_decode_combine_kernel(const float* __restrict__ part,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out, int S, int Hkv,
                            int G, int D, int NS) {
  const int s = blockIdx.x / Hkv;
  const int n_split = lengths[s] / SPLIT_TOKENS + 1;
  if (n_split == 1) return;
  const size_t n_rows = static_cast<size_t>(S) * Hkv * NS * G;
  for (int e = threadIdx.x; e < G * D; e += DEC_COMBINE_THREADS) {
    const int r = e / D, d = e - r * D;
    const size_t r0 = static_cast<size_t>(blockIdx.x) * NS * G + r;
    float ms = NEG_BIG;
    for (int j = 0; j < n_split; ++j)
      ms = fmaxf(ms, part[n_rows * D + r0 + j * G]);
    float L = 0.f, A = 0.f;
    for (int j = 0; j < n_split; ++j) {
      const size_t pr = r0 + j * G;
      const float a = expf(part[n_rows * D + pr] - ms);
      L += part[n_rows * (D + 1) + pr] * a;
      A += part[pr * D + d] * a;
    }
    out[(static_cast<size_t>(blockIdx.x) * G + r) * D + d] =
        __float2bfloat16(A / fmaxf(L, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q: tensor-core prefill
// ---------------------------------------------------------------------------

constexpr int PF_BK = 64;               // keys a tile (absolute positions)
constexpr int PF_SPLIT_KEYS = 1024;     // keys a prefill split covers
constexpr int PF_STAGES = 3;            // tiles in the ring
constexpr int PF_MAX_ROWS = 128;        // rows a block: 8 warps of 16

// Shared memory of the prefill kernel, in bytes: the ring of PF_STAGES raw
// tiles (bf16 pools: the K and V tiles themselves, rows padded to D + 8
// elements for conflict-free ldmatrix; int8 / sc: the codes and residuals
// as copied, then the K and V scales), the bf16 tiles the products read
// (int8: K, V; sc: 16 code and resid of K, then of V), then q.
template <int D, int KIND>
struct PfLayout {
  using R = Raw<D, KIND>;
  static constexpr int ST = D + 8;                    // padded row, elems
  static constexpr int TILE = PF_BK * ST * 2;         // one bf16 tile
  static constexpr int SLOT =
      KIND == KV_BF16 ? 2 * TILE : R::NARR * PF_BK * D + 2 * PF_BK * 4;
  static constexpr int NCT = KIND == KV_BF16 ? 0 : R::NARR;
  static constexpr int CT_OFF = PF_STAGES * SLOT;     // compute tiles
  static constexpr int Q_OFF = CT_OFF + NCT * TILE;
  static size_t bytes(int rows) {
    return static_cast<size_t>(Q_OFF) + static_cast<size_t>(rows) * ST * 2;
  }
};

// q (G, C, Hkv, Gq, D); grid (G Hkv, ceil(C / bq), key splits), 16 rows a
// warp, bq Gq <= PF_MAX_ROWS rows a block, position-major.  Block (.., j)
// walks the tiles of keys [j PF_SPLIT_KEYS, (j + 1) PF_SPLIT_KEYS) up to
// its causal horizon.  A row whose position lies in split 0 writes its
// output from block j = 0; otherwise each split j <= position /
// PF_SPLIT_KEYS writes the row's (acc, m, l) to `part`
// (acc (rows, NS, D), then m and l (rows, NS); rows in q's order) for
// paged_prefill_combine_kernel.
template <int D, int KIND>
__global__ void __launch_bounds__(32 * PF_MAX_ROWS / 16,
                                  KIND == KV_SC || D > 64 ? 1 : 2)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, Pools pools,
                         const int* __restrict__ tables,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ part, int C, int Hkv, int Gq,
                         int pshift, int width, int start, int bq) {
  using Lay = PfLayout<D, KIND>;
  using R = Raw<D, KIND>;
  constexpr int ST = Lay::ST;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x / Hkv, h = blockIdx.x - g * Hkv;
  const int row0 = blockIdx.y * bq;                  // first position
  const int n_rows = min(bq, C - row0) * Gq;         // real rows
  const int rows_pad = nthr / 2;                     // 16 a warp
  const int hi_pos = start + row0 + (n_rows - 1) / Gq;
  constexpr int TPS = PF_SPLIT_KEYS / PF_BK;         // tiles a split
  const int j = blockIdx.z, NS = gridDim.z;
  const int t0 = j * TPS;
  if (t0 * PF_BK > hi_pos) return;                   // wholly in the future
  const int n_tiles = min(hi_pos / PF_BK + 1, t0 + TPS) - t0;
  const int kv_end = start + C;                      // keys written
  const int pmask = (1 << pshift) - 1;
  const int* tab = tables + static_cast<size_t>(g) * width;
  const uint32_t smem_base = smem_u32(smem);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem + Lay::Q_OFF);

  // q rows: row i is position row0 + i / Gq of head i % Gq
  for (int e = tid; e < rows_pad * (D / 8); e += nthr) {
    const int i = e / (D / 8), c = (e % (D / 8)) * 8;
    const bool in = i < n_rows;
    const size_t src =
        in ? ((((static_cast<size_t>(g) * C + row0 + i / Gq) * Hkv + h) *
                   Gq + i % Gq) * D + c)
           : 0;
    cp_async16(smem_u32(q_s + i * ST + c), q + src, in);
  }
  // tile t0 + t of K / V into ring slot t % PF_STAGES; keys past kv_end
  // zero-filled without reading their table lane
  auto load_tile = [&](int t) {
    const uint32_t slot = smem_base + (t % PF_STAGES) * Lay::SLOT;
    t += t0;
    constexpr int CPR = R::ROW / 16;
    for (int e = tid; e < PF_BK * CPR; e += nthr) {
      const int r = e / CPR, c = e % CPR, key = t * PF_BK + r;
      const bool in = key < kv_end;
      const size_t phys = in ? tab[key >> pshift] : 0;
      const size_t off =
          in ? (((phys << pshift) + (key & pmask)) * Hkv + h) * R::ROW +
                   c * 16
             : 0;
#pragma unroll
      for (int a = 0; a < R::NARR; ++a) {
        const uint32_t dst =
            KIND == KV_BF16 ? slot + a * Lay::TILE + (r * ST * 2 + c * 16)
                            : slot + (a * PF_BK + r) * R::ROW + c * 16;
        cp_async16(dst, static_cast<const unsigned char*>(pools.arr[a]) + off,
                   in);
      }
    }
    if constexpr (R::SCALED) {
      for (int e = tid; e < 2 * PF_BK; e += nthr) {
        const int key = t * PF_BK + e % PF_BK;
        const bool in = key < kv_end;
        const size_t phys = in ? tab[key >> pshift] : 0;
        const size_t row = ((phys << pshift) + (key & pmask)) * Hkv + h;
        cp_async4(slot + R::NARR * PF_BK * R::ROW + e * 4,
                  (e < PF_BK ? pools.scale[0] : pools.scale[1]) +
                      (in ? row : 0),
                  in);
      }
    }
  };
  load_tile(0);
  cp_async_commit();                                 // q and tile 0
#pragma unroll
  for (int t = 1; t < PF_STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  const int lr = lane & 7, lm = lane >> 3;
  const int a_off = ((lm & 1) * 8 + lr) * ST + (lm >> 1) * 8;
  const int b_off = ((lm >> 1) * 8 + lr) * ST + (lm & 1) * 8;
  const uint32_t q_base = smem_u32(q_s + warp * 16 * ST + a_off);
  // q's A fragments, read again by ldmatrix each tile (held in registers
  // they would push the kernel past 128)
  auto qfrag = [&](int kk, uint32_t(&a)[4]) {
    ldsm_x4(a, q_base + kk * 16 * 2);
  };
  const int tq = lane & 3;
  const int w_lo = warp * 16;                        // first row
  const bool w_live = w_lo < n_rows;
  const int w_pos_lo = start + row0 + w_lo / Gq;
  const int w_pos_hi = start + row0 + (min(w_lo + 15, n_rows - 1)) / Gq;
  const int i_lo = w_lo + (lane >> 2);
  const int p_row[2] = {start + row0 + i_lo / Gq,
                        start + row0 + (i_lo + 8) / Gq};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_r[2] = {NEG_BIG, NEG_BIG};
  float l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<PF_STAGES - 2>();                  // tile t has landed ...
    __syncthreads();                                 // ... everywhere; t - 1
    if (t + PF_STAGES - 1 < n_tiles)                 // is consumed
      load_tile(t + PF_STAGES - 1);
    cp_async_commit();
    const uint32_t slot = smem_base + (t % PF_STAGES) * Lay::SLOT;
    const float* ks = nullptr;
    const float* vs = nullptr;
    uint32_t kb, vb, kb2 = 0, vb2 = 0;
    if constexpr (KIND == KV_BF16) {
      kb = slot + b_off * 2;
      vb = slot + Lay::TILE + a_off * 2;
    } else {
      // widen this thread's own copies of tile t to the bf16 tiles
      const unsigned char* raw = smem + (t % PF_STAGES) * Lay::SLOT;
      constexpr int CPR = R::ROW / 16;
#pragma unroll
      for (int a = 0; a < R::NARR; ++a) {
        // sc codes (arrays 0, 1) enter as 16 code: exact in bf16
        const float mul =
            KIND == KV_SC && a < 2 ? static_cast<float>(1 << SC_SHIFT) : 1.f;
        for (int e = tid; e < PF_BK * CPR; e += nthr) {
          const int r = e / CPR, c = e % CPR;
          widen16(raw + (a * PF_BK + r) * R::ROW + c * 16, mul,
                  smem + Lay::CT_OFF + a * Lay::TILE + (r * ST + c * 16) * 2);
        }
      }
      __syncthreads();
      ks = reinterpret_cast<const float*>(raw + R::NARR * PF_BK * R::ROW);
      vs = ks + PF_BK;
      const uint32_t ct = smem_base + Lay::CT_OFF;
      kb = ct + b_off * 2;
      vb = ct + Lay::TILE + a_off * 2;
      kb2 = ct + 2 * Lay::TILE + b_off * 2;
      vb2 = ct + 3 * Lay::TILE + a_off * 2;
    }
    const int key0 = (t0 + t) * PF_BK;
    // a warp without rows, or whose rows all precede the tile, skips it
    if (!w_live || key0 > w_pos_hi) continue;
    if (key0 + PF_BK - 1 > w_pos_lo)
      attn_tile<D, KIND, true, PF_BK>(qfrag, o, m_r, l_r, kb, vb, kb2, vb2,
                                      ks, vs, key0, p_row, tq);
    else
      attn_tile<D, KIND, false, PF_BK>(qfrag, o, m_r, l_r, kb, vb, kb2,
                                       vb2, ks, vs, key0, p_row, tq);
  }
  cp_async_wait<0>();                                // no copy outlives it

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
    l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
    const int row = i_lo + 8 * i;
    // a row writes only from the splits up to its own position's: a later
    // split's block saw none of its keys
    if (row >= n_rows || j > p_row[i] / PF_SPLIT_KEYS) continue;
    // the row's index in q's (G, C, Hkv, Gq) order
    const size_t rid =
        ((static_cast<size_t>(g) * C + row0 + row / Gq) * Hkv + h) * Gq +
        row % Gq;
    if (p_row[i] < PF_SPLIT_KEYS) {                  // one split: done
      const float lc = fmaxf(l_r[i], 1e-30f);
      __nv_bfloat16* op = out + rid * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(op + n * 8) =
            __floats2bfloat162_rn(o[n][2 * i] / lc, o[n][2 * i + 1] / lc);
      }
    } else {
      const size_t pr = rid * NS + j;
      float* ap = part + pr * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(ap + n * 8) =
            make_float2(o[n][2 * i], o[n][2 * i + 1]);
      if (tq == 0) {
        const size_t n_part =
            static_cast<size_t>(gridDim.x) * C * Gq * NS;   // rows x NS
        part[n_part * D + pr] = m_r[i];
        part[n_part * (D + 1) + pr] = l_r[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 q at D 64 / 128 on 16-position pages: the wgmma prefill
// ---------------------------------------------------------------------------

constexpr int PW_PAGE = 16;                        // the page size it takes
constexpr int PW_CONSUMERS = 2;                    // warpgroups of 64 rows
constexpr int PW_THREADS = 128 * (PW_CONSUMERS + 1);
constexpr int PW_TAB = PF_SPLIT_KEYS / PW_PAGE;    // table lanes a split

// Shared memory of paged_prefill_wgmma_kernel, from a 1024-byte aligned
// base: STAGES bf16 stages, each a K and a V tile of PF_BK keys as D / 64
// boxes of PF_BK rows x 128 bytes in 128B swizzle (the layout wgmma's
// descriptors read); for int8 / sc pools RAW_STAGES raw stages (K codes,
// V codes, then K and V residuals for sc, each PF_BK rows x D bytes as TMA
// lands them); the consumers' q rows (64 rows a warpgroup, in boxes like
// K's); the stages' K and V scales; the split's table lanes; the
// barriers (K full, V full, empty: a stage each; raw full: a raw stage
// each).  Every box starts 1024-byte aligned, as the swizzle's phase needs.
template <int D, int KIND>
struct PwLayout {
  static_assert(D == 64 || D == 128, "D must be 64 or 128");
  static constexpr int BOXES = D / 64;
  static constexpr int TILE = PF_BK * D * 2;            // a bf16 K or V tile
  static constexpr int STAGES = KIND == KV_BF16 ? 4 : 3;
  static constexpr int RAW_STAGES = KIND == KV_BF16 ? 0 : 3;
  static constexpr int RAW_TILE = PF_BK * D;            // one int8 array
  static constexpr int RAW = Raw<D, KIND>::NARR * RAW_TILE;
  static constexpr int RAW_OFF = STAGES * 2 * TILE;
  static constexpr int Q_WG = 64 * D * 2;
  static constexpr int Q_OFF = RAW_OFF + RAW_STAGES * RAW;
  static constexpr int SCALE_OFF = Q_OFF + PW_CONSUMERS * Q_WG;
  static constexpr int TAB_OFF =
      SCALE_OFF + (Raw<D, KIND>::SCALED ? STAGES * 2 * PF_BK * 4 : 0);
  static constexpr int BAR_OFF = TAB_OFF + PW_TAB * 4;
  static constexpr size_t BYTES =
      1024 + BAR_OFF + 8 * (3 * STAGES + RAW_STAGES);
  // registers a producer / consumer thread keeps (setmaxnreg): the
  // launch's 168 a thread (65536 / PW_THREADS, rounded down to 8) given
  // from the producer to the two consumer warpgroups; a widening producer
  // keeps enough to have a tile's shared-memory loads in flight at once
  static constexpr int PRODUCER_REGS = KIND == KV_BF16 ? 24 : 72;
  static constexpr int CONSUMER_REGS = KIND == KV_BF16 ? 240 : 216;
};

// 16 int8 codes (and for sc their 16 residuals) as 16 bf16 values: the
// code (int8), or the joined 16 code + resid (sc), exact in bf16 for every
// pool kv_quant writes (|16 code + resid| <= 136; see the header).  Each
// byte b becomes the float 2^23 + (b + 128) by one PRMT (no I2F); the
// joined value is (c - B) 16 + r - B with B = 2^23 + 128, every step exact.
template <int KIND>
__device__ __forceinline__ void widen_joined(uint4 code, uint4 resid,
                                             uint32_t (&w)[8]) {
  constexpr float B = 8388736.0f;
  const uint32_t c[4] = {code.x ^ 0x80808080u, code.y ^ 0x80808080u,
                         code.z ^ 0x80808080u, code.w ^ 0x80808080u};
  const uint32_t r[4] = {resid.x ^ 0x80808080u, resid.y ^ 0x80808080u,
                         resid.z ^ 0x80808080u, resid.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      f[b] = __uint_as_float(__byte_perm(c[i], 0x4B000000u, 0x7440u + b)) -
             B;
      if constexpr (KIND == KV_SC)
        f[b] = fmaf(f[b], static_cast<float>(1 << SC_SHIFT),
                    __uint_as_float(
                        __byte_perm(r[i], 0x4B000000u, 0x7440u + b))) -
               B;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    w[2 * i] = *reinterpret_cast<const uint32_t*>(&lo);
    w[2 * i + 1] = *reinterpret_cast<const uint32_t*>(&hi);
  }
}

// The online softmax of one consumer's 64 x PF_BK tile of S: s[4 n + e]
// is row r_lo (+ 8 for e >= 2), key key0 + 8 n + 2 tq + (e & 1).  x = the
// logit times the key's K scale (int8, sc; times 2^-SC_SHIFT for sc, as
// the producer stored it), NEG_BIG where MASK and the key lies past the
// row's position; the row max over the quad; l moved to the new base by
// corr = 2^(old - new); the weights p = 2^(c x - base), c = log2(e) /
// sqrt(D), in place of s and into l (masked weights 0).
template <int KIND, bool MASK>
__device__ __forceinline__ void pw_weights(float (&s)[32], float (&m_r)[2],
                                           float (&l_r)[2], float (&corr)[2],
                                           const float* ks, float c,
                                           int key0, const int (&p_row)[2],
                                           int tq) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < PF_BK / 8; ++n) {
    float2 k2 = make_float2(1.f, 1.f);
    if constexpr (KIND != KV_BF16)
      k2 = *reinterpret_cast<const float2*>(ks + 8 * n + 2 * tq);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * n + e];
      if constexpr (KIND != KV_BF16) x *= (e & 1) ? k2.y : k2.x;
      if constexpr (MASK) {
        if (key0 + 8 * n + 2 * tq + (e & 1) > p_row[e >> 1]) x = NEG_BIG;
      }
      s[4 * n + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float base[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    base[i] = __fmul_rn(mx[i], c);
    corr[i] = ex2(__fmul_rn(m_r[i], c) - base[i]);
    m_r[i] = mx[i];
    l_r[i] *= corr[i];
  }
#pragma unroll
  for (int n = 0; n < PF_BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ex2(fmaf(s[4 * n + e], c, -base[e >> 1]));
      if constexpr (MASK) {
        if (s[4 * n + e] == NEG_BIG) p = 0.f;
      }
      s[4 * n + e] = p;
      l_r[e >> 1] += p;
    }
  }
}

// Once the previous P V has landed: O moved to the new base (only when
// some row max of the warp moved), and the weights, times the keys' V
// scales (int8, sc), as bf16 hi + lo A fragments of 16 keys each (the C
// layout of S is the A layout of its 16-key slices).
template <int D, int KIND>
__device__ __forceinline__ void pw_pack(const float (&s)[32],
                                        const float (&corr)[2],
                                        float (&o)[D / 64][32],
                                        uint32_t (&p_hi)[PF_BK / 16][4],
                                        uint32_t (&p_lo)[PF_BK / 16][4],
                                        const float* vs, int tq) {
  if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
    for (int cc = 0; cc < D / 64; ++cc)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[cc][e] *= corr[(e >> 1) & 1];
  }
#pragma unroll
  for (int kk = 0; kk < PF_BK / 16; ++kk) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = 2 * kk + hh;
      float p[4] = {s[4 * n], s[4 * n + 1], s[4 * n + 2], s[4 * n + 3]};
      if constexpr (KIND != KV_BF16) {
        const float2 v2 = *reinterpret_cast<const float2*>(vs + 8 * n +
                                                           2 * tq);
        p[0] *= v2.x;
        p[1] *= v2.y;
        p[2] *= v2.x;
        p[3] *= v2.y;
      }
      wg_split(p[0], p[1], p_hi[kk][2 * hh], p_lo[kk][2 * hh]);
      wg_split(p[2], p[3], p_hi[kk][2 * hh + 1], p_lo[kk][2 * hh + 1]);
    }
  }
}

// q (G, C, Hkv, Gq, D); grid (G Hkv, ceil(C / bq), key splits) as
// paged_prefill_mma_kernel's, 128 (nc + 1) threads for nc = ceil(bq Gq /
// 64) consumer warpgroups: block rows position-major (row i = position
// row0 + i / Gq, head i % Gq), 64 a consumer.  Maps over the pools as
// (D, Hkv, page, N): k_map / v_map the bf16 values (64-column boxes of a
// page, 128B swizzle) or the int8 codes (D-byte rows of a page), kr_map /
// vr_map the sc residuals (int8, sc only; otherwise copies nothing
// reads).  A page past the chunk's last is read as page n_pages, past the
// pool: TMA fills it with zeros and reads nothing.  Outputs, partials and
// their merge as paged_prefill_mma_kernel's, m of a partial in log2 units
// (paged_prefill_combine_kernel<D, true>).
template <int D, int KIND>
__global__ void __launch_bounds__(PW_THREADS, 1)
paged_prefill_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap kr_map,
                           const __grid_constant__ CUtensorMap vr_map,
                           const __nv_bfloat16* __restrict__ q,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ tables,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ part, int C, int Hkv, int Gq,
                           int width, int start, int bq, int n_pages) {
  using L = PwLayout<D, KIND>;
  constexpr int TPS = PF_SPLIT_KEYS / PF_BK;         // tiles a split
  constexpr float SCL = KIND == KV_SC ? 1.0f / (1 << SC_SHIFT) : 1.0f;
  constexpr float CL = LOG2E / sqrt_d<D>();          // logits -> log2 units
  extern __shared__ __align__(1024) unsigned char pw_smem[];
  const uint32_t base = (smem_u32(pw_smem) + 1023) & ~1023u;
  unsigned char* const sm = pw_smem + (base - smem_u32(pw_smem));
  const uint32_t k_full = base + L::BAR_OFF;
  const uint32_t v_full = k_full + 8 * L::STAGES;
  const uint32_t empty = v_full + 8 * L::STAGES;
  const uint32_t raw_full = empty + 8 * L::STAGES;
  int* const tab_s = reinterpret_cast<int*>(sm + L::TAB_OFF);
  // stage st's K scales at scale_s + 2 st PF_BK, its V scales after them
  float* const scale_s = reinterpret_cast<float*>(sm + L::SCALE_OFF);

  const int g = blockIdx.x / Hkv, h = blockIdx.x - g * Hkv;
  const int row0 = blockIdx.y * bq;                  // first position
  const int n_rows = min(bq, C - row0) * Gq;         // real rows
  const int hi_pos = start + row0 + (n_rows - 1) / Gq;
  const int j = blockIdx.z, NS = gridDim.z;
  const int t0 = j * TPS;
  if (t0 * PF_BK > hi_pos) return;                   // wholly in the future
  const int n_tiles = min(hi_pos / PF_BK + 1, t0 + TPS) - t0;
  const int live_pages = (start + C) / PW_PAGE;      // pages holding keys
  const int nc = blockDim.x / 128 - 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(k_full + 8 * s, KIND == KV_BF16 ? 1 : 128);
      mbar_init(v_full + 8 * s, KIND == KV_BF16 ? 1 : 128);
      mbar_init(empty + 8 * s, 128 * nc);
    }
    for (int s = 0; s < L::RAW_STAGES; ++s) mbar_init(raw_full + 8 * s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == nc) {
    // the producer warpgroup
    setmaxnreg_dec<L::PRODUCER_REGS>();
    const int pt = threadIdx.x - 128 * nc;
    // the block's table lanes; past the chunk's last page, n_pages
    const int* tab = tables + static_cast<size_t>(g) * width;
    for (int i = pt; i < 4 * n_tiles; i += 128) {
      const int pg = (PF_BK / PW_PAGE) * t0 + i;
      tab_s[i] = pg < live_pages ? tab[pg] : n_pages;
    }
    named_sync(1, 128);
    if constexpr (KIND == KV_BF16) {
      // one thread loads each tile's pages straight into a stage
      if (pt == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int st = t % L::STAGES;
          if (t >= L::STAGES)
            mbar_wait(empty + 8 * st, (t / L::STAGES - 1) & 1);
          const uint32_t kd = base + st * 2 * L::TILE;
          mbar_expect_tx(k_full + 8 * st, L::TILE);
#pragma unroll
          for (int p = 0; p < PF_BK / PW_PAGE; ++p)
#pragma unroll
            for (int c = 0; c < L::BOXES; ++c)
              tma_load_4d(kd + c * PF_BK * 128 + p * PW_PAGE * 128, &k_map,
                          k_full + 8 * st, 64 * c, h, 0, tab_s[4 * t + p]);
          mbar_expect_tx(v_full + 8 * st, L::TILE);
#pragma unroll
          for (int p = 0; p < PF_BK / PW_PAGE; ++p)
#pragma unroll
            for (int c = 0; c < L::BOXES; ++c)
              tma_load_4d(kd + L::TILE + c * PF_BK * 128 + p * PW_PAGE * 128,
                          &v_map, v_full + 8 * st, 64 * c, h, 0,
                          tab_s[4 * t + p]);
        }
      }
    } else {
      // one thread keeps the raw ring full; the warpgroup widens each raw
      // tile into a stage and loads the tile's scales (thread pt: key
      // pt % PF_BK, of K below PF_BK, of V from it)
      auto issue_raw = [&](int t) {
        const int rs = t % L::RAW_STAGES;
        const uint32_t rd = base + L::RAW_OFF + rs * L::RAW;
        const uint32_t bar = raw_full + 8 * rs;
        mbar_expect_tx(bar, L::RAW);
#pragma unroll
        for (int p = 0; p < PF_BK / PW_PAGE; ++p) {
          const int phys = tab_s[4 * t + p];
          const uint32_t off = p * PW_PAGE * D;
          tma_load_4d(rd + off, &k_map, bar, 0, h, 0, phys);
          tma_load_4d(rd + L::RAW_TILE + off, &v_map, bar, 0, h, 0, phys);
          if constexpr (KIND == KV_SC) {
            tma_load_4d(rd + 2 * L::RAW_TILE + off, &kr_map, bar, 0, h, 0,
                        phys);
            tma_load_4d(rd + 3 * L::RAW_TILE + off, &vr_map, bar, 0, h, 0,
                        phys);
          }
        }
      };
      if (pt == 0)
        for (int t = 0; t < L::RAW_STAGES - 1 && t < n_tiles; ++t)
          issue_raw(t);
      const float* scales = pt < PF_BK ? k_scale : v_scale;
      const int key = pt % PF_BK;
      // this thread's scale of tile t (0 past the chunk's last page),
      // loaded a tile ahead of its use
      auto scale_of = [&](int t) {
        const int phys = tab_s[4 * t + key / PW_PAGE];
        return phys < n_pages
                   ? scales[(static_cast<size_t>(phys) * PW_PAGE +
                             key % PW_PAGE) * Hkv + h] * SCL
                   : 0.f;
      };
      constexpr int UNITS = PF_BK * D / 16;          // 16 codes a unit
      static_assert(UNITS % 128 == 0, "whole units a producer thread");
      float sc_next = scale_of(0);
      for (int t = 0; t < n_tiles; ++t) {
        // raw stage (t - 1) % RAW_STAGES was read by every thread
        if (pt == 0 && t + L::RAW_STAGES - 1 < n_tiles)
          issue_raw(t + L::RAW_STAGES - 1);
        const float sc = sc_next;
        if (t + 1 < n_tiles) sc_next = scale_of(t + 1);
        const int st = t % L::STAGES;
        if (t >= L::STAGES) mbar_wait(empty + 8 * st, (t / L::STAGES - 1) & 1);
        mbar_wait(raw_full + 8 * (t % L::RAW_STAGES),
                  (t / L::RAW_STAGES) & 1);
        const unsigned char* raw =
            sm + L::RAW_OFF + (t % L::RAW_STAGES) * L::RAW;
        unsigned char* tile = sm + st * 2 * L::TILE;
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {             // K, then V
#pragma unroll
          for (int i = 0; i < UNITS / 128; ++i) {
            const int u = pt + 128 * i;
            const int r = u / (D / 16), cu = u % (D / 16);
            const uint4 code = *reinterpret_cast<const uint4*>(
                raw + kv * L::RAW_TILE + r * D + cu * 16);
            uint4 resid = make_uint4(0, 0, 0, 0);
            if constexpr (KIND == KV_SC)
              resid = *reinterpret_cast<const uint4*>(
                  raw + (2 + kv) * L::RAW_TILE + r * D + cu * 16);
            uint32_t w[8];
            widen_joined<KIND>(code, resid, w);
            // columns 16 cu .. + 15: chunks 2 (cu % 4) and + 1 of box cu / 4
            unsigned char* row = tile + kv * L::TILE +
                                 (cu / 4) * PF_BK * 128 + r * 128;
            const int c0 = 2 * (cu % 4);
            *reinterpret_cast<uint4*>(row + ((c0 ^ (r & 7)) << 4)) =
                make_uint4(w[0], w[1], w[2], w[3]);
            *reinterpret_cast<uint4*>(row + (((c0 + 1) ^ (r & 7)) << 4)) =
                make_uint4(w[4], w[5], w[6], w[7]);
          }
          if ((pt >= PF_BK) == (kv == 1))
            scale_s[(2 * st + kv) * PF_BK + key] = sc;
          fence_async_smem();                        // for wgmma's reads
          mbar_arrive((kv == 0 ? k_full : v_full) + 8 * st);
        }
        named_sync(1, 128);
      }
    }
  } else {
    // a consumer: 64 rows, 16 a warp
    setmaxnreg_inc<L::CONSUMER_REGS>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int tq = lane & 3;
    // this warpgroup's q rows into its boxes (rows past the block zero)
    const uint32_t qs = base + L::Q_OFF + wg * L::Q_WG;
    for (int e = tid; e < 64 * (D / 8); e += 128) {
      const int i = e / (D / 8), k = e % (D / 8);
      const int bi = 64 * wg + i;
      const bool in = bi < n_rows;
      const size_t src =
          in ? ((((static_cast<size_t>(g) * C + row0 + bi / Gq) * Hkv + h) *
                     Gq + bi % Gq) * D + 8 * k)
             : 0;
      cp_async16(qs + (k / 8) * 64 * 128 + i * 128 + (((k % 8) ^ (i & 7)) << 4),
                 q + src, in);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_async_smem();
    named_sync(2 + wg, 128);

    const int r_lo = 64 * wg + 16 * warp + (lane >> 2);   // and r_lo + 8
    const int p_row[2] = {start + row0 + r_lo / Gq,
                          start + row0 + (r_lo + 8) / Gq};
    const int w_pos_lo = start + row0 + (64 * wg + 16 * warp) / Gq;
    float o[L::BOXES][32];
#pragma unroll
    for (int cc = 0; cc < L::BOXES; ++cc)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[cc][e] = 0.f;
    float m_r[2] = {NEG_BIG, NEG_BIG};
    float l_r[2] = {0.f, 0.f};
    float s[32];                                     // S of the tile
    float corr[2];
    uint32_t p_hi[PF_BK / 16][4], p_lo[PF_BK / 16][4];

    // descriptors, built once: q's boxes, stage 0's K boxes (K-major: 8-row
    // groups 1024 bytes apart) and V boxes (MN-major through the
    // transpose bit), moved by adding byte offsets / 16
    const uint64_t dq = wgmma_desc(qs, 16, 1024, 1);
    const uint64_t dk = wgmma_desc(base, 16, 1024, 1);
    const uint64_t dv = wgmma_desc(base + L::TILE, 1024, 1024, 1);
    auto issue_qk = [&](int t) {
      const uint32_t st = ((t % L::STAGES) * 2 * L::TILE) >> 4;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = 32 * (ks % 4);
        wgmma_n64_ss(s, dq + (((ks / 4) * 64 * 128 + off) >> 4),
                     dk + st + (((ks / 4) * PF_BK * 128 + off) >> 4),
                     ks > 0);
      }
    };
    // O += P V of tile t, the hi products then the lo ones
    auto issue_pv = [&](int t) {
      const uint32_t st = ((t % L::STAGES) * 2 * L::TILE) >> 4;
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk)
#pragma unroll
        for (int cc = 0; cc < L::BOXES; ++cc)
          wgmma_n64_rs(o[cc], p_hi[kk],
                       dv + st + ((cc * PF_BK * 128 + kk * 16 * 128) >> 4));
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk)
#pragma unroll
        for (int cc = 0; cc < L::BOXES; ++cc)
          wgmma_n64_rs(o[cc], p_lo[kk],
                       dv + st + ((cc * PF_BK * 128 + kk * 16 * 128) >> 4));
    };
    // after a wait: the accumulators hold the products' sums, and P's
    // registers, which P V reads as they run, stayed live until here
    auto landed = [&]() {
      fence_regs(s);
#pragma unroll
      for (int cc = 0; cc < L::BOXES; ++cc) fence_regs(o[cc]);
#pragma unroll
      for (int kk = 0; kk < PF_BK / 16; ++kk) {
        fence_regs(p_hi[kk]);
        fence_regs(p_lo[kk]);
      }
    };
    // the weights of tile t (its K scales landed with k_full); the mask
    // only on a tile that reaches this warp's first position
    auto weights = [&](int t) {
      const int key0 = (t0 + t) * PF_BK;
      const float* ks = scale_s + 2 * (t % L::STAGES) * PF_BK;
      if (key0 + PF_BK - 1 > w_pos_lo)
        pw_weights<KIND, true>(s, m_r, l_r, corr, ks, CL, key0, p_row, tq);
      else
        pw_weights<KIND, false>(s, m_r, l_r, corr, ks, CL, key0, p_row, tq);
    };
    auto pack = [&](int t) {
      pw_pack<D, KIND>(s, corr, o, p_hi, p_lo,
                       scale_s + (2 * (t % L::STAGES) + 1) * PF_BK, tq);
    };

    // Two consumer warpgroups take turns at the tensor cores (named
    // barriers 4 and 5): one issues P V of tile t and q K^T of tile t + 1
    // while the other runs its softmax.  Warpgroup 1 lets warpgroup 0 go
    // first; a warpgroup hands the turn on after each of its issues but
    // its last.  No wgmma sits in a branch (ptxas would serialize them
    // all): the first q K^T and the last P V have steps of their own.
    const bool pp = nc == 2;
    const int turn = 4 + wg, other = 5 - wg;
    if (pp && wg == 1) named_arrive(other, 256);
    mbar_wait(k_full, 0);
    if (pp) named_sync(turn, 256);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    if (pp) named_arrive(other, 256);
    wgmma_wait<0>();
    fence_regs(s);
    weights(0);
    for (int t = 0; t < n_tiles - 1; ++t) {
      const int st = t % L::STAGES;
      mbar_wait(v_full + 8 * st, (t / L::STAGES) & 1);
      pack(t);
      mbar_wait(k_full + 8 * ((t + 1) % L::STAGES),
                ((t + 1) / L::STAGES) & 1);
      if (pp) named_sync(turn, 256);
      wgmma_fence();
      issue_qk(t + 1);
      wgmma_commit();
      issue_pv(t);
      wgmma_commit();
      if (pp) named_arrive(other, 256);
      // tile t + 1's weights while its P V runs: they read S alone
      wgmma_wait<1>();
      fence_regs(s);
      weights(t + 1);
      wgmma_wait<0>();
      landed();
      mbar_arrive(empty + 8 * st);                   // stage st is read
    }
    const int last = n_tiles - 1;
    mbar_wait(v_full + 8 * (last % L::STAGES), (last / L::STAGES) & 1);
    pack(last);
    if (pp) named_sync(turn, 256);
    wgmma_fence();
    issue_pv(last);
    wgmma_commit();
    if (pp && wg == 0) named_arrive(other, 256);
    wgmma_wait<0>();
    landed();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 1);
      l_r[i] += __shfl_xor_sync(0xffffffffu, l_r[i], 2);
      const int row = r_lo + 8 * i;
      // a row writes only from the splits up to its own position's
      if (row >= n_rows || j > p_row[i] / PF_SPLIT_KEYS) continue;
      const size_t rid =
          ((static_cast<size_t>(g) * C + row0 + row / Gq) * Hkv + h) * Gq +
          row % Gq;
      if (p_row[i] < PF_SPLIT_KEYS) {                // one split: done
        const float lc = fmaxf(l_r[i], 1e-30f);
        __nv_bfloat16* op = out + rid * D + 2 * tq;
#pragma unroll
        for (int cc = 0; cc < L::BOXES; ++cc)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<__nv_bfloat162*>(op + 64 * cc + 8 * n) =
                __floats2bfloat162_rn(o[cc][4 * n + 2 * i] / lc,
                                      o[cc][4 * n + 2 * i + 1] / lc);
      } else {
        const size_t pr = rid * NS + j;
        float* ap = part + pr * D + 2 * tq;
#pragma unroll
        for (int cc = 0; cc < L::BOXES; ++cc)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<float2*>(ap + 64 * cc + 8 * n) =
                make_float2(o[cc][4 * n + 2 * i], o[cc][4 * n + 2 * i + 1]);
        if (tq == 0) {
          const size_t n_part =
              static_cast<size_t>(gridDim.x) * C * Gq * NS;   // rows x NS
          part[n_part * D + pr] = __fmul_rn(m_r[i], CL);      // base
          part[n_part * (D + 1) + pr] = l_r[i];
        }
      }
    }
  }
}

// The log-sum-exp merge of a prefill row's key splits, in split order;
// rows in split 0 are done.  One thread per (row, dim), rows in q's
// (G, C, Hkv, Gq) order.  A split's m is a logit (LOG2 false:
// paged_prefill_mma_kernel's) or its weights' base in log2 units (LOG2:
// paged_prefill_wgmma_kernel's).
template <int D, bool LOG2>
__global__ void __launch_bounds__(256) paged_prefill_combine_kernel(
    const float* __restrict__ part, __nv_bfloat16* __restrict__ out,
    int rows, int C, int HG, int start, int NS) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(rows) * D) return;
  const size_t rid = e / D;
  const int d = static_cast<int>(e % D);
  const int pos = start + static_cast<int>((rid / HG) % C);
  const int n_split = pos / PF_SPLIT_KEYS + 1;
  if (n_split == 1) return;
  const size_t n_part = static_cast<size_t>(rows) * NS;
  const size_t r0 = rid * NS;
  float ms = NEG_BIG;
  for (int j = 0; j < n_split; ++j) ms = fmaxf(ms, part[n_part * D + r0 + j]);
  float L = 0.f, A = 0.f;
  for (int j = 0; j < n_split; ++j) {
    const float x = part[n_part * D + r0 + j] - ms;
    const float a = LOG2 ? exp2f(x) : expf(x);
    L += part[n_part * (D + 1) + r0 + j] * a;
    A += part[(r0 + j) * D + d] * a;
  }
  out[e] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}


// ---------------------------------------------------------------------------
// geometry and launches
// ---------------------------------------------------------------------------

// Geometry::kernel of the paged launchers: the CUDA-core kernel
// (decode_kernel / prefill_kernel), the mma.sync one
// (paged_decode_split_kernel / paged_prefill_mma_kernel) or the wgmma
// prefill (paged_prefill_wgmma_kernel)
enum PagedKernel { PG_F32 = 0, PG_MMA = 1, PG_WGMMA = 2 };

template <int V>
using Int = std::integral_constant<int, V>;

// head dim, KV kind and row count as template arguments of f
template <typename F>
int with_d(int D, const char* name, F f) {
  switch (D) {
    case 16: return f(Int<16>{});
    case 32: return f(Int<32>{});
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    default:
      return refuse("%s: head dim %d is not one of 16, 32, 64, 128", name,
                    D);
  }
}
// the wgmma prefill's head dims
template <typename F>
int with_wgmma_d(int D, F f) {
  switch (D) {
    case 64: return f(Int<64>{});
    case 128: return f(Int<128>{});
    default:
      return refuse("paged_attn_prefill: the wgmma kernel takes head dim 64 "
                    "or 128, got %d", D);
  }
}
template <typename F>
int with_kind(int kind, F f) {
  switch (kind) {
    case KV_BF16: return f(Int<KV_BF16>{});
    case KV_INT8: return f(Int<KV_INT8>{});
    default: return f(Int<KV_SC>{});
  }
}

// log2(page), or -1 when page is not a power of two
int page_shift(int page) {
  int s = 0;
  while ((1 << s) < page) ++s;
  return (1 << s) == page ? s : -1;
}

bool misaligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

// The bf16 kernels take bf16 q and pools 16-byte aligned (their page size,
// a power of two, is checked with the geometry).
int bf16_route_check(const char* name, const void* q, const Pools& p,
                     int kv_kind) {
  if (misaligned16({q, p.arr[0], p.arr[1],
                    kv_kind == KV_SC ? p.arr[2] : nullptr,
                    kv_kind == KV_SC ? p.arr[3] : nullptr}))
    return refuse("%s: bf16 q and the pools must be 16-byte aligned", name);
  return 0;
}

// float32 q or float32 pools run the CUDA-core kernels
bool f32_route(int q_dtype, int kv_kind) {
  return q_dtype == Q_F32 || kv_kind == KV_F32;
}

// bf16 q over bf16 / int8 / sc pools at head dim 64 or 128 on the
// engine's 16-position pages runs the wgmma prefill; other head dims and
// page sizes the mma.sync one.  Never chosen by block_q, C or start.
bool wgmma_route(int D, int page) {
  return (D == 64 || D == 128) && page == PW_PAGE;
}

// The decode launch's geometry, after the checks of its sizes and codes.
int decode_geometry(int S, int Hkv, int G, int D, int page, int maxp,
                    int q_dtype, int kv_kind, Geometry& g) {
  if (S < 1 || Hkv < 1 || G < 1 || D < 1 || page < 1 || maxp < 1)
    return refuse("paged_attn_decode: S, Hkv, G, D, page and maxp must be "
                  "positive");
  if ((q_dtype != Q_F32 && q_dtype != Q_BF16) || kv_kind < KV_F32 ||
      kv_kind > KV_SC)
    return refuse("paged_attn_decode: unknown q dtype %d or KV kind %d",
                  q_dtype, kv_kind);
  g = Geometry{};
  if (f32_route(q_dtype, kv_kind)) {
    // grid (S, Hkv): block (s, h) walks the slot's pages in one pass
    g.kernel = PG_F32;
    g.grid[0] = S;
    g.grid[1] = Hkv;
    g.grid[2] = 1;
    g.threads = THREADS;
    g.smem = static_cast<long long>(smem_bytes(G, page, D));
    return 0;
  }
  const int pshift = page_shift(page);
  if (pshift < 0)
    return refuse("paged_attn_decode: bf16 q needs a power-of-two page "
                  "size, got %d", page);
  if (G > DEC_MAX_G)
    return refuse("paged_attn_decode: bf16 q takes at most %d query rows a "
                  "KV head, got %d", DEC_MAX_G, G);
  int rc = with_d(D, "paged_attn_decode", [&](auto d) {
    return with_kind(kv_kind, [&](auto k) {
      g.smem = static_cast<long long>(
          DecLayout<decltype(d)::value, decltype(k)::value>::bytes(G));
      return 0;
    });
  });
  if (rc) return rc;
  // grid (S Hkv, NS): block (lane, KV head, split); splits past a lane's
  // length return at once
  const int NS = ((maxp << pshift) + SPLIT_TOKENS - 1) / SPLIT_TOKENS;
  g.kernel = PG_MMA;
  g.grid[0] = S * Hkv;
  g.grid[1] = NS;
  g.grid[2] = 1;
  g.threads = DEC_THREADS;
  g.splits = NS;
  if (NS > 1) {
    g.combine_grid = S * Hkv;
    g.combine_threads = DEC_COMBINE_THREADS;
  }
  return 0;
}

// The prefill launch's geometry, after the checks of its sizes and codes.
int prefill_geometry(int G, int C, int Hkv, int Gq, int D, int page,
                     int width, int start, int block_q, int q_dtype,
                     int kv_kind, Geometry& g) {
  if (G < 1 || C < 1 || Hkv < 1 || Gq < 1 || D < 1 || page < 1 ||
      block_q < 1 || C % page || start % page ||
      (start + C) / page > width)
    return refuse("paged_attn_prefill: sizes must be positive, C and start "
                  "multiples of page, and width >= (start + C) / page");
  if ((q_dtype != Q_F32 && q_dtype != Q_BF16) || kv_kind < KV_F32 ||
      kv_kind > KV_SC)
    return refuse("paged_attn_prefill: unknown q dtype %d or KV kind %d",
                  q_dtype, kv_kind);
  g = Geometry{};
  if (f32_route(q_dtype, kv_kind)) {
    // grid (G Hq, ceil(C / bq)): block (request and q head, q-block)
    const int bq = block_q;
    g.kernel = PG_F32;
    g.grid[0] = G * Hkv * Gq;
    g.grid[1] = (C + bq - 1) / bq;
    g.grid[2] = 1;
    g.threads = THREADS;
    g.smem = static_cast<long long>(smem_bytes(bq, page, D));
    g.block = bq;
    return 0;
  }
  if (page_shift(page) < 0)
    return refuse("paged_attn_prefill: bf16 q needs a power-of-two page "
                  "size, got %d", page);
  if (Gq > PF_MAX_ROWS)
    return refuse("paged_attn_prefill: bf16 q takes at most %d query heads "
                  "a KV head, got %d", PF_MAX_ROWS, Gq);
  int bq = block_q;
  if (bq > C) bq = C;
  if (bq > PF_MAX_ROWS / Gq) bq = PF_MAX_ROWS / Gq;
  int rc;
  if (wgmma_route(D, page)) {
    // a producer warpgroup and a consumer warpgroup each 64 rows
    const int consumers = (bq * Gq + 63) / 64;
    rc = with_wgmma_d(D, [&](auto d) {
      return with_kind(kv_kind, [&](auto k) {
        g.smem = static_cast<long long>(
            PwLayout<decltype(d)::value, decltype(k)::value>::BYTES);
        return 0;
      });
    });
    g.kernel = PG_WGMMA;
    g.threads = 128 * (consumers + 1);
  } else {
    const int warps = (bq * Gq + 15) / 16;
    rc = with_d(D, "paged_attn_prefill", [&](auto d) {
      return with_kind(kv_kind, [&](auto k) {
        g.smem = static_cast<long long>(
            PfLayout<decltype(d)::value, decltype(k)::value>::bytes(16 *
                                                                     warps));
        return 0;
      });
    });
    g.kernel = PG_MMA;
    g.threads = 32 * warps;
  }
  if (rc) return rc;
  // grid (G Hkv, ceil(C / bq), NS): block (request and KV head, q-block,
  // key split)
  const int NS = (start + C + PF_SPLIT_KEYS - 1) / PF_SPLIT_KEYS;
  g.grid[0] = G * Hkv;
  g.grid[1] = (C + bq - 1) / bq;
  g.grid[2] = NS;
  g.splits = NS;
  g.block = bq;
  if (NS > 1) {
    const int rows = G * C * Hkv * Gq;
    g.combine_grid = (rows * D + 255) / 256;
    g.combine_threads = 256;
  }
  return 0;
}

template <typename QT, int KIND>
int decode_f32(const Geometry& g, const void* q, const void* kp,
               const void* vp, const void* ks, const void* vs,
               const void* kr, const void* vr, const void* tables,
               const void* lengths, void* out, int S, int Hkv, int G, int D,
               int page, int maxp, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(decode_kernel<QT, KIND>, smem,
                        "paged_attn_decode");
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]));
  decode_kernel<QT, KIND><<<grid, static_cast<int>(g.threads), smem,
                            stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int8_t*>(kr),
      static_cast<const int8_t*>(vr), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), Hkv, G, D,
      page, maxp, sqrtf(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int KIND>
int prefill_f32(const Geometry& g, const void* q, const void* kp,
                const void* vp, const void* ks, const void* vs,
                const void* kr, const void* vr, const void* tables,
                void* out, int G, int C, int Hkv, int Gq, int D, int page,
                int width, int start, int bq, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(prefill_kernel<QT, KIND>, smem,
                        "paged_attn_prefill");
  if (rc) return rc;
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]));
  prefill_kernel<QT, KIND><<<grid, static_cast<int>(g.threads), smem,
                             stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int8_t*>(kr),
      static_cast<const int8_t*>(vr), static_cast<const int*>(tables),
      static_cast<QT*>(out), C, Hkv, Gq, D, page, width, start, bq,
      sqrtf(D));
  return static_cast<int>(cudaGetLastError());
}

// float32 q (any pool), or bf16 q over float32 pools: the CUDA-core
// kernels, one instantiation per (q dtype, KV kind)
template <template <typename, int> class F, typename... Args>
int dispatch_f32(int q_dtype, int kv_kind, Args... args) {
  if (q_dtype == Q_BF16) return F<__nv_bfloat16, KV_F32>::run(args...);
  switch (kv_kind) {
    case KV_F32: return F<float, KV_F32>::run(args...);
    case KV_BF16: return F<float, KV_BF16>::run(args...);
    case KV_INT8: return F<float, KV_INT8>::run(args...);
    default: return F<float, KV_SC>::run(args...);
  }
}

template <typename QT, int KIND>
struct DecodeF32 {
  template <typename... A>
  static int run(A... a) { return decode_f32<QT, KIND>(a...); }
};

template <typename QT, int KIND>
struct PrefillF32 {
  template <typename... A>
  static int run(A... a) { return prefill_f32<QT, KIND>(a...); }
};

template <int D, int KIND>
int decode_split(const Geometry& g, const void* q, const Pools& pools,
                 const void* tables, const void* lengths, void* out,
                 void* scratch, int S, int Hkv, int G, int pshift, int maxp,
                 cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(paged_decode_split_kernel<D, KIND>, smem,
                        "paged_attn_decode");
  if (rc) return rc;
  const int NS = static_cast<int>(g.splits);
  auto* part = static_cast<float*>(scratch);
  auto* o = static_cast<__nv_bfloat16*>(out);
  const int* len = static_cast<const int*>(lengths);
  paged_decode_split_kernel<D, KIND>
      <<<dim3(static_cast<unsigned>(g.grid[0]),
              static_cast<unsigned>(g.grid[1])),
         static_cast<int>(g.threads), smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), pools,
          static_cast<const int*>(tables), len, o, part, S, Hkv, G, pshift,
          maxp);
  rc = static_cast<int>(cudaGetLastError());
  if (rc || g.combine_grid == 0) return rc;
  paged_decode_combine_kernel<<<static_cast<unsigned>(g.combine_grid),
                                static_cast<int>(g.combine_threads), 0,
                                stream>>>(part, len, o, S, Hkv, G, D, NS);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KIND>
int prefill_mma(const Geometry& g, const void* q, const Pools& pools,
                const void* tables, void* out, void* scratch, int G, int C,
                int Hkv, int Gq, int pshift, int width, int start,
                cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(paged_prefill_mma_kernel<D, KIND>, smem,
                        "paged_attn_prefill");
  if (rc) return rc;
  const int NS = static_cast<int>(g.splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  paged_prefill_mma_kernel<D, KIND>
      <<<dim3(static_cast<unsigned>(g.grid[0]),
              static_cast<unsigned>(g.grid[1]),
              static_cast<unsigned>(g.grid[2])),
         static_cast<int>(g.threads), smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), pools,
          static_cast<const int*>(tables), o, part, C, Hkv, Gq, pshift,
          width, start, static_cast<int>(g.block));
  rc = static_cast<int>(cudaGetLastError());
  if (rc || g.combine_grid == 0) return rc;
  const int rows = G * C * Hkv * Gq;
  paged_prefill_combine_kernel<D, false>
      <<<static_cast<unsigned>(g.combine_grid),
         static_cast<int>(g.combine_threads), 0, stream>>>(
          part, o, rows, C, Hkv * Gq, start, NS);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int KIND>
int prefill_wgmma(const Geometry& g, const void* q, const Pools& pools,
                  const void* tables, void* out, void* scratch, int G, int C,
                  int Hkv, int Gq, int width, int start, int n_pages,
                  cudaStream_t stream) {
  // the pools as (D, Hkv, page, N): bf16 values in 64-column boxes of a
  // page, 128B swizzle; int8 codes and residuals in D-byte rows of a page
  constexpr bool BF = KIND == KV_BF16;
  constexpr cuuint64_t ISZ = BF ? 2 : 1;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(Hkv), PW_PAGE,
                              static_cast<cuuint64_t>(n_pages)};
  const cuuint64_t strides[3] = {D * ISZ, Hkv * D * ISZ,
                                 PW_PAGE * Hkv * D * ISZ};
  const cuuint32_t box[4] = {BF ? 64u : static_cast<cuuint32_t>(D), 1,
                             PW_PAGE, 1};
  CUtensorMap maps[4];
  for (int a = 0; a < 4; ++a) {
    if (a >= Raw<D, KIND>::NARR) {                 // read by no one
      maps[a] = maps[a - 2];
      continue;
    }
    if (int rc = tensor_map_4d(
            &maps[a], "paged_attn_prefill",
            BF ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
               : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            pools.arr[a], dims, strides, box,
            BF ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE))
      return rc;
  }
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(paged_prefill_wgmma_kernel<D, KIND>, smem,
                        "paged_attn_prefill");
  if (rc) return rc;
  const int NS = static_cast<int>(g.splits);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(scratch);
  paged_prefill_wgmma_kernel<D, KIND>
      <<<dim3(static_cast<unsigned>(g.grid[0]),
              static_cast<unsigned>(g.grid[1]),
              static_cast<unsigned>(g.grid[2])),
         static_cast<int>(g.threads), smem, stream>>>(
          maps[0], maps[1], maps[2], maps[3],
          static_cast<const __nv_bfloat16*>(q), pools.scale[0],
          pools.scale[1], static_cast<const int*>(tables), o, part, C, Hkv,
          Gq, width, start, static_cast<int>(g.block), n_pages);
  rc = static_cast<int>(cudaGetLastError());
  if (rc || g.combine_grid == 0) return rc;
  const int rows = G * C * Hkv * Gq;
  paged_prefill_combine_kernel<D, true>
      <<<static_cast<unsigned>(g.combine_grid),
         static_cast<int>(g.combine_threads), 0, stream>>>(
          part, o, rows, C, Hkv * Gq, start, NS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Positions one decode split and keys one prefill split cover (the
// wrappers size the scratch of the split partials with them).
extern "C" int paged_attn_decode_split_tokens() { return SPLIT_TOKENS; }
extern "C" int paged_attn_prefill_split_tokens() { return PF_SPLIT_KEYS; }

// The geometry paged_attn_decode_launch would launch with for these sizes
// (GEOMETRY_FIELDS values into out; Geometry::kernel is a PagedKernel),
// or the refusal the launch would make of them.
extern "C" int paged_attn_decode_geometry(int S, int Hkv, int G, int D,
                                          int page, int maxp, int q_dtype,
                                          int kv_kind, long long* out) {
  Geometry g;
  if (int rc = decode_geometry(S, Hkv, G, D, page, maxp, q_dtype, kv_kind,
                               g))
    return rc;
  write_geometry(g, out);
  return 0;
}

// The same for paged_attn_prefill_launch.
extern "C" int paged_attn_prefill_geometry(int G, int C, int Hkv, int Gq,
                                           int D, int page, int width,
                                           int start, int block_q,
                                           int q_dtype, int kv_kind,
                                           long long* out) {
  Geometry g;
  if (int rc = prefill_geometry(G, C, Hkv, Gq, D, page, width, start,
                                block_q, q_dtype, kv_kind, g))
    return rc;
  write_geometry(g, out);
  return 0;
}

// Pointers the format does not use are null.  scratch: float32, at
// least S Hkv NS G (D + 2) floats when a lane's positions span NS > 1
// decode splits (NS = ceil(maxp page / SPLIT_TOKENS); used by bf16 q over
// bf16 / int8 / sc pools), else may be null.  Returns a CUDA error code.
extern "C" int paged_attn_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_resid,
    const void* v_resid, const void* tables, const void* lengths, void* out,
    void* scratch, int S, int Hkv, int G, int D, int page, int maxp,
    int q_dtype, int kv_kind, void* stream) {
  Geometry g;
  if (int rc = decode_geometry(S, Hkv, G, D, page, maxp, q_dtype, kv_kind,
                               g))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  if (g.kernel == PG_F32)
    return dispatch_f32<DecodeF32>(q_dtype, kv_kind, g, q, k_pages, v_pages,
                                   k_scale, v_scale, k_resid, v_resid,
                                   tables, lengths, out, S, Hkv, G, D, page,
                                   maxp, st);
  const Pools pools{{k_pages, v_pages, k_resid, v_resid},
                    {static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale)}};
  if (int rc = bf16_route_check("paged_attn_decode", q, pools, kv_kind))
    return rc;
  const int ps = page_shift(page);
  return with_d(D, "paged_attn_decode", [&](auto d) {
    return with_kind(kv_kind, [&](auto k) {
      return decode_split<decltype(d)::value, decltype(k)::value>(
          g, q, pools, tables, lengths, out, scratch, S, Hkv, G, ps, maxp,
          st);
    });
  });
}

// scratch: float32, G C Hkv Gq NS (D + 2) floats when the chunk's keys
// span NS > 1 prefill splits (NS = ceil((start + C) / PF_SPLIT_KEYS);
// used by bf16 q over bf16 / int8 / sc pools), else may be null.
// n_pages: the pools' N (the wgmma kernel's tensor maps span them).
extern "C" int paged_attn_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_resid,
    const void* v_resid, const void* tables, void* out, void* scratch,
    int G, int C, int Hkv, int Gq, int D, int page, int width, int start,
    int block_q, int n_pages, int q_dtype, int kv_kind, void* stream) {
  Geometry g;
  if (int rc = prefill_geometry(G, C, Hkv, Gq, D, page, width, start,
                                block_q, q_dtype, kv_kind, g))
    return rc;
  auto st = static_cast<cudaStream_t>(stream);
  if (g.kernel == PG_F32)
    return dispatch_f32<PrefillF32>(q_dtype, kv_kind, g, q, k_pages, v_pages,
                                    k_scale, v_scale, k_resid, v_resid,
                                    tables, out, G, C, Hkv, Gq, D, page,
                                    width, start, block_q, st);
  const Pools pools{{k_pages, v_pages, k_resid, v_resid},
                    {static_cast<const float*>(k_scale),
                     static_cast<const float*>(v_scale)}};
  if (int rc = bf16_route_check("paged_attn_prefill", q, pools, kv_kind))
    return rc;
  if (g.kernel == PG_WGMMA) {
    if (n_pages < 1)
      return refuse("paged_attn_prefill: the pools hold %d pages", n_pages);
    return with_wgmma_d(D, [&](auto d) {
      return with_kind(kv_kind, [&](auto k) {
        return prefill_wgmma<decltype(d)::value, decltype(k)::value>(
            g, q, pools, tables, out, scratch, G, C, Hkv, Gq, width, start,
            n_pages, st);
      });
    });
  }
  const int ps = page_shift(page);
  return with_d(D, "paged_attn_prefill", [&](auto d) {
    return with_kind(kv_kind, [&](auto k) {
      return prefill_mma<decltype(d)::value, decltype(k)::value>(
          g, q, pools, tables, out, scratch, G, C, Hkv, Gq, ps, width, start,
          st);
    });
  });
}
