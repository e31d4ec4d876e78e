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
// (q . k) / sqrt(D) (a divide after the dot), positions past the live
// length / causal horizon masked to -1e30 before the exp and their weight
// zeroed after it, output acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds them.  Decode reads every live position of K and V once
// per KV head and does 4 G D flops per position (G = 4 query rows a KV
// head), far below the H100's 295 flop/byte balance point: bytes.
// Prefill does C times more flops per byte; at C = 64 and Gq = 4 its
// bytes and its bf16 products take about the same time at the H100's
// peaks (fp: bytes; int8: operations).
//
// bfloat16 q with bf16 / int8 / sc pools (the serving path) runs two
// designs on one tensor-core tile routine (attn_tile): S = q k^T and
// O += P V as mma.sync m16n8k16 (bf16 in, float32 sums), the online
// softmax on the accumulator fragments, P entering P V as two bf16 terms
// hi + lo (one term moves O past its 1e-2 tolerance, see
// flash_attention.cu).  int8 pools: the codes are exact in bf16, the
// per-key scale multiplies the float32 logit (K) and folds into P (V).
// sc pools: 16 code and resid are both exact in bf16, so K and V each
// take two products summed in one float32 accumulator, q . (resid +
// 16 code), then scaled by scale / 16.  Codes are widened to bf16 in
// shared memory without I2F (widen16).
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
// mma tile, held as A fragments in registers.  The warps' partials merge
// in warp order through shared memory; a lane with one split writes its
// output, otherwise each split writes (acc, m, l) to scratch and
// paged_decode_combine_kernel merges the splits in split order with the
// reference's exact log-sum-exp combine (launched only when maxp pages
// hold more than one split).
//
// paged_prefill_mma_kernel: a block owns one (request, KV head, q-block)
// and all Gq query heads of that KV head, rows ordered position-major
// (row i = position i / Gq, head i % Gq), 16 rows a warp, at most 128
// rows, so each K/V tile is read once for the whole GQA group.  Key
// tiles of 64 absolute positions are gathered through the page table by
// cp.async into a ring of three; tiles past the block's causal horizon
// are never loaded and keys past the chunk's end are zero-filled; the
// causal mask is applied only on tiles that reach a warp's diagonal.
// The keys are split by absolute position too (PF_SPLIT_KEYS a split, a
// block each), so that a long cache fills the card; a block writes only
// the rows whose position reaches its split: rows whose position lies in
// split 0 write their output, the others' splits are merged by
// paged_prefill_combine_kernel in split order.  A row's result depends on
// its own position and the tiles before it only, not on block_q or the
// chunk around it.
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

// The log-sum-exp merge of a prefill row's key splits, in split order;
// rows in split 0 are done.  One thread per (row, dim), rows in q's
// (G, C, Hkv, Gq) order.
template <int D>
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
    const float a = expf(part[n_part * D + r0 + j] - ms);
    L += part[n_part * (D + 1) + r0 + j] * a;
    A += part[(r0 + j) * D + d] * a;
  }
  out[e] = __float2bfloat16(A / fmaxf(L, 1e-30f));
}


// ---------------------------------------------------------------------------
// geometry and launches
// ---------------------------------------------------------------------------

// Geometry::kernel of the paged launchers: the CUDA-core kernel
// (decode_kernel / prefill_kernel) or the tensor-core one
// (paged_decode_split_kernel / paged_prefill_mma_kernel)
enum PagedKernel { PG_F32 = 0, PG_MMA = 1 };

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
  const int warps = (bq * Gq + 15) / 16;
  int rc = with_d(D, "paged_attn_prefill", [&](auto d) {
    return with_kind(kv_kind, [&](auto k) {
      g.smem = static_cast<long long>(
          PfLayout<decltype(d)::value, decltype(k)::value>::bytes(16 *
                                                                   warps));
      return 0;
    });
  });
  if (rc) return rc;
  // grid (G Hkv, ceil(C / bq), NS): block (request and KV head, q-block,
  // key split)
  const int NS = (start + C + PF_SPLIT_KEYS - 1) / PF_SPLIT_KEYS;
  g.kernel = PG_MMA;
  g.grid[0] = G * Hkv;
  g.grid[1] = (C + bq - 1) / bq;
  g.grid[2] = NS;
  g.threads = 32 * warps;
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
  paged_prefill_combine_kernel<D>
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
extern "C" int paged_attn_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_resid,
    const void* v_resid, const void* tables, void* out, void* scratch,
    int G, int C, int Hkv, int Gq, int D, int page, int width, int start,
    int block_q, int q_dtype, int kv_kind, void* stream) {
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
  const int ps = page_shift(page);
  return with_d(D, "paged_attn_prefill", [&](auto d) {
    return with_kind(kv_kind, [&](auto k) {
      return prefill_mma<decltype(d)::value, decltype(k)::value>(
          g, q, pools, tables, out, scratch, G, C, Hkv, Gq, ps, width, start,
          st);
    });
  });
}
