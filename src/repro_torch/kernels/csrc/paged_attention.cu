// Paged GQA attention over the serving engine's page pools, for Hopper
// (sm_90a): one-token decode and chunked causal prefill.
//
// Replaces the TPU kernels in src/repro/kernels/paged_attention.py:
//   paged_attn_decode_pallas  (_decode_kernel, _load_kv_block)
//   paged_attn_prefill_pallas (_prefill_kernel, _load_kv_block)
// Both read K/V pages straight through the page tables, dequantize
// compressed pools (kv_format int8 / sc) on load, and run an fp32 online
// softmax (m, l, acc) over the pages, with the reference's numerics:
// logits = (q . k) / sqrt(D) (divide after the dot), positions past the
// live length / causal horizon masked to -1e30 before the exp and their
// weight zeroed after it, output acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds them: at serving shapes, memory and latency.  A decode step
// reads every live page of K and V once per KV head (GQA: the G query
// heads that share a KV head ride in one block, so each page is read
// once, not G times) and does 4*G*D flops per cached position, far below
// the H100's 295 flop/byte balance point; prefill does C times more
// flops per page byte but at C = 64 still sits below it.  Design: a
// block owns one (slot, KV head) for decode or one (request, q
// head, q-block) for prefill, loops over its live pages in order,
// stages each page of K and V in shared memory as float (K rows padded
// to D+1 words so the per-key dot products do not collide on one bank),
// and keeps q, the logits tile and (m, l, acc) in shared memory too, so
// any G, D, page and block_q fit one code path.  Pages wholly past the
// length (decode) or the block's causal horizon (prefill) are never
// loaded.  Each block's loop order is fixed, so a row's result does not
// depend on which other rows share the launch.  No tensor cores, TMA or
// cp.async yet: that is later work.

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
// decode: grid (S, Hkv); block (s, h) walks the slot's table lanes in
// order (no split-K: one block per slot and KV head).
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

template <typename QT, int KIND>
int decode_typed(const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* kr,
                 const void* vr, const void* tables, const void* lengths,
                 void* out, int S, int Hkv, int G, int D, int page, int maxp,
                 cudaStream_t stream) {
  const size_t smem = smem_bytes(G, page, D);
  int rc = prepare_smem(decode_kernel<QT, KIND>, smem,
                        "paged_attn_decode");
  if (rc) return rc;
  const dim3 grid(S, Hkv);
  decode_kernel<QT, KIND><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int8_t*>(kr),
      static_cast<const int8_t*>(vr), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), Hkv, G, D,
      page, maxp, sqrtf(D));
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int KIND>
int prefill_typed(const void* q, const void* kp, const void* vp,
                  const void* ks, const void* vs, const void* kr,
                  const void* vr, const void* tables, void* out, int G,
                  int C, int Hkv, int Gq, int D, int page, int width,
                  int start, int bq, cudaStream_t stream) {
  const size_t smem = smem_bytes(bq, page, D);
  int rc = prepare_smem(prefill_kernel<QT, KIND>, smem,
                        "paged_attn_prefill");
  if (rc) return rc;
  const dim3 grid(G * Hkv * Gq, (C + bq - 1) / bq);
  prefill_kernel<QT, KIND><<<grid, THREADS, smem, stream>>>(
      static_cast<const QT*>(q), kp, vp, static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int8_t*>(kr),
      static_cast<const int8_t*>(vr), static_cast<const int*>(tables),
      static_cast<QT*>(out), C, Hkv, Gq, D, page, width, start, bq,
      sqrtf(D));
  return static_cast<int>(cudaGetLastError());
}

// q dtype x KV kind -> one template instantiation
template <template <typename, int> class F, typename... Args>
int dispatch(int q_dtype, int kv_kind, Args... args) {
#define REPRO_KV_CASES(QT)                                      \
  switch (kv_kind) {                                            \
    case KV_F32: return F<QT, KV_F32>::run(args...);            \
    case KV_BF16: return F<QT, KV_BF16>::run(args...);          \
    case KV_INT8: return F<QT, KV_INT8>::run(args...);          \
    case KV_SC: return F<QT, KV_SC>::run(args...);              \
    default: return refuse("unknown KV kind %d", kv_kind);      \
  }
  if (q_dtype == Q_F32) { REPRO_KV_CASES(float) }
  if (q_dtype == Q_BF16) { REPRO_KV_CASES(__nv_bfloat16) }
#undef REPRO_KV_CASES
  return refuse("unknown q dtype %d", q_dtype);
}

template <typename QT, int KIND>
struct Decode {
  template <typename... A>
  static int run(A... a) { return decode_typed<QT, KIND>(a...); }
};

template <typename QT, int KIND>
struct Prefill {
  template <typename... A>
  static int run(A... a) { return prefill_typed<QT, KIND>(a...); }
};

}  // namespace

// Pointers the format does not use are null.  Returns a CUDA error code.
extern "C" int paged_attn_decode_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_resid,
    const void* v_resid, const void* tables, const void* lengths, void* out,
    int S, int Hkv, int G, int D, int page, int maxp, int q_dtype,
    int kv_kind, void* stream) {
  if (S < 1 || Hkv < 1 || G < 1 || D < 1 || page < 1 || maxp < 1)
    return refuse("paged_attn_decode: S, Hkv, G, D, page and maxp must be "
                  "positive");
  return dispatch<Decode>(q_dtype, kv_kind, q, k_pages, v_pages, k_scale,
                          v_scale, k_resid, v_resid, tables, lengths, out, S,
                          Hkv, G, D, page, maxp,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int paged_attn_prefill_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_resid,
    const void* v_resid, const void* tables, void* out, int G, int C,
    int Hkv, int Gq, int D, int page, int width, int start, int block_q,
    int q_dtype, int kv_kind, void* stream) {
  if (G < 1 || C < 1 || Hkv < 1 || Gq < 1 || D < 1 || page < 1 ||
      block_q < 1 || C % page || start % page ||
      (start + C) / page > width)
    return refuse("paged_attn_prefill: sizes must be positive, C and start "
                  "multiples of page, and width >= (start + C) / page");
  return dispatch<Prefill>(q_dtype, kv_kind, q, k_pages, v_pages, k_scale,
                           v_scale, k_resid, v_resid, tables, out, G, C, Hkv,
                           Gq, D, page, width, start, block_q,
                           static_cast<cudaStream_t>(stream));
}
