// Flash attention forward (causal or bidirectional GQA) for Hopper
// (sm_90a), with the per-row log-sum-exp the backward reads.
//
// Replaces the TPU kernel in src/repro/kernels/flash_attention.py:
//   flash_attention_pallas (_kernel)
// with its numerics: q is cast to float32 and multiplied by `scale`
// (1/sqrt(D) unless the caller pre-scaled q), logits = q . k in float32,
// causal positions k_col > q_row masked to -1e30 and their weight zeroed
// after the exp, an online softmax (m, l, acc) in float32 over key tiles,
// output acc / max(l, 1e-30) cast to q's dtype; lse = m + log(l) per row.
//
// What bounds it: operations.  At the training shape (B 2, S 4096, 32 q
// heads, D 64) a call does 2 * 2 * B*Hq * S^2/2 * D = 137 GFLOP against
// 0.17 GB of q, k, v, o and lse, far above the H100's 295 flop/byte
// balance point, so the kernel is as fast as its inner products.  This
// first version runs them on the CUDA cores in float32, not on the tensor
// cores: one block owns BQ = 64 query rows of one (batch, q head); two
// threads share a row.  Per key tile of BK = 64 rows, K and V are staged
// in shared memory as float32; each thread holds its q row in registers,
// forms 32 logits (keys 2j + half), the pair reduces the row max and sum
// with one shuffle, the tile's weights go through shared memory, and each
// thread updates its half of the row's output (columns in groups of four,
// interleaved between the pair, so the pair's float4 reads of a V row hit
// neighbouring banks).  The key loop stops at the block's causal diagonal,
// and q tiles are scheduled longest first.  A ragged S is masked: rows
// past S are neither read nor written and keys past S get no weight.
// mma.sync / wgmma tiles, TMA and a backward kernel are later work.

#include "common.cuh"

namespace {

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

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int S, int Hq, int Hkv, float scale, int causal) {
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
    const T* qp = q + ((static_cast<size_t>(b) * S + (live ? row : 0)) * Hq +
                       hq) * D;
#pragma unroll
    for (int i = 0; i < D / 4; ++i) {
      qv[i] = make_float4(to_float(qp[4 * i]) * scale,
                          to_float(qp[4 * i + 1]) * scale,
                          to_float(qp[4 * i + 2]) * scale,
                          to_float(qp[4 * i + 3]) * scale);
    }
  }
  float4 acc[D / 8];                                // columns 8i + 4half..
#pragma unroll
  for (int i = 0; i < D / 8; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = NEG_BIG, l = 0.f;

  const int k_end = causal ? min(S, row0 + BQ) : S;
  const int n_tiles = (k_end + BK - 1) / BK;
  const size_t kv_row = static_cast<size_t>(Hkv) * D;   // stride of a key
  const T* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * D;

  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BK;
    __syncthreads();                 // the previous tile is consumed
    for (int i = threadIdx.x; i < BK * D; i += THREADS) {
      const int j = i / D, d = i - j * D;
      const bool in = key0 + j < S;
      const size_t e = static_cast<size_t>(key0 + j) * kv_row + d;
      k_s[j * (D + 4) + d] = in ? to_float(kb[e]) : 0.f;
      v_s[j * D + d] = in ? to_float(vb[e]) : 0.f;
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
  T* op = out + ((static_cast<size_t>(b) * S + row) * Hq + hq) * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int c = 8 * i + 4 * half;
    op[c] = from_float<T>(acc[i].x / lc);
    op[c + 1] = from_float<T>(acc[i].y / lc);
    op[c + 2] = from_float<T>(acc[i].z / lc);
    op[c + 3] = from_float<T>(acc[i].w / lc);
  }
  if (half == 0) {
    lse[static_cast<size_t>(bh) * S + row] = m + logf(l);
  }
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 float* lse, int B, int S, int Hq, int Hkv, float scale,
                 int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  int rc = prepare_smem(flash_fwd_kernel<T, D>, smem, "flash_attention");
  if (rc) return rc;
  const dim3 grid(B * Hq, (S + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, S, Hq, Hkv,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             float* lse, int B, int S, int Hq, int Hkv, float scale,
             int causal, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_typed<T, 16>(q, k, v, out, lse, B, S, Hq, Hkv,
                                        scale, causal, stream);
    case 32: return launch_typed<T, 32>(q, k, v, out, lse, B, S, Hq, Hkv,
                                        scale, causal, stream);
    case 64: return launch_typed<T, 64>(q, k, v, out, lse, B, S, Hq, Hkv,
                                        scale, causal, stream);
    case 128: return launch_typed<T, 128>(q, k, v, out, lse, B, S, Hq, Hkv,
                                          scale, causal, stream);
    default:
      return refuse("flash_attention: head dim %d is not one of 16, 32, "
                    "64, 128", D);
  }
}

}  // namespace

// q (B, S, Hq, D), k / v (B, S, Hkv, D), out like q, lse (B, Hq, S)
// float32; all contiguous.  dtype 0 = float32, 1 = bfloat16 (q, k, v and
// out alike).  Returns a CUDA error code.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int S, int Hq, int Hkv, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  if (B < 1 || S < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv)
    return refuse("flash_attention: B, S, Hq and Hkv must be positive and "
                  "Hq a multiple of Hkv (got Hq %d, Hkv %d)", Hq, Hkv);
  if ((static_cast<long long>(S) + BQ - 1) / BQ > 65535)
    return refuse("flash_attention: S = %d needs more than 65535 q tiles",
                  S);
  auto st = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<float*>(lse);
  if (dtype == Q_F32)
    return launch_d<float>(D, q, k, v, out, l, B, S, Hq, Hkv, scale, causal,
                           st);
  if (dtype == Q_BF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, l, B, S, Hq, Hkv, scale,
                                   causal, st);
  return refuse("flash_attention: unknown dtype %d", dtype);
}
