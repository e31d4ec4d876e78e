// The SC integer datapath for Hopper (sm_90a): int8 activation levels x
// int8 ternary weights -> exact int32 sums (== the exact BSN's popcount),
// with an optional fused SI epilogue.
//
// Replaces the TPU kernel src/repro/kernels/ternary_matmul.py:
// ternary_matmul_pallas (_matmul_kernel, _matmul_si_kernel).  Computes
//     out[m, n] = sum_k x[m, k] * w[k, n]                      (int32)
// or, with thresholds t (N, out_bsl) in the q domain,
//     out[m, n] = #{j : sum >= t[n, j]} - out_bsl / 2.
// x is (M, K) int8, w keeps the reference's (K, N) int8 layout.
//
// What bounds it: reading the weights.  At decode M is 4 lanes, so each
// weight byte feeds 4 multiply-adds: the (K, N) int8 read at 3.35 TB/s is
// the limit (granite-3-2b: 0.755 ms for one 4-lane step's 2.53e9 bytes).
// Design:
// - A block owns 128 output columns and MT (4 or 16) rows of x.  Lane l
//   of every warp owns columns 4l..4l+3 and reads one 32-bit word of a
//   weight row, so a warp reads 128 consecutive bytes (coalesced) and
//   each weight byte is read once per row tile of x.
// - The 8 warps take interleaved groups of 4 weight rows; a 4x4 byte
//   transpose (__byte_perm) turns the 4 words into 4 per-column words of
//   4 k-values, which feed __dp4a against x's packed words.
// - x's rows for the block's K range sit in shared memory, read as
//   broadcasts.  The warps' partial tiles are summed with shared-memory
//   atomics.
// - When the (column, row) tiles alone cannot fill the card (decode), the
//   K range is split over blocks (grid z) and the partial sums are added
//   into the zeroed output with global atomics.  The sums are integers,
//   so neither split nor order changes a bit.  The SI variant needs the
//   whole sum in one block, so it never splits K; its thresholds for the
//   block's columns are loaded once into shared memory.

#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = 128;        // 32 lanes x 4 columns
constexpr int UNROLL = 4;          // row groups a warp has in flight
constexpr int MAX_OUT_BSL = 32;

// 4 rows' words (w0..w3 hold columns c..c+3 of rows k..k+3) -> 4 column
// words, col[c] = (w0.c, w1.c, w2.c, w3.c), lowest byte first.
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           int col[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);
  const uint32_t t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140);
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);
  col[0] = static_cast<int>(__byte_perm(t0, t2, 0x5410));
  col[1] = static_cast<int>(__byte_perm(t0, t2, 0x7632));
  col[2] = static_cast<int>(__byte_perm(t1, t3, 0x5410));
  col[3] = static_cast<int>(__byte_perm(t1, t3, 0x7632));
}

// Shared memory: red[MT][TILE_N] int, then (SI) thr[TILE_N][out_bsl] int,
// then xs[MT][groups] packed x words.
template <int MT, bool SI>
__global__ void __launch_bounds__(THREADS)
ternary_matmul_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ w,
                      const int* __restrict__ thr, int* __restrict__ out,
                      int M, int N, int K, int groups_per_split,
                      int out_bsl) {
  extern __shared__ __align__(16) int smem[];
  int* red = smem;
  int* thr_s = red + MT * TILE_N;
  int* xs = thr_s + (SI ? TILE_N * out_bsl : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TILE_N;
  const int m0 = blockIdx.y * MT;
  const int G = K / 4;                              // row groups of 4
  const int g0 = blockIdx.z * groups_per_split;
  const int g1 = min(G, g0 + groups_per_split);
  const int ng = g1 - g0;

  const int* xw = reinterpret_cast<const int*>(x);  // K % 4 == 0
  for (int i = tid; i < MT * ng; i += THREADS) {
    const int m = i / ng, g = i - m * ng;
    xs[i] = m0 + m < M ? xw[static_cast<size_t>(m0 + m) * G + g0 + g] : 0;
  }
  for (int i = tid; i < MT * TILE_N; i += THREADS) red[i] = 0;
  if constexpr (SI) {
    for (int i = tid; i < TILE_N * out_bsl; i += THREADS) {
      thr_s[i] = n0 + i / out_bsl < N
                     ? thr[static_cast<size_t>(n0) * out_bsl + i]
                     : INT_MAX;
    }
  }
  __syncthreads();

  int acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0;

  const int n = n0 + 4 * lane;
  if (n < N) {          // N % 4 == 0: all 4 of the lane's columns, or none
    const uint32_t* wcol = reinterpret_cast<const uint32_t*>(w + n);
    const size_t row_words = static_cast<size_t>(N) / 4;
    for (int g = g0 + warp; g < g1; g += WARPS * UNROLL) {
      uint32_t wv[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int gg = g + u * WARPS;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wv[u][r] = gg < g1
              ? __ldg(wcol + static_cast<size_t>(4 * gg + r) * row_words)
              : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int gg = g + u * WARPS;
        if (gg < g1) {
          int col[4];
          transpose4(wv[u][0], wv[u][1], wv[u][2], wv[u][3], col);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const int xv = xs[m * ng + gg - g0];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[m][c] = __dp4a(col[c], xv, acc[m][c]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        atomicAdd(&red[m * TILE_N + 4 * lane + c], acc[m][c]);
  }
  __syncthreads();

  for (int i = tid; i < MT * TILE_N; i += THREADS) {
    const int m = i / TILE_N, j = i - m * TILE_N;
    if (m0 + m >= M || n0 + j >= N) continue;
    const int v = red[i];
    int* dst = out + static_cast<size_t>(m0 + m) * N + n0 + j;
    if constexpr (SI) {
      const int* t = thr_s + j * out_bsl;
      int cnt = 0;
      for (int b = 0; b < out_bsl; ++b) cnt += v >= t[b];
      *dst = cnt - out_bsl / 2;
    } else if (gridDim.z > 1) {
      atomicAdd(dst, v);
    } else {
      *dst = v;
    }
  }
}

int sm_count() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
    cached[dev] = n;
  }
  return cached[dev];
}

template <int MT, bool SI>
int run(const int8_t* x, const int8_t* w, const int* thr, int* out, int M,
        int N, int K, int out_bsl, cudaStream_t stream) {
  const int G = K / 4;
  const int col_tiles = (N + TILE_N - 1) / TILE_N;
  const int row_tiles = (M + MT - 1) / MT;
  const size_t fixed = (static_cast<size_t>(MT) * TILE_N +
                        (SI ? static_cast<size_t>(TILE_N) * out_bsl : 0)) *
                       sizeof(int);
  int gps = G;                          // row groups per K split
  if (!SI && G > 0) {
    // split K until about two blocks per SM are in flight, and so that
    // the block's x rows fit in shared memory
    const long tiles = static_cast<long>(col_tiles) * row_tiles;
    const long want = (2L * sm_count() + tiles - 1) / tiles;
    int splits = static_cast<int>(want < G ? want : G);
    gps = (G + splits - 1) / splits;
    const long fit = static_cast<long>((SMEM_CAP - fixed) /
                                       (static_cast<size_t>(MT) * 4));
    if (gps > fit) gps = static_cast<int>(fit);
  }
  const int splits = G > 0 ? (G + gps - 1) / gps : 1;
  if (splits > 65535)
    return refuse("ternary_matmul: K=%d needs %d splits, above a grid's "
                  "65535", K, splits);
  const size_t smem = fixed + static_cast<size_t>(MT) * gps * sizeof(int);
  int rc = prepare_smem(ternary_matmul_kernel<MT, SI>, smem,
                        "ternary_matmul");
  if (rc) return rc;
  if (splits > 1) {
    rc = static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(M) * N * sizeof(int), stream));
    if (rc) return rc;
  }
  const dim3 grid(col_tiles, row_tiles, splits);
  ternary_matmul_kernel<MT, SI><<<grid, THREADS, smem, stream>>>(
      x, w, thr, out, M, N, K, gps, out_bsl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8, w (K, N) int8, thr (N, out_bsl) int32 or null, out
// (M, N) int32, all contiguous on the card (checked by the Python
// wrapper, kernels/ternary_matmul.py).  Returns a CUDA error code.
extern "C" int ternary_matmul_launch(const void* x, const void* w,
                                     const void* thr, void* out, int M,
                                     int N, int K, int out_bsl,
                                     void* stream) {
  if (M < 0 || N < 0 || K < 0)
    return refuse("ternary_matmul: negative shape M=%d N=%d K=%d", M, N, K);
  if (K % 4 || N % 4)
    return refuse("ternary_matmul: K and N must be multiples of 4 (the "
                  "kernel reads 4-byte words), got K=%d N=%d", K, N);
  if (reinterpret_cast<uintptr_t>(x) % 4 ||
      reinterpret_cast<uintptr_t>(w) % 4)
    return refuse("ternary_matmul: x and w must start on a 4-byte "
                  "boundary");
  if (thr && (out_bsl < 1 || out_bsl > MAX_OUT_BSL))
    return refuse("ternary_matmul: the SI epilogue takes 1..%d threshold "
                  "columns, got out_bsl=%d", MAX_OUT_BSL, out_bsl);
  if ((M + 15) / 16 > 65535)
    return refuse("ternary_matmul: M=%d has too many rows for one launch",
                  M);
  if (M == 0 || N == 0) return 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* tp = static_cast<const int*>(thr);
  auto* op = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (M <= 4) {
    return thr ? run<4, true>(xp, wp, tp, op, M, N, K, out_bsl, s)
               : run<4, false>(xp, wp, tp, op, M, N, K, out_bsl, s);
  }
  return thr ? run<16, true>(xp, wp, tp, op, M, N, K, out_bsl, s)
             : run<16, false>(xp, wp, tp, op, M, N, K, out_bsl, s);
}
