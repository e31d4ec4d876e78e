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
// Batched: a launch may hold E independent products (E, M, K) x (E, K, N)
// -> (E, M, N), one per MoE expert (src/repro/models/moe.py's
// _expert_matmul einsums under sc_int).  Grid z enumerates (product, K
// split) pairs, each block offsets x, w and out by its product's batch
// stride, and both kernels count the E x tiles when they decide whether
// K must split to fill the card.  The SI epilogue takes one product.
//
// What bounds it.  At decode (M <= 16 rows) reading the weights: each
// weight byte feeds at most 16 multiply-adds, so the (K, N) int8 read at
// 3.35 TB/s is the limit (granite-3-2b: 0.755 ms for one 4-lane step's
// 2.53e9 bytes).  At prefill (the engine's chunks of up to 256 rows) the
// products: 256 x 2048 x 8192 is 8.6e9 operations against 2.2e7 bytes,
// so only the int8 tensor cores keep it near its byte bound.
//
// Decode, M <= 16: ternary_matmul_kernel (dp4a on the CUDA cores).
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
// - When the (column, row) tiles alone cannot fill the card, the K range
//   is split over blocks (grid z) and the partial sums are added into the
//   zeroed output with global atomics.
//
// Prefill, M > 16: ternary_matmul_mma_kernel (wgmma m64n128k32 s8).
// - A block owns 128 x 128 outputs: two warpgroups of 64 rows, each one
//   wgmma chain with 64 int32 accumulators a thread.  Row tiles of one
//   column tile are neighbours in the grid (blockIdx.x), so they run
//   together and the weights come from device memory about once.
// - x (M, K) row-major is already the K-major A operand; cp.async (16
//   bytes a thread, rows and K past the end zero-filled) writes its
//   128-byte K slices straight into wgmma's 128B-swizzle layout.
// - int8 operands of wgmma must be K-major and nothing on sm_90 transposes
//   bytes on the way in, while w keeps the reference's (K, N) row-major
//   layout.  So each 128 x 128 w slice lands as it is (chunks swizzled
//   so the transpose reads hit 32 banks) and the block transposes it
//   once in shared memory, 16 k x 4 columns a thread with the same
//   __byte_perm transpose4 as the decode kernel, into a K-major copy in
//   the 128B-swizzle layout that both warpgroups' wgmma read.
// - A ring of 4 slots runs 2 slices ahead; the transposed copy is double-
//   buffered, so a slice's wgmma chain runs while the next is transposed.
// - Split K (grid z, at most 8 ways) only when the tiles cannot fill the
//   card; the partial sums are added into the zeroed output with int32
//   atomics.
//
// Both kernels give exact int32 sums, so neither the kernel choice, nor
// a K split, nor the order of the atomics changes a bit.
// The SI variants need the whole sum in one block, so they never split
// K; their thresholds for the block's columns are loaded once into
// shared memory.

#include <climits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TILE_N = 128;        // 32 lanes x 4 columns
constexpr int UNROLL = 4;          // row groups a warp has in flight
constexpr int MAX_OUT_BSL = 32;
constexpr int DP4A_MAX_ROWS = 16;      // larger M runs the tensor cores

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
                      int M, int N, int K, int groups_per_split, int splits,
                      size_t x_bs, size_t w_bs, size_t o_bs, int out_bsl) {
  extern __shared__ __align__(16) int smem[];
  int* red = smem;
  int* thr_s = red + MT * TILE_N;
  int* xs = thr_s + (SI ? TILE_N * out_bsl : 0);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * TILE_N;
  const int m0 = blockIdx.y * MT;
  const int split = blockIdx.z % splits;
  const size_t b = blockIdx.z / splits;             // the product
  x += b * x_bs;
  w += b * w_bs;
  out += b * o_bs;
  const int G = K / 4;                              // row groups of 4
  const int g0 = split * groups_per_split;
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
    } else if (splits > 1) {
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

// Geometry::kernel of the ternary matmul: the dp4a kernel at 4 or 16
// rows a block, or the tensor-core (wgmma) kernel
enum TernaryKernel { TM_DP4A_4 = 0, TM_DP4A_16 = 1, TM_WGMMA = 2 };

// The dp4a launch's geometry: grid (column tiles, row tiles of MT,
// products x K splits); per_split: K row groups of 4 a split.
int dp4a_geometry(int MT, bool si, int batch, int M, int N, int K,
                  int out_bsl, Geometry& g) {
  const int G = K / 4;
  const int col_tiles = (N + TILE_N - 1) / TILE_N;
  const int row_tiles = (M + MT - 1) / MT;
  const size_t fixed = (static_cast<size_t>(MT) * TILE_N +
                        (si ? static_cast<size_t>(TILE_N) * out_bsl : 0)) *
                       sizeof(int);
  int gps = G;                          // row groups per K split
  if (!si && G > 0) {
    // split K until about two blocks per SM are in flight, and so that
    // the block's x rows fit in shared memory
    const long tiles = static_cast<long>(col_tiles) * row_tiles * batch;
    const long want = (2L * sm_count() + tiles - 1) / tiles;
    int splits = static_cast<int>(want < G ? want : G);
    gps = (G + splits - 1) / splits;
    const long fit = static_cast<long>((SMEM_CAP - fixed) /
                                       (static_cast<size_t>(MT) * 4));
    if (gps > fit) gps = static_cast<int>(fit);
  }
  const int splits = G > 0 ? (G + gps - 1) / gps : 1;
  if (static_cast<long>(splits) * batch > 65535)
    return refuse("ternary_matmul: %d products x %d K splits (K=%d) are "
                  "above a grid's 65535", batch, splits, K);
  g.kernel = MT == 4 ? TM_DP4A_4 : TM_DP4A_16;
  g.grid[0] = col_tiles;
  g.grid[1] = row_tiles;
  g.grid[2] = batch * splits;
  g.threads = THREADS;
  g.smem = static_cast<long long>(fixed +
                                  static_cast<size_t>(MT) * gps * sizeof(int));
  g.splits = splits;
  g.per_split = gps;
  g.block = MT;
  return 0;
}

template <int MT, bool SI>
int run(const Geometry& g, const int8_t* x, const int8_t* w, const int* thr,
        int* out, int batch, int M, int N, int K, int out_bsl,
        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(ternary_matmul_kernel<MT, SI>, smem,
                        "ternary_matmul");
  if (rc) return rc;
  const int splits = static_cast<int>(g.splits);
  const size_t mn = static_cast<size_t>(M) * N;
  if (splits > 1) {
    rc = static_cast<int>(
        cudaMemsetAsync(out, 0, batch * mn * sizeof(int), stream));
    if (rc) return rc;
  }
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]),
                  static_cast<unsigned>(g.grid[2]));
  ternary_matmul_kernel<MT, SI><<<grid, static_cast<int>(g.threads), smem,
                                  stream>>>(
      x, w, thr, out, M, N, K, static_cast<int>(g.per_split), splits,
      static_cast<size_t>(M) * K, static_cast<size_t>(K) * N, mn, out_bsl);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// M > 16: the int8 tensor cores (wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_BM = 128;             // rows a block: 2 warpgroups x 64
constexpr int TC_BN = 128;             // columns a block
constexpr int TC_BK = 128;             // K bytes a ring stage holds
constexpr int TC_STAGES = 4;           // ring of x / w slices; 2 ahead
constexpr int TC_TILE = TC_BM * TC_BK; // bytes of one 128 x 128 slice
constexpr int TC_FILL_BLOCKS = 132;    // split K below this many tiles
constexpr int TC_MAX_SPLITS = 8;       // more splits measured slower

// 128-byte rows whose 16-byte chunks are XOR-swizzled by the row's low 3
// bits: wgmma's 128B-swizzle layout (the tile starts 1024-byte aligned)
__device__ __forceinline__ uint32_t swz128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory descriptor of a K-major operand in that layout:
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_b128(uint32_t saddr) {
  return wgmma_desc(saddr, 16, 1024, 1);
}

// d (64 x 128 int32, the warpgroup's fragments) += a (64 x 32) * b (32 x
// 128), both int8 from shared memory
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// Shared memory (from a 1024-byte aligned base): TC_STAGES x (x slice
// 128 rows x 128 K bytes, wgmma layout; w slice 128 K rows x 128 bytes,
// chunks swizzled by (row / 16) % 8), then two transposed w slices (128
// columns x 128 K bytes, wgmma layout), then (SI) thr[out_bsl][128] int.
template <bool SI>
__global__ void __launch_bounds__(THREADS)
ternary_matmul_mma_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const int* __restrict__ thr, int* __restrict__ out,
                          int M, int N, int K, int ktiles_per_split,
                          int splits, size_t x_bs, size_t w_bs, size_t o_bs,
                          int out_bsl) {
  extern __shared__ __align__(1024) uint8_t tmm_smem[];
  const uint32_t base = (smem_u32(tmm_smem) + 1023) & ~1023u;
  uint8_t* const sbase = tmm_smem + (base - smem_u32(tmm_smem));
  uint8_t* const bt = sbase + TC_STAGES * 2 * TC_TILE;
  int* const thr_s = reinterpret_cast<int*>(bt + 2 * TC_TILE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;                 // warpgroup: rows 64 wg..
  const int m0 = blockIdx.x * TC_BM, n0 = blockIdx.y * TC_BN;
  const size_t bz = blockIdx.z / splits;    // the product
  x += bz * x_bs;
  w += bz * w_bs;
  out += bz * o_bs;
  const int kt0 = (blockIdx.z % splits) * ktiles_per_split;
  const int nkt = min((K + TC_BK - 1) / TC_BK, kt0 + ktiles_per_split) - kt0;
  const bool live = m0 + 64 * wg < M;       // the warpgroup has rows

  if constexpr (SI) {
    for (int i = tid; i < TC_BN * out_bsl; i += THREADS) {
      const int b = i / TC_BN, j = i - b * TC_BN;
      thr_s[i] = n0 + j < N ? thr[static_cast<size_t>(n0 + j) * out_bsl + b]
                            : INT_MAX;
    }
  }

  // slice kt0 + i into ring slot `slot`.  K % 16 == 0 and N % 16 == 0,
  // so a 16-byte chunk is wholly inside or outside the operand; outside
  // chunks are zero-filled, their source never addressed.
  auto load = [&](int slot, int i) {
    uint8_t* as = sbase + slot * 2 * TC_TILE;
    uint8_t* ws = as + TC_TILE;
    const int k0 = (kt0 + i) * TC_BK;
#pragma unroll
    for (int j = 0; j < TC_TILE / 16 / THREADS; ++j) {
      const int q = j * THREADS + tid, r = q >> 3, c = q & 7;
      const bool in = m0 + r < M && k0 + 16 * c < K;
      cp_async16(smem_u32(as + swz128(r, c)),
                 in ? x + static_cast<size_t>(m0 + r) * K + k0 + 16 * c : x,
                 in);
    }
#pragma unroll
    for (int j = 0; j < TC_TILE / 16 / THREADS; ++j) {
      const int q = j * THREADS + tid, r = q >> 3, c = q & 7;
      const bool in = k0 + r < K && n0 + 16 * c < N;
      cp_async16(smem_u32(ws + r * 128 + ((c ^ ((r >> 4) & 7)) << 4)),
                 in ? w + static_cast<size_t>(k0 + r) * N + n0 + 16 * c : w,
                 in);
    }
  };

  int acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 2; ++s) {
    if (s < nkt) load(s, s);
    cp_async_commit();
  }

  // the transpose: a thread takes 16 K rows (16 kc..16 kc + 15) x 4
  // columns (4 nq..4 nq + 3); a warp's lanes 8 kc's x 4 nq's, so its word
  // reads (w rows' chunks swizzled by kc) hit 32 banks and each 8-lane
  // phase of its 16-byte writes (one column, 8 kc chunks) 8 bank groups
  const int kc = lane & 7, nq = 4 * warp + (lane >> 3);
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<TC_STAGES - 3>();
    __syncthreads();          // slice i landed; wgmma(i - 2) retired
    if (i + TC_STAGES - 2 < nkt)
      load((i + TC_STAGES - 2) % TC_STAGES, i + TC_STAGES - 2);
    cp_async_commit();

    const uint8_t* ws = sbase + (i % TC_STAGES) * 2 * TC_TILE + TC_TILE +
                        16 * kc * 128 + (((nq >> 2) ^ kc) << 4) +
                        4 * (nq & 3);
    uint8_t* bti = bt + (i & 1) * TC_TILE;
    int col[4][4];                // [k-quad][column]
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t wv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        wv[r] = *reinterpret_cast<const uint32_t*>(ws + (4 * q + r) * 128);
      transpose4(wv[0], wv[1], wv[2], wv[3], col[q]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<int4*>(bti + swz128(4 * nq + c, kc)) =
          make_int4(col[0][c], col[1][c], col[2][c], col[3][c]);
    }
    fence_async_smem();       // this thread's x chunks and w words, seen
    __syncthreads();          //   by every warpgroup's wgmma

    if (live) {
      const uint32_t a = base + (i % TC_STAGES) * 2 * TC_TILE + wg * 64 * 128;
      const uint32_t b = smem_u32(bti);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < TC_BK / 32; ++ks)
        wgmma_s8(acc, desc_b128(a + 32 * ks), desc_b128(b + 32 * ks));
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  if constexpr (SI) __syncthreads();     // thr_s, even with no K slice

  // acc[4 j + e]: row 16 (warp % 4) + g (+ 8 for e >= 2) of the
  // warpgroup's 64, columns 8 j + 2 t + (e & 1)
  if (!live) return;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 64 * wg + 16 * (warp & 3) + g;   // tile rows row0, +8
  if constexpr (SI) {
    // threshold-outer, so each threshold pair is read once for all the
    // thread's 64 sums and the 16 reads of a step are independent
    int cnt[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) cnt[e] = 0;
    for (int b = 0; b < out_bsl; ++b) {
      const int* tb = thr_s + b * TC_BN + 2 * t;
#pragma unroll
      for (int j = 0; j < TC_BN / 8; ++j) {
        const int2 th = *reinterpret_cast<const int2*>(tb + 8 * j);
        cnt[4 * j] += acc[4 * j] >= th.x;
        cnt[4 * j + 1] += acc[4 * j + 1] >= th.y;
        cnt[4 * j + 2] += acc[4 * j + 2] >= th.x;
        cnt[4 * j + 3] += acc[4 * j + 3] >= th.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = cnt[e] - out_bsl / 2;
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gm = m0 + row0 + 8 * hr;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
      const int jn = 8 * j + 2 * t;
      if (n0 + jn >= N) continue;           // N % 16: both or neither
      const int v0 = acc[4 * j + 2 * hr], v1 = acc[4 * j + 2 * hr + 1];
      int* dst = out + static_cast<size_t>(gm) * N + n0 + jn;
      if (!SI && splits > 1) {
        atomicAdd(dst, v0);
        atomicAdd(dst + 1, v1);
      } else {
        *reinterpret_cast<int2*>(dst) = make_int2(v0, v1);
      }
    }
  }
}

// The tensor-core launch's geometry: grid (row tiles, column tiles,
// products x K splits); per_split: K slices of TC_BK a split.
int mma_geometry(bool si, int batch, int M, int N, int K, int out_bsl,
                 Geometry& g) {
  const int row_tiles = (M + TC_BM - 1) / TC_BM;
  const int col_tiles = (N + TC_BN - 1) / TC_BN;
  const int kt = (K + TC_BK - 1) / TC_BK;
  int kps = kt;                          // K slices per split
  if (!si && kt > 0) {
    // split K (a function of the shape alone) when the tiles of all the
    // products leave most of the card idle
    const long tiles = static_cast<long>(row_tiles) * col_tiles * batch;
    long splits = tiles < TC_FILL_BLOCKS ? TC_FILL_BLOCKS / tiles : 1;
    if (splits > TC_MAX_SPLITS) splits = TC_MAX_SPLITS;
    kps = static_cast<int>((kt + splits - 1) / splits);
  }
  const int splits = kt > 0 ? (kt + kps - 1) / kps : 1;
  if (col_tiles > 65535)
    return refuse("ternary_matmul: N=%d has too many column tiles", N);
  if (static_cast<long>(splits) * batch > 65535)
    return refuse("ternary_matmul: %d products x %d K splits are above a "
                  "grid's 65535", batch, splits);
  g.kernel = TM_WGMMA;
  g.grid[0] = row_tiles;
  g.grid[1] = col_tiles;
  g.grid[2] = batch * splits;
  g.threads = THREADS;
  g.smem = static_cast<long long>(
      1024 + static_cast<size_t>(TC_STAGES + 1) * 2 * TC_TILE +
      (si ? static_cast<size_t>(TC_BN) * out_bsl * sizeof(int) : 0));
  g.splits = splits;
  g.per_split = kps;
  g.block = TC_BM;
  return 0;
}

template <bool SI>
int run_mma(const Geometry& g, const int8_t* x, const int8_t* w,
            const int* thr, int* out, int batch, int M, int N, int K,
            int out_bsl, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(ternary_matmul_mma_kernel<SI>, smem,
                        "ternary_matmul");
  if (rc) return rc;
  const int splits = static_cast<int>(g.splits);
  const size_t mn = static_cast<size_t>(M) * N;
  if (splits > 1) {
    rc = static_cast<int>(
        cudaMemsetAsync(out, 0, batch * mn * sizeof(int), stream));
    if (rc) return rc;
  }
  const dim3 grid(static_cast<unsigned>(g.grid[0]),
                  static_cast<unsigned>(g.grid[1]),
                  static_cast<unsigned>(g.grid[2]));
  ternary_matmul_mma_kernel<SI><<<grid, static_cast<int>(g.threads), smem,
                                  stream>>>(
      x, w, thr, out, M, N, K, static_cast<int>(g.per_split), splits,
      static_cast<size_t>(M) * K, static_cast<size_t>(K) * N, mn, out_bsl);
  return static_cast<int>(cudaGetLastError());
}

// The launch's geometry for these sizes (si: the SI epilogue, with
// out_bsl threshold columns), after the checks of the sizes; a grid of
// zeros when there is nothing to launch.
int ternary_geometry(int batch, int M, int N, int K, bool si, int out_bsl,
                     Geometry& g) {
  if (batch < 0 || M < 0 || N < 0 || K < 0)
    return refuse("ternary_matmul: negative shape batch=%d M=%d N=%d K=%d",
                  batch, M, N, K);
  if (si && batch > 1)
    return refuse("ternary_matmul: the SI epilogue takes one product, got "
                  "batch=%d", batch);
  const bool mma = M > DP4A_MAX_ROWS;
  const int mult = mma ? 16 : 4;
  if (K % mult || N % mult)
    return refuse("ternary_matmul: K and N must be multiples of %d at M=%d "
                  "(the kernel reads %d-byte words), got K=%d N=%d", mult,
                  M, mult, K, N);
  if (si && (out_bsl < 1 || out_bsl > MAX_OUT_BSL))
    return refuse("ternary_matmul: the SI epilogue takes 1..%d threshold "
                  "columns, got out_bsl=%d", MAX_OUT_BSL, out_bsl);
  g = Geometry{};
  if (batch == 0 || M == 0 || N == 0) return 0;
  if (mma) return mma_geometry(si, batch, M, N, K, out_bsl, g);
  return dp4a_geometry(M <= 4 ? 4 : 16, si, batch, M, N, K, out_bsl, g);
}

}  // namespace

// The geometry ternary_matmul_launch would launch with for these sizes
// (out_bsl > 0: the SI epilogue; GEOMETRY_FIELDS values into out;
// Geometry::kernel is a TernaryKernel), or the refusal it would make.
extern "C" int ternary_matmul_geometry(int batch, int M, int N, int K,
                                       int out_bsl, long long* out) {
  Geometry g;
  if (int rc = ternary_geometry(batch, M, N, K, out_bsl > 0, out_bsl, g))
    return rc;
  write_geometry(g, out);
  return 0;
}

// x (batch, M, K) int8, w (batch, K, N) int8, thr (N, out_bsl) int32 or
// null (one product only), out (batch, M, N) int32, all contiguous on the
// card (checked by the Python wrapper, kernels/ternary_matmul.py).
// M <= DP4A_MAX_ROWS runs the dp4a kernel (K, N multiples of 4, x and w
// 4-byte aligned), larger M the tensor-core kernel (K, N multiples of 16,
// x and w 16-byte aligned).  Returns a CUDA error code.
extern "C" int ternary_matmul_launch(const void* x, const void* w,
                                     const void* thr, void* out, int batch,
                                     int M, int N, int K, int out_bsl,
                                     void* stream) {
  Geometry g;
  if (int rc = ternary_geometry(batch, M, N, K, thr != nullptr, out_bsl, g))
    return rc;
  const int mult = g.kernel == TM_WGMMA ? 16 : 4;
  if (reinterpret_cast<uintptr_t>(x) % mult ||
      reinterpret_cast<uintptr_t>(w) % mult)
    return refuse("ternary_matmul: x and w must start on a %d-byte "
                  "boundary at M=%d", mult, M);
  if (g.grid[0] == 0) return 0;
  const auto* xp = static_cast<const int8_t*>(x);
  const auto* wp = static_cast<const int8_t*>(w);
  const auto* tp = static_cast<const int*>(thr);
  auto* op = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const int B = batch;
  switch (g.kernel) {
    case TM_DP4A_4:
      return thr ? run<4, true>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s)
                 : run<4, false>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s);
    case TM_DP4A_16:
      return thr ? run<16, true>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s)
                 : run<16, false>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s);
    default:
      return thr ? run_mma<true>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s)
                 : run_mma<false>(g, xp, wp, tp, op, B, M, N, K, out_bsl, s);
  }
}
