// Bitonic sorting network (the exact BSN, paper Fig 3b) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bsn_sort.py: bsn_sort_pallas
// (_sort_kernel).  Sorts each row of an (R, L) tensor, L a power of two,
// with Batcher's network: log2(L) merge phases of 1..log2(L)
// compare-exchange levels; at level (k, j) position i pairs with i ^ j
// and the pair's direction is bit k of its position (descending keeps the
// larger value first where that bit is 0).  int8, int32 and float32: it
// sorts any values, not only bits, so there is no popcount shortcut.
//
// What bounds it: the compare-exchanges.  A row makes L/2 * log2(L) *
// (log2(L) + 1) / 2 of them against 2 * L * sizeof(T) bytes moved (for
// L = 16384 int8 bits, 105 levels per 32 KB), so the operations, not the
// memory, set the bound.  Design: a block holds whole rows in shared
// memory (one row, or several short rows, at least 2048 elements), reads
// them once, coalesced, runs every level there with one barrier per
// level, and writes them back once.  A row above the 227 KB a block can
// hold is refused.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int MIN_BLOCK_ELEMS = 2048;

enum SortDtype { S_INT8 = 0, S_INT32 = 1, S_F32 = 2 };

template <typename T>
__global__ void __launch_bounds__(THREADS)
bsn_sort_kernel(const T* __restrict__ in, T* __restrict__ out, int rows,
                int log_len, int rows_per_block, int descending) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int L = 1 << log_len;
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - r0);
  const size_t base = static_cast<size_t>(r0) * L;
  const int n = nr * L;
  for (int i = threadIdx.x; i < n; i += THREADS) s[i] = in[base + i];
  __syncthreads();

  const int log_half = log_len - 1;
  const int pairs = log_len > 0 ? nr << log_half : 0;
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < pairs; p += THREADS) {
        const int row = p >> log_half;
        const int q = p & ((1 << log_half) - 1);
        // the q-th pair: low partner has bit j clear
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const bool keep_hi = descending ? up : !up;
        T* rs = s + row * L;
        const T a = rs[lo], b = rs[hi];
        const T mx = a > b ? a : b;
        const T mn = a > b ? b : a;
        rs[lo] = keep_hi ? mx : mn;
        rs[hi] = keep_hi ? mn : mx;
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += THREADS) out[base + i] = s[i];
}

template <typename T>
int run(const void* in, void* out, int rows, int log_len, int descending,
        cudaStream_t stream) {
  const int L = 1 << log_len;
  const int rpb = L >= MIN_BLOCK_ELEMS ? 1 : MIN_BLOCK_ELEMS / L;
  const size_t smem = static_cast<size_t>(rpb) * L * sizeof(T);
  int rc = prepare_smem(bsn_sort_kernel<T>, smem, "bsn_sort");
  if (rc) return rc;
  const int blocks = (rows + rpb - 1) / rpb;
  bsn_sort_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(in), static_cast<T*>(out), rows, log_len, rpb,
      descending);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// in, out: (rows, L) contiguous on the card, L a power of two; dtype one
// of SortDtype (checked by the Python wrapper, kernels/bsn_sort.py).
// Returns a CUDA error code.
extern "C" int bsn_sort_launch(const void* in, void* out, int rows, int L,
                               int dtype, int descending, void* stream) {
  if (rows < 0 || L < 1 || (L & (L - 1)))
    return refuse("bsn_sort: takes rows >= 0 and a power-of-two row "
                  "length, got rows=%d L=%d", rows, L);
  int log_len = 0;
  while ((1 << log_len) < L) ++log_len;
  if (rows == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case S_INT8: return run<int8_t>(in, out, rows, log_len, descending, s);
    case S_INT32: return run<int>(in, out, rows, log_len, descending, s);
    case S_F32: return run<float>(in, out, rows, log_len, descending, s);
    default:
      return refuse("bsn_sort: dtype code %d is not int8 (0), int32 (1) "
                    "or float32 (2)", dtype);
  }
}
