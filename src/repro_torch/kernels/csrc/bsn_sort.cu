// Bitonic sorting network (the exact BSN, paper Fig 3b) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bsn_sort.py: bsn_sort_pallas
// (_sort_kernel).  Sorts each row of an (R, L) tensor, L a power of two,
// with Batcher's network: log2(L) merge phases of 1..log2(L)
// compare-exchange levels; at level (k, j) position i pairs with i ^ j
// and the pair's direction is bit k of its position (descending keeps the
// larger value first where that bit is 0).  int8, int32 and float32: it
// sorts any values, not only bits, so there is no popcount shortcut.  A
// pair (a, b) keeps (a > b ? a : b, a > b ? b : a) in its order, as the
// plain version's network does.
//
// What bounds it: the compare-exchanges.  A row makes L/2 * log2(L) *
// (log2(L) + 1) / 2 of them against 2 * L * sizeof(T) bytes moved (for
// L = 16384 int8 bits, 105 levels per 32 KB), so the instructions per
// exchange, not the memory, set the time.  Design: the network runs where
// the data already is.  Each thread holds a run of RUN = 32 consecutive
// positions in registers (RUN = 64 or 128 for int8 rows above 32768),
// int8 packed four to a 32-bit word; a block holds one row (or several
// short rows: at least 8192 elements), read and written once, coalesced
// in 16-byte vectors.  A level with partner distance j runs
// - inside a word (int8, j = 1, 2): prmt swaps the partner bytes, and
//   one SIMD compare-select does the word's two exchanges;
// - inside the thread (j < RUN): whole words pair with whole words, four
//   int8 exchanges per SIMD compare-select;
// - inside the warp (j < 32 RUN): __shfl_xor_sync brings the partner
//   lane's words, no barrier;
// - across warps (j >= 32 RUN, 10 of 105 levels at L = 16384): in shared
//   memory, 16-byte vector pairs, one barrier a level.
// The int8 compare-select is SWAR on the packed word: 8 integer
// instructions for four compare-exchanges (7 for one side of four).  A
// row above the 227 KB a block can hold in shared memory is refused.

#include "common.cuh"

namespace {

enum SortDtype { S_INT8 = 0, S_INT32 = 1, S_F32 = 2 };

constexpr int MIN_BLOCK_ELEMS = 8192;   // short rows share a block
constexpr int MAX_THREADS = 1024;

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// c ? x : y bit by bit, one LOP3 (left to itself the compiler splits the
// select into three once c comes out of a predicated flip)
__device__ __forceinline__ uint32_t bitsel(uint32_t c, uint32_t x,
                                           uint32_t y) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xca;" : "=r"(r) : "r"(c), "r"(x), "r"(y));
  return r;
}

// The element operations on a register word W.  gt(a, b) is the
// condition a > b (M: a bool, or for packed int8 0xff / 0x00 per byte);
// sel(c, x, y) is c ? x : y; all(f) is f in every lane of M.
template <typename T>
struct Ops;

template <>
struct Ops<int8_t> {
  using W = uint32_t;   // four elements, the lowest position in the low byte
  using M = uint32_t;
  static constexpr int EPW = 4;
  static constexpr bool kExactTies = false;
  static __device__ __forceinline__ M all(bool f) {
    return f ? 0xffffffffu : 0u;
  }
  static __device__ __forceinline__ M xr(M a, M b) { return a ^ b; }
  static __device__ __forceinline__ M gt(W a, W b) {
    // per byte, b < a: of unlike signs the negative one is smaller (bit 7
    // of b where a ^ b has it); of like signs the low 7 bits decide, and
    // bit 7 of (b | 0x80) - (a & 0x7f), which borrows from no other byte,
    // is clear exactly where b's low bits are below a's.  prmt's sign mode
    // (selector nibbles 8..b) spreads each bit 7 over its byte.
    const uint32_t t = (b | 0x80808080u) - (a & 0x7f7f7f7fu);
    const uint32_t x = ((a ^ b) & b) | (~(a ^ b) & ~t);
    return prmt(x, 0u, 0xba98u);
  }
  static __device__ __forceinline__ W sel(M c, W x, W y) {
    return bitsel(c, x, y);
  }
  static __device__ __forceinline__ W from_bits(uint32_t u) { return u; }
  static __device__ __forceinline__ uint32_t bits(W w) { return w; }
};

template <>
struct Ops<int> {
  using W = int;
  using M = bool;
  static constexpr int EPW = 1;
  static constexpr bool kExactTies = false;
  static __device__ __forceinline__ M all(bool f) { return f; }
  static __device__ __forceinline__ M xr(M a, M b) { return a != b; }
  static __device__ __forceinline__ M gt(W a, W b) { return a > b; }
  static __device__ __forceinline__ W sel(M c, W x, W y) { return c ? x : y; }
  static __device__ __forceinline__ W from_bits(uint32_t u) {
    return static_cast<int>(u);
  }
  static __device__ __forceinline__ uint32_t bits(W w) {
    return static_cast<uint32_t>(w);
  }
};

template <>
struct Ops<float> {
  using W = float;
  using M = bool;
  static constexpr int EPW = 1;
  // a > b is false both ways for -0 / +0 and for NaN: which of the two
  // goes first then depends on the pair's order, so keep that order
  static constexpr bool kExactTies = true;
  static __device__ __forceinline__ M all(bool f) { return f; }
  static __device__ __forceinline__ M xr(M a, M b) { return a != b; }
  static __device__ __forceinline__ M gt(W a, W b) { return a > b; }
  static __device__ __forceinline__ W sel(M c, W x, W y) { return c ? x : y; }
  static __device__ __forceinline__ W from_bits(uint32_t u) {
    return __uint_as_float(u);
  }
  static __device__ __forceinline__ uint32_t bits(W w) {
    return __float_as_uint(w);
  }
};

// Compare-exchange of a (the lower position) and b; f is all-ones where
// the pair ascends (the larger value goes to the higher position).
template <class O>
__device__ __forceinline__ void cx(typename O::W& a, typename O::W& b,
                                   typename O::M f) {
  const typename O::M c = O::xr(O::gt(a, b), f);
  const typename O::W lo = O::sel(c, a, b), hi = O::sel(c, b, a);
  a = lo;
  b = hi;
}

// This thread's new value of a pair whose other half p lives in another
// lane: w is the lower position's value when is_low.
template <class O>
__device__ __forceinline__ typename O::W pick(typename O::W w,
                                              typename O::W p, bool is_low,
                                              typename O::M f) {
  if constexpr (O::kExactTies) {
    const typename O::W a = is_low ? w : p, b = is_low ? p : w;
    return O::sel(O::xr(O::gt(a, b), f), w, p);
  } else {
    // equal values are interchangeable: the higher half takes
    // gt(w, p) ^ ~f, the complement of its condition but at ties
    return O::sel(O::xr(O::gt(w, p), O::xr(f, O::all(!is_low))), w, p);
  }
}

// int8, pairs inside a word (J = 1: bytes 0-1 and 2-3; J = 2: 0-2, 1-3);
// f per byte as in cx.  The higher byte of a pair sees the swapped
// comparison, so its condition is complemented (HIGH).
template <int J>
__device__ __forceinline__ uint32_t cx_in_word(uint32_t a, uint32_t f) {
  using O = Ops<int8_t>;
  constexpr uint32_t SWAP = J == 1 ? 0x2301u : 0x1032u;
  constexpr uint32_t HIGH = J == 1 ? 0xff00ff00u : 0xffff0000u;
  const uint32_t b = prmt(a, 0u, SWAP);
  return O::sel(O::gt(a, b) ^ f ^ HIGH, a, b);
}

// Direction of a pair at phase k: ascending (all-ones) where bit k of its
// position in the row, xor the sort's order, is set; pos & (L - 1) keeps
// the row's own bits when several rows share a block.
template <class O>
__device__ __forceinline__ typename O::M ascends(int pos, int k, int len_mask,
                                                 int asc) {
  return O::all(((pos & k & len_mask) != 0) != (asc != 0));
}

// Level J (< RUN) of phase k on this thread's run, in registers.
template <class O, int NW, int J>
__device__ __forceinline__ void thread_level(typename O::W (&w)[NW], int k,
                                             int base, int len_mask,
                                             int asc) {
  constexpr int EPW = O::EPW;
  constexpr int RUN = NW * EPW;
  if constexpr (J >= EPW) {
    constexpr int JW = J / EPW;
    if (k >= RUN) {                   // one direction for the whole run
      const typename O::M f = ascends<O>(base, k, len_mask, asc);
#pragma unroll
      for (int i = 0; i < NW; ++i)
        if (!(i & JW)) cx<O>(w[i], w[i + JW], f);
    } else {
#pragma unroll
      for (int i = 0; i < NW; ++i)
        if (!(i & JW))
          cx<O>(w[i], w[i + JW], ascends<O>(i * EPW, k, len_mask, asc));
    }
  } else if (k >= RUN) {              // int8 within a word
    const uint32_t f = ascends<O>(base, k, len_mask, asc);
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = cx_in_word<J>(w[i], f);
  } else {
    // at k = 2 bytes 2-3 (bit 1 set) run opposite to bytes 0-1, unless
    // the row is 2 long
    const uint32_t k2 = ascends<O>(0, 2, len_mask, asc) ^
                        ((len_mask & 2) ? 0xffff0000u : 0u);
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const uint32_t f =
          k == 2 ? k2 : ascends<O>(i * EPW, k, len_mask, asc);
      w[i] = cx_in_word<J>(w[i], f);
    }
  }
}

// Levels J, J/2, ..., 1 of phase k (those below k).
template <class O, int NW, int J>
__device__ __forceinline__ void thread_levels(typename O::W (&w)[NW], int k,
                                              int base, int len_mask,
                                              int asc) {
  if (J < k) thread_level<O, NW, J>(w, k, base, len_mask, asc);
  if constexpr (J > 1)
    thread_levels<O, NW, J / 2>(w, k, base, len_mask, asc);
}

template <class W>
struct alignas(16) Quad {
  W v[4];
};

// A run of RUN elements from src (n of them exist) into words, 16-byte
// vector loads when the run is whole and aligned; the rest reads as 0.
template <typename T, class O, int NW>
__device__ __forceinline__ void load_run(typename O::W (&w)[NW],
                                         const T* src, long long n,
                                         bool vec) {
  constexpr int RUN = NW * O::EPW;
  if (vec && n >= RUN) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      const uint4 u = s4[q];
      w[4 * q] = O::from_bits(u.x);
      w[4 * q + 1] = O::from_bits(u.y);
      w[4 * q + 2] = O::from_bits(u.z);
      w[4 * q + 3] = O::from_bits(u.w);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (O::EPW == 4) {
      uint32_t word = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = 4 * i + e;
        const uint32_t byte =
            at < n ? static_cast<uint8_t>(src[at]) : 0u;
        word |= byte << (8 * e);
      }
      w[i] = word;
    } else {
      w[i] = i < n ? src[i] : T(0);
    }
  }
}

template <typename T, class O, int NW>
__device__ __forceinline__ void store_run(const typename O::W (&w)[NW],
                                          T* dst, long long n, bool vec) {
  constexpr int RUN = NW * O::EPW;
  if (vec && n >= RUN) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
#pragma unroll
    for (int q = 0; q < NW / 4; ++q) {
      d4[q] = make_uint4(O::bits(w[4 * q]), O::bits(w[4 * q + 1]),
                         O::bits(w[4 * q + 2]), O::bits(w[4 * q + 3]));
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    if constexpr (O::EPW == 4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int at = 4 * i + e;
        if (at < n) dst[at] = static_cast<T>((w[i] >> (8 * e)) & 0xffu);
      }
    } else {
      if (i < n) dst[i] = w[i];
    }
  }
}

// One block sorts blockDim.x * RUN consecutive elements of the (rows, L)
// array: one row, or L-aligned short rows; a tail block's missing
// elements sort as zeros in rows of their own and are not written.
template <typename T, int RUN>
__global__ void __launch_bounds__(MAX_THREADS)
bsn_sort_reg_kernel(const T* __restrict__ in, T* __restrict__ out,
                    long long total, int log_len, int asc, int vec) {
  using O = Ops<T>;
  using W = typename O::W;
  constexpr int NW = RUN / O::EPW;
  constexpr int WARP_SPAN = 32 * RUN;
  constexpr int QUAD = 4 * O::EPW;            // elements of a 16-byte quad
  static_assert(NW % 8 == 0, "a run is a whole number of quad pairs");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Quad<W>* s4 = reinterpret_cast<Quad<W>*>(smem_raw);

  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int L = 1 << log_len, len_mask = L - 1;
  const int base = tid * RUN;                  // the run's position
  const long long start = static_cast<long long>(blockIdx.x) * nt * RUN +
                          base;
  const long long n = total - start;
  W w[NW];
  load_run<T, O, NW>(w, in + (n > 0 ? start : 0), n, vec != 0);

  for (int k = 2; k <= L; k <<= 1) {
    int j = k >> 1;
    if (j >= WARP_SPAN) {                      // across warps
#pragma unroll
      for (int q = 0; q < NW / 4; ++q)
        s4[tid * (NW / 4) + q] = Quad<W>{{w[4 * q], w[4 * q + 1],
                                          w[4 * q + 2], w[4 * q + 3]}};
      __syncthreads();
      for (; j >= WARP_SPAN; j >>= 1) {
        const int jq = j / QUAD;
#pragma unroll
        for (int i = 0; i < NW / 8; ++i) {
          const int p = tid + i * nt;          // the p-th quad pair
          const int lo = ((p & ~(jq - 1)) << 1) | (p & (jq - 1));
          const typename O::M f = ascends<O>(lo * QUAD, k, len_mask, asc);
          Quad<W> a = s4[lo], b = s4[lo + jq];
#pragma unroll
          for (int e = 0; e < 4; ++e) cx<O>(a.v[e], b.v[e], f);
          s4[lo] = a;
          s4[lo + jq] = b;
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < NW / 4; ++q) {
        const Quad<W> u = s4[tid * (NW / 4) + q];
        w[4 * q] = u.v[0];
        w[4 * q + 1] = u.v[1];
        w[4 * q + 2] = u.v[2];
        w[4 * q + 3] = u.v[3];
      }
    }
    if (j >= RUN) {                            // across lanes of the warp
      const typename O::M f = ascends<O>(base, k, len_mask, asc);
      for (; j >= RUN; j >>= 1) {
        const int delta = j / RUN;
        const bool is_low = !(lane & delta);
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          const W p = __shfl_xor_sync(0xffffffffu, w[i], delta);
          w[i] = pick<O>(w[i], p, is_low, f);
        }
      }
    }
    thread_levels<O, NW, RUN / 2>(w, k, base, len_mask, asc);
  }
  if (n > 0) store_run<T, O, NW>(w, out + start, n, vec != 0);
}

// A thread's run of positions for a row of 2^log_len elements of
// `bytes` each: 32 up to L = 32768 (1024 threads); longer int8 rows take
// longer runs.  Any longer row needs more than a block's shared memory,
// and the launch refuses it.
int run_length(int bytes, int log_len) {
  if (bytes == 1 && log_len == 16) return 64;
  if (bytes == 1 && log_len >= 17) return 128;
  return 32;
}

// The launch's geometry: grid (blocks of max(L, MIN_BLOCK_ELEMS)
// elements), elements / RUN threads (Geometry::kernel: RUN); shared
// memory only where a level crosses warps (L > 32 RUN).
int sort_geometry(int rows, int L, int dtype, Geometry& g) {
  if (rows < 0 || L < 1 || (L & (L - 1)))
    return refuse("bsn_sort: takes rows >= 0 and a power-of-two row "
                  "length, got rows=%d L=%d", rows, L);
  if (dtype != S_INT8 && dtype != S_INT32 && dtype != S_F32)
    return refuse("bsn_sort: dtype code %d is not int8 (0), int32 (1) "
                  "or float32 (2)", dtype);
  int log_len = 0;
  while ((1 << log_len) < L) ++log_len;
  g = Geometry{};
  if (rows == 0) return 0;
  const int bytes = dtype == S_INT8 ? 1 : 4;
  const int run = run_length(bytes, log_len);
  const long long elems = L > MIN_BLOCK_ELEMS ? L : MIN_BLOCK_ELEMS;
  const long long total = static_cast<long long>(rows) * L;
  g.kernel = run;
  g.grid[0] = (total + elems - 1) / elems;
  g.grid[1] = 1;
  g.grid[2] = 1;
  g.threads = elems / run;            // <= MAX_THREADS where smem fits
  g.smem = L > 32LL * run ? elems * bytes : 0;
  g.block = elems;
  return 0;
}

template <typename T, int RUN>
int launch_run(const void* in, void* out, const Geometry& g, int rows,
               int log_len, int descending, cudaStream_t stream) {
  const long long L = 1LL << log_len;
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(bsn_sort_reg_kernel<T, RUN>, smem, "bsn_sort");
  if (rc) return rc;
  const long long total = static_cast<long long>(rows) * L;
  const int vec = (reinterpret_cast<uintptr_t>(in) |
                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  bsn_sort_reg_kernel<T, RUN>
      <<<static_cast<unsigned>(g.grid[0]), static_cast<int>(g.threads),
         smem, stream>>>(static_cast<const T*>(in), static_cast<T*>(out),
                         total, log_len, descending ? 0 : 1, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* in, void* out, const Geometry& g, int rows, int log_len,
        int descending, cudaStream_t stream) {
  if constexpr (sizeof(T) == 1) {
    if (g.kernel == 64)
      return launch_run<T, 64>(in, out, g, rows, log_len, descending,
                               stream);
    if (g.kernel == 128)
      return launch_run<T, 128>(in, out, g, rows, log_len, descending,
                                stream);
  }
  return launch_run<T, 32>(in, out, g, rows, log_len, descending, stream);
}

}  // namespace

// The geometry bsn_sort_launch would launch with for these sizes
// (GEOMETRY_FIELDS values into out), or the refusal it would make.
extern "C" int bsn_sort_geometry(int rows, int L, int dtype,
                                 long long* out) {
  Geometry g;
  if (int rc = sort_geometry(rows, L, dtype, g)) return rc;
  write_geometry(g, out);
  return 0;
}

// in, out: (rows, L) contiguous on the card, L a power of two; dtype one
// of SortDtype (checked by the Python wrapper, kernels/bsn_sort.py).
// Returns a CUDA error code.
extern "C" int bsn_sort_launch(const void* in, void* out, int rows, int L,
                               int dtype, int descending, void* stream) {
  Geometry g;
  if (int rc = sort_geometry(rows, L, dtype, g)) return rc;
  if (rows == 0) return 0;
  int log_len = 0;
  while ((1 << log_len) < L) ++log_len;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case S_INT8: return run<int8_t>(in, out, g, rows, log_len, descending, s);
    case S_INT32: return run<int>(in, out, g, rows, log_len, descending, s);
    default: return run<float>(in, out, g, rows, log_len, descending, s);
  }
}
