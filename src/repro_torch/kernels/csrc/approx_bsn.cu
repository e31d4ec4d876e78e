// Approximate progressive-sorting BSN adder (paper §IV-B, Fig 10b and
// the Fig 12 temporal reuse), count domain, for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/approx_bsn.py:
// approx_bsn_pallas (_spatial_kernel, _pipeline) and
// approx_bsn_temporal_pallas (_temporal_kernel).  For each row of
// (R, cycles * width) int32 popcounts it runs, on each of the `cycles`
// chunks of `width` counts, a static chain of stages (group g, clip c,
// stride s), entering BSL L:
//     x <- sum over groups of g
//     x <- clamp(x - c, 0, g*L - 2c)          (clamps even when c == 0)
//     x <- (x + s/2) / s                      (x >= 0: floor == shift)
// and writes the (R,) int32 sum of the chunks' output popcounts (the
// spatial adder is cycles == 1).  The TPU walks the cycle axis as a
// sequential grid dimension that revisits the output block; here the
// row's block loops over its chunks itself and keeps the running sum in
// a register, so no output is revisited and no atomics are needed.
//
// What bounds it: memory.  Each count is read once and used in one add,
// so the card's 3.35 TB/s read rate is the limit (on the serving path
// R = tokens x N rows of width K in {2048, 8192}).  Design: one block per
// row, of 256 threads, or fewer for a narrow chunk (width / 8, at least
// one warp) so that more rows are in flight while each short chunk
// waits on its reads and barriers.  Stage 1 reads the row straight from
// device memory with consecutive threads on consecutive words
// (coalesced); its partial codes stay in shared memory for the later
// stages, so nothing between stages goes back to device memory.  A
// stage with one output (the last one, and the whole pipeline of
// default_approx_spec) is a block-wide reduction; a stage with group >=
// 32 gives each output a warp; a narrower group gives each output a
// thread.  All sums are integer, so the order of reduction changes no
// bit.

#include "common.cuh"

namespace {

constexpr int MAX_STAGES = 8;

struct Stages {
  int n;
  int group[MAX_STAGES];
  int clip[MAX_STAGES];
  int stride[MAX_STAGES];
  int kept[MAX_STAGES];     // g * L - 2c: the saturation ceiling
  int buf0, buf1;           // shared-memory ping-pong sizes (ints)
};

__device__ __forceinline__ int finish(int x, int clip, int kept,
                                      int stride) {
  x = min(max(x - clip, 0), kept);
  return stride > 1 ? (x + stride / 2) / stride : x;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// THREADS is a compile-time constant: the strided loops below unroll on
// it (a run-time block size made the 256-thread kernel 1.5x slower).
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
approx_bsn_kernel(const int* __restrict__ counts, int* __restrict__ out,
                  int width, int cycles, Stages st) {
  extern __shared__ int bufs[];
  __shared__ int red[THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = THREADS / 32;
  const int row = blockIdx.x;

  int total = 0;                        // thread 0: sum over the chunks
  for (int t = 0; t < cycles; ++t) {
    const int* in = counts + (static_cast<size_t>(row) * cycles + t) * width;
    int n = width;
    for (int s = 0; s < st.n; ++s) {
      const int g = st.group[s], m = n / g;
      const int clip = st.clip[s], kept = st.kept[s], stride = st.stride[s];
      int* dst = (s & 1) ? bufs + st.buf0 : bufs;
      if (m == 1) {                       // block-wide reduction
        int v = 0;
        for (int i = tid; i < n; i += THREADS) v += in[i];
        v = warp_sum(v);
        if (lane == 0) red[warp] = v;
        __syncthreads();
        if (warp == 0) {
          v = lane < nwarps ? red[lane] : 0;
          v = warp_sum(v);
          if (lane == 0) {
            v = finish(v, clip, kept, stride);
            if (s == st.n - 1) total += v; else dst[0] = v;
          }
        }
      } else if (g >= 32) {               // one warp per output
        for (int j = warp; j < m; j += nwarps) {
          int v = 0;
          for (int i = lane; i < g; i += 32) v += in[j * g + i];
          v = warp_sum(v);
          if (lane == 0) dst[j] = finish(v, clip, kept, stride);
        }
      } else {                            // one thread per output
        for (int j = tid; j < m; j += THREADS) {
          int v = 0;
          for (int i = 0; i < g; ++i) v += in[j * g + i];
          dst[j] = finish(v, clip, kept, stride);
        }
      }
      __syncthreads();
      in = dst;
      n = m;
    }
  }
  if (tid == 0) out[row] = total;
}

template <int THREADS>
int run(const int* counts, int* out, const Geometry& g, int width,
        int cycles, const Stages& st, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(g.smem);
  int rc = prepare_smem(approx_bsn_kernel<THREADS>, smem, "approx_bsn");
  if (rc) return rc;
  approx_bsn_kernel<THREADS><<<static_cast<unsigned>(g.grid[0]), THREADS,
                               smem, stream>>>(counts, out, width, cycles,
                                               st);
  return static_cast<int>(cudaGetLastError());
}

// The launch's stage table and geometry, after the checks of the sizes:
// grid (rows); a block of width / 8 threads, one warp to 256
// (Geometry::kernel and threads: that block size); shared memory: the
// two stage buffers.
int approx_geometry(int rows, int width, int cycles, int in_bsl,
                    const int* stages, int n_stages, Stages& st,
                    Geometry& g) {
  if (n_stages < 1 || n_stages > MAX_STAGES || rows < 1 || width < 1 ||
      cycles < 1)
    return refuse("approx_bsn: takes 1..%d stages and positive rows, "
                  "width and cycles", MAX_STAGES);
  st = Stages{};
  st.n = n_stages;
  int bsl = in_bsl, n = width;
  int sizes[MAX_STAGES];
  for (int s = 0; s < n_stages; ++s) {
    st.group[s] = stages[3 * s];
    st.clip[s] = stages[3 * s + 1];
    st.stride[s] = stages[3 * s + 2];
    st.kept[s] = bsl * st.group[s] - 2 * st.clip[s];
    bsl = st.kept[s] / st.stride[s];
    n /= st.group[s];
    sizes[s] = n;                       // outputs of stage s
  }
  // stage s writes buffer s & 1; buffer 0 holds stage 0's outputs (the
  // largest it ever holds), buffer 1 stage 1's
  st.buf0 = sizes[0];
  st.buf1 = n_stages > 1 ? sizes[1] : 0;
  g = Geometry{};
  g.threads = width <= 32 * 8 ? 32 : width <= 64 * 8 ? 64
              : width <= 128 * 8 ? 128 : 256;
  g.kernel = g.threads;
  g.grid[0] = rows;
  g.grid[1] = 1;
  g.grid[2] = 1;
  g.smem = static_cast<long long>(st.buf0 + st.buf1) * sizeof(int);
  return 0;
}

}  // namespace

// The geometry approx_bsn_launch would launch with for these arguments
// (GEOMETRY_FIELDS values into out), or the refusal it would make.
extern "C" int approx_bsn_geometry(int rows, int width, int cycles,
                                   int in_bsl, const int* stages,
                                   int n_stages, long long* out) {
  Stages st;
  Geometry g;
  if (int rc = approx_geometry(rows, width, cycles, in_bsl, stages,
                               n_stages, st, g))
    return rc;
  write_geometry(g, out);
  return 0;
}

// counts: (rows, cycles * width); stages: n_stages triples (group, clip,
// stride), validated by the Python wrapper
// (kernels/approx_bsn.validate_stages).  Returns a CUDA error code.
extern "C" int approx_bsn_launch(const void* counts, void* out, int rows,
                                 int width, int cycles, int in_bsl,
                                 const int* stages, int n_stages,
                                 void* stream) {
  Stages st;
  Geometry g;
  if (int rc = approx_geometry(rows, width, cycles, in_bsl, stages,
                               n_stages, st, g))
    return rc;
  const auto* c = static_cast<const int*>(counts);
  auto* o = static_cast<int*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (g.threads) {
    case 32: return run<32>(c, o, g, width, cycles, st, s);
    case 64: return run<64>(c, o, g, width, cycles, st, s);
    case 128: return run<128>(c, o, g, width, cycles, st, s);
    default: return run<256>(c, o, g, width, cycles, st, s);
  }
}
