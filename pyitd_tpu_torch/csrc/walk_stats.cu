// The MEITD walk's gate statistics of a row (walk_stats_kernel), on Hopper
// (sm_90a), plain C interface.
//
// Replaces: no Pallas kernel.  JAX computes these in plain jnp; the kernel
// fuses the eager glue of ops/extrema.py::count_extrema and
// ops/wpe.py::weighted_permutation_entropy at order 3, delay 1, normalised:
// about 150 ATen calls a stage of the walk (decomp/meitd_jit.py) become one
// launch, whose (2, rows) buffer the stage copies to the host.
//
// Per row of n f64 samples it writes
//   out[row]        the number of interior extrema, as extrema_masks marks
//                   them: the plateau-rightmost rule, a difference that is
//                   NaN counts as +inf, a sample within 1 of a NaN never
//                   counts, the endpoints never count;
//   out[rows + row] (ENTROPY) the weighted permutation entropy of the n - 2
//                   windows x[j..j+2]: each window's rank pattern with the
//                   stable tie-break of the plain version, weighted by the
//                   window's ddof = 0 variance, -sum p log2 p over the six
//                   pattern bins in ascending hash order, / log2(3!).
// A window with a NaN compares false everywhere, as in the plain version:
// its pattern may be no permutation (its weight then lands in no bin) or
// put a NaN into a bin, and a NaN total makes every p NaN, so the entropy
// reads -0.0 as the plain version's does.
//
// What bounds it: bytes, 8 a sample read once; the stencil's other three
// loads hit L1.  A stage of the walk (at most 32 rows of 32,768) is one
// wave and latency; the ensemble's select (1,440 rows, 377 MB) is 0.113 ms
// at the data sheet's 3.35 TB/s.
//
// Determinism: one CTA a row, a fixed thread count.  Thread t sweeps the
// samples t, t + THREADS, ... in order, accumulating an integer count and
// the six bin sums in f64; the block reduces them in a fixed order (warp
// shuffles, then warp 0 shuffles the warps' partials from shared memory).
// So a row's result depends on that row alone -- not on the batch it rides
// in or its place there -- and is the same on every run: the entropy gates
// a discrete decision.  The bins' order of additions differs from the
// plain version's reduction, so entropies agree to rounding, not bit for
// bit; counts are exact.  Built with -fmad=false, each window's variance
// is a rounded product and sum as in the plain version, its / 3 a product
// with 1 / 3 as PyTorch's CUDA division by a scalar forms it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// 1,024 threads a row and four samples in flight a thread: a stage's time
// is one CTA's latency (0.018 ms at 32 x 32,768), which the most threads
// shorten; at the select 512 threads read 0.187 ms against 0.234, less
// than a stage's difference times the 64 stages of a call
constexpr int THREADS = 1024;
constexpr int UNROLL = 4;
constexpr int WARPS = THREADS / 32;
constexpr int NBIN = 6;
constexpr unsigned FULL = 0xffffffffu;
constexpr double THIRD = 1.0 / 3.0;

// The window's pattern bin from the ranks of its middle and last sample
// (r1, r2 in 0..2): the plain version's hash is 3^r1 + 2 * 3^r2, and the
// permutations' hashes 5, 7, 11, 15, 19, 21 are bins 0 to 5; the other
// three hashes (3, 9, 27) only a NaN can give, and they have no bin.
__constant__ int8_t BIN[9] = {-1, 1, 4, 0, -1, 5, 2, 3, -1};

__device__ __forceinline__ double diff(double a, double b) {
  const double d = a - b;
  return isnan(d) ? INFINITY : d;
}

template <bool ENTROPY>
__global__ void __launch_bounds__(THREADS)
walk_stats_kernel(const double* __restrict__ x, int rows, int n, double norm,
                  double* __restrict__ out) {
  const int row = blockIdx.x;
  const double* xr = x + (int64_t)row * n;
  int count = 0;
  double acc[NBIN];
#pragma unroll
  for (int b = 0; b < NBIN; ++b) acc[b] = 0.0;

#pragma unroll UNROLL
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const double c = xr[i];
    const double l = i > 0 ? xr[i - 1] : 0.0;
    const double r = i + 1 < n ? xr[i + 1] : 0.0;
    if (i > 0 && i + 1 < n && !isnan(l) && !isnan(c) && !isnan(r)) {
      const double db = diff(c, l), df = diff(r, c);
      count += ((db <= 0.0 && df > 0.0) || (db >= 0.0 && df < 0.0));
    }
    if (ENTROPY && i + 2 < n) {
      const double v0 = c, v1 = r, v2 = xr[i + 2];
      // rank_i = #{j: v_j < v_i} + #{j < i: v_j == v_i}; a <= b is
      // a < b || a == b, a NaN included
      const int r1 = (v0 <= v1) + (v2 < v1);
      const int r2 = (v0 <= v2) + (v1 <= v2);
      const int bin = BIN[3 * r1 + r2];
      // / 3 as PyTorch's CUDA division by a scalar forms it: times 1 / 3
      const double mean = (v0 + v1 + v2) * THIRD;
      const double d0 = v0 - mean, d1 = v1 - mean, d2 = v2 - mean;
      const double var = (d0 * d0 + d1 * d1 + d2 * d2) * THIRD;
#pragma unroll
      for (int b = 0; b < NBIN; ++b) acc[b] += bin == b ? var : 0.0;
    }
  }

  // warp shuffles, then warp 0 over the warps' partials in shared memory
  __shared__ int cnt_w[WARPS];
  __shared__ double acc_w[NBIN][WARPS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    count += __shfl_down_sync(FULL, count, o);
    if (ENTROPY) {
#pragma unroll
      for (int b = 0; b < NBIN; ++b)
        acc[b] += __shfl_down_sync(FULL, acc[b], o);
    }
  }
  if (lane == 0) {
    cnt_w[warp] = count;
    if (ENTROPY) {
#pragma unroll
      for (int b = 0; b < NBIN; ++b) acc_w[b][warp] = acc[b];
    }
  }
  __syncthreads();
  if (warp != 0) return;
  count = lane < WARPS ? cnt_w[lane] : 0;
  if (ENTROPY) {
#pragma unroll
    for (int b = 0; b < NBIN; ++b)
      acc[b] = lane < WARPS ? acc_w[b][lane] : 0.0;
  }
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    count += __shfl_down_sync(FULL, count, o);
    if (ENTROPY) {
#pragma unroll
      for (int b = 0; b < NBIN; ++b)
        acc[b] += __shfl_down_sync(FULL, acc[b], o);
    }
  }
  if (lane != 0) return;
  out[row] = (double)count;
  if (!ENTROPY) return;

  // -sum p log2 p over the bins in ascending hash order, as the plain
  // version forms it
  double total = 0.0;
#pragma unroll
  for (int b = 0; b < NBIN; ++b) total += acc[b];
  const double denom = total == 0.0 ? 1.0 : total;
  double h = 0.0;
#pragma unroll
  for (int b = 0; b < NBIN; ++b) {
    const double p = acc[b] / denom;
    h += p > 0.0 ? p * log2(p) : 0.0;
  }
  out[rows + row] = -h / norm;
}

}  // namespace

extern "C" {

// x: (rows, n) f64, contiguous; out: (2, rows) f64 with ENTROPY, else
// (1, rows).  norm: log2(3!) as the host computes it.
int pyitd_walk_stats(const double* x, int rows, int n, int entropy,
                     double norm, double* out, void* stream) {
  if (entropy)
    walk_stats_kernel<true><<<rows, THREADS, 0, (cudaStream_t)stream>>>(
        x, rows, n, norm, out);
  else
    walk_stats_kernel<false><<<rows, THREADS, 0, (cudaStream_t)stream>>>(
        x, rows, n, norm, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
