// Tile-local knot fills shared by csrc/sift_level.cu and csrc/cubic.cu.
//
// One block of NT threads owns one (row, tile of TILE samples).  The tile
// plus a one-sample halo is staged in shared memory; each thread owns a
// contiguous run of SPT samples, whose knot bits and own last-two /
// first-two knots it computes serially; a warp-shuffle scan and a
// cross-warp scan through shared memory turn those into the exclusive
// state before (forward) or after (reverse) each run, seeded with the
// state of everything before / after the tile.  Knot positions are int32
// indices within the row, -1 for none with value 0.
//
// A row may be one time shard of a longer signal (struct Shard): the knot
// test then runs on the global position offset + t against the global
// length, the two cells beside the shard hold its neighbours' edge samples,
// and every knot position is global.  Shared-memory indices stay local.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4096;            // samples per block
constexpr int NT = 512;               // threads per block
constexpr int SPT = TILE / NT;        // contiguous samples per thread
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory index with one pad word every 32: a thread's run of SPT
// samples starts SPT words after its neighbour's, which would otherwise put
// a warp's accesses on a few banks
__device__ __forceinline__ int padi(int i) { return i + (i >> 5); }
constexpr int SX_LEN = (TILE + 2) + (TILE + 2) / 32 + 1;
constexpr int SB_LEN = TILE + TILE / 32 + 1;

// last two knots at or before a point (p1 the latest); -1 = none, value 0
struct Fwd { int p1; float v1; int p2; float v2; };
// first two knots at or after a point (q1 the earliest); -1 = none, value 0
struct Rev { int q1; float w1; int q2; float w2; };

// Per-row arguments of a time shard (the port of the shard arguments of
// pallas_fill_sharded.py::sharded_sift_level_fused): where the row starts in
// the global signal, the neighbour shards' edge samples, the global end-knot
// values, and the last two knots before / first two after the shard.
struct Shard {
  int n_global;
  const int* offset;     // (rows)
  const float* halo_l;   // (rows) sample before the shard's first
  const float* halo_r;   // (rows) sample after the shard's last
  const float* b_first;  // (rows) global end-knot values (sift_level only)
  const float* b_last;
  const int* pre_pos;    // (rows, 2) last two knots before the shard
  const float* pre_val;
  const int* suf_pos;    // (rows, 2) first two knots after the shard
  const float* suf_val;
};

__device__ __forceinline__ Fwd fwd_none() { return {-1, 0.f, -1, 0.f}; }
__device__ __forceinline__ Rev rev_none() { return {-1, 0.f, -1, 0.f}; }

// a covers samples before b's (pallas_fill.py::_combine)
__device__ __forceinline__ Fwd fwd_combine(const Fwd& a, const Fwd& b) {
  const bool h1 = b.p1 >= 0, h2 = b.p2 >= 0;
  Fwd r;
  r.p1 = h1 ? b.p1 : a.p1;
  r.v1 = h1 ? b.v1 : a.v1;
  const int tp = h1 ? a.p1 : a.p2;
  const float tv = h1 ? a.v1 : a.v2;
  r.p2 = h2 ? b.p2 : tp;
  r.v2 = h2 ? b.v2 : tv;
  return r;
}

// a covers samples before b's; keep the first two knots
__device__ __forceinline__ Rev rev_combine(const Rev& a, const Rev& b) {
  const bool h1 = a.q1 >= 0, h2 = a.q2 >= 0;
  Rev r;
  r.q1 = h1 ? a.q1 : b.q1;
  r.w1 = h1 ? a.w1 : b.w1;
  const int tq = h1 ? b.q1 : b.q2;
  const float tw = h1 ? b.w1 : b.w2;
  r.q2 = h2 ? a.q2 : tq;
  r.w2 = h2 ? a.w2 : tw;
  return r;
}

__device__ __forceinline__ Fwd shfl_up(const Fwd& s, int o) {
  return {__shfl_up_sync(FULL, s.p1, o), __shfl_up_sync(FULL, s.v1, o),
          __shfl_up_sync(FULL, s.p2, o), __shfl_up_sync(FULL, s.v2, o)};
}

__device__ __forceinline__ Rev shfl_down(const Rev& s, int o) {
  return {__shfl_down_sync(FULL, s.q1, o), __shfl_down_sync(FULL, s.w1, o),
          __shfl_down_sync(FULL, s.q2, o), __shfl_down_sync(FULL, s.w2, o)};
}

// ITD knot mask at sample t (pallas_fill.py::_knot_mask_flat): canonical
// extrema with the plateau-rightmost rule, NaN differences as +inf, no
// extremum within one sample of a NaN, both endpoints always, padding never.
// t is the sample's index in its row of n samples, g its position in the
// signal of ng samples (pallas_fill_sharded.py::_knot_state_sharded): a
// sample past either end is padding.
__device__ __forceinline__ bool knot_at(float xm1, float x0, float xp1, int t,
                                        int n, int g, int ng) {
  if (t >= n || g >= ng) return false;
  if (g == 0 || g == ng - 1) return true;
  float dxb = x0 - xm1;
  float dxf = xp1 - x0;
  if (isnan(dxb)) dxb = INFINITY;
  if (isnan(dxf)) dxf = INFINITY;
  const bool near_nan = isnan(x0) || isnan(xm1) || isnan(xp1);
  const bool is_min = (dxb <= 0.f) && (dxf > 0.f);
  const bool is_max = (dxb >= 0.f) && (dxf < 0.f);
  return (is_min || is_max) && !near_nan;
}

__device__ __forceinline__ bool knot_at(float xm1, float x0, float xp1, int t,
                                        int n) {
  return knot_at(xm1, x0, xp1, t, n, t, n);
}

// Frei-Osorio knot value (linear_baseline.py::knot_value), alpha = 0.5
__device__ __forceinline__ float knot_value(int kpos, float kval, int lpos,
                                            float lval, int rpos, float rval) {
  const float span = (float)(rpos - lpos);
  const float w = (float)(kpos - lpos) / (span == 0.f ? 1.f : span);
  return 0.5f * (lval + w * (rval - lval)) + 0.5f * kval;
}

// x[base-1 .. base+TILE] of one row into shared memory; lo for x[-1], hi
// for x[n], zeros further off the row
__device__ __forceinline__ void stage_tile(const float* __restrict__ xr, int n,
                                           int base, float* s, float lo,
                                           float hi) {
  for (int k = threadIdx.x; k < TILE + 2; k += NT) {
    const int g = base - 1 + k;
    s[padi(k)] = (g >= 0 && g < n) ? xr[g]
                                   : (g == -1 ? lo : (g == n ? hi : 0.f));
  }
}

__device__ __forceinline__ void stage_tile(const float* __restrict__ xr, int n,
                                           int base, float* s) {
  stage_tile(xr, n, base, s, 0.f, 0.f);
}

// This thread's run of SPT samples: knot bits, values, and the run's own
// last-two / first-two knots.
struct Run {
  unsigned bits;
  float xv[SPT];
  Fwd f;
  Rev r;
};

// the run's knot bits and signal values from the staged tile; the row
// starts at position off of a signal of ng samples
__device__ __forceinline__ void load_bits(const float* s, int n, int base,
                                          Run& run, int off, int ng) {
  const int j0 = threadIdx.x * SPT;
  run.bits = 0u;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = j0 + k;
    const float a = s[padi(j)], b = s[padi(j + 1)], c = s[padi(j + 2)];
    run.xv[k] = b;
    if (knot_at(a, b, c, base + j, n, off + base + j, ng)) run.bits |= 1u << k;
  }
}

__device__ __forceinline__ void load_bits(const float* s, int n, int base,
                                          Run& run) {
  load_bits(s, n, base, run, 0, n);
}

// the run's own last-two and first-two knots, with the values in run.xv;
// base is the position of the tile's first sample
__device__ __forceinline__ void run_states(int base, Run& run) {
  const int j0 = threadIdx.x * SPT;
  run.f = fwd_none();
#pragma unroll
  for (int k = 0; k < SPT; ++k)
    if ((run.bits >> k) & 1u) run.f = {base + j0 + k, run.xv[k], run.f.p1, run.f.v1};
  run.r = rev_none();
#pragma unroll
  for (int k = SPT - 1; k >= 0; --k)
    if ((run.bits >> k) & 1u) run.r = {base + j0 + k, run.xv[k], run.r.q1, run.r.w1};
}

__device__ __forceinline__ void load_run(const float* s, int n, int base,
                                         Run& run, int off, int ng) {
  load_bits(s, n, base, run, off, ng);
  run_states(off + base, run);
}

__device__ __forceinline__ void load_run(const float* s, int n, int base,
                                         Run& run) {
  load_run(s, n, base, run, 0, n);
}

// Exclusive forward scan of the threads' states in thread order, seeded by
// `seed` (the state of everything before the block).
__device__ Fwd block_excl_fwd(Fwd v, Fwd seed, Fwd* sw) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Fwd inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Fwd u = shfl_up(inc, o);
    if (lane >= o) inc = fwd_combine(u, inc);
  }
  Fwd ex = shfl_up(inc, 1);
  if (lane == 0) ex = fwd_none();
  if (lane == 31) sw[w] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Fwd acc = seed;
    for (int i = 0; i < NWARP; ++i) {
      const Fwd t = sw[i];
      sw[i] = acc;
      acc = fwd_combine(acc, t);
    }
  }
  __syncthreads();
  const Fwd r = fwd_combine(sw[w], ex);
  __syncthreads();
  return r;
}

// Exclusive reverse scan (state of the samples after each thread's run),
// seeded by `seed` (the state of everything after the block).
__device__ Rev block_excl_rev(Rev v, Rev seed, Rev* sw) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  Rev inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Rev u = shfl_down(inc, o);
    if (lane + o < 32) inc = rev_combine(inc, u);
  }
  Rev ex = shfl_down(inc, 1);
  if (lane == 31) ex = rev_none();
  if (lane == 0) sw[w] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    Rev acc = seed;
    for (int i = NWARP - 1; i >= 0; --i) {
      const Rev t = sw[i];
      sw[i] = acc;
      acc = rev_combine(t, acc);
    }
  }
  __syncthreads();
  const Rev r = rev_combine(ex, sw[w]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

}  // namespace
