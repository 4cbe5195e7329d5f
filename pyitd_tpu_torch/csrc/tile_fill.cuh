// Tile-local knot tests, fills and summaries shared by csrc/sift_level.cu
// and csrc/cubic.cu.  One block of NT threads owns one (row, tile of TILE
// samples).  Knot positions are int32, -1 for none with value 0.
//
// Two layouts live here.
//
// The chunk layout (the sift's kernels).  What bounds a tile-sized kernel on
// this card is not arithmetic but how many bytes it keeps in flight: whole
// 32-byte sectors, 16 bytes a thread, few barriers, few registers, so that
// several blocks are resident on an SM.  A warp owns WSPAN = 256 consecutive
// samples as two sets of 32 chunks of 4; lane l holds chunk l of each set,
// so every 128-bit access of a warp covers 512 consecutive bytes
// (load_chunk_values: into registers, no staging).  The knot test of a
// chunk needs one sample on either side: the neighbour lane's by shuffle,
// the other set's at the set seam, and one scalar load per warp edge.
// chunk_knots computes the four knot bits of a chunk from five shared
// differences (the booleans of knot_at, which K6 still calls).
// A chunk that is ragged (the row's end) or whose row does not start on a
// 16-byte boundary takes scalar accesses in the same kernel.
//   tile_summary: a tile's last two and first two knots and its knot count
//   are a reduction, not a scan: the two largest and two smallest knot
//   positions.  Each thread takes them from its 8 knot bits (clz / ffs), a
//   warp with five redux instructions, the values follow by one shuffle
//   each, the 16 warp results meet in shared memory behind ONE barrier and
//   warp 0 reduces them the same way.
//   Bitmap: the tile's 4096 knot bits as 128 words in shared memory plus a
//   128-bit map of the nonzero words in registers.  The last knot at or
//   before a sample and the first after it are then two or three bit
//   operations and at most two shared-memory reads (find_prev, find_next),
//   for every thread on its own: no scan over the block's threads, no
//   thread that waits for another's state.
//
// The run layout (K6 in cubic.cu): the tile plus a one-sample halo is
// staged in padded shared memory, each thread owns a contiguous run of SPT
// samples, and a warp-shuffle scan plus a cross-warp scan through shared
// memory turn the runs' own states into the exclusive state before
// (forward) or after (reverse) each run (block_excl_fwd, block_excl_rev).
//
// A row may be one time shard of a longer signal (struct Shard): the knot
// test then runs on the global position offset + t against the global
// length, the two cells beside the shard hold its neighbours' edge samples,
// and every knot position is global.  Shared-memory indices stay local.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knot.cuh"

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


// ---------------------------------------------------------------------------
// the chunk layout
// ---------------------------------------------------------------------------

constexpr int CH = SPT / 4;           // chunks of 4 samples per thread
constexpr int WSPAN = 32 * SPT;       // consecutive samples per warp
constexpr int CSET = WSPAN / CH;      // samples per chunk set of a warp
constexpr int NONE_AFTER = 0x7fffffff;  // "no knot" among first-knot minima
static_assert(CH == 2 && CSET == 128, "two chunk sets of 32 chunks per warp");

// local index (within the tile) of the first sample of this thread's chunk c
__device__ __forceinline__ int chunk_start(int c) {
  return (int)(threadIdx.x >> 5) * WSPAN + c * CSET + 4 * (int)(threadIdx.x & 31);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// x[t] of a row of n samples for the knot test: lo at -1, hi at n, zeros
// further off the row (what stage_tile stages)
__device__ __forceinline__ float row_value(const float* __restrict__ xr, int n,
                                           int t, float lo, float hi) {
  return (t >= 0 && t < n) ? xr[t] : (t == -1 ? lo : (t == n ? hi : 0.f));
}

// This thread's chunks of one tile: values, and one knot bit per sample
// (bit q of bits[c]: sample q of chunk c).
struct Chunks {
  float v[CH][4];
  unsigned bits[CH];
};

// The knot bits of four consecutive samples e[1..4] with their neighbours
// e[0] and e[5]; the first is sample t of its row of n, position g of a
// signal of ng.  The booleans of knot_at: with d = NaN standing for +inf,
// (d <= 0) is false and !(d < 0) true as they are for +inf, so no
// difference is tested for NaN; the samples are.
__device__ __forceinline__ unsigned chunk_knots(const float (&e)[6], int t,
                                                int n, int g, int ng) {
  bool le[5], lt[5], nn[6];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const float d = e[i + 1] - e[i];
    le[i] = d <= 0.f;
    lt[i] = d < 0.f;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) nn[i] = e[i] != e[i];
  unsigned bits = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool is_min = le[q] && !le[q + 1];
    const bool is_max = !lt[q] && lt[q + 1];
    const bool near_nan = nn[q] || nn[q + 1] || nn[q + 2];
    if ((is_min || is_max) && !near_nan) bits |= 1u << q;
  }
  // the signal's end points are knots, padding never is
  if (g == 0 || t + 4 > n || g + 4 >= ng) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (t + q >= n || g + q >= ng) bits &= ~(1u << q);
      else if (g + q == 0 || g + q == ng - 1) bits |= 1u << q;
    }
  }
  return bits;
}

// Load this thread's chunks of the tile at `base` of a row (xr, n) with
// 128-bit loads where the chunk is whole and aligned; the row lies between
// the samples lo and hi.  Returns this lane's sample just outside the warp's
// span (lanes 0 and 31).  STREAM: the row is read once.
template <bool STREAM>
__device__ __forceinline__ float load_chunk_values(
    const float* __restrict__ xr, int n, int base, float lo, float hi,
    Chunks& ch) {
  const int lane = threadIdx.x & 31;
  const int w0 = base + (int)(threadIdx.x >> 5) * WSPAN;
  float edge = 0.f;
  if (lane == 0) edge = row_value(xr, n, w0 - 1, lo, hi);
  if (lane == 31) edge = row_value(xr, n, w0 + WSPAN, lo, hi);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int p = w0 + c * CSET + 4 * lane;
    if (p + 4 <= n && aligned16(xr + p)) {
      const float4* src = reinterpret_cast<const float4*>(xr + p);
      const float4 t = STREAM ? __ldcs(src) : __ldg(src);
      ch.v[c][0] = t.x; ch.v[c][1] = t.y; ch.v[c][2] = t.z; ch.v[c][3] = t.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) ch.v[c][q] = row_value(xr, n, p + q, lo, hi);
    }
  }
  return edge;
}

// The knot bits of the loaded chunks: a chunk's neighbours are the next
// lane's samples, the other set's at the seam, `edge` outside the warp's
// span.  The row starts at position off of a signal of ng samples.
__device__ __forceinline__ void chunk_bits(int n, int base, int off, int ng,
                                           float edge, Chunks& ch) {
  const int lane = threadIdx.x & 31;
  const int w0 = base + (int)(threadIdx.x >> 5) * WSPAN;
  const float seam_l = __shfl_sync(FULL, ch.v[0][3], 31);  // before set 1
  const float seam_r = __shfl_sync(FULL, ch.v[1][0], 0);   // after set 0
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    float left = __shfl_up_sync(FULL, ch.v[c][3], 1);
    float right = __shfl_down_sync(FULL, ch.v[c][0], 1);
    if (lane == 0) left = c == 0 ? edge : seam_l;
    if (lane == 31) right = c == 0 ? seam_r : edge;
    const float e[6] = {left, ch.v[c][0], ch.v[c][1], ch.v[c][2], ch.v[c][3],
                        right};
    const int p = w0 + c * CSET + 4 * lane;
    ch.bits[c] = chunk_knots(e, p, n, off + p, ng);
  }
}

// 16 bytes from device memory into shared memory without passing through
// registers (both 16-byte aligned); cp_async_wait makes this thread's
// copies visible to it
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;" ::
                   : "memory");
}

// element i = 4 c + q of a thread's chunks, i not known at compile time
__device__ __forceinline__ float pick(const float (&v)[CH][4], int i) {
  float r = v[0][0];
#pragma unroll
  for (int k = 1; k < 4 * CH; ++k) r = (i == k) ? v[k >> 2][k & 3] : r;
  return r;
}

// A warp's or a tile's end knots: the two latest (p1 > p2, -1 = none), the
// two earliest (q1 < q2, NONE_AFTER = none), their values (0 for none) and
// the knot count.
struct Ends {
  int p1, p2, q1, q2, cnt;
  float v1, v2, w1, w2;
};

// Summary of the tile whose first sample has position gtile: the end knots
// over the knot bits `bits` of the threads' chunks, with the values in v,
// written to the tile's five summary slots (positions as in TileSummaries:
// -1 = none).  Every thread of the block calls it; one barrier.
__device__ __forceinline__ void tile_summary(
    const float (&v)[CH][4], const unsigned (&bits)[CH], int gtile, Ends* s_we,
    int* __restrict__ fpos, float* __restrict__ fval, int* __restrict__ rpos,
    float* __restrict__ rval, int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int gw0 = gtile + w * WSPAN;
  const unsigned m = bits[0] | (bits[1] << 4);  // bit i: element i, in order
  int p1 = -1, p2 = -1, q1 = NONE_AFTER, q2 = NONE_AFTER;
  if (m != 0u) {
    const int lp = gw0 + 4 * lane;
    int i = 31 - __clz(m);
    p1 = lp + (i >> 2) * CSET + (i & 3);
    unsigned r = m & ~(1u << i);
    if (r != 0u) {
      i = 31 - __clz(r);
      p2 = lp + (i >> 2) * CSET + (i & 3);
    }
    i = __ffs(m) - 1;
    q1 = lp + (i >> 2) * CSET + (i & 3);
    r = m & (m - 1u);
    if (r != 0u) {
      i = __ffs(r) - 1;
      q2 = lp + (i >> 2) * CSET + (i & 3);
    }
  }
  // the warp's: the largest, then the largest of what is left
  Ends e;
  e.p1 = __reduce_max_sync(FULL, p1);
  e.p2 = __reduce_max_sync(FULL, p1 == e.p1 ? p2 : p1);
  e.q1 = __reduce_min_sync(FULL, q1);
  e.q2 = __reduce_min_sync(FULL, q1 == e.q1 ? q2 : q1);
  e.cnt = __reduce_add_sync(FULL, __popc(m));
  // the value at a position of this warp's span, from the lane that holds it
  auto value = [&](int pos, bool has) {
    const int j = (pos - gw0) & (WSPAN - 1);
    const float s = __shfl_sync(FULL, pick(v, ((j >> 7) << 2) | (j & 3)),
                                (j & (CSET - 1)) >> 2);
    return has ? s : 0.f;
  };
  e.v1 = value(e.p1, e.p1 >= 0);
  e.v2 = value(e.p2, e.p2 >= 0);
  e.w1 = value(e.q1, e.q1 != NONE_AFTER);
  e.w2 = value(e.q2, e.q2 != NONE_AFTER);
  if (lane == 0) s_we[w] = e;
  __syncthreads();
  if (w != 0) return;
  // warp 0: the same reduction over the warps' results
  if (lane < NWARP) e = s_we[lane];
  else e = Ends{-1, -1, NONE_AFTER, NONE_AFTER, 0, 0.f, 0.f, 0.f, 0.f};
  Ends t;
  t.p1 = __reduce_max_sync(FULL, e.p1);
  t.p2 = __reduce_max_sync(FULL, e.p1 == t.p1 ? e.p2 : e.p1);
  t.q1 = __reduce_min_sync(FULL, e.q1);
  t.q2 = __reduce_min_sync(FULL, e.q1 == t.q1 ? e.q2 : e.q1);
  t.cnt = __reduce_add_sync(FULL, e.cnt);
  // the value of a knot from the lane whose warp holds it as one of its ends
  auto fetch = [&](int pos, bool has, int a1, float x1, int a2, float x2) {
    const unsigned owners = __ballot_sync(FULL, a1 == pos || a2 == pos);
    const float s = __shfl_sync(FULL, a1 == pos ? x1 : x2,
                                (__ffs(owners) - 1) & 31);
    return has ? s : 0.f;
  };
  t.v1 = fetch(t.p1, t.p1 >= 0, e.p1, e.v1, e.p2, e.v2);
  t.v2 = fetch(t.p2, t.p2 >= 0, e.p1, e.v1, e.p2, e.v2);
  t.w1 = fetch(t.q1, t.q1 != NONE_AFTER, e.q1, e.w1, e.q2, e.w2);
  t.w2 = fetch(t.q2, t.q2 != NONE_AFTER, e.q1, e.w1, e.q2, e.w2);
  if (lane == 0) {
    fpos[0] = t.p1; fval[0] = t.v1; fpos[1] = t.p2; fval[1] = t.v2;
    rpos[0] = t.q1 == NONE_AFTER ? -1 : t.q1; rval[0] = t.w1;
    rpos[1] = t.q2 == NONE_AFTER ? -1 : t.q2; rval[1] = t.w2;
    cnt[0] = t.cnt;
  }
}

// The tile's knot bits in shared memory (bit j & 31 of word j >> 5 is
// local sample j) with the map of its nonzero words.
struct Bitmap {
  const unsigned* w;            // TILE / 32 words
  unsigned long long lo, hi;    // bit k of (hi:lo): word k is not zero
};
static_assert(TILE / 32 == 128, "the map of nonzero words has 128 bits");

// Write this thread's knot bits into the bitmap words (a word is the bits
// of 8 neighbouring lanes); a barrier must follow before read_bitmap.
__device__ __forceinline__ void write_bitmap(const unsigned (&bits)[CH],
                                             unsigned* s_bits) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    unsigned word = bits[c] << (4 * (lane & 7));
    word |= __shfl_xor_sync(FULL, word, 1);
    word |= __shfl_xor_sync(FULL, word, 2);
    word |= __shfl_xor_sync(FULL, word, 4);
    if ((lane & 7) == 0) s_bits[chunk_start(c) >> 5] = word;
  }
}

__device__ __forceinline__ Bitmap read_bitmap(const unsigned* s_bits) {
  const int lane = threadIdx.x & 31;
  const unsigned long long b0 = __ballot_sync(FULL, s_bits[lane] != 0u);
  const unsigned long long b1 = __ballot_sync(FULL, s_bits[32 + lane] != 0u);
  const unsigned long long b2 = __ballot_sync(FULL, s_bits[64 + lane] != 0u);
  const unsigned long long b3 = __ballot_sync(FULL, s_bits[96 + lane] != 0u);
  return {s_bits, b0 | (b1 << 32), b2 | (b3 << 32)};
}

// local index of the last knot at or before local sample j (j >= -1); -1
// if the tile has none there
__device__ __forceinline__ int find_prev(const Bitmap& b, int j) {
  if (j < 0) return -1;
  const int k = j >> 5;
  const unsigned m = b.w[k] & (0xffffffffu >> (31 - (j & 31)));
  if (m != 0u) return (k << 5) + 31 - __clz(m);
  unsigned long long t;
  int kb = 0;
  if (k >= 64) {
    t = b.hi & ((1ull << (k - 64)) - 1ull);
    kb = 64;
    if (t == 0ull) {
      t = b.lo;
      kb = 0;
    }
  } else {
    t = b.lo & ((1ull << k) - 1ull);
  }
  if (t == 0ull) return -1;
  const int kk = kb + 63 - __clzll((long long)t);
  return (kk << 5) + 31 - __clz(b.w[kk]);
}

// local index of the first knot at or after local sample j (j <= TILE);
// -1 if the tile has none there
__device__ __forceinline__ int find_next(const Bitmap& b, int j) {
  if (j >= TILE) return -1;
  const int k = j >> 5;
  const unsigned m = b.w[k] & (0xffffffffu << (j & 31));
  if (m != 0u) return (k << 5) + __ffs(m) - 1;
  unsigned long long t;
  int kb = 0;
  if (k < 64) {
    t = b.lo & ~((2ull << k) - 1ull);  // the words after word k
    if (t == 0ull) {
      t = b.hi;
      kb = 64;
    }
  } else {
    t = b.hi & ~((2ull << (k - 64)) - 1ull);
    kb = 64;
  }
  if (t == 0ull) return -1;
  const int kk = kb + __ffsll((long long)t) - 1;
  return (kk << 5) + __ffs(b.w[kk]) - 1;
}

}  // namespace
