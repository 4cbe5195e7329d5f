// Masked fills and segmented running sums on Hopper (sm_90a), plain C
// interface: the scan primitives of the structural sift backward.
//
// Replaces: pyitd_tpu/ops/pallas_fill.py::fill2_padded (K3, via
// fill2_pallas; kernel body _make_fill2_kernel), fillv_pallas
// (_make_fillv_kernel), here K3's depth-1 mode, segsum_pallas (K4,
// _make_segsum_kernel), and linear_fill2_pallas (K2a, _linear_fill2_padded;
// kernel body _make_linear_fill2_kernel), here K3 with the ITD knot mask
// computed in the kernel.
//
// What they compute, per row, over a scan order that runs forward (t = 0,
// 1, ...) or in reverse (t = n-1, n-2, ...):
//   fill2   (pos, value) of the last two marked samples at or before t in
//           scan order (with `strict`, strictly before); 0 where none.
//           Positions are int32 sample indices derived in the kernel.
//   linear_fill2  fill2 of the signal itself under its ITD knot mask
//           (knot.cuh::knot_at: canonical extrema, both endpoints, the NaN
//           quarantine), inclusive: the standalone first fill round of the
//           cubic tier's unfused and compact routes.
//   fillv   the value of the last marked sample at or before t; 0 if none.
//   segsum  out[t] = v[t] + (flag[t] ? 0 : out[t-1]), one or two channels
//           sharing the flag (t-1 meaning the previous sample in scan
//           order); with `strict`, out[t-1] of that recurrence (0 at the
//           first sample in scan order).
//
// What bounds them: bytes.  A scan does no arithmetic to speak of (selects;
// one f32 add per sample and channel for segsum), so the least time is the
// inputs read once and the outputs written once: at 8 x 1M, fill2 moves
// 21 B/sample (value, mask, four outputs), linear_fill2 20 (the signal,
// four outputs), fillv 9, segsum 9 or 17.
//
// What the design does about it: one launch per call that moves exactly
// those bytes, a single-pass scan with decoupled look-back over the tiles
// of a row.  The TPU walks each row's blocks in scan order and carries the
// scan state in SMEM; a GPU runs its blocks in no order, so a block
//   1. takes a ticket from an atomic counter; tickets number the (row,
//      tile) pairs row by row and, within a row, in scan order, so every
//      tile a block will wait for was started before it;
//   2. loads its tile of TILE samples once with 128-bit loads, no staging
//      in shared memory: a warp owns WSPAN consecutive samples as CH sets
//      of 32 chunks of 4 samples, and lane l holds chunk l of every set, so
//      each load and each store of a warp covers 512 consecutive bytes
//      (flags: 4 bytes per chunk, shifted into place where the row's flags
//      are not 4-byte aligned); reversed in registers for a reverse scan;
//   3. folds the tile to its aggregate (a serial fold per chunk, one
//      warp-shuffle scan per chunk set, the sets in order, a shuffle scan
//      of the warp aggregates) and publishes it in the tile's descriptor in
//      global scratch: the state, then a release store of the call's mark;
//   4. looks back (warp 0): windows of 32 earlier descriptors, nearest
//      window first, each lane acquiring one descriptor, the window folded
//      by a fixed shuffle tree, until the fold is saturated (a reset seen
//      for segsum, two marks for fill2, one for fillv) or the row starts;
//   5. scans the tile it still holds in registers from that prefix and
//      writes each output channel with 128-bit stores.
// Every input is read once and every output written once, so loads and
// stores carry the streaming hint (ld.cs / st.cs).
// linear_fill2 reads no flags: each chunk's knot bits come from its own
// four samples and their two neighbours, the neighbouring lanes' chunks by
// shuffle and, at the warp's two ends in memory order, one scalar load.
// Only aggregates are published and folded, never a running prefix, so a
// tile waits for loads of earlier tiles and never for their look-backs, and
// the association of every sum is fixed by the data alone: the same inputs
// give the same bits on every run.
//
// Alignment.  A row starts at any float: the tiling is shifted by the
// row's distance `pad` (0..3 floats) from a 16-byte boundary, so that every
// chunk inside the row is aligned; the chunks that straddle the row's head
// or tail, and any array whose address is not congruent to the first input's
// modulo 16, take scalar accesses in the same kernel.  Shifted rows need up
// to 3 samples more: (n + 3) / TILE tiles, rounded up.
//
// Scratch (kept by the wrapper per device and stream, zeroed once): a
// header {ticket, done, epoch} and one 32-byte descriptor per (row, tile),
// the same layout for every monoid.  A descriptor is published when its
// status equals epoch + 1; the last block to finish sets ticket and done
// back to 0 and adds one to the epoch, which unpublishes every descriptor
// for the next call without touching them.  A wait that outlasts
// SPIN_LIMIT polls (seconds; a sound wait is a predecessor's load and
// fold, microseconds) traps, so a protocol fault is a CUDA error, not a
// hang.
//
// A fill only selects, so fill2 and fillv are bit-equal to their plain
// versions whatever the association.  segsum's f32 adds associate in the
// order above, not in the plain version's: a term passes through at most
//   d = 19 + CH + log2(NWARP) + ceil((tiles - 1) / 32)
// additions on its way to an output (4 in its chunk's fold, 5 in the warp
// scan of its chunk set, CH - 1 across the sets, log2(NWARP) across the
// warps, 5 in a window's tree, one per window walked, two seeding a chunk,
// 4 in the chunk's walk), which bounds its error
// (ops/cuda_fill.py::segsum_error_bound).  On integer-valued inputs whose
// partial sums stay below 2^24 every order is exact.
// Built with -fmad=false and no fast-math, like sift_level.cu.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "knot.cuh"

namespace {

constexpr int TILE = 4096;            // scan indices per block
// 512 threads of 8 samples, registers capped for 3 blocks per SM (fill2,
// segsum with 2 channels: 40 registers) or 4 (fillv, segsum with 1: 32).
// ptxas reports 4 to 68 bytes of spills per thread at these caps and none
// without them (35 to 55 registers, 2 or 3 blocks); on the H100 the capped
// kernels are the faster, and 256 x 16 and 1024 x 4 slower than 512 x 8
// (tools/scan_bench.py times any of them).
#ifndef PYITD_SCAN_THREADS
#define PYITD_SCAN_THREADS 512
#endif
constexpr int NT = PYITD_SCAN_THREADS;  // threads per block
constexpr int SPT = TILE / NT;        // samples per thread
constexpr int CH = SPT / 4;           // as chunks of 4 consecutive samples
constexpr int NWARP = NT / 32;
constexpr int WSPAN = 32 * SPT;       // consecutive samples per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr int WINDOW = 32;            // descriptors per look-back step
constexpr unsigned SPIN_LIMIT = 1u << 22;
static_assert(NT * SPT == TILE && SPT % 4 == 0, "chunks of 4 samples");
static_assert(NWARP <= 32 && (NWARP & (NWARP - 1)) == 0, "one warp scans the "
              "warp aggregates");

// ---- the scans' monoids: comb(a, b) with a first in scan order; full(s):
// nothing earlier in scan order can change comb(., s); WARPS: the warps per
// SM the compiler leaves registers for -----------------------------------

// K3: the last two marks in scan order, nearest first; position -1 = none
// (value 0) (pallas_fill.py::_combine)
struct Fill2 {
  struct S { int p1; float v1; int p2; float v2; };
  static constexpr int NV = 1, NO = 4, WARPS = 48;
  __device__ static S id() { return {-1, 0.f, -1, 0.f}; }
  __device__ static S comb(const S& a, const S& b) {
    const bool h1 = b.p1 >= 0, h2 = b.p2 >= 0;
    S r;
    r.p1 = h1 ? b.p1 : a.p1;
    r.v1 = h1 ? b.v1 : a.v1;
    r.p2 = h2 ? b.p2 : (h1 ? a.p1 : a.p2);
    r.v2 = h2 ? b.v2 : (h1 ? a.v1 : a.v2);
    return r;
  }
  __device__ static bool full(const S& s) { return s.p2 >= 0; }
  __device__ static S elem(bool m, const float* v, int pos) {
    return m ? S{pos, v[0], -1, 0.f} : id();
  }
  __device__ static void emit(const S& s, unsigned* o) {
    const bool h1 = s.p1 >= 0, h2 = s.p2 >= 0;
    o[0] = h1 ? (unsigned)s.p1 : 0u;
    o[1] = h1 ? __float_as_uint(s.v1) : 0u;
    o[2] = h2 ? (unsigned)s.p2 : 0u;
    o[3] = h2 ? __float_as_uint(s.v2) : 0u;
  }
};

// fillv: K3 at depth 1, value only (pallas_fill.py::_combine1)
struct Fill1 {
  struct S { int p; float v; };
  static constexpr int NV = 1, NO = 1, WARPS = 64;
  __device__ static S id() { return {-1, 0.f}; }
  __device__ static S comb(const S& a, const S& b) { return b.p >= 0 ? b : a; }
  __device__ static bool full(const S& s) { return s.p >= 0; }
  __device__ static S elem(bool m, const float* v, int pos) {
    return m ? S{pos, v[0]} : id();
  }
  __device__ static void emit(const S& s, unsigned* o) {
    o[0] = s.p >= 0 ? __float_as_uint(s.v) : 0u;
  }
};

// K4: (reset seen, sum after the last reset) per channel
// (pallas_fill.py::_seg_combine)
template <int C>
struct Seg {
  struct S { int r; float s[C]; };
  static constexpr int NV = C, NO = C, WARPS = C == 1 ? 64 : 48;
  __device__ static S id() {
    S z;
    z.r = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) z.s[c] = 0.f;
    return z;
  }
  __device__ static S comb(const S& a, const S& b) {
    S r;
    r.r = a.r | b.r;
#pragma unroll
    for (int c = 0; c < C; ++c) r.s[c] = b.r ? b.s[c] : a.s[c] + b.s[c];
    return r;
  }
  __device__ static bool full(const S& s) { return s.r != 0; }
  __device__ static S elem(bool f, const float* v, int) {
    S e;
    e.r = f ? 1 : 0;
#pragma unroll
    for (int c = 0; c < C; ++c) e.s[c] = v[c];
    return e;
  }
  __device__ static void emit(const S& s, unsigned* o) {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = __float_as_uint(s.s[c]);
  }
};

// a scan state through a warp shuffle, word by word: MODE 0 from lane - o,
// 1 from lane + o, 2 from lane o
template <int MODE, class S>
__device__ __forceinline__ S shfl_s(const S& s, int o) {
  static_assert(sizeof(S) % 4 == 0, "scan states are 32-bit words");
  constexpr int W = sizeof(S) / 4;
  unsigned w[W];
  memcpy(w, &s, sizeof(S));
#pragma unroll
  for (int i = 0; i < W; ++i)
    w[i] = MODE == 0 ? __shfl_up_sync(FULL, w[i], o)
         : MODE == 1 ? __shfl_down_sync(FULL, w[i], o)
                     : __shfl_sync(FULL, w[i], o);
  S r;
  memcpy(&r, w, sizeof(S));
  return r;
}

// Inclusive scan over the first `width` lanes of a warp (Kogge-Stone).
template <class Op>
__device__ __forceinline__ typename Op::S warp_inclusive(typename Op::S v,
                                                         int lane, int width) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    if (o >= width) break;
    const typename Op::S u = shfl_s<0>(v, o);
    if (lane >= o) v = Op::comb(u, v);
  }
  return v;
}

// ---- the scratch: header and per-tile descriptors ------------------------

struct Header {
  unsigned ticket;             // the next (row, tile) to hand out
  unsigned done;               // blocks that have finished
  unsigned long long epoch;    // calls completed on this scratch
};
constexpr int HEADER_BYTES = 64;

struct alignas(32) Desc {
  unsigned w[4];               // the tile's aggregate state
  unsigned long long status;   // published when equal to the call's mark
  unsigned long long unused;
};
static_assert(sizeof(Header) <= HEADER_BYTES && sizeof(Desc) == 32, "layout");

__device__ __forceinline__ void st_release(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// The state first, then the mark with release order: a reader that
// acquires the mark sees the state.
template <class S>
__device__ __forceinline__ void publish(Desc* d, const S& s,
                                        unsigned long long mark) {
  static_assert(sizeof(S) <= 16, "a state fits a descriptor");
  unsigned w[4] = {0u, 0u, 0u, 0u};
  memcpy(w, &s, sizeof(S));
  *reinterpret_cast<uint4*>(d->w) = make_uint4(w[0], w[1], w[2], w[3]);
  st_release(&d->status, mark);
}

// Wait until the descriptor carries this call's mark, then read its state.
// The tile was started before this block (ticket order), so the wait ends;
// if it does not, the protocol is broken: trap.
template <class S>
__device__ __forceinline__ S await(const Desc* d, unsigned long long mark) {
  unsigned spins = 0;
  while (ld_acquire(&d->status) != mark) {
    if (++spins > SPIN_LIMIT) __trap();
    if (spins > 64) __nanosleep(128);
  }
  const uint4 q = __ldcg(reinterpret_cast<const uint4*>(d->w));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
  S s;
  memcpy(&s, w, sizeof(S));
  return s;
}

// The exclusive prefix of tile `tile` of a row from the aggregates of the
// tiles before it (`d` points at the row's first descriptor); one whole
// warp.  Windows of WINDOW tiles, nearest first; in a window lane l takes
// tile base - l, and the shuffle tree folds far-to-near in a fixed shape.
template <class Op>
__device__ typename Op::S look_back(const Desc* d, int tile,
                                    unsigned long long mark) {
  using S = typename Op::S;
  const int lane = threadIdx.x & 31;
  S acc = Op::id();
  for (int base = tile - 1; base >= 0; base -= WINDOW) {
    const int k = base - lane;
    S a = k >= 0 ? await<S>(d + k, mark) : Op::id();
    __syncwarp();
#pragma unroll
    for (int o = 1; o < WINDOW; o <<= 1) {
      const S far = shfl_s<1>(a, o);
      if (lane + o < WINDOW) a = Op::comb(far, a);
    }
    acc = Op::comb(shfl_s<2>(a, 0), acc);
    if (Op::full(acc)) break;
  }
  return acc;
}

// ---- a thread's chunks: 4 samples at positions p .. p + 3 of a row
// (positions outside 0 .. n-1 read as unmarked zeros, each monoid's
// identity), held in scan order ------------------------------------------

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <bool REV>
__device__ __forceinline__ void load_values(const float* __restrict__ rowp,
                                            int p, int n, bool whole,
                                            float (&v)[4]) {
  float m[4];
  if (whole && aligned16(rowp + p)) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(rowp + p));
    m[0] = t.x;
    m[1] = t.y;
    m[2] = t.z;
    m[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      m[q] = (p + q >= 0 && p + q < n) ? rowp[p + q] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = m[REV ? 3 - q : q];
}

// bit q of the result: flag of the chunk's q-th sample in scan order (any
// nonzero byte is a set flag)
template <bool REV>
__device__ __forceinline__ unsigned load_flags(const uint8_t* __restrict__ rowp,
                                               int p, int n, bool whole) {
  unsigned bits = 0u;
  if (whole) {
    // the aligned 4-byte words that hold the chunk, shifted into place;
    // each word read holds at least one byte of the chunk
    const uint8_t* a = rowp + p;
    const unsigned k = (unsigned)(reinterpret_cast<uintptr_t>(a) & 3);
    const unsigned* w = reinterpret_cast<const unsigned*>(a - k);
    unsigned b = w[0];
    if (k != 0u) b = __funnelshift_r(b, w[1], 8u * k);
    // high bit of every nonzero byte, then the 4 high bits gathered
    b = (((b & 0x7f7f7f7fu) + 0x7f7f7f7fu) | b) & 0x80808080u;
    bits = ((b >> 7) * 0x10204080u) >> 28;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p + q >= 0 && p + q < n && rowp[p + q]) bits |= 1u << q;
  }
  return REV ? __brev(bits) >> 28 : bits;
}

// bit q of the result: whether the chunk's q-th sample in scan order is a
// knot of the row (rowp, n), from the chunk's values `v` (in scan order).
// The neighbours in memory order are the next lane's chunk (a reverse scan:
// the previous lane's); the warp's first and last chunk in memory order
// read theirs.  Positions outside the row are never knots.  Every lane of
// the warp calls this.
template <bool REV>
__device__ __forceinline__ unsigned knot_bits(const float* __restrict__ rowp,
                                              int p, int n,
                                              const float (&v)[4]) {
  const int lane = threadIdx.x & 31;
  float m[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) m[q] = v[REV ? 3 - q : q];
  float left = REV ? __shfl_down_sync(FULL, m[3], 1)
                   : __shfl_up_sync(FULL, m[3], 1);
  float right = REV ? __shfl_up_sync(FULL, m[0], 1)
                    : __shfl_down_sync(FULL, m[0], 1);
  if (lane == (REV ? 31 : 0))
    left = (p - 1 >= 0 && p - 1 < n) ? rowp[p - 1] : 0.f;
  if (lane == (REV ? 0 : 31))
    right = (p + 4 >= 0 && p + 4 < n) ? rowp[p + 4] : 0.f;
  unsigned bits = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float xm1 = q == 0 ? left : m[q - 1];
    const float xp1 = q == 3 ? right : m[q + 1];
    if (p + q >= 0 && knot_at(xm1, m[q], xp1, p + q, n)) bits |= 1u << q;
  }
  return REV ? __brev(bits) >> 28 : bits;
}

// four outputs of one channel, `o` in scan order, to positions p .. p + 3
template <bool REV>
__device__ __forceinline__ void store4(unsigned* __restrict__ rowp, int p,
                                       int n, bool whole,
                                       const unsigned (&o)[4]) {
  if (whole && aligned16(rowp + p)) {
    const uint4 t = REV ? make_uint4(o[3], o[2], o[1], o[0])
                        : make_uint4(o[0], o[1], o[2], o[3]);
    __stcs(reinterpret_cast<uint4*>(rowp + p), t);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (p + q >= 0 && p + q < n) rowp[p + q] = o[REV ? 3 - q : q];
  }
}

// ------------------------------------------------------------- the kernel
// KNOTS: the flags are the knot mask of in0 (linear_fill2), `fl` unused
template <class Op, bool REV, bool STRICT, bool KNOTS>
__global__ void __launch_bounds__(NT, Op::WARPS / NWARP) scan_lookback(
    const float* __restrict__ in0, const float* __restrict__ in1,
    const uint8_t* __restrict__ fl, int n, int ntiles, unsigned nblocks,
    Header* __restrict__ hdr, Desc* __restrict__ desc,
    unsigned* __restrict__ out0, unsigned* __restrict__ out1,
    unsigned* __restrict__ out2, unsigned* __restrict__ out3) {
  using S = typename Op::S;
  __shared__ S sw[NWARP];
  __shared__ S s_prefix;
  __shared__ unsigned s_ticket;
  __shared__ unsigned long long s_mark;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    s_ticket = atomicAdd(&hdr->ticket, 1u);
    s_mark = *reinterpret_cast<volatile unsigned long long*>(&hdr->epoch) + 1ull;
  }
  __syncthreads();
  const unsigned ticket = s_ticket;
  const unsigned long long mark = s_mark;
  const int row = (int)(ticket / (unsigned)ntiles);
  const int tile = (int)(ticket % (unsigned)ntiles);  // in scan order
  const size_t ro = (size_t)row * (size_t)n;
  // floats from the 16-byte boundary at or before the row's first sample
  const int pad = (int)(((reinterpret_cast<uintptr_t>(in0) >> 2) + ro) & 3);
  // chunk c of this thread, in memory order; a reverse scan walks tiles,
  // warps, chunk sets, lanes and samples from the far end
  const int p0 = (REV ? ntiles - 1 - tile : tile) * TILE
                 + (REV ? NWARP - 1 - warp : warp) * WSPAN
                 + 4 * (REV ? 31 - lane : lane) - pad;
  auto chunk_pos = [&](int c) { return p0 + 128 * (REV ? CH - 1 - c : c); };

  float v[Op::NV][CH][4];
  unsigned bits[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int p = chunk_pos(c);
    const bool whole = p >= 0 && p <= n - 4;
    load_values<REV>(in0 + ro, p, n, whole, v[0][c]);
    if (Op::NV > 1) load_values<REV>(in1 + ro, p, n, whole, v[Op::NV - 1][c]);
    bits[c] = KNOTS ? knot_bits<REV>(in0 + ro, p, n, v[0][c])
                    : load_flags<REV>(fl + ro, p, n, whole);
  }

  auto element = [&](int c, int q) {
    float e[Op::NV];
#pragma unroll
    for (int ch = 0; ch < Op::NV; ++ch) e[ch] = v[ch][c][q];
    return Op::elem((bits[c] >> q) & 1u, e, chunk_pos(c) + (REV ? 3 - q : q));
  };

  // the tile's aggregate: chunks, each chunk set across the warp, the sets,
  // the warps.  ex[c]: everything before chunk c in its warp
  S ex[CH];
  S wtot = Op::id();
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    S a = Op::id();
#pragma unroll
    for (int q = 0; q < 4; ++q) a = Op::comb(a, element(c, q));
    const S inc = warp_inclusive<Op>(a, lane, 32);
    S e = shfl_s<0>(inc, 1);
    if (lane == 0) e = Op::id();
    ex[c] = Op::comb(wtot, e);
    wtot = Op::comb(wtot, shfl_s<2>(inc, 31));
  }
  if (lane == 31) sw[warp] = wtot;
  __syncthreads();
  if (warp == 0) {
    const S wi = warp_inclusive<Op>(lane < NWARP ? sw[lane] : Op::id(), lane,
                                    NWARP);
    S we = shfl_s<0>(wi, 1);   // the warps before this one
    if (lane == 0) we = Op::id();
    if (lane < NWARP) sw[lane] = we;
    Desc* rd = desc + (size_t)row * (size_t)ntiles;
    if (lane == NWARP - 1) publish(rd + tile, wi, mark);
    const S pre = look_back<Op>(rd, tile, mark);
    if (lane == 0) s_prefix = pre;
  }
  __syncthreads();

  // the scan of each chunk, seeded by everything before it
  const S before = Op::comb(s_prefix, sw[warp]);
  unsigned* const outs[4] = {out0, out1, out2, out3};
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    S P = Op::comb(before, ex[c]);
    unsigned o[Op::NO][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const S nx = Op::comb(P, element(c, q));
      unsigned ok[Op::NO];
      Op::emit(STRICT ? P : nx, ok);
#pragma unroll
      for (int ch = 0; ch < Op::NO; ++ch) o[ch][q] = ok[ch];
      P = nx;
    }
    const int p = chunk_pos(c);
    const bool whole = p >= 0 && p <= n - 4;
#pragma unroll
    for (int ch = 0; ch < Op::NO; ++ch)
      store4<REV>(outs[ch] + ro, p, n, whole, o[ch]);
  }

  // the last block to finish leaves the scratch ready for the next call
  if (tid == 0 && atomicAdd(&hdr->done, 1u) == nblocks - 1u) {
    hdr->ticket = 0u;
    hdr->done = 0u;
    hdr->epoch = mark;
  }
}

// tiles per row: rows that may start off a 16-byte boundary are shifted by
// up to 3 samples
int tiles_per_row(const void* in0, int n) {
  const bool aligned = (reinterpret_cast<uintptr_t>(in0) & 15) == 0
                       && n % 4 == 0;
  return (int)(((long long)n + (aligned ? 0 : 3) + TILE - 1) / TILE);
}

template <class Op, bool REV, bool STRICT, bool KNOTS = false>
int run_scan(const float* in0, const float* in1, const uint8_t* fl, int rows,
             int n, void* scratch, void* o0, void* o1, void* o2, void* o3,
             cudaStream_t s) {
  const int ntiles = tiles_per_row(in0, n);
  const long long blocks = (long long)rows * ntiles;
  if (rows < 1 || n < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Header* hdr = static_cast<Header*>(scratch);
  Desc* desc = reinterpret_cast<Desc*>(static_cast<char*>(scratch)
                                       + HEADER_BYTES);
  scan_lookback<Op, REV, STRICT, KNOTS><<<(unsigned)blocks, NT, 0, s>>>(
      in0, in1, fl, n, ntiles, (unsigned)blocks, hdr, desc,
      static_cast<unsigned*>(o0), static_cast<unsigned*>(o1),
      static_cast<unsigned*>(o2), static_cast<unsigned*>(o3));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pyitd_scan_tile_size() { return TILE; }

// samples per thread and threads per block: they fix the order of segsum's
// additions (ops/cuda_fill.py::segsum_depth)
int pyitd_scan_run_length() { return SPT; }
int pyitd_scan_threads() { return NT; }

// the scratch a call needs: pyitd_scan_header_bytes() + rows * tiles *
// pyitd_scan_desc_bytes(), tiles = ceil((n + 3) / TILE); zeroed before its
// first use, then left to the kernels
int pyitd_scan_header_bytes() { return HEADER_BYTES; }
int pyitd_scan_desc_bytes() { return (int)sizeof(Desc); }

int pyitd_fill2(const float* v, const uint8_t* mask, int rows, int n,
                int reverse, int strict, int* p1, float* v1, int* p2,
                float* v2, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYITD_FILL2(R, T)                                                  \
  return run_scan<Fill2, R, T>(v, nullptr, mask, rows, n, scratch, p1, v1, \
                               p2, v2, s)
  if (reverse) {
    if (strict) PYITD_FILL2(true, true);
    PYITD_FILL2(true, false);
  }
  if (strict) PYITD_FILL2(false, true);
  PYITD_FILL2(false, false);
#undef PYITD_FILL2
}

// K2a: fill2 of x under its knot mask, inclusive
int pyitd_linear_fill2(const float* x, int rows, int n, int reverse, int* p1,
                       float* v1, int* p2, float* v2, void* scratch,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    return run_scan<Fill2, true, false, true>(x, nullptr, nullptr, rows, n,
                                              scratch, p1, v1, p2, v2, s);
  return run_scan<Fill2, false, false, true>(x, nullptr, nullptr, rows, n,
                                             scratch, p1, v1, p2, v2, s);
}

int pyitd_fillv(const float* v, const uint8_t* mask, int rows, int n,
                int reverse, float* out, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    return run_scan<Fill1, true, false>(v, nullptr, mask, rows, n, scratch,
                                        out, nullptr, nullptr, nullptr, s);
  return run_scan<Fill1, false, false>(v, nullptr, mask, rows, n, scratch,
                                       out, nullptr, nullptr, nullptr, s);
}

int pyitd_segsum(int nch, const float* v0, const float* v1,
                 const uint8_t* flags, int rows, int n, int reverse,
                 int strict, float* o0, float* o1, void* scratch,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYITD_SEG(C, R, T)                                                \
  return run_scan<Seg<C>, R, T>(v0, v1, flags, rows, n, scratch, o0, o1, \
                                nullptr, nullptr, s)
#define PYITD_SEG_C(C)             \
  if (reverse) {                   \
    if (strict) PYITD_SEG(C, true, true); \
    PYITD_SEG(C, true, false);     \
  }                                \
  if (strict) PYITD_SEG(C, false, true); \
  PYITD_SEG(C, false, false)
  if (nch == 2) {
    PYITD_SEG_C(2);
  }
  if (nch != 1) return (int)cudaErrorInvalidValue;
  PYITD_SEG_C(1);
#undef PYITD_SEG_C
#undef PYITD_SEG
}

}  // extern "C"
