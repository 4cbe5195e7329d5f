// Masked fills and segmented running sums on Hopper (sm_90a), plain C
// interface: the scan primitives of the structural sift backward.
//
// Replaces: pyitd_tpu/ops/pallas_fill.py::fill2_padded (K3, via
// fill2_pallas; kernel body _make_fill2_kernel), fillv_pallas
// (_make_fillv_kernel), here K3's depth-1 mode, and segsum_pallas (K4,
// _make_segsum_kernel).
//
// What they compute, per row, over a scan order that runs forward (t = 0,
// 1, ...) or in reverse (t = n-1, n-2, ...):
//   fill2   (pos, value) of the last two marked samples at or before t in
//           scan order (with `strict`, strictly before); 0 where none.
//           Positions are int32 sample indices derived in the kernel.
//   fillv   the value of the last marked sample at or before t; 0 if none.
//   segsum  out[t] = v[t] + (flag[t] ? 0 : out[t-1]), one or two channels
//           sharing the flag (t-1 meaning the previous sample in scan
//           order).
//
// What bounds them: bytes.  A scan does no arithmetic to speak of (selects;
// one f32 add per sample and channel for segsum), so the least time is the
// inputs read once and the outputs written once: at 8 x 1M, fill2 moves
// 21 B/sample (value, mask, four outputs), fillv 9, segsum 9 or 17.
//
// What the design does about it.  The TPU walks each row's blocks in scan
// order and carries the scan state in SMEM; a GPU runs its blocks in no
// order, so every tile of TILE samples is seeded instead, in three launches
// per call that share one template over the scan's monoid:
//   1. scan_summary: one block per (row, tile) stages the tile through
//      shared memory and writes the tile's aggregate state;
//   2. scan_rows: one warp per row turns the aggregates, in place, into each
//      tile's exclusive prefix (a lane-serial fold, a warp-shuffle scan, a
//      serial re-walk);
//   3. scan_apply: one block per (row, tile) restages the tile, runs a
//      serial run of SPT samples per thread, a warp-shuffle scan and a
//      cross-warp scan through shared memory seeded from step 2, and writes
//      each output channel through shared memory in one coalesced pass.
// The summary pass re-reads the inputs once; decoupled look-back would save
// that pass and is left for a later change.  The sift kernels' tile_scan
// (sift_level.cu) scans both fill directions at once with knot counts and
// stop flags; these scans need one direction and, for segsum, another
// monoid, so they share this template instead.
//
// A fill only selects, so fill2 and fillv are bit-equal to their plain
// versions whatever the association.  segsum's f32 adds associate in the
// order above, not in the plain version's: a term passes through at most
// 59 + 2 * ceil(ntiles / 32) additions on its way to an output (8 in the
// run walk, 8 + 5 + 16 within a tile's aggregate, 2 * per + 5 in the row
// scan, 16 + 1 seeding the apply pass), which bounds its error
// (ops/cuda_fill.py::segsum_error_bound).  On integer-valued inputs whose
// partial sums stay below 2^24 every order is exact.
// Built with -fmad=false and no fast-math, like sift_level.cu.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int TILE = 4096;            // scan indices per block
constexpr int NT = 512;               // threads per block
constexpr int SPT = TILE / NT;        // consecutive scan indices per thread
constexpr int NWARP = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

// shared-memory index with one pad word every 32 (see sift_level.cu)
__device__ __forceinline__ int padi(int i) { return i + (i >> 5); }
constexpr int SB_LEN = TILE + TILE / 32 + 1;

// ---- the scans' monoids: comb(a, b) with a first in scan order ----------

// K3: the last two marks in scan order, nearest first; position -1 = none
// (value 0) (pallas_fill.py::_combine)
struct Fill2 {
  struct S { int p1; float v1; int p2; float v2; };
  static constexpr int NV = 1, NO = 4;
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
  static constexpr int NV = 1, NO = 1;
  __device__ static S id() { return {-1, 0.f}; }
  __device__ static S comb(const S& a, const S& b) { return b.p >= 0 ? b : a; }
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
  static constexpr int NV = C, NO = C;
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

template <class S>
__device__ __forceinline__ S shfl_up_s(const S& s, int o) {
  static_assert(sizeof(S) % 4 == 0, "scan states are 32-bit words");
  constexpr int W = sizeof(S) / 4;
  unsigned w[W];
  memcpy(w, &s, sizeof(S));
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = __shfl_up_sync(FULL, w[i], o);
  S r;
  memcpy(&r, w, sizeof(S));
  return r;
}

// scan index i of a row -> sample position
template <bool REV>
__device__ __forceinline__ int pos_of(int i, int n) { return REV ? n - 1 - i : i; }

// This thread's run of SPT scan indices: input values and mark/flag bits.
template <class Op>
struct Run {
  float v[Op::NV][SPT];
  unsigned bits;
};

// Stage one tile (scan indices i0 .. i0+TILE-1 of a row) through shared
// memory, one channel at a time; scan indices past the row read as
// unmarked zeros, which is each monoid's identity.
template <class Op, bool REV>
__device__ __forceinline__ void load_run(const float* __restrict__ in0,
                                         const float* __restrict__ in1,
                                         const uint8_t* __restrict__ fl, int n,
                                         int i0, unsigned* s, Run<Op>& run) {
  const int j0 = threadIdx.x * SPT;
#pragma unroll
  for (int c = 0; c < Op::NV; ++c) {
    const float* src = c == 0 ? in0 : in1;
    for (int j = threadIdx.x; j < TILE; j += NT) {
      const int i = i0 + j;
      s[padi(j)] = i < n ? __float_as_uint(src[pos_of<REV>(i, n)]) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SPT; ++k) run.v[c][k] = __uint_as_float(s[padi(j0 + k)]);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < TILE; j += NT) {
    const int i = i0 + j;
    s[padi(j)] = (i < n && fl[pos_of<REV>(i, n)]) ? 1u : 0u;
  }
  __syncthreads();
  run.bits = 0u;
#pragma unroll
  for (int k = 0; k < SPT; ++k) run.bits |= s[padi(j0 + k)] << k;
  __syncthreads();
}

template <class Op, bool REV>
__device__ __forceinline__ typename Op::S element(const Run<Op>& run, int k,
                                                  int i0, int n) {
  float v[Op::NV];
#pragma unroll
  for (int c = 0; c < Op::NV; ++c) v[c] = run.v[c][k];
  const int i = i0 + threadIdx.x * SPT + k;
  return Op::elem((run.bits >> k) & 1u, v, pos_of<REV>(i, n));
}

template <class Op, bool REV>
__device__ __forceinline__ typename Op::S run_aggregate(const Run<Op>& run,
                                                        int i0, int n) {
  typename Op::S a = Op::id();
#pragma unroll
  for (int k = 0; k < SPT; ++k) a = Op::comb(a, element<Op, REV>(run, k, i0, n));
  return a;
}

// Exclusive scan of the threads' run aggregates in thread order, seeded by
// `seed` (the state of everything before the block); sw[NWARP] receives
// seed followed by the whole block.
template <class Op>
__device__ typename Op::S block_excl(typename Op::S v, typename Op::S seed,
                                     typename Op::S* sw) {
  using S = typename Op::S;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  S inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const S u = shfl_up_s(inc, o);
    if (lane >= o) inc = Op::comb(u, inc);
  }
  S ex = shfl_up_s(inc, 1);
  if (lane == 0) ex = Op::id();
  if (lane == 31) sw[w] = inc;
  __syncthreads();
  if (threadIdx.x == 0) {
    S acc = seed;
    for (int i = 0; i < NWARP; ++i) {
      const S t = sw[i];
      sw[i] = acc;
      acc = Op::comb(acc, t);
    }
    sw[NWARP] = acc;
  }
  __syncthreads();
  return Op::comb(sw[w], ex);
}

// ------------------------------------------------------------- pass 1
template <class Op, bool REV>
__global__ void __launch_bounds__(NT) scan_summary(
    const float* __restrict__ in0, const float* __restrict__ in1,
    const uint8_t* __restrict__ fl, int n, int ntiles,
    typename Op::S* __restrict__ st) {
  __shared__ unsigned s_buf[SB_LEN];
  __shared__ typename Op::S sw[NWARP + 1];
  const int row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const size_t ro = (size_t)row * n;
  const int i0 = tile * TILE;
  Run<Op> run;
  load_run<Op, REV>(in0 + ro, Op::NV > 1 ? in1 + ro : nullptr, fl + ro, n,
                    i0, s_buf, run);
  block_excl<Op>(run_aggregate<Op, REV>(run, i0, n), Op::id(), sw);
  if (threadIdx.x == 0) st[blockIdx.x] = sw[NWARP];
}

// ------------------------------------------------------------- pass 2
// One warp per row; lane l owns a contiguous run of tiles.  In place: each
// tile's aggregate becomes its exclusive prefix.
template <class Op>
__global__ void scan_rows(int ntiles, typename Op::S* __restrict__ st) {
  using S = typename Op::S;
  const int lane = threadIdx.x;
  S* r = st + (size_t)blockIdx.x * ntiles;
  const int per = (ntiles + 31) / 32;
  const int k0 = min(lane * per, ntiles), k1 = min(k0 + per, ntiles);
  S a = Op::id();
  for (int k = k0; k < k1; ++k) a = Op::comb(a, r[k]);
  S inc = a;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const S u = shfl_up_s(inc, o);
    if (lane >= o) inc = Op::comb(u, inc);
  }
  S acc = shfl_up_s(inc, 1);
  if (lane == 0) acc = Op::id();
  for (int k = k0; k < k1; ++k) {
    const S t = r[k];
    r[k] = acc;
    acc = Op::comb(acc, t);
  }
}

// ------------------------------------------------------------- pass 3
template <class Op, bool REV, bool STRICT>
__global__ void __launch_bounds__(NT) scan_apply(
    const float* __restrict__ in0, const float* __restrict__ in1,
    const uint8_t* __restrict__ fl, int n, int ntiles,
    const typename Op::S* __restrict__ st, unsigned* __restrict__ out0,
    unsigned* __restrict__ out1, unsigned* __restrict__ out2,
    unsigned* __restrict__ out3) {
  using S = typename Op::S;
  __shared__ unsigned s_buf[SB_LEN];
  __shared__ S sw[NWARP + 1];
  const int row = blockIdx.x / ntiles, tile = blockIdx.x % ntiles;
  const size_t ro = (size_t)row * n;
  const int i0 = tile * TILE;
  Run<Op> run;
  load_run<Op, REV>(in0 + ro, Op::NV > 1 ? in1 + ro : nullptr, fl + ro, n,
                    i0, s_buf, run);
  S P = block_excl<Op>(run_aggregate<Op, REV>(run, i0, n), st[blockIdx.x],
                       sw);

  unsigned o[Op::NO][SPT];
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const S nx = Op::comb(P, element<Op, REV>(run, k, i0, n));
    unsigned ok[Op::NO];
    Op::emit(STRICT ? P : nx, ok);
#pragma unroll
    for (int c = 0; c < Op::NO; ++c) o[c][k] = ok[c];
    P = nx;
  }

  unsigned* outs[4] = {out0, out1, out2, out3};
  const int j0 = threadIdx.x * SPT;
#pragma unroll
  for (int c = 0; c < Op::NO; ++c) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SPT; ++k) s_buf[padi(j0 + k)] = o[c][k];
    __syncthreads();
    unsigned* dst = outs[c] + ro;
    for (int j = threadIdx.x; j < TILE; j += NT) {
      const int i = i0 + j;
      if (i >= n) break;
      dst[pos_of<REV>(i, n)] = s_buf[padi(j)];
    }
  }
}

template <class Op, bool REV, bool STRICT>
int run_scan(const float* in0, const float* in1, const uint8_t* fl, int rows,
             int n, int ntiles, void* scratch, void* o0, void* o1, void* o2,
             void* o3, cudaStream_t s) {
  using S = typename Op::S;
  S* st = static_cast<S*>(scratch);
  const int blocks = rows * ntiles;
  scan_summary<Op, REV><<<blocks, NT, 0, s>>>(in0, in1, fl, n, ntiles, st);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  scan_rows<Op><<<rows, 32, 0, s>>>(ntiles, st);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  scan_apply<Op, REV, STRICT><<<blocks, NT, 0, s>>>(
      in0, in1, fl, n, ntiles, st, static_cast<unsigned*>(o0),
      static_cast<unsigned*>(o1), static_cast<unsigned*>(o2),
      static_cast<unsigned*>(o3));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pyitd_scan_tile_size() { return TILE; }

// bytes of one tile's scan state: 0 fill2, 1 fillv, 2 segsum (1 channel),
// 3 segsum (2 channels); the wrappers allocate rows * ntiles of them
int pyitd_scan_state_bytes(int kind) {
  switch (kind) {
    case 0: return (int)sizeof(Fill2::S);
    case 1: return (int)sizeof(Fill1::S);
    case 2: return (int)sizeof(Seg<1>::S);
    case 3: return (int)sizeof(Seg<2>::S);
    default: return 0;
  }
}

int pyitd_fill2(const float* v, const uint8_t* mask, int rows, int n,
                int ntiles, int reverse, int strict, int* p1, float* v1,
                int* p2, float* v2, void* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYITD_FILL2(R, T)                                                   \
  return run_scan<Fill2, R, T>(v, nullptr, mask, rows, n, ntiles, scratch, \
                               p1, v1, p2, v2, s)
  if (reverse) {
    if (strict) PYITD_FILL2(true, true);
    PYITD_FILL2(true, false);
  }
  if (strict) PYITD_FILL2(false, true);
  PYITD_FILL2(false, false);
#undef PYITD_FILL2
}

int pyitd_fillv(const float* v, const uint8_t* mask, int rows, int n,
                int ntiles, int reverse, float* out, void* scratch,
                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (reverse)
    return run_scan<Fill1, true, false>(v, nullptr, mask, rows, n, ntiles,
                                        scratch, out, nullptr, nullptr,
                                        nullptr, s);
  return run_scan<Fill1, false, false>(v, nullptr, mask, rows, n, ntiles,
                                       scratch, out, nullptr, nullptr,
                                       nullptr, s);
}

int pyitd_segsum(int nch, const float* v0, const float* v1,
                 const uint8_t* flags, int rows, int n, int ntiles,
                 int reverse, float* o0, float* o1, void* scratch,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define PYITD_SEG(C, R)                                                    \
  return run_scan<Seg<C>, R, false>(v0, v1, flags, rows, n, ntiles,       \
                                    scratch, o0, o1, nullptr, nullptr, s)
  if (nch == 2) {
    if (reverse) PYITD_SEG(2, true);
    PYITD_SEG(2, false);
  }
  if (nch != 1) return (int)cudaErrorInvalidValue;
  if (reverse) PYITD_SEG(1, true);
  PYITD_SEG(1, false);
#undef PYITD_SEG
}

}  // extern "C"
