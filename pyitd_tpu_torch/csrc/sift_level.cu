// One trip of the canonical ITD sift on Hopper (sm_90a), plain C interface.
//
// Replaces: pyitd_tpu/ops/pallas_fill.py::sift_level_fused_padded (K1,
// kernel body _make_level_fused_kernel / _fused_scans_and_epilogue), its
// XLA pre-pass level_block_states_fwd, the two-kernel emit tier
// sift_level_emit_padded, and, with the bookkeeping compiled out, the
// level pair _linear_fill2_padded + _linear_baseline_padded behind
// linear_level_pallas (K2a/K2b).
//
// What bounds it: bytes.  At 8 x 1M f32 with 10 levels the sift moves about
// 3.7 GB: ten trips x (5 reads + 5 writes of 32 MB), the initial
// extraction's 4 x 32 MB and eleven 32 MB summary reads -- about 1.1 ms at
// the data sheet's 3.35 TB/s.  The arithmetic per sample is a few dozen
// flops, far below the card's ratio of flops to bytes.
//
// What the design does about it.  The TPU walks each row's blocks in order
// and carries the reverse fill state from block to block; a GPU runs its
// blocks in no order, so both directions are seeded instead, in three
// launches per trip:
//   1. level_summaries: one block per (row, tile of TILE samples) reads the
//      tile once and writes its last two knots, first two knots and knot
//      count (16 + 16 + 4 bytes per tile).
//   2. tile_scan: one warp per row turns those into each tile's exclusive
//      forward prefix and exclusive reverse suffix, the interior extrema
//      count, and the sift's stop flags and done/reason/ncomp update.
//   3. sift_level: one block per (row, tile) stages the tile plus a
//      one-sample halo in shared memory, recomputes the knot mask, runs
//      the forward and reverse last-two-knot fills seeded from step 2
//      (a serial run per thread, a warp-shuffle scan, a cross-warp scan
//      through shared memory), evaluates the Frei-Osorio knot values and
//      the linear-in-value baseline, and writes baseline, rotation, its
//      two-sum residual, the output row and the compensation in one
//      coalesced pass.  Each input is read once and each output written
//      once; a row's previous baseline and pending residual are read only
//      where its stop flags need them.
// Knot positions are int32: (kpos - lpos) is an integer difference cast to
// f32 once.  Built with -fmad=false and no fast-math, so every formula
// rounds as PyTorch's eager elementwise kernels do; the kernels agree with
// the plain PyTorch versions in ops/cuda_fill.py bit for bit.

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

constexpr int STOP_A = 1, STOP_B = 2, CONT = 4;

// last two knots at or before a point (p1 the latest); -1 = none, value 0
struct Fwd { int p1; float v1; int p2; float v2; };
// first two knots at or after a point (q1 the earliest); -1 = none, value 0
struct Rev { int q1; float w1; int q2; float w2; };

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
// extremum within one sample of a NaN, both endpoints always, padding never
__device__ __forceinline__ bool knot_at(float xm1, float x0, float xp1, int t,
                                        int n) {
  if (t >= n) return false;
  if (t == 0 || t == n - 1) return true;
  float dxb = x0 - xm1;
  float dxf = xp1 - x0;
  if (isnan(dxb)) dxb = INFINITY;
  if (isnan(dxf)) dxf = INFINITY;
  const bool near_nan = isnan(x0) || isnan(xm1) || isnan(xp1);
  const bool is_min = (dxb <= 0.f) && (dxf > 0.f);
  const bool is_max = (dxb >= 0.f) && (dxf < 0.f);
  return (is_min || is_max) && !near_nan;
}

// Frei-Osorio knot value (linear_baseline.py::knot_value), alpha = 0.5
__device__ __forceinline__ float knot_value(int kpos, float kval, int lpos,
                                            float lval, int rpos, float rval) {
  const float span = (float)(rpos - lpos);
  const float w = (float)(kpos - lpos) / (span == 0.f ? 1.f : span);
  return 0.5f * (lval + w * (rval - lval)) + 0.5f * kval;
}

// x[base-1 .. base+TILE] of one row into shared memory; zeros off the row
__device__ __forceinline__ void stage_tile(const float* __restrict__ xr, int n,
                                           int base, float* s) {
  for (int k = threadIdx.x; k < TILE + 2; k += NT) {
    const int g = base - 1 + k;
    s[padi(k)] = (g >= 0 && g < n) ? xr[g] : 0.f;
  }
}

// This thread's run of SPT samples: knot bits, values, and the run's own
// last-two / first-two knots.
struct Run {
  unsigned bits;
  float xv[SPT];
  Fwd f;
  Rev r;
};

__device__ __forceinline__ void load_run(const float* s, int n, int base,
                                         Run& run) {
  const int j0 = threadIdx.x * SPT;
  run.bits = 0u;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int j = j0 + k;
    const float a = s[padi(j)], b = s[padi(j + 1)], c = s[padi(j + 2)];
    run.xv[k] = b;
    if (knot_at(a, b, c, base + j, n)) run.bits |= 1u << k;
  }
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

// ---------------------------------------------------------------- kernel 1
__global__ void __launch_bounds__(NT) level_summaries_kernel(
    const float* __restrict__ x, int n, int ntiles, int* __restrict__ fpos,
    float* __restrict__ fval, int* __restrict__ rpos, float* __restrict__ rval,
    int* __restrict__ cnt) {
  __shared__ float s_x[SX_LEN];
  __shared__ Fwd sw_f[NWARP];
  __shared__ Rev sw_r[NWARP];
  __shared__ int s_cnt[NWARP];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  stage_tile(x + (size_t)row * n, n, base, s_x);
  __syncthreads();
  Run run;
  load_run(s_x, n, base, run);
  const Fwd fex = block_excl_fwd(run.f, fwd_none(), sw_f);
  const Rev rex = block_excl_rev(run.r, rev_none(), sw_r);
  const int c = warp_sum(__popc(run.bits));
  if ((threadIdx.x & 31) == 0) s_cnt[threadIdx.x >> 5] = c;
  __syncthreads();
  const size_t o = ((size_t)row * ntiles + tile) * 2;
  if (threadIdx.x == NT - 1) {
    const Fwd t = fwd_combine(fex, run.f);
    fpos[o] = t.p1; fval[o] = t.v1; fpos[o + 1] = t.p2; fval[o + 1] = t.v2;
  }
  if (threadIdx.x == 0) {
    const Rev t = rev_combine(run.r, rex);
    rpos[o] = t.q1; rval[o] = t.w1; rpos[o + 1] = t.q2; rval[o + 1] = t.w2;
    int total = 0;
    for (int i = 0; i < NWARP; ++i) total += s_cnt[i];
    cnt[(size_t)row * ntiles + tile] = total;
  }
}

// ---------------------------------------------------------------- kernel 2
// One warp per row.  Lane l owns a contiguous run of tiles; a lane-serial
// fold, a warp-shuffle exclusive scan of the lane folds, then a serial
// re-walk that writes each tile's exclusive prefix / suffix.
__global__ void tile_scan_kernel(
    int ntiles, const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const int* __restrict__ cnt, int* __restrict__ fpos_ex,
    float* __restrict__ fval_ex, int* __restrict__ rpos_ex,
    float* __restrict__ rval_ex, int* __restrict__ nex, int* __restrict__ flags,
    int* __restrict__ done, int* __restrict__ reason, int* __restrict__ ncomp,
    int trip, int max_iteration) {
  const int row = blockIdx.x, lane = threadIdx.x;
  const int per = (ntiles + 31) / 32;
  const int k0 = min(lane * per, ntiles), k1 = min(k0 + per, ntiles);
  const size_t rb = (size_t)row * ntiles;

  Fwd fa = fwd_none();
  Rev ra = rev_none();
  int c = 0;
  for (int k = k0; k < k1; ++k) {
    const size_t o = (rb + k) * 2;
    fa = fwd_combine(fa, Fwd{fpos[o], fval[o], fpos[o + 1], fval[o + 1]});
    c += cnt[rb + k];
  }
  for (int k = k1 - 1; k >= k0; --k) {
    const size_t o = (rb + k) * 2;
    ra = rev_combine(Rev{rpos[o], rval[o], rpos[o + 1], rval[o + 1]}, ra);
  }

  Fwd finc = fa;
  Rev rinc = ra;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const Fwd u = shfl_up(finc, o);
    if (lane >= o) finc = fwd_combine(u, finc);
    const Rev v = shfl_down(rinc, o);
    if (lane + o < 32) rinc = rev_combine(rinc, v);
  }
  Fwd facc = shfl_up(finc, 1);
  if (lane == 0) facc = fwd_none();
  Rev racc = shfl_down(rinc, 1);
  if (lane == 31) racc = rev_none();
  const int total = warp_sum(c);

  for (int k = k0; k < k1; ++k) {
    const size_t o = (rb + k) * 2;
    const Fwd t{fpos[o], fval[o], fpos[o + 1], fval[o + 1]};
    fpos_ex[o] = facc.p1; fval_ex[o] = facc.v1;
    fpos_ex[o + 1] = facc.p2; fval_ex[o + 1] = facc.v2;
    facc = fwd_combine(facc, t);
  }
  for (int k = k1 - 1; k >= k0; --k) {
    const size_t o = (rb + k) * 2;
    const Rev t{rpos[o], rval[o], rpos[o + 1], rval[o + 1]};
    rpos_ex[o] = racc.q1; rval_ex[o] = racc.w1;
    rpos_ex[o + 1] = racc.q2; rval_ex[o + 1] = racc.w2;
    racc = rev_combine(t, racc);
  }

  if (lane == 0) {
    const int nx = total - 2;  // knots minus the two endpoints
    nex[row] = nx;
    int f = 0;
    if (done != nullptr) {  // sift bookkeeping (decomp/itd.py:520-522)
      const bool d = done[row] != 0;
      const bool sa = !d && nx < 2;
      const bool sb = !d && !sa && trip >= max_iteration + 1;
      const bool ct = !d && !sa && !sb;
      f = (sa ? STOP_A : 0) | (sb ? STOP_B : 0) | (ct ? CONT : 0);
      if (sa || sb) {
        ncomp[row] = trip + 1;
        reason[row] = sa ? 1 : 2;
        done[row] = 1;
      }
    }
    flags[row] = f;
  }
}

// ---------------------------------------------------------------- kernel 3
template <bool BOOK, bool REF_END>
__global__ void __launch_bounds__(NT) sift_level_kernel(
    const float* __restrict__ x, int n, int ntiles,
    const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const int* __restrict__ flags, const float* __restrict__ rotp,
    const float* __restrict__ pbase, const float* __restrict__ perr,
    const float* __restrict__ comp, float* __restrict__ base_out,
    float* __restrict__ rot_out, float* __restrict__ err_out,
    float* __restrict__ row_out, float* __restrict__ comp_out) {
  __shared__ float s_x[SX_LEN];
  __shared__ float s_b[SB_LEN];
  __shared__ Fwd sw_f[NWARP];
  __shared__ Rev sw_r[NWARP];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const float* xr = x + (size_t)row * n;
  stage_tile(xr, n, base, s_x);
  __syncthreads();

  Run run;
  load_run(s_x, n, base, run);
  const size_t so = ((size_t)row * ntiles + tile) * 2;
  const Fwd fseed{fpos[so], fval[so], fpos[so + 1], fval[so + 1]};
  const Rev rseed{rpos[so], rval[so], rpos[so + 1], rval[so + 1]};
  const Fwd fex = block_excl_fwd(run.f, fseed, sw_f);
  const Rev rex = block_excl_rev(run.r, rseed, sw_r);

  const int j0 = threadIdx.x * SPT;
  // reverse walk: the first two knots strictly after each sample
  int n1p[SPT], n2p[SPT];
  float n1x[SPT], n2x[SPT];
  Rev S = rex;
#pragma unroll
  for (int k = SPT - 1; k >= 0; --k) {
    n1p[k] = S.q1; n1x[k] = S.w1; n2p[k] = S.q2; n2x[k] = S.w2;
    if ((run.bits >> k) & 1u) S = {base + j0 + k, run.xv[k], S.q1, S.w1};
  }

  const float b_first = 0.5f * (xr[0] + xr[1]);
  const float b_last = 0.5f * (xr[n - 2] + xr[n - 1]);
  // forward walk: the last two knots at or before each sample, then the
  // epilogue of _fused_scans_and_epilogue in the order of the gather form
  Fwd P = fex;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int t = base + j0 + k;
    const float xt = run.xv[k];
    if ((run.bits >> k) & 1u) P = {t, xt, P.p1, P.v1};
    float b = 0.f;
    if (t < n) {
      int q1 = n1p[k];
      float w1 = n1x[k];
      if (t == n - 1) {  // no knot after: the gather form clips to n-1
        q1 = n - 1;
        w1 = xt;
      }
      float b_l;
      if (P.p1 == n - 1) b_l = b_last;
      else if (P.p1 == 0) b_l = b_first;
      else b_l = knot_value(P.p1, P.v1, P.p2, P.v2, q1, w1);
      const float b_r = (q1 == n - 1)
          ? b_last : knot_value(q1, w1, P.p1, P.v1, n2p[k], n2x[k]);
      const float den = w1 - P.v1;
      const float slope = (den == 0.f) ? 0.f : (b_r - b_l) / den;
      b = b_l + slope * (xt - P.v1);
      if (REF_END && t == n - 1) b = 0.f;
    }
    s_b[padi(j0 + k)] = b;
  }
  __syncthreads();

  // coalesced pass: outputs, and the sift bookkeeping for the PREVIOUS
  // extraction's outputs (row into rotations[level], compensation)
  const size_t ro = (size_t)row * n;
  const int fl = BOOK ? flags[row] : 0;
  const bool sa = fl & STOP_A, sb = fl & STOP_B, ct = fl & CONT;
  for (int j = threadIdx.x; j < TILE; j += NT) {
    const int t = base + j;
    if (t >= n) break;
    const size_t i = ro + t;
    const float xx = s_x[padi(j + 1)];
    const float b = s_b[padi(j)];
    const float r = xx - b;
    const float bb = r - xx;
    base_out[i] = b;
    rot_out[i] = r;
    err_out[i] = (xx - (r - bb)) + ((-b) - bb);
    if (BOOK) {
      const float rp = (ct || sb) ? rotp[i] : 0.f;
      const float rs = rp + xx;
      const float rbb = rs - rp;
      const float res_err = (rp - (rs - rbb)) + (xx - rbb);
      float rowv;
      if (sa) rowv = pbase[i];
      else if (sb) rowv = rs;
      else rowv = ct ? rp : 0.f;
      row_out[i] = rowv;
      const float pe = (ct || sb) ? perr[i] : 0.f;
      comp_out[i] = (comp[i] + pe) + (sb ? res_err : 0.f);
    }
  }
}

}  // namespace

extern "C" {

int pyitd_tile_size() { return TILE; }

const char* pyitd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int pyitd_level_summaries(const float* x, int rows, int n, int ntiles,
                          int* fpos, float* fval, int* rpos, float* rval,
                          int* cnt, void* stream) {
  const dim3 grid(ntiles, rows);
  level_summaries_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, n, ntiles, fpos, fval, rpos, rval, cnt);
  return (int)cudaGetLastError();
}

int pyitd_tile_scan(int rows, int ntiles, const int* fpos, const float* fval,
                    const int* rpos, const float* rval, const int* cnt,
                    int* fpos_ex, float* fval_ex, int* rpos_ex, float* rval_ex,
                    int* nex, int* flags, int* done, int* reason, int* ncomp,
                    int trip, int max_iteration, void* stream) {
  tile_scan_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      ntiles, fpos, fval, rpos, rval, cnt, fpos_ex, fval_ex, rpos_ex, rval_ex,
      nex, flags, done, reason, ncomp, trip, max_iteration);
  return (int)cudaGetLastError();
}

int pyitd_sift_level(const float* x, int rows, int n, int ntiles,
                     const int* fpos, const float* fval, const int* rpos,
                     const float* rval, const int* flags, const float* rotp,
                     const float* pbase, const float* perr, const float* comp,
                     float* base, float* rot, float* err, float* row_out,
                     float* comp_out, int bookkeeping, int ref_end,
                     void* stream) {
  const dim3 grid(ntiles, rows);
  cudaStream_t s = (cudaStream_t)stream;
#define PYITD_LAUNCH(B, R)                                                   \
  sift_level_kernel<B, R><<<grid, NT, 0, s>>>(                              \
      x, n, ntiles, fpos, fval, rpos, rval, flags, rotp, pbase, perr, comp, \
      base, rot, err, row_out, comp_out)
  if (bookkeeping) {
    if (ref_end) PYITD_LAUNCH(true, true);
    else PYITD_LAUNCH(true, false);
  } else {
    if (ref_end) PYITD_LAUNCH(false, true);
    else PYITD_LAUNCH(false, false);
  }
#undef PYITD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
