// One trip of the canonical ITD sift on Hopper (sm_90a), plain C interface.
//
// Replaces: pyitd_tpu/ops/pallas_fill.py::sift_level_fused_padded (K1,
// kernel body _make_level_fused_kernel / _fused_scans_and_epilogue), its
// XLA pre-pass level_block_states_fwd, the two-kernel emit tier
// sift_level_emit_padded, and, with the bookkeeping compiled out, the
// level pair _linear_fill2_padded + _linear_baseline_padded behind
// linear_level_pallas (K2a/K2b); and, with the shard arguments compiled in
// (SHARD), pyitd_tpu/ops/pallas_fill_sharded.py::sharded_sift_level_fused
// (K9) and the pre-pass inside parallel/sharded.py::_sift_local_pallas.
//
// What bounds it: bytes, and on this card the bytes a block keeps in flight.
// At 8 x 1M f32 with 10 levels the sift moves about 3.4 GB: ten trips x
// (5 reads + 5 writes of 32 MB), the first extraction's 4 x 32 MB and one
// 32 MB summary read -- about 1.0 ms at the data sheet's 3.35 TB/s.  The
// arithmetic per sample is a few dozen flops, far below the card's ratio of
// flops to bytes; what a slow version of these kernels waits for is its own
// chain of barriers and shared-memory round trips with too few blocks
// resident to hide it.
//
// What the design does about it.  The TPU walks each row's blocks in order
// and carries the reverse fill state from block to block; a GPU runs its
// blocks in no order, so both directions are seeded instead:
//   1. level_summaries: one block per (row, tile of TILE samples) loads the
//      tile with coalesced 128-bit loads straight into registers
//      (tile_fill.cuh, the chunk layout), tests the knots, and reduces them
//      to the tile's last two knots, first two knots and knot count
//      (16 + 16 + 4 bytes per tile): a reduction with one barrier, no scan.
//   2. tile_scan: one block per row turns those into each tile's exclusive
//      forward prefix and exclusive reverse suffix, the interior extrema
//      count, and the sift's stop flags and done/reason/ncomp update.
//   3. sift_level: one block per (row, tile) loads the tile the same way,
//      keeps the values in 16 KB of shared memory and the knot bits as a
//      128-word bitmap beside them, and after ONE barrier every thread finds
//      the two knots before and the two after each of its chunks by bit
//      operations on the bitmap (tile_fill.cuh::find_prev / find_next; a
//      knot outside the tile is the seed from step 2).  No thread waits for
//      another's fill state.  It then evaluates the Frei-Osorio knot values
//      and the linear-in-value baseline -- the two knot values and the slope
//      only where its walk passes a knot, since they are constants of a
//      knot-to-knot segment -- and writes baseline, rotation, its two-sum
//      residual, the output row and the compensation from registers with
//      128-bit stores.  Each input is read once and each output written
//      once; a row's previous baseline and pending residual are read only
//      where its stop flags need them.  What is read once and written for
//      the next trip to stream carries the streaming hint (ld.cs / st.cs).
// The pre-pass leaves the sift's trips.  Step 1 would re-read, trip after
// trip, the baseline that step 3 of the trip before held in its registers.
// With EMIT, sift_level also writes the summary of the baseline it has just
// computed over the tile's INTERIOR, samples 1 .. TILE - 2 of the tile,
// whose knot tests need only values the block holds (two more barriers:
// the baseline passes through the shared memory that held the signal).
// tile_scan then completes each tile with its two edge samples, reading at
// most six values per tile from the baseline, before it scans.  A sift is
// one level_summaries (of the input), and one tile_scan and one sift_level
// per extraction.  Nothing looks ahead between blocks, so no block waits
// for another: a one-pass look-back in both directions (as the backward's
// scans do in one) would make a tile spin on tiles after it in ticket
// order, and a row whose only knots are its end points would need every
// tile of the row resident at once.
// Knot positions are int32: (kpos - lpos) is an integer difference cast to
// f32 once.  Built with -fmad=false and no fast-math, so every formula
// rounds as PyTorch's eager elementwise kernels do; the kernels agree with
// the plain PyTorch versions in ops/cuda_fill.py bit for bit.
//
// One time shard of a longer signal (K9).  The TPU kernel walks a shard's
// blocks in reverse and seeds its carry once from the cross-shard suffix;
// here every tile is seeded in both directions, so the cross-shard states
// enter where the tile seeds are loaded.  A kernel row is one (shard, row)
// pair and every shard argument is a per-row array (tile_fill.cuh::Shard),
// so one launch serves every shard on the card.  level_summaries tests and
// numbers knots by global position, with the neighbours' edge samples in the
// two halo cells; tile_scan also writes the shard's inclusive totals, which
// the caller folds across shards (a gather) and whose counts it sums before
// it decides the stop flags; sift_level combines the shard's prefix and
// suffix into each tile's seeds and takes the global end-knot values as
// arguments.  With SHARD off the code is what it was.
//
// A shard's summaries from the trip before (fold_emit,
// pallas_fill_sharded.py::_make_level_fused_sharded_kernel(fold_emit=True)
// and parallel/sharded.py::states_from_folds).  With SHARD and EMIT,
// sift_level numbers the interior summary's knots by global position and
// also leaves out the shard's last real sample (local n - 1), wherever it
// falls: its knot test needs the next shard's first baseline sample, which
// this launch computes in another block.  tile_scan, given the shard
// arguments, completes each tile with its first and last sample and the
// shard's last one, with the halos of this trip's input as the neighbours
// beyond the row, so a sharded sift too summarises only its input.

// The chunk layout, the knot test, the tile summary and the bitmap live in
// tile_fill.cuh, shared with the cubic tier's kernels in cubic.cu.
#include "tile_fill.cuh"

namespace {

constexpr int STOP_A = 1, STOP_B = 2, CONT = 4;

// Blocks of NT threads the compiler leaves registers for on one SM
// (tools/level_bench.py times other values).  sift_level without the
// bookkeeping is the faster at 3 (40 registers, some 60 bytes of spills per
// thread, against 56 to 64 registers and none at 2); with it, 3 blocks
// would hold 200 KB of shared memory and spill more, and 2 are the faster.
#ifndef PYITD_LEVEL_BLOCKS
#define PYITD_LEVEL_BLOCKS 3
#endif
#ifndef PYITD_BOOK_BLOCKS
#define PYITD_BOOK_BLOCKS 2
#endif
#ifndef PYITD_SUMMARY_BLOCKS
#define PYITD_SUMMARY_BLOCKS 4
#endif

// ---------------------------------------------------------------- kernel 1
template <bool SHARD>
__global__ void __launch_bounds__(NT, PYITD_SUMMARY_BLOCKS)
level_summaries_kernel(const float* __restrict__ x, int n, int ntiles, Shard sh,
                       int* __restrict__ fpos, float* __restrict__ fval,
                       int* __restrict__ rpos, float* __restrict__ rval,
                       int* __restrict__ cnt) {
  __shared__ Ends s_we[NWARP];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const int off = SHARD ? sh.offset[row] : 0;
  Chunks ch;
  // the level that follows reads the row again: no streaming hint
  const float edge = load_chunk_values<false>(
      x + (size_t)row * n, n, base, SHARD ? sh.halo_l[row] : 0.f,
      SHARD ? sh.halo_r[row] : 0.f, ch);
  chunk_bits(n, base, off, SHARD ? sh.n_global : n, edge, ch);
  const size_t o = (size_t)row * ntiles + tile;
  tile_summary(ch.v, ch.bits, off + base, s_we, fpos + 2 * o, fval + 2 * o,
               rpos + 2 * o, rval + 2 * o, cnt + o);
}

// ---------------------------------------------------------------- kernel 2
// One tile's summary.  With `edges` (a row of the signal the interior
// summaries were taken from) the summary covers the tile's interior only
// and is completed here with the tile's first and last sample, whose knot
// tests read their neighbours from the row, and on a time shard (`shard`)
// with the shard's last sample: the row starts at position off of a
// signal of ng samples, between the samples hl and hr.
struct TileSum {
  Fwd f;
  Rev r;
  int c;
};

// the sample at t of an edge row as a one-knot state, if it is a knot
__device__ __forceinline__ void add_edge(TileSum& s, float xm1, float x0,
                                         float xp1, int t, int n, int g,
                                         int ng, bool before) {
  if (!knot_at(xm1, x0, xp1, t, n, g, ng)) return;
  if (before) {
    s.f = fwd_combine(Fwd{g, x0, -1, 0.f}, s.f);
    s.r = rev_combine(Rev{g, x0, -1, 0.f}, s.r);
  } else {
    s.f = fwd_combine(s.f, Fwd{g, x0, -1, 0.f});
    s.r = rev_combine(s.r, Rev{g, x0, -1, 0.f});
  }
  s.c += 1;
}

__device__ __forceinline__ TileSum load_summary(
    size_t o, int k, const int* __restrict__ fpos,
    const float* __restrict__ fval, const int* __restrict__ rpos,
    const float* __restrict__ rval, const int* __restrict__ cnt,
    const float* __restrict__ edges, int n, bool shard, int off, int ng,
    float hl, float hr) {
  TileSum s{{fpos[2 * o], fval[2 * o], fpos[2 * o + 1], fval[2 * o + 1]},
            {rpos[2 * o], rval[2 * o], rpos[2 * o + 1], rval[2 * o + 1]},
            cnt[o]};
  if (edges == nullptr) return s;
  // in position order: the first sample, the interior, the shard's last
  // sample inside the tile, the tile's last sample
  const int t0 = k * TILE, t1 = t0 + TILE - 1, tl = n - 1;
  add_edge(s, t0 > 0 ? edges[t0 - 1] : hl, edges[t0],
           t0 + 1 < n ? edges[t0 + 1] : hr, t0, n, off + t0, ng, true);
  if (shard && tl > t0 && tl < t1)
    add_edge(s, edges[tl - 1], edges[tl], hr, tl, n, off + tl, ng, false);
  if (t1 < n)
    add_edge(s, edges[t1 - 1], edges[t1], t1 + 1 < n ? edges[t1 + 1] : hr,
             t1, n, off + t1, ng, false);
  return s;
}

// One block of up to SCAN_NT threads per row.  Thread t owns a contiguous
// run of tiles (one tile each up to SCAN_NT tiles a row): a serial fold of
// its run, a warp-shuffle scan of the thread folds in both directions, the
// warp aggregates through shared memory behind one barrier, then a serial
// re-walk that writes each tile's exclusive prefix / suffix.  The fills only
// select, so any association gives the same bits.  With ftot_pos it also
// writes the row's inclusive totals (the last two and the first two knots
// of the whole row): a time shard's side of the cross-shard fold.  With
// edges and sh.offset the rows are time shards (load_summary).
constexpr int SCAN_NT = 256;

__global__ void __launch_bounds__(SCAN_NT) tile_scan_kernel(
    int ntiles, const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const int* __restrict__ cnt, const float* __restrict__ edges, int n,
    Shard sh, int* __restrict__ fpos_ex, float* __restrict__ fval_ex,
    int* __restrict__ rpos_ex, float* __restrict__ rval_ex,
    int* __restrict__ nex, int* __restrict__ flags,
    int* __restrict__ done, int* __restrict__ reason, int* __restrict__ ncomp,
    int trip, int max_iteration, int* __restrict__ ftot_pos,
    float* __restrict__ ftot_val, int* __restrict__ rtot_pos,
    float* __restrict__ rtot_val) {
  __shared__ Fwd sw_f[SCAN_NT / 32];
  __shared__ Rev sw_r[SCAN_NT / 32];
  __shared__ int sw_c[SCAN_NT / 32];
  const int row = blockIdx.x, tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, w = tid >> 5, nw = nthr >> 5;
  const int per = (ntiles + nthr - 1) / nthr;
  const int k0 = min(tid * per, ntiles), k1 = min(k0 + per, ntiles);
  const size_t rb = (size_t)row * ntiles;
  const float* er = edges == nullptr ? nullptr : edges + (size_t)row * n;
  const bool shard = er != nullptr && sh.offset != nullptr;
  const int off = shard ? sh.offset[row] : 0;
  const int ng = shard ? sh.n_global : n;
  const float hl = shard ? sh.halo_l[row] : 0.f;
  const float hr = shard ? sh.halo_r[row] : 0.f;
  auto summary = [&](int k) {
    return load_summary(rb + k, k, fpos, fval, rpos, rval, cnt, er, n, shard,
                        off, ng, hl, hr);
  };

  Fwd fa = fwd_none();
  Rev ra = rev_none();
  int c = 0;
  for (int k = k0; k < k1; ++k) {
    const TileSum t = summary(k);
    fa = fwd_combine(fa, t.f);
    ra = rev_combine(ra, t.r);
    c += t.c;
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
  c = warp_sum(c);
  if (lane == 31) sw_f[w] = finc;
  if (lane == 0) {
    sw_r[w] = rinc;
    sw_c[w] = c;
  }
  __syncthreads();
  Fwd wpre = fwd_none();  // the warps before this one
  for (int i = 0; i < w; ++i) wpre = fwd_combine(wpre, sw_f[i]);
  Rev wsuf = rev_none();  // the warps after it
  for (int i = nw - 1; i > w; --i) wsuf = rev_combine(sw_r[i], wsuf);
  int total = 0;
  for (int i = 0; i < nw; ++i) total += sw_c[i];

  if (ftot_pos != nullptr) {
    const size_t o = (size_t)row * 2;
    if (tid == nthr - 1) {
      const Fwd t = fwd_combine(wpre, finc);
      ftot_pos[o] = t.p1; ftot_val[o] = t.v1;
      ftot_pos[o + 1] = t.p2; ftot_val[o + 1] = t.v2;
    }
    if (tid == 0) {
      const Rev t = rev_combine(rinc, wsuf);
      rtot_pos[o] = t.q1; rtot_val[o] = t.w1;
      rtot_pos[o + 1] = t.q2; rtot_val[o + 1] = t.w2;
    }
  }
  Fwd facc = shfl_up(finc, 1);
  if (lane == 0) facc = fwd_none();
  facc = fwd_combine(wpre, facc);
  Rev racc = shfl_down(rinc, 1);
  if (lane == 31) racc = rev_none();
  racc = rev_combine(racc, wsuf);

  for (int k = k0; k < k1; ++k) {
    const size_t o = (rb + k) * 2;
    fpos_ex[o] = facc.p1; fval_ex[o] = facc.v1;
    fpos_ex[o + 1] = facc.p2; fval_ex[o + 1] = facc.v2;
    if (k + 1 < k1) facc = fwd_combine(facc, summary(k).f);
  }
  for (int k = k1 - 1; k >= k0; --k) {
    const size_t o = (rb + k) * 2;
    rpos_ex[o] = racc.q1; rval_ex[o] = racc.w1;
    rpos_ex[o + 1] = racc.q2; rval_ex[o + 1] = racc.w2;
    if (k > k0) racc = rev_combine(summary(k).r, racc);
  }

  if (tid == 0) {
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
// the first `count` of four values of an array at index i, zeros after them
__device__ __forceinline__ void load_tail(const float* __restrict__ a, size_t i,
                                          int count, float (&v)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < count ? a[i + q] : 0.f;
}

// STREAM: the next reader is far enough away to find nothing in the cache
template <bool STREAM>
__device__ __forceinline__ void store4(float* __restrict__ a, size_t i,
                                       int count, bool vec,
                                       const float (&v)[4]) {
  if (vec) {
    const float4 t = make_float4(v[0], v[1], v[2], v[3]);
    if (STREAM) __stcs(reinterpret_cast<float4*>(a + i), t);
    else *reinterpret_cast<float4*>(a + i) = t;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < count) a[i + q] = v[q];
  }
}

template <bool BOOK, bool REF_END, bool SHARD, bool EMIT>
__global__ void
__launch_bounds__(NT, BOOK ? PYITD_BOOK_BLOCKS : PYITD_LEVEL_BLOCKS)
sift_level_kernel(
    const float* __restrict__ x, int n, int ntiles, Shard sh,
    const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const int* __restrict__ flags, const float* __restrict__ rotp,
    const float* __restrict__ pbase, const float* __restrict__ perr,
    const float* __restrict__ comp, float* __restrict__ base_out,
    float* __restrict__ rot_out, float* __restrict__ err_out,
    float* __restrict__ row_out, float* __restrict__ comp_out,
    int* __restrict__ ifpos, float* __restrict__ ifval,
    int* __restrict__ irpos, float* __restrict__ irval,
    int* __restrict__ icnt) {
  __shared__ __align__(16) float s_x[TILE];
  __shared__ unsigned s_bits[TILE / 32];
  __shared__ Ends s_we[EMIT ? NWARP : 1];
  // BOOK: three tiles of the previous extraction's outputs
  extern __shared__ __align__(16) float s_in[];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const size_t ro = (size_t)row * n;
  const float* xr = x + ro;
  // the row's first position and the length of the signal it is part of
  const int off = SHARD ? sh.offset[row] : 0;
  const int ng = SHARD ? sh.n_global : n;
  const int gbase = off + base;

  // 128-bit accesses need every array on the row's own 16-byte phase
  uintptr_t ptrs = reinterpret_cast<uintptr_t>(x)
      | reinterpret_cast<uintptr_t>(base_out)
      | reinterpret_cast<uintptr_t>(rot_out)
      | reinterpret_cast<uintptr_t>(err_out);
  if (BOOK)
    ptrs |= reinterpret_cast<uintptr_t>(rotp) | reinterpret_cast<uintptr_t>(pbase)
        | reinterpret_cast<uintptr_t>(perr) | reinterpret_cast<uintptr_t>(comp)
        | reinterpret_cast<uintptr_t>(row_out)
        | reinterpret_cast<uintptr_t>(comp_out);
  const size_t i0 = ro + base + chunk_start(0);
  const bool congruent = (ptrs & 15) == 0 && (i0 & 3) == 0;
  const int fl = BOOK ? flags[row] : 0;
  const bool sa = fl & STOP_A, sb = fl & STOP_B, ct = fl & CONT;

  Chunks ch;
  const float edge = load_chunk_values<true>(
      xr, n, base, SHARD ? sh.halo_l[row] : 0.f, SHARD ? sh.halo_r[row] : 0.f,
      ch);
  if (BOOK) {
    // the previous extraction's outputs start on their way now, into shared
    // memory past the registers, and are read when the baseline is known:
    // the pending rotation (stop A: the previous baseline), its residual,
    // the compensation
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j0 = chunk_start(c);
      if (!congruent || base + j0 + 4 > n) continue;
      const size_t i = i0 + c * CSET;
      if (sa) {
        cp_async16(s_in + j0, pbase + i);
      } else if (ct || sb) {
        cp_async16(s_in + j0, rotp + i);
        cp_async16(s_in + TILE + j0, perr + i);
      }
      cp_async16(s_in + 2 * TILE + j0, comp + i);
    }
  }
  chunk_bits(n, base, off, ng, edge, ch);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    *reinterpret_cast<float4*>(s_x + chunk_start(c)) =
        make_float4(ch.v[c][0], ch.v[c][1], ch.v[c][2], ch.v[c][3]);
  write_bitmap(ch.bits, s_bits);

  const size_t so = ((size_t)row * ntiles + tile) * 2;
  Fwd fseed{fpos[so], fval[so], fpos[so + 1], fval[so + 1]};
  Rev rseed{rpos[so], rval[so], rpos[so + 1], rval[so + 1]};
  if (SHARD) {  // the knots of the shards before / after: farther than any
    const size_t ho = (size_t)row * 2;  // of this shard's, so local ones win
    fseed = fwd_combine(Fwd{sh.pre_pos[ho], sh.pre_val[ho], sh.pre_pos[ho + 1],
                            sh.pre_val[ho + 1]}, fseed);
    rseed = rev_combine(rseed, Rev{sh.suf_pos[ho], sh.suf_val[ho],
                                   sh.suf_pos[ho + 1], sh.suf_val[ho + 1]});
  }
  const float b_first = SHARD ? sh.b_first[row] : 0.5f * (xr[0] + xr[1]);
  const float b_last =
      SHARD ? sh.b_last[row] : 0.5f * (xr[n - 2] + xr[n - 1]);
  __syncthreads();
  const Bitmap bm = read_bitmap(s_bits);

  float bout[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int j0 = chunk_start(c);
    const int t0 = base + j0, g0 = gbase + j0;
    const unsigned nib = ch.bits[c];

    // the last two knots before the chunk: the tile's, then the seed's
    Fwd P = fseed;
    const int a1 = find_prev(bm, j0 - 1);
    if (a1 >= 0) {
      const int a2 = find_prev(bm, a1 - 1);
      P.p2 = P.p1; P.v2 = P.v1;
      if (a2 >= 0) {
        P.p2 = gbase + a2; P.v2 = s_x[a2];
      }
      P.p1 = gbase + a1; P.v1 = s_x[a1];
    }
    // the first two knots after the chunk
    Rev S = rseed;
    const int c1 = find_next(bm, j0 + 4);
    if (c1 >= 0) {
      const int c2 = find_next(bm, c1 + 1);
      S.q2 = S.q1; S.w2 = S.w1;
      if (c2 >= 0) {
        S.q2 = gbase + c2; S.w2 = s_x[c2];
      }
      S.q1 = gbase + c1; S.w1 = s_x[c1];
    }

    // reverse walk: the first two knots strictly after each sample
    int n1p[4], n2p[4];
    float n1x[4], n2x[4];
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      n1p[k] = S.q1; n1x[k] = S.w1; n2p[k] = S.q2; n2x[k] = S.w2;
      if ((nib >> k) & 1u) S = {g0 + k, ch.v[c][k], S.q1, S.w1};
    }

    // forward walk: the last two knots at or before each sample, then the
    // epilogue of _fused_scans_and_epilogue in the order of the gather
    // form.  The knot values and the slope change only where the walk
    // passes a knot.
    float b_l = 0.f, slope = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k;  // index in the row
      const int g = g0 + k;  // position in the signal
      const float xt = ch.v[c][k];
      const bool knot = (nib >> k) & 1u;
      if (knot) P = {g, xt, P.p1, P.v1};
      float b = 0.f;
      if (t < n) {
        if (k == 0 || knot) {
          int q1 = n1p[k];
          float w1 = n1x[k];
          if (g == ng - 1) {  // no knot after: the gather form clips to the end
            q1 = ng - 1;
            w1 = xt;
          }
          if (P.p1 == ng - 1) b_l = b_last;
          else if (P.p1 == 0) b_l = b_first;
          else b_l = knot_value(P.p1, P.v1, P.p2, P.v2, q1, w1);
          const float b_r = (q1 == ng - 1)
              ? b_last : knot_value(q1, w1, P.p1, P.v1, n2p[k], n2x[k]);
          const float den = w1 - P.v1;
          slope = (den == 0.f) ? 0.f : (b_r - b_l) / den;
        }
        b = b_l + slope * (xt - P.v1);
        if (REF_END && g == ng - 1) b = 0.f;
      }
      bout[c][k] = b;
    }
  }

  // outputs, and the sift bookkeeping for the PREVIOUS extraction's outputs
  // (row into rotations[level], compensation), which have been on their way
  // into shared memory since the block began
  bool live[CH], vec[CH];
  int count[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int t0 = base + chunk_start(c);
    live[c] = t0 < n;
    count[c] = min(4, n - t0);
    vec[c] = congruent && count[c] == 4;
  }
  if (BOOK) cp_async_wait();
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    if (!live[c]) continue;
    const size_t i = i0 + c * CSET;
    float r[4], e[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float xx = ch.v[c][k], b = bout[c][k];
      r[k] = xx - b;
      const float bb = r[k] - xx;
      e[k] = (xx - (r[k] - bb)) + ((-b) - bb);
    }
    // the next trip's tile_scan and sift_level read the baseline first
    store4<false>(base_out, i, count[c], vec[c], bout[c]);
    store4<true>(rot_out, i, count[c], vec[c], r);
    store4<true>(err_out, i, count[c], vec[c], e);
    if (BOOK) {
      float rp[4] = {0.f, 0.f, 0.f, 0.f}, pe[4] = {0.f, 0.f, 0.f, 0.f}, cm[4];
      if (vec[c]) {  // this thread's own copies
        const int j0 = chunk_start(c);
        const float4 a = *reinterpret_cast<const float4*>(s_in + j0);
        const float4 b = *reinterpret_cast<const float4*>(s_in + TILE + j0);
        const float4 d = *reinterpret_cast<const float4*>(s_in + 2 * TILE + j0);
        if (sa || ct || sb) { rp[0] = a.x; rp[1] = a.y; rp[2] = a.z; rp[3] = a.w; }
        if (ct || sb) { pe[0] = b.x; pe[1] = b.y; pe[2] = b.z; pe[3] = b.w; }
        cm[0] = d.x; cm[1] = d.y; cm[2] = d.z; cm[3] = d.w;
      } else {
        if (sa) {
          load_tail(pbase, i, count[c], rp);
        } else if (ct || sb) {
          load_tail(rotp, i, count[c], rp);
          load_tail(perr, i, count[c], pe);
        }
        load_tail(comp, i, count[c], cm);
      }
      float rowv[4], co[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // stop A: the previous baseline; stop B: the pending rotation plus
        // x, whose rounding joins the compensation; running: the rotation
        const float xx = ch.v[c][k], p = rp[k];
        const float rs = p + xx;
        const float rbb = rs - p;
        const float res_err = (p - (rs - rbb)) + (xx - rbb);
        rowv[k] = sb ? rs : p;
        co[k] = (cm[k] + pe[k]) + (sb ? res_err : 0.f);
      }
      store4<true>(row_out, i, count[c], vec[c], rowv);
      store4<true>(comp_out, i, count[c], vec[c], co);
    }
  }

  if (EMIT) {
    // the interior summary of the baseline: its knot tests need the
    // neighbour chunks' values, through the shared memory that held x
    __syncthreads();
#pragma unroll
    for (int c = 0; c < CH; ++c)
      *reinterpret_cast<float4*>(s_x + chunk_start(c)) =
          make_float4(bout[c][0], bout[c][1], bout[c][2], bout[c][3]);
    __syncthreads();
    unsigned ibits[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j0 = chunk_start(c);
      const float e[6] = {j0 > 0 ? s_x[j0 - 1] : 0.f, bout[c][0], bout[c][1],
                          bout[c][2], bout[c][3],
                          j0 + 4 < TILE ? s_x[j0 + 4] : 0.f};
      ibits[c] = chunk_knots(e, base + j0, n, gbase + j0, ng);
      if (j0 == 0) ibits[c] &= ~1u;             // the tile's first sample
      if (j0 + 4 == TILE) ibits[c] &= ~8u;      // and its last: tile_scan's
      // and a shard's last, whose right neighbour is the next shard's
      const int q = n - 1 - (base + j0);
      if (SHARD && q >= 0 && q < 4) ibits[c] &= ~(1u << q);
    }
    const size_t o = (size_t)row * ntiles + tile;
    tile_summary(bout, ibits, gbase, s_we, ifpos + 2 * o, ifval + 2 * o,
                 irpos + 2 * o, irval + 2 * o, icnt + o);
  }
}

// the bookkeeping's three staged tiles are dynamic shared memory: with the
// kernel's static 17 KB a block passes the 48 KB a kernel has without asking
constexpr int BOOK_SMEM = 3 * TILE * (int)sizeof(float);

}  // namespace

extern "C" {

int pyitd_tile_size() { return TILE; }

const char* pyitd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// offset == nullptr: whole rows.  Otherwise each row is a time shard that
// starts at offset[row] of a signal of n_global samples, between the samples
// halo_l[row] and halo_r[row].
int pyitd_level_summaries(const float* x, int rows, int n, int ntiles,
                          int n_global, const int* offset, const float* halo_l,
                          const float* halo_r, int* fpos, float* fval,
                          int* rpos, float* rval, int* cnt, void* stream) {
  const dim3 grid(ntiles, rows);
  cudaStream_t s = (cudaStream_t)stream;
  Shard sh{};
  sh.n_global = n_global; sh.offset = offset;
  sh.halo_l = halo_l; sh.halo_r = halo_r;
  if (offset != nullptr)
    level_summaries_kernel<true><<<grid, NT, 0, s>>>(
        x, n, ntiles, sh, fpos, fval, rpos, rval, cnt);
  else
    level_summaries_kernel<false><<<grid, NT, 0, s>>>(
        x, n, ntiles, sh, fpos, fval, rpos, rval, cnt);
  return (int)cudaGetLastError();
}

// edges == nullptr: the summaries are whole tiles'.  Otherwise they cover
// each tile's interior, and edges is the (rows, n) signal they were taken
// from: the tiles' first and last samples are tested here.  With offset
// (edges only) each row is a time shard, as in pyitd_level_summaries, and
// its last sample is tested here too.
int pyitd_tile_scan(int rows, int ntiles, const int* fpos, const float* fval,
                    const int* rpos, const float* rval, const int* cnt,
                    const float* edges, int n, int n_global,
                    const int* offset, const float* halo_l,
                    const float* halo_r, int* fpos_ex, float* fval_ex,
                    int* rpos_ex, float* rval_ex, int* nex, int* flags,
                    int* done, int* reason, int* ncomp, int trip,
                    int max_iteration, int* ftot_pos, float* ftot_val,
                    int* rtot_pos, float* rtot_val, void* stream) {
  const int threads = min(SCAN_NT, 32 * ((ntiles + 31) / 32));
  Shard sh{};
  sh.n_global = n_global; sh.offset = offset;
  sh.halo_l = halo_l; sh.halo_r = halo_r;
  tile_scan_kernel<<<rows, threads, 0, (cudaStream_t)stream>>>(
      ntiles, fpos, fval, rpos, rval, cnt, edges, n, sh, fpos_ex, fval_ex,
      rpos_ex, rval_ex, nex, flags, done, reason, ncomp, trip, max_iteration,
      ftot_pos, ftot_val, rtot_pos, rtot_val);
  return (int)cudaGetLastError();
}

// ifpos != nullptr: also write the interior summaries of the baseline,
// (rows, ntiles, 2) positions and values and (rows, ntiles) counts, for
// pyitd_tile_scan with edges = base (and, for time shards, the shard
// arguments of the next trip).
int pyitd_sift_level(const float* x, int rows, int n, int ntiles,
                     const int* fpos, const float* fval, const int* rpos,
                     const float* rval, const int* flags, const float* rotp,
                     const float* pbase, const float* perr, const float* comp,
                     float* base, float* rot, float* err, float* row_out,
                     float* comp_out, int bookkeeping, int ref_end,
                     int n_global, const int* offset, const float* halo_l,
                     const float* halo_r, const float* b_first,
                     const float* b_last, const int* pre_pos,
                     const float* pre_val, const int* suf_pos,
                     const float* suf_val, int* ifpos, float* ifval,
                     int* irpos, float* irval, int* icnt, void* stream) {
  const dim3 grid(ntiles, rows);
  cudaStream_t s = (cudaStream_t)stream;
  const Shard sh{n_global, offset, halo_l, halo_r, b_first,
                 b_last,   pre_pos, pre_val, suf_pos, suf_val};
#define PYITD_LAUNCH(B, R, S, E)                                             \
  do {                                                                       \
    if (B) {  /* per launch: the attribute belongs to the current device */  \
      const cudaError_t e = cudaFuncSetAttribute(                            \
          sift_level_kernel<B, R, S, E>,                                     \
          cudaFuncAttributeMaxDynamicSharedMemorySize, BOOK_SMEM);           \
      if (e != cudaSuccess) return (int)e;                                   \
    }                                                                        \
    sift_level_kernel<B, R, S, E><<<grid, NT, B ? BOOK_SMEM : 0, s>>>(      \
        x, n, ntiles, sh, fpos, fval, rpos, rval, flags, rotp, pbase, perr, \
        comp, base, rot, err, row_out, comp_out, ifpos, ifval, irpos,       \
        irval, icnt);                                                        \
  } while (0)
#define PYITD_LAUNCH_END(B, S, E)           \
  if (ref_end) PYITD_LAUNCH(B, true, S, E); \
  else PYITD_LAUNCH(B, false, S, E)
#define PYITD_LAUNCH_BOOK(S, E)                           \
  if (bookkeeping) { PYITD_LAUNCH_END(true, S, E); }      \
  else { PYITD_LAUNCH_END(false, S, E); }
  if (offset != nullptr && ifpos != nullptr) {  // time shards
    PYITD_LAUNCH_BOOK(true, true)
  } else if (offset != nullptr) {
    PYITD_LAUNCH_BOOK(true, false)
  } else if (ifpos != nullptr) {
    PYITD_LAUNCH_BOOK(false, true)
  } else {
    PYITD_LAUNCH_BOOK(false, false)
  }
#undef PYITD_LAUNCH_BOOK
#undef PYITD_LAUNCH_END
#undef PYITD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
