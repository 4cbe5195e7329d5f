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

// The tile-local fills (staging, knot bits, block scans) live in
// tile_fill.cuh, shared with the cubic tier's kernels in cubic.cu.
#include "tile_fill.cuh"

namespace {

constexpr int STOP_A = 1, STOP_B = 2, CONT = 4;

// ---------------------------------------------------------------- kernel 1
template <bool SHARD>
__global__ void __launch_bounds__(NT) level_summaries_kernel(
    const float* __restrict__ x, int n, int ntiles, Shard sh,
    int* __restrict__ fpos, float* __restrict__ fval, int* __restrict__ rpos,
    float* __restrict__ rval, int* __restrict__ cnt) {
  __shared__ float s_x[SX_LEN];
  __shared__ Fwd sw_f[NWARP];
  __shared__ Rev sw_r[NWARP];
  __shared__ int s_cnt[NWARP];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const int off = SHARD ? sh.offset[row] : 0;
  if (SHARD)
    stage_tile(x + (size_t)row * n, n, base, s_x, sh.halo_l[row],
               sh.halo_r[row]);
  else
    stage_tile(x + (size_t)row * n, n, base, s_x);
  __syncthreads();
  Run run;
  load_run(s_x, n, base, run, off, SHARD ? sh.n_global : n);
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
// re-walk that writes each tile's exclusive prefix / suffix.  With ftot_pos
// it also writes the row's inclusive totals (the last two and the first two
// knots of the whole row): a time shard's side of the cross-shard fold.
__global__ void tile_scan_kernel(
    int ntiles, const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const int* __restrict__ cnt, int* __restrict__ fpos_ex,
    float* __restrict__ fval_ex, int* __restrict__ rpos_ex,
    float* __restrict__ rval_ex, int* __restrict__ nex, int* __restrict__ flags,
    int* __restrict__ done, int* __restrict__ reason, int* __restrict__ ncomp,
    int trip, int max_iteration, int* __restrict__ ftot_pos,
    float* __restrict__ ftot_val, int* __restrict__ rtot_pos,
    float* __restrict__ rtot_val) {
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
  if (ftot_pos != nullptr) {
    const size_t o = (size_t)row * 2;
    if (lane == 31) {
      ftot_pos[o] = finc.p1; ftot_val[o] = finc.v1;
      ftot_pos[o + 1] = finc.p2; ftot_val[o + 1] = finc.v2;
    }
    if (lane == 0) {
      rtot_pos[o] = rinc.q1; rtot_val[o] = rinc.w1;
      rtot_pos[o + 1] = rinc.q2; rtot_val[o + 1] = rinc.w2;
    }
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
template <bool BOOK, bool REF_END, bool SHARD>
__global__ void __launch_bounds__(NT) sift_level_kernel(
    const float* __restrict__ x, int n, int ntiles, Shard sh,
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
  // the row's first position and the length of the signal it is part of
  const int off = SHARD ? sh.offset[row] : 0;
  const int ng = SHARD ? sh.n_global : n;
  const int gbase = off + base;
  if (SHARD) stage_tile(xr, n, base, s_x, sh.halo_l[row], sh.halo_r[row]);
  else stage_tile(xr, n, base, s_x);
  __syncthreads();

  Run run;
  load_run(s_x, n, base, run, off, ng);
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
    if ((run.bits >> k) & 1u) S = {gbase + j0 + k, run.xv[k], S.q1, S.w1};
  }

  const float b_first = SHARD ? sh.b_first[row] : 0.5f * (xr[0] + xr[1]);
  const float b_last =
      SHARD ? sh.b_last[row] : 0.5f * (xr[n - 2] + xr[n - 1]);
  // forward walk: the last two knots at or before each sample, then the
  // epilogue of _fused_scans_and_epilogue in the order of the gather form
  Fwd P = fex;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    const int t = base + j0 + k;  // index in the row
    const int g = gbase + j0 + k;  // position in the signal
    const float xt = run.xv[k];
    if ((run.bits >> k) & 1u) P = {g, xt, P.p1, P.v1};
    float b = 0.f;
    if (t < n) {
      int q1 = n1p[k];
      float w1 = n1x[k];
      if (g == ng - 1) {  // no knot after: the gather form clips to the end
        q1 = ng - 1;
        w1 = xt;
      }
      float b_l;
      if (P.p1 == ng - 1) b_l = b_last;
      else if (P.p1 == 0) b_l = b_first;
      else b_l = knot_value(P.p1, P.v1, P.p2, P.v2, q1, w1);
      const float b_r = (q1 == ng - 1)
          ? b_last : knot_value(q1, w1, P.p1, P.v1, n2p[k], n2x[k]);
      const float den = w1 - P.v1;
      const float slope = (den == 0.f) ? 0.f : (b_r - b_l) / den;
      b = b_l + slope * (xt - P.v1);
      if (REF_END && g == ng - 1) b = 0.f;
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

int pyitd_tile_scan(int rows, int ntiles, const int* fpos, const float* fval,
                    const int* rpos, const float* rval, const int* cnt,
                    int* fpos_ex, float* fval_ex, int* rpos_ex, float* rval_ex,
                    int* nex, int* flags, int* done, int* reason, int* ncomp,
                    int trip, int max_iteration, int* ftot_pos,
                    float* ftot_val, int* rtot_pos, float* rtot_val,
                    void* stream) {
  tile_scan_kernel<<<rows, 32, 0, (cudaStream_t)stream>>>(
      ntiles, fpos, fval, rpos, rval, cnt, fpos_ex, fval_ex, rpos_ex, rval_ex,
      nex, flags, done, reason, ncomp, trip, max_iteration, ftot_pos,
      ftot_val, rtot_pos, rtot_val);
  return (int)cudaGetLastError();
}

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
                     const float* suf_val, void* stream) {
  const dim3 grid(ntiles, rows);
  cudaStream_t s = (cudaStream_t)stream;
  const Shard sh{n_global, offset, halo_l, halo_r, b_first,
                 b_last,   pre_pos, pre_val, suf_pos, suf_val};
#define PYITD_LAUNCH(B, R, S)                                                \
  sift_level_kernel<B, R, S><<<grid, NT, 0, s>>>(                           \
      x, n, ntiles, sh, fpos, fval, rpos, rval, flags, rotp, pbase, perr,   \
      comp, base, rot, err, row_out, comp_out)
#define PYITD_LAUNCH_END(B, S)           \
  if (ref_end) PYITD_LAUNCH(B, true, S); \
  else PYITD_LAUNCH(B, false, S)
  if (offset != nullptr) {  // time shards
    if (bookkeeping) { PYITD_LAUNCH_END(true, true); }
    else { PYITD_LAUNCH_END(false, true); }
  } else {
    if (bookkeeping) { PYITD_LAUNCH_END(true, false); }
    else { PYITD_LAUNCH_END(false, false); }
  }
#undef PYITD_LAUNCH_END
#undef PYITD_LAUNCH
  return (int)cudaGetLastError();
}

}  // extern "C"
