// The cubic-spline baseline tier on Hopper (sm_90a), plain C interface:
// the knot-value and neighbor fills around the moment solve, and the fused
// back-substitution + spline evaluation after it.  The solve's local
// factorization is csrc/spike.cu.
//
// Replaces:
//   K5 pyitd_tpu/ops/pallas_fill.py::cubic_ksite_padded
//      (_make_cubic_ksite_kernel): knot mask of x, forward last-two-knot
//      fill, reverse strictly-next knot, the Frei-Osorio knot value k_site
//      at every sample with the odd-reflection end values;
//   K6 pallas_fill.py::cubic_neighbors_padded (_make_cubic_neighbors_
//      kernel): per sample the last two knots at or before it and the
//      strictly-next knot, positions and k_site values;
//   K8 pyitd_tpu/ops/pallas_spike.py::spike_backsub_eval
//      (_make_spike_eval_kernel): u = xp1 + vl1 e_prev + vr1 f_next, the
//      next sample's w, the end-moment and final-sample patches, the
//      closed-form moment spline, the pass-through guard.
//
// What bounds them: bytes.  At 8 x 1M f32: K5 reads x and writes k_site
// (64 MB, 0.019 ms at the data sheet's 3.35 TB/s); K6 reads x and k_site
// and writes six channels (256 MB, 0.076 ms); K8 reads thirteen channels
// and writes two (480 MB, 0.143 ms).  A few dozen flops per sample.
//
// What the design does about it.  The TPU kernels walk each row's blocks in
// reverse and carry the suffix in SMEM, with forward seeds from an XLA
// fold; a GPU runs blocks in no order, so K5 and K6 are seeded in both
// directions by the sift's own pre-pass (level_summaries + tile_scan of
// csrc/sift_level.cu, which knows the same knot mask): the last two knots
// before each tile and the first two after it.  K5 takes those seeds with
// their x values; K6 takes the same positions and reads their k_site
// values itself, so no second summary pass runs over the signal.  K5 works
// as sift_level does (tile_fill.cuh's chunk layout): 128-bit loads of the
// tile straight into registers, x in shared memory for the knot values,
// the knot bits as a bitmap behind ONE barrier, and per chunk of four the
// two knots before it and the first after it by bit searches
// (find_prev / find_next; the tile's seeds where it has none), then
// 128-bit stores of k_site from registers.  K6 stages the tile once, scans
// it with tile_fill.cuh's block scans, and writes each output channel
// through shared memory in one coalesced pass.  K8 is
// one thread per sample: the thirteen reads are coalesced, the next
// sample's three spike channels come from the same cache lines, and the
// block scalars of the interface solve are two loads per thread.
//
// Built with -fmad=false and no fast-math: every formula rounds as
// PyTorch's eager elementwise kernels do, in the order of the plain
// versions in ops/cuda_cubic.py, so kernel and plain agree bit for bit.
// The h^2/6 factor is (h*h) * (1/6 in f32): PyTorch's CUDA division by a
// host scalar multiplies by its reciprocal, and the plain version spells
// that out.

#include "tile_fill.cuh"

namespace {

constexpr float SIXTH = 1.0f / 6.0f;

// one 32-bit channel of this thread's run, written coalesced through `s`
__device__ __forceinline__ void store_run(const unsigned (&v)[SPT],
                                          unsigned* s,
                                          unsigned* __restrict__ out_row,
                                          int base, int n) {
  const int j0 = threadIdx.x * SPT;
#pragma unroll
  for (int k = 0; k < SPT; ++k) s[padi(j0 + k)] = v[k];
  __syncthreads();
  for (int j = threadIdx.x; j < TILE; j += NT) {
    const int t = base + j;
    if (t >= n) break;
    out_row[t] = s[padi(j)];
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K5
// Blocks of NT threads the compiler leaves registers for on one SM
// (tools/cubic_bench.py times other values).
#ifndef PYITD_KSITE_BLOCKS
#define PYITD_KSITE_BLOCKS 3
#endif

__global__ void __launch_bounds__(NT, PYITD_KSITE_BLOCKS) cubic_ksite_kernel(
    const float* __restrict__ x, int n, int ntiles,
    const int* __restrict__ fpos, const float* __restrict__ fval,
    const int* __restrict__ rpos, const float* __restrict__ rval,
    const float* __restrict__ b_first, const float* __restrict__ b_last,
    float* __restrict__ k_out) {
  __shared__ __align__(16) float s_x[TILE];
  __shared__ unsigned s_bits[TILE / 32];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const size_t ro = (size_t)row * n;
  const float* xr = x + ro;

  // K6 reads x again next: no streaming hint
  Chunks ch;
  const float edge = load_chunk_values<false>(xr, n, base, 0.f, 0.f, ch);
  chunk_bits(n, base, 0, n, edge, ch);
#pragma unroll
  for (int c = 0; c < CH; ++c)
    *reinterpret_cast<float4*>(s_x + chunk_start(c)) =
        make_float4(ch.v[c][0], ch.v[c][1], ch.v[c][2], ch.v[c][3]);
  write_bitmap(ch.bits, s_bits);
  const size_t so = ((size_t)row * ntiles + tile) * 2;
  const Fwd fseed{fpos[so], fval[so], fpos[so + 1], fval[so + 1]};
  const int rq = rpos[so];
  const float rw = rval[so];
  const float bf = b_first[row], bl = b_last[row];
  const size_t i0 = ro + base + chunk_start(0);
  const bool congruent = ((reinterpret_cast<uintptr_t>(x)
                           | reinterpret_cast<uintptr_t>(k_out)) & 15) == 0
      && (i0 & 3) == 0;
  __syncthreads();
  const Bitmap bm = read_bitmap(s_bits);

#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int j0 = chunk_start(c);
    const int t0 = base + j0;
    const unsigned nib = ch.bits[c];

    // the last two knots before the chunk: the tile's, then the seed's
    Fwd P = fseed;
    const int a1 = find_prev(bm, j0 - 1);
    if (a1 >= 0) {
      const int a2 = find_prev(bm, a1 - 1);
      P.p2 = P.p1; P.v2 = P.v1;
      if (a2 >= 0) {
        P.p2 = base + a2; P.v2 = s_x[a2];
      }
      P.p1 = base + a1; P.v1 = s_x[a1];
    }
    // the first knot after the chunk
    int q = rq;
    float qv = rw;
    const int c1 = find_next(bm, j0 + 4);
    if (c1 >= 0) {
      q = base + c1; qv = s_x[c1];
    }
    // reverse walk: the first knot strictly after each sample
    int n1p[4];
    float n1x[4];
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      n1p[k] = q; n1x[k] = qv;
      if ((nib >> k) & 1u) {
        q = t0 + k; qv = ch.v[c][k];
      }
    }
    // forward walk: the knot before the latest at or before each sample,
    // and the Frei-Osorio value over it and the next knot (no knot: 0)
    float kv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + k;
      if ((nib >> k) & 1u) P = {t, ch.v[c][k], P.p1, P.v1};
      const bool h2 = P.p2 >= 0, h1 = n1p[k] >= 0;
      float v = knot_value(t, ch.v[c][k], h2 ? P.p2 : 0, h2 ? P.v2 : 0.f,
                           h1 ? n1p[k] : 0, h1 ? n1x[k] : 0.f);
      if (t == 0) v = bf;
      if (t == n - 1) v = bl;
      kv[k] = v;
    }
    if (t0 >= n) continue;
    float* dst = k_out + i0 + c * CSET;
    if (congruent && t0 + 4 <= n) {
      *reinterpret_cast<float4*>(dst) = make_float4(kv[0], kv[1], kv[2], kv[3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (t0 + k < n) dst[k] = kv[k];
    }
  }
}

// ---------------------------------------------------------------- K6
__global__ void __launch_bounds__(NT) cubic_neighbors_kernel(
    const float* __restrict__ x, const float* __restrict__ ks, int n,
    int ntiles, const int* __restrict__ fpos, const int* __restrict__ rpos,
    int* __restrict__ p1p, int* __restrict__ p2p, int* __restrict__ n1p,
    float* __restrict__ kj, float* __restrict__ kjm1,
    float* __restrict__ kj1) {
  __shared__ float s_x[SX_LEN];
  __shared__ unsigned s_w[SB_LEN];
  __shared__ Fwd sw_f[NWARP];
  __shared__ Rev sw_r[NWARP];
  const int tile = blockIdx.x, row = blockIdx.y, base = tile * TILE;
  const size_t ro = (size_t)row * n;
  stage_tile(x + ro, n, base, s_x);
  __syncthreads();

  // knot bits from x, then the run's values replaced by k_site
  Run run;
  load_bits(s_x, n, base, run);
  __syncthreads();
  for (int j = threadIdx.x; j < TILE; j += NT) {
    const int t = base + j;
    s_x[padi(j)] = t < n ? ks[ro + t] : 0.f;
  }
  __syncthreads();
  const int j0 = threadIdx.x * SPT;
#pragma unroll
  for (int k = 0; k < SPT; ++k) run.xv[k] = s_x[padi(j0 + k)];
  run_states(base, run);

  // the seeds' positions are the sift pre-pass's; their values are k_site
  const size_t so = ((size_t)row * ntiles + tile) * 2;
  const int sp1 = fpos[so], sp2 = fpos[so + 1], sq1 = rpos[so];
  const Fwd fseed{sp1, sp1 >= 0 ? ks[ro + sp1] : 0.f,
                  sp2, sp2 >= 0 ? ks[ro + sp2] : 0.f};
  const Rev rseed{sq1, sq1 >= 0 ? ks[ro + sq1] : 0.f, -1, 0.f};
  const Fwd fex = block_excl_fwd(run.f, fseed, sw_f);
  const Rev rex = block_excl_rev(run.r, rseed, sw_r);

  unsigned a1[SPT], a2[SPT], a3[SPT], a4[SPT], a5[SPT], a6[SPT];
  Rev S = rex;
#pragma unroll
  for (int k = SPT - 1; k >= 0; --k) {
    const bool h = S.q1 >= 0;
    a3[k] = (unsigned)(h ? S.q1 : 0);
    a6[k] = __float_as_uint(h ? S.w1 : 0.f);
    if ((run.bits >> k) & 1u) S = {base + j0 + k, run.xv[k], S.q1, S.w1};
  }
  Fwd P = fex;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    if ((run.bits >> k) & 1u) P = {base + j0 + k, run.xv[k], P.p1, P.v1};
    const bool h1 = P.p1 >= 0, h2 = P.p2 >= 0;
    a1[k] = (unsigned)(h1 ? P.p1 : 0);
    a4[k] = __float_as_uint(h1 ? P.v1 : 0.f);
    a2[k] = (unsigned)(h2 ? P.p2 : 0);
    a5[k] = __float_as_uint(h2 ? P.v2 : 0.f);
  }
  store_run(a1, s_w, reinterpret_cast<unsigned*>(p1p + ro), base, n);
  store_run(a2, s_w, reinterpret_cast<unsigned*>(p2p + ro), base, n);
  store_run(a3, s_w, reinterpret_cast<unsigned*>(n1p + ro), base, n);
  store_run(a4, s_w, reinterpret_cast<unsigned*>(kj + ro), base, n);
  store_run(a5, s_w, reinterpret_cast<unsigned*>(kjm1 + ro), base, n);
  store_run(a6, s_w, reinterpret_cast<unsigned*>(kj1 + ro), base, n);
}

// ---------------------------------------------------------------- K8
constexpr int EVAL_NT = 256;

// f: the six SPIKE factor channels, (6, rows, npad); per (row, SPIKE
// block) scalars ep, fn, wn; per row m0, ml, bl, pass
__global__ void __launch_bounds__(EVAL_NT) spike_backsub_eval_kernel(
    const float* __restrict__ f, int rows, int n, int npad, int nblk, int sb,
    const float* __restrict__ ep, const float* __restrict__ fn,
    const float* __restrict__ wn, const float* __restrict__ m0,
    const float* __restrict__ ml, const float* __restrict__ bl,
    const int* __restrict__ pass, const int* __restrict__ p1p,
    const int* __restrict__ p2p, const int* __restrict__ n1p,
    const float* __restrict__ kj, const float* __restrict__ kjm1,
    const float* __restrict__ kj1, const float* __restrict__ x,
    float* __restrict__ base_out, float* __restrict__ rot_out) {
  const int row = blockIdx.y;
  const int t = blockIdx.x * EVAL_NT + threadIdx.x;
  if (t >= n) return;
  const size_t plane = (size_t)rows * npad;
  const float* xp1 = f;
  const float* xp2 = f + plane;
  const float* vl1 = f + 2 * plane;
  const float* vl2 = f + 3 * plane;
  const float* vr1 = f + 4 * plane;
  const float* vr2 = f + 5 * plane;
  const int blk = t / sb;
  const size_t bo = (size_t)row * nblk + blk;
  const float e = ep[bo], fv = fn[bo];
  const size_t fo = (size_t)row * npad + t;
  const size_t so = (size_t)row * n + t;

  // the moment of the knot at or before t, and w at the next sample (the
  // next SPIKE block's first w at a block's last cell)
  const float u = (xp1[fo] + vl1[fo] * e) + vr1[fo] * fv;
  const float w_next = ((t + 1) % sb != 0)
      ? (xp2[fo + 1] + vl2[fo + 1] * e) + vr2[fo + 1] * fv : wn[bo];

  const int p1 = p1p[so], p2 = p2p[so], q1 = n1p[so];
  const float m_last = ml[row];
  const float m_j = (p1 == 0) ? m0[row] : u;
  float m_j1 = (q1 == n - 1) ? m_last : w_next;
  const bool last = t == n - 1;
  if (last) m_j1 = m_last;
  const int pos_j = last ? p2 : p1;
  const float k_j = last ? kjm1[so] : kj[so];
  const float k_j1 = last ? bl[row] : kj1[so];
  const int right = last ? t : q1;

  const float h = (float)(right - pos_j);
  const float hs = (h == 0.f) ? 1.f : h;
  const float s = (float)(t - pos_j) / hs;
  const float omt = 1.f - s;
  const float lin = omt * k_j + s * k_j1;
  const float cub = (omt * omt * omt - omt) * m_j + (s * s * s - s) * m_j1;
  const float xv = x[so];
  float b = lin + ((h * h) * SIXTH) * cub;
  if (pass[row] != 0) b = xv;
  base_out[so] = b;
  rot_out[so] = xv - b;
}

}  // namespace

extern "C" {

int pyitd_cubic_ksite(const float* x, int rows, int n, int ntiles,
                      const int* fpos, const float* fval, const int* rpos,
                      const float* rval, const float* b_first,
                      const float* b_last, float* k_out, void* stream) {
  const dim3 grid(ntiles, rows);
  cubic_ksite_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, n, ntiles, fpos, fval, rpos, rval, b_first, b_last, k_out);
  return (int)cudaGetLastError();
}

int pyitd_cubic_neighbors(const float* x, const float* ks, int rows, int n,
                          int ntiles, const int* fpos, const int* rpos,
                          int* p1p, int* p2p, int* n1p, float* kj,
                          float* kjm1, float* kj1, void* stream) {
  const dim3 grid(ntiles, rows);
  cubic_neighbors_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      x, ks, n, ntiles, fpos, rpos, p1p, p2p, n1p, kj, kjm1, kj1);
  return (int)cudaGetLastError();
}

int pyitd_spike_backsub_eval(const float* factors, int rows, int n, int npad,
                             int nblk, int sb, const float* e_prev,
                             const float* f_next, const float* w_first_next,
                             const float* m0, const float* m_last,
                             const float* b_last, const int* passthrough,
                             const int* p1p, const int* p2p, const int* n1p,
                             const float* kj, const float* kjm1,
                             const float* kj1, const float* x, float* base,
                             float* rot, void* stream) {
  const dim3 grid((n + EVAL_NT - 1) / EVAL_NT, rows);
  spike_backsub_eval_kernel<<<grid, EVAL_NT, 0, (cudaStream_t)stream>>>(
      factors, rows, n, npad, nblk, sb, e_prev, f_next, w_first_next, m0,
      m_last, b_last, passthrough, p1p, p2p, n1p, kj, kjm1, kj1, x, base,
      rot);
  return (int)cudaGetLastError();
}

}  // extern "C"
