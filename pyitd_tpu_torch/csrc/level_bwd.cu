// The structural level adjoint's per-sample work on Hopper (sm_90a), plain C
// interface: the three kernels around the adjoint's four scans.
//
// Replaces no TPU kernel: fuses the XLA glue of
// pyitd_tpu/ops/linear_baseline.py::_structural_level_bwd (the adjoint of one
// sift level), which eager PyTorch ran as about 170 kernels a level, each a
// whole pass over the arrays.  A level's adjoint on the kernel route
// (ops/linear_baseline.py::structural_level_bwd) is seven launches:
//   bwd_knots   the knot mask of x (knot.cuh::knot_at) and its one-left
//               shift, the reverse segment sum's flags;
//   fill2 x 2   (fill_segsum.cu) the last two knots at or before each sample
//               and the first two strictly after it;
//   bwd_pre     per sample: the end knots' values, the knot values on either
//               side of the sample's segment (knot.cuh::knot_value), the
//               segment's slope, the four cotangent channels with their
//               non-finite terms dropped, and the direct term of the
//               gradient; in the kernel sift's reverse trip loop it first
//               forms the level's cotangents from the sift's, the rows'
//               stop flags and the next level's input gradient (Trip);
//   segsum x 2  (fill_segsum.cu) the channels summed into the knot sites;
//   bwd_post    per sample: the knot-site sums, the knot-value adjoint and
//               its pushes to the neighbour knots, and the end knots' four
//               additions.  A push lands on a knot from the knots on either
//               side of it: bwd_post gathers the next knot's c_p and the
//               previous knot's c_n, recomputed there from the sums and
//               the fill channels at that knot (the fills already hold both
//               positions), where a segment sum over the knots once did.
//
// What bounds them: bytes.  They do a few dozen flops a sample; the least
// time is every input read once and every output written once: bwd_knots
// reads 4 B a sample and writes 2, bwd_pre reads 48 and writes 20, bwd_post
// reads 29 and writes 4.  In the reverse trip loop bwd_pre reads the carry
// in place of a third cotangent, so 48 again (52 with stored baselines),
// and the next trip's row cotangent only in the chunks of rows that trip
// stopped by STOP_A.  bwd_post's gathers, two a knot, would add up to
// ten scattered loads a knot: each block first computes its own samples'
// pushes into shared memory, and a knot reads its neighbours' there; only a
// neighbour in another block is recomputed from global memory (through L2).
//
// What the design does about it.  The (rows, n) arrays are read as one flat
// array in chunks of 4 consecutive samples, one chunk per thread and
// consecutive lanes on consecutive chunks, so every 128-bit access of a warp
// covers 512 consecutive bytes, straight into registers (ld.cs / st.cs: each
// byte is touched once).  The chunks are shifted by the first input's
// distance from a 16-byte boundary; a chunk at either end of the array, and
// an array not congruent to the first input modulo 16, take scalar
// accesses.  A chunk may hold the end of one row and the start of the next,
// so each sample finds its own row and position.  The knot test's
// neighbours come from the neighbouring lanes by shuffle and, at the warp's
// two ends, by a scalar load; a row's first and last samples are knots
// whatever their neighbours, so a neighbour across the end of a row is
// never used.
//
// Arithmetic: the plain versions' operations in their order
// (ops/cuda_fill.py::bwd_knots, bwd_pre, bwd_post), IEEE division, built with
// -fmad=false like the other kernels, so each kernel equals its plain version
// bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "knot.cuh"

namespace {

constexpr int NT = 256;  // threads per block, one chunk of 4 samples each
constexpr int SPAN = 4 * NT;  // samples per block
constexpr unsigned FULL = 0xffffffffu;

// A thread's chunk: flat positions p .. p + 3 of an array of N samples in
// rows of n, and each sample's row and position in it.
struct Chunk {
  long long p;
  bool whole;  // all four samples inside the array
  bool in[4];
  int row[4], t[4];
};

__device__ __forceinline__ Chunk chunk_of(const void* first, long long N,
                                          int n) {
  // floats from the 16-byte boundary at or before the first input
  const int pad = (int)((reinterpret_cast<uintptr_t>(first) >> 2) & 3);
  Chunk c;
  c.p = 4LL * ((long long)blockIdx.x * NT + threadIdx.x) - pad;
  c.whole = c.p >= 0 && c.p + 4 <= N;
  const long long f0 = c.p < 0 ? 0 : c.p;
  int r, t;
  if (N <= 0x7fffffffLL) {  // a 32-bit division where the array allows
    r = (int)f0 / n;
    t = (int)f0 - r * n;
  } else {
    r = (int)(f0 / n);
    t = (int)(f0 - (long long)r * n);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long f = c.p + q;
    c.in[q] = f >= 0 && f < N;
    c.row[q] = r;
    c.t[q] = t;
    if (f >= 0 && ++t == n) {
      t = 0;
      ++r;
    }
  }
  return c;
}

__device__ __forceinline__ bool aligned(const void* a, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(a) & (bytes - 1)) == 0;
}

// the chunk's four 32-bit words of `a` (0 outside the array)
__device__ __forceinline__ void load4(const void* a, const Chunk& c,
                                      unsigned (&w)[4]) {
  const unsigned* u = static_cast<const unsigned*>(a);
  if (c.whole && aligned(u + c.p, 16)) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(u + c.p));
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = c.in[q] ? u[c.p + q] : 0u;
  }
}

__device__ __forceinline__ void loadf(const float* a, const Chunk& c,
                                      float (&v)[4]) {
  unsigned w[4];
  load4(a, c, w);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = __uint_as_float(w[q]);
}

__device__ __forceinline__ void loadi(const int* a, const Chunk& c,
                                      int (&v)[4]) {
  unsigned w[4];
  load4(a, c, w);
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = (int)w[q];
}

__device__ __forceinline__ void storef(float* a, const Chunk& c,
                                       const float (&v)[4]) {
  if (c.whole && aligned(a + c.p, 16)) {
    __stcs(reinterpret_cast<float4*>(a + c.p),
           make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c.in[q]) a[c.p + q] = v[q];
  }
}

// bit q: the chunk's sample q is marked (any nonzero byte)
__device__ __forceinline__ unsigned load_mask(const uint8_t* a,
                                              const Chunk& c) {
  unsigned bits = 0u;
  if (c.whole && aligned(a + c.p, 4)) {
    unsigned b = __ldcs(reinterpret_cast<const unsigned*>(a + c.p));
    // high bit of every nonzero byte, then the 4 high bits gathered
    b = (((b & 0x7f7f7f7fu) + 0x7f7f7f7fu) | b) & 0x80808080u;
    bits = ((b >> 7) * 0x10204080u) >> 28;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c.in[q] && a[c.p + q]) bits |= 1u << q;
  }
  return bits;
}

// bit q of `bits` as the bool (byte 0 or 1) of the chunk's sample q
__device__ __forceinline__ void store_mask(uint8_t* a, const Chunk& c,
                                           unsigned bits) {
  if (c.whole && aligned(a + c.p, 4)) {
    const unsigned b = (bits & 1u) | ((bits & 2u) << 7) | ((bits & 4u) << 14)
                       | ((bits & 8u) << 21);
    __stcs(reinterpret_cast<unsigned*>(a + c.p), b);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (c.in[q]) a[c.p + q] = (uint8_t)((bits >> q) & 1u);
  }
}

__device__ __forceinline__ float at(const float* a, long long f, long long N) {
  return f >= 0 && f < N ? a[f] : 0.f;
}

// ------------------------------------------------------------- bwd_knots
// the knot mask of x, and f_next[t] = knots[t + 1] (false at a row's last)
__global__ void __launch_bounds__(NT) bwd_knots_kernel(
    const float* __restrict__ x, long long N, int n,
    uint8_t* __restrict__ knots, uint8_t* __restrict__ f_next) {
  const int lane = threadIdx.x & 31;
  const Chunk c = chunk_of(x, N, n);
  // x[p - 1] .. x[p + 5]: the lane before holds x[p - 1], the lane after
  // x[p + 4] and x[p + 5]; the warp's two ends load theirs, issued with
  // the chunk's own load
  const float left = lane == 0 ? at(x, c.p - 1, N) : 0.f;
  const float right = lane == 31 ? at(x, c.p + 4, N) : 0.f;
  const float right2 = lane == 31 ? at(x, c.p + 5, N) : 0.f;
  float m[4];
  loadf(x, c, m);
  float xs[7];
  xs[0] = __shfl_up_sync(FULL, m[3], 1);
  xs[5] = __shfl_down_sync(FULL, m[0], 1);
  xs[6] = __shfl_down_sync(FULL, m[1], 1);
  if (lane == 0) xs[0] = left;
  if (lane == 31) {
    xs[5] = right;
    xs[6] = right2;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) xs[q + 1] = m[q];
  unsigned kb = 0u, fb = 0u;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (c.in[q] && knot_at(xs[q], xs[q + 1], xs[q + 2], c.t[q], n))
      kb |= 1u << q;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if (c.in[q] && c.t[q] != n - 1 && ((kb >> (q + 1)) & 1u)) fb |= 1u << q;
  // the sample after the chunk, in the same row as its last one
  if (c.in[3] && c.t[3] != n - 1
      && knot_at(xs[4], xs[5], xs[6], c.t[3] + 1, n))
    fb |= 8u;
  store_mask(knots, c, kb);
  store_mask(f_next, c, fb);
}

// ---------------------------------------------------------------- bwd_pre

__device__ __forceinline__ float b_first(const float* xrow) {
  return 0.5f * (__ldg(xrow) + __ldg(xrow + 1));
}

__device__ __forceinline__ float b_last(const float* xrow, int n) {
  return 0.5f * (__ldg(xrow + n - 2) + __ldg(xrow + n - 1));
}

// The kernel sift's reverse trip loop (decomp/itd.py::_KernelSift.backward)
// hands level j the sift's output cotangents in place of the level's own:
// g_rot = G_j (row j's), g_base = Gb_j (baseline row j's), g_err = Gc (the
// correction's), any of them null where absent, and these per-row flags and
// extra streams; bwd_pre forms the level's cotangents from them
// (ops/cuda_fill.py::trip_cotangents).  flags null: the cotangents are the
// level's own, as the torch route and a lone level pass them.
struct Trip {
  const int* flags;       // trip j's STOP_A | STOP_B | CONT bits, per row
  const int* flags_next;  // trip j + 1's, null past the last trip
  const float* g_next;    // G_{j+1}, with flags_next
  const float* carry;     // level j + 1's input gradient, null at the last
  const float* g_zero;    // a further term of level 0's zero path
  bool zero;              // level 0: its gradient takes the zero path
};

constexpr int STOP_A = 1, STOP_B = 2, CONT = 4;  // cuda_fill.STOP_A etc.

// the chunk's four samples of `a`, 0 where a is null or no sample needs it
__device__ __forceinline__ void loadf_if(const float* a, bool need,
                                         const Chunk& c, float (&v)[4]) {
  if (a != nullptr && need) {
    loadf(a, c, v);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = 0.f;
  }
}

// The level's output cotangents (GR, GB, GE) of the chunk's samples from the
// sift's, and level 0's zero-path term (ZT), in the order of
// ops/cuda_fill.py::trip_cotangents.  The streams every row reads are loaded
// whatever the rows' flags, so their loads wait for no flag; the next trip's
// row cotangent reaches only the rows that trip stopped by STOP_A, so it is
// read where some sample of the chunk lies in such a row.  Formed before the
// fills are read, so that only the level's cotangents stay live.
__device__ __forceinline__ void trip_cotangents(
    const Trip& T, const float* g_rot, const float* g_base,
    const float* g_err, const Chunk& c, float (&GR)[4], float (&GB)[4],
    float (&GE)[4], float (&ZT)[4]) {
  float G[4], C[4], B[4], CA[4], GN[4], GZ[4];
  int F[4], FN[4];
  loadf_if(g_rot, true, c, G);
  loadf_if(g_err, true, c, C);
  loadf_if(g_base, true, c, B);
  loadf_if(T.carry, true, c, CA);
  loadf_if(T.g_zero, true, c, GZ);
  bool need_n = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    F[q] = c.in[q] ? __ldg(T.flags + c.row[q]) : 0;
    FN[q] = T.flags_next != nullptr && c.in[q]
        ? __ldg(T.flags_next + c.row[q]) : 0;
    need_n |= (FN[q] & STOP_A) != 0;
  }
  loadf_if(T.g_next, need_n, c, GN);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const bool cont = (F[q] & CONT) != 0, stop_b = (F[q] & STOP_B) != 0;
    const float sb = C[q] + (G[q] - C[q]);
    GR[q] = cont ? G[q] : (stop_b ? sb : 0.f);
    GE[q] = (cont || stop_b) ? C[q] : 0.f;
    float gb = stop_b ? sb : 0.f;
    if (T.g_next != nullptr) gb = gb + ((FN[q] & STOP_A) ? GN[q] : 0.f);
    if (g_base != nullptr) gb = gb + (cont ? B[q] : 0.f);
    if (T.carry != nullptr) gb = gb + CA[q];
    GB[q] = gb;
    ZT[q] = 0.f;
    if (T.zero) {
      float z = C[q] + ((F[q] & STOP_A) ? G[q] : 0.f);
      if (T.g_zero != nullptr) z = z + GZ[q];
      ZT[q] = z * 0.f;
    }
  }
}

// SIFT: the cotangents are the kernel sift's (Trip), else the level's own
template <bool SIFT>
__global__ void __launch_bounds__(NT) bwd_pre_kernel(
    const float* __restrict__ x, const float* __restrict__ g_rot,
    const float* __restrict__ g_base, const float* __restrict__ g_err,
    const int* __restrict__ p1p, const float* __restrict__ p1x,
    const int* __restrict__ p2p, const float* __restrict__ p2x,
    const int* __restrict__ n1p, const float* __restrict__ n1x,
    const int* __restrict__ n2p, const float* __restrict__ n2x, long long N,
    int n, bool reference, Trip T, float* __restrict__ a_bl,
    float* __restrict__ a_xl, float* __restrict__ a_br,
    float* __restrict__ a_xr, float* __restrict__ gx) {
  const Chunk c = chunk_of(x, N, n);
  float GR[4], GB[4], GE[4], ZT[4];
  if constexpr (SIFT) {
    trip_cotangents(T, g_rot, g_base, g_err, c, GR, GB, GE, ZT);
  } else {
    loadf(g_rot, c, GR);
    loadf(g_base, c, GB);
    loadf(g_err, c, GE);
  }
  float X[4], P1X[4], P2X[4], N1X[4], N2X[4];
  int P1[4], P2[4], N1[4], N2[4];
  loadf(x, c, X);
  loadi(p1p, c, P1);
  loadf(p1x, c, P1X);
  loadi(p2p, c, P2);
  loadf(p2x, c, P2X);
  loadi(n1p, c, N1);
  loadf(n1x, c, N1X);
  loadi(n2p, c, N2);
  loadf(n2x, c, N2X);
  float obl[4], oxl[4], obr[4], oxr[4], ogx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    obl[q] = oxl[q] = obr[q] = oxr[q] = ogx[q] = 0.f;
    if (!c.in[q]) continue;
    const float* xrow = x + (long long)c.row[q] * n;
    // the knot values at the segment's left and right knots
    float bl = knot_value(P1[q], P1X[q], P2[q], P2X[q], N1[q], N1X[q]);
    if (P1[q] == 0) bl = b_first(xrow);
    if (P1[q] == n - 1) bl = b_last(xrow, n);
    const float br = N1[q] == n - 1
        ? b_last(xrow, n)
        : knot_value(N1[q], N1X[q], P1[q], P1X[q], N2[q], N2X[q]);
    const float xl = P1X[q], xr = N1X[q];
    const float d = xr - xl;
    const bool dz = d == 0.f;
    const float safe = dz ? 1.f : d;
    const float s = dz ? 0.f : (br - bl) / safe;
    // err's coefficients are exactly (+x, -rot, -baseline)
    const float geff_rot = GR[q] - GE[q];
    const float geff_base = GB[q] - GE[q];
    float g_b = geff_base - geff_rot;
    if (reference && c.t[q] == n - 1) g_b = 0.f;
    const float qq = dz ? 0.f : (X[q] - xl) / safe;
    const float coef = dz ? 0.f : (br - bl) / (safe * safe);
    const float abl = g_b * (dz ? 1.f : 1.f - qq);
    const float abr = g_b * qq;
    const float axl = g_b * coef * (X[q] - xr);
    const float axr = -g_b * coef * (X[q] - xl);
    ogx[q] = geff_rot + GE[q] + g_b * s;
    if (SIFT && T.zero) ogx[q] = ogx[q] + ZT[q];
    // the channels drop non-finite terms; the direct term keeps them
    obl[q] = isfinite(abl) ? abl : 0.f;
    oxl[q] = isfinite(axl) ? axl : 0.f;
    obr[q] = isfinite(abr) ? abr : 0.f;
    oxr[q] = isfinite(axr) ? axr : 0.f;
  }
  storef(a_bl, c, obl);
  storef(a_xl, c, oxl);
  storef(a_br, c, obr);
  storef(a_xr, c, oxr);
  storef(gx, c, ogx);
}

// --------------------------------------------------------------- bwd_post

struct Sums {
  const uint8_t* knots;
  const float* sa_bl;  // reverse sums over [t, next knot)
  const float* se_br;  // sums over [previous knot, t)
  const int* p2p;
  const int* n1p;
};

// gkv at flat position f: the sums landing on a knot site, 0 elsewhere
__device__ __forceinline__ float gkv_at(const Sums& S, long long f) {
  return __ldcg(S.knots + f) ? __ldcg(S.sa_bl + f) + __ldcg(S.se_br + f)
                             : 0.f;
}

// The knot-value adjoint's pushes at sample t: gint the interior knot's
// gkv (0 elsewhere), p2 / n1 its previous and next knot; c_p goes to the
// previous knot, c_n to the next
struct Push { float cp, cn; };

__device__ __forceinline__ Push push_of(float gint, int t, int p2, int n1) {
  const float span = (float)(n1 - p2);
  const float w = (float)(t - p2) / (span == 0.f ? 1.f : span);
  return {gint * (0.5f * (1.f - w)), gint * (0.5f * w)};
}

// the pushes at sample u of the row starting at flat position ro,
// recomputed from global memory (a knot outside the block's samples).  The
// fills put u inside the row; a position outside it (positions that are
// not the fills' of this mask) pushes nothing, where the plain version's
// gather refuses it, and reads no memory off the row.
__device__ __forceinline__ Push push_at(const Sums& S, long long ro, int u,
                                        int n) {
  if (u < 0 || u >= n) return {0.f, 0.f};
  const long long f = ro + u;
  const bool k = __ldcg(S.knots + f) != 0;
  const float g = k ? __ldcg(S.sa_bl + f) + __ldcg(S.se_br + f) : 0.f;
  const float gi = (k && u != 0 && u != n - 1) ? g : 0.f;
  return push_of(gi, u, __ldcg(S.p2p + f), __ldcg(S.n1p + f));
}

// shared-memory index i of the block holds sample u of the row
__device__ __forceinline__ bool in_block(long long i, int u, int n) {
  return i >= 0 && i < SPAN && u >= 0 && u < n;
}

__global__ void __launch_bounds__(NT) bwd_post_kernel(
    const uint8_t* __restrict__ knots, const float* __restrict__ gx0,
    const float* __restrict__ sa_bl, const float* __restrict__ sa_xl,
    const float* __restrict__ se_br, const float* __restrict__ se_xr,
    const int* __restrict__ p2p, const int* __restrict__ n1p, long long N,
    int n, float* __restrict__ gx) {
  __shared__ __align__(16) float s_cp[SPAN];
  __shared__ __align__(16) float s_cn[SPAN];
  const Chunk c = chunk_of(gx0, N, n);
  // the block's first sample
  const long long first = c.p - 4 * (long long)threadIdx.x;
  const Sums S{knots, sa_bl, se_br, p2p, n1p};
  const unsigned kb = load_mask(knots, c);
  float G[4], ABL[4], AXL[4], EBR[4], EXR[4];
  int P2[4], N1[4];
  loadf(gx0, c, G);
  loadf(sa_bl, c, ABL);
  loadf(sa_xl, c, AXL);
  loadf(se_br, c, EBR);
  loadf(se_xr, c, EXR);
  loadi(p2p, c, P2);
  loadi(n1p, c, N1);
  // interior knots: kv = 0.5*(x[pe] + w*(x[nx] - x[pe])) + 0.5*x[t]; each
  // sample's pushes, for the knots of the block that gather them
  float gint[4], cp[4], cn[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = c.t[q];
    const bool k = (kb >> q) & 1u;
    const float gkv = k ? ABL[q] + EBR[q] : 0.f;
    gint[q] = (k && t != 0 && t != n - 1) ? gkv : 0.f;
    const Push pu = push_of(gint[q], t, P2[q], N1[q]);
    cp[q] = pu.cp;
    cn[q] = pu.cn;
  }
  reinterpret_cast<float4*>(s_cp)[threadIdx.x] =
      make_float4(cp[0], cp[1], cp[2], cp[3]);
  reinterpret_cast<float4*>(s_cn)[threadIdx.x] =
      make_float4(cn[0], cn[1], cn[2], cn[3]);
  __syncthreads();
  float out[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    out[q] = 0.f;
    if (!c.in[q]) continue;
    const int t = c.t[q];
    const long long ro = (long long)c.row[q] * n;
    const bool k = (kb >> q) & 1u;
    float g = G[q] + (k ? AXL[q] + EXR[q] : 0.f);
    g = g + 0.5f * gint[q];
    // the pushes from the next knot (its c_p) and the previous one (c_n),
    // from shared memory where that knot is one of the block's samples and
    // in the sample's row
    float push = 0.f;
    if (k) {
      float nxt = 0.f, prv = 0.f;
      if (t != n - 1) {
        const long long i = ro + N1[q] - first;
        nxt = in_block(i, N1[q], n) ? s_cp[i] : push_at(S, ro, N1[q], n).cp;
      }
      if (t != 0) {
        const long long i = ro + P2[q] - first;
        prv = in_block(i, P2[q], n) ? s_cn[i] : push_at(S, ro, P2[q], n).cn;
      }
      push = nxt + prv;
    }
    g = g + push;
    // end knots: kv[0] = 0.5*(x[0]+x[1]); kv[n-1] = 0.5*(x[n-2]+x[n-1]),
    // added at 0, 1, n-2, n-1 in that order (they overlap for n < 4)
    if (t <= 1 || t >= n - 2) {
      const float g0 = 0.5f * gkv_at(S, ro);
      const float gl = 0.5f * gkv_at(S, ro + n - 1);
      if (t == 0) g += g0;
      if (t == 1) g += g0;
      if (t == n - 2) g += gl;
      if (t == n - 1) g += gl;
    }
    out[q] = g;
  }
  storef(gx, c, out);
}

// blocks for rows * n samples from `first`'s 16-byte boundary on; 0 if the
// shape is out of range
unsigned blocks_for(const void* first, int rows, int n) {
  if (rows < 1 || n < 2) return 0u;
  const long long pad = (long long)((reinterpret_cast<uintptr_t>(first) >> 2)
                                    & 3);
  const long long chunks = ((long long)rows * n + pad + 3) / 4;
  const long long blocks = (chunks + NT - 1) / NT;
  return blocks > 0x7fffffffLL ? 0u : (unsigned)blocks;
}

}  // namespace

extern "C" {

int pyitd_bwd_knots(const float* x, int rows, int n, uint8_t* knots,
                    uint8_t* f_next, void* stream) {
  const unsigned blocks = blocks_for(x, rows, n);
  if (blocks == 0u) return (int)cudaErrorInvalidValue;
  bwd_knots_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      x, (long long)rows * n, n, knots, f_next);
  return (int)cudaGetLastError();
}

// flags null: g_rot, g_base and g_err are the level's own cotangents, none
// null, and the trip's other pointers are ignored
int pyitd_bwd_pre(const float* x, const float* g_rot, const float* g_base,
                  const float* g_err, const int* p1p, const float* p1x,
                  const int* p2p, const float* p2x, const int* n1p,
                  const float* n1x, const int* n2p, const float* n2x,
                  int rows, int n, int reference, const int* flags,
                  const int* flags_next, const float* g_next,
                  const float* carry, const float* g_zero, int zero,
                  float* a_bl, float* a_xl, float* a_br, float* a_xr,
                  float* gx, void* stream) {
  const unsigned blocks = blocks_for(x, rows, n);
  if (blocks == 0u) return (int)cudaErrorInvalidValue;
  const bool sift = flags != nullptr;
  if (!sift && (g_rot == nullptr || g_base == nullptr || g_err == nullptr))
    return (int)cudaErrorInvalidValue;
  if (sift && (flags_next == nullptr) != (g_next == nullptr))
    return (int)cudaErrorInvalidValue;
  const Trip T{flags, flags_next, g_next, carry, g_zero, zero != 0};
  const auto kernel = sift ? bwd_pre_kernel<true> : bwd_pre_kernel<false>;
  kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      x, g_rot, g_base, g_err, p1p, p1x, p2p, p2x, n1p, n1x, n2p, n2x,
      (long long)rows * n, n, reference != 0, T, a_bl, a_xl, a_br, a_xr, gx);
  return (int)cudaGetLastError();
}

int pyitd_bwd_post(const uint8_t* knots, const float* gx0,
                   const float* sa_bl, const float* sa_xl, const float* se_br,
                   const float* se_xr, const int* p2p, const int* n1p,
                   int rows, int n, float* gx, void* stream) {
  const unsigned blocks = blocks_for(gx0, rows, n);
  if (blocks == 0u) return (int)cudaErrorInvalidValue;
  bwd_post_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
      knots, gx0, sa_bl, sa_xl, se_br, se_xr, p2p, n1p, (long long)rows * n,
      n, gx);
  return (int)cudaGetLastError();
}

}  // extern "C"
