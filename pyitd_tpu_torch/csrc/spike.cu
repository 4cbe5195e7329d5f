// The SPIKE local factorization of the cubic tier's moment system (K7)
// and the interface solve that couples its blocks, on Hopper (sm_90a),
// plain C interface.
//
// Replaces: pyitd_tpu/ops/pallas_spike.py::spike_factors_padded (K7,
// kernel body _spike_local_kernel).  Per block of SB cells of the chained
// block-2x2 not-a-knot system (pyitd_tpu/ops/chained_pcr.py) with the
// block's two boundary couplings as extra right-hand sides, it writes the
// particular solution and the left and right spikes (xp1, xp2, vl1, vl2,
// vr1, vr2), as chained_pcr.shard_spike_factors solves them by PCR.
//
// What bounds it: bytes.  Five input channels read (17 bytes a cell) and
// six written (24 bytes a padded cell): about 330 MB at 8 x 1M, 0.098 ms
// at the data sheet's 3.35 TB/s.  Operations, as issued under -fmad=false
// (every multiply and add its own instruction): about 24 a cell for the
// run's sweeps and back-substitution, and about 100 per run per round of
// the reduced solve, (100 log2(SB / R) + 22) / R a cell -- some 127 a cell
// at SB = 2048, R = 8: 1.0 G instructions at 8 x 1M, 2.0 GFLOP of the f32
// peak's multiply-add slots (0.03 ms).
//
// What the design does about it: the partition method.  PCR over all of a
// block's cells (the TPU kernel's way, and this file's before) does
// log2(SB) rounds of twelve shared-memory channels per cell: its traffic
// and arithmetic grow with log2(SB).  Here each thread owns a run of R
// consecutive cells in registers:
//   1. a forward Thomas sweep over the run's marked cells writes each u as
//      u[g] = al[g] + be[g] U + ga[g] w[g+1] (U: the u before the run; an
//      unmarked cell carries the state), and a backward pass of the same
//      form gives the run's first w as o0 + oU U + oW W (W: the w after
//      the run);
//   2. the runs' last u and first w are the unknowns of a reduced system
//      with the interface solve's structure (A has only column 1, C only
//      column 2), three right-hand sides: the data, the left spike (U = 1
//      at the first run), the right spike (W = 1 at the last run).  It is
//      solved by block PCR over the SB / R runs in double-buffered shared
//      memory (14 channels, one barrier a round);
//   3. each thread back-substitutes its run from its neighbours' results
//      and writes the six channels from registers with 128-bit stores.
// The work per cell no longer grows with log2(SB).  What sets the speed is
// overlap, one block's loads under another's sweeps and barriers, so the
// block is small enough for three to share an SM at 80 registers without
// spills: SB = 2048 cells in runs of R = 8, 256 threads.
// SB = 8192 (JAX's block, a four times shorter interface system) leaves
// one block per SM and reads 1.6x to 1.7x slower (tools/cubic_bench.py,
// PERF.md section 6).  Cells at or past the row's n are padding:
// unmarked chain rows, whatever the inputs hold there, so the inputs are
// read unpadded.
//
// Built with -fmad=false and no fast-math; every update is written in the
// order of ops/cuda_cubic.py::spike_factors (its reduced solve
// chained_pcr.interface_pcr) and 1/x is IEEE division, so the kernel
// equals its plain version bit for bit.
//
// The interface solve and the end moments (spike_interface_kernel).
//
// Replaces: no Pallas kernel.  It fuses the XLA glue of JAX's
// _eval_fills_fused between K7 and K8 (pyitd_tpu/ops/cubic_baseline.py:
// 530-567): chained_pcr.reduced_interface_solve over the row's SPIKE
// blocks, the block scalars e_prev, f_next, w_first_next, and the
// not-a-knot end moments m0, m_last from the row's first two and last two
// interior knots.  Its plain version is ops/cuda_cubic.py::
// interface_end_moments, where the same work took about 640 eager ATen
// calls a cubic level.
//
// What bounds it: latency.  A row's work is ceil(log2(nblk)) rounds of a
// 2x2 block PCR, each a barrier and ten channels read from three blocks,
// and the search for the end knots, at most one pass over the row's mask:
// about 1 MB at 32 x 32,768 (0.3 us at 3.35 TB/s), while the edge cells
// of the factors are 36 bytes a block.  One row is one CTA, so the time
// is a chain of dependent loads and barriers, a few microseconds, and no
// byte or operation count comes near it.
//
// What the design does about it: one launch a level in place of the
// eager ops, and nothing on a row's chain that a barrier does not need.
// One CTA a row, one thread a SPIKE block (up to IFACE_MAX_NT threads,
// each owning every IFACE_MAX_NT-th block beyond that), so a round is one
// barrier.  The ten channels live in double-buffered shared memory up to
// IFACE_SMEM_BLOCKS blocks (160 KB), and in a per-row global scratch that
// the wrapper allocates beyond (n up to 2^24, 8,192 blocks).  The end
// knots are found from both ends of the mask in passes of IFACE_SCAN
// bytes a thread that stop once two marks are seen (one barrier a pass,
// then one top-2 reduction): a row with knots reads a few KB of its mask;
// only a row with fewer than two knots reads all of it.  The end moments
// read u at four cells, in _u_at's order.  The PCR follows
// chained_pcr.interface_pcr's order of operations with one right-hand
// side, so it equals its plain version bit for bit, as K7 does.

#include <cuda_runtime.h>
#include <stdint.h>

// SB cells a block, R a run (tools/cubic_bench.py times other values; the
// plain version reads them as cuda_cubic.SPIKE_BLK / SPIKE_RUN)
#ifndef PYITD_SPIKE_SB
#define PYITD_SPIKE_SB 2048
#endif
#ifndef PYITD_SPIKE_RUN
#define PYITD_SPIKE_RUN 8
#endif
#ifndef PYITD_SPIKE_BLOCKS
#define PYITD_SPIKE_BLOCKS 3
#endif

namespace {

constexpr int SB = PYITD_SPIKE_SB;
constexpr int R = PYITD_SPIKE_RUN;
constexpr int NRUN = SB / R;           // runs per block: its threads
constexpr int NCH = 14;                // reduced-system channels
constexpr size_t SMEM = 2ull * NCH * NRUN * sizeof(float);
static_assert(R % 4 == 0 && SB % R == 0, "runs of whole float4s");
static_assert(NRUN % 32 == 0 && NRUN <= 1024, "one run per thread");

// reduced-system channel slots: A (a11, a21), C (c12, c22), B, then the
// three right-hand-side pairs (data, left spike, right spike)
enum { A11, A21, C12, C22, B11, B12, B21, B22, D0 };

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (v == 0.f ? 1.f : v);
}

struct Reduced {
  float v[NCH];
};

__device__ __forceinline__ void put(float* buf, int p, const Reduced& r) {
#pragma unroll
  for (int c = 0; c < NCH; ++c) buf[c * NRUN + p] = r.v[c];
}

// run p's state, or the identity row with zero right-hand sides outside
// the block
__device__ __forceinline__ Reduced get(const float* buf, int p) {
  Reduced r;
  const bool in = p >= 0 && p < NRUN;
#pragma unroll
  for (int c = 0; c < NCH; ++c)
    r.v[c] = in ? buf[c * NRUN + p] : ((c == B11 || c == B22) ? 1.f : 0.f);
  return r;
}

__global__ void __launch_bounds__(NRUN, PYITD_SPIKE_BLOCKS)
spike_factors_kernel(const uint8_t* __restrict__ mask,
                     const float* __restrict__ a, const float* __restrict__ b,
                     const float* __restrict__ c, const float* __restrict__ d,
                     int rows, int n, int npad, float* __restrict__ out) {
  extern __shared__ float sm[];
  const int p = threadIdx.x, blk = blockIdx.x, row = blockIdx.y;
  const int g0 = blk * SB + p * R;
  const size_t i0 = (size_t)row * n + g0;

  // this thread's run: 128-bit loads where it is whole and aligned
  unsigned mb = 0u;
  float av[R], bv[R], cv[R], dv[R];
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a)
      | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(c)
      | reinterpret_cast<uintptr_t>(d);
  if (g0 + R <= n && (ptrs & 15) == 0 && (i0 & 3) == 0
      && (reinterpret_cast<uintptr_t>(mask) & 3) == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const unsigned mw =
          __ldcs(reinterpret_cast<const unsigned*>(mask + i0) + q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((mw >> (8 * k)) & 0xffu) mb |= 1u << (4 * q + k);
      const float4 ta = __ldcs(reinterpret_cast<const float4*>(a + i0) + q);
      const float4 tb = __ldcs(reinterpret_cast<const float4*>(b + i0) + q);
      const float4 tc = __ldcs(reinterpret_cast<const float4*>(c + i0) + q);
      const float4 td = __ldcs(reinterpret_cast<const float4*>(d + i0) + q);
      const int k = 4 * q;
      av[k] = ta.x; av[k + 1] = ta.y; av[k + 2] = ta.z; av[k + 3] = ta.w;
      bv[k] = tb.x; bv[k + 1] = tb.y; bv[k + 2] = tb.z; bv[k + 3] = tb.w;
      cv[k] = tc.x; cv[k + 1] = tc.y; cv[k + 2] = tc.z; cv[k + 3] = tc.w;
      dv[k] = td.x; dv[k + 1] = td.y; dv[k + 2] = td.z; dv[k + 3] = td.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const bool live = g0 + k < n;
      if (live && mask[i0 + k] != 0) mb |= 1u << k;
      av[k] = live ? a[i0 + k] : 0.f;
      bv[k] = live ? b[i0 + k] : 1.f;
      cv[k] = live ? c[i0 + k] : 0.f;
      dv[k] = live ? d[i0 + k] : 0.f;
    }
  }

  // 1. the forward sweep: u[g] = al[g] + be[g] U + ga[g] w[g+1]
  float al[R], be[R], ga[R];
  float A = 0.f, B = 1.f, G = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if ((mb >> k) & 1u) {
      const float inv = safe_inv(bv[k] + av[k] * G);
      A = (dv[k] - av[k] * A) * inv;
      B = (-(av[k] * B)) * inv;
      G = (-cv[k]) * inv;
    }
    al[k] = A; be[k] = B; ga[k] = G;
  }
  // the run's first w = o0 + ou U + ow W
  float o0 = 0.f, ou = 0.f, ow = 1.f;
#pragma unroll
  for (int k = R - 1; k >= 0; --k) {
    if ((mb >> k) & 1u) {
      o0 = al[k] + ga[k] * o0;
      ou = be[k] + ga[k] * ou;
      ow = ga[k] * ow;
    }
  }

  // 2. the reduced system over the block's runs: block PCR
  const bool first = p == 0, last = p == NRUN - 1;
  Reduced s;
  s.v[A11] = first ? 0.f : -B;
  s.v[A21] = first ? 0.f : -ou;
  s.v[C12] = last ? 0.f : -G;
  s.v[C22] = last ? 0.f : -ow;
  s.v[B11] = 1.f; s.v[B12] = 0.f; s.v[B21] = 0.f; s.v[B22] = 1.f;
  s.v[D0] = A; s.v[D0 + 1] = o0;
  s.v[D0 + 2] = first ? B : 0.f; s.v[D0 + 3] = first ? ou : 0.f;
  s.v[D0 + 4] = last ? G : 0.f; s.v[D0 + 5] = last ? ow : 0.f;
  float* cur = sm;
  float* nxt = sm + NCH * NRUN;
  put(cur, p, s);
  __syncthreads();
  for (int st = 1; st < NRUN; st <<= 1) {
    const Reduced m = get(cur, p - st), q = get(cur, p + st);
    const float idetm = safe_inv(m.v[B11] * m.v[B22] - m.v[B12] * m.v[B21]);
    const float e11 = (-(s.v[A11] * m.v[B22])) * idetm;
    const float e12 = (s.v[A11] * m.v[B12]) * idetm;
    const float e21 = (-(s.v[A21] * m.v[B22])) * idetm;
    const float e22 = (s.v[A21] * m.v[B12]) * idetm;
    const float idetp = safe_inv(q.v[B11] * q.v[B22] - q.v[B12] * q.v[B21]);
    const float f11 = (s.v[C12] * q.v[B21]) * idetp;
    const float f12 = (-(s.v[C12] * q.v[B11])) * idetp;
    const float f21 = (s.v[C22] * q.v[B21]) * idetp;
    const float f22 = (-(s.v[C22] * q.v[B11])) * idetp;
    Reduced t;
    t.v[B11] = (s.v[B11] + f11 * q.v[A11]) + f12 * q.v[A21];
    t.v[B12] = (s.v[B12] + e11 * m.v[C12]) + e12 * m.v[C22];
    t.v[B21] = (s.v[B21] + f21 * q.v[A11]) + f22 * q.v[A21];
    t.v[B22] = (s.v[B22] + e21 * m.v[C12]) + e22 * m.v[C22];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int i1 = D0 + 2 * r, i2 = i1 + 1;
      t.v[i1] = (((s.v[i1] + e11 * m.v[i1]) + e12 * m.v[i2]) + f11 * q.v[i1])
          + f12 * q.v[i2];
      t.v[i2] = (((s.v[i2] + e21 * m.v[i1]) + e22 * m.v[i2]) + f21 * q.v[i1])
          + f22 * q.v[i2];
    }
    t.v[A11] = e11 * m.v[A11] + e12 * m.v[A21];
    t.v[A21] = e21 * m.v[A11] + e22 * m.v[A21];
    t.v[C12] = f11 * q.v[C12] + f12 * q.v[C22];
    t.v[C22] = f21 * q.v[C12] + f22 * q.v[C22];
    s = t;
    put(nxt, p, s);
    __syncthreads();
    float* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  // every run's (e, f) for the three right-hand sides, to its neighbours
  // through the buffer no thread reads any more
  const float idet = safe_inv(s.v[B11] * s.v[B22] - s.v[B12] * s.v[B21]);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float d1 = s.v[D0 + 2 * r], d2 = s.v[D0 + 2 * r + 1];
    nxt[(2 * r) * NRUN + p] = (s.v[B22] * d1 - s.v[B12] * d2) * idet;
    nxt[(2 * r + 1) * NRUN + p] = (s.v[B11] * d2 - s.v[B21] * d1) * idet;
  }
  __syncthreads();

  // 3. back-substitution of the run, six channels with 128-bit stores
  const size_t plane = (size_t)rows * npad;
  float* o = out + (size_t)row * npad + g0;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const float U = first ? (r == 1 ? 1.f : 0.f) : nxt[(2 * r) * NRUN + p - 1];
    float w = last ? (r == 2 ? 1.f : 0.f) : nxt[(2 * r + 1) * NRUN + p + 1];
#pragma unroll
    for (int q = R / 4 - 1; q >= 0; --q) {
      float uo[4], wo[4];
#pragma unroll
      for (int j = 3; j >= 0; --j) {
        const int k = 4 * q + j;
        const float u = (r == 0 ? al[k] + be[k] * U : be[k] * U) + ga[k] * w;
        if ((mb >> k) & 1u) w = u;
        uo[j] = u;
        wo[j] = w;
      }
      *reinterpret_cast<float4*>(o + (2 * r) * plane + 4 * q) =
          make_float4(uo[0], uo[1], uo[2], uo[3]);
      *reinterpret_cast<float4*>(o + (2 * r + 1) * plane + 4 * q) =
          make_float4(wo[0], wo[1], wo[2], wo[3]);
    }
  }
}

// ------------------------------------------- the interface solve
constexpr int IFACE_CH = 10;              // the 2x2 block row's channels
constexpr int IFACE_SMEM_BLOCKS = 2048;   // blocks whose state fits in smem
constexpr int IFACE_MIN_NT = 256;         // threads of a CTA: the mask scan
constexpr int IFACE_MAX_NT = 512;         // 128 registers a thread
constexpr int IFACE_SCAN = 16;            // mask bytes a thread and pass

// channel slots of a block's row A X_{p-1} + B X_p + C X_{p+1} = D
enum { IA11, IA21, IC12, IC22, IB11, IB12, IB21, IB22, ID1, ID2 };

struct Iface {
  float v[IFACE_CH];
};

// block p's state, or the identity row with a zero right-hand side
// outside the row
__device__ __forceinline__ Iface iface_get(const float* buf, int nblk,
                                           int p) {
  Iface r;
  if (p >= 0 && p < nblk) {
#pragma unroll
    for (int c = 0; c < IFACE_CH; ++c) r.v[c] = buf[c * nblk + p];
  } else {
#pragma unroll
    for (int c = 0; c < IFACE_CH; ++c)
      r.v[c] = (c == IB11 || c == IB22) ? 1.f : 0.f;
  }
  return r;
}

// (a1, a2) becomes the two smallest (LARGEST: largest) of a1 <= a2 and
// b1 <= b2 (>= for LARGEST); positions are distinct but for the sentinels
template <bool LARGEST>
__device__ __forceinline__ void top2(int& a1, int& a2, int b1, int b2) {
  if (LARGEST ? b1 > a1 : b1 < a1) {
    a2 = LARGEST ? max(a1, b2) : min(a1, b2);
    a1 = b1;
  } else {
    a2 = LARGEST ? max(a2, b1) : min(a2, b1);
  }
}

// the first two (LARGEST: last two) marked positions of the row's mask:
// each thread meets its positions in order, so its first two marks are
// its end's; passes stop once the CTA has seen two.  Sentinel: n (-1).
template <bool LARGEST>
__device__ void end_knots(const uint8_t* __restrict__ m, int n, int* red,
                          int& k1, int& k2) {
  const int nt = blockDim.x, tid = threadIdx.x;
  const int none = LARGEST ? -1 : n;
  k1 = none;
  k2 = none;
  for (int base = 0; base < n; base += nt * IFACE_SCAN) {
    uint8_t mb[IFACE_SCAN];
#pragma unroll
    for (int k = 0; k < IFACE_SCAN; ++k) {
      const int j = base + k * nt + tid;
      mb[k] = j < n ? m[LARGEST ? n - 1 - j : j] : 0;
    }
#pragma unroll
    for (int k = 0; k < IFACE_SCAN; ++k) {
      const int j = base + k * nt + tid;
      if (mb[k] != 0) {
        if (k1 == none) k1 = LARGEST ? n - 1 - j : j;
        else if (k2 == none) k2 = LARGEST ? n - 1 - j : j;
      }
    }
    const int any2 = __syncthreads_or(k2 != none);
    if (any2 || __syncthreads_count(k1 != none) >= 2) break;
  }
  // one top-2 reduction over the CTA: the warps, then the warps' results
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    top2<LARGEST>(k1, k2, __shfl_xor_sync(0xffffffffu, k1, off),
                  __shfl_xor_sync(0xffffffffu, k2, off));
  if (lane == 0) {
    red[warp] = k1;
    red[32 + warp] = k2;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (nt >> 5);
    k1 = in ? red[lane] : none;
    k2 = in ? red[32 + lane] : none;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      top2<LARGEST>(k1, k2, __shfl_xor_sync(0xffffffffu, k1, off),
                    __shfl_xor_sync(0xffffffffu, k2, off));
    if (lane == 0) {
      red[64] = k1;
      red[65] = k2;
    }
  }
  __syncthreads();
  k1 = red[64];
  k2 = red[65];
}

__device__ __forceinline__ float sdiv(float num, float den) {
  return num / (den == 0.f ? 1.f : den);
}

// f: the six SPIKE factor channels, (6, rows, npad); mask (rows, n);
// out: e_prev, f_next, w_first_next, (3, rows, nblk); ends: m0, m_last,
// (2, rows).  SMEM: the state in shared memory, else in scratch (rows,
// 2 IFACE_CH nblk).
template <bool SMEM>
__global__ void __launch_bounds__(IFACE_MAX_NT) spike_interface_kernel(
    const float* __restrict__ f, const uint8_t* __restrict__ mask, int rows,
    int n, int npad, int nblk, float* scratch, float* __restrict__ out,
    float* __restrict__ ends) {
  extern __shared__ float ism[];
  __shared__ int red[66];
  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const size_t plane = (size_t)rows * npad;
  const float* xp1 = f;
  const float* xp2 = f + plane;
  const float* vl1 = f + 2 * plane;
  const float* vl2 = f + 3 * plane;
  const float* vr1 = f + 4 * plane;
  const float* vr2 = f + 5 * plane;
  const size_t ro = (size_t)row * npad;
  float* cur = SMEM ? ism : scratch + (size_t)row * 2 * IFACE_CH * nblk;
  float* nxt = cur + IFACE_CH * nblk;

  // each block's row, with the signs of cuda_cubic.spike_interface: its
  // last cell's u and first cell's w
  for (int p = tid; p < nblk; p += nt) {
    const size_t lo = ro + (size_t)p * SB, hi = lo + SB - 1;
    cur[IA11 * nblk + p] = -vl1[hi];
    cur[IA21 * nblk + p] = -vl2[lo];
    cur[IC12 * nblk + p] = -vr1[hi];
    cur[IC22 * nblk + p] = -vr2[lo];
    cur[IB11 * nblk + p] = 1.f;
    cur[IB12 * nblk + p] = 0.f;
    cur[IB21 * nblk + p] = 0.f;
    cur[IB22 * nblk + p] = 1.f;
    cur[ID1 * nblk + p] = xp1[hi];
    cur[ID2 * nblk + p] = xp2[lo];
  }
  // the end knots, while those stores land
  const uint8_t* m = mask + (size_t)row * n;
  int i1, i2, il1, il2;
  end_knots<false>(m, n, red, i1, i2);
  end_knots<true>(m, n, red, il1, il2);

  // block PCR, chained_pcr.interface_pcr's order of operations
  for (int st = 1; st < nblk; st <<= 1) {
    __syncthreads();
    for (int p = tid; p < nblk; p += nt) {
      const Iface s = iface_get(cur, nblk, p);
      const Iface a = iface_get(cur, nblk, p - st);
      const Iface q = iface_get(cur, nblk, p + st);
      const float idetm =
          safe_inv(a.v[IB11] * a.v[IB22] - a.v[IB12] * a.v[IB21]);
      const float e11 = (-(s.v[IA11] * a.v[IB22])) * idetm;
      const float e12 = (s.v[IA11] * a.v[IB12]) * idetm;
      const float e21 = (-(s.v[IA21] * a.v[IB22])) * idetm;
      const float e22 = (s.v[IA21] * a.v[IB12]) * idetm;
      const float idetp =
          safe_inv(q.v[IB11] * q.v[IB22] - q.v[IB12] * q.v[IB21]);
      const float f11 = (s.v[IC12] * q.v[IB21]) * idetp;
      const float f12 = (-(s.v[IC12] * q.v[IB11])) * idetp;
      const float f21 = (s.v[IC22] * q.v[IB21]) * idetp;
      const float f22 = (-(s.v[IC22] * q.v[IB11])) * idetp;
      float* o = nxt + p;
      o[IB11 * nblk] = (s.v[IB11] + f11 * q.v[IA11]) + f12 * q.v[IA21];
      o[IB12 * nblk] = (s.v[IB12] + e11 * a.v[IC12]) + e12 * a.v[IC22];
      o[IB21 * nblk] = (s.v[IB21] + f21 * q.v[IA11]) + f22 * q.v[IA21];
      o[IB22 * nblk] = (s.v[IB22] + e21 * a.v[IC12]) + e22 * a.v[IC22];
      o[ID1 * nblk] = (((s.v[ID1] + e11 * a.v[ID1]) + e12 * a.v[ID2])
                       + f11 * q.v[ID1]) + f12 * q.v[ID2];
      o[ID2 * nblk] = (((s.v[ID2] + e21 * a.v[ID1]) + e22 * a.v[ID2])
                       + f21 * q.v[ID1]) + f22 * q.v[ID2];
      o[IA11 * nblk] = e11 * a.v[IA11] + e12 * a.v[IA21];
      o[IA21 * nblk] = e21 * a.v[IA11] + e22 * a.v[IA21];
      o[IC12 * nblk] = f11 * q.v[IC12] + f12 * q.v[IC22];
      o[IC22 * nblk] = f21 * q.v[IC12] + f22 * q.v[IC22];
    }
    float* sw = cur;
    cur = nxt;
    nxt = sw;
  }
  // every read of the buffer that nxt now names is done
  __syncthreads();

  // each block's (e, f), into the buffer no thread reads any more
  float* E = nxt;
  float* F = nxt + nblk;
  for (int p = tid; p < nblk; p += nt) {
    const Iface s = iface_get(cur, nblk, p);
    const float idet =
        safe_inv(s.v[IB11] * s.v[IB22] - s.v[IB12] * s.v[IB21]);
    E[p] = (s.v[IB22] * s.v[ID1] - s.v[IB12] * s.v[ID2]) * idet;
    F[p] = (s.v[IB11] * s.v[ID2] - s.v[IB21] * s.v[ID1]) * idet;
  }
  __syncthreads();

  // the block scalars: e_prev, f_next, and the next block's first w
  const size_t bo = (size_t)row * nblk, bplane = (size_t)rows * nblk;
  for (int p = tid; p < nblk; p += nt) {
    out[bo + p] = p > 0 ? E[p - 1] : 0.f;
    out[bplane + bo + p] = p < nblk - 1 ? F[p + 1] : 0.f;
    float wn = 0.f;
    if (p < nblk - 1) {
      const size_t lo = ro + (size_t)(p + 1) * SB;
      const float fn = p + 2 < nblk ? F[p + 2] : 0.f;
      wn = (xp2[lo] + vl2[lo] * E[p]) + vr2[lo] * fn;
    }
    out[2 * bplane + bo + p] = wn;
  }

  // the end moments: cubic_baseline._end_moments on _u_at
  if (tid == 0) {
    auto u_at = [&](int i) {
      const int blk = i / SB;
      const float ep = blk > 0 ? E[blk - 1] : 0.f;
      const float fn = blk < nblk - 1 ? F[blk + 1] : 0.f;
      const size_t o = ro + i;
      return (xp1[o] + vl1[o] * ep) + vr1[o] * fn;
    };
    const bool has_i2 = i2 < n, has_il2 = il2 >= 0;
    if (i1 >= n) i1 = 0;
    if (il1 < 0) il1 = n - 1;
    const float m1 = u_at(i1);
    const float m2 = has_i2 ? u_at(i2) : 0.f;
    const float ml1 = u_at(il1);
    const float ml2 = has_il2 ? u_at(il2) : 0.f;
    const float h0 = (float)i1;
    const float h1 = (float)(has_i2 ? i2 - i1 : n - 1 - i1);
    const float hl = (float)(n - 1 - il1);
    const float hl2 = (float)(has_il2 ? il1 - il2 : il1);
    ends[row] = m1 + sdiv(h0, h1) * (m1 - m2);
    ends[rows + row] = ml1 + sdiv(hl, hl2) * (ml1 - ml2);
  }
}

}  // namespace

extern "C" {

int pyitd_spike_block() { return SB; }

int pyitd_spike_run() { return R; }

int pyitd_spike_factors(const uint8_t* mask, const float* a, const float* b,
                        const float* c, const float* d, int rows, int n,
                        int npad, float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spike_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(npad / SB, rows);
  spike_factors_kernel<<<grid, NRUN, SMEM, (cudaStream_t)stream>>>(
      mask, a, b, c, d, rows, n, npad, out);
  return (int)cudaGetLastError();
}

int pyitd_spike_interface(const float* factors, const uint8_t* mask,
                          int rows, int n, int npad, float* scratch,
                          float* out, float* ends, void* stream) {
  const int nblk = npad / SB;
  const int warps = (nblk + 31) / 32 * 32;
  const int nt = warps < IFACE_MIN_NT ? IFACE_MIN_NT
      : warps > IFACE_MAX_NT ? IFACE_MAX_NT : warps;
  if (nblk > IFACE_SMEM_BLOCKS) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    spike_interface_kernel<false><<<rows, nt, 0, (cudaStream_t)stream>>>(
        factors, mask, rows, n, npad, nblk, scratch, out, ends);
    return (int)cudaGetLastError();
  }
  const size_t smem = 2ull * IFACE_CH * nblk * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spike_interface_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  spike_interface_kernel<true><<<rows, nt, smem, (cudaStream_t)stream>>>(
      factors, mask, rows, n, npad, nblk, nullptr, out, ends);
  return (int)cudaGetLastError();
}

}  // extern "C"
