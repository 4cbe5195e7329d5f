// The SPIKE local factorization of the cubic tier's moment system on
// Hopper (sm_90a), plain C interface.
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

}  // extern "C"
