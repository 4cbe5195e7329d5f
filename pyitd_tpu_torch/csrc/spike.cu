// The SPIKE local factorization of the cubic tier's moment system on
// Hopper (sm_90a), plain C interface.
//
// Replaces: pyitd_tpu/ops/pallas_spike.py::spike_factors_padded (K7,
// kernel body _spike_local_kernel).  Per block of cells of the chained
// block-2x2 not-a-knot system (pyitd_tpu/ops/chained_pcr.py): the block's
// two boundary couplings move to extra right-hand sides and the block is
// solved for all three by chained block PCR; it writes the particular
// solution and the left and right spikes (xp1, xp2, vl1, vl2, vr1, vr2).
//
// What bounds it.  Bytes: five input channels read and six written, 352 MB
// at 8 x 1M (0.105 ms at the data sheet's 3.35 TB/s).  Operations: about
// 60 f32 flops per cell per round, 11 rounds at this block size, about
// 5.4 GFLOP at 8 x 1M (0.08 ms at 67 TFLOP/s).  In practice shared-memory
// traffic: each round reads every channel at three cells and writes it
// once.
//
// What the design does about it.  The TPU block is 8192 cells with twelve
// live f32 channels in VMEM (384 KB).  A Hopper block has at most 227 KB
// of shared memory, so the block here is SB = 2048 cells: the twelve
// channels, double-buffered (one buffer read, the other written each
// round), take 192 KB, one block per SM with 1024 threads, two cells per
// thread per round.  The interface system grows to (rows, n / 2048) and
// stays a torch solve (chained_pcr.reduced_interface_solve).  Cells at or
// past the row's n are padding: unmarked chain rows, whatever the inputs
// hold there, so the inputs are read unpadded.
//
// Built with -fmad=false and no fast-math; every update is written in the
// order of ops/chained_pcr.py::_pcr_core and 1/x is IEEE division, so the
// kernel equals shard_spike_factors run on the same blocks bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SB = 2048;               // cells per SPIKE block
constexpr int SNT = 1024;              // threads per block
constexpr int NCH = 12;                // live channels
constexpr size_t SMEM = 2ull * NCH * SB * sizeof(float);

// channel slots: the matrix (al, b11, b12, b21, cg, cw), then three
// right-hand-side pairs (d, l, r) as (p1, p2)
enum { AL, B11, B12, B21, CG, CW, P0 };

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (v == 0.f ? 1.f : v);
}

__global__ void __launch_bounds__(SNT) spike_factors_kernel(
    const uint8_t* __restrict__ mask, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    const float* __restrict__ d, int rows, int n, int npad,
    float* __restrict__ out) {
  extern __shared__ float sm[];
  float* cur = sm;
  float* nxt = sm + NCH * SB;
  const int blk = blockIdx.x, row = blockIdx.y;
  const size_t ro = (size_t)row * n;

  // chain encoding (chained_pcr._encode) and the boundary couplings moved
  // to the spike right-hand sides (shard_spike_factors)
  for (int i = threadIdx.x; i < SB; i += SNT) {
    const int g = blk * SB + i;
    const bool m = g < n && mask[ro + g] != 0;
    float al = m ? a[ro + g] : -1.f;
    const float b11 = m ? b[ro + g] : 1.f;
    const float b21 = m ? -1.f : 0.f;
    float cg = m ? c[ro + g] : 0.f;
    float cw = m ? 0.f : -1.f;
    const float d1 = m ? d[ro + g] : 0.f;
    const float first = i == 0 ? 1.f : 0.f;
    const float last = i == SB - 1 ? 1.f : 0.f;
    const float l1 = first * (-al);
    const float r1 = last * (-cg);
    const float r2 = last * (-cw);
    al = al * (1.f - first);
    cg = cg * (1.f - last);
    cw = cw * (1.f - last);
    cur[AL * SB + i] = al;
    cur[B11 * SB + i] = b11;
    cur[B12 * SB + i] = 0.f;
    cur[B21 * SB + i] = b21;
    cur[CG * SB + i] = cg;
    cur[CW * SB + i] = cw;
    cur[(P0 + 0) * SB + i] = d1;
    cur[(P0 + 1) * SB + i] = 0.f;
    cur[(P0 + 2) * SB + i] = l1;
    cur[(P0 + 3) * SB + i] = 0.f;
    cur[(P0 + 4) * SB + i] = r1;
    cur[(P0 + 5) * SB + i] = r2;
  }
  __syncthreads();

  for (int s = 1; s < SB; s <<= 1) {
    for (int i = threadIdx.x; i < SB; i += SNT) {
      const int im = i - s, ip = i + s;
      const bool hm = im >= 0, hp = ip < SB;
      // neighbors at distance s; out of the block: identity row, zero rhs
      const float b11m = hm ? cur[B11 * SB + im] : 1.f;
      const float b12m = hm ? cur[B12 * SB + im] : 0.f;
      const float b21m = hm ? cur[B21 * SB + im] : 0.f;
      const float alm = hm ? cur[AL * SB + im] : 0.f;
      const float cgm = hm ? cur[CG * SB + im] : 0.f;
      const float cwm = hm ? cur[CW * SB + im] : 0.f;
      const float b11p = hp ? cur[B11 * SB + ip] : 1.f;
      const float b12p = hp ? cur[B12 * SB + ip] : 0.f;
      const float b21p = hp ? cur[B21 * SB + ip] : 0.f;
      const float alp = hp ? cur[AL * SB + ip] : 0.f;
      const float cgp = hp ? cur[CG * SB + ip] : 0.f;
      const float cwp = hp ? cur[CW * SB + ip] : 0.f;
      const float al = cur[AL * SB + i];
      const float b11 = cur[B11 * SB + i];
      const float b12 = cur[B12 * SB + i];
      const float b21 = cur[B21 * SB + i];
      const float cg = cur[CG * SB + i];
      const float cw = cur[CW * SB + i];

      const float idetm = safe_inv(b11m - b12m * b21m);
      const float e11 = (-al) * idetm;
      const float e12 = (al * b12m) * idetm;
      const float idetp = safe_inv(b11p - b12p * b21p);
      const float f11 = (cg * b21p) * idetp;
      const float f12 = ((-cg) * b11p) * idetp;
      const float f21 = (cw * b21p) * idetp;
      const float f22 = ((-cw) * b11p) * idetp;

      nxt[B11 * SB + i] = b11 + f11 * alp;
      nxt[B12 * SB + i] = (b12 + e11 * cgm) + e12 * cwm;
      nxt[B21 * SB + i] = b21 + f21 * alp;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float* p1c = cur + (P0 + 2 * q) * SB;
        const float* p2c = cur + (P0 + 2 * q + 1) * SB;
        const float p1m = hm ? p1c[im] : 0.f, p2m = hm ? p2c[im] : 0.f;
        const float p1p = hp ? p1c[ip] : 0.f, p2p = hp ? p2c[ip] : 0.f;
        nxt[(P0 + 2 * q) * SB + i] =
            (((p1c[i] + e11 * p1m) + e12 * p2m) + f11 * p1p) + f12 * p2p;
        nxt[(P0 + 2 * q + 1) * SB + i] = (p2c[i] + f21 * p1p) + f22 * p2p;
      }
      nxt[AL * SB + i] = e11 * alm;
      nxt[CG * SB + i] = f11 * cgp + f12 * cwp;
      nxt[CW * SB + i] = f21 * cgp + f22 * cwp;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  // 2x2 solve of each cell's decoupled block row, for all three pairs
  const size_t plane = (size_t)rows * npad;
  for (int i = threadIdx.x; i < SB; i += SNT) {
    const float b11 = cur[B11 * SB + i];
    const float b12 = cur[B12 * SB + i];
    const float b21 = cur[B21 * SB + i];
    const float idet = safe_inv(b11 - b12 * b21);
    const size_t o = (size_t)row * npad + (size_t)blk * SB + i;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float p1 = cur[(P0 + 2 * q) * SB + i];
      const float p2 = cur[(P0 + 2 * q + 1) * SB + i];
      out[(2 * q) * plane + o] = (p1 - b12 * p2) * idet;
      out[(2 * q + 1) * plane + o] = (b11 * p2 - b21 * p1) * idet;
    }
  }
}

}  // namespace

extern "C" {

int pyitd_spike_block() { return SB; }

int pyitd_spike_factors(const uint8_t* mask, const float* a, const float* b,
                        const float* c, const float* d, int rows, int n,
                        int npad, float* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      spike_factors_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(npad / SB, rows);
  spike_factors_kernel<<<grid, SNT, SMEM, (cudaStream_t)stream>>>(
      mask, a, b, c, d, rows, n, npad, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
