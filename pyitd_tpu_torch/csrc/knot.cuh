// The ITD knot test and the Frei-Osorio knot value, shared by the sift's and
// the cubic tier's tile kernels (tile_fill.cuh), the scan kernels'
// linear_fill2 (fill_segsum.cu) and the level adjoint's kernels
// (level_bwd.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// ITD knot mask at sample t (pallas_fill.py::_knot_mask_flat): canonical
// extrema with the plateau-rightmost rule, NaN differences as +inf, no
// extremum within one sample of a NaN, both endpoints always, padding never.
// t is the sample's index in its row of n samples, g its position in the
// signal of ng samples (pallas_fill_sharded.py::_knot_state_sharded): a
// sample past either end is padding.
__device__ __forceinline__ bool knot_at(float xm1, float x0, float xp1, int t,
                                        int n, int g, int ng) {
  if (t >= n || g >= ng) return false;
  if (g == 0 || g == ng - 1) return true;
  float dxb = x0 - xm1;
  float dxf = xp1 - x0;
  if (isnan(dxb)) dxb = INFINITY;
  if (isnan(dxf)) dxf = INFINITY;
  const bool near_nan = isnan(x0) || isnan(xm1) || isnan(xp1);
  const bool is_min = (dxb <= 0.f) && (dxf > 0.f);
  const bool is_max = (dxb >= 0.f) && (dxf < 0.f);
  return (is_min || is_max) && !near_nan;
}

__device__ __forceinline__ bool knot_at(float xm1, float x0, float xp1, int t,
                                        int n) {
  return knot_at(xm1, x0, xp1, t, n, t, n);
}

// Frei-Osorio knot value (linear_baseline.py::knot_value), alpha = 0.5
__device__ __forceinline__ float knot_value(int kpos, float kval, int lpos,
                                            float lval, int rpos, float rval) {
  const float span = (float)(rpos - lpos);
  const float w = (float)(kpos - lpos) / (span == 0.f ? 1.f : span);
  return 0.5f * (lval + w * (rval - lval)) + 0.5f * kval;
}

}  // namespace
