// The closed-form anti-aliased winding contribution of one edge to one
// pixel, shared by prepass.cu, scene.cu and winding.cu.
//
// For an edge clipped to the row slab [r, r+1] (a linear X(y) over
// [lo, hi]), the contribution to pixel (r, c) is
//     sign(dy) * (hi - lo) * mean_y clamp((c + 1) - X(y), 0, 1)
// and the mean of the clamped linear function has the closed form
// (C(g1) - C(g0)) / (g1 - g0) with C the antiderivative of clamp(t, 0, 1).
// Summed over a tile's edges this is the exact signed trapezoid area the
// reference's accumulate-then-cumsum scanline computes.
//
// The operations and their order are those of the JAX package's
// ops/coverage.py and of the plain PyTorch version (ops/coverage.py
// _chunk_winding); the library is built with -fmad=false so no multiply-add is
// fused, which keeps the |den| > 1e-7 branch on the same side as the plain
// version's.
#pragma once

struct EdgeParams {
  float sign;   // sign(b0 - a0): +1 down, -1 up, 0 horizontal / padding
  float y_lo;   // row extent
  float y_hi;
  float x_lo;   // column at y_lo
  float slope;  // dcol / drow
};

__device__ __forceinline__ EdgeParams edge_params(float a0, float a1, float b0,
                                                  float b1) {
  EdgeParams e;
  float d = b0 - a0;
  e.sign = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
  e.y_lo = fminf(a0, b0);
  e.y_hi = fmaxf(a0, b0);
  bool down = a0 <= b0;
  e.x_lo = down ? a1 : b1;
  float x_hi = down ? b1 : a1;
  float dy = e.y_hi - e.y_lo;
  e.slope = (x_hi - e.x_lo) / (dy > 0.f ? dy : 1.f);
  return e;
}

__device__ __forceinline__ float clamp_antideriv(float t) {
  return t <= 0.f ? 0.f : (t >= 1.f ? t - 0.5f : 0.5f * t * t);
}

// Contribution of edge e to pixel (row, col).  Rows outside the edge's
// extent have dy == 0 and contribute an exact zero, so they return early;
// so do pixels wholly left of the edge (g0, g1 <= 0: the antiderivatives
// are 0, the mean an exact zero), which also spares the IEEE division its
// slow path on a zero numerator.  A sum that starts at +0.f is the same
// whether it adds these zeros (of either sign) or skips them.
__device__ __forceinline__ float edge_contrib(const EdgeParams& e, float row,
                                              float col) {
  float lo = fmaxf(e.y_lo, row);
  float hi = fminf(e.y_hi, row + 1.f);
  float dy = fmaxf(hi - lo, 0.f);
  if (dy == 0.f) return 0.f;
  float xs0 = e.x_lo + e.slope * (lo - e.y_lo);
  float xs1 = e.x_lo + e.slope * (hi - e.y_lo);
  float g0 = (col + 1.f) - xs0;
  float g1 = (col + 1.f) - xs1;
  if (g0 <= 0.f && g1 <= 0.f) return 0.f;
  float den = g1 - g0;
  float mean;
  if (fabsf(den) > 1e-7f) {
    mean = (clamp_antideriv(g1) - clamp_antideriv(g0)) / den;
  } else {
    mean = fminf(fmaxf(0.5f * (g0 + g1), 0.f), 1.f);
  }
  return e.sign * dy * mean;
}

// edge_contrib without branches, for a loop that evaluates several edges
// at once (independent chains the scheduler can overlap): the same
// operations wherever edge_contrib returns a value, and a zero wherever it
// returns 0.f, so a sum adds the same bits.  Where the value is discarded
// the division divides a nonzero denominator by itself.
__device__ __forceinline__ float edge_contrib_flat(const EdgeParams& e,
                                                   float row, float col) {
  float lo = fmaxf(e.y_lo, row);
  float hi = fminf(e.y_hi, row + 1.f);
  float dy = fmaxf(hi - lo, 0.f);
  float xs0 = e.x_lo + e.slope * (lo - e.y_lo);
  float xs1 = e.x_lo + e.slope * (hi - e.y_lo);
  float g0 = (col + 1.f) - xs0;
  float g1 = (col + 1.f) - xs1;
  float den = g1 - g0;
  bool safe = fabsf(den) > 1e-7f;
  bool zero = dy == 0.f || (g0 <= 0.f && g1 <= 0.f);
  float den_s = safe ? den : 1.f;
  float num = zero ? den_s : clamp_antideriv(g1) - clamp_antideriv(g0);
  float q = num / den_s;
  float mean = safe ? q : fminf(fmaxf(0.5f * (g0 + g1), 0.f), 1.f);
  return zero ? 0.f : e.sign * dy * mean;
}
