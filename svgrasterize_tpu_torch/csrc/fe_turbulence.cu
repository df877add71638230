// feTurbulence of a filter chain in one launch: the SVG 1.1 spec's Perlin
// noise (turbulence or fractalNoise, any number of octaves) over a
// primitive's output region, four channels a pixel, straight alpha clamped
// to [0, 1].  filter._apply takes it for a source layer on the card.
//
// It replaces no Pallas kernel: the JAX package evaluates the noise as XLA
// ops (svgrasterize_tpu/ops/turbulence.py).  The port ran it in PyTorch
// (ops/turbulence.py turbulence_region, turbulence_impl over the region: the
// plain version, which the kernel is held against) as about 815 device
// operations a primitive at 3 octaves: each of the 4 channels x octaves
// evaluations of the spec's noise2 is some 60 elementwise operations and
// lattice gathers over the whole region.
//
// What bounds it on the H100: neither device memory nor the FP32 rate.  A
// grain card of the effects sheet is 203 x 323 px; its float4 image is 1.05
// MB written once (0.31 us at 3.35 TB/s), and its 12 noise evaluations a
// pixel 360 FP32 operations (0.35 us at 67 TFLOP/s): the launch and the
// latency of a block's steps pace it.  The work is a pixel's own, with no
// neighbour: 6 selector and 4 gradient lookups an octave, in the lattice
// tables.  The design keeps those lookups on chip: a block stages in shared
// memory the part of the tables the lookups reach (the selector's first 512
// entries and the gradients' first 256 rows, re-laid so that one lattice
// point's four channels are two float4: 10 KB), with every load of it in
// flight at once (16-byte loads, at most three a thread), then walks pixels
// a thread at a time with a stride of the grid, so that a few blocks an SM
// (kBlocksPerSm, held by the launch bounds) share out a large region and
// each table load is paid for by many pixels.  A pixel's lattice cell,
// s-curves and corner indices are the same for its four channels and are
// found once an octave; its channels' sums stay in registers; neighbouring
// threads write neighbouring float4 pixels.  Measured on the H100 at a grain
// card: the kernel alone 4.85 us (profiler), 5.85 us when a block staged the
// whole 18.5 KB of tables a float at a time.
//
// The arithmetic is turbulence_region's and turbulence_impl's, in their order,
// each f32 multiply and add rounded on its own (-fmad=false): the pixel
// centre (r + off0) + 0.5, its user point (inv00 pr + inv01 pc) + inv02,
// the lattice point v f doubled each octave, tx = v + 4096 truncated toward
// zero to int32 and masked with 255 as a signed integer, rx0 = tx -
// floor(tx), the s-curve (t t)(3 - 2 t), u = rx0 gx + ry0 gy, the lerps u +
// s (v - u), the octave's noise times 1 / ratio (a power of two, as PyTorch
// divides by a scalar on the card), (total + 1) / 2 for fractalNoise, then
// the clamp with torch.clamp's NaN rule.

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 4;  // resident blocks an SM the launch bounds keep
constexpr int kBSize = 256;      // the spec's BSize
constexpr int kBm = 0xff;        // the spec's BM
constexpr int kTable = kBSize + kBSize + 2;  // the tables' rows
constexpr int kSelLoads = 2 * kBSize / 4;     // int4 loads of the selector's used entries
constexpr int kGradLoads = 4 * kBSize / 2 / kThreads;  // float4 loads a thread
constexpr float kPerlinN = 4096.f;  // the spec's PerlinN

// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clip01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

__device__ __forceinline__ float s_curve(float t) { return t * t * (3.f - 2.f * t); }

// ops/turbulence.py _noise2's last steps for one channel: the four corners'
// dot products and the three lerps
__device__ __forceinline__ float corners(float rx0, float rx1, float ry0, float ry1,
                                         float sx, float sy, float g00x, float g00y,
                                         float g10x, float g10y, float g01x, float g01y,
                                         float g11x, float g11y) {
  float u = rx0 * g00x + ry0 * g00y;
  float v = rx1 * g10x + ry0 * g10y;
  const float a = u + sx * (v - u);
  u = rx0 * g01x + ry1 * g01y;
  v = rx1 * g11x + ry1 * g11y;
  const float b = u + sx * (v - u);
  return a + sy * (b - a);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fe_turbulence_kernel(const int4* __restrict__ selector, const float4* __restrict__ gradient,
                     int off0, int off1, int h, int w, float inv00, float inv01,
                     float inv02, float inv10, float inv11, float inv12, float base_fx,
                     float base_fy, int octaves, int fractal, float4* __restrict__ out) {
  // the lookups reach selector entries below 2 kBSize - 1 and, through them,
  // gradient rows below kBSize (the rows above are the spec's copies)
  __shared__ int4 sel4[kSelLoads];
  // grad[2 q] = channels 0, 1 of lattice point q (x, y, x, y); grad[2 q + 1]
  // channels 2, 3
  __shared__ float4 grad[2 * kBSize];
  // every load in flight before any store: a float4 of the gradients holds
  // rows q, q + 1 of one channel (each channel's 514 rows start 16-byte
  // aligned)
  int4 s = make_int4(0, 0, 0, 0);
  float4 gl[kGradLoads];
  if (threadIdx.x < kSelLoads) s = selector[threadIdx.x];
#pragma unroll
  for (int k = 0; k < kGradLoads; ++k) {
    const int f = threadIdx.x + k * kThreads, ch = f / (kBSize / 2);
    gl[k] = gradient[ch * (kTable / 2) + f - ch * (kBSize / 2)];
  }
  if (threadIdx.x < kSelLoads) sel4[threadIdx.x] = s;
  float2* g2 = reinterpret_cast<float2*>(grad);
#pragma unroll
  for (int k = 0; k < kGradLoads; ++k) {
    const int f = threadIdx.x + k * kThreads, ch = f / (kBSize / 2);
    const int q = 2 * (f - ch * (kBSize / 2));
    g2[q * 4 + ch] = make_float2(gl[k].x, gl[k].y);
    g2[(q + 1) * 4 + ch] = make_float2(gl[k].z, gl[k].w);
  }
  __syncthreads();
  const int* sel = reinterpret_cast<const int*>(sel4);

  const size_t n = (size_t)h * w;
  for (size_t p = (size_t)blockIdx.x * kThreads + threadIdx.x; p < n;
       p += (size_t)gridDim.x * kThreads) {
    const int r = (int)(p / w), c = (int)(p - (size_t)r * w);
    const float pr = ((float)r + (float)off0) + 0.5f;
    const float pc = ((float)c + (float)off1) + 0.5f;
    float vx = ((inv00 * pr + inv01 * pc) + inv02) * base_fx;
    float vy = ((inv10 * pr + inv11 * pc) + inv12) * base_fy;
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
    float ratio = 1.f;
    for (int o = 0; o < octaves; ++o) {
      const float tx = vx + kPerlinN;
      const int bx0 = (int)tx & kBm;
      const int bx1 = (bx0 + 1) & kBm;
      const float rx0 = tx - floorf(tx);
      const float rx1 = rx0 - 1.f;
      const float ty = vy + kPerlinN;
      const int by0 = (int)ty & kBm;
      const int by1 = (by0 + 1) & kBm;
      const float ry0 = ty - floorf(ty);
      const float ry1 = ry0 - 1.f;
      const int i = sel[bx0] & kBm, j = sel[bx1] & kBm;
      const int q00 = sel[i + by0] & kBm, q10 = sel[j + by0] & kBm;
      const int q01 = sel[i + by1] & kBm, q11 = sel[j + by1] & kBm;
      const float sx = s_curve(rx0), sy = s_curve(ry0);
      const float inv_ratio = 1.f / ratio;
      const float4 a00 = grad[2 * q00], a10 = grad[2 * q10];
      const float4 a01 = grad[2 * q01], a11 = grad[2 * q11];
      const float4 b00 = grad[2 * q00 + 1], b10 = grad[2 * q10 + 1];
      const float4 b01 = grad[2 * q01 + 1], b11 = grad[2 * q11 + 1];
      float n0 = corners(rx0, rx1, ry0, ry1, sx, sy, a00.x, a00.y, a10.x, a10.y, a01.x,
                         a01.y, a11.x, a11.y);
      float n1 = corners(rx0, rx1, ry0, ry1, sx, sy, a00.z, a00.w, a10.z, a10.w, a01.z,
                         a01.w, a11.z, a11.w);
      float n2 = corners(rx0, rx1, ry0, ry1, sx, sy, b00.x, b00.y, b10.x, b10.y, b01.x,
                         b01.y, b11.x, b11.y);
      float n3 = corners(rx0, rx1, ry0, ry1, sx, sy, b00.z, b00.w, b10.z, b10.w, b01.z,
                         b01.w, b11.z, b11.w);
      if (!fractal) {
        n0 = fabsf(n0);
        n1 = fabsf(n1);
        n2 = fabsf(n2);
        n3 = fabsf(n3);
      }
      t0 = t0 + n0 * inv_ratio;
      t1 = t1 + n1 * inv_ratio;
      t2 = t2 + n2 * inv_ratio;
      t3 = t3 + n3 * inv_ratio;
      vx = vx * 2.f;
      vy = vy * 2.f;
      ratio = ratio * 2.f;
    }
    if (fractal) {
      t0 = (t0 + 1.f) * 0.5f;
      t1 = (t1 + 1.f) * 0.5f;
      t2 = (t2 + 1.f) * 0.5f;
      t3 = (t3 + 1.f) * 0.5f;
    }
    out[p] = make_float4(clip01(t0), clip01(t1), clip01(t2), clip01(t3));
  }
}

}  // namespace

extern "C" int svgr_fe_turbulence(const int* selector, const float* gradient, int off0,
                                  int off1, int h, int w, float inv00, float inv01,
                                  float inv02, float inv10, float inv11, float inv12,
                                  float base_fx, float base_fy, int octaves, int fractal,
                                  float* out, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || octaves < 1) return (int)cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return (int)rc;
  const size_t needed = ((size_t)h * w + kThreads - 1) / kThreads;
  const size_t resident = (size_t)sms * kBlocksPerSm;
  const unsigned int blocks = (unsigned int)(needed < resident ? needed : resident);
  fe_turbulence_kernel<<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const int4*>(selector), reinterpret_cast<const float4*>(gradient),
      off0, off1, h, w, inv00, inv01, inv02, inv10, inv11, inv12,
      base_fx, base_fy, octaves, fractal, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}
