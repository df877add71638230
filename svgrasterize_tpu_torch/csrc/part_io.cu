// Filter-part entry and exit kernels: the two ends of a filter part whose
// chain runs per frame (render_plan._PartFilter), one launch each.
//
// They replace no TPU kernel.  The JAX package runs a part's ends as XLA
// operations, and the port ran them as PyTorch operations, about 45 a part
// (ops/part_io.py, their plain versions, which the kernels are held
// against).  On the card those were tens of small launches a part over a
// few thousand to tens of thousands of pixels: the time went to launches
// and their latency, not to bytes.  Each end is now one launch.
//
// Entry (svgr_part_entry): for each pixel of the part's source crop, the
// span tile it falls in, that tile's row of the level's canvas by the
// part's slot map (-1: no row, zeros), then Layer.convert as
// Filter.seeds runs it: un-premultiply (rgb / a where a > 1e-4), clip to
// [0, 1], then the piecewise sRGB curve when the chain's colorspace is not
// the canvas's; and SourceAlpha, the canvas alpha times the chain's
// channel mask.  Two (h, w, 4) images, written once.
//
// Exit (svgr_part_exit): for each pixel of each of the part's out tiles,
// the chain's result pixel under it (read by the strides it is given, so
// views and broadcast channels need no copy; 1 or 4 channels), converted
// to premultiplied alpha in the canvas's colorspace as Layer.convert does,
// then merge_at's OVER onto a zero out span and clamp to [0, 1]; pixels
// the result does not cover are zero.  Written straight into the tile's
// pool row, so no out-span image and no pool-row launch follow.
//
// The arithmetic is ops/part_io.py's in its order: separate f32 multiplies
// and adds (-fmad=false), IEEE division, powf, torch.clamp's NaN rule, the
// 1e-12 floor of core/color.py.  What bounds both on the H100: launch
// latency; a part moves well under a megabyte.  One thread a pixel, blocks
// of 256, float4 loads and stores of the canvas, seeds and pool.

#include <math.h>

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_to(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.clamp(x, min=floor)
__device__ __forceinline__ float floor_at(float x, float floor) {
  return isnan(x) ? x : fmaxf(x, floor);
}

// core/color.py srgb_to_linear and linear_to_srgb on one channel
__device__ __forceinline__ float to_linear(float x) {
  const float lo = x / 12.92f;
  const float hi = powf(floor_at((x + 0.055f) / 1.055f, 1e-12f), 2.4f);
  return x <= 0.04045f ? lo : hi;
}

__device__ __forceinline__ float to_srgb(float x) {
  const float lo = x * 12.92f;
  const float hi =
      1.055f * powf(floor_at(x, 1e-12f), (float)(1.0 / 2.4)) - 0.055f;
  return x <= 0.0031308f ? lo : hi;
}

// gamma: 0 none, 1 sRGB -> linear, 2 linear -> sRGB (rgb only)
__device__ __forceinline__ float4 convert_gamma(float4 v, int gamma) {
  if (gamma == 1) {
    v.x = to_linear(v.x);
    v.y = to_linear(v.y);
    v.z = to_linear(v.z);
  } else if (gamma == 2) {
    v.x = to_srgb(v.x);
    v.y = to_srgb(v.y);
    v.z = to_srgb(v.z);
  }
  return v;
}

// core/color.py pre_to_straight_alpha
__device__ __forceinline__ float4 to_straight(float4 v) {
  if (v.w > 0.0001f) {
    v.x = v.x / v.w;
    v.y = v.y / v.w;
    v.z = v.z / v.w;
  }
  return make_float4(clamp_to(v.x, 0.f, 1.f), clamp_to(v.y, 0.f, 1.f),
                     clamp_to(v.z, 0.f, 1.f), clamp_to(v.w, 0.f, 1.f));
}

template <int T>
__global__ void __launch_bounds__(kThreads)
part_entry_kernel(const float4* __restrict__ rows, int n_rows,
                  const int* __restrict__ slots, int nsj, int r0, int c0,
                  int h, int w, int gamma, const float* __restrict__ amask,
                  float4* __restrict__ graphic, float4* __restrict__ alpha) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= h * w) return;
  const int r = r0 + i / w;  // span pixel
  const int c = c0 + i % w;
  const int row = slots[(r / T) * nsj + c / T];
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= 0 && row < n_rows) {
    v = rows[((size_t)row * T + r % T) * T + c % T];
  }
  alpha[i] = make_float4(v.w * amask[0], v.w * amask[1], v.w * amask[2],
                         v.w * amask[3]);
  graphic[i] = convert_gamma(to_straight(v), gamma);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
part_exit_kernel(float4* __restrict__ pool, int pool_rows,
                 const float* __restrict__ result, int h, int w, int channels,
                 int stride_r, int stride_c, int stride_ch, int pre_alpha,
                 int gamma, int off_r, int off_c, int ntj, int span_tiles,
                 const int* __restrict__ src_idx,
                 const int* __restrict__ dst_idx) {
  constexpr int kPer = T * T / kThreads < 1 ? 1 : T * T / kThreads;
  const int k = blockIdx.x / kPer;  // the part's out tile
  const int p = (blockIdx.x % kPer) * kThreads + threadIdx.x;  // its pixel
  if (p >= T * T) return;
  const int s = src_idx[k];
  const int d = dst_idx[k];
  if (s < 0 || s >= span_tiles || d < 0 || d >= pool_rows) return;
  const int r = (s / ntj) * T + p / T - off_r;  // result pixel
  const int c = (s % ntj) * T + p % T - off_c;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r >= 0 && r < h && c >= 0 && c < w) {
    const float* px = result + (size_t)r * stride_r + (size_t)c * stride_c;
    if (channels == 1) {
      // alpha only: the OVER below broadcasts it to every channel
      v = make_float4(px[0], px[0], px[0], px[0]);
    } else {
      v = make_float4(px[0], px[stride_ch], px[2 * stride_ch],
                      px[3 * stride_ch]);
      bool pre = pre_alpha != 0;
      if (gamma != 0) {
        if (pre) v = to_straight(v);
        v = convert_gamma(v, gamma);
        pre = false;
      }
      if (!pre) {
        v.x = v.x * v.w;
        v.y = v.y * v.w;
        v.z = v.z * v.w;
      }
    }
    // merge_at: src + dst * (1 - src_a) with dst = 0, then the clamp
    const float keep = 0.f * (1.f - v.w);
    v = make_float4(clamp_to(v.x + keep, 0.f, 1.f),
                    clamp_to(v.y + keep, 0.f, 1.f),
                    clamp_to(v.z + keep, 0.f, 1.f),
                    clamp_to(v.w + keep, 0.f, 1.f));
  }
  pool[(size_t)d * T * T + p] = v;
}

template <int T>
int launch_entry(const float* rows, int n_rows, const int* slots, int nsj,
                 int r0, int c0, int h, int w, int gamma, const float* amask,
                 float* graphic, float* alpha, cudaStream_t stream) {
  const int blocks = (h * w + kThreads - 1) / kThreads;
  part_entry_kernel<T><<<blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rows), n_rows, slots, nsj, r0, c0, h, w,
      gamma, amask, reinterpret_cast<float4*>(graphic),
      reinterpret_cast<float4*>(alpha));
  return (int)cudaGetLastError();
}

template <int T>
int launch_exit(float* pool, int pool_rows, const float* result, int h, int w,
                int channels, int stride_r, int stride_c, int stride_ch,
                int pre_alpha, int gamma, int off_r, int off_c, int ntj,
                int span_tiles, const int* src_idx, const int* dst_idx, int n,
                cudaStream_t stream) {
  constexpr int kPer = T * T / kThreads < 1 ? 1 : T * T / kThreads;
  part_exit_kernel<T><<<n * kPer, kThreads, 0, stream>>>(
      reinterpret_cast<float4*>(pool), pool_rows, result, h, w, channels,
      stride_r, stride_c, stride_ch, pre_alpha, gamma, off_r, off_c, ntj,
      span_tiles, src_idx, dst_idx);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int svgr_part_entry(const float* rows, int n_rows, const int* slots,
                               int nsj, int r0, int c0, int h, int w,
                               int gamma, const float* amask, float* graphic,
                               float* alpha, int tile, cudaStream_t stream) {
  if (h <= 0 || w <= 0) return 0;
  switch (tile) {
    case 16:
      return launch_entry<16>(rows, n_rows, slots, nsj, r0, c0, h, w, gamma,
                              amask, graphic, alpha, stream);
    case 32:
      return launch_entry<32>(rows, n_rows, slots, nsj, r0, c0, h, w, gamma,
                              amask, graphic, alpha, stream);
    case 64:
      return launch_entry<64>(rows, n_rows, slots, nsj, r0, c0, h, w, gamma,
                              amask, graphic, alpha, stream);
    case 128:
      return launch_entry<128>(rows, n_rows, slots, nsj, r0, c0, h, w, gamma,
                               amask, graphic, alpha, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int svgr_part_exit(float* pool, int pool_rows, const float* result,
                              int h, int w, int channels, int stride_r,
                              int stride_c, int stride_ch, int pre_alpha,
                              int gamma, int off_r, int off_c, int ntj,
                              int span_tiles, const int* src_idx,
                              const int* dst_idx, int n, int tile,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (tile) {
    case 16:
      return launch_exit<16>(pool, pool_rows, result, h, w, channels, stride_r,
                             stride_c, stride_ch, pre_alpha, gamma, off_r,
                             off_c, ntj, span_tiles, src_idx, dst_idx, n,
                             stream);
    case 32:
      return launch_exit<32>(pool, pool_rows, result, h, w, channels, stride_r,
                             stride_c, stride_ch, pre_alpha, gamma, off_r,
                             off_c, ntj, span_tiles, src_idx, dst_idx, n,
                             stream);
    case 64:
      return launch_exit<64>(pool, pool_rows, result, h, w, channels, stride_r,
                             stride_c, stride_ch, pre_alpha, gamma, off_r,
                             off_c, ntj, span_tiles, src_idx, dst_idx, n,
                             stream);
    case 128:
      return launch_exit<128>(pool, pool_rows, result, h, w, channels,
                              stride_r, stride_c, stride_ch, pre_alpha, gamma,
                              off_r, off_c, ntj, span_tiles, src_idx, dst_idx,
                              n, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
