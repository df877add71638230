// Separable Gaussian blur of a filter chain (feGaussianBlur, and
// feDropShadow's blur) in one launch: the full convolution of an (h, w, 4)
// f32 layer with a row factor u (kh taps, down the rows) and a column factor
// v (kw taps, along each row), each pixel optionally un-premultiplied as it
// is loaded.  Layer.convolve takes it for a 4-channel layer on the card
// whose taps separate.
//
// It replaces no Pallas kernel: the JAX package runs the same blur as XLA
// band matmuls (svgrasterize_tpu/ops/blur.py _convolve_separable_mxu).  The
// port ran it in PyTorch as about 29 device operations a blur: the
// un-premultiply's seven, both band matrices built anew each frame, two
// matmuls and their transposes (ops/blur.py fe_blur, its plain version,
// which the kernel is held against).
//
// What bounds it on the H100: at a filter chain's sizes (layers of 10^4 to
// 10^5 pixels, 5 to 19 taps) the launch and its latency; a blur is under
// 10 MFLOP and under 2 MB.  On large layers, device memory: one read and one
// write of the layer.  The design does one launch a blur, reads each input
// pixel from device memory about once and writes each output pixel once: a
// block owns kTileH x kTileW output pixels, stages its zero-padded input
// window (un-premultiplied once a pixel) and the taps in shared memory, sums
// u down the window's columns into a shared intermediate, then v along the
// intermediate's rows, and stores float4 pixels, neighbouring threads on
// neighbouring pixels.  A thread loads kLoads window pixels before it
// converts any, and sums kRows output rows of a column from one read of
// each window pixel.  Measured on the H100 at the icons_3840 frame's 8
// blurs (layers 93-214 px a side, taps 5-19), the kernel alone: 3.67 us a
// blur at 8 x 32 pixels a block, 256 threads, 4 loads, 2 rows; 3.7-4.2 us
// with 512 threads, 4 x 32, 4 x 64 or 16 x 16 a block, 1 or 4 rows, 2 or 8
// loads; 4.1-5.3 us with 128 threads; 4.9-7.8 us at 16 x 32, 8 x 64 or 32 x
// 32 a block; 6.5 us at 16 x 32 with neither batched loads nor rows.  A
// blur is about 100 blocks, under one wave, so a thread's serial steps pace
// it.
//
// The window and the intermediate take 16 (kTileW + kw - 1) (2 kTileH + kh
// - 1) bytes, 27 KB for 19 x 19 taps.  Where taps are so long that they
// would take more than kSharedMax (square taps longer than 32), the same
// sums run as two launches through a scratch layer the wrapper allocates:
// u down the rows into (h + kh - 1, w, 4), then v along them.  The route
// follows from the taps' lengths alone (fused_exec.fe_blur_launches mirrors
// the rule).
//
// The arithmetic is ops/blur.py's in its order of passes: the un-premultiply
// of core/color.py (rgb / a where a > 0.0001, IEEE division, then rgba
// clipped to [0, 1] with torch.clamp's NaN rule), then u over rows, then v
// over columns, each tap a separate f32 multiply and add (-fmad=false),
// taken in ascending input index as a matmul's inner loop runs; only the
// order of a band matmul's sums differs.

#include "kernels.h"

namespace {

constexpr int kThreads = 256;
constexpr int kTileH = 8;   // output rows of a block
constexpr int kTileW = 32;  // output columns of a block
constexpr int kLoads = 4;   // window pixels a thread loads at once
constexpr int kRows = 2;    // rows a thread sums down one column (divides kTileH)
constexpr size_t kSharedMax = 48 * 1024;  // no opt-in above the default
constexpr int kMaxGridY = 65535;

// the passes one template instantiates
constexpr int kBoth = 0;   // u then v through shared memory, one launch
constexpr int kDown = 1;   // u down the rows into the scratch layer
constexpr int kAlong = 2;  // v along the scratch layer's rows

// torch.clamp(x, 0, 1): NaN stays NaN
__device__ __forceinline__ float clip01(float x) {
  return x < 0.f ? 0.f : (x > 1.f ? 1.f : x);
}

// core/color.py pre_to_straight_alpha of one pixel
__device__ __forceinline__ float4 straight(float4 p) {
  if (p.w > 0.0001f) {
    p.x = p.x / p.w;
    p.y = p.y / p.w;
    p.z = p.z / p.w;
  }
  return make_float4(clip01(p.x), clip01(p.y), clip01(p.z), clip01(p.w));
}

__device__ __forceinline__ void add_scaled(float4& s, float t, float4 p) {
  s.x = s.x + t * p.x;
  s.y = s.y + t * p.y;
  s.z = s.z + t * p.z;
  s.w = s.w + t * p.w;
}

size_t shared_bytes(int kh, int kw) {
  return sizeof(float4) * (size_t)(kTileW + kw - 1) * (2 * kTileH + kh - 1) +
         sizeof(float) * (size_t)(kh + kw);
}

// kBoth: in (h, w) -> out (h + kh - 1, w + kw - 1), a block a tile, grid
//   (column tiles, row tiles);
// kDown: in (h, w) -> out (h + kh - 1, w) with u;
// kAlong: in (h, w) -> out (h, w + kw - 1) with v; a thread a pixel.
template <int kPass>
__global__ void __launch_bounds__(kThreads)
fe_blur_kernel(const float4* __restrict__ in, int h, int w,
               const float* __restrict__ u, int kh,
               const float* __restrict__ v, int kw, int unpremultiply,
               float4* __restrict__ out) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kPass == kBoth) {
    extern __shared__ float4 smem[];
    const int ho = h + kh - 1, wo = w + kw - 1;
    const int wh = kTileH + kh - 1, ww = kTileW + kw - 1;
    float4* win = smem;              // (wh, ww): input rows y0 - kh + 1 ...
    float4* mid = win + wh * ww;     // (kTileH, ww): u applied
    float* su = reinterpret_cast<float*>(mid + kTileH * ww);
    float* sv = su + kh;
    const int y0 = blockIdx.y * kTileH, x0 = blockIdx.x * kTileW;
    for (int i = threadIdx.x; i < kh; i += kThreads) su[i] = u[i];
    for (int i = threadIdx.x; i < kw; i += kThreads) sv[i] = v[i];
    // the window, kLoads pixels a thread at a time so that their loads are
    // in flight together; the zero padding converts to zero
    for (int base = threadIdx.x; base < wh * ww; base += kLoads * kThreads) {
      float4 p[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = base + k * kThreads;
        const int r = i / ww, c = i - r * ww;
        const int y = y0 - kh + 1 + r, x = x0 - kw + 1 + c;
        p[k] = i < wh * ww && y >= 0 && y < h && x >= 0 && x < w ? in[(size_t)y * w + x]
                                                                  : zero;
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const int i = base + k * kThreads;
        if (i < wh * ww) win[i] = unpremultiply ? straight(p[k]) : p[k];
      }
    }
    __syncthreads();
    // mid[r][c] = sum over a of u[a] * input row y0 + r - a, window row
    // r + j with j = kh - 1 - a; a thread takes kRows rows of one column,
    // reading each window pixel once for all of them
    for (int i = threadIdx.x; i < (kTileH / kRows) * ww; i += kThreads) {
      const int r0 = i / ww * kRows, c = i - i / ww * ww;
      float4 s[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) s[k] = zero;
      for (int j = 0; j < kh + kRows - 1; ++j) {
        const float4 p = win[(r0 + j) * ww + c];
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          const int a = kh - 1 - (j - k);  // output row r0 + k, window row r0 + j
          if (a >= 0 && a < kh) add_scaled(s[k], su[a], p);
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) mid[(r0 + k) * ww + c] = s[k];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileH * kTileW; i += kThreads) {
      const int r = i / kTileW, c = i % kTileW;
      const int y = y0 + r, x = x0 + c;
      if (y >= ho || x >= wo) continue;
      float4 s = zero;
#pragma unroll 4
      for (int j = 0; j < kw; ++j) add_scaled(s, sv[kw - 1 - j], mid[r * ww + c + j]);
      out[(size_t)y * wo + x] = s;
    }
  } else {
    const int ho = kPass == kDown ? h + kh - 1 : h;
    const int wo = kPass == kDown ? w : w + kw - 1;
    const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
    if (i >= (size_t)ho * wo) return;
    const int y = (int)(i / wo), x = (int)(i - (size_t)y * wo);
    float4 s = zero;
    if constexpr (kPass == kDown) {
      for (int j = 0; j < kh; ++j) {
        const int yy = y - kh + 1 + j;
        if (yy < 0 || yy >= h) continue;
        float4 p = in[(size_t)yy * w + x];
        if (unpremultiply) p = straight(p);
        add_scaled(s, u[kh - 1 - j], p);
      }
    } else {
      for (int j = 0; j < kw; ++j) {
        const int xx = x - kw + 1 + j;
        if (xx < 0 || xx >= w) continue;
        add_scaled(s, v[kw - 1 - j], in[(size_t)y * w + xx]);
      }
    }
    out[i] = s;
  }
}

unsigned int blocks_for(size_t n) { return (unsigned int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" int svgr_fe_blur(const float* image, int h, int w, const float* u,
                            int kh, const float* v, int kw, int unpremultiply,
                            float* scratch, float* out, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || kh <= 0 || kw <= 0) return (int)cudaErrorInvalidValue;
  const int ho = h + kh - 1, wo = w + kw - 1;
  const float4* in = reinterpret_cast<const float4*>(image);
  float4* dst = reinterpret_cast<float4*>(out);
  const size_t smem = shared_bytes(kh, kw);
  if (smem <= kSharedMax) {
    const dim3 grid((wo + kTileW - 1) / kTileW, (ho + kTileH - 1) / kTileH);
    if (grid.y > (unsigned int)kMaxGridY) return (int)cudaErrorInvalidValue;
    fe_blur_kernel<kBoth><<<grid, kThreads, smem, stream>>>(
        in, h, w, u, kh, v, kw, unpremultiply, dst);
    return (int)cudaGetLastError();
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  float4* mid = reinterpret_cast<float4*>(scratch);
  fe_blur_kernel<kDown><<<blocks_for((size_t)ho * w), kThreads, 0, stream>>>(
      in, h, w, u, kh, v, kw, unpremultiply, mid);
  const cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  fe_blur_kernel<kAlong><<<blocks_for((size_t)ho * wo), kThreads, 0, stream>>>(
      mid, ho, w, u, kh, v, kw, 0, dst);
  return (int)cudaGetLastError();
}
