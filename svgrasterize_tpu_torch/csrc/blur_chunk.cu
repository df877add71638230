// Blur-chunk kernel: every out-span tile of a chunk of lone separable-blur
// filter parts (one isolation-pass level's feGaussianBlur parts, batched by
// ops/filter_batch.py).
//
// Replaces the JAX package's TPU kernel in
// svgrasterize_tpu/ops/filter_batch.py: _chunk_kernel_factory, launched by
// _apply_chunk_pallas.  What it computes, per part b and channel c, is the
// XLA chain of apply_chunk there (and ops/filter_batch.apply_chunk here):
//   X   = the part's source span, tile (i, j) read from canvas row
//         lut[b, i * nsj + j] (-1 reads zeros), un-premultiplied and
//         clipped as Layer.convert does (rgb := 0 for SourceAlpha parts),
//         then converted sRGB <-> linear when the chain's colorspace is not
//         the canvas's;
//   O_c = BH[b] @ X_c @ BW[b]^T: crop, separable gaussian and placement in
//         one pair of band-operator products;
//   the blurred rgb converted back, re-premultiplied by the blurred alpha,
//   and cut into (T, T, 4) out tiles, out-span row-major per part.
// The conversion formulas are _planar_convert's, max(..., 1e-12) guards
// included.
//
// What bounds it on the H100: FP32 arithmetic.  A block computes
// T x W x H x 4 + T x T x W x 4 multiply-adds for its out tile (H, W the
// span's height and width) and reads the span once per out tile; the
// operands of each product stay in shared memory.
//
// Design: one block per (part, out tile).  Plain f32 multiply-adds (no
// TF32, no tensor cores) and no skipping of the band operators' zeros: a
// first kernel that is right.  The block walks the span's columns in
// chunks of kC: for each chunk it accumulates Z = BH[tile rows] @ X[:, chunk]
// (T x kC x 4) in registers over kC-row steps of the span, staging the BH
// and converted X tiles in shared memory, then stages Z and adds
// Z @ BW[tile cols, chunk]^T into the out tile's registers.  Shared memory
// stays under 48 KB at every T, whatever the span's size.

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_linear(float x) {
  return x <= 0.04045f ? x / 12.92f
                       : powf(fmaxf((x + 0.055f) / 1.055f, 1e-12f), 2.4f);
}

__device__ __forceinline__ float to_srgb(float x) {
  return x <= 0.0031308f
             ? x * 12.92f
             : 1.055f * powf(fmaxf(x, 1e-12f), 1.0f / 2.4f) - 0.055f;
}

__device__ __forceinline__ float convert_gamma(float x, int mode) {
  if (mode == 1) return to_linear(x);
  if (mode == 2) return to_srgb(x);
  return x;
}

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.f), 1.f);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
blur_chunk_kernel(const float4* __restrict__ canvas, const int* __restrict__ lut,
                  const float* __restrict__ bh, const float* __restrict__ bw,
                  const int* __restrict__ src_alpha, int nsi, int nsj, int noi,
                  int noj, int gamma_in, int gamma_out,
                  float4* __restrict__ out) {
  constexpr int kC = T < 32 ? T : 32;       // span rows / columns per step
  constexpr int kPairs = T * kC / kThreads;  // Z entries per thread
  constexpr int kPx = T * T / kThreads;      // out pixels per thread
  constexpr int kZ = 4 * T * kC;             // staged Z, channel-planar
  constexpr int kOperands = T * kC + 4 * kC * kC;  // BH tile + X tile
  constexpr int kUnion = kZ > kOperands ? kZ : kOperands;
  constexpr int kBwStride = kC + 1;          // padded: no bank conflicts
  __shared__ __align__(16) float smem[kUnion + T * kBwStride];
  float* s_bh = smem;                                       // (T, kC)
  float4* s_x = reinterpret_cast<float4*>(smem + T * kC);   // (kC, kC)
  float* s_z = smem;                                        // (4, T, kC)
  float* s_bw = smem + kUnion;                              // (T, kC + 1)

  const int b = blockIdx.y;
  const int o = blockIdx.x;
  const int oi = o / noj;
  const int oj = o % noj;
  const int tid = threadIdx.x;
  const int H = nsi * T;
  const int W = nsj * T;
  const int Ho = noi * T;
  const int Wo = noj * T;
  const int* lut_b = lut + (size_t)b * nsi * nsj;
  const float* bh_b = bh + ((size_t)b * Ho + (size_t)oi * T) * H;
  const float* bw_b = bw + ((size_t)b * Wo + (size_t)oj * T) * W;
  const bool alpha_only = src_alpha[b] != 0;

  float4 acc[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int w0 = 0; w0 < W; w0 += kC) {
    float4 z[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) z[p] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h0 = 0; h0 < H; h0 += kC) {
      // stage BH[tile rows, h0 : h0 + kC]
      for (int e = tid; e < T * kC; e += kThreads) {
        const int r = e / kC, hh = e % kC;
        s_bh[e] = bh_b[(size_t)r * H + h0 + hh];
      }
      // stage the converted span pixels X[h0 : h0 + kC, w0 : w0 + kC]
      for (int e = tid; e < kC * kC; e += kThreads) {
        const int hh = e / kC, ww = e % kC;
        const int h = h0 + hh, w = w0 + ww;
        const int row = lut_b[(h / T) * nsj + (w / T)];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row >= 0) v = canvas[((size_t)row * T + h % T) * T + w % T];
        if (alpha_only) v.x = v.y = v.z = 0.f;
        // Layer.convert(pre_alpha=False): rgb / a where a > 1e-4, clip
        const bool pos = v.w > 0.0001f;
        const float safe = pos ? v.w : 1.f;
        if (pos) {
          v.x = v.x / safe;
          v.y = v.y / safe;
          v.z = v.z / safe;
        }
        v.x = convert_gamma(clip01(v.x), gamma_in);
        v.y = convert_gamma(clip01(v.y), gamma_in);
        v.z = convert_gamma(clip01(v.z), gamma_in);
        v.w = clip01(v.w);
        s_x[e] = v;
      }
      __syncthreads();
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int e = tid + p * kThreads;
        const int r = e / kC, ww = e % kC;
        for (int hh = 0; hh < kC; ++hh) {
          const float a = s_bh[r * kC + hh];
          const float4 x = s_x[hh * kC + ww];
          z[p].x = z[p].x + a * x.x;
          z[p].y = z[p].y + a * x.y;
          z[p].z = z[p].z + a * x.z;
          z[p].w = z[p].w + a * x.w;
        }
      }
      __syncthreads();
    }

    // stage Z (over the operand tiles, now dead) and BW[tile cols, chunk]
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int e = tid + p * kThreads;  // r * kC + ww
      s_z[e] = z[p].x;
      s_z[T * kC + e] = z[p].y;
      s_z[2 * T * kC + e] = z[p].z;
      s_z[3 * T * kC + e] = z[p].w;
    }
    for (int e = tid; e < T * kC; e += kThreads) {
      const int q = e / kC, ww = e % kC;
      s_bw[q * kBwStride + ww] = bw_b[(size_t)q * W + w0 + ww];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      const int px = tid + i * kThreads;
      const int r = px / T, q = px % T;
      const float* zr = s_z + r * kC;
      const float* bq = s_bw + q * kBwStride;
      for (int ww = 0; ww < kC; ++ww) {
        const float g = bq[ww];
        acc[i].x = acc[i].x + zr[ww] * g;
        acc[i].y = acc[i].y + zr[T * kC + ww] * g;
        acc[i].z = acc[i].z + zr[2 * T * kC + ww] * g;
        acc[i].w = acc[i].w + zr[3 * T * kC + ww] * g;
      }
    }
    __syncthreads();
  }

  // back to premultiplied, in the canvas's colorspace
  float4* dst = out + ((size_t)b * noi * noj + o) * T * T;
#pragma unroll
  for (int i = 0; i < kPx; ++i) {
    float4 v = acc[i];
    v.x = convert_gamma(v.x, gamma_out) * v.w;
    v.y = convert_gamma(v.y, gamma_out) * v.w;
    v.z = convert_gamma(v.z, gamma_out) * v.w;
    dst[tid + i * kThreads] = v;
  }
}

template <int T>
cudaError_t launch(const float* canvas, const int* lut, const float* bh,
                   const float* bw, const int* src_alpha, int parts, int nsi,
                   int nsj, int noi, int noj, int gamma_in, int gamma_out,
                   float* out, cudaStream_t stream) {
  const dim3 grid(noi * noj, parts);
  blur_chunk_kernel<T><<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(canvas), lut, bh, bw, src_alpha, nsi,
      nsj, noi, noj, gamma_in, gamma_out, reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_blur_chunk(const float* canvas, int rows, const int* lut,
                               const float* bh, const float* bw,
                               const int* src_alpha, int parts, int nsi,
                               int nsj, int noi, int noj, int gamma_in,
                               int gamma_out, float* out, int tile,
                               cudaStream_t stream) {
  if (parts <= 0) return 0;
  if (rows < 0 || nsi < 1 || nsj < 1 || noi < 1 || noj < 1 || parts > 65535 ||
      gamma_in < 0 || gamma_in > 2 || gamma_out < 0 || gamma_out > 2) {
    return (int)cudaErrorInvalidValue;
  }
  switch (tile) {
    case 16:
      return (int)launch<16>(canvas, lut, bh, bw, src_alpha, parts, nsi, nsj,
                             noi, noj, gamma_in, gamma_out, out, stream);
    case 32:
      return (int)launch<32>(canvas, lut, bh, bw, src_alpha, parts, nsi, nsj,
                             noi, noj, gamma_in, gamma_out, out, stream);
    case 64:
      return (int)launch<64>(canvas, lut, bh, bw, src_alpha, parts, nsi, nsj,
                             noi, noj, gamma_in, gamma_out, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
