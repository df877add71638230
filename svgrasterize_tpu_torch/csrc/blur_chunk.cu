// Blur-chunk kernel: every out-span tile of every chunk of one isolation-
// pass level's lone separable-blur filter parts (the feGaussianBlur parts
// that ops/filter_batch.py batches into chunks), in one launch.
//
// Replaces the JAX package's TPU kernel in
// svgrasterize_tpu/ops/filter_batch.py: _chunk_kernel_factory, launched by
// _apply_chunk_pallas once per chunk.  What it computes, per part b and
// channel c, is the XLA chain of apply_chunk there (and
// ops/filter_batch.apply_chunk here):
//   X   = the part's source span, tile (i, j) read from canvas row
//         lut[b, i * nsj + j] (-1 reads zeros), un-premultiplied and
//         clipped as Layer.convert does (rgb := 0 for SourceAlpha parts),
//         then converted sRGB <-> linear when the chain's colorspace is not
//         the canvas's;
//   O_c = BH[b] @ X_c @ BW[b]^T: crop, separable gaussian and placement in
//         one pair of band-operator products, in plain f32 (no TF32, no
//         tensor cores: the JAX kernel runs Precision.HIGHEST);
//   the blurred rgb converted back, re-premultiplied by the blurred alpha,
//   and cut into (T, T, 4) out tiles, out-span row-major per part.
// The conversion formulas are _planar_convert's, max(..., 1e-12) guards
// included.
//
// What bounds it on the H100: the bytes of the span rows, band operators
// and out tiles (a few MB a level) and the multiply-adds over the band
// operators' nonzero entries.  The first design ran one block per (part,
// out tile) and chunk, one launch per chunk, and multiplied each out
// tile's (T, H) slice of BH by the whole span and its (T, W) slice of BW:
// ~128x its bound on a level of 32 parts, almost all of it products with
// the zeros outside the operators' bands (about T + taps - 1 columns wide)
// and with the all-zero tiles that pad a chunk's smaller parts to its
// largest, plus six rounds of host dispatch, and 222 registers at T = 64.
//
// Design: one launch per level.  filter_batch.pack_level concatenates the
// level's chunks (lut, bh, bw, src_alpha) and gives each chunk a table row
// (its first out tile, sizes, offsets, colorspace), each (part, 16-row
// block of the out span) of BH and each (part, out-tile column) of BW its
// band of nonzero columns [lo, hi).  A block is a kRows = 16-row slice of
// one out tile (T / 16 blocks a tile; 256 threads, 512 at T = 128, so at
// most 4 px and 2 Z entries per thread); it finds its chunk by binary
// search over the first out tiles, as winding.cu does, and walks only the
// band: for each kC-column step of the BW band it accumulates
// Z = BH[rows, h band] @ X[h band, step] in registers over the kC-row
// steps of the BH band, staging the BH and converted X tiles in shared
// memory, then stages Z and adds Z @ BW[tile cols, step]^T into the out
// rows' registers.  The products
// are plain f32 fused multiply-adds (explicit, whatever -fmad says), as
// the plain version's matmul runs them; a thread's Z entries share a
// column and its out pixels a column, so each staged X pixel and BW entry
// is read once for them all.  The steps keep the dense walk's kC
// alignment, and every skipped product is 0 x a finite x >= 0, so each
// skipped fused multiply-add returns its sum unchanged: each sum adds the
// same nonzero terms in the same order as the dense walk, bit for bit.
// An out tile with an empty band (the padding of a chunk's smaller parts)
// writes zeros and reads nothing.  The chunk table (up to 64 chunks) and
// the canvas rows of the span tiles under a block's bands (up to 64) are
// staged in shared memory first, so a block waits on three dependent
// loads before its first step and on one a step; pack_level puts the
// chunks with the longest walks first, so their blocks start first.  A
// register cap keeps 512 threads on an SM, and static shared memory stays
// under 48 KB at every T (38,912 bytes at T = 128), whatever the span's
// size.

#include "kernels.h"

namespace {

template <int T>
struct BlurLayout {
  // threads a block: 256, and 512 at T = 128, so that a thread holds at
  // most 4 out pixels and 2 Z entries at every T (256 threads at T = 128
  // hold 8 pixels and spill under the 128-register cap)
  static constexpr int kThreads = T == 128 ? 512 : 256;
  static constexpr int kC = T < 32 ? T : 32;       // span rows / columns per step
  static constexpr int kRows = 16;                  // out rows per block
  static constexpr int kSplit = T / kRows;          // blocks per out tile
  static constexpr int kPairs = kRows * kC / kThreads;  // Z entries per thread
  static constexpr int kPx = kRows * T / kThreads;      // out pixels per thread
  static constexpr int kBhPer = kRows * kC / kThreads;  // staged per thread
  static constexpr int kXPer = kC * kC / kThreads;
  static constexpr int kBwPer = T * kC / kThreads;
  // blocks an SM must hold: 2 of 256 threads, 1 of 512, at most 128
  // registers a thread (a cap of 80 spills at T = 32 and 64)
  static constexpr int kMinBlocks = 512 / kThreads;
};

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

// A span pixel as the blur reads it: Layer.convert(pre_alpha=False) (rgb
// := 0 for SourceAlpha parts, rgb / a where a > 1e-4, clip), then the
// chain's colorspace.
__device__ __forceinline__ float4 convert_in(float4 v, bool alpha_only,
                                             int gamma) {
  if (alpha_only) v.x = v.y = v.z = 0.f;
  const bool pos = v.w > 0.0001f;
  const float safe = pos ? v.w : 1.f;
  if (pos) {
    v.x = v.x / safe;
    v.y = v.y / safe;
    v.z = v.z / safe;
  }
  v.x = convert_gamma(clip01(v.x), gamma);
  v.y = convert_gamma(clip01(v.y), gamma);
  v.z = convert_gamma(clip01(v.z), gamma);
  v.w = clip01(v.w);
  return v;
}

// a level's chunk table and a block's span-tile rows staged in shared
// memory when they fit (else read from device memory)
constexpr int kTableInts = 64 * SVGR_BLUR_TABLE_COLS;
constexpr int kLutSlots = 64;

template <int T>
__global__ void __launch_bounds__(BlurLayout<T>::kThreads, BlurLayout<T>::kMinBlocks)
blur_level_kernel(const float4* __restrict__ canvas, int canvas_rows,
                  const int* __restrict__ lut, const float* __restrict__ bh,
                  const float* __restrict__ bw,
                  const int* __restrict__ src_alpha,
                  const int2* __restrict__ hband,
                  const int2* __restrict__ wband,
                  const int* __restrict__ table, int n_chunks, int linear_rgb,
                  float4* __restrict__ out) {
  using L = BlurLayout<T>;
  constexpr int kThreads = L::kThreads;
  constexpr int kC = L::kC;
  constexpr int kRows = L::kRows;
  constexpr int kZ = 4 * kRows * kC;                 // staged Z, channel-planar
  constexpr int kOperands = kRows * kC + 4 * kC * kC;  // BH tile + X tile
  constexpr int kUnion = kZ > kOperands ? kZ : kOperands;
  constexpr int kBwStride = kC + 1;                  // padded: no bank conflicts
  __shared__ __align__(16) float smem[kUnion + T * kBwStride];
  float* s_bh = smem;                                        // (kRows, kC)
  float4* s_x = reinterpret_cast<float4*>(smem + kRows * kC);  // (kC, kC)
  float* s_z = smem;                                         // (4, kRows, kC)
  float* s_bw = smem + kUnion;                               // (T, kC + 1)

  __shared__ int s_table[kTableInts];
  __shared__ int s_lut[kLutSlots];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / L::kSplit;  // the level's out tile
  const int r0 = (blockIdx.x % L::kSplit) * kRows;

  // the chunk holding this tile: the last one starting at or before it
  const int* tab = table;
  if (n_chunks * SVGR_BLUR_TABLE_COLS <= kTableInts) {
    for (int e = tid; e < n_chunks * SVGR_BLUR_TABLE_COLS; e += kThreads) {
      s_table[e] = table[e];
    }
    __syncthreads();
    tab = s_table;
  }
  int lo = 0, hi = n_chunks;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tab[mid * SVGR_BLUR_TABLE_COLS + SVGR_BT_OUT] <= tile) lo = mid; else hi = mid;
  }
  const int* ck = tab + lo * SVGR_BLUR_TABLE_COLS;
  const int nsi = ck[SVGR_BT_NSI], nsj = ck[SVGR_BT_NSJ];
  const int noi = ck[SVGR_BT_NOI], noj = ck[SVGR_BT_NOJ];
  const int local = tile - ck[SVGR_BT_OUT];
  const int b = local / (noi * noj);
  const int oi = local % (noi * noj) / noj;
  const int oj = local % noj;
  const int H = nsi * T;
  const int W = nsj * T;
  const int* lut_b = lut + ck[SVGR_BT_LUT] + (size_t)b * nsi * nsj;
  const float* bh_b =
      bh + ck[SVGR_BT_BH] + ((size_t)b * noi * T + (size_t)oi * T + r0) * H;
  const float* bw_b = bw + ck[SVGR_BT_BW] + ((size_t)b * noj * T + (size_t)oj * T) * W;
  const bool alpha_only = src_alpha[ck[SVGR_BT_PART] + b] != 0;
  const int2 hb = hband[ck[SVGR_BT_HB] + (b * noi + oi) * L::kSplit + r0 / kRows];
  const int2 wb = wband[ck[SVGR_BT_WB] + b * noj + oj];
  // gamma codes: 0 none, 1 sRGB -> linear, 2 linear -> sRGB
  const bool chain_linear = ck[SVGR_BT_LINEAR] != 0;
  const int gamma_in = chain_linear == (linear_rgb != 0) ? 0 : (chain_linear ? 1 : 2);
  const int gamma_out = gamma_in == 0 ? 0 : 3 - gamma_in;

  float4 acc[L::kPx];
#pragma unroll
  for (int i = 0; i < L::kPx; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the bands' kC-aligned steps; an empty band (lo >= hi) walks none
  const int ww = tid % kC;  // this thread's Z column and out column
  const int q = tid % T;
  const int w_end = hb.x < hb.y && wb.x < wb.y ? wb.y : 0;
  // the canvas rows of the span tiles the bands cover: lut_src[(ti - ti0) *
  // stride + tj - tj0] is span tile (ti, tj)'s
  const int ti0 = hb.x / T, tj0 = wb.x / T;
  const int nti = (hb.y + T - 1) / T - ti0, ntj = (wb.y + T - 1) / T - tj0;
  const int* lut_src = lut_b;
  int lut_i0 = 0, lut_j0 = 0, lut_stride = nsj;
  if (w_end > 0 && nti * ntj <= kLutSlots) {
    for (int e = tid; e < nti * ntj; e += kThreads) {
      s_lut[e] = lut_b[(ti0 + e / ntj) * nsj + tj0 + e % ntj];
    }
    lut_src = s_lut;
    lut_i0 = ti0, lut_j0 = tj0, lut_stride = ntj;
  }
  __syncthreads();
  for (int w0 = wb.x / kC * kC; w0 < w_end; w0 += kC) {
    float4 z[L::kPairs];
#pragma unroll
    for (int p = 0; p < L::kPairs; ++p) z[p] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int h0 = hb.x / kC * kC; h0 < hb.y; h0 += kC) {
      // stage BH[block rows, h0 : h0 + kC] and the converted span pixels
      // X[h0 : h0 + kC, w0 : w0 + kC] (one span tile: kC divides T)
#pragma unroll
      for (int i = 0; i < L::kBhPer; ++i) {
        const int e = tid + i * kThreads;
        s_bh[e] = bh_b[(size_t)(e / kC) * H + h0 + e % kC];
      }
      const int row = lut_src[(h0 / T - lut_i0) * lut_stride + w0 / T - lut_j0];
      const bool ok = row >= 0 && row < canvas_rows;
      const float4* src = canvas + ((size_t)(ok ? row : 0) * T + h0 % T) * T + w0 % T;
#pragma unroll
      for (int i = 0; i < L::kXPer; ++i) {
        const int e = tid + i * kThreads;
        const float4 v = ok ? src[(e / kC) * T + e % kC] : make_float4(0.f, 0.f, 0.f, 0.f);
        s_x[e] = convert_in(v, alpha_only, gamma_in);
      }
      __syncthreads();
      for (int hh = 0; hh < kC; ++hh) {
        const float4 x = s_x[hh * kC + ww];
#pragma unroll
        for (int p = 0; p < L::kPairs; ++p) {
          const float a = s_bh[((tid + p * kThreads) / kC) * kC + hh];
          z[p].x = __fmaf_rn(a, x.x, z[p].x);
          z[p].y = __fmaf_rn(a, x.y, z[p].y);
          z[p].z = __fmaf_rn(a, x.z, z[p].z);
          z[p].w = __fmaf_rn(a, x.w, z[p].w);
        }
      }
      __syncthreads();
    }

    // stage Z (over the operand tiles, now dead) and BW[tile cols, step]
#pragma unroll
    for (int p = 0; p < L::kPairs; ++p) {
      const int e = tid + p * kThreads;  // r * kC + ww
      s_z[e] = z[p].x;
      s_z[kRows * kC + e] = z[p].y;
      s_z[2 * kRows * kC + e] = z[p].z;
      s_z[3 * kRows * kC + e] = z[p].w;
    }
#pragma unroll
    for (int i = 0; i < L::kBwPer; ++i) {
      const int e = tid + i * kThreads;
      s_bw[(e / kC) * kBwStride + e % kC] = bw_b[(size_t)(e / kC) * W + w0 + e % kC];
    }
    __syncthreads();
    const float* bq = s_bw + q * kBwStride;
    for (int c = 0; c < kC; ++c) {
      const float g = bq[c];
#pragma unroll
      for (int i = 0; i < L::kPx; ++i) {
        const float* zr = s_z + ((tid + i * kThreads) / T) * kC + c;
        acc[i].x = __fmaf_rn(zr[0], g, acc[i].x);
        acc[i].y = __fmaf_rn(zr[kRows * kC], g, acc[i].y);
        acc[i].z = __fmaf_rn(zr[2 * kRows * kC], g, acc[i].z);
        acc[i].w = __fmaf_rn(zr[3 * kRows * kC], g, acc[i].w);
      }
    }
    __syncthreads();
  }

  // back to premultiplied, in the canvas's colorspace
  float4* dst = out + ((size_t)tile * T + r0) * T;
#pragma unroll
  for (int i = 0; i < L::kPx; ++i) {
    float4 v = acc[i];
    v.x = convert_gamma(v.x, gamma_out) * v.w;
    v.y = convert_gamma(v.y, gamma_out) * v.w;
    v.z = convert_gamma(v.z, gamma_out) * v.w;
    dst[tid + i * kThreads] = v;
  }
}

template <int T>
cudaError_t launch(const float* canvas, int rows, const int* lut,
                   const float* bh, const float* bw, const int* src_alpha,
                   const int* hband, const int* wband, const int* table,
                   int n_chunks, int tiles, int linear_rgb, float* out,
                   cudaStream_t stream) {
  const long long blocks = (long long)tiles * BlurLayout<T>::kSplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  blur_level_kernel<T><<<(unsigned)blocks, BlurLayout<T>::kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(canvas), rows, lut, bh, bw, src_alpha,
      reinterpret_cast<const int2*>(hband), reinterpret_cast<const int2*>(wband),
      table, n_chunks, linear_rgb, reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_blur_level(const float* canvas, int rows, const int* lut,
                               const float* bh, const float* bw,
                               const int* src_alpha, const int* hband,
                               const int* wband, const int* table,
                               int n_chunks, int tiles, int linear_rgb,
                               float* out, int tile, cudaStream_t stream) {
  if (tiles <= 0) return 0;
  if (rows < 0 || n_chunks < 1) return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 16:
      return (int)launch<16>(canvas, rows, lut, bh, bw, src_alpha, hband,
                             wband, table, n_chunks, tiles, linear_rgb, out,
                             stream);
    case 32:
      return (int)launch<32>(canvas, rows, lut, bh, bw, src_alpha, hband,
                             wband, table, n_chunks, tiles, linear_rgb, out,
                             stream);
    case 64:
      return (int)launch<64>(canvas, rows, lut, bh, bw, src_alpha, hband,
                             wband, table, n_chunks, tiles, linear_rgb, out,
                             stream);
    case 128:
      return (int)launch<128>(canvas, rows, lut, bh, bw, src_alpha, hband,
                              wband, table, n_chunks, tiles, linear_rgb, out,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
