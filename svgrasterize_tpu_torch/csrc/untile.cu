// Untile: a frame's canvas tiles copied into the viewport-sized, row-major
// layer that a render returns, in one pass.
//
// It replaces no TPU kernel: the JAX package untiles with XLA operations (a
// reshape, a transpose and a slice).  The port ran the same operations in
// PyTorch, and a served request paid two full copies of the frame for them:
// the captured graph's output cloned for the caller, then the clone
// permuted into a row-major canvas.  This kernel is one copy, from the
// tiles straight into the layer, and it moves only the viewport's pixels:
// rows and columns of the tile grid past the viewport are neither read nor
// written.  It copies bits and computes nothing, so the layer equals the
// plain reshape, permute and crop (render_plan.tiles_to_layer on the CPU)
// bit for bit.
//
// What bounds it on the H100: device memory bandwidth; it reads and writes
// h x w x 16 bytes.  One thread moves one pixel as one float4, and a block
// of 512 threads covers a run of consecutive pixels of one layer row: a
// warp reads consecutive pixels of one tile row (T x 16 contiguous bytes;
// two tiles' rows at T=16) and writes the same pixels of the layer row,
// coalesced on both sides at every tile size.  Measured on the H100 at the
// served frames (3840^2 T=64, 7680^2 T=128, 3840 x 985 T=32), two or four
// pixels a thread and blocks of 64 to 256 threads were 0.2-0.6 % slower,
// and streaming loads and stores (__ldcs, __stcs) 0.5-1.5 % slower.

#include "kernels.h"

namespace {

constexpr int kThreads = 512;     // pixels of a block's run
constexpr int kMaxGridY = 65535;  // rows beyond it loop

__global__ void __launch_bounds__(kThreads)
untile_kernel(const float4* __restrict__ tiles, float4* __restrict__ out,
              int grid_w, int shift, int h, int w) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= w) return;
  // the pixel's tile column j and its column in the tile; tile (i, j) starts
  // (i * grid_w + j) * T * T pixels in
  const size_t col = ((size_t)(x >> shift) << (2 * shift)) + (x & ((1 << shift) - 1));
  for (int y = blockIdx.y; y < h; y += gridDim.y) {
    const size_t row = (((size_t)(y >> shift) * grid_w) << (2 * shift)) +
                       ((size_t)(y & ((1 << shift) - 1)) << shift);
    out[(size_t)y * w + x] = tiles[row + col];
  }
}

}  // namespace

extern "C" int svgr_untile(const float* tiles, int grid_w, int tile,
                           float* out, int h, int w, cudaStream_t stream) {
  int shift;
  switch (tile) {
    case 16: shift = 4; break;
    case 32: shift = 5; break;
    case 64: shift = 6; break;
    case 128: shift = 7; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (h <= 0 || w <= 0) return 0;
  const dim3 grid((w + kThreads - 1) / kThreads, h < kMaxGridY ? h : kMaxGridY);
  untile_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(tiles), reinterpret_cast<float4*>(out),
      grid_w, shift, h, w);
  return (int)cudaGetLastError();
}
