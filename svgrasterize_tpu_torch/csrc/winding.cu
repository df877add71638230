// Whole-image winding kernel: the (height, width) anti-aliased winding
// field of each of a batch of edge lists, the interpreter's path masks
// (render.py _mask_padded, batched per render by render.MaskBatch).
//
// Replaces the JAX package's TPU kernel svgrasterize_tpu/ops/
// pallas_coverage.py _winding_kernel (launched by winding_pallas), which
// walks (8, 128) output blocks of one mask and streams the whole padded
// edge list through each in chunks of 32.  What it computes is
// ops/coverage.py's closed form (the plain version here is
// svgrasterize_tpu_torch/ops/coverage.winding, once per mask): each pixel
// sums sign * dy * mean over the edges, rows outside [0, height) drop,
// columns clamp on the left.
//
// What bounds it on the H100: on a large list, arithmetic.  It writes
// height * width * 4 bytes once and reads 16 bytes per edge per block,
// while every (edge, pixel) pair whose row the edge crosses needs 16 FP32
// operations (the column-dependent part of edge_contrib) on top of 12 per
// (edge, row) for the row clip and slab columns; a path with hundreds of
// edges over a large mask is thousands of operations per byte written.
// Each lane recomputes the (edge, row) part for its own columns, so the
// kernel does about 16 + 12 / 4 operations per pair where the function
// needs 16.  On the interpreter's masks (tens of edges over a few hundred
// pixels each) neither: a mask is well under a microsecond of card work,
// and one launch per mask cost its host dispatch and a pageable upload
// (~15-30 us a mask).  So one launch takes a whole batch of masks.
//
// Design: one block of 256 threads per 8 x 128 output pixels of a mask;
// the grid is flat over every mask's blocks.  A batch launch reads a
// per-mask table (edge offset, edge count, height, width, output offset,
// first block) and a block finds its mask by binary search over "first
// block"; the one-mask entry (svgr_winding) passes its one entry by value
// instead, so the same kernel serves both and each mask's field is the
// same bit for bit.  Within a mask: warp w owns row r0 + w and each lane
// four columns (lane + 32 j), so every output write is a coalesced
// 128-byte row segment and each pixel's sum lives in one thread (no
// atomics).  The block stages the mask's edge list through shared memory in
// chunks of 256: each thread turns one edge into its parameters (sign,
// y_lo, y_hi, x_lo, slope) once per block, and edges that contribute an
// exact zero to the whole block are dropped before anyone reads them:
// padding and horizontal edges, edges whose [y_lo, y_hi] misses the
// block's rows, and edges that lie right of the block by more than a pixel.
// The survivors are compacted in their original order (warp ballots and a
// prefix over the 8 warps), so each pixel adds its contributions in edge
// order.  Every lane of a warp then reads the same edge (a shared-memory
// broadcast), and an edge that misses the warp's row is skipped by the
// whole warp at once.  The per-(edge, pixel) math is winding.cuh's, shared
// with prepass.cu and scene.cu; the library is built with -fmad=false.

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kRows = 8;              // block rows: one warp each
constexpr int kCols = 128;            // block columns: 4 per lane
constexpr int kThreads = 32 * kRows;  // 256
constexpr int kChunk = kThreads;      // edges staged per step
constexpr int kPx = kCols / 32;       // columns per thread

// one row of the batch table (SVGR_WINDING_TABLE_COLS int32 columns)
struct MaskEntry {
  int edge_off, segs, height, width, out_off, first_block;
};

__global__ void __launch_bounds__(kThreads)
winding_kernel(const float4* __restrict__ edges,
               const int* __restrict__ table, int n_masks, MaskEntry m,
               float* __restrict__ out) {
  __shared__ EdgeParams s_edges[kChunk];
  __shared__ int s_count[kRows];

  const int block = blockIdx.x;
  if (table != nullptr) {
    // the last mask whose first block is <= this block; a mask without
    // blocks shares its first block with the next one, so it is never found
    int lo = 0, hi = n_masks;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (table[mid * SVGR_WINDING_TABLE_COLS + 5] <= block) lo = mid + 1;
      else hi = mid;
    }
    const int* t = table + (lo - 1) * SVGR_WINDING_TABLE_COLS;
    m = MaskEntry{t[0], t[1], t[2], t[3], t[4], t[5]};
  }
  const int height = m.height, width = m.width, segs = m.segs;
  const float4* mask_edges = edges + m.edge_off;
  const int local = block - m.first_block;
  const int col_blocks = (width + kCols - 1) / kCols;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (local / col_blocks) * kRows;
  const int c0 = (local % col_blocks) * kCols;
  const int row = r0 + warp;
  const float rowf = (float)row;
  const float block_lo = (float)r0;
  const float block_hi = (float)(r0 + kRows);
  // an edge whose every point lies at column >= c0 + kCols + 1 gives
  // g <= -1 at every pixel of the block: an exact zero contribution
  const float right = (float)(c0 + kCols + 1);

  float acc[kPx];
#pragma unroll
  for (int j = 0; j < kPx; ++j) acc[j] = 0.f;

  for (int e0 = 0; e0 < segs; e0 += kChunk) {
    EdgeParams e;
    bool keep = false;
    if (e0 + tid < segs) {
      const float4 v = mask_edges[e0 + tid];
      e = edge_params(v.x, v.y, v.z, v.w);
      keep = e.sign != 0.f && e.y_hi > block_lo && e.y_lo < block_hi &&
             fminf(v.y, v.w) < right;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      base += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (keep) s_edges[base + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();

    if (row < height) {
      for (int k = 0; k < total; ++k) {
        const EdgeParams& p = s_edges[k];
        if (p.y_hi <= rowf || p.y_lo >= rowf + 1.f) continue;  // dy == 0
#pragma unroll
        for (int j = 0; j < kPx; ++j) {
          acc[j] += edge_contrib(p, rowf, (float)(c0 + lane + 32 * j));
        }
      }
    }
    __syncthreads();
  }

  if (row < height) {
    float* dst = out + m.out_off + (size_t)row * width;
#pragma unroll
    for (int j = 0; j < kPx; ++j) {
      const int col = c0 + lane + 32 * j;
      if (col < width) dst[col] = acc[j];
    }
  }
}

}  // namespace

extern "C" int svgr_winding(const float* edges, int segs, float* out,
                            int height, int width, cudaStream_t stream) {
  if (height <= 0 || width <= 0) return 0;
  if (segs < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((width + kCols - 1) / kCols) *
                           ((height + kRows - 1) / kRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const MaskEntry one{0, segs, height, width, 0, 0};
  winding_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(edges), nullptr, 1, one, out);
  return (int)cudaGetLastError();
}

extern "C" int svgr_winding_batch(const float* edges, const int* table,
                                  int n_masks, int blocks, float* out,
                                  cudaStream_t stream) {
  if (n_masks <= 0 || blocks <= 0) return 0;
  winding_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(edges), table, n_masks, MaskEntry{},
      out);
  return (int)cudaGetLastError();
}
