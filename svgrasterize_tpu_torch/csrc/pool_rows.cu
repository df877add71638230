// Pool row writer: one isolation-pass level's new rows, written into the
// pass pool in place.
//
// Replaces the JAX package's TPU kernel in svgrasterize_tpu/render_plan.py:
// _pool_update_aliased, an input-output-aliased row writer that puts a
// level's rows at pool[lo : lo + n].  Here one launch writes
// pool[dst_idx[i]] = src[src_idx[i]] for an output block of a level (the
// plain pass rows of the level's canvas, one filter part's tiles, or one
// blur chunk's tiles), so it also takes the place of the JAX level's
// out-tile gather, row concatenation and permutation before the update.
//
// What bounds it on the H100: device memory bandwidth; it moves
// 2 x T x T x 16 bytes per row and computes nothing.
//
// Design: one block per row, 256 threads copying float4s; indices out of
// range are skipped.  The source never aliases the pool (it is a level's
// canvas or a filter's output), so rows are independent.

#include "kernels.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pool_rows_kernel(float4* __restrict__ pool, int pool_rows,
                 const float4* __restrict__ src, int src_rows,
                 const int* __restrict__ src_idx,
                 const int* __restrict__ dst_idx, int row_len) {
  const int i = blockIdx.x;
  const int s = src_idx[i];
  const int d = dst_idx[i];
  if (s < 0 || s >= src_rows || d < 0 || d >= pool_rows) return;
  const float4* from = src + (size_t)s * row_len;
  float4* to = pool + (size_t)d * row_len;
  for (int e = threadIdx.x; e < row_len; e += kThreads) to[e] = from[e];
}

}  // namespace

extern "C" int svgr_pool_rows(float* pool, int pool_rows, const float* src,
                              int src_rows, const int* src_idx,
                              const int* dst_idx, int n, int tile,
                              cudaStream_t stream) {
  if (n <= 0) return 0;
  if (tile != 16 && tile != 32 && tile != 64 && tile != 128) {
    return (int)cudaErrorInvalidValue;
  }
  pool_rows_kernel<<<n, kThreads, 0, stream>>>(
      reinterpret_cast<float4*>(pool), pool_rows,
      reinterpret_cast<const float4*>(src), src_rows, src_idx, dst_idx,
      tile * tile);
  return (int)cudaGetLastError();
}
