// Prepass winding kernel: the winding field of each big-segment-class row.
//
// Replaces the JAX package's TPU kernel svgrasterize_tpu/ops/fused_exec.py
// _prepass_kernel_factory (launched by prepass_winding), whose inner loop is
// _winding_pass_body.  That kernel packs G = 128 / T edges per 128-lane
// vector register, pre-broadcast by a device-side prep, and banded 8-row
// accumulators; all of that is TPU scheduling and is not carried over.
//
// What bounds it on the H100: arithmetic.  Each (edge, pixel) pair costs
// ~25 FP32 operations including one division, and a row of S edges over a
// T x T tile reads only 16 S bytes of edges but does S T^2 pair
// evaluations; device memory traffic is negligible beside that.
//
// Design: one block per class row, 256 threads, each thread owning
// T*T/256 pixels of the tile in registers.  The row's edges are staged
// through shared memory in chunks of 256 (their per-edge parameters
// computed once, by one thread each), then every thread sums the closed
// form over the chunk for its pixels.  Padding and horizontal edges
// (sign 0) are skipped uniformly across the block; rows outside an edge's
// extent return early inside edge_contrib.  A warp covers one or two
// whole pixel rows, so that early return is mostly warp-uniform.

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kThreads = 256;

template <int T>
__global__ void __launch_bounds__(kThreads)
prepass_kernel(const float4* __restrict__ edges, float* __restrict__ out,
               int width) {
  constexpr int kPx = T * T / kThreads;
  __shared__ EdgeParams s_edges[kThreads];

  const float4* row_edges = edges + (size_t)blockIdx.x * width;
  float acc[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) acc[i] = 0.f;

  for (int base = 0; base < width; base += kThreads) {
    const int n = min(kThreads, width - base);
    if (threadIdx.x < n) {
      float4 v = row_edges[base + threadIdx.x];
      s_edges[threadIdx.x] = edge_params(v.x, v.y, v.z, v.w);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const EdgeParams e = s_edges[k];
      if (e.sign == 0.f) continue;  // contributes an exact zero
#pragma unroll
      for (int i = 0; i < kPx; ++i) {
        const int px = threadIdx.x + i * kThreads;
        acc[i] += edge_contrib(e, (float)(px / T), (float)(px % T));
      }
    }
    __syncthreads();
  }

  float* dst = out + (size_t)blockIdx.x * T * T;
#pragma unroll
  for (int i = 0; i < kPx; ++i) dst[threadIdx.x + i * kThreads] = acc[i];
}

template <int T>
cudaError_t launch(const float* edges, float* out, int rows, int width,
                   cudaStream_t stream) {
  prepass_kernel<T><<<rows, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(edges), out, width);
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_prepass_winding(const float* edges, float* out, int rows,
                                    int width, int tile, cudaStream_t stream) {
  if (rows <= 0) return 0;
  switch (tile) {
    case 16: return (int)launch<16>(edges, out, rows, width, stream);
    case 32: return (int)launch<32>(edges, out, rows, width, stream);
    case 64: return (int)launch<64>(edges, out, rows, width, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
