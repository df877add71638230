// Prepass winding kernel: the (T, T) winding field of every big-segment-class
// row of a plan, and the trailing zero scratch row, in one launch.
//
// Replaces the JAX package's TPU kernel svgrasterize_tpu/ops/fused_exec.py
// _prepass_kernel_factory (launched by prepass_winding), whose inner loop is
// _winding_pass_body.  That kernel packs G = 128 / T edges per 128-lane
// vector register, pre-broadcast by a device-side prep, and banded 8-row
// accumulators; all of that is TPU scheduling and is not carried over.  What
// it computes is the plain version here, ops/batch_exec.py _prepass_winding:
// each pixel of a row's tile sums winding.cuh's closed form over the row's
// padded edge list.
//
// What bounds it on the H100: neither bytes nor FLOPs.  A plan's big rows
// are a few hundred lists of tens to hundreds of edges (about 0.8 MB at
// 1488^2, T = 32), microseconds of the card's bandwidth or arithmetic; the
// time is latency, the longest serial chain of one block.  The first design
// ran one block per class row, each of 256 threads walking every padded
// edge of its row for T*T/256 pixels, one launch per class plus a separate
// zero fill.  Its widest class had 8 blocks on a 132-SM card, and lowering
// has already cut every edge at the interior 8-row boundaries
// (render_plan._band_split_batch), so 3 of 4 (T = 32) or 7 of 8 (T = 64) of
// those (edge, pixel) steps were exact zeros, each still a shared-memory
// read.
//
// Design: one launch per call over every class.  The classes travel by
// value in the kernel's arguments (edge pointer, first output row, width),
// so nothing is uploaded per call; a call of more than
// SVGR_PREPASS_MAX_CLASSES classes is refused (lowering's class widths are
// distinct powers of two, so a plan has far fewer).  One block per (class
// row, band of 8 pixel rows), plus one band set for the zero scratch row,
// which the kernel writes itself: T / 8 times the blocks of the first
// design.  One warp per pixel row (at T = 16 a half-warp, two rows per warp,
// 128 threads), lanes over columns (one per lane at T <= 32, T / 32 of
// them 32 apart at T = 64 and 128), so every store is a coalesced row
// segment and each pixel's sum stays in one thread (no atomics).  The block stages its row's edges through shared
// memory in chunks of one edge per thread: each thread computes edge_params
// for its edge, and edges whose [y_lo, y_hi] misses the band (padding and
// horizontal edges too, sign 0) are dropped with warp ballots and the rest
// compacted in their order, as winding.cu does.  A dropped edge
// contributes an exact 0.0 to every pixel of the band, so each pixel adds
// the same nonzero terms in the same edge order as an unculled walk
// (winding.cuh's math, built with -fmad=false).  The serial chain falls
// from "S_c edges x T^2/256 pixels" to "S_c / chunk staging steps + the
// band's live edges x 1-2 pixels"; a block whose row has no live edge only
// writes zeros.
//
// What is left of that chain is latency: one warp row of a dense class
// row (a star path) still meets tens of edges, each a dependent run of
// some forty operations with an IEEE division.  So each thread evaluates kGroup edges
// at once with edge_contrib_flat (no branches: independent chains the
// scheduler overlaps) and adds them in edge order; a group that misses the
// warp's rows is skipped by the whole warp, and the last total % kGroup
// edges go one at a time through edge_contrib.

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kBand = 8;   // pixel rows per block
constexpr int kGroup = 8;  // edges a thread evaluates at once

struct ClassTable {
  const float4* edges[SVGR_PREPASS_MAX_CLASSES];  // (rows, width) edge lists
  int first_row[SVGR_PREPASS_MAX_CLASSES];        // ascending output rows
  int width[SVGR_PREPASS_MAX_CLASSES];
  int n_classes;
  int total_rows;  // the zero scratch row's index
};

template <int T>
struct Layout {
  static constexpr int kRowsPerWarp = T < 32 ? 32 / T : 1;
  static constexpr int kLanesPerRow = T < 32 ? T : 32;
  static constexpr int kWarps = kBand / kRowsPerWarp;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kPx = T > 32 ? T / 32 : 1;  // columns per lane
};

template <int T>
__global__ void __launch_bounds__(Layout<T>::kThreads)
prepass_kernel(const ClassTable classes, float* __restrict__ out) {
  using L = Layout<T>;
  constexpr int kBands = T / kBand;
  __shared__ EdgeParams s_edges[L::kThreads];
  __shared__ int s_count[L::kWarps];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x / kBands;           // output row
  const int r0 = (blockIdx.x % kBands) * kBand;  // the band's first pixel row
  const int warp_r0 = r0 + warp * L::kRowsPerWarp;
  const int prow = warp_r0 + lane / L::kLanesPerRow;
  const int col0 = lane % L::kLanesPerRow;
  const float rowf = (float)prow;
  const float band_lo = (float)r0;
  const float band_hi = (float)(r0 + kBand);
  const float warp_lo = (float)warp_r0;
  const float warp_hi = (float)(warp_r0 + L::kRowsPerWarp);

  // the class holding this row (the last one starting at or before it; an
  // unrolled scan, so every argument is read at a fixed offset); the zero
  // scratch row has no edges
  const float4* edges = nullptr;
  int width = 0;
  if (row < classes.total_rows) {
    int first = 0;
#pragma unroll
    for (int c = 0; c < SVGR_PREPASS_MAX_CLASSES; ++c) {
      if (c < classes.n_classes && row >= classes.first_row[c]) {
        first = classes.first_row[c];
        width = classes.width[c];
        edges = classes.edges[c];
      }
    }
    edges += (size_t)(row - first) * width;
  }

  float acc[L::kPx];
#pragma unroll
  for (int j = 0; j < L::kPx; ++j) acc[j] = 0.f;

  for (int e0 = 0; e0 < width; e0 += L::kThreads) {
    EdgeParams e;
    bool keep = false;
    if (e0 + tid < width) {
      const float4 v = edges[e0 + tid];
      e = edge_params(v.x, v.y, v.z, v.w);
      keep = e.sign != 0.f && e.y_hi > band_lo && e.y_lo < band_hi;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int base = 0, total = 0;
#pragma unroll
    for (int w = 0; w < L::kWarps; ++w) {
      base += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (keep) s_edges[base + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();

    // kGroup edges at a time, evaluated as independent chains and added
    // in edge order; a group that misses the warp's rows adds only zeros
    int k = 0;
    for (; k + kGroup <= total; k += kGroup) {
      bool meets = false;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        meets |= s_edges[k + g].y_hi > warp_lo && s_edges[k + g].y_lo < warp_hi;
      }
      if (!meets) continue;
#pragma unroll
      for (int j = 0; j < L::kPx; ++j) {
        const float col = (float)(col0 + 32 * j);
        float c[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          c[g] = edge_contrib_flat(s_edges[k + g], rowf, col);
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) acc[j] += c[g];
      }
    }
    for (; k < total; ++k) {
      const EdgeParams& p = s_edges[k];
      if (p.y_hi <= warp_lo || p.y_lo >= warp_hi) continue;  // dy == 0
#pragma unroll
      for (int j = 0; j < L::kPx; ++j) {
        acc[j] += edge_contrib(p, rowf, (float)(col0 + 32 * j));
      }
    }
    __syncthreads();
  }

  float* dst = out + ((size_t)row * T + prow) * T;
#pragma unroll
  for (int j = 0; j < L::kPx; ++j) dst[col0 + 32 * j] = acc[j];
}

template <int T>
cudaError_t launch(const ClassTable& classes, float* out, cudaStream_t stream) {
  const long long blocks = (long long)(classes.total_rows + 1) * (T / kBand);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  prepass_kernel<T><<<(unsigned)blocks, Layout<T>::kThreads, 0, stream>>>(
      classes, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_prepass_winding(const float* const* edges, const int* rows,
                                    const int* widths, int n_classes,
                                    float* out, int tile,
                                    cudaStream_t stream) {
  if (n_classes <= 0 || n_classes > SVGR_PREPASS_MAX_CLASSES) {
    return (int)cudaErrorInvalidValue;
  }
  ClassTable classes{};
  long long total = 0;
  for (int c = 0; c < n_classes; ++c) {
    if (rows[c] < 0 || widths[c] < 0) return (int)cudaErrorInvalidValue;
    classes.edges[c] = reinterpret_cast<const float4*>(edges[c]);
    classes.first_row[c] = (int)total;
    classes.width[c] = widths[c];
    total += rows[c];
  }
  if (total >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  classes.n_classes = n_classes;
  classes.total_rows = (int)total;
  switch (tile) {
    case 16: return (int)launch<16>(classes, out, stream);
    case 32: return (int)launch<32>(classes, out, stream);
    case 64: return (int)launch<64>(classes, out, stream);
    case 128: return (int)launch<128>(classes, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
