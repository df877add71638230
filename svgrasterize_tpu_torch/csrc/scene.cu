// Scene kernel: every canvas tile of an item stream (the main stream or an
// isolation-pass group's), composed in z order from its work items.
//
// Replaces the JAX package's main TPU kernel in
// svgrasterize_tpu/ops/fused_exec.py: _kernel_factory_kvec (the default),
// _kernel_factory_k and _kernel_factory, with the per-item math of
// _item_compute, launched by execute_items_fused.  The TPU kernel walks the
// items on a sequential grid with a revisited output block per tile, ring
// flushes, channel-planar (T, 4T) tiles and several streaming layouts; all
// of that is TPU scheduling.  What it computes, and what this kernel
// computes, is the XLA executor's (svgrasterize_tpu/ops/batch_exec.py
// execute_items), item by item:
//   winding = inline edges (or the item's big-class prepass row) + carry;
//   coverage by fill rule; x clip field; zeroed below 1e-6; x opacity;
//   x the luminance of a pool row (mask items, mask_idx >= 0);
//   paint (solid, linear, radial, or a pattern: the modular gather from
//   the plan's pattern-tile atlas; a pool row for texture items,
//   tex_idx >= 0; a collapsed-run field overrides last);
//   acc = rgba + acc * (1 - rgba.a).
// The 1e-6 floor comes before the opacity, as in batch_exec.py; the TPU
// kernel applies it after.  The TPU path precomputes a (T, T, 4) field
// per pattern item before its kernel runs (TPU scheduling); here the
// pattern item's gather index is computed at each pixel from its
// parameters, in the operation order of batch_exec._paint_item.
//
// What bounds it on the H100: arithmetic in the inline winding (up to 64
// edges x T^2 pixels per item, ~25 FP32 operations per pair) and in the
// gradient paints; per item it reads under 2 KB of parameters and at most
// one T x T field per stack (two pool rows for a masked texture item), and
// writes each tile once.
//
// Design: one block per canvas tile, so tile runs are independent and no
// block synchronises with another.  Thread 0 and 1 find the tile's item run
// by binary search in the sorted tile_id (padding items sit at num_tiles,
// past every block).  Each of the 256 threads keeps the RGBA accumulator
// of its T*T/256 pixels in registers for the whole run; per item the
// block stages the item's edge parameters, stops and scalars in shared
// memory and every thread evaluates its pixels.  Each tile is written once,
// as float4 (T, T, 4) rows; tiles with no items are written as zeros.

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kThreads = 256;

// Python-style floating remainder (torch.remainder / jnp.remainder).
__device__ __forceinline__ float py_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
}

__device__ __forceinline__ int lower_bound(const int* __restrict__ a, int n,
                                           int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Linear or radial gradient paint at pixel (row, col) of the item's tile;
// the operation order follows ops/batch_exec.py _paint.
__device__ float4 gradient_paint(int kind, int spread, const float* fp,
                                 int row, int col, const float* s_off,
                                 const float4* s_col, int k_stops) {
  const float rr = ((float)row + fp[SVGR_F_TILE_R]) + 0.5f;
  const float cc = ((float)col + fp[SVGR_F_TILE_C]) + 0.5f;
  const float* m = fp + SVGR_F_AFFINE;
  const float gx = rr * m[0] + cc * m[1] + m[2];
  const float gy = rr * m[3] + cc * m[4] + m[5];

  float t;
  bool valid = true;
  if (kind == SVGR_PAINT_LINEAR) {
    const float p0x = fp[SVGR_F_P0], p0y = fp[SVGR_F_P0 + 1];
    const float vec0 = fp[SVGR_F_P1] - p0x;
    const float vec1 = fp[SVGR_F_P1 + 1] - p0y;
    const float denom = fmaxf(vec0 * vec0 + vec1 * vec1, 1e-30f);
    t = ((gx - p0x) * vec0 + (gy - p0y) * vec1) / denom;
  } else {
    const float radius = fp[SVGR_F_RADIUS];
    const float fradius = fp[SVGR_F_FRADIUS];
    const float fcx = fp[SVGR_F_FCENTER], fcy = fp[SVGR_F_FCENTER + 1];
    const float cd0 = fp[SVGR_F_CENTER] - fcx;
    const float cd1 = fp[SVGR_F_CENTER + 1] - fcy;
    const float pd0 = gx - fcx;
    const float pd1 = gy - fcy;
    const float rd = radius - fradius;
    const float a = cd0 * cd0 + cd1 * cd1 - rd * rd;
    const float b = pd0 * cd0 + pd1 * cd1 + fradius * rd;
    const float c = pd0 * pd0 + pd1 * pd1 - fradius * fradius;
    const float det = b * b - a * c;
    const float sq = sqrtf(fmaxf(det, 0.f));
    const float a_safe = fabsf(a) > 1e-30f ? a : 1e-30f;
    t = fmaxf((b + sq) / a_safe, (b - sq) / a_safe);
    valid = det >= 0.f;
    if (fabsf(rd) > 1e-12f) valid = valid && (t > fradius / (fradius - radius));
  }
  if (spread == 1) {
    t = t - truncf(t);
  } else if (spread == 2) {
    t = fabsf(py_remainder(t + 1.f, 2.f) - 1.f);
  }

  float4 g = s_col[0];
  for (int k = 1; k < k_stops; ++k) {
    const float o0 = s_off[k - 1];
    const float o1 = s_off[k];
    const float span = o1 - o0;
    float ratio;
    if (span > 1e-12f) {
      ratio = fminf(fmaxf((t - o0) / span, 0.f), 1.f);
    } else {
      ratio = t >= o1 ? 1.f : 0.f;  // duplicate offsets step at the stop
    }
    const float4 c0 = s_col[k - 1];
    const float4 c1 = s_col[k];
    g.x = g.x + ratio * (c1.x - c0.x);
    g.y = g.y + ratio * (c1.y - c0.y);
    g.z = g.z + ratio * (c1.z - c0.z);
    g.w = g.w + ratio * (c1.w - c0.w);
  }
  if (kind == SVGR_PAINT_RADIAL && !valid) g = make_float4(0.f, 0.f, 0.f, 0.f);
  return g;
}

// Pattern paint at pixel (row, col) of the item's tile: device pixel ->
// pattern user space (the item's affine) -> the modular cell -> atlas
// pixels (pat_fwd), truncated toward zero and clamped to the tile.
__device__ float4 pattern_paint(const float* fp, const int* ip, int row,
                                int col, const float4* __restrict__ atlas,
                                int pat_h, int pat_w) {
  const float rr = ((float)row + fp[SVGR_F_TILE_R]) + 0.5f;
  const float cc = ((float)col + fp[SVGR_F_TILE_C]) + 0.5f;
  const float* m = fp + SVGR_F_AFFINE;
  const float gx = rr * m[0] + cc * m[1] + m[2];
  const float gy = rr * m[3] + cc * m[4] + m[5];
  const float q0 = py_remainder(gx - fp[SVGR_F_PAT_XY], fp[SVGR_F_PAT_WH]);
  const float q1 =
      py_remainder(gy - fp[SVGR_F_PAT_XY + 1], fp[SVGR_F_PAT_WH + 1]);
  const float* f = fp + SVGR_F_PAT_FWD;
  const float s0 = q0 * f[0] + q1 * f[1] + f[2];
  const float s1 = q0 * f[3] + q1 * f[4] + f[5];
  const int i0 = min(max((int)s0 - ip[SVGR_I_PAT_LO], 0), ip[SVGR_I_PAT_MAX]);
  const int i1 =
      min(max((int)s1 - ip[SVGR_I_PAT_LO + 1], 0), ip[SVGR_I_PAT_MAX + 1]);
  return atlas[((size_t)ip[SVGR_I_PAT] * pat_h + i0) * pat_w + i1];
}

template <int T>
__global__ void __launch_bounds__(kThreads)
scene_kernel(const float4* __restrict__ lines, int segs,
             const float* __restrict__ carry, const int* __restrict__ tile_id,
             int n_items, const int* __restrict__ iparams,
             const float* __restrict__ fparams,
             const float* __restrict__ stop_off,
             const float4* __restrict__ stop_col, int k_stops,
             const float* __restrict__ big_wind,
             const float* __restrict__ clips,
             const float4* __restrict__ field,
             const float4* __restrict__ pool,
             const float4* __restrict__ patterns, int pat_h, int pat_w,
             float4* __restrict__ out) {
  constexpr int kPx = T * T / kThreads;
  __shared__ EdgeParams s_edges[SVGR_MAX_SEGS];
  __shared__ float s_off[SVGR_MAX_STOPS];
  __shared__ float4 s_col[SVGR_MAX_STOPS];
  __shared__ float s_fp[SVGR_N_FPARAMS];
  __shared__ int s_ip[SVGR_N_IPARAMS];
  __shared__ int s_run[2];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < 2) s_run[tid] = lower_bound(tile_id, n_items, tile + tid);
  __syncthreads();
  const int first = s_run[0];
  const int last = s_run[1];

  float4 acc[kPx];
#pragma unroll
  for (int i = 0; i < kPx; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int it = first; it < last; ++it) {
    if (tid < segs) {
      const float4 v = lines[(size_t)it * segs + tid];
      s_edges[tid] = edge_params(v.x, v.y, v.z, v.w);
    }
    if (tid < k_stops) {
      s_off[tid] = stop_off[(size_t)it * k_stops + tid];
      s_col[tid] = stop_col[(size_t)it * k_stops + tid];
    }
    if (tid < SVGR_N_FPARAMS) s_fp[tid] = fparams[(size_t)it * SVGR_N_FPARAMS + tid];
    if (tid < SVGR_N_IPARAMS) s_ip[tid] = iparams[(size_t)it * SVGR_N_IPARAMS + tid];
    __syncthreads();

    const int kind = s_ip[SVGR_I_KIND];
    const int rule = s_ip[SVGR_I_RULE];
    const int spread = s_ip[SVGR_I_SPREAD];
    const int big_idx = s_ip[SVGR_I_BIG];
    const int clip_idx = s_ip[SVGR_I_CLIP];
    const int field_idx = s_ip[SVGR_I_FIELD];
    const int tex_idx = s_ip[SVGR_I_TEX];
    const int mask_idx = s_ip[SVGR_I_MASK];
    const float opacity = s_fp[SVGR_F_OPACITY];
    const float4 color = make_float4(
        s_fp[SVGR_F_COLOR], s_fp[SVGR_F_COLOR + 1], s_fp[SVGR_F_COLOR + 2],
        s_fp[SVGR_F_COLOR + 3]);
    const float* carry_row = carry + (size_t)it * T;
    const float* big = (big_wind != nullptr && big_idx >= 0)
                           ? big_wind + (size_t)big_idx * T * T : nullptr;
    const float* clip = (clips != nullptr && clip_idx >= 0)
                            ? clips + (size_t)clip_idx * T * T : nullptr;
    const float4* fld = (field != nullptr && field_idx >= 0)
                            ? field + (size_t)field_idx * T * T : nullptr;
    const float4* tex = (pool != nullptr && tex_idx >= 0)
                            ? pool + (size_t)tex_idx * T * T : nullptr;
    const float4* msk = (pool != nullptr && mask_idx >= 0)
                            ? pool + (size_t)mask_idx * T * T : nullptr;

#pragma unroll
    for (int i = 0; i < kPx; ++i) {
      const int px = tid + i * kThreads;
      const int row = px / T;
      const int col = px % T;

      float w;
      if (big != nullptr) {
        w = big[px];
      } else {
        w = 0.f;
        for (int k = 0; k < segs; ++k) {
          if (s_edges[k].sign == 0.f) continue;  // padding: exact zero
          w += edge_contrib(s_edges[k], (float)row, (float)col);
        }
      }
      w = w + carry_row[row];
      float cov = rule ? fabsf(py_remainder(w + 1.f, 2.f) - 1.f)
                       : fminf(fabsf(w), 1.f);
      if (clip != nullptr) cov = cov * clip[px];
      float mask = cov < 1e-6f ? 0.f : cov;
      mask = mask * opacity;
      if (msk != nullptr) {
        const float4 m = msk[px];
        mask = mask * (m.x * 0.2125f + m.y * 0.7154f + m.z * 0.072f);
      }

      float4 paint;
      if (fld != nullptr) {
        paint = fld[px];
      } else if (tex != nullptr) {
        paint = tex[px];
      } else if (kind == SVGR_PAINT_SOLID) {
        paint = color;
      } else if (kind == SVGR_PAINT_PATTERN) {
        paint = pattern_paint(s_fp, s_ip, row, col, patterns, pat_h, pat_w);
      } else {
        paint = gradient_paint(kind, spread, s_fp, row, col, s_off, s_col,
                               k_stops);
      }
      const float4 src = make_float4(mask * paint.x, mask * paint.y,
                                     mask * paint.z, mask * paint.w);
      const float keep = 1.f - src.w;
      acc[i].x = src.x + acc[i].x * keep;
      acc[i].y = src.y + acc[i].y * keep;
      acc[i].z = src.z + acc[i].z * keep;
      acc[i].w = src.w + acc[i].w * keep;
    }
    __syncthreads();
  }

  float4* dst = out + (size_t)tile * T * T;
#pragma unroll
  for (int i = 0; i < kPx; ++i) dst[tid + i * kThreads] = acc[i];
}

template <int T>
cudaError_t launch(const float* lines, int segs, const float* carry,
                   const int* tile_id, int n_items, const int* iparams,
                   const float* fparams, const float* stop_off,
                   const float* stop_col, int k_stops, const float* big_wind,
                   const float* clips, const float* field, const float* pool,
                   const float* patterns, int pat_h, int pat_w, float* out,
                   int num_tiles, cudaStream_t stream) {
  scene_kernel<T><<<num_tiles, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(lines), segs, carry, tile_id, n_items,
      iparams, fparams, stop_off, reinterpret_cast<const float4*>(stop_col),
      k_stops, big_wind, clips, reinterpret_cast<const float4*>(field),
      reinterpret_cast<const float4*>(pool),
      reinterpret_cast<const float4*>(patterns), pat_h, pat_w,
      reinterpret_cast<float4*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_scene_tiles(const float* lines, int segs,
                                const float* carry, const int* tile_id,
                                int n_items, const int* iparams,
                                const float* fparams, const float* stop_off,
                                const float* stop_col, int k_stops,
                                const float* big_wind, const float* clips,
                                const float* field, const float* pool,
                                const float* patterns, int pat_h, int pat_w,
                                float* out, int num_tiles, int tile,
                                cudaStream_t stream) {
  if (num_tiles <= 0) return 0;
  if (segs < 0 || segs > SVGR_MAX_SEGS || k_stops < 1 ||
      k_stops > SVGR_MAX_STOPS) {
    return (int)cudaErrorInvalidValue;
  }
  switch (tile) {
    case 16:
      return (int)launch<16>(lines, segs, carry, tile_id, n_items, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    case 32:
      return (int)launch<32>(lines, segs, carry, tile_id, n_items, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    case 64:
      return (int)launch<64>(lines, segs, carry, tile_id, n_items, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
