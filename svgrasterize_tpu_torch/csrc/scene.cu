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
// What bounds it on the H100: the tiles it writes (T*T*16 bytes each, 236
// MB for a 3840^2 frame) and the fields it reads, and, on dense tiles,
// the arithmetic of the inline winding (up to 64 edges per item, ~30 FP32
// operations per live (edge, pixel) pair) and the gradient paints.  Per
// item it reads under 2.5 KB of parameters.
//
// The first design ran one block of 256 threads per tile, each thread
// holding T*T/256 RGBA accumulators (195 registers at T = 64, so one block
// of 8 warps per SM and little to hide the latency of the stores), two
// __syncthreads per item, and every pixel walked all of the item's padded
// edges, though lowering has cut every edge at the 8-row band boundaries
// (render_plan._band_split_batch), so most of them miss a pixel's row.
//
// Design: the work is units of (tile, band of rows): 4 rows at T = 64 and
// 128, 8 at T = 32, the whole tile at T = 16, each independent (the carry
// is per row and coverage per pixel), so each output pixel is written once
// and a tile with no items is written as zeros.  Each warp owns 1-4 whole
// rows, lanes over columns, 2 pixels of one row per thread (4 at T = 128,
// so that a warp still covers a whole row and culls its edges for it),
// under a register cap that keeps at least 24 warps (20 at T != 64) on an
// SM.  The launch holds as many blocks as the card runs at once, and block b
// renders units b, b + gridDim.x, ...: on the documents served, a tile
// holds one item (collapsed runs), so a unit's own chain (its run, its
// parameters, its fields, its store) would be all latency.  A unit's run
// comes from the plan's run table (batch_exec.tile_runs, made at upload),
// loaded while the unit before it renders; the parameters of a run (raw
// edges, fparams, iparams, stops) are staged kItems items at a time into a
// double buffer in dynamic shared memory with cp.async, the next group
// (this unit's, or the next unit's first) loading while the current one
// renders, behind one __syncthreads per group.  Per item each warp
// computes edge_params of the staged edges, keeps with ballots only those
// with sign != 0 whose [y_lo, y_hi] meets its own rows, compacts them in
// edge order into its own shared slice, and evaluates them kGroup at a
// time with edge_contrib_flat (independent chains), adding in edge order.
// A dropped edge contributes an exact 0.0 to the warp's pixels, so each
// pixel's winding is the same sum, bit for bit, as a walk over every edge
// (winding.cuh, built with -fmad=false).

#include <algorithm>

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kGroup = 8;  // edges a thread evaluates at once
constexpr int kItems = 8;  // items staged per group
// a warp's compacted edges, with room for the reads of a last partial
// group past the kept ones (their values are discarded)
constexpr int kKeptSlots = SVGR_MAX_SEGS + kGroup;

// A thread's kPx pixels (2, or 4 at T = 128) are columns T / kPx apart of
// one row, so their edge terms share the row's clip of each edge; a row is
// T / kPx lanes and a warp covers 32 / (T / kPx) rows (1 at T = 64 and
// 128, 2 at 32, 4 at 16).  A block is 4 warps, kBand rows of one tile (4
// at T = 64 and 128, 8 at 32, the tile at 16): small blocks, so an SM's
// blocks wait on their loads at different times.
template <int T>
struct Layout {
  static constexpr int kPx = T == 128 ? 4 : 2;
  static constexpr int kLanesPerRow = T / kPx;
  static constexpr int kRowsPerWarp = 32 / kLanesPerRow;
  static constexpr int kWarps = 4;
  static constexpr int kBand = kWarps * kRowsPerWarp;
  static constexpr int kThreads = 32 * kWarps;
  // blocks an SM must hold: 6 at T = 64 (at most 80 registers a thread),
  // 5 elsewhere (at most 102), where a thread's pixels need more without
  // spilling (at T = 128 a cap of 80, 6 blocks, spills; 5 blocks ran the
  // 3840^2 flat plan faster than 4 on an H100)
  static constexpr int kMinBlocks = T == 64 ? 6 : 5;
};

// One staging buffer, offsets in floats: kItems items' raw edges and stop
// colours (float4, first, so 16-byte aligned), then stop offsets, fparams
// and iparams; the size is rounded to a float4.
struct Stage {
  int lines, col, off, fp, ip, size;
};

__host__ __device__ inline Stage stage_layout(int segs, int k_stops) {
  Stage s;
  s.lines = 0;
  s.col = s.lines + kItems * segs * 4;
  s.off = s.col + kItems * k_stops * 4;
  s.fp = s.off + kItems * k_stops;
  s.ip = s.fp + kItems * SVGR_N_FPARAMS;
  s.size = (s.ip + kItems * SVGR_N_IPARAMS + 3) & ~3;
  return s;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Python-style floating remainder (torch.remainder / jnp.remainder).
__device__ __forceinline__ float py_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m += b;
  return m;
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

// Queue the cp.async copies of items [it, it + n) into one staging buffer.
template <int kThreads>
__device__ void stage_items(float* buf, const Stage& s, int it, int n,
                            int segs, int k_stops, int tid,
                            const float4* __restrict__ lines,
                            const float* __restrict__ fparams,
                            const int* __restrict__ iparams,
                            const float* __restrict__ stop_off,
                            const float4* __restrict__ stop_col) {
  float4* s_lines = reinterpret_cast<float4*>(buf + s.lines);
  float4* s_col = reinterpret_cast<float4*>(buf + s.col);
  const float4* g_lines = lines + (size_t)it * segs;
  const float4* g_col = stop_col + (size_t)it * k_stops;
  const float* g_off = stop_off + (size_t)it * k_stops;
  const float* g_fp = fparams + (size_t)it * SVGR_N_FPARAMS;
  const int* g_ip = iparams + (size_t)it * SVGR_N_IPARAMS;
  for (int e = tid; e < n * segs; e += kThreads) cp_async16(s_lines + e, g_lines + e);
  for (int e = tid; e < n * k_stops; e += kThreads) {
    cp_async16(s_col + e, g_col + e);
    cp_async4(buf + s.off + e, g_off + e);
  }
  for (int e = tid; e < n * SVGR_N_FPARAMS; e += kThreads) {
    cp_async4(buf + s.fp + e, g_fp + e);
  }
  for (int e = tid; e < n * SVGR_N_IPARAMS; e += kThreads) {
    cp_async4(buf + s.ip + e, g_ip + e);
  }
}

template <int T>
__global__ void __launch_bounds__(Layout<T>::kThreads, Layout<T>::kMinBlocks)
scene_kernel(const float4* __restrict__ lines, int segs,
             const float* __restrict__ carry, const int* __restrict__ runs,
             const int* __restrict__ iparams,
             const float* __restrict__ fparams,
             const float* __restrict__ stop_off,
             const float4* __restrict__ stop_col, int k_stops,
             const float* __restrict__ big_wind,
             const float* __restrict__ clips,
             const float4* __restrict__ field,
             const float4* __restrict__ pool,
             const float4* __restrict__ patterns, int pat_h, int pat_w,
             float4* __restrict__ out, int num_tiles) {
  using L = Layout<T>;
  constexpr int kBands = T / L::kBand;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  // this thread's pixels' columns col0 + j * T / kPx of each unit's rows
  const int col0 = lane % L::kLanesPerRow;
  const int units = num_tiles * kBands;
  const Stage st = stage_layout(segs, k_stops);
  EdgeParams* s_kept =
      reinterpret_cast<EdgeParams*>(smem + 2 * st.size) + warp * kKeptSlots;
  auto stage = [&](int group, int it, int n) {
    stage_items<L::kThreads>(smem + (group & 1) * st.size, st, it, min(kItems, n),
                             segs, k_stops, tid, lines, fparams, iparams,
                             stop_off, stop_col);
  };

  // the units (tile, band) this block renders, blockIdx.x + k * gridDim.x;
  // group gi of the block's sequence of item groups reads buffer gi & 1
  int unit = blockIdx.x;
  int first = unit < units ? runs[unit / kBands] : 0;
  int last = unit < units ? runs[unit / kBands + 1] : 0;
  if (first < last) stage(0, first, last - first);
  cp_async_commit();
  int gi = 0;
  for (; unit < units; unit += gridDim.x) {
    // the next unit's run, in flight while this one's first group waits
    const int next = unit + gridDim.x;
    const int next_first = next < units ? runs[next / kBands] : 0;
    const int next_last = next < units ? runs[next / kBands + 1] : 0;
    const int tile = unit / kBands;
    const int warp_r0 = (unit % kBands) * L::kBand + warp * L::kRowsPerWarp;
    const int row = warp_r0 + lane / L::kLanesPerRow;
    const float rowf = (float)row;
    const float warp_lo = (float)warp_r0;
    const float warp_hi = (float)(warp_r0 + L::kRowsPerWarp);

    float4 acc[L::kPx];
#pragma unroll
    for (int j = 0; j < L::kPx; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);

    for (int g0 = first; g0 < last; g0 += kItems, ++gi) {
      // this group's copies have landed, and every warp is done with the
      // buffer the next group loads into: this unit's next group, or the
      // next unit's first, so its parameters arrive while this one renders
      cp_async_wait_all();
      __syncthreads();
      if (g0 + kItems < last) {
        stage(gi + 1, g0 + kItems, last - g0 - kItems);
      } else if (next_first < next_last) {
        stage(gi + 1, next_first, next_last - next_first);
      }
      cp_async_commit();
      const float* buf = smem + (gi & 1) * st.size;
      const int n_group = min(kItems, last - g0);

      for (int i = 0; i < n_group; ++i) {
        const int it = g0 + i;
        const float* s_fp = buf + st.fp + i * SVGR_N_FPARAMS;
        const int* s_ip =
            reinterpret_cast<const int*>(buf + st.ip) + i * SVGR_N_IPARAMS;
        const float* s_off = buf + st.off + i * k_stops;
        const float4* s_col =
            reinterpret_cast<const float4*>(buf + st.col) + i * k_stops;
        const float4* s_lines =
            reinterpret_cast<const float4*>(buf + st.lines) + i * segs;

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

        // the inline winding: this warp's live edges, compacted in edge
        // order, then kGroup at a time
        float wind[L::kPx];
#pragma unroll
        for (int j = 0; j < L::kPx; ++j) wind[j] = 0.f;
        if (big == nullptr) {
          __syncwarp();  // the previous item's edges are read
          int kept = 0;
          for (int e0 = 0; e0 < segs; e0 += 32) {
            const int e = e0 + lane;
            EdgeParams p;
            bool keep = false;
            if (e < segs) {
              const float4 v = s_lines[e];
              p = edge_params(v.x, v.y, v.z, v.w);
              keep = p.sign != 0.f && p.y_hi > warp_lo && p.y_lo < warp_hi;
            }
            const unsigned ballot = __ballot_sync(0xffffffffu, keep);
            if (keep) s_kept[kept + __popc(ballot & ((1u << lane) - 1u))] = p;
            kept += __popc(ballot);
          }
          __syncwarp();
          for (int k = 0; k < kept; k += kGroup) {
#pragma unroll
            for (int j = 0; j < L::kPx; ++j) {
              const float col = (float)(col0 + j * L::kLanesPerRow);
              float c[kGroup];
#pragma unroll
              for (int g = 0; g < kGroup; ++g) {
                // past the last kept edge: an exact 0.0, which the sum
                // adds without changing a bit
                c[g] = k + g < kept ? edge_contrib_flat(s_kept[k + g], rowf, col)
                                    : 0.f;
              }
#pragma unroll
              for (int g = 0; g < kGroup; ++g) wind[j] += c[g];
            }
          }
        }

#pragma unroll
        for (int j = 0; j < L::kPx; ++j) {
          const int col = col0 + j * L::kLanesPerRow;
          const int px = row * T + col;
          float w = big != nullptr ? big[px] : wind[j];
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
          acc[j].x = src.x + acc[j].x * keep;
          acc[j].y = src.y + acc[j].y * keep;
          acc[j].z = src.z + acc[j].z * keep;
          acc[j].w = src.w + acc[j].w * keep;
        }
      }
    }
    // an empty unit staged nothing: the next unit's first group goes to
    // the buffer the next group reads (its last reader passed a barrier)
    if (first == last && next_first < next_last) {
      stage(gi, next_first, next_last - next_first);
      cp_async_commit();
    }

    float4* dst = out + ((size_t)tile * T + row) * T + col0;
#pragma unroll
    for (int j = 0; j < L::kPx; ++j) dst[j * L::kLanesPerRow] = acc[j];
    first = next_first;
    last = next_last;
  }
}

template <int T>
cudaError_t launch(const float* lines, int segs, const float* carry,
                   const int* runs, const int* iparams,
                   const float* fparams, const float* stop_off,
                   const float* stop_col, int k_stops, const float* big_wind,
                   const float* clips, const float* field, const float* pool,
                   const float* patterns, int pat_h, int pat_w, float* out,
                   int num_tiles, cudaStream_t stream) {
  using L = Layout<T>;
  const long long units = (long long)num_tiles * (T / L::kBand);
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = (size_t)2 * stage_layout(segs, k_stops).size * sizeof(float) +
                      (size_t)L::kWarps * kKeptSlots * sizeof(EdgeParams);
  cudaError_t rc;
  if (smem > 48 * 1024) {
    rc = cudaFuncSetAttribute(scene_kernel<T>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return rc;
  }
  // as many blocks as the card holds at once, each walking its units
  int device = 0, sms = 0, per_sm = 0;
  if ((rc = cudaGetDevice(&device)) != cudaSuccess) return rc;
  if ((rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return rc;
  }
  if ((rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, scene_kernel<T>, L::kThreads, smem)) != cudaSuccess) {
    return rc;
  }
  const long long blocks = std::min<long long>(units, (long long)sms * std::max(per_sm, 1));
  scene_kernel<T><<<(unsigned)blocks, L::kThreads, smem, stream>>>(
      reinterpret_cast<const float4*>(lines), segs, carry, runs, iparams,
      fparams, stop_off, reinterpret_cast<const float4*>(stop_col), k_stops,
      big_wind, clips, reinterpret_cast<const float4*>(field),
      reinterpret_cast<const float4*>(pool),
      reinterpret_cast<const float4*>(patterns), pat_h, pat_w,
      reinterpret_cast<float4*>(out), num_tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int svgr_scene_tiles(const float* lines, int segs,
                                const float* carry, const int* runs,
                                const int* iparams,
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
      return (int)launch<16>(lines, segs, carry, runs, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    case 32:
      return (int)launch<32>(lines, segs, carry, runs, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    case 64:
      return (int)launch<64>(lines, segs, carry, runs, iparams,
                             fparams, stop_off, stop_col, k_stops, big_wind,
                             clips, field, pool, patterns, pat_h, pat_w,
                             out, num_tiles, stream);
    case 128:
      return (int)launch<128>(lines, segs, carry, runs, iparams,
                              fparams, stop_off, stop_col, k_stops, big_wind,
                              clips, field, pool, patterns, pat_h, pat_w,
                              out, num_tiles, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
