// C interface of the hand-written CUDA kernels, loaded with ctypes by
// svgrasterize_tpu_torch/ops/cuda_lib.py.
//
// Every function enqueues one kernel launch on `stream` (svgr_fe_blur two
// for long taps), does not synchronise and allocates nothing; it returns the
// cudaGetLastError() code right after the launch (0 on success).  All pointers are device
// pointers to contiguous arrays.
#pragma once

#include <cuda_runtime.h>

// Packed per-item parameter columns; must match ops/batch_exec.py.
#define SVGR_N_IPARAMS 13
#define SVGR_I_KIND 0
#define SVGR_I_RULE 1
#define SVGR_I_SPREAD 2
#define SVGR_I_BIG 3
#define SVGR_I_CLIP 4
#define SVGR_I_FIELD 5
#define SVGR_I_TEX 6
#define SVGR_I_MASK 7
#define SVGR_I_PAT 8
#define SVGR_I_PAT_LO 9    // 2 columns
#define SVGR_I_PAT_MAX 11  // 2 columns

#define SVGR_N_FPARAMS 34
#define SVGR_F_OPACITY 0
#define SVGR_F_TILE_R 1
#define SVGR_F_TILE_C 2
#define SVGR_F_COLOR 3
#define SVGR_F_AFFINE 7
#define SVGR_F_P0 13
#define SVGR_F_P1 15
#define SVGR_F_CENTER 17
#define SVGR_F_FCENTER 19
#define SVGR_F_RADIUS 21
#define SVGR_F_FRADIUS 22
#define SVGR_F_PAT_FWD 24  // 6 columns, row-major 2x3
#define SVGR_F_PAT_XY 30
#define SVGR_F_PAT_WH 32

// paint kinds (render_plan PAINT_*)
#define SVGR_PAINT_SOLID 0
#define SVGR_PAINT_LINEAR 1
#define SVGR_PAINT_RADIAL 2
#define SVGR_PAINT_PATTERN 3

// inline edges and gradient stops an item may carry (SMALL_SEGS, MAX_STOPS)
#define SVGR_MAX_SEGS 64
#define SVGR_MAX_STOPS 64

#ifdef __cplusplus
extern "C" {
#endif

// classes one prepass launch takes (its arguments carry them by value)
#define SVGR_PREPASS_MAX_CLASSES 32

// Winding field of every row of n_classes classes of padded edge lists, in
// one launch; edges, rows and widths are host arrays of n_classes entries.
//   edges[c]: (rows[c], widths[c], 4) f32 tile-local (a0, a1, b0, b1)
//   out:      (sum rows + 1, tile, tile) f32, the classes' rows in order,
//             then a zero row
// tile is 16, 32, 64 or 128; 1 <= n_classes <= SVGR_PREPASS_MAX_CLASSES.
int svgr_prepass_winding(const float* const* edges, const int* rows,
                         const int* widths, int n_classes, float* out,
                         int tile, cudaStream_t stream);

// Premultiplied canvas tiles of a (tile_id, z)-sorted work-item stream.
//   lines (n, segs, 4), carry (n, tile), runs (num_tiles + 1,) int32 with
//   tile t's items at [runs[t], runs[t + 1]), iparams (n, SVGR_N_IPARAMS),
//   fparams (n, SVGR_N_FPARAMS), stop_off (n, k_stops), stop_col
//   (n, k_stops, 4); lines and stop_col 16-byte aligned;
//   big_wind (B, tile, tile), clips (U, tile, tile), field
//   (F, tile, tile, 4), pool (P, tile, tile, 4) and the pattern-tile atlas
//   patterns (Q, pat_h, pat_w, 4) may be null when no item references them
//   (pool rows are read by texture and mask items, atlas tiles by pattern
//   items).
//   out: (num_tiles, tile, tile, 4) f32; tiles without items are zero.
// tile is 16, 32, 64 or 128; segs <= SVGR_MAX_SEGS; k_stops <= SVGR_MAX_STOPS.
int svgr_scene_tiles(const float* lines, int segs, const float* carry,
                     const int* runs, const int* iparams,
                     const float* fparams, const float* stop_off,
                     const float* stop_col, int k_stops,
                     const float* big_wind, const float* clips,
                     const float* field, const float* pool,
                     const float* patterns, int pat_h, int pat_w, float* out,
                     int num_tiles, int tile, cudaStream_t stream);

// Winding field of one padded edge list over a whole image.
//   edges: (segs, 4) f32 (a0, a1, b0, b1) in image pixel coordinates;
//   out:   (height, width) f32.
int svgr_winding(const float* edges, int segs, float* out, int height,
                 int width, cudaStream_t stream);

// columns of svgr_winding_batch's per-mask table: edge offset (in edges),
// edge count, height, width, output offset (in floats), first block
#define SVGR_WINDING_TABLE_COLS 6

// Winding fields of n_masks edge lists in one launch, the same kernel as
// svgr_winding, so each field equals that function's bit for bit.
//   edges: (sum segs, 4) f32, each mask's list in its own pixel coordinates;
//   table: (n_masks, SVGR_WINDING_TABLE_COLS) int32; a mask's blocks are
//          ceil(width / 256) * ceil(height / 8) (0 for an empty mask), first
//          block their exclusive prefix sum, blocks the total;
//   out:   flat f32, each mask's (height, width) field at its output offset.
int svgr_winding_batch(const float* edges, const int* table, int n_masks,
                       int blocks, float* out, cudaStream_t stream);

// columns of svgr_blur_level's per-chunk table (ops/filter_batch.py
// pack_level): the chunk's first out tile (ascending), its sizes and
// colorspace, and its offsets into the level's concatenated arrays
#define SVGR_BLUR_TABLE_COLS 13
#define SVGR_BT_OUT 0     // first out tile of the level's output
#define SVGR_BT_B 1       // parts
#define SVGR_BT_NSI 2     // span tiles down / across
#define SVGR_BT_NSJ 3
#define SVGR_BT_NOI 4     // out-span tiles down / across
#define SVGR_BT_NOJ 5
#define SVGR_BT_LINEAR 6  // 1: the chain blurs in linearRGB
#define SVGR_BT_LUT 7     // offset into lut (ints)
#define SVGR_BT_BH 8      // offset into bh (floats)
#define SVGR_BT_BW 9      // offset into bw (floats)
#define SVGR_BT_PART 10   // first part (src_alpha)
#define SVGR_BT_HB 11     // first (part, 16-row block) of hband
#define SVGR_BT_WB 12     // first (part, out-tile column) of wband

// Every out-span tile of every chunk of lone separable-blur filter parts
// of one level, in one launch.  Per chunk (table row c, B parts):
//   lut + LUT: (B, nsi * nsj) int32 canvas row of each span tile, -1 = zeros;
//   bh + BH: (B, noi * tile, nsi * tile), bw + BW: (B, noj * tile,
//   nsj * tile) f32 band operators; src_alpha + PART: (B,) int32, 1 = the
//   part blurs SourceAlpha; hband + HB: (B * noi * tile / 16, 2) int32
//   [lo, hi) of the nonzero columns of each 16-row block of BH, wband + WB:
//   (B * noj, 2) the same of each out-tile column's BW rows (lo >= hi:
//   none);
//   out + OUT tiles: (B * noi * noj, tile, tile, 4) f32 premultiplied.
//   canvas (rows, tile, tile, 4) f32 premultiplied pass rows; linear_rgb:
//   the canvas's colorspace (a chunk whose chain differs converts around
//   its blur); tiles: the level's out tiles (the last row's OUT + its
//   B * noi * noj).
// tile is 16, 32, 64 or 128.
int svgr_blur_level(const float* canvas, int rows, const int* lut,
                    const float* bh, const float* bw, const int* src_alpha,
                    const int* hband, const int* wband, const int* table,
                    int n_chunks, int tiles, int linear_rgb, float* out,
                    int tile, cudaStream_t stream);

// pool[dst_idx[i]] = src[src_idx[i]] for i < n, rows of tile * tile * 4 f32,
// in place; indices outside [0, pool_rows) / [0, src_rows) are skipped.
int svgr_pool_rows(float* pool, int pool_rows, const float* src, int src_rows,
                   const int* src_idx, const int* dst_idx, int n, int tile,
                   cudaStream_t stream);

// A filter part's entry: the chain's two seeds from its pass rows.
//   rows: (n_rows, tile, tile, 4) f32 premultiplied, the part's rows of the
//         level's canvas; slots: (span tiles,) int32, each span tile's row
//         (-1: none, zeros), row-major over nsj tiles a row;
//   the crop: span pixels [r0, r0 + h) x [c0, c0 + w);
//   gamma: 0 none, 1 sRGB -> linear, 2 linear -> sRGB (the chain's
//   colorspace against the canvas's); amask: (4,) f32 SourceAlpha's mask;
//   graphic: (h, w, 4) f32 straight alpha; alpha: (h, w, 4) f32, the
//   canvas alpha times amask.
// tile is 16, 32, 64 or 128.
int svgr_part_entry(const float* rows, int n_rows, const int* slots, int nsj,
                    int r0, int c0, int h, int w, int gamma,
                    const float* amask, float* graphic, float* alpha, int tile,
                    cudaStream_t stream);

// A filter part's exit: the chain's result, converted to premultiplied
// alpha in the canvas's colorspace, placed on a zero out span and clamped
// to [0, 1], written as out tiles into pool rows.
//   result: (h, w, channels) f32 by its strides (in floats), channels 1 or
//           4; pre_alpha: its alpha mode; gamma as above (4 channels only);
//   off_r, off_c: its offset in the out span of ntj tiles a row and
//   span_tiles tiles;
//   pool[dst_idx[i]] = out-span tile src_idx[i], for i < n, in place;
//   indices outside [0, span_tiles) / [0, pool_rows) are skipped.
// tile is 16, 32, 64 or 128.
int svgr_part_exit(float* pool, int pool_rows, const float* result, int h,
                   int w, int channels, int stride_r, int stride_c,
                   int stride_ch, int pre_alpha, int gamma, int off_r,
                   int off_c, int ntj, int span_tiles, const int* src_idx,
                   const int* dst_idx, int n, int tile, cudaStream_t stream);

// The viewport's pixels of a frame's canvas tiles as a row-major layer.
//   tiles: (grid_h * grid_w, tile, tile, 4) f32, tile (i, j) at i * grid_w
//          + j, 16-byte aligned;
//   out:   (h, w, 4) f32, pixel (y, x) = tiles[(y / tile) * grid_w + x /
//          tile][y % tile][x % tile]; h <= grid_h * tile, w <= grid_w * tile.
// tile is 16, 32, 64 or 128.
int svgr_untile(const float* tiles, int grid_w, int tile, float* out, int h,
                int w, cudaStream_t stream);

// A filter chain's separable blur: the full convolution of a layer with
// row taps u (down the rows) and column taps v (along each row).
//   image: (h, w, 4) f32, 16-byte aligned; with unpremultiply set each
//          pixel is first un-premultiplied as core/color.py does it;
//   u: (kh,) f32; v: (kw,) f32;
//   out: (h + kh - 1, w + kw - 1, 4) f32;
//   scratch: (h + kh - 1, w, 4) f32 where the taps are too long for one
//            launch's shared memory (then two launches), else unused.
int svgr_fe_blur(const float* image, int h, int w, const float* u, int kh,
                 const float* v, int kw, int unpremultiply, float* scratch,
                 float* out, cudaStream_t stream);

// A filter chain's feTurbulence: the SVG 1.1 spec's noise over an output
// region of h x w device pixels whose first pixel is (off0, off1).
//   selector: (514,) int32, entries in [0, 256); gradient: (4, 514, 2) f32,
//             the spec's lattice tables (ops/turbulence.py lattice_tables),
//             16-byte aligned; rows 256 on of each are the spec's copies of
//             the first and are not read;
//   inv00 ... inv12: the first two rows of the device-to-user transform,
//             applied to the pixel centre (r + off0 + 0.5, c + off1 + 0.5);
//   base_fx, base_fy: baseFrequency; octaves >= 1; fractal: 1 for
//             fractalNoise, 0 for turbulence;
//   out: (h, w, 4) f32, straight alpha clamped to [0, 1], 16-byte aligned.
int svgr_fe_turbulence(const int* selector, const float* gradient, int off0,
                       int off1, int h, int w, float inv00, float inv01,
                       float inv02, float inv10, float inv11, float inv12,
                       float base_fx, float base_fy, int octaves, int fractal,
                       float* out, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
