// C interface of the hand-written CUDA kernels, loaded with ctypes by
// svgrasterize_tpu_torch/ops/cuda_lib.py.
//
// Every function enqueues one kernel launch on `stream`, does not
// synchronise and allocates nothing; it returns the cudaGetLastError()
// code right after the launch (0 on success).  All pointers are device
// pointers to contiguous arrays.
#pragma once

#include <cuda_runtime.h>

// Packed per-item parameter columns; must match ops/batch_exec.py.
#define SVGR_N_IPARAMS 8
#define SVGR_I_KIND 0
#define SVGR_I_RULE 1
#define SVGR_I_SPREAD 2
#define SVGR_I_BIG 3
#define SVGR_I_CLIP 4
#define SVGR_I_FIELD 5

#define SVGR_N_FPARAMS 24
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

// paint kinds (render_plan PAINT_*)
#define SVGR_PAINT_SOLID 0
#define SVGR_PAINT_LINEAR 1
#define SVGR_PAINT_RADIAL 2

// inline edges and gradient stops an item may carry (SMALL_SEGS, MAX_STOPS)
#define SVGR_MAX_SEGS 64
#define SVGR_MAX_STOPS 64

#ifdef __cplusplus
extern "C" {
#endif

// Winding field of each of `rows` padded edge lists.
//   edges: (rows, width, 4) f32 tile-local (a0, a1, b0, b1)
//   out:   (rows, tile, tile) f32
// tile is 16, 32 or 64.
int svgr_prepass_winding(const float* edges, float* out, int rows, int width,
                         int tile, cudaStream_t stream);

// Premultiplied canvas tiles of a (tile_id, z)-sorted work-item stream.
//   lines (n, segs, 4), carry (n, tile), tile_id (n,) sorted with padding
//   items at num_tiles, iparams (n, SVGR_N_IPARAMS), fparams
//   (n, SVGR_N_FPARAMS), stop_off (n, k_stops), stop_col (n, k_stops, 4);
//   big_wind (B, tile, tile), clips (U, tile, tile) and field
//   (F, tile, tile, 4) may be null when no item references them.
//   out: (num_tiles, tile, tile, 4) f32; tiles without items are zero.
// tile is 16, 32 or 64; segs <= SVGR_MAX_SEGS; k_stops <= SVGR_MAX_STOPS.
int svgr_scene_tiles(const float* lines, int segs, const float* carry,
                     const int* tile_id, int n_items, const int* iparams,
                     const float* fparams, const float* stop_off,
                     const float* stop_col, int k_stops,
                     const float* big_wind, const float* clips,
                     const float* field, float* out, int num_tiles, int tile,
                     cudaStream_t stream);

#ifdef __cplusplus
}
#endif
