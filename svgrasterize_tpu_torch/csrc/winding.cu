// Whole-image winding kernel: the (height, width) anti-aliased winding
// field of each of a batch of edge lists, the interpreter's path masks
// (render.py _mask_padded, batched per render by render.MaskBatch) and the
// fill batches of parallel/batch.py.
//
// Replaces the JAX package's TPU kernel svgrasterize_tpu/ops/
// pallas_coverage.py _winding_kernel (launched by winding_pallas), which
// walks (8, 128) output blocks of one mask and evaluates ops/coverage.py's
// closed form at every (edge, pixel) pair of each block: work O(S * H * W),
// a fit for the TPU's vector unit.  What it computes (the plain version
// here is svgrasterize_tpu_torch/ops/coverage.winding, once per mask): each
// pixel sums sign * dy * mean clamp((c + 1) - X(y), 0, 1) over the edges,
// rows outside [0, height) drop, columns clamp on the left and drop on the
// right.
//
// Design: a row scanline.  Clipped to the slab of row r, an edge spans the
// columns [xmin, xmax] between its slab ends xs0 and xs1.  Its term is an
// exact 0 at every column c <= floor(xmin) - 1 (both g = (c + 1) - xs are
// <= 0) and exactly sign * dy at every column c >= ceil(xmax) (both g >= 1,
// so the closed form's numerator and denominator round alike and the mean is
// 1).  Only the partial cells [floor(xmin), ceil(xmax)) need the closed
// form, about 1 + |slope| * dy of them; the full cells are one carry of
// sign * dy at column ceil(xmax).  A row's field is its partial cells plus
// the inclusive prefix sum of its carries: the reference's accumulate-then-
// cumsum scanline, with each term the same float the dense closed form
// gives.  Work O(edge-rows x cells crossed + H x W).
//
// Blocks: one block of 256 threads per (mask, band of 8 rows, segment of
// 256 columns); the grid is flat over every mask's blocks.  A batch launch
// reads a per-mask table (edge offset, edge count, height, width, output
// offset, first block) and a block finds its mask by binary search over
// "first block"; the one-mask entry (svgr_winding) passes its one entry by
// value, so the same kernel serves both and each field is the same bit for
// bit.  The block stages the mask's edges through shared memory in chunks
// of 256 (edge_params once per edge), dropping padding and horizontal
// edges, edges that miss the band's rows and edges right of the segment by
// more than a pixel; survivors keep their order while the next chunk's
// edges load.  Warp w owns row r0 + w and a shared-memory
// row of partial sums and one of carries.  Its lanes take the survivors 32
// at a time, one (edge, row) pair each: the lane clips the edge to the slab
// once (lo, hi, dy, xs0, xs1) and classifies it against the segment
// [c0, c1): wholly left (ceil(xmax) <= c0) adds sign * dy to the lane's
// row base (f64); wholly right (floor(xmin) >= c1) is dropped; else it
// deposits its partial cells and its carry.  Narrow
// pairs (at most kNarrow cells) deposit one cell per lane per step; lanes
// whose cells coincide (the same first cell, or the same carry column) are
// summed in lane order by the group's lowest lane, which alone writes, so
// no address has two writers and no float atomic is used.  Wide pairs are
// then taken one at a time in lane order, the warp's lanes on distinct
// cells.  Every order is fixed by the data: the same mask gives the same
// bits on every run.  Finally the warp scans its carries in f64 (8
// consecutive columns a lane, a shuffle scan over the lanes), adds the row
// base and the partial sums, rounds once to f32 and writes the row segment
// coalesced.  The carries are mostly exact +-1; the f64 scan keeps a long
// row's reassociated sum within rounding of the plain version's.
//
// What bounds it on the H100: bytes, by the function (a 1024^2 field is
// 4 MB, 1.3 us at 3.35 TB/s).  The kernel is bound by neither bytes nor
// FP32 throughput: on long lists (hundreds of pairs a row) by the
// instructions of its per-pair steps, whose few cells leave most lanes of
// a deposit step idle; on small masks (a fill batch, the interpreter's
// masks) by each block's latency (edge loads, barriers, the scan) times
// the waves of blocks, hence blocks of 8 rows and 256 columns, 5 resident
// per SM.  The per-cell math is winding.cuh's closed form (clamp_antideriv,
// the |den| > 1e-7 branch); the library is built with -fmad=false.

#include "kernels.h"
#include "winding.cuh"

namespace {

constexpr int kRows = 8;              // band rows: one warp each
constexpr int kSeg = 256;             // segment columns
constexpr int kThreads = 32 * kRows;  // 256
constexpr int kChunk = kThreads;      // edges staged per step
constexpr int kPer = kSeg / 32;       // consecutive columns a lane scans
constexpr int kNarrow = 4;            // cells of a pair deposited lane-parallel
constexpr unsigned kFull = 0xffffffffu;
// blocks an SM keeps resident (at most 48 registers a thread): small masks
// are paced by each block's latency times the waves of blocks
constexpr int kMinBlocks = 5;

// one row of the batch table (SVGR_WINDING_TABLE_COLS int32 columns)
struct MaskEntry {
  int edge_off, segs, height, width, out_off, first_block;
};

// The closed-form term of a partial cell: edge_contrib's column-dependent
// part, with k = sign * dy of the (edge, row) pair.
__device__ __forceinline__ float cell_term(float k, float xs0, float xs1,
                                           float col) {
  const float g0 = (col + 1.f) - xs0;
  const float g1 = (col + 1.f) - xs1;
  const float den = g1 - g0;
  float mean;
  if (fabsf(den) > 1e-7f) {
    mean = (clamp_antideriv(g1) - clamp_antideriv(g0)) / den;
  } else {
    mean = fminf(fmaxf(0.5f * (g0 + g1), 0.f), 1.f);
  }
  return k * mean;
}

// arr[idx] += v for every lane with act, one writer per address: `same`
// holds the lanes whose idx equals this lane's (__match_any_sync); the
// active lanes of a group are summed in lane order and the lowest writes.
__device__ __forceinline__ void deposit(float* arr, int idx, float v, bool act,
                                        unsigned same, int lane) {
  const unsigned group = same & __ballot_sync(kFull, act);
  const bool shared = act && (group & (group - 1u)) != 0u;
  const unsigned sharers = __ballot_sync(kFull, shared);
  float s = v;
  if (sharers) {
    float sum = 0.f;
    for (unsigned w = sharers; w; w &= w - 1u) {
      const int l = __ffs(w) - 1;
      const float vl = __shfl_sync(kFull, v, l);
      if ((group >> l) & 1u) sum += vl;
    }
    if (shared) s = sum;
  }
  if (act && (group & (0u - group)) == (1u << lane)) arr[idx] += s;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
winding_kernel(const float4* __restrict__ edges,
               const int* __restrict__ table, int n_masks, MaskEntry m,
               float* __restrict__ out) {
  __shared__ EdgeParams s_edges[kChunk];
  __shared__ int s_count[kRows];
  __shared__ __align__(16) float s_part[kRows][kSeg];
  __shared__ __align__(16) float s_carry[kRows][kSeg];

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
  const int col_blocks = (width + kSeg - 1) / kSeg;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = (local / col_blocks) * kRows;
  const int c0 = (local % col_blocks) * kSeg;
  const int c1 = min(c0 + kSeg, width);
  const int row = r0 + warp;
  const float rowf = (float)row;
  const float c0f = (float)c0, c1f = (float)c1;
  const float band_lo = (float)r0;
  const float band_hi = (float)min(r0 + kRows, height);
  // an edge whose every point lies at column >= c1 + 1 has floor(xmin) >= c1
  // on every row: nothing in the segment
  const float right = c1f + 1.f;

  {
    float4* part4 = reinterpret_cast<float4*>(&s_part[0][0]);
    float4* carry4 = reinterpret_cast<float4*>(&s_carry[0][0]);
    for (int i = tid; i < kRows * kSeg / 4; i += kThreads) {
      part4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      carry4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();  // a warp's rows were zeroed by every warp
  }
  float* const part = s_part[warp];
  float* const carry = s_carry[warp];
  double base = 0.0;  // this lane's pairs wholly left of the segment

  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (tid < segs) v = mask_edges[tid];
  for (int e0 = 0; e0 < segs; e0 += kChunk) {
    EdgeParams e;
    bool keep = false;
    if (e0 + tid < segs) {
      e = edge_params(v.x, v.y, v.z, v.w);
      keep = e.sign != 0.f && e.y_hi > band_lo && e.y_lo < band_hi &&
             fminf(v.y, v.w) < right;
    }
    // the next chunk's edge loads while this one is processed
    if (e0 + kChunk + tid < segs) v = mask_edges[e0 + kChunk + tid];
    const unsigned ballot = __ballot_sync(kFull, keep);
    if (lane == 0) s_count[warp] = __popc(ballot);
    __syncthreads();
    int first_slot = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kRows; ++w) {
      first_slot += w < warp ? s_count[w] : 0;
      total += s_count[w];
    }
    if (keep) s_edges[first_slot + __popc(ballot & ((1u << lane) - 1u))] = e;
    __syncthreads();

    if (row < height) {
      for (int k0 = 0; k0 < total; k0 += 32) {
        // this lane's (edge, row) pair: clip once, classify
        float k = 0.f, xs0 = 0.f, xs1 = 0.f;
        int first = 0, cells = 0, cc = -1;
        bool dep = false;
        if (k0 + lane < total) {
          const EdgeParams p = s_edges[k0 + lane];
          if (p.y_hi > rowf && p.y_lo < rowf + 1.f) {
            const float lo = fmaxf(p.y_lo, rowf);
            const float hi = fminf(p.y_hi, rowf + 1.f);
            const float dy = fmaxf(hi - lo, 0.f);
            if (dy != 0.f) {
              xs0 = p.x_lo + p.slope * (lo - p.y_lo);
              xs1 = p.x_lo + p.slope * (hi - p.y_lo);
              k = p.sign * dy;
              const float fl = floorf(fminf(xs0, xs1));
              const float ce = ceilf(fmaxf(xs0, xs1));
              if (ce <= c0f) {
                base += (double)k;  // every cell of the segment is full
              } else if (fl < c1f) {
                dep = true;
                first = (int)fmaxf(fl, c0f) - c0;
                cells = (int)fminf(ce, c1f) - c0 - first;
                cc = ce < c1f ? (int)ce - c0 : -1;
              }
            }
          }
        }
        if (__ballot_sync(kFull, dep) == 0u) continue;
        // narrow pairs: step t deposits cell first + t of every pair with
        // more than t cells; lanes share an address iff they share `first`
        const int steps = dep && cells <= kNarrow ? cells : 0;
        const unsigned same = __match_any_sync(kFull, steps ? first : -1 - lane);
        const int n_steps = (int)__reduce_max_sync(kFull, (unsigned)steps);
        for (int t = 0; t < n_steps; ++t) {
          const bool act = t < steps;
          const float v = act ? cell_term(k, xs0, xs1, (float)(c0 + first + t)) : 0.f;
          deposit(part, first + t, v, act, same, lane);
        }
        const bool carries = dep && cc >= 0;
        deposit(carry, cc, k, carries,
                __match_any_sync(kFull, carries ? cc : -1 - lane), lane);
        // wide pairs, one at a time in lane order, lanes on distinct cells
        for (unsigned wide = __ballot_sync(kFull, dep && cells > kNarrow); wide;
             wide &= wide - 1u) {
          const int src = __ffs(wide) - 1;
          const float wk = __shfl_sync(kFull, k, src);
          const float w0 = __shfl_sync(kFull, xs0, src);
          const float w1 = __shfl_sync(kFull, xs1, src);
          const int wf = __shfl_sync(kFull, first, src);
          const int wn = __shfl_sync(kFull, cells, src);
          for (int c = lane; c < wn; c += 32) {
            part[wf + c] += cell_term(wk, w0, w1, (float)(c0 + wf + c));
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
  }

  if (row < height) {
    // the row base, the same sum on every lane (a butterfly of commutative
    // adds), then the carries' inclusive prefix sum in f64
#pragma unroll
    for (int o = 16; o; o >>= 1) base += __shfl_xor_sync(kFull, base, o);
    float pv[kPer];
    double run[kPer];
    const float4* part4 = reinterpret_cast<const float4*>(part + lane * kPer);
    const float4* carry4 = reinterpret_cast<const float4*>(carry + lane * kPer);
    double acc = 0.0;
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      const float4 cv = carry4[q];
      const float4 p = part4[q];
      run[4 * q + 0] = acc += (double)cv.x;
      run[4 * q + 1] = acc += (double)cv.y;
      run[4 * q + 2] = acc += (double)cv.z;
      run[4 * q + 3] = acc += (double)cv.w;
      pv[4 * q + 0] = p.x;
      pv[4 * q + 1] = p.y;
      pv[4 * q + 2] = p.z;
      pv[4 * q + 3] = p.w;
    }
    double incl = acc;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double up = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += up;
    }
    double excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0;
    const double off = base + excl;
    __syncwarp();
    float4* field4 = reinterpret_cast<float4*>(part + lane * kPer);
#pragma unroll
    for (int q = 0; q < kPer / 4; ++q) {
      field4[q] = make_float4((float)((double)pv[4 * q + 0] + (off + run[4 * q + 0])),
                              (float)((double)pv[4 * q + 1] + (off + run[4 * q + 1])),
                              (float)((double)pv[4 * q + 2] + (off + run[4 * q + 2])),
                              (float)((double)pv[4 * q + 3] + (off + run[4 * q + 3])));
    }
    __syncwarp();
    float* dst = out + m.out_off + (size_t)row * width + c0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = lane + 32 * j;
      if (c0 + c < c1) dst[c] = part[c];
    }
  }
}

}  // namespace

extern "C" int svgr_winding(const float* edges, int segs, float* out,
                            int height, int width, cudaStream_t stream) {
  if (height <= 0 || width <= 0) return 0;
  if (segs < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((width + kSeg - 1) / kSeg) *
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
