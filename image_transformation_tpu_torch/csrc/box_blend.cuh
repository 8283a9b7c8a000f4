// The box-driven z-order alpha-over shared by K1 (fused_compose.cu) and K2
// (fused_v3.cu).
//
// Hopper runs the blocks of a launch in no order, and the boxes of one
// canvas overlap, so z-order cannot come from the grid. Each placement
// (b, k) has a rectangle (x, y, w, h) on its canvas: its origin and its
// live extent, with w = h = 0 for a dropped placement. Outside that
// rectangle its resampled pixels are transparent, and Pillow's alpha-over
// leaves the canvas unchanged under alpha 0. A canvas pixel covered by some
// rectangle is written by exactly one thread: the one in the block of the
// LAST placement whose rectangle covers it. That thread walks k = 0..k_last
// and blends every placement covering the pixel, in order.
//
// Two grids run the same tile body (`blend_tile`), 256 threads a block:
// - `box_blend_kernel` (K1), grid
//   (B*N, ceil(mw / 32), ceil(mh / 32)): each block takes a 32 x 32 tile of
//   its placement's rectangle and leaves at once when the tile lies past
//   the rectangle (the grid spans the envelope);
// - `box_blend_walk` (K2), a persistent grid over the live tiles of a
//   range of the launch's placements only (csrc/live_tiles.cuh): a tile
//   past the canvas edge is skipped inside the walk.
// The canvas's N rectangles are staged in shared memory (up to MAX_STAGED;
// past that the later ones are read from device memory), not reloaded for
// every later placement of every pixel: once per block on the envelope
// grid, and on the walk whenever the walk reaches another canvas.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "live_tiles.cuh"
#include "pillow.cuh"

namespace box_blend {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_STAGED = 2048;  // rectangles staged per block (32 KB)

inline int smem_bytes(int n) { return (int)sizeof(int4) * (n < MAX_STAGED ? n : MAX_STAGED); }

__device__ __forceinline__ bool covers(const int4& r, int x, int y) {
  return x >= r.x && x < r.x + r.z && y >= r.y && y < r.y + r.w;
}

// A tile wholly past its rectangle or its canvas: uniform per block.
__device__ __forceinline__ bool tile_past(const int4& me, int c0, int r0, int H, int W) {
  return c0 >= me.z || r0 >= me.w || me.x + c0 >= W || me.y + r0 >= H;
}

// Canvas b's rectangles into s_rect (the first `staged`); no barrier.
template <class Rects>
__device__ __forceinline__ void stage_rects(const Rects& rects, int4* s_rect, int staged, int b,
                                            int N) {
  for (int t = threadIdx.x; t < staged; t += THREADS) s_rect[t] = rects.get(b * N + t);
}

// canvas: uchar4 [B, H, W] (RGBA pixels, or a packed plane read as bytes);
// res: uchar4 [B, N, mh, mw], placement (b, k)'s resampled pixels at its
// rectangle's origin; rects.get(bk) gives the rectangle of placement bk.
// One 32 x 32 tile (c0, r0) of placement (b, k), rectangle `me`, with
// canvas b's rectangles staged in s_rect; all THREADS threads call it.
template <class Rects>
__device__ __forceinline__ void blend_tile(uchar4* __restrict__ canvas,
                                           const uchar4* __restrict__ res, const Rects& rects,
                                           const int4* s_rect, int staged, int b, int k,
                                           const int4& me, int c0, int r0, int N, int H, int W,
                                           int mh, int mw) {
  const int c = c0 + (threadIdx.x & 31), x = me.x + c;
  for (int r = r0 + (threadIdx.x >> 5); r < r0 + TILE; r += THREADS / 32) {
    const int y = me.y + r;
    if (c >= me.z || r >= me.w || x < 0 || y < 0 || x >= W || y >= H) continue;
    bool owned = true;
    for (int k2 = k + 1; k2 < N && owned; ++k2) {
      owned = !covers(k2 < staged ? s_rect[k2] : rects.get(b * N + k2), x, y);
    }
    if (!owned) continue;
    uchar4* px = canvas + ((size_t)b * H + y) * W + x;
    uchar4 d = *px;
    for (int k2 = 0; k2 <= k; ++k2) {
      const int4 o = k2 < staged ? s_rect[k2] : rects.get(b * N + k2);
      if (!covers(o, x, y)) continue;
      d = pillow::alpha_over(
          d, res[((size_t)(b * N + k2) * mh + (y - o.y)) * mw + (x - o.x)]);
    }
    *px = d;
  }
}

// The envelope grid: block (bk, tile column, tile row).
template <class Rects>
__global__ void __launch_bounds__(THREADS)
box_blend_kernel(uchar4* __restrict__ canvas, const uchar4* __restrict__ res, Rects rects,
                 int N, int H, int W, int mh, int mw) {
  const int bk = blockIdx.x;
  const int4 me = rects.get(bk);
  const int c0 = blockIdx.y * TILE, r0 = blockIdx.z * TILE;
  if (tile_past(me, c0, r0, H, W)) return;
  const int b = bk / N;
  extern __shared__ int4 s_rect[];
  const int staged = min(N, MAX_STAGED);
  stage_rects(rects, s_rect, staged, b, N);
  __syncthreads();
  blend_tile(canvas, res, rects, s_rect, staged, b, bk - b * N, me, c0, r0, N, H, W, mh, mw);
}

// The walk over the live tiles of placements p0 .. p0+n-1 of the launch's
// B*N (csrc/live_tiles.cuh); the prefix of n + 1 ints lies in dynamic
// shared memory after the staged rectangles.
template <class Rects>
__global__ void __launch_bounds__(THREADS)
box_blend_walk(uchar4* __restrict__ canvas, const uchar4* __restrict__ res, Rects rects,
               int N, int H, int W, int mh, int mw, int p0, int n) {
  extern __shared__ int4 s_rect[];
  __shared__ int s_warp[THREADS / 32];
  const int staged = min(N, MAX_STAGED);
  int* prefix = reinterpret_cast<int*>(s_rect + staged);
  live_tiles::build_prefix<THREADS>(prefix, p0, n, rects, s_warp);
  const int total = prefix[n];
  int cur = 0, staged_b = -1;
  for (int t = blockIdx.x; t < total; t += gridDim.x) {
    cur = live_tiles::advance(prefix, n, cur, t);
    const int bk = p0 + cur;
    const int4 me = rects.get(bk);
    const int local = t - prefix[cur], ntx = (me.z + TILE - 1) / TILE;
    const int ty = local / ntx, c0 = (local - ty * ntx) * TILE, r0 = ty * TILE;
    if (tile_past(me, c0, r0, H, W)) continue;
    const int b = bk / N;
    if (b != staged_b) {  // uniform: the walk reached another canvas
      __syncthreads();    // every thread is done with the last canvas's rectangles
      stage_rects(rects, s_rect, staged, b, N);
      __syncthreads();
      staged_b = b;
    }
    blend_tile(canvas, res, rects, s_rect, staged, b, bk - b * N, me, c0, r0, N, H, W, mh, mw);
  }
}

}  // namespace box_blend
