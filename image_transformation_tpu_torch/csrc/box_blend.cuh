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
// Grid (B*N, ceil(mw / 32), ceil(mh / 32)), 256 threads: each block takes a
// 32 x 32 tile of its placement's rectangle and leaves at once when the
// tile lies past the rectangle (the grid spans the envelope). The canvas's
// N rectangles are staged in shared memory once per block (up to
// MAX_STAGED; past that the later ones are read from device memory), not
// reloaded for every later placement of every pixel.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace box_blend {

constexpr int TILE = 32;
constexpr int THREADS = 256;
constexpr int MAX_STAGED = 2048;  // rectangles staged per block (32 KB)

inline int smem_bytes(int n) { return (int)sizeof(int4) * (n < MAX_STAGED ? n : MAX_STAGED); }

__device__ __forceinline__ bool covers(const int4& r, int x, int y) {
  return x >= r.x && x < r.x + r.z && y >= r.y && y < r.y + r.w;
}

// canvas: uchar4 [B, H, W] (RGBA pixels, or a packed plane read as bytes);
// res: uchar4 [B, N, mh, mw], placement (b, k)'s resampled pixels at its
// rectangle's origin; rects.get(bk) gives the rectangle of placement bk.
template <class Rects>
__global__ void __launch_bounds__(THREADS)
box_blend_kernel(uchar4* __restrict__ canvas, const uchar4* __restrict__ res, Rects rects,
                 int N, int H, int W, int mh, int mw) {
  const int bk = blockIdx.x;
  const int4 me = rects.get(bk);
  const int c0 = blockIdx.y * TILE, r0 = blockIdx.z * TILE;
  // uniform per block: past the rectangle, or the whole tile past the canvas
  if (c0 >= me.z || r0 >= me.w || me.x + c0 >= W || me.y + r0 >= H) return;
  const int b = bk / N, k = bk - b * N;
  extern __shared__ int4 s_rect[];
  const int staged = min(N, MAX_STAGED);
  for (int t = threadIdx.x; t < staged; t += THREADS) s_rect[t] = rects.get(b * N + t);
  __syncthreads();

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

}  // namespace box_blend
