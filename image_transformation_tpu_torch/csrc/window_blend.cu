// K4: the packed window blend of the two-program hybrid compose, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels image_transformation_tpu/ops/compose_pallas.py:
// _make_blend_kernel_packed (row 3, launched by _pallas_blend_packed),
// _make_blend_kernel_packed_pipelined (row 5), _make_blend_kernel_packed_clamped
// (row 6, _pallas_blend_packed_clamped) and _make_blend_kernel_clamped_pipelined
// (row 10). The four differ only in the TPU's memory schedule (grid over
// canvases or over objects, single or double-buffered window DMAs); what
// they compute is one thing: for each canvas b and each object k in list
// order whose `valid` is set, Pillow's alpha-over of the pre-resized packed
// source src[b, k] onto the packed plane with its top-left at
// (ws_x + dx, ws_y + dy), content past the plane's edge cut off.
//
// The TPU's window cut (rows that fall past the window, lanes < dx after
// the roll) only ever drops pixels that lie past the padded plane: the
// unclamped plane pads by a full window, and in the clamped geometry an
// uncapped origin leaves dy < 8 and dx < 128 (the source fits its window),
// while a capped one ends its window at the plane's edge. So cutting at the
// plane's edge is the window cut, and K4 needs no window extents.
//
// What bounds it on this card: the plane bytes under the object rectangles
// (read and written once per covered pixel) and the source bytes; about
// 2 x 4 B x B*N*mh*mw in all, ~0.2 GB at 1080p B=64 N=4. What the design
// does about it:
// - z-order without a sequential grid: blocks run in no order and windows
//   of different objects on one canvas overlap. A block covers a 32 x 8 tile
//   of object k's rectangle; a pixel is written only by the thread of the
//   LAST valid object that covers it, and that thread blends objects 0..k
//   in order (the rule of K2's blend launch, csrc/fused_v3.cu);
// - neighbouring threads read and write neighbouring int32 pixels of a row,
//   so loads and stores coalesce; pixels are read as uchar4, so alpha >= 128
//   (a negative int32) needs no masking;
// - an invalid object is skipped before any index is formed from its meta
//   (a dropped object may carry dy == MH in the clamped geometry).
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   plane i32 [B, hp, wp]      packed RGBA, updated in place
//   src   i32 [B, N, mh, mw]   packed RGBA, zero outside each live region
//   meta  i32 [B, N, 6]        ws_x ws_y dx dy same valid

#include <cstdint>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace {

constexpr int TILE_X = 32;  // columns per block (one warp)
constexpr int TILE_Y = 8;   // rows per block
constexpr int META = 6;

struct Rect {
  int x, y;
  bool valid;
};

__device__ __forceinline__ Rect load_rect(const int* __restrict__ meta, int bk) {
  const int* m = meta + (size_t)bk * META;
  Rect r;
  r.x = __ldg(m + 0) + __ldg(m + 2);
  r.y = __ldg(m + 1) + __ldg(m + 3);
  r.valid = __ldg(m + 5) > 0;
  return r;
}

__device__ __forceinline__ bool covers(const Rect& r, int y, int x, int mh, int mw) {
  return r.valid && y >= r.y && y < r.y + mh && x >= r.x && x < r.x + mw;
}

// grid (B*N, ceil(mw/32), ceil(mh/8)); block 32 x 8.
__global__ void __launch_bounds__(TILE_X * TILE_Y)
window_blend_kernel(int* __restrict__ plane, const int* __restrict__ src,
                    const int* __restrict__ meta, int N, int hp, int wp,
                    int mh, int mw) {
  const int bk = blockIdx.x;
  const Rect r = load_rect(meta, bk);
  if (!r.valid) return;  // uniform per block
  const int c = blockIdx.y * TILE_X + threadIdx.x;
  const int rr = blockIdx.z * TILE_Y + threadIdx.y;
  if (c >= mw || rr >= mh) return;
  const int x = r.x + c, y = r.y + rr;
  if (x < 0 || y < 0 || x >= wp || y >= hp) return;  // cut at the plane edge
  const int b = bk / N, k = bk - b * N;
  for (int k2 = k + 1; k2 < N; ++k2) {
    if (covers(load_rect(meta, b * N + k2), y, x, mh, mw)) return;
  }
  uchar4* px = reinterpret_cast<uchar4*>(plane) + ((size_t)b * hp + y) * wp + x;
  const uchar4* s = reinterpret_cast<const uchar4*>(src);
  uchar4 d = *px;
  for (int k2 = 0; k2 <= k; ++k2) {
    const Rect r2 = load_rect(meta, b * N + k2);
    if (!covers(r2, y, x, mh, mw)) continue;
    d = pillow::alpha_over(
        d, s[((size_t)(b * N + k2) * mh + (y - r2.y)) * mw + (x - r2.x)]);
  }
  *px = d;
}

}  // namespace

extern "C" int window_blend_launch(void* plane, const void* src, const void* meta,
                                   int B, int N, int hp, int wp, int mh, int mw,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)B * (unsigned)N, (unsigned)((mw + TILE_X - 1) / TILE_X),
                  (unsigned)((mh + TILE_Y - 1) / TILE_Y));
  window_blend_kernel<<<grid, dim3(TILE_X, TILE_Y), 0, s>>>(
      static_cast<int*>(plane), static_cast<const int*>(src),
      static_cast<const int*>(meta), N, hp, wp, mh, mw);
  return (int)cudaGetLastError();
}
