// K4: the window blend of the two-program hybrid compose, for Hopper
// (sm_90a).
//
// Replaces the TPU blend kernels of image_transformation_tpu/ops/compose_pallas.py
// (rows of the kernel table in PERF.md):
// - packed int32 planes (entry window_blend_launch):
//   _make_blend_kernel_packed (row 3, launched by _pallas_blend_packed),
//   _make_blend_kernel_packed_pipelined (row 5), _make_blend_kernel_packed_clamped
//   (row 6), _make_blend_kernel_clamped_pipelined (row 10),
//   _make_blend_kernel_clamped_batchsrc (row 7), _make_blend_kernel_resident
//   (row 8), _make_blend_kernel_band (row 9); _make_blend_kernel_rowbaked
//   (row 11) and _make_blend_kernel_aligned (row 4), whose producers bake the
//   row offset, or both offsets, into the sources, are this entry with those
//   offsets zeroed in the meta by the wrapper;
// - planar u8 planes (entry window_blend_planar_launch): _make_blend_kernel
//   (row 2, _pallas_blend_planar), the same placement on four byte planes;
// - the timing-only stage variants of row 6 in benchmarks/bisect_resize.py
//   (blend_step_anatomy.make_variant, row 15; entry window_blend_stage_launch).
// The TPU kernels differ in memory schedule (grid over canvases or over
// objects, window, band or resident-canvas DMAs, single or double
// buffering); what they compute is one thing: for each canvas b and each
// object k in list order whose `valid` is set, Pillow's alpha-over of the
// pre-resized source src[b, k] onto the plane with its top-left at
// (ws_x + dx, ws_y + dy), content past the plane's edge cut off.
//
// The TPU's window cut (rows that fall past the window, lanes < dx after
// the roll) only ever drops pixels that lie past the padded plane: the
// unclamped plane pads by a full window, and in the clamped geometry an
// uncapped origin leaves dy < 8 and dx < 128 (the source fits its window),
// while a capped one ends its window at the plane's edge. So cutting at the
// plane's edge is the window cut, and K4 needs no window extents.
//
// What bounds it on this card: the source bytes of each placement's live
// box (read once) and the plane bytes under its pixels of alpha > 0 (read
// and written once; Pillow's alpha-over leaves the rest as it is), which
// chip_smoke.py counts from the inputs (PERF.md, kernel table). What the
// design does about it:
// - z-order without a sequential grid: blocks run in no order and windows
//   of different objects on one canvas overlap. A block covers a 32 x 8 tile
//   of object k's rectangle; a pixel is written only by the thread of the
//   LAST valid object that covers it, and that thread blends objects 0..k
//   in order (the rule of K2's blend launch, csrc/fused_v3.cu);
// - neighbouring threads read and write neighbouring pixels of a row, so
//   loads and stores coalesce; packed pixels are read as uchar4, so alpha >=
//   128 (a negative int32) needs no masking. The planar instantiation loads
//   and stores single bytes from four planes (right, and slow);
// - an invalid object is skipped before any index is formed from its meta
//   (a dropped object may carry dy == MH in the clamped geometry).
//
// The stage variants (row 15) are K4 on a meta whose dx, or dy, or both,
// the wrapper has zeroed (their placement), with or without the blend:
// BLEND=false writes back d | (s & keep_mask). keep_mask is a runtime
// argument (the wrapper passes 0), so the compiler cannot fold the source
// load and the store away: that instantiation still moves every byte.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   packed: plane i32 [B, hp, wp], src i32 [B, N, mh, mw] (packed RGBA)
//   planar: plane u8 [B, 4, hp, wp], src u8 [B, N, 4, mh, mw]
//   meta    i32 [B, N, 6]  ws_x ws_y dx dy same valid
// The plane is updated in place; sources are zero outside each live region.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace {

constexpr int TILE_X = 32;  // columns per block (one warp)
constexpr int TILE_Y = 8;   // rows per block
constexpr int META = 6;

// Images of `px` pixels each: packed (one uchar4 per pixel) or planar (four
// byte planes of `px` bytes, R G B A).
template <bool PLANAR>
struct Pixels {
  uint8_t* base;
  size_t px;

  __device__ __forceinline__ uchar4 load(size_t img, size_t i) const {
    if constexpr (PLANAR) {
      const uint8_t* p = base + img * 4 * px + i;
      return make_uchar4(p[0], p[px], p[2 * px], p[3 * px]);
    } else {
      return reinterpret_cast<const uchar4*>(base)[img * px + i];
    }
  }

  __device__ __forceinline__ void store(size_t img, size_t i, uchar4 v) const {
    if constexpr (PLANAR) {
      uint8_t* p = base + img * 4 * px + i;
      p[0] = v.x;
      p[px] = v.y;
      p[2 * px] = v.z;
      p[3 * px] = v.w;
    } else {
      reinterpret_cast<uchar4*>(base)[img * px + i] = v;
    }
  }
};

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

// d | (s & mask) on the pixel's 32-bit word.
__device__ __forceinline__ uchar4 keep_bits(uchar4 d, uchar4 s, unsigned mask) {
  unsigned dw, sw;
  memcpy(&dw, &d, 4);
  memcpy(&sw, &s, 4);
  dw |= sw & mask;
  memcpy(&d, &dw, 4);
  return d;
}

// grid (B*N, ceil(mw/32), ceil(mh/8)); block 32 x 8.
template <bool PLANAR, bool BLEND>
__global__ void __launch_bounds__(TILE_X * TILE_Y)
window_blend_kernel(Pixels<PLANAR> plane, Pixels<PLANAR> src,
                    const int* __restrict__ meta, int N, int hp, int wp, int mh,
                    int mw, unsigned keep_mask) {
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
  const size_t at = (size_t)y * wp + x;
  uchar4 d = plane.load(b, at);
  // One source at a time. K4 waits on memory, so its time follows the
  // blocks resident per SM; unrolled, the non-blending instantiation kept
  // several loads in flight in 40 registers (6 blocks per SM against the
  // packed blend's 8 at 30), and row 15 did not compare like with like.
#pragma unroll 1
  for (int k2 = 0; k2 <= k; ++k2) {
    const Rect r2 = load_rect(meta, b * N + k2);
    if (!covers(r2, y, x, mh, mw)) continue;
    const uchar4 s =
        src.load((size_t)b * N + k2, (size_t)(y - r2.y) * mw + (x - r2.x));
    if constexpr (BLEND) {
      d = pillow::alpha_over(d, s);
    } else {
      d = keep_bits(d, s, keep_mask);
    }
  }
  plane.store(b, at, d);
}

template <bool PLANAR, bool BLEND>
int launch(void* plane, const void* src, const void* meta, int B, int N, int hp,
           int wp, int mh, int mw, unsigned keep_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)B * (unsigned)N, (unsigned)((mw + TILE_X - 1) / TILE_X),
                  (unsigned)((mh + TILE_Y - 1) / TILE_Y));
  const Pixels<PLANAR> p{static_cast<uint8_t*>(plane), (size_t)hp * wp};
  const Pixels<PLANAR> q{const_cast<uint8_t*>(static_cast<const uint8_t*>(src)),
                         (size_t)mh * mw};
  window_blend_kernel<PLANAR, BLEND><<<grid, dim3(TILE_X, TILE_Y), 0, s>>>(
      p, q, static_cast<const int*>(meta), N, hp, wp, mh, mw, keep_mask);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_blend_launch(void* plane, const void* src, const void* meta,
                                   int B, int N, int hp, int wp, int mh, int mw,
                                   void* stream) {
  return launch<false, true>(plane, src, meta, B, N, hp, wp, mh, mw, 0u, stream);
}

extern "C" int window_blend_planar_launch(void* plane, const void* src,
                                          const void* meta, int B, int N, int hp,
                                          int wp, int mh, int mw, void* stream) {
  return launch<true, true>(plane, src, meta, B, N, hp, wp, mh, mw, 0u, stream);
}

// The stage variants of benchmarks/bisect_resize.py:353-359 on a meta the
// wrapper has zeroed: blend != 0 is K4 itself, blend == 0 writes back
// d | (s & keep_mask).
extern "C" int window_blend_stage_launch(void* plane, const void* src,
                                         const void* meta, int B, int N, int hp,
                                         int wp, int mh, int mw, int blend,
                                         int keep_mask, void* stream) {
  return blend ? launch<false, true>(plane, src, meta, B, N, hp, wp, mh, mw, 0u, stream)
               : launch<false, false>(plane, src, meta, B, N, hp, wp, mh, mw,
                                      (unsigned)keep_mask, stream);
}
