// K1: fused exact resize + alpha-over for Hopper (sm_90a), from supplied
// Pillow tables.
//
// Replaces the TPU kernels image_transformation_tpu/ops/compose_pallas.py:
// _make_fused_kernel_v2 (launched by _pallas_fused_v2_impl) and, behind
// ops/compose_kernels.py:_pallas_compose_planar, _make_kernel (launched by
// _pallas_compose_planar). For each canvas b and each object k, in list
// order (z-order):
//   1. premultiply the RGBA object (Pillow MULDIV255);
//   2. horizontal pass: clip8((sum_j kh[ox,j] * p[y,j] + 2^21) >> 22);
//   3. vertical pass with kv, the same way;
//   4. unpremultiply: min(255, floor(255*c/a)), c passed through at a=0;
//   5. identity objects (box size == object size) copy the raw pixels;
//   6. Pillow alpha-over (AlphaComposite.c, PRECISION_BITS=7) at the box
//      origin, cropped to the canvas; a negative or off-canvas origin drops
//      the object.
// All arithmetic is int32 as in Pillow, so the result is bit-exact vs PIL
// given Pillow's coefficient tables (built on the host).
//
// What bounds it on this card: the integer multiply-adds on the tables'
// NONZERO taps (Pillow's windows hold ~6/s of a row's taps at scale s; the
// dense tables are ~98% zeros at the sweep's scales), then reading the
// dense tables once, then the canvas bytes under the live boxes. What the
// design does about it, in three launches:
//   (a) bounds: one block per (placement, table, 32 table rows), one warp
//       per table row with all of the row's loads in flight; __ballot_sync
//       finds each row's first and one-past-last nonzero tap, and the
//       block's part of the live extent (one past its last non-empty output
//       row or column; the pad for an identity object). A row with no
//       nonzero tap resamples to 0, the transparent pixel, so resampling
//       and blending only inside the extent is exact for any tables;
//   (b) resample (csrc/resample.cuh): each tile walks each row's own window,
//       the premultiplied source patch staged in shared memory with 16-byte
//       loads and the H result kept in shared memory (no scratch in device
//       memory between the passes); each tile copies the taps inside its
//       windows from the table rows into shared memory once, coalesced
//       (the coefficient reads of the passes are then warp-uniform shared
//       loads, not L2 round trips). Each block reduces its placement's
//       extent parts; block (bk, 0, 0) writes the placement's rectangle
//       (origin, extent; extent 0 when dropped) for the blend;
//   (c) blend (csrc/box_blend.cuh): over each placement's rectangle only,
//       z-order by the last covering placement.
// B*N rides on gridDim.x, so any batch launches.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   canvas  u8  [B, H, W, 4]      updated in place
//   objects u8  [Bo, N, ph, pw, 4]  Bo == 1 (shared by all canvases) or B
//   kh      i32 [B, N, mw, pw]
//   kv      i32 [B, N, mh, ph]
//   boxes   i32 [B, N, 4]         (x1, y1, x2, y2); only the origin is read
//   flags   u8  [B, N]            bit 0 live, bit 1 identity
//   scratch u8  fused_compose_scratch_bytes(B, N, mh, mw), carved here into
//           hwin  i32 [B, N, mw, 2]     each kh row's [lo, hi)
//           vwin  i32 [B, N, mh, 2]     each kv row's [lo, hi)
//           part  i32 [B, N, 2, S]      extent parts, S = ceil(max(mh, mw) / 32)
//           rects i32 [B, N, 4]         (x, y, w, h) of each placement
//           res   u8  [B, N, mh, mw, 4] resampled RGBA

#include <cstdint>
#include <cuda_runtime.h>

#include "box_blend.cuh"
#include "pillow.cuh"
#include "resample.cuh"

namespace {

constexpr uint8_t FLAG_LIVE = 1;
constexpr uint8_t FLAG_IDENTITY = 2;
constexpr int BOUNDS_THREADS = 256;
constexpr int BOUNDS_ROWS = 32;    // table rows per bounds block (4 per warp)
constexpr int BOUNDS_UNROLL = 16;  // loads of a row in flight per lane (512 taps)

__device__ __forceinline__ bool k1_live(const uint8_t* flags, const int* boxes, int bk,
                                        int H, int W) {
  const int x1 = boxes[4 * bk], y1 = boxes[4 * bk + 1];
  return (flags[bk] & FLAG_LIVE) && x1 >= 0 && y1 >= 0 && x1 < W && y1 < H;
}

// (a) grid (B*N, 2, S): blockIdx.y 0 scans kh (mw rows of pw taps), 1 scans
// kv (mh rows of ph); blockIdx.z takes rows [32 z, 32 z + 32), one warp per
// row at a time, every load of a row issued before its ballots. Writes
// win[bk, row] = (lo, hi) ((0, 0) for an empty row) and the slice's extent
// part[bk, axis, z] (one past its last non-empty row; the pad of an
// identity placement; 0 for a dropped one). The resample launch reduces
// the S parts.
__global__ void __launch_bounds__(BOUNDS_THREADS)
k1_bounds(const int* __restrict__ kh, const int* __restrict__ kv,
          const int* __restrict__ boxes, const uint8_t* __restrict__ flags,
          int2* __restrict__ hwin, int2* __restrict__ vwin, int* __restrict__ part, int H,
          int W, int ph, int pw, int mh, int mw) {
  const int bk = blockIdx.x, axis = blockIdx.y, slice = blockIdx.z;
  const int rows = axis == 0 ? mw : mh, taps = axis == 0 ? pw : ph;
  int* out = part + ((size_t)bk * 2 + axis) * gridDim.z + slice;
  if (!k1_live(flags, boxes, bk, H, W)) {  // dropped: an empty rectangle
    if (threadIdx.x == 0) *out = 0;
    return;
  }
  if (flags[bk] & FLAG_IDENTITY) {  // Pillow's plain copy: the pad
    if (threadIdx.x == 0) *out = min(rows, taps);
    return;
  }
  const int* table = (axis == 0 ? kh + (size_t)bk * mw * pw : kv + (size_t)bk * mh * ph);
  int2* win = (axis == 0 ? hwin + (size_t)bk * mw : vwin + (size_t)bk * mh);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int warps = BOUNDS_THREADS / 32;
  int extent = 0;
  const int r_end = min(rows, (slice + 1) * BOUNDS_ROWS);
  for (int r = slice * BOUNDS_ROWS + warp; r < r_end; r += warps) {
    const int* row = table + (size_t)r * taps;
    int lo = -1, hi = 0;
    for (int j0 = 0; j0 < taps; j0 += 32 * BOUNDS_UNROLL) {
      int v[BOUNDS_UNROLL];
#pragma unroll
      for (int u = 0; u < BOUNDS_UNROLL; ++u) {
        const int j = j0 + 32 * u + lane;
        v[u] = j < taps ? __ldg(row + j) : 0;
      }
#pragma unroll
      for (int u = 0; u < BOUNDS_UNROLL; ++u) {
        const unsigned m = __ballot_sync(0xffffffffu, v[u] != 0);
        if (m) {
          const int base = j0 + 32 * u;
          if (lo < 0) lo = base + __ffs(m) - 1;
          hi = base + 32 - __clz(m);
        }
      }
    }
    if (lane == 0) win[r] = lo < 0 ? make_int2(0, 0) : make_int2(lo, hi);
    if (lo >= 0) extent = r + 1;
  }
  __shared__ int s_ext[warps];
  if (lane == 0) s_ext[warp] = extent;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < warps; ++w) extent = max(extent, s_ext[w]);
    *out = extent;
  }
}

// one past the last non-empty row of placement bk along `axis`: the max
// of launch (a)'s S parts
__device__ __forceinline__ int k1_extent(const int* __restrict__ part, int bk, int axis, int S) {
  const int* p = part + ((size_t)bk * 2 + axis) * S;
  int e = 0;
  for (int s = 0; s < S; ++s) e = max(e, p[s]);
  return e;
}

// K1's tile windows, from launch (a)'s rows: columns past ext_w and rows
// past ext_h are empty. Then the taps inside the windows are copied once,
// coalesced, into compact arrays in shared memory (so the passes read them
// with warp-uniform shared loads, not L2 round trips), when they fit:
// returns whether they did (the same in every thread).
__device__ bool k1_prepare(resample::TileWindows& w, const int* __restrict__ kh,
                           const int* __restrict__ kv, const int2* __restrict__ hwin,
                           const int2* __restrict__ vwin, int ph, int pw, int ext_h,
                           int ext_w, int ox0, int oy0, int* coef_h, int* coef_v, int cap_h,
                           int cap_v) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < 2) {  // warp 0: the tile's columns, warp 1: its rows
    const bool live = warp == 0 ? ox0 + lane < ext_w : oy0 + lane < ext_h;
    const int2 lh = live ? (warp == 0 ? hwin : vwin)[lane] : make_int2(0, 0);
    resample::set_window(w, warp, lane, lh.x, lh.y);
  }
  __syncthreads();
  if (w.total[0] > cap_h || w.total[1] > cap_v) return false;
  for (int e = warp; e < resample::TX + resample::TY; e += resample::WARPS) {
    const bool horiz = e < resample::TX;
    const int c = horiz ? e : e - resample::TX;
    const int lo = horiz ? w.hlo[c] : w.vlo[c], hi = horiz ? w.hhi[c] : w.vhi[c];
    const int* row = horiz ? kh + (size_t)c * pw : kv + (size_t)c * ph;
    int* dst = horiz ? coef_h + w.hoff[c] : coef_v + w.voff[c];
    for (int i = lo + lane; i < hi; i += 32) dst[i - lo] = __ldg(row + i);
  }
  return true;
}

// K1's taps read from the table rows through L1: for tiles whose windows
// hold more taps than the compact arrays (tables no Pillow window gives).
struct RowTaps {
  const int* __restrict__ kh;  // the tile's first kh row
  const int* __restrict__ kv;  // the tile's first kv row
  int ph, pw;
  __device__ __forceinline__ int h(int c, int j) const { return __ldg(kh + (size_t)c * pw + j); }
  __device__ __forceinline__ int v(int r, int i) const { return __ldg(kv + (size_t)r * ph + i); }
};

// (b) grid (B*N, ceil(mw/TX), ceil(mh/TY)): one tile of one placement.
// Block (bk, 0, 0) also writes the placement's rectangle for the blend.
__global__ void __launch_bounds__(resample::THREADS, 3)
k1_resample(const uchar4* __restrict__ objects, const int* __restrict__ kh,
            const int* __restrict__ kv, const int* __restrict__ boxes,
            const uint8_t* __restrict__ flags, const int2* __restrict__ hwin,
            const int2* __restrict__ vwin, const int* __restrict__ part,
            int4* __restrict__ rects, uchar4* __restrict__ res, int Bo, int N, int ph, int pw,
            int mh, int mw, int S, int cap_h, int cap_v, int vec) {
  const int bk = blockIdx.x;
  const int ext_w = k1_extent(part, bk, 0, S), ext_h = k1_extent(part, bk, 1, S);
  const int ox0 = blockIdx.y * resample::TX, oy0 = blockIdx.z * resample::TY;
  if (ox0 == 0 && oy0 == 0 && threadIdx.x == 0) {
    rects[bk] = make_int4(boxes[4 * bk], boxes[4 * bk + 1], ext_w, ext_h);
  }
  if (ox0 >= ext_w || oy0 >= ext_h) return;  // past the live extent (or dropped)
  const int b = bk / N, k = bk - b * N;
  const size_t obj_px = (size_t)ph * pw;
  const resample::InterleavedSrc src{objects, ((size_t)(Bo == 1 ? 0 : b) * N + k) * obj_px,
                                     (size_t)Bo * N * obj_px, pw, vec != 0};
  uchar4* out = res + (size_t)bk * mh * mw;
  if (flags[bk] & FLAG_IDENTITY) {
    resample::copy_tile(src, out, mw, ph, pw, ext_h, ext_w, ox0, oy0);
    return;
  }
  __shared__ resample::TileWindows win;
  extern __shared__ uint32_t smem[];
  int* coef = reinterpret_cast<int*>(smem + resample::TILE_SMEM_BYTES / 4);
  const int* kh_t = kh + ((size_t)bk * mw + ox0) * pw;
  const int* kv_t = kv + ((size_t)bk * mh + oy0) * ph;
  const bool staged = k1_prepare(win, kh_t, kv_t, hwin + (size_t)bk * mw + ox0,
                                 vwin + (size_t)bk * mh + oy0, ph, pw, ext_h, ext_w, ox0, oy0,
                                 coef, coef + cap_h, cap_h, cap_v);
  __syncthreads();
  if (staged) {
    resample::resample_tile(src, resample::SharedTaps{coef, coef + cap_h, &win}, win, smem, out,
                            mw, ext_h, ext_w, ox0, oy0);
  } else {
    resample::resample_tile(src, RowTaps{kh_t, kv_t, ph, pw}, win, smem, out, mw, ext_h, ext_w,
                            ox0, oy0);
  }
}

struct K1Rects {
  const int4* __restrict__ rects;
  __device__ __forceinline__ int4 get(int bk) const { return rects[bk]; }
};

}  // namespace

// slices of table rows the bounds launch takes per placement and table
extern "C" int fused_compose_bounds_slices(int mh, int mw) {
  const int rows = mh > mw ? mh : mw;
  return (rows + BOUNDS_ROWS - 1) / BOUNDS_ROWS;
}

// K1's scratch, carved from one buffer, each region on a 256-byte boundary:
// the table rows' windows, the extent parts, the rectangles and the
// resampled objects. `base` 0 gives the offsets alone.
struct K1Scratch {
  uintptr_t hwin, vwin, part, rects, res, bytes;
};

static K1Scratch k1_scratch(uintptr_t base, int B, int N, int mh, int mw) {
  const uintptr_t bn = (uintptr_t)B * (uintptr_t)N;
  const uintptr_t sizes[5] = {8 * bn * mw, 8 * bn * mh,
                              8 * bn * fused_compose_bounds_slices(mh, mw), 16 * bn,
                              4 * bn * mh * mw};
  uintptr_t at[5], off = 0;
  for (int i = 0; i < 5; ++i) {
    at[i] = base + off;
    off += (sizes[i] + 255) / 256 * 256;
  }
  return {at[0], at[1], at[2], at[3], at[4], off};
}

// bytes of scratch a K1 call of B canvases of N objects with envelope (mh, mw) takes
extern "C" long long fused_compose_scratch_bytes(int B, int N, int mh, int mw) {
  return (long long)k1_scratch(0, B, N, mh, mw).bytes;
}

// dynamic shared memory of each of K1's three launches, for objects padded
// to (ph, pw) and N per canvas
extern "C" int fused_compose_smem(int ph, int pw, int N, int* out) {
  int cap_h, cap_v;
  out[0] = 0;
  out[1] = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  out[2] = box_blend::smem_bytes(N);
  return 0;
}

// Launch (a) alone: each table row's window, and each placement's extent
// parts part[bk, axis, 0..S) with S = fused_compose_bounds_slices(mh, mw).
extern "C" int fused_compose_bounds_launch(const void* kh, const void* kv, const void* boxes,
                                           const void* flags, void* hwin, void* vwin,
                                           void* part, int B, int N, int H, int W, int ph,
                                           int pw, int mh, int mw, void* stream) {
  k1_bounds<<<dim3((unsigned)B * (unsigned)N, 2, fused_compose_bounds_slices(mh, mw)),
              BOUNDS_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(kh), static_cast<const int*>(kv), static_cast<const int*>(boxes),
      static_cast<const uint8_t*>(flags), static_cast<int2*>(hwin), static_cast<int2*>(vwin),
      static_cast<int*>(part), H, W, ph, pw, mh, mw);
  return (int)cudaGetLastError();
}

// K1's three launches: (a) bounds, (b) resample, (c) blend. `scratch` holds
// fused_compose_scratch_bytes(B, N, mh, mw) bytes, 256-byte aligned.
extern "C" int fused_compose_launch(void* canvas, const void* objects, const void* kh,
                                    const void* kv, const void* boxes, const void* flags,
                                    void* scratch, int B, int Bo, int N, int H, int W, int ph,
                                    int pw, int mh, int mw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bn = (unsigned)B * (unsigned)N;
  const K1Scratch at = k1_scratch(reinterpret_cast<uintptr_t>(scratch), B, N, mh, mw);
  int2* hwin = reinterpret_cast<int2*>(at.hwin);
  int2* vwin = reinterpret_cast<int2*>(at.vwin);
  int* part = reinterpret_cast<int*>(at.part);
  int4* rects = reinterpret_cast<int4*>(at.rects);
  uchar4* res = reinterpret_cast<uchar4*>(at.res);
  cudaError_t err = (cudaError_t)fused_compose_bounds_launch(
      kh, kv, boxes, flags, hwin, vwin, part, B, N, H, W, ph, pw, mh, mw, stream);
  if (err != cudaSuccess) return (int)err;

  // the compact tap arrays where they fit beside the core (else caps 0: every
  // tile reads its taps from the rows)
  int cap_h, cap_v;
  const int smem = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  err = resample::allow_smem(k1_resample, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = reinterpret_cast<uintptr_t>(objects) % 16 == 0;
  const dim3 grid_r(bn, (mw + resample::TX - 1) / resample::TX,
                    (mh + resample::TY - 1) / resample::TY);
  k1_resample<<<grid_r, resample::THREADS, smem, s>>>(
      static_cast<const uchar4*>(objects), static_cast<const int*>(kh),
      static_cast<const int*>(kv), static_cast<const int*>(boxes),
      static_cast<const uint8_t*>(flags), hwin, vwin, part, rects, res, Bo, N, ph, pw, mh, mw,
      fused_compose_bounds_slices(mh, mw), cap_h, cap_v, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_b(bn, (mw + box_blend::TILE - 1) / box_blend::TILE,
                    (mh + box_blend::TILE - 1) / box_blend::TILE);
  box_blend::box_blend_kernel<<<grid_b, box_blend::THREADS, box_blend::smem_bytes(N), s>>>(
      static_cast<uchar4*>(canvas), res, K1Rects{rects}, N, H, W, mh, mw);
  return (int)cudaGetLastError();
}
