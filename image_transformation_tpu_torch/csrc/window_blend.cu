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
// chip_smoke.py counts from the inputs (PERF.md, kernel table). The sources
// are whole envelopes [mh, mw], zero outside each live region, and with
// JAX's signature nothing else says where that region lies. So K4 is two
// launches:
//   (a) bounds: grid (B*N, S), S = ceil(mh / ROWS). A block scans ROWS
//       source rows of one placement, only the part that lands on the
//       plane, with 16-byte loads (BOUNDS_UNROLL of a thread's in flight),
//       and writes its slice's part: the first and one-past-last row and
//       column that hold a NONZERO source pixel (in any of the four planes
//       of a planar source). Nonzero, not alpha > 0, so that the stage
//       entry's d | (s & keep_mask) is exact for any mask. The warp's
//       minima and maxima reduce with __reduce_min_sync/__reduce_max_sync,
//       the block's through shared memory: no atomics, and no scratch to
//       zero (every part is written). An invalid placement writes an empty
//       part before any index is formed from its meta (a dropped object
//       may carry dy == MH). This is the one launch that reads every
//       source byte on the plane;
//   (b) blend: grid (B*N, SL), SL = ceil(mh / BLEND_ROWS). Every block
//       reduces the S parts of its canvas's N placements into their
//       rectangles (x, y, w, h) on the plane, staged in shared memory once
//       (a warp per placement), and walks its share (1/SL) of its own
//       rectangle's rows: every block has work (none spans the envelope)
//       and the host needs no sizes (no sync). The rule of
//       csrc/box_blend.cuh keeps z-order: the LAST placement whose
//       rectangle covers a pixel owns it and blends placements 0..k in
//       order. Outside its rectangle a source is zero, and Pillow's
//       alpha-over returns the plane under alpha 0, so the result is the
//       blend over the whole envelope.
// The blend moves groups of four horizontally adjacent pixels on a
// 4-aligned column, one per thread: one 16-byte access of a packed plane,
// one 32-bit word of each of the four planes of a planar one; planar source
// bytes come from the aligned words that hold them through __funnelshift_r.
// A group store writes all four pixels, and two placements' edges can share
// a group, so a group's owner is the last placement whose rectangle meets
// ANY of its pixels in that row, and it blends, for each pixel, every
// placement covering it, in order. A plane (or planar source) whose rows do
// not start on such boundaries takes the same walk one pixel per thread.
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
//   scratch window_blend_scratch_bytes(B, N, mh) bytes, 16-byte aligned:
//           the bounds parts, int4 [B, N, S] (r0, r1, c0, c1)
// The plane is updated in place; sources are zero outside each live region.

#include <climits>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace {

constexpr int META = 6;
constexpr int THREADS = 256;
constexpr int ROWS = 32;          // source rows per bounds block
constexpr int BLEND_ROWS = 16;    // envelope rows per blend slice
constexpr int BOUNDS_UNROLL = 4;  // a bounds thread's loads in flight
constexpr int MAX_SMEM = 232448;  // shared memory a block can use (227 KB)

inline int slices(int mh) { return (mh + ROWS - 1) / ROWS; }
inline int blend_slices(int mh) { return (mh + BLEND_ROWS - 1) / BLEND_ROWS; }

// 32 bytes of shared memory per placement: its rectangle and its source origin
inline int blend_smem(int n) { return 2 * (int)sizeof(int4) * n; }

// Where placement bk's source lies on the plane, and whether it is valid.
struct Origin {
  int x, y;
  bool valid;
};

__device__ __forceinline__ Origin load_origin(const int* __restrict__ meta, int bk) {
  const int* m = meta + (size_t)bk * META;
  Origin o;
  o.x = __ldg(m + 0) + __ldg(m + 2);
  o.y = __ldg(m + 1) + __ldg(m + 3);
  o.valid = __ldg(m + 5) > 0;
  return o;
}

// bit j set where byte j of w is nonzero
__device__ __forceinline__ unsigned byte_mask(unsigned w) {
  const unsigned t = (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
  return (t >> 7 & 1u) | (t >> 14 & 2u) | (t >> 21 & 4u) | (t >> 28 & 8u);
}

// One step of the bounds scan: P horizontally adjacent source pixels of one
// row (load), and which of them are nonzero (mask, bit j for pixel j).
template <bool PLANAR, bool VEC>
struct Scan;

template <>
struct Scan<false, true> {  // packed, 16-byte loads: 4 pixels
  static constexpr int P = 4;
  using Raw = int4;
  const int4* __restrict__ p;
  int row;
  __device__ Scan(const uint8_t* src, int bk, int mh, int mw)
      : p(reinterpret_cast<const int4*>(src) + (size_t)bk * mh * (mw / 4)), row(mw / 4) {}
  __device__ __forceinline__ Raw load(int r, int q) const { return __ldg(p + (size_t)r * row + q); }
  __device__ __forceinline__ static unsigned mask(const Raw& v) {
    return (unsigned)(v.x != 0) | (unsigned)(v.y != 0) << 1 | (unsigned)(v.z != 0) << 2 |
           (unsigned)(v.w != 0) << 3;
  }
};

template <>
struct Scan<false, false> {  // packed, one pixel per load
  static constexpr int P = 1;
  using Raw = int;
  const int* __restrict__ p;
  int row;
  __device__ Scan(const uint8_t* src, int bk, int mh, int mw)
      : p(reinterpret_cast<const int*>(src) + (size_t)bk * mh * mw), row(mw) {}
  __device__ __forceinline__ Raw load(int r, int q) const { return __ldg(p + (size_t)r * row + q); }
  __device__ __forceinline__ static unsigned mask(Raw v) { return v != 0; }
};

template <>
struct Scan<true, true> {  // planar, a 16-byte load from each plane: 16 pixels
  static constexpr int P = 16;
  struct Raw {
    uint4 c[4];
  };
  const uint4* __restrict__ p;
  size_t plane;
  int row;
  __device__ Scan(const uint8_t* src, int bk, int mh, int mw)
      : p(reinterpret_cast<const uint4*>(src) + (size_t)bk * 4 * mh * (mw / 16)),
        plane((size_t)mh * (mw / 16)), row(mw / 16) {}
  __device__ __forceinline__ Raw load(int r, int q) const {
    Raw v;
#pragma unroll
    for (int c = 0; c < 4; ++c) v.c[c] = __ldg(p + c * plane + (size_t)r * row + q);
    return v;
  }
  __device__ __forceinline__ static unsigned mask(const Raw& v) {
    const uint4 o = make_uint4(v.c[0].x | v.c[1].x | v.c[2].x | v.c[3].x,
                               v.c[0].y | v.c[1].y | v.c[2].y | v.c[3].y,
                               v.c[0].z | v.c[1].z | v.c[2].z | v.c[3].z,
                               v.c[0].w | v.c[1].w | v.c[2].w | v.c[3].w);
    return byte_mask(o.x) | byte_mask(o.y) << 4 | byte_mask(o.z) << 8 | byte_mask(o.w) << 12;
  }
};

template <>
struct Scan<true, false> {  // planar, a byte of each plane: one pixel
  static constexpr int P = 1;
  using Raw = uchar4;
  const uint8_t* __restrict__ p;
  size_t plane;
  int row;
  __device__ Scan(const uint8_t* src, int bk, int mh, int mw)
      : p(src + (size_t)bk * 4 * mh * mw), plane((size_t)mh * mw), row(mw) {}
  __device__ __forceinline__ Raw load(int r, int q) const {
    const uint8_t* a = p + (size_t)r * row + q;
    return make_uchar4(__ldg(a), __ldg(a + plane), __ldg(a + 2 * plane), __ldg(a + 3 * plane));
  }
  __device__ __forceinline__ static unsigned mask(Raw v) { return (v.x | v.y | v.z | v.w) != 0; }
};

// (a) grid (B*N, S): block (bk, s) scans source rows [ROWS s, ROWS s + ROWS)
// of placement bk, the part of them that lands on the plane, and writes
// part[bk, s] = (r0, r1, c0, c1): the first and one-past-last row and column
// of its nonzero pixels, (INT_MAX, 0, INT_MAX, 0) when it holds none.
template <bool PLANAR, bool VEC>
__global__ void __launch_bounds__(THREADS)
k4_bounds(const uint8_t* __restrict__ src, const int* __restrict__ meta, int4* __restrict__ part,
          int hp, int wp, int mh, int mw) {
  using Sc = Scan<PLANAR, VEC>;
  constexpr int P = Sc::P;
  const int bk = blockIdx.x, slice = blockIdx.y;
  int r_lo = INT_MAX, r_hi = 0, c_lo = INT_MAX, c_hi = 0;
  const Origin o = load_origin(meta, bk);
  // source rows and columns on the plane (none is formed for an invalid placement)
  const int row0 = o.valid ? max(slice * ROWS, -o.y) : 0;
  const int row1 = o.valid ? min(min(mh, (slice + 1) * ROWS), hp - o.y) : 0;
  const int col0 = o.valid ? max(0, -o.x) : 0;
  const int col1 = o.valid ? min(mw, wp - o.x) : 0;
  if (row1 > row0 && col1 > col0) {
    const Sc scan(src, bk, mh, mw);
    const int q0 = col0 / P, nq = (col1 + P - 1) / P - q0;
    const int n = (row1 - row0) * nq;
    for (int i0 = threadIdx.x; i0 < n; i0 += THREADS * BOUNDS_UNROLL) {
      typename Sc::Raw v[BOUNDS_UNROLL];
#pragma unroll
      for (int u = 0; u < BOUNDS_UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < n) v[u] = scan.load(row0 + i / nq, q0 + i % nq);
      }
#pragma unroll
      for (int u = 0; u < BOUNDS_UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i >= n) continue;
        const int r = row0 + i / nq, c = (q0 + i % nq) * P;
        unsigned m = Sc::mask(v[u]);
        if (c < col0) m &= ~0u << (col0 - c);            // columns left of the plane
        if (c + P > col1) m &= (1u << (col1 - c)) - 1u;  // columns past its edge
        if (m) {
          r_lo = min(r_lo, r);
          r_hi = max(r_hi, r + 1);
          c_lo = min(c_lo, c + __ffs((int)m) - 1);
          c_hi = max(c_hi, c + 32 - __clz((int)m));
        }
      }
    }
  }
  r_lo = __reduce_min_sync(0xffffffffu, r_lo);
  r_hi = __reduce_max_sync(0xffffffffu, r_hi);
  c_lo = __reduce_min_sync(0xffffffffu, c_lo);
  c_hi = __reduce_max_sync(0xffffffffu, c_hi);
  __shared__ int4 s_part[THREADS / 32];
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = make_int4(r_lo, r_hi, c_lo, c_hi);
  __syncthreads();
  if (threadIdx.x == 0) {
    int4 e = s_part[0];
    for (int w = 1; w < THREADS / 32; ++w) {
      const int4 q = s_part[w];
      e = make_int4(min(e.x, q.x), max(e.y, q.y), min(e.z, q.z), max(e.w, q.w));
    }
    part[(size_t)bk * gridDim.y + slice] = e;
  }
}

// Stage canvas b's placements in shared memory: s[k] = placement k's
// rectangle (x, y, w, h) on the plane, from launch (a)'s S parts ((0, 0, 0,
// 0) when it has no live pixel on the plane or is invalid); s[N + k] = its
// source origin (x, y). A warp per placement: its lanes load the parts and
// the meta together and reduce the parts with warp minima and maxima.
__device__ void stage_boxes(int4* s, const int* __restrict__ meta, const int4* __restrict__ part,
                            int b, int N, int S) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < N; k += THREADS / 32) {
    const int bk = b * N + k;
    const Origin o = load_origin(meta, bk);
    int4 e = make_int4(INT_MAX, 0, INT_MAX, 0);
    for (int j = lane; j < S; j += 32) {
      const int4 q = __ldg(part + (size_t)bk * S + j);
      e = make_int4(min(e.x, q.x), max(e.y, q.y), min(e.z, q.z), max(e.w, q.w));
    }
    e.x = __reduce_min_sync(0xffffffffu, e.x);
    e.y = __reduce_max_sync(0xffffffffu, e.y);
    e.z = __reduce_min_sync(0xffffffffu, e.z);
    e.w = __reduce_max_sync(0xffffffffu, e.w);
    if (lane == 0) {
      s[k] = o.valid && e.y > e.x ? make_int4(o.x + e.z, o.y + e.x, e.w - e.z, e.y - e.x)
                                  : make_int4(0, 0, 0, 0);
      s[N + k] = make_int4(o.x, o.y, 0, 0);
    }
  }
  __syncthreads();
}

// whether rectangle r meets columns [x0, x1) of row y
__device__ __forceinline__ bool meets(const int4& r, int y, int x0, int x1) {
  return y >= r.y && y < r.y + r.w && r.x < x1 && r.x + r.z > x0;
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

// Byte j of the result is row[c0 + j] for j in [j0, j1) (the others are
// undefined), read from the aligned words of `row` that hold those bytes
// only: row is 4-byte aligned and row[c0 + j0 .. c0 + j1) lies inside it.
__device__ __forceinline__ uint32_t load_bytes(const uint8_t* __restrict__ row, int c0, int j0,
                                               int j1) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row);
  const int wa = (c0 + j0) >> 2;
  const uint32_t lo = __ldg(w + wa);
  const uint32_t hi = ((c0 + j1 - 1) >> 2) != wa ? __ldg(w + wa + 1) : 0u;
  const int off = c0 - 4 * wa;  // in [-3, 3]; below 0 every byte read is in lo
  return off >= 0 ? __funnelshift_r(lo, hi, 8 * off) : lo << (-8 * off);
}

__device__ __forceinline__ uchar4 byte_of(const uint32_t (&w)[4], int j) {
  return make_uchar4(w[0] >> 8 * j, w[1] >> 8 * j, w[2] >> 8 * j, w[3] >> 8 * j);
}

// G adjacent pixels of one row: of a packed plane (one uchar4 each; G = 4
// takes one 16-byte access) or of a planar one (G = 4: one 32-bit word of
// each of the four planes; G = 1: a byte of each). `img_px` is the pixels
// of one image plane.
template <bool PLANAR, int G>
struct Group {
  __device__ __forceinline__ static void load(const uint8_t* base, size_t img_px, uchar4 (&d)[G]) {
    if constexpr (PLANAR) {
      uint32_t w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (G == 4) {
          w[c] = *reinterpret_cast<const uint32_t*>(base + c * img_px);
        } else {
          w[c] = base[c * img_px];
        }
      }
#pragma unroll
      for (int j = 0; j < G; ++j) d[j] = byte_of(w, j);
    } else if constexpr (G == 4) {
      const int4 v = *reinterpret_cast<const int4*>(base);
      memcpy(d, &v, 16);
    } else {
      d[0] = *reinterpret_cast<const uchar4*>(base);
    }
  }
  __device__ __forceinline__ static void store(uint8_t* base, size_t img_px, const uchar4 (&d)[G]) {
    if constexpr (PLANAR) {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < G; ++j) {
        w[0] |= (uint32_t)d[j].x << 8 * j;
        w[1] |= (uint32_t)d[j].y << 8 * j;
        w[2] |= (uint32_t)d[j].z << 8 * j;
        w[3] |= (uint32_t)d[j].w << 8 * j;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (G == 4) {
          *reinterpret_cast<uint32_t*>(base + c * img_px) = w[c];
        } else {
          base[c * img_px] = (uint8_t)w[c];
        }
      }
    } else if constexpr (G == 4) {
      int4 v;
      memcpy(&v, d, 16);
      *reinterpret_cast<int4*>(base) = v;
    } else {
      *reinterpret_cast<uchar4*>(base) = d[0];
    }
  }
  // source pixels j in [j0, j1) of a group whose first pixel is at source
  // column c0 of `row` (the source row of one placement; the others are
  // left as they are)
  __device__ __forceinline__ static void load_src(const uint8_t* __restrict__ row, size_t img_px,
                                                  int c0, int j0, int j1, uchar4 (&s)[G]) {
    if constexpr (PLANAR && G == 4) {
      uint32_t w[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = load_bytes(row + c * img_px, c0, j0, j1);
#pragma unroll
      for (int j = 0; j < G; ++j) s[j] = byte_of(w, j);
    } else if constexpr (PLANAR) {
      const uint8_t* p = row + c0;
      s[0] = make_uchar4(__ldg(p), __ldg(p + img_px), __ldg(p + 2 * img_px),
                         __ldg(p + 3 * img_px));
    } else {
      const uchar4* p = reinterpret_cast<const uchar4*>(row) + c0;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j >= j0 && j < j1) s[j] = __ldg(p + j);
      }
    }
  }
};

// (b) grid (B*N, SL): a thread per group of G pixels on a G-aligned column
// of the block's share of its rectangle's rows (rows split evenly among the
// SL blocks of the placement), neighbouring threads on neighbouring groups.
// The group's owner is the last placement meeting any of its pixels in the
// row; it blends, for each pixel, every placement covering it, in order,
// and stores the whole group (pixels no placement covers are stored back
// unchanged: no other thread writes them).
template <bool PLANAR, int G, bool BLEND>
__global__ void __launch_bounds__(THREADS)
k4_blend(uint8_t* __restrict__ plane, const uint8_t* __restrict__ src,
         const int* __restrict__ meta, const int4* __restrict__ part, int N, int S, int hp,
         int wp, int mh, int mw, unsigned keep_mask) {
  using Gr = Group<PLANAR, G>;
  constexpr int BPP = PLANAR ? 1 : 4;  // bytes of a pixel in one image plane
  extern __shared__ int4 s_box[];
  const int bk = blockIdx.x, b = bk / N, k = bk - b * N;
  stage_boxes(s_box, meta, part, b, N, S);
  const int4 me = s_box[k];
  const int chunk = (me.w + (int)gridDim.y - 1) / (int)gridDim.y;
  const int r0 = blockIdx.y * chunk, r1 = min(me.w, r0 + chunk);
  const int g0 = me.x / G, ng = me.z > 0 ? (me.x + me.z - 1) / G - g0 + 1 : 0;
  const int n = (r1 - r0) * ng;
  const size_t px = (size_t)hp * wp, spx = (size_t)mh * mw;
  const size_t img = PLANAR ? 4 * px : px, simg = PLANAR ? 4 * spx : spx;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int r = i / ng;
    const int x = (g0 + i - r * ng) * G, y = me.y + r0 + r;
    bool owned = true;
    for (int k2 = k + 1; k2 < N && owned; ++k2) owned = !meets(s_box[k2], y, x, x + G);
    if (!owned) continue;
    uint8_t* at = plane + (b * img + (size_t)y * wp + x) * BPP;
    uchar4 d[G];
    Gr::load(at, px * BPP, d);
    // one source at a time: K4 waits on memory, and its time follows the
    // blocks resident per SM
#pragma unroll 1
    for (int k2 = 0; k2 <= k; ++k2) {
      const int4 rr = s_box[k2];
      if (!meets(rr, y, x, x + G)) continue;
      const int4 o = s_box[N + k2];
      const int j0 = max(rr.x - x, 0), j1 = min(rr.x + rr.z - x, G);  // pixels it covers
      uchar4 s[G];
      Gr::load_src(src + ((b * N + k2) * simg + (size_t)(y - o.y) * mw) * BPP, spx * BPP,
                   x - o.x, j0, j1, s);
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < j0 || j >= j1) continue;
        if constexpr (BLEND) {
          d[j] = pillow::alpha_over(d[j], s[j]);
        } else {
          d[j] = keep_bits(d[j], s[j], keep_mask);
        }
      }
    }
    Gr::store(at, px * BPP, d);
  }
}

bool aligned(const void* p, unsigned n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

// launch (a): 16-byte loads where every source row starts on a 16-byte boundary
template <bool PLANAR>
cudaError_t run_bounds(const void* src, const void* meta, int4* part, int B, int N, int hp,
                       int wp, int mh, int mw, cudaStream_t s) {
  const dim3 grid((unsigned)B * (unsigned)N, (unsigned)slices(mh));
  const uint8_t* p = static_cast<const uint8_t*>(src);
  const int* m = static_cast<const int*>(meta);
  if (aligned(src, 16) && mw % (PLANAR ? 16 : 4) == 0) {
    k4_bounds<PLANAR, true><<<grid, THREADS, 0, s>>>(p, m, part, hp, wp, mh, mw);
  } else {
    k4_bounds<PLANAR, false><<<grid, THREADS, 0, s>>>(p, m, part, hp, wp, mh, mw);
  }
  return cudaGetLastError();
}

// launch (b), with its shared memory (the opt-in above 48 KB is set on
// every such launch: N > 1536 placements per canvas)
template <bool PLANAR, int G, bool BLEND>
cudaError_t run_blend(void* plane, const void* src, const void* meta, const int4* part, int B,
                      int N, int hp, int wp, int mh, int mw, unsigned keep_mask,
                      cudaStream_t s) {
  const int smem = blend_smem(N);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        k4_blend<PLANAR, G, BLEND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  k4_blend<PLANAR, G, BLEND>
      <<<dim3((unsigned)B * (unsigned)N, (unsigned)blend_slices(mh)), THREADS, smem, s>>>(
          static_cast<uint8_t*>(plane), static_cast<const uint8_t*>(src),
          static_cast<const int*>(meta), part, N, slices(mh), hp, wp, mh, mw, keep_mask);
  return cudaGetLastError();
}

// K4's two launches. Groups of 4 pixels (16-byte accesses of a packed
// plane, 32-bit words of each plane of a planar one) where every plane row
// starts on such a boundary and, for a planar source, every source row on a
// 4-byte one; else one pixel per thread.
template <bool PLANAR, bool BLEND>
int launch(void* plane, const void* src, const void* meta, void* scratch, int B, int N, int hp,
           int wp, int mh, int mw, unsigned keep_mask, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* part = static_cast<const int4*>(scratch);
  cudaError_t err = run_bounds<PLANAR>(src, meta, static_cast<int4*>(scratch), B, N, hp, wp, mh,
                                       mw, s);
  if (err != cudaSuccess) return (int)err;
  const bool groups = PLANAR ? aligned(plane, 4) && aligned(src, 4) && wp % 4 == 0 && mw % 4 == 0
                             : aligned(plane, 16) && wp % 4 == 0;
  err = groups ? run_blend<PLANAR, 4, BLEND>(plane, src, meta, part, B, N, hp, wp, mh, mw,
                                             keep_mask, s)
               : run_blend<PLANAR, 1, BLEND>(plane, src, meta, part, B, N, hp, wp, mh, mw,
                                             keep_mask, s);
  return (int)err;
}

}  // namespace

// bytes of scratch one K4 call of B canvases of N placements with sources of
// mh rows takes: the bounds parts
extern "C" long long window_blend_scratch_bytes(int B, int N, int mh) {
  return (long long)sizeof(int4) * B * N * slices(mh);
}

// row slices per placement of the bounds launch (out[0], the parts per
// placement) and of the blend launch (out[1]): their grids' y extents
extern "C" int window_blend_slices(int mh, int* out) {
  out[0] = slices(mh);
  out[1] = blend_slices(mh);
  return 0;
}

// dynamic shared memory of K4's two launches (bounds, blend) for N
// placements per canvas
extern "C" int window_blend_smem(int N, int* out) {
  out[0] = 0;
  out[1] = blend_smem(N);
  return 0;
}

// Launch (a) alone, into part int4 [B, N, S], S = window_blend_slices' out[0].
extern "C" int window_blend_bounds_launch(const void* src, const void* meta, void* part, int B,
                                          int N, int hp, int wp, int mh, int mw, int planar,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* p = static_cast<int4*>(part);
  return (int)(planar ? run_bounds<true>(src, meta, p, B, N, hp, wp, mh, mw, s)
                      : run_bounds<false>(src, meta, p, B, N, hp, wp, mh, mw, s));
}

extern "C" int window_blend_launch(void* plane, const void* src, const void* meta, void* scratch,
                                   int B, int N, int hp, int wp, int mh, int mw, void* stream) {
  return launch<false, true>(plane, src, meta, scratch, B, N, hp, wp, mh, mw, 0u, stream);
}

extern "C" int window_blend_planar_launch(void* plane, const void* src, const void* meta,
                                          void* scratch, int B, int N, int hp, int wp, int mh,
                                          int mw, void* stream) {
  return launch<true, true>(plane, src, meta, scratch, B, N, hp, wp, mh, mw, 0u, stream);
}

// The stage variants of benchmarks/bisect_resize.py:353-359 on a meta the
// wrapper has zeroed: blend != 0 is K4 itself, blend == 0 writes back
// d | (s & keep_mask).
extern "C" int window_blend_stage_launch(void* plane, const void* src, const void* meta,
                                         void* scratch, int B, int N, int hp, int wp, int mh,
                                         int mw, int blend, int keep_mask, void* stream) {
  return blend ? launch<false, true>(plane, src, meta, scratch, B, N, hp, wp, mh, mw, 0u, stream)
               : launch<false, false>(plane, src, meta, scratch, B, N, hp, wp, mh, mw,
                                      (unsigned)keep_mask, stream);
}
