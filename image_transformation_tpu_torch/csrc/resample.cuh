// The tap-bounded Pillow resample shared by K1 (fused_compose.cu) and K2
// (fused_v3.cu): premultiply, a horizontal and a vertical int32 pass with
// Pillow's clip8 after each, unpremultiply; one block per placement (b, k)
// and output tile.
//
// Tile: TX = 32 output columns by TY = 32 output rows, 256 threads (8
// warps). TY trades the vertical halo against parallelism: a tile's H pass
// covers the union of its rows' windows, ~(TY + 6) / s source rows at scale
// s, so the halo is recomputed 6 / TY = 19% of the time at TY = 32 (38% at
// 16); shared memory does not grow with TY, because source rows go through
// in chunks of RC.
//
// Per-warp windows, not the block's union: each output column and each
// output row walks only its own [lo, hi). Warps take one column (H pass) or
// one output row (V pass) at a time, so the window and its coefficients are
// uniform across the warp and no lane diverges; lanes run over source rows
// (H) or output columns (V).
//
// The H pass's column form (an instance's choice, `COLS`): at an upscale s
// a tile's 32 output rows read only ~31 / s + 6 source rows (11-17 at
// 2.9-5.9x), so lanes over source rows leave most of a warp idle. A chunk
// of fewer than 32 source rows whose columns' windows lie in one patch then
// puts lane l on tile column l and warp w on the chunk's rows w, w + 8, ...:
// a chunk of n rows costs each warp ceil(n / 8) passes, not 4. A lane walks
// its own column's window; its patch reads are mostly broadcasts at an
// upscale.
//
// Shared memory (dynamic, `TILE_SMEM_BYTES`): the premultiplied source patch
// of RC rows by CC columns (RGBA packed in a u32, row stride CC + 1, odd, so
// lanes on different rows hit different banks), then the H pass's clipped
// result for the chunk's rows, [TX][RC + 1] packed u32. A tile whose source
// rows or columns do not fit walks them in chunks: the H sums of each
// (row, column) carry across column chunks in shared memory and are clipped
// once all columns are in; the V sums stay in registers across row chunks.
// So no tap is dropped and Pillow's order (clip8 after the whole H sum, then
// after the whole V sum) holds at any window size (a 1-px box's window is
// the whole source row). The H sums live one pair at a time in registers,
// so a thread holds 80 registers and 3 blocks fit an SM.
//
// The core is templated on
// - the taps `Taps`: `h(c, j)` and `v(r, i)` give the coefficient of tile
//   column c / row r at source column j / row i, inside the window (the
//   kernel has written the windows into `TileWindows` before: K1 from its
//   bounds launch, K2 from the sizes); `SharedTaps` reads compact arrays in
//   shared memory (K2 builds them, K1 copies them from its tables). Where a
//   tile's taps do not fit those arrays (objects padded so large that the
//   arrays do not fit beside the core, or tables no Pillow window gives),
//   K1 reads them from its table rows and K2 computes each where it is used;
//   no tap is dropped;
// - the source layout `Src`: `stage` writes premultiplied source pixels of a
//   patch into shared memory, `raw(i, j)` reads one pixel unchanged.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace resample {

constexpr int TX = 32;              // output columns per tile (lanes of the V pass)
constexpr int TY = 32;              // output rows per tile
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RC = 64;              // source rows per chunk (2 groups of 32 lanes)
constexpr int RCW = 32;             // source rows per chunk in a wide tile
constexpr int CC = 128;             // source columns per chunk
constexpr int PS = CC + 1;          // patch row stride (odd: conflict-free)
constexpr int TS = RC + 1;          // H-result column stride (odd)
constexpr int ROWS_PER_WARP = TY / WARPS;
constexpr int PAIRS = (RC / 32) * TX / WARPS;  // (row group, column) pairs per warp
constexpr int PATCH_BYTES = 4 * RC * PS;
// the H result [TX][TS] u32, or in a wide tile the H sums [TX][RCW] int4
constexpr int HRES_BYTES = 4 * TX * TS > 16 * TX * RCW ? 4 * TX * TS : 16 * TX * RCW;
// bytes of dynamic shared memory the core uses (a kernel adds its tap arrays)
constexpr int TILE_SMEM_BYTES = PATCH_BYTES + HRES_BYTES;
// dynamic shared memory a resample block may take on Hopper: 227 KB less
// the static TileWindows and the K2 table's f32 row sums
constexpr int MAX_DYNAMIC_SMEM = 232448 - 2048;

static_assert(TY == 32, "K2's tables build one output row per lane of warp 1");
static_assert(RC % 32 == 0 && RCW == 32 && TY % WARPS == 0, "tile shape");
static_assert(PATCH_BYTES % 16 == 0, "the H sums are int4");

// Where a tile's output pixels go: pixel (oy, ox) of the output at
// out[oy * mw + ox], for ox0 <= ox < ext_w and oy0 <= oy < ext_h.
struct TileDst {
  uchar4* out;
  int mw, ext_h, ext_w, ox0, oy0;
};

struct TileWindows {
  int hlo[TX], hhi[TX];  // window of each tile column (lo == hi: empty)
  int vlo[TY], vhi[TY];  // window of each tile row
  int hoff[TX], voff[TY];  // where each window's taps start in the compact arrays
  int total[2];          // taps of all columns' and of all rows' windows
  int span[4];           // union of the non-empty windows: jlo, jhi, ilo, ihi
};

// Capacity of a tile's compact coefficient array along one axis: `lanes`
// windows over an input of at most `in_max` taps. A Pillow window holds at
// most 6*fs + 2 taps (support 3*fs each side, fs = max(in/out, 1)) and at
// most in_max; over min(lanes, out) live rows that sums to under 6*in_max +
// 2*lanes when downscaling and 8*lanes when upscaling.
__host__ __device__ __forceinline__ int coeff_cap(int in_max, int lanes) {
  const int dense = lanes * in_max, bounded = 6 * in_max + 8 * lanes;
  return dense < bounded ? dense : bounded;
}

// A resample launch's compact tap arrays for objects padded to (ph, pw):
// sets *cap_h and *cap_v (entries), or 0 and 0 when they do not fit beside
// the core (every tile then reads its taps another way); returns the
// dynamic shared memory of one block.
inline int tap_caps(int ph, int pw, int* cap_h, int* cap_v) {
  *cap_h = coeff_cap(pw, TX);
  *cap_v = coeff_cap(ph, TY);
  if (TILE_SMEM_BYTES + 4 * (*cap_h + *cap_v) > MAX_DYNAMIC_SMEM) *cap_h = *cap_v = 0;
  return TILE_SMEM_BYTES + 4 * (*cap_h + *cap_v);
}

// One warp: lane l's window [lo, hi) into the tile's windows (columns for
// warp 0, rows for warp 1), with its start in the compact array (an
// exclusive prefix sum of the lengths) and the axis's total.
__device__ __forceinline__ void set_window(TileWindows& w, int axis, int lane, int lo, int hi) {
  const int len = hi - lo;
  int incl = len;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  (axis == 0 ? w.hlo : w.vlo)[lane] = lo;
  (axis == 0 ? w.hhi : w.vhi)[lane] = hi;
  (axis == 0 ? w.hoff : w.voff)[lane] = incl - len;
  if (lane == 31) w.total[axis] = incl;
}

__device__ __forceinline__ uint32_t premul_pack(int r, int g, int b, int a) {
  return (uint32_t)pillow::muldiv255(r, a) | ((uint32_t)pillow::muldiv255(g, a) << 8) |
         ((uint32_t)pillow::muldiv255(b, a) << 16) | ((uint32_t)a << 24);
}

__device__ __forceinline__ uint32_t clip_pack(const int* acc) {
  return (uint32_t)pillow::clip8(acc[0]) | ((uint32_t)pillow::clip8(acc[1]) << 8) |
         ((uint32_t)pillow::clip8(acc[2]) << 16) | ((uint32_t)pillow::clip8(acc[3]) << 24);
}

__device__ __forceinline__ void mac(int* acc, int w, uint32_t px) {
  acc[0] += w * (int)(px & 255u);
  acc[1] += w * (int)((px >> 8) & 255u);
  acc[2] += w * (int)((px >> 16) & 255u);
  acc[3] += w * (int)(px >> 24);
}

// The union of the non-empty windows lo[0..31], hi[0..31] (one per lane),
// reduced in one warp; an empty union is (0, 0).
__device__ __forceinline__ void warp_union(const int* lo, const int* hi, int lane, int* out) {
  const bool live = hi[lane] > lo[lane];
  int a = live ? lo[lane] : 0x7fffffff, b = live ? hi[lane] : 0;
  for (int off = 16; off > 0; off >>= 1) {
    a = min(a, __shfl_xor_sync(0xffffffffu, a, off));
    b = max(b, __shfl_xor_sync(0xffffffffu, b, off));
  }
  if (lane == 0) {
    out[0] = b > 0 ? a : 0;
    out[1] = b;
  }
}

// A tile's taps in compact arrays in shared memory: window c's taps start
// at win->hoff[c] (columns) or win->voff[c] (rows).
struct SharedTaps {
  const int* coef_h;
  const int* coef_v;
  const TileWindows* win;
  __device__ __forceinline__ int h(int c, int j) const {
    return coef_h[win->hoff[c] + j - win->hlo[c]];
  }
  __device__ __forceinline__ int v(int r, int i) const {
    return coef_v[win->voff[r] + i - win->vlo[r]];
  }
};

// The H pass's column form over a chunk of `nrows` (< 32) source rows
// staged in `patch` from source column j0, whose columns' windows all lie
// in it: lane l takes tile column l, warp w rows w, w + WARPS, ...; each
// (row, column) sum is one thread's, in tap order, clipped once, into
// hres[column][row] (stride TS, odd: the lanes' stores hit 32 banks). The
// taps are read from `tab` on each row: held in registers for the chunk,
// they spilled at the kernel's 80 and ran 3% slower.
template <class Taps>
__device__ __forceinline__ void h_pass_columns(const Taps& tab, const TileWindows& win,
                                               const uint32_t* patch, uint32_t* hres, int j0,
                                               int nrows, int lane, int warp) {
  const int lo = win.hlo[lane], len = win.hhi[lane] - lo, at = lo - j0;
#pragma unroll 1
  for (int r = warp; r < nrows; r += WARPS) {
    const uint32_t* prow = patch + r * PS + at;
    int acc[4] = {0, 0, 0, 0};
    for (int i = 0; i < len; ++i) mac(acc, tab.h(lane, lo + i), prow[i]);
    hres[lane * TS + r] = clip_pack(acc);
  }
}

// Resample one tile of one placement into `out` (row stride `mw`): the
// output pixels [oy0, oy0 + TY) x [ox0, ox0 + TX) cut at (ext_h, ext_w).
// All 256 threads of the block call it, after the tile's windows (`win`)
// and taps are in place and a barrier; `smem` is the dynamic buffer.
//
// A tile whose columns' windows span at most CC source columns (the common
// case) takes source rows RC at a time and clips each H sum as soon as it is
// complete. A wider tile ("wide": a steep downscale or a 1-px box) takes RCW
// rows at a time and walks the columns in chunks of CC, keeping each H sum
// in shared memory (int4 per row and column, owned by one thread) between
// chunks. Either way a thread holds the H result of its (row, column) pairs
// as packed u32 until the whole block is done with the chunk, then writes it.
// With COLS, a chunk that is not wide and has fewer than 32 source rows
// takes the column form (h_pass_columns) instead, uniformly per block, and
// thread 0 adds to `tally` (shared memory) the tile's count in that form
// (1 where every chunk took it) and in all ([0], [1]).
//
// The tile's pixels go to `dst` (TileDst), read only after the passes: a
// caller whose tile origin is not in blockIdx keeps `dst` in shared memory,
// so that no output pointer stays live in registers through the passes.
template <bool COLS = false, class Src, class Taps>
__device__ __forceinline__ void resample_tile(const Src& src, const Taps& tab, TileWindows& win,
                                              uint32_t* smem, const TileDst& dst,
                                              int* tally = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* patch = smem;                                 // [RC][PS]
  uint32_t* hres = smem + PATCH_BYTES / 4;                // [TX][TS]
  int4* hsum = reinterpret_cast<int4*>(hres);             // [TX][RCW], wide tiles

  if (warp == 0) warp_union(win.hlo, win.hhi, lane, win.span);
  if (warp == 1) warp_union(win.vlo, win.vhi, lane, win.span + 2);
  __syncthreads();
  const int jlo = win.span[0], jhi = win.span[1], ilo = win.span[2], ihi = win.span[3];
  const bool wide = jhi - jlo > CC;
  const int rc = wide ? RCW : RC;
  if (COLS && threadIdx.x == 0) {
    tally[0] += !wide && ihi - ilo < 32;
    tally[1] += 1;
  }

  int acc_v[ROWS_PER_WARP][4] = {};
  for (int i0 = ilo; i0 < ihi; i0 += rc) {
    const int i1 = min(i0 + rc, ihi), nrows = i1 - i0;
    if (COLS && !wide && nrows < 32) {  // the column form: one patch, uniform per block
      src.stage(patch, i0, i1, jlo, jhi);
      __syncthreads();
      h_pass_columns(tab, win, patch, hres, jlo, nrows, lane, warp);
    } else {
      uint32_t packed[PAIRS];
      for (int j0 = jlo; j0 < jhi; j0 += CC) {
        const int j1 = min(j0 + CC, jhi);
        src.stage(patch, i0, i1, j0, j1);
        __syncthreads();
#pragma unroll
        for (int m = 0; m < PAIRS; ++m) {
          const int g = m / (TX / WARPS), c = warp + WARPS * (m % (TX / WARPS));
          if (32 * g >= nrows) continue;  // uniform per warp
          int acc[4] = {0, 0, 0, 0};
          if (j0 != jlo) {  // a later column chunk of a wide tile: the sum so far
            const int4 h = hsum[c * RCW + lane];
            acc[0] = h.x, acc[1] = h.y, acc[2] = h.z, acc[3] = h.w;
          }
          const int lo = max(win.hlo[c], j0), hi = min(win.hhi[c], j1);
          const uint32_t* prow = patch + (32 * g + lane) * PS;
#pragma unroll 4
          for (int j = lo; j < hi; ++j) mac(acc, tab.h(c, j), prow[j - j0]);
          if (j1 == jhi) {
            packed[m] = clip_pack(acc);
          } else {
            hsum[c * RCW + lane] = make_int4(acc[0], acc[1], acc[2], acc[3]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int m = 0; m < PAIRS; ++m) {
        const int g = m / (TX / WARPS), c = warp + WARPS * (m % (TX / WARPS));
        const int row = 32 * g + lane;
        if (row < nrows) hres[c * TS + row] = packed[m];
      }
    }
    __syncthreads();
    const uint32_t* hcol = hres + lane * TS;
#pragma unroll
    for (int q = 0; q < ROWS_PER_WARP; ++q) {
      const int r = warp + WARPS * q;
      const int lo = max(win.vlo[r], i0), hi = min(win.vhi[r], i1);
#pragma unroll 4
      for (int i = lo; i < hi; ++i) mac(acc_v[q], tab.v(r, i), hcol[i - i0]);
    }
    __syncthreads();  // hres and the patch are rewritten by the next chunk
  }

  uchar4* __restrict__ out = dst.out;
  const int mw = dst.mw, ext_h = dst.ext_h, ext_w = dst.ext_w;
  const int ox = dst.ox0 + lane;
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int oy = dst.oy0 + warp + WARPS * q;
    if (ox < ext_w && oy < ext_h) {
      const int* a = acc_v[q];
      out[(size_t)oy * mw + ox] = pillow::unpremultiply(
          pillow::clip8(a[0]), pillow::clip8(a[1]), pillow::clip8(a[2]), pillow::clip8(a[3]));
    }
  }
}

template <class Src, class Taps>
__device__ __forceinline__ void resample_tile(const Src& src, const Taps& tab, TileWindows& win,
                                              uint32_t* smem, uchar4* __restrict__ out,
                                              int mw, int ext_h, int ext_w, int ox0, int oy0) {
  resample_tile(src, tab, win, smem, TileDst{out, mw, ext_h, ext_w, ox0, oy0});
}

// Pillow's plain copy of a tile (identity / `same`): the object's pixel
// where it lies inside the (ph, pw) pad, 0 past it.
template <class Src>
__device__ __forceinline__ void copy_tile(const Src& src, uchar4* __restrict__ out, int mw,
                                          int ph, int pw, int ext_h, int ext_w, int ox0,
                                          int oy0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ox = ox0 + lane;
#pragma unroll
  for (int q = 0; q < ROWS_PER_WARP; ++q) {
    const int oy = oy0 + warp + WARPS * q;
    if (ox < ext_w && oy < ext_h) {
      out[(size_t)oy * mw + ox] =
          (oy < ph && ox < pw) ? src.raw(oy, ox) : make_uchar4(0, 0, 0, 0);
    }
  }
}

// Source layout of K1: interleaved RGBA, uchar4 [ph, pw] per object.
// `base` is the objects tensor of `total` pixels (16-byte aligned when
// `vec`), `off` the object's first pixel in it. With `vec`, each thread
// loads 16 bytes (4 pixels) of a row segment aligned down to a 4-pixel
// boundary of the tensor (pixel by pixel where those 4 would pass its
// end); the premultiply happens in registers between the load and the
// shared store (so cp.async, a raw copy, does not apply).
struct InterleavedSrc {
  const uchar4* __restrict__ base;
  size_t off, total;
  int pw;
  bool vec;

  __device__ __forceinline__ uchar4 raw(int i, int j) const {
    return base[off + (size_t)i * pw + j];
  }

  __device__ __forceinline__ void stage(uint32_t* patch, int i0, int i1, int j0, int j1) const {
    const int n = j1 - j0, rows = i1 - i0;
    if (vec) {
      const int quads = (n + 3) / 4 + 1;  // a segment spans at most this many quads
      const uint4* q4 = reinterpret_cast<const uint4*>(base);
      for (int e = threadIdx.x; e < rows * quads; e += THREADS) {
        const int ri = e / quads, q = e - ri * quads;
        const size_t a = off + (size_t)(i0 + ri) * pw + j0;  // first pixel of the segment
        const size_t a4 = (a & ~(size_t)3) + 4 * (size_t)q;
        if (a4 >= a + n) continue;
        uint32_t w[4];
        if (a4 + 4 <= total) {
          const uint4 v = __ldg(q4 + a4 / 4);
          w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
        } else {  // the tensor's last pixels: only those before its end
          const uint32_t* px = reinterpret_cast<const uint32_t*>(base);
#pragma unroll
          for (int t = 0; t < 4; ++t) w[t] = a4 + t < total ? __ldg(px + a4 + t) : 0u;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const size_t at = a4 + t;
          if (at < a || at >= a + n) continue;
          const uint32_t p = w[t];
          patch[ri * PS + (int)(at - a)] =
              premul_pack(p & 255u, (p >> 8) & 255u, (p >> 16) & 255u, p >> 24);
        }
      }
    } else {
      for (int e = threadIdx.x; e < rows * n; e += THREADS) {
        const int ri = e / n, c = e - ri * n;
        const uchar4 p = raw(i0 + ri, j0 + c);
        patch[ri * PS + c] = premul_pack(p.x, p.y, p.z, p.w);
      }
    }
  }
};

// Source layout of K2: planar u8 [4, ph, pw] per object. With `vec` (the
// plane size and the tensor's address multiples of 4), each thread loads
// one 32-bit word of each of the four planes: 16 bytes, 4 pixels.
struct PlanarSrc {
  const uint8_t* __restrict__ base;
  size_t off;    // byte offset of the object's first plane
  size_t plane;  // ph * pw
  int pw;
  bool vec;

  __device__ __forceinline__ uchar4 raw(int i, int j) const {
    const size_t at = off + (size_t)i * pw + j;
    return make_uchar4(base[at], base[at + plane], base[at + 2 * plane], base[at + 3 * plane]);
  }

  __device__ __forceinline__ void stage(uint32_t* patch, int i0, int i1, int j0, int j1) const {
    const int n = j1 - j0, rows = i1 - i0;
    if (vec) {
      const int quads = (n + 3) / 4 + 1;
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(base);
      const size_t p4 = plane / 4;
      for (int e = threadIdx.x; e < rows * quads; e += THREADS) {
        const int ri = e / quads, q = e - ri * quads;
        const size_t a = off + (size_t)(i0 + ri) * pw + j0;
        const size_t a4 = (a & ~(size_t)3) + 4 * (size_t)q;
        if (a4 >= a + n) continue;
        const size_t w = a4 / 4;
        const uint32_t r = __ldg(w4 + w), g = __ldg(w4 + w + p4), b = __ldg(w4 + w + 2 * p4),
                       al = __ldg(w4 + w + 3 * p4);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const size_t at = a4 + t;
          if (at < a || at >= a + n) continue;
          const int s = 8 * t;
          patch[ri * PS + (int)(at - a)] = premul_pack((r >> s) & 255u, (g >> s) & 255u,
                                                       (b >> s) & 255u, (al >> s) & 255u);
        }
      }
    } else {
      for (int e = threadIdx.x; e < rows * n; e += THREADS) {
        const int ri = e / n, c = e - ri * n;
        const uchar4 p = raw(i0 + ri, j0 + c);
        patch[ri * PS + c] = premul_pack(p.x, p.y, p.z, p.w);
      }
    }
  }
};

// Opt a kernel into `bytes` of dynamic shared memory on the current device,
// once per kernel, device and size (a block's static and dynamic shared
// memory together above 48 KB need it); returns the CUDA error (0 on
// success). Kernels of one signature (the instances of a template) pass
// distinct TAGs.
template <int TAG = 0, class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes) {
  constexpr int MAX_DEVICES = 64;
  static int allowed[MAX_DEVICES] = {};  // one array per kernel signature and TAG
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < MAX_DEVICES && bytes <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) allowed[dev] = bytes;
  return err;
}

}  // namespace resample
