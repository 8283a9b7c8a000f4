// K2: gen-3 fused resize + alpha-over for Hopper (sm_90a), with the
// Pillow coefficient tables built on the device from four sizes per object.
//
// Replaces the TPU kernel image_transformation_tpu/ops/compose_pallas.py:
// _make_fused_kernel_v3 and _make_fused_kernel_v3_pipelined (launched by
// _pallas_fused_v3_impl). For each live placement (canvas b, object k):
//   1. build the H and V tables from (in_h, in_w, out_h, out_w) (meta
//      columns 6-9) with the float32 formula of ops/resize.py
//      resample_coeff_matrix + quantize_coeffs (= _coeff_table_in_kernel);
//   2. premultiply, the separable int32 resample (clip8 after each pass),
//      unpremultiply; or, when `same` is set, the object's pixels unchanged;
//   3. alpha-over into the packed plane at the box origin (ws + d), in
//      object order, with Pillow's arithmetic; content past the plane's
//      (hp, wp) is cut off. A placement whose `valid` is 0 is dropped.
// Gen-3's meta clamps target sizes so every window ends inside the plane
// (origins capped at hp-MH / wp-MW, or per object), so cutting at the
// plane edge cuts exactly what the TPU kernel's window cuts; nothing
// outside an object's window changes.
//
// What bounds it on this card: the integer multiply-adds of the two
// resample passes on each window's taps (bound by operations), and the f32
// table arithmetic (a degree-12 Horner and a divide per tap). What the
// design does about it, in two launches (three in a mixed launch):
// - the grid: both kernels walk only the live 32x32 tiles of the launch
//   (csrc/live_tiles.cuh), a persistent grid of the SMs times the blocks an
//   SM holds, where a placement's share of the envelope is small (the UHD
//   cell's logo, text and CTA beside its photo: 75% of the blocks of a
//   grid over the envelope would exit at once); the
//   resample's blocks claim tiles one at a time, since its tiles' costs
//   differ. A launch of more placements than the walk's prefix (4 bytes a
//   placement) fits beside a kernel's shared memory without lowering its
//   blocks an SM runs as several launches over ranges of placements;
// - resample (csrc/resample.cuh), one 32x32 output tile of a placement at a
//   time: a block builds its 32 columns' and 32 rows' windows, weight
//   sums and quantized taps once, into compact [rows][taps] arrays in
//   shared memory (each tap's coefficient is computed once per tile; where
//   objects are padded so large that the arrays do not fit beside the
//   core and the walk's prefix, ph + pw > 7,455, each tap is computed
//   where it is used instead, slower but with no size limit); each
//   output column and row then walks only its own window; the
//   source patch is staged premultiplied in shared memory, four pixels of
//   the four planes (16 bytes) per thread, and the H result stays in shared
//   memory, so there is no scratch in device memory between the passes;
//   the mixed instance's H pass puts lanes on the tile's 32 columns where a
//   chunk has fewer than 32 source rows (an upscale reads 11-17 a tile at
//   the UHD cell's 2.9-5.9x, which left 50-65% of the lanes idle over
//   source rows); the other instance and K1 keep lanes on source rows;
// - the f32 table arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn, which
//   nvcc never contracts into FMAs, and each row's weight sum adds the taps
//   in index order, so the tables equal the plain version's
//   (ops/resize.py:build_coeffs_v3) bit for bit;
// - where an axis grows (out > in), the f32 centre (o + 0.5) * scale is off
//   by ~3e-5 px at 5.85x, which moves coefficients by up to ~90 units of
//   2^22 from Pillow's and pixels by 3: in a launch whose output envelope
//   exceeds the objects' padded extent (mh > ph or mw > pw: the upscaling
//   renders) each growing axis's tap argument is ((2i + 1) out - (2o + 1)
//   in) * (1 / (2 out)), an exact integer times a rounded reciprocal, and
//   its window is computed in integers (within 2 units of Pillow's tables).
//   The other launches run the f32 form alone: compiled beside the mixed
//   one in a kernel, it ran 4% slower (1080p B=256, 0.963 -> 1.003 ms);
// - in a mixed launch the growing axes' tables are built once per
//   placement, not once per tile: a table stage (v3_tables) runs ahead of
//   the resample and writes each output position's window and quantized
//   taps (32 bytes, `TapEntry`) to a chunk-sized buffer; a tile whose axis
//   grows loads its 32 entries with 16-byte loads instead of rebuilding
//   them (the build was 52% of an upscale tile's cycles at the UHD cell's
//   shapes). A shrinking axis keeps the per-tile build;
// - blend (csrc/box_blend.cuh): over each placement's live tiles only, z-order by
//   the last covering placement (Hopper runs blocks in no order and the
//   windows of one canvas overlap), the canvas's boxes staged in shared
//   memory;
// - scratch: the wrapper (ops/compose_kernels.py:fused_v3) launches over
//   chunks of canvases, so `res` stays within its budget whatever the
//   batch; at 1080p B=1280 the plane alone is 10.6 GB.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   plane   i32 [B, hp, wp]            packed RGBA, updated in place
//   objects u8  [Bo, N, 4, ph, pw]     planar, Bo == 1 (shared) or B
//   meta    i32 [B, N, 10]             ws_x ws_y dx dy same valid in_h in_w out_h out_w
//   res     u8  [B, N, mh, mw, 4]      scratch (resampled RGBA)
//   tables  i32 [B, N, P, 8]           scratch of a mixed launch (else null):
//           per output position, columns first (P = ceil32(mw) +
//           ceil32(mh)), a growing axis's 6 taps, lo and hi
// Sizes are clamped to the envelopes (in to (ph, pw), out to (mh, mw)).

#include <cstdint>
#include <cuda_runtime.h>

#include "box_blend.cuh"
#include "live_tiles.cuh"
#include "pillow.cuh"
#include "resample.cuh"

namespace {

constexpr int META = 10;

struct Meta {
  int x1, y1, same, valid, in_h, in_w, out_h, out_w;
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ Meta load_meta(const int* __restrict__ meta, int bk,
                                          int ph, int pw, int mh, int mw) {
  const int* m = meta + (size_t)bk * META;
  Meta r;
  r.x1 = m[0] + m[2];
  r.y1 = m[1] + m[3];
  r.same = m[4];
  r.valid = m[5];
  r.in_h = clampi(m[6], ph);
  r.in_w = clampi(m[7], pw);
  r.out_h = clampi(m[8], mh);
  r.out_w = clampi(m[9], mw);
  return r;
}

// ---- the f32 table formula (ops/resize.py:resample_coeff_matrix) ----

// the degree-12 lanczos3 fit in u = x^2 (exact float32 constants)
__constant__ float LANCZOS3_POLY_U[13] = {
    0.019992724061012268f, 0.12934572994709015f, -0.43056443333625793f,
    0.2683068513870239f,   0.3336562514305115f,  -0.6404303312301636f,
    0.4925920069217682f,   -0.2359950840473175f, 0.08007098734378815f,
    -0.020507415756583214f, 0.004155285656452179f, -0.0007197138038463891f,
    9.71919289440848e-05f,
};

__device__ __forceinline__ float lanczos3(float x) {
  const float t = fminf(
      __fsub_rn(__fmul_rn(__fmul_rn(x, x), (float)(1.0 / 4.5)), 1.0f), 1.0f);
  float acc = LANCZOS3_POLY_U[12];
#pragma unroll
  for (int c = 11; c >= 0; --c) {
    acc = __fadd_rn(__fmul_rn(acc, t), LANCZOS3_POLY_U[c]);
  }
  return fabsf(x) < 3.0f ? acc : 0.0f;
}

// One axis of a placement: support 3 fs and inv_fs 1 / fs (fs = max(scale,
// 1)). In the mixed form (MIXED, the tiles of placements with a growing
// axis) a growing axis (scale < 1: out > in) holds out in `support` and
// 1 / (2 out) in `inv_fs`, the exact-argument form's constants.
struct Axis {
  float in_f, scale, support, inv_fs;
};

__device__ __forceinline__ bool grows(const Axis& a) { return a.scale < 1.0f; }

template <bool MIXED>
__device__ __forceinline__ Axis axis_params(int in_size, int out_size) {
  Axis a;
  a.in_f = (float)in_size;
  const float out_f = fmaxf((float)out_size, 1.0f);
  a.scale = __fdiv_rn(a.in_f, out_f);
  if (MIXED && grows(a)) {
    a.support = out_f;
    a.inv_fs = __fdiv_rn(1.0f, __fmul_rn(2.0f, out_f));
    return a;
  }
  const float fs = fmaxf(a.scale, 1.0f);
  a.support = __fmul_rn(3.0f, fs);
  a.inv_fs = __fdiv_rn(1.0f, fs);
  return a;
}

// One output position's window and weight sum. Rows at or past the output
// size are all zero (lo == hi). On a growing axis `center` holds the bits
// of the integer (2o + 1) in, twice the output size times the centre.
struct Row {
  float center, wsum;
  int lo, hi;
};

// Tap i's weight, in the growing axis's exact-argument form (GROW) or the
// f32 form.
template <bool GROW>
__device__ __forceinline__ float tap_weight(const Axis& a, float center, int i) {
  if (GROW) {
    const int num = (2 * i + 1) * (int)a.support - __float_as_int(center);
    return lanczos3(__fmul_rn((float)num, a.inv_fs));
  }
  return lanczos3(
      __fmul_rn(__fadd_rn(__fsub_rn((float)i, center), 0.5f), a.inv_fs));
}

template <bool MIXED>
__device__ Row row_params(const Axis& a, int o, int out_size) {
  Row r;
  if (MIXED && grows(a)) {
    const int in = (int)a.in_f, out = (int)a.support;
    const int c2 = (2 * o + 1) * in;
    const int lo_num = c2 - 5 * out;  // (centre - 3 + 0.5) * 2 out
    r.center = __int_as_float(c2);
    r.lo = min(lo_num > 0 ? lo_num / (2 * out) : 0, in);
    r.hi = o < max(out_size, 1) ? min((c2 + 7 * out) / (2 * out), in) : r.lo;
    float s = 0.0f;
    for (int i = r.lo; i < r.hi; ++i) s = __fadd_rn(s, tap_weight<true>(a, r.center, i));
    r.wsum = s != 0.0f ? s : 1.0f;
    return r;
  }
  r.center = __fmul_rn(__fadd_rn((float)o, 0.5f), a.scale);
  const float lo = fminf(
      fmaxf(truncf(__fadd_rn(__fsub_rn(r.center, a.support), 0.5f)), 0.0f),
      a.in_f);
  const float hi = fminf(
      fmaxf(truncf(__fadd_rn(__fadd_rn(r.center, a.support), 0.5f)), 0.0f),
      a.in_f);
  r.lo = (int)lo;
  r.hi = o < max(out_size, 1) ? (int)hi : r.lo;  // the (o < out_f) row mask
  float s = 0.0f;
  for (int i = r.lo; i < r.hi; ++i) s = __fadd_rn(s, tap_weight<false>(a, r.center, i));
  r.wsum = s != 0.0f ? s : 1.0f;
  return r;
}

// quantized coefficient of tap i inside a row's window
template <bool GROW>
__device__ __forceinline__ int coeff(const Axis& a, float center, float wsum, int i) {
  const float w = __fdiv_rn(tap_weight<GROW>(a, center, i), wsum);
  const float scaled = __fmul_rn(w, 4194304.0f);  // 2^22
  return (int)truncf(__fadd_rn(scaled, w < 0.0f ? -0.5f : 0.5f));
}

// A growing axis's output position in the table stage's buffer: its window
// [lo, hi) and its quantized taps, zero past hi. In the exact-argument form
// hi - lo <= (12 out) / (2 out) = 6, so 6 slots hold every window.
constexpr int ENTRY_TAPS = 6;
struct TapEntry {
  int4 a, b;  // taps 0-3; taps 4-5, lo, hi
};
static_assert(sizeof(TapEntry) == 32, "an entry is two 16-byte loads");

// The mixed instance's tiles since the library was loaded, on each device:
// [0] those whose H pass took the column form, [1] all it resampled (not
// the plain copies). Each block adds its counts once, as it leaves the walk.
__device__ unsigned long long g_h_tally[2];

__host__ __device__ __forceinline__ int ceil_tile(int v) {
  return (v + resample::TX - 1) / resample::TX * resample::TX;
}

// K2's tables for one tile: each tile column's and row's window and weight
// sum (centre and sum in shared memory, `center`/`wsum` [TX + TY], columns
// first), with the plain version's f32 op order (row_params, coeff); with
// MIXED each growing axis takes the exact-argument form. As `Taps` of the
// core it computes each coefficient where it is used: the tiles whose taps
// do not fit the compact arrays take that path.
template <bool MIXED>
struct V3Taps {
  Axis axh, axv;
  float* center;
  float* wsum;

  __device__ __forceinline__ int h(int c, int j) const {
    return MIXED && grows(axh) ? coeff<true>(axh, center[c], wsum[c], j)
                               : coeff<false>(axh, center[c], wsum[c], j);
  }
  __device__ __forceinline__ int v(int r, int i) const {
    const float ce = center[resample::TX + r], ws = wsum[resample::TX + r];
    return MIXED && grows(axv) ? coeff<true>(axv, ce, ws, i) : coeff<false>(axv, ce, ws, i);
  }

  // The tile's windows into `w`, then, when they fit (cap_h and cap_v
  // entries), the quantized taps built once into compact [rows][taps]
  // arrays (ragged: window c's taps start at hoff[c] / voff[c]; read by
  // SharedTaps). Returns whether they fit (the same in every thread).
  // With MIXED, an axis given its table stage's entries (`th` for the
  // tile's columns, `tv` for its rows; null where the axis shrinks) loads
  // its windows and taps from them instead of building them.
  __device__ bool prepare(resample::TileWindows& w, int ox0, int oy0, int out_w, int out_h,
                          int* coef_h, int* coef_v, int cap_h, int cap_v,
                          const TapEntry* th = nullptr, const TapEntry* tv = nullptr) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const TapEntry* tab = warp == 0 ? th : tv;
    if (warp < 2 && MIXED && tab != nullptr) {  // a growing axis: the stage's entries
      const int4 a = __ldg(&tab[lane].a), b = __ldg(&tab[lane].b);
      resample::set_window(w, warp, lane, b.z, b.w);
      const int off = warp == 0 ? w.hoff[lane] : w.voff[lane], len = b.w - b.z;
      int* dst = (warp == 0 ? coef_h : coef_v) + off;
      if (off + len <= (warp == 0 ? cap_h : cap_v)) {  // all lanes, exactly when they fit
        const int t[ENTRY_TAPS] = {a.x, a.y, a.z, a.w, b.x, b.y};
#pragma unroll
        for (int i = 0; i < ENTRY_TAPS; ++i) {
          if (i < len) dst[i] = t[i];
        }
      }
    } else if (warp < 2) {  // warp 0: the tile's columns, warp 1: its rows
      const Row r = warp == 0 ? row_params<MIXED>(axh, ox0 + lane, out_w)
                              : row_params<MIXED>(axv, oy0 + lane, out_h);
      center[warp * resample::TX + lane] = r.center;
      wsum[warp * resample::TX + lane] = r.wsum;
      resample::set_window(w, warp, lane, r.lo, r.hi);
    }
    __syncthreads();
    if (w.total[0] > cap_h || w.total[1] > cap_v) {
      if (MIXED && warp < 2 && tab != nullptr) {  // the computed taps need the centre and sum
        const Row r = warp == 0 ? row_params<MIXED>(axh, ox0 + lane, out_w)
                                : row_params<MIXED>(axv, oy0 + lane, out_h);
        center[warp * resample::TX + lane] = r.center;
        wsum[warp * resample::TX + lane] = r.wsum;
      }
      return false;
    }
    // the quantized taps, one window per warp at a time, lanes over taps;
    // entries e < TX are the columns', the rest the rows' (loaded above
    // where the axis has entries)
    const int e0 = MIXED && th != nullptr ? resample::TX : 0;
    const int e1 = MIXED && tv != nullptr ? resample::TX : resample::TX + resample::TY;
    for (int e = e0 + warp; e < e1; e += resample::WARPS) {
      const bool horiz = e < resample::TX;
      const int c = horiz ? e : e - resample::TX;
      const int lo = horiz ? w.hlo[c] : w.vlo[c], hi = horiz ? w.hhi[c] : w.vhi[c];
      int* dst = horiz ? coef_h + w.hoff[c] : coef_v + w.voff[c];
      const Axis ax = horiz ? axh : axv;
      if (MIXED && grows(ax)) {
        for (int i = lo + lane; i < hi; i += 32)
          dst[i - lo] = coeff<true>(ax, center[e], wsum[e], i);
      } else {
        for (int i = lo + lane; i < hi; i += 32)
          dst[i - lo] = coeff<false>(ax, center[e], wsum[e], i);
      }
    }
    return true;
  }
};

// The tables and the resample of one tile (ox0, oy0) of a placement that
// is neither dropped nor a plain copy, into `dst` (in shared memory, read
// after the passes); `win`, `center` and `wsum` in shared memory.
// `entries` is the placement's table-stage entries (columns, then rows, at
// ceil_tile(mw)), null where the launch has none. With MIXED the H pass may
// take its column form, counted in `tally` (shared memory).
template <bool MIXED>
__device__ __forceinline__ void resample_placement_tile(
    const resample::PlanarSrc& src, const resample::TileDst& dst, const Meta& m, int ox0,
    int oy0, int mw, int cap_h, int cap_v, resample::TileWindows& win, float* center,
    float* wsum, const TapEntry* entries, int* tally) {
  extern __shared__ uint32_t smem[];
  int* coef = reinterpret_cast<int*>(smem + resample::TILE_SMEM_BYTES / 4);
  const V3Taps<MIXED> taps{axis_params<MIXED>(m.in_w, m.out_w),
                           axis_params<MIXED>(m.in_h, m.out_h), center, wsum};
  const bool tabled = MIXED && entries != nullptr;
  const TapEntry* th = tabled && grows(taps.axh) ? entries + ox0 : nullptr;
  const TapEntry* tv = tabled && grows(taps.axv) ? entries + ceil_tile(mw) + oy0 : nullptr;
  const bool staged =
      taps.prepare(win, ox0, oy0, m.out_w, m.out_h, coef, coef + cap_h, cap_h, cap_v, th, tv);
  __syncthreads();
  if (staged) {
    resample::resample_tile<MIXED>(src, resample::SharedTaps{coef, coef + cap_h, &win}, win, smem,
                                   dst, tally);
  } else {
    resample::resample_tile<MIXED>(src, taps, win, smem, dst, tally);
  }
}

// (0) grid (B*N, ceil(P / 256)), a mixed launch only: one thread per output
// position of a placement (P = ceil_tile(mw) + ceil_tile(mh), columns
// first) writes the growing axis's window and quantized taps with the
// tiles' own functions (row_params, coeff: bit-equal to a tile's build).
// Positions are written where a tile reads them: live placements that are
// not a plain copy, axes that grow, positions under ceil_tile(out).
__global__ void __launch_bounds__(256)
v3_tables(const int* __restrict__ meta, TapEntry* __restrict__ tables, int ph, int pw, int mh,
          int mw) {
  const int bk = blockIdx.x;
  const int pcols = ceil_tile(mw), npos = pcols + ceil_tile(mh);
  const int p = blockIdx.y * blockDim.x + threadIdx.x;
  if (p >= npos) return;
  const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
  const bool col = p < pcols;
  const int o = col ? p : p - pcols, out = col ? m.out_w : m.out_h;
  if (m.valid <= 0 || m.same > 0 || o >= ceil_tile(out)) return;
  const Axis a = axis_params<true>(col ? m.in_w : m.in_h, out);
  if (!grows(a)) return;
  const Row r = row_params<true>(a, o, out);
  int t[ENTRY_TAPS];
#pragma unroll
  for (int i = 0; i < ENTRY_TAPS; ++i) {
    t[i] = r.lo + i < r.hi ? coeff<true>(a, r.center, r.wsum, r.lo + i) : 0;
  }
  TapEntry* e = tables + (size_t)bk * npos + p;
  e->a = make_int4(t[0], t[1], t[2], t[3]);
  e->b = make_int4(t[4], t[5], r.lo, r.hi);
}

// K2's placement rectangles, from the meta: the box at its origin, 0 when
// the placement is not valid. Its (w, h) are the resample's extent too.
struct V3Rects {
  const int* __restrict__ meta;
  int mh, mw;
  __device__ __forceinline__ int4 get(int bk) const {
    const int* r = meta + (size_t)bk * META;
    const bool valid = r[5] > 0;
    return make_int4(r[0] + r[2], r[1] + r[3], valid ? clampi(r[9], mw) : 0,
                     valid ? clampi(r[8], mh) : 0);
  }
};

// (1) the resample of one live placement's tiles, walked (a persistent
// grid, csrc/live_tiles.cuh) over the live tiles of placements p0 .. p0+n-1
// of the launch's B*N; each tile goes into res (or takes the object's own
// pixels where `same` is set); with MIXED the growing axes' tables take the
// exact-argument form, loaded from `tables` (the stage's buffer) where it
// is not null. The prefix lies in dynamic shared memory after the core and
// the tap arrays. Its tiles differ in cost (a tile's source patch grows
// with the downscale), so blocks claim them one at a time from the counter
// `claims` rather than by a fixed stride: a stride left blocks with unequal
// work (on an H100, score1080's resample ran 8% slower than a grid of one
// block per envelope tile, whose blocks the hardware hands out as slots
// free). The block's next flat tile, its cursor and the tile's output live
// in shared memory, not in registers through the tile's passes (the core
// holds 80 a thread); the next claim is made as a tile starts, so its
// latency hides behind it. With MIXED, thread 0 counts the block's tiles by
// H-pass form in shared memory and adds them to g_h_tally as it leaves.
template <bool MIXED>
__global__ void __launch_bounds__(resample::THREADS, 3)
v3_resample(const uint8_t* __restrict__ objects, const int* __restrict__ meta,
            uchar4* __restrict__ res, const TapEntry* __restrict__ tables, int Bo, int N, int ph,
            int pw, int mh, int mw, int cap_h, int cap_v, int vec, int p0, int n,
            int* __restrict__ claims) {
  extern __shared__ uint32_t smem[];
  __shared__ int s_warp[resample::WARPS];
  __shared__ resample::TileWindows win;
  __shared__ float center[resample::TX + resample::TY], wsum[resample::TX + resample::TY];
  __shared__ resample::TileDst s_dst;
  __shared__ int s_walk[2];
  __shared__ int s_tally[2];  // MIXED: the block's tiles in the column form, and in all
  int* prefix = reinterpret_cast<int*>(smem + resample::TILE_SMEM_BYTES / 4 + cap_h + cap_v);
  if (threadIdx.x == 0) s_walk[0] = atomicAdd(claims, 1), s_walk[1] = 0;
  if (MIXED && threadIdx.x == 0) s_tally[0] = s_tally[1] = 0;
  live_tiles::build_prefix<resample::THREADS>(prefix, p0, n, V3Rects{meta, mh, mw}, s_warp);
  for (;;) {
    const int t = s_walk[0];
    if (t >= prefix[n]) break;  // uniform
    const int i = live_tiles::advance(prefix, n, s_walk[1], t);
    const int local = t - prefix[i], bk = p0 + i;
    __syncthreads();  // every thread has read s_walk
    const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
    const int ntx = (m.out_w + resample::TX - 1) / resample::TX, ty = local / ntx;
    const int ox0 = (local - ty * ntx) * resample::TX, oy0 = ty * resample::TY;
    const int b = bk / N, k = bk - b * N;
    const size_t plane = (size_t)ph * pw;
    const resample::PlanarSrc src{objects, ((size_t)(Bo == 1 ? 0 : b) * N + k) * 4 * plane,
                                  plane, pw, vec != 0};
    uchar4* out = res + (size_t)bk * mh * mw;
    if (threadIdx.x == 0) {
      s_walk[0] = atomicAdd(claims, 1), s_walk[1] = i;
      // the passes' output: the tile's first pixel and its extent left from there
      s_dst = resample::TileDst{out + (size_t)oy0 * mw + ox0, mw, m.out_h - oy0, m.out_w - ox0,
                                0, 0};
    }
    if (m.same > 0) {  // Pillow's plain copy: out == in
      resample::copy_tile(src, out, mw, ph, pw, m.out_h, m.out_w, ox0, oy0);
    } else {
      const TapEntry* entries =
          MIXED && tables != nullptr ? tables + (size_t)bk * (ceil_tile(mw) + ceil_tile(mh))
                                     : nullptr;
      // s_dst is read after the tile's barriers
      resample_placement_tile<MIXED>(src, s_dst, m, ox0, oy0, mw, cap_h, cap_v, win, center,
                                     wsum, entries, s_tally);
    }
    __syncthreads();  // s_walk's and s_dst's updates are seen (a plain copy has no barrier)
  }
  if (MIXED && threadIdx.x == 0 && s_tally[1] > 0) {
    atomicAdd(&g_h_tally[0], (unsigned long long)s_tally[0]);
    atomicAdd(&g_h_tally[1], (unsigned long long)s_tally[1]);
  }
  if (threadIdx.x == 0) live_tiles::finish(claims);
}

// The walk's launches for placements of N a canvas, objects padded to
// (ph, pw), envelope (mh, mw), on the current device: for the resample
// [0] and the blend [1], the most placements a launch walks, the resident
// blocks an SM, the blocks a launch (the SMs times those, or fewer where
// the launch has fewer envelope tiles) and the dynamic shared memory
// before the prefix.
struct V3Grid {
  int cap[2], resident[2], sms, base[2];
  long long env_tiles;  // envelope tiles a placement

  // blocks of a launch of kernel i over n placements
  unsigned blocks(int i, int n) const {
    const long long full = (long long)sms * resident[i], env = env_tiles * n;
    return (unsigned)(env < full ? env : full);
  }
};

// The flat tile indices of a launch stay below 2^30 (an int with room for
// the claims past the total).
constexpr long long MAX_WALK_TILES = 1LL << 30;

// The resample's compact tap arrays (resample::tap_caps) where they leave
// room for the prefix of one placement, else none (every tile computes its
// taps where it uses them); returns the dynamic shared memory before the
// prefix.
int v3_tap_caps(int ph, int pw, int* cap_h, int* cap_v) {
  const int smem = resample::tap_caps(ph, pw, cap_h, cap_v);
  if (smem + 8 <= resample::MAX_DYNAMIC_SMEM) return smem;
  *cap_h = *cap_v = 0;
  return resample::TILE_SMEM_BYTES;
}

cudaError_t v3_grid(int N, int ph, int pw, int mh, int mw, V3Grid* g) {
  const bool mixed = mh > ph || mw > pw;
  int cap_h, cap_v;
  g->base[0] = v3_tap_caps(ph, pw, &cap_h, &cap_v);
  g->base[1] = box_blend::smem_bytes(N);
  g->env_tiles =
      (long long)((mw + resample::TX - 1) / resample::TX) * ((mh + resample::TY - 1) / resample::TY);
  if (g->env_tiles > MAX_WALK_TILES) return cudaErrorInvalidValue;
  // the prefix may take what the kernels' shared memory leaves
  const void* kernels[2] = {mixed ? (const void*)v3_resample<true> : (const void*)v3_resample<false>,
                            (const void*)box_blend::box_blend_walk<V3Rects>};
  cudaError_t err = mixed ? resample::allow_smem<1>(v3_resample<true>, resample::MAX_DYNAMIC_SMEM)
                          : resample::allow_smem<0>(v3_resample<false>, resample::MAX_DYNAMIC_SMEM);
  if (err == cudaSuccess) {
    err = resample::allow_smem(box_blend::box_blend_walk<V3Rects>, resample::MAX_DYNAMIC_SMEM);
  }
  const int threads[2] = {resample::THREADS, box_blend::THREADS};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    live_tiles::Fit f;
    err = live_tiles::fit(kernels[i], threads[i], g->base[i], resample::MAX_DYNAMIC_SMEM, &f);
    const long long most = MAX_WALK_TILES / g->env_tiles;
    g->cap[i] = f.cap < most ? f.cap : (int)most;
    g->resident[i] = f.resident;
    g->sms = f.sms;
  }
  return err;
}

}  // namespace

static_assert(resample::TX == resample::TY && box_blend::TILE == resample::TX &&
                  live_tiles::TILE == resample::TX,
              "one 32 x 32 tile for both axes, both kernels and the walk");

// K2's table stage alone (for a mixed launch; also the card tests' entry):
// writes `tables` [B*N, ceil_tile(mw) + ceil_tile(mh)] entries.
extern "C" int fused_v3_tables_launch(const void* meta, void* tables, int B, int N, int ph,
                                      int pw, int mh, int mw, void* stream) {
  const unsigned bn = (unsigned)B * (unsigned)N;
  const dim3 grid(bn, (ceil_tile(mw) + ceil_tile(mh) + 255) / 256);
  v3_tables<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(meta), static_cast<TapEntry*>(tables), ph, pw, mh, mw);
  return (int)cudaGetLastError();
}

// The mixed instance's tiles on the current device since the library was
// loaded (g_h_tally): out[0] those whose H pass took the column form, out[1]
// all it resampled. A copy from the device: it waits for the launches on
// the legacy default stream (the caller synchronises the others).
extern "C" int fused_v3_h_tally(long long* out) {
  unsigned long long v[2];
  const cudaError_t err = cudaMemcpyFromSymbol(v, g_h_tally, sizeof(v));
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)v[0];
  out[1] = (long long)v[1];
  return 0;
}

// Launches K2's kernels for B canvases (one chunk of the wrapper's batch):
// in a mixed launch, given `tables`, the table stage, then the resample
// and the blend, each walking the live tiles of at most its cap of
// placements a launch (V3Grid), so a chunk of more placements launches
// each kernel over consecutive ranges of them: every resample before the
// first blend, since a pixel's blend reads the resampled pixels of every
// placement of its canvas under it. `claims` is the resample's counter,
// two ints that are zero and that no launch on another stream uses at the
// same time; `walks` gets the resample's launches. Pointers are already
// offset to the chunk.
extern "C" int fused_v3_launch(void* plane, const void* objects, const void* meta, void* res,
                               void* tables, int* claims, int B, int Bo, int N, int hp, int wp,
                               int ph, int pw, int mh, int mw, void* stream, int* walks) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *walks = 0;
  const long long bn = (long long)B * N;
  // the compact tap arrays where they fit beside the core (else caps 0: every
  // tile computes its taps where it uses them)
  int cap_h, cap_v;
  v3_tap_caps(ph, pw, &cap_h, &cap_v);
  // an envelope past the objects' padded extent: the launch's growing axes
  // take the exact-argument form (ops/resize.py:build_coeffs_v3)
  const bool mixed = mh > ph || mw > pw;
  if (!mixed) tables = nullptr;
  cudaError_t err;
  if (tables != nullptr) {
    err = (cudaError_t)fused_v3_tables_launch(meta, tables, B, N, ph, pw, mh, mw, stream);
    if (err != cudaSuccess) return (int)err;
  }
  V3Grid g;
  err = v3_grid(N, ph, pw, mh, mw, &g);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((size_t)ph * pw) % 4 == 0 && reinterpret_cast<uintptr_t>(objects) % 4 == 0;
  const auto* obj = static_cast<const uint8_t*>(objects);
  const auto* m = static_cast<const int*>(meta);
  auto* r = static_cast<uchar4*>(res);
  const auto* tab = static_cast<const TapEntry*>(tables);
  const auto resample_kernel = mixed ? v3_resample<true> : v3_resample<false>;
  for (long long p0 = 0; p0 < bn; p0 += g.cap[0]) {
    const int n = (int)(bn - p0 < g.cap[0] ? bn - p0 : g.cap[0]);
    resample_kernel<<<g.blocks(0, n), resample::THREADS, g.base[0] + 4 * (n + 1), s>>>(
        obj, m, r, tab, Bo, N, ph, pw, mh, mw, cap_h, cap_v, vec, (int)p0, n, claims);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++*walks;
  }
  for (long long p0 = 0; p0 < bn; p0 += g.cap[1]) {
    const int n = (int)(bn - p0 < g.cap[1] ? bn - p0 : g.cap[1]);
    box_blend::box_blend_walk<<<g.blocks(1, n), box_blend::THREADS, g.base[1] + 4 * (n + 1), s>>>(
        static_cast<uchar4*>(plane), r, V3Rects{m, mh, mw}, N, hp, wp, mh, mw, (int)p0, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The launches fused_v3_launch makes for B canvases of N placements,
// objects padded to (ph, pw), envelope (mh, mw), on the current device:
// for the resample (out[5 * i], i = 0) and the blend (i = 1), the
// launches, the most placements a launch walks, the blocks of all the
// launches, the resident blocks an SM and the first launch's dynamic
// shared memory. Returns the CUDA error.
extern "C" int fused_v3_grid(int B, int N, int ph, int pw, int mh, int mw, long long* out) {
  V3Grid g;
  const cudaError_t err = v3_grid(N, ph, pw, mh, mw, &g);
  if (err != cudaSuccess) return (int)err;
  const long long bn = (long long)B * N;
  for (int i = 0; i < 2; ++i) {
    long long launches = 0, blocks = 0;
    for (long long p0 = 0; p0 < bn; p0 += g.cap[i], ++launches) {
      blocks += g.blocks(i, (int)(bn - p0 < g.cap[i] ? bn - p0 : g.cap[i]));
    }
    const int first = (int)(bn < g.cap[i] ? bn : g.cap[i]);
    const long long v[5] = {launches, g.cap[i], blocks, g.resident[i], g.base[i] + 4 * (first + 1)};
    for (int j = 0; j < 5; ++j) out[5 * i + j] = v[j];
  }
  return 0;
}
