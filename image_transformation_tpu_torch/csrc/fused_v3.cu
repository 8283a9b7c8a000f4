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
// - resample (csrc/resample.cuh), one block per placement and 32x32 output
//   tile: each block builds its 32 columns' and 32 rows' windows, weight
//   sums and quantized taps once, into compact [rows][taps] arrays in
//   shared memory (each tap's coefficient is computed once per tile; where
//   objects are padded so large that the arrays do not fit beside the
//   core, ph + pw > 7,456, each tap is computed where it is used
//   instead, slower but with no size limit); each
//   output column and row then walks only its own window; the
//   source patch is staged premultiplied in shared memory, four pixels of
//   the four planes (16 bytes) per thread, and the H result stays in shared
//   memory, so there is no scratch in device memory between the passes;
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
// - blend (csrc/box_blend.cuh): over each placement's box only, z-order by
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

// The tables and the resample of one tile of a placement that is neither
// dropped nor a plain copy; `win`, `center` and `wsum` in shared memory.
// `entries` is the placement's table-stage entries (columns, then rows, at
// ceil_tile(mw)), null where the launch has none.
template <bool MIXED>
__device__ __forceinline__ void resample_placement_tile(
    const resample::PlanarSrc& src, uchar4* out, const Meta& m, int ox0, int oy0, int mw,
    int cap_h, int cap_v, resample::TileWindows& win, float* center, float* wsum,
    const TapEntry* entries) {
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
    resample::resample_tile(src, resample::SharedTaps{coef, coef + cap_h, &win}, win, smem, out,
                            mw, m.out_h, m.out_w, ox0, oy0);
  } else {
    resample::resample_tile(src, taps, win, smem, out, mw, m.out_h, m.out_w, ox0, oy0);
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

// (1) grid (B*N, ceil(mw/TX), ceil(mh/TY)): one tile of one placement,
// resampled into res (or the object's own pixels where `same` is set); with
// MIXED the growing axes' tables take the exact-argument form, loaded from
// `tables` (the stage's buffer) where it is not null.
template <bool MIXED>
__global__ void __launch_bounds__(resample::THREADS, 3)
v3_resample(const uint8_t* __restrict__ objects, const int* __restrict__ meta,
            uchar4* __restrict__ res, const TapEntry* __restrict__ tables, int Bo, int N, int ph,
            int pw, int mh, int mw, int cap_h, int cap_v, int vec) {
  const int bk = blockIdx.x;
  const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
  const int ox0 = blockIdx.y * resample::TX, oy0 = blockIdx.z * resample::TY;
  if (m.valid <= 0 || ox0 >= m.out_w || oy0 >= m.out_h) return;  // uniform
  const int b = bk / N, k = bk - b * N;
  const size_t plane = (size_t)ph * pw;
  const resample::PlanarSrc src{objects, ((size_t)(Bo == 1 ? 0 : b) * N + k) * 4 * plane,
                                plane, pw, vec != 0};
  uchar4* out = res + (size_t)bk * mh * mw;
  if (m.same > 0) {  // Pillow's plain copy: out == in
    resample::copy_tile(src, out, mw, ph, pw, m.out_h, m.out_w, ox0, oy0);
    return;
  }
  __shared__ resample::TileWindows win;
  __shared__ float center[resample::TX + resample::TY], wsum[resample::TX + resample::TY];
  const TapEntry* entries =
      MIXED && tables != nullptr
          ? tables + (size_t)bk * (ceil_tile(mw) + ceil_tile(mh))
          : nullptr;
  resample_placement_tile<MIXED>(src, out, m, ox0, oy0, mw, cap_h, cap_v, win, center, wsum,
                                 entries);
}

// K2's placement rectangles, from the meta: the box at its origin, 0 when
// the placement is not valid.
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

}  // namespace

static_assert(resample::TX == resample::TY, "one tile rounding for both axes");

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

// Launches K2's kernels for B canvases (one chunk of the wrapper's batch):
// in a mixed launch, given `tables`, the table stage, then the resample and
// the blend; pointers are already offset to the chunk.
extern "C" int fused_v3_launch(void* plane, const void* objects, const void* meta, void* res,
                               void* tables, int B, int Bo, int N, int hp, int wp, int ph,
                               int pw, int mh, int mw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bn = (unsigned)B * (unsigned)N;
  // the compact tap arrays where they fit beside the core (else caps 0: every
  // tile computes its taps where it uses them)
  int cap_h, cap_v;
  const int smem = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  // an envelope past the objects' padded extent: the launch's growing axes
  // take the exact-argument form (ops/resize.py:build_coeffs_v3)
  const bool mixed = mh > ph || mw > pw;
  if (!mixed) tables = nullptr;
  cudaError_t err;
  if (tables != nullptr) {
    err = (cudaError_t)fused_v3_tables_launch(meta, tables, B, N, ph, pw, mh, mw, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const auto kernel = mixed ? v3_resample<true> : v3_resample<false>;
  err = mixed ? resample::allow_smem<1>(kernel, smem) : resample::allow_smem<0>(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((size_t)ph * pw) % 4 == 0 && reinterpret_cast<uintptr_t>(objects) % 4 == 0;
  const dim3 grid_r(bn, (mw + resample::TX - 1) / resample::TX,
                    (mh + resample::TY - 1) / resample::TY);
  kernel<<<grid_r, resample::THREADS, smem, s>>>(
      static_cast<const uint8_t*>(objects), static_cast<const int*>(meta),
      static_cast<uchar4*>(res), static_cast<const TapEntry*>(tables), Bo, N, ph, pw, mh, mw,
      cap_h, cap_v, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b(bn, (mw + box_blend::TILE - 1) / box_blend::TILE,
                    (mh + box_blend::TILE - 1) / box_blend::TILE);
  box_blend::box_blend_kernel<<<grid_b, box_blend::THREADS, box_blend::smem_bytes(N), s>>>(
      static_cast<uchar4*>(plane), static_cast<const uchar4*>(res),
      V3Rects{static_cast<const int*>(meta), mh, mw}, N, hp, wp, mh, mw);
  return (int)cudaGetLastError();
}

// dynamic shared memory of K2's resample and blend launches, for objects
// padded to (ph, pw) and N per canvas (the table stage takes none)
extern "C" int fused_v3_smem(int ph, int pw, int N, int* out) {
  int cap_h, cap_v;
  out[0] = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  out[1] = box_blend::smem_bytes(N);
  return 0;
}
