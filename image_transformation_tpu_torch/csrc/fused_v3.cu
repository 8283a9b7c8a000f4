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
// design does about it, in two launches:
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
  __device__ bool prepare(resample::TileWindows& w, int ox0, int oy0, int out_w, int out_h,
                          int* coef_h, int* coef_v, int cap_h, int cap_v) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (warp < 2) {  // warp 0: the tile's columns, warp 1: its rows
      const Row r = warp == 0 ? row_params<MIXED>(axh, ox0 + lane, out_w)
                              : row_params<MIXED>(axv, oy0 + lane, out_h);
      center[warp * resample::TX + lane] = r.center;
      wsum[warp * resample::TX + lane] = r.wsum;
      resample::set_window(w, warp, lane, r.lo, r.hi);
    }
    __syncthreads();
    if (w.total[0] > cap_h || w.total[1] > cap_v) return false;
    // the quantized taps, one window per warp at a time, lanes over taps
    for (int e = warp; e < resample::TX + resample::TY; e += resample::WARPS) {
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
template <bool MIXED>
__device__ __forceinline__ void resample_placement_tile(
    const resample::PlanarSrc& src, uchar4* out, const Meta& m, int ox0, int oy0, int mw,
    int cap_h, int cap_v, resample::TileWindows& win, float* center, float* wsum) {
  extern __shared__ uint32_t smem[];
  int* coef = reinterpret_cast<int*>(smem + resample::TILE_SMEM_BYTES / 4);
  const V3Taps<MIXED> taps{axis_params<MIXED>(m.in_w, m.out_w),
                           axis_params<MIXED>(m.in_h, m.out_h), center, wsum};
  const bool staged =
      taps.prepare(win, ox0, oy0, m.out_w, m.out_h, coef, coef + cap_h, cap_h, cap_v);
  __syncthreads();
  if (staged) {
    resample::resample_tile(src, resample::SharedTaps{coef, coef + cap_h, &win}, win, smem, out,
                            mw, m.out_h, m.out_w, ox0, oy0);
  } else {
    resample::resample_tile(src, taps, win, smem, out, mw, m.out_h, m.out_w, ox0, oy0);
  }
}

// (1) grid (B*N, ceil(mw/TX), ceil(mh/TY)): one tile of one placement,
// resampled into res (or the object's own pixels where `same` is set); with
// MIXED the growing axes' tables take the exact-argument form.
template <bool MIXED>
__global__ void __launch_bounds__(resample::THREADS, 3)
v3_resample(const uint8_t* __restrict__ objects, const int* __restrict__ meta,
            uchar4* __restrict__ res, int Bo, int N, int ph, int pw, int mh, int mw,
            int cap_h, int cap_v, int vec) {
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
  resample_placement_tile<MIXED>(src, out, m, ox0, oy0, mw, cap_h, cap_v, win, center, wsum);
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

// Launches K2's two kernels for B canvases (one chunk of the wrapper's
// batch); pointers are already offset to the chunk.
extern "C" int fused_v3_launch(void* plane, const void* objects, const void* meta, void* res,
                               int B, int Bo, int N, int hp, int wp, int ph, int pw, int mh,
                               int mw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned bn = (unsigned)B * (unsigned)N;
  // the compact tap arrays where they fit beside the core (else caps 0: every
  // tile computes its taps where it uses them)
  int cap_h, cap_v;
  const int smem = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  // an envelope past the objects' padded extent: the launch's growing axes
  // take the exact-argument form (ops/resize.py:build_coeffs_v3)
  const bool mixed = mh > ph || mw > pw;
  const auto kernel = mixed ? v3_resample<true> : v3_resample<false>;
  cudaError_t err = mixed ? resample::allow_smem<1>(kernel, smem)
                          : resample::allow_smem<0>(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = ((size_t)ph * pw) % 4 == 0 && reinterpret_cast<uintptr_t>(objects) % 4 == 0;
  const dim3 grid_r(bn, (mw + resample::TX - 1) / resample::TX,
                    (mh + resample::TY - 1) / resample::TY);
  kernel<<<grid_r, resample::THREADS, smem, s>>>(
      static_cast<const uint8_t*>(objects), static_cast<const int*>(meta),
      static_cast<uchar4*>(res), Bo, N, ph, pw, mh, mw, cap_h, cap_v, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_b(bn, (mw + box_blend::TILE - 1) / box_blend::TILE,
                    (mh + box_blend::TILE - 1) / box_blend::TILE);
  box_blend::box_blend_kernel<<<grid_b, box_blend::THREADS, box_blend::smem_bytes(N), s>>>(
      static_cast<uchar4*>(plane), static_cast<const uchar4*>(res),
      V3Rects{static_cast<const int*>(meta), mh, mw}, N, hp, wp, mh, mw);
  return (int)cudaGetLastError();
}

// dynamic shared memory of each of K2's two launches, for objects padded
// to (ph, pw) and N per canvas
extern "C" int fused_v3_smem(int ph, int pw, int N, int* out) {
  int cap_h, cap_v;
  out[0] = resample::tap_caps(ph, pw, &cap_h, &cap_v);
  out[1] = box_blend::smem_bytes(N);
  return 0;
}
