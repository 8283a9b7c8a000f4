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
// What bounds it on this card: integer multiply-adds of the two resample
// passes, and the f32 table arithmetic (a degree-12 Horner per tap), then
// the plane bytes under the objects. What the design does about it:
// - tap bounds: each block computes, for its 32 output columns (or 8 output
//   rows), each row's window [xmin, xmax) and weight sum, and walks only the
//   union of those windows, not the whole input extent; the 32x32 table
//   tile is built in shared memory per step, never stored in device memory;
// - the f32 table arithmetic uses __fmul_rn / __fadd_rn / __fdiv_rn, which
//   nvcc never contracts into FMAs, and each row's weight sum adds the taps
//   in index order, so the tables equal the plain version's bit for bit;
// - z-order without a sequential grid: Hopper runs blocks in no order and
//   windows of different objects on one canvas overlap. Launch 3 gives
//   each covered plane pixel to one thread, in the block of the LAST
//   object that covers it; that thread walks k = 0..N-1 and blends every
//   object covering the pixel in order;
// - scratch: the wrapper (ops/compose_kernels.py:fused_v3) launches the
//   three kernels over chunks of canvases, so the u8 scratch (tmp, res) is
//   bounded by its budget whatever the batch; at 1080p B=1280 the plane
//   alone is 10.6 GB.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   plane   i32 [B, hp, wp]            packed RGBA, updated in place
//   objects u8  [Bo, N, 4, ph, pw]     planar, Bo == 1 (shared) or B
//   meta    i32 [B, N, 10]             ws_x ws_y dx dy same valid in_h in_w out_h out_w
//   tmp     u8  [B, N, 4, ph, mw]      scratch (H pass, premultiplied)
//   res     u8  [B, N, mh, mw, 4]      scratch (resampled RGBA)
// Sizes are clamped to the envelopes (in to (ph, pw), out to (mh, mw)).

#include <cstdint>
#include <cuda_runtime.h>

#include "pillow.cuh"

namespace {

using pillow::alpha_over;
using pillow::clip8;
using pillow::muldiv255;

constexpr int TILE_X = 32;   // output columns per block (one warp)
constexpr int TILE_Y = 8;    // rows per block
constexpr int TILE_K = 32;   // contraction step staged in shared memory
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int META = 10;

static_assert(TILE_Y * TILE_K == THREADS, "one staged entry per thread");

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

__device__ __forceinline__ bool covers(const Meta& m, int y, int x) {
  return m.valid > 0 && y >= m.y1 && y < m.y1 + m.out_h && x >= m.x1 &&
         x < m.x1 + m.out_w;
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

struct Axis {
  float in_f, scale, support, inv_fs;
};

__device__ __forceinline__ Axis axis_params(int in_size, int out_size) {
  Axis a;
  a.in_f = (float)in_size;
  const float out_f = fmaxf((float)out_size, 1.0f);
  a.scale = __fdiv_rn(a.in_f, out_f);
  const float fs = fmaxf(a.scale, 1.0f);
  a.support = __fmul_rn(3.0f, fs);
  a.inv_fs = __fdiv_rn(1.0f, fs);
  return a;
}

// One output position's window and weight sum. Rows at or past the output
// size are all zero (lo == hi).
struct Row {
  float center, wsum;
  int lo, hi;
};

__device__ __forceinline__ float tap_weight(const Axis& a, float center, int i) {
  return lanczos3(
      __fmul_rn(__fadd_rn(__fsub_rn((float)i, center), 0.5f), a.inv_fs));
}

__device__ Row row_params(const Axis& a, int o, int out_size) {
  Row r;
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
  for (int i = r.lo; i < r.hi; ++i) s = __fadd_rn(s, tap_weight(a, r.center, i));
  r.wsum = s != 0.0f ? s : 1.0f;
  return r;
}

// quantized coefficient of tap i (0 outside the row's window)
__device__ __forceinline__ int coeff(const Axis& a, float center, float wsum,
                                     int lo, int hi, int i) {
  if (i < lo || i >= hi) return 0;
  const float w = __fdiv_rn(tap_weight(a, center, i), wsum);
  const float scaled = __fmul_rn(w, 4194304.0f);  // 2^22
  return (int)truncf(__fadd_rn(scaled, w < 0.0f ? -0.5f : 0.5f));
}

// (1) tmp[b,k,c,y,ox] = clip8(sum_j kh[ox,j] * premul(obj[y,j])[c]).
// Block: 32 output columns x 8 source rows of one (b, k).
// grid (B*N, ceil(mw/32), ceil(ph/8)).
__global__ void __launch_bounds__(THREADS)
v3_hpass(const uint8_t* __restrict__ objects, const int* __restrict__ meta,
         uint8_t* __restrict__ tmp, int Bo, int N, int ph, int pw, int mh,
         int mw) {
  const int bk = blockIdx.x;
  const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
  const int ox0 = blockIdx.y * TILE_X, y0 = blockIdx.z * TILE_Y;
  // uniform per block; rows at or past in_h are never read by the V pass
  if (m.valid <= 0 || m.same > 0 || ox0 >= m.out_w || y0 >= m.in_h) return;
  const int b = bk / N, k = bk - b * N;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  const size_t plane = (size_t)ph * pw;
  const uint8_t* obj = objects + ((size_t)(Bo == 1 ? 0 : b) * N + k) * 4 * plane;

  __shared__ float c_center[TILE_X], c_wsum[TILE_X];
  __shared__ int c_lo[TILE_X], c_hi[TILE_X];
  __shared__ int w_s[TILE_X][TILE_K + 1];  // +1: conflict-free column reads
  __shared__ int4 p_s[TILE_Y][TILE_K];
  __shared__ int s_span[2];

  const Axis ax = axis_params(m.in_w, m.out_w);
  if (ty == 0) {
    const Row r = row_params(ax, ox0 + tx, m.out_w);
    c_center[tx] = r.center;
    c_wsum[tx] = r.wsum;
    c_lo[tx] = r.lo;
    c_hi[tx] = r.hi;
    // union of the live windows of this block's columns
    int lo = r.hi > r.lo ? r.lo : 0x7fffffff, hi = r.hi > r.lo ? r.hi : 0;
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tx == 0) {
      s_span[0] = lo;
      s_span[1] = hi;
    }
  }
  __syncthreads();
  const int jlo = s_span[0], jhi = s_span[1];

  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int j0 = jlo; j0 < jhi; j0 += TILE_K) {
    for (int e = tid; e < TILE_X * TILE_K; e += THREADS) {
      const int r = e / TILE_K, c = e - r * TILE_K;
      w_s[r][c] = coeff(ax, c_center[r], c_wsum[r], c_lo[r], c_hi[r], j0 + c);
    }
    {
      const int r = tid / TILE_K, c = tid - r * TILE_K;
      const int gy = y0 + r, gj = j0 + c;
      int4 p = make_int4(0, 0, 0, 0);
      if (gy < ph && gj < pw) {
        const size_t at = (size_t)gy * pw + gj;
        const int a = obj[3 * plane + at];
        p = make_int4(muldiv255(obj[at], a), muldiv255(obj[plane + at], a),
                      muldiv255(obj[2 * plane + at], a), a);
      }
      p_s[r][c] = p;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < TILE_K; ++jj) {
      const int w = w_s[tx][jj];
      const int4 p = p_s[ty][jj];
      a0 += w * p.x;
      a1 += w * p.y;
      a2 += w * p.z;
      a3 += w * p.w;
    }
    __syncthreads();
  }
  const int ox = ox0 + tx, y = y0 + ty;
  if (ox < mw && y < ph) {
    const size_t tplane = (size_t)ph * mw;
    uint8_t* t = tmp + (size_t)bk * 4 * tplane + (size_t)y * mw + ox;
    t[0] = (uint8_t)clip8(a0);
    t[tplane] = (uint8_t)clip8(a1);
    t[2 * tplane] = (uint8_t)clip8(a2);
    t[3 * tplane] = (uint8_t)clip8(a3);
  }
}

// (2) res[b,k,oy,ox] = unpremul(clip8(sum_i kv[oy,i] * tmp[b,k,:,i,ox])),
// or the object's own pixel when `same` is set.
// Block: 32 output columns x 8 output rows of one (b, k).
// grid (B*N, ceil(mw/32), ceil(mh/8)).
__global__ void __launch_bounds__(THREADS)
v3_vpass(const uint8_t* __restrict__ objects, const int* __restrict__ meta,
         const uint8_t* __restrict__ tmp, uchar4* __restrict__ res, int Bo,
         int N, int ph, int pw, int mh, int mw) {
  const int bk = blockIdx.x;
  const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
  const int ox0 = blockIdx.y * TILE_X, oy0 = blockIdx.z * TILE_Y;
  if (m.valid <= 0 || ox0 >= m.out_w || oy0 >= m.out_h) return;  // uniform
  const int b = bk / N, k = bk - b * N;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  const int ox = ox0 + tx, oy = oy0 + ty;
  const bool live = ox < m.out_w && oy < m.out_h;
  uchar4* out = res + (size_t)bk * mh * mw;

  if (m.same > 0) {  // Pillow's plain copy: out == in
    if (live) {
      const size_t plane = (size_t)ph * pw;
      const uint8_t* obj =
          objects + ((size_t)(Bo == 1 ? 0 : b) * N + k) * 4 * plane;
      uchar4 v = make_uchar4(0, 0, 0, 0);
      if (oy < ph && ox < pw) {
        const size_t at = (size_t)oy * pw + ox;
        v = make_uchar4(obj[at], obj[plane + at], obj[2 * plane + at],
                        obj[3 * plane + at]);
      }
      out[(size_t)oy * mw + ox] = v;
    }
    return;
  }

  __shared__ float r_center[TILE_Y], r_wsum[TILE_Y];
  __shared__ int r_lo[TILE_Y], r_hi[TILE_Y];
  __shared__ int w_s[TILE_Y][TILE_K];
  __shared__ int t_s[4][TILE_K][TILE_X];
  __shared__ int s_span[2];

  const Axis ax = axis_params(m.in_h, m.out_h);
  if (ty == 0) {
    Row r;
    r.lo = r.hi = 0;
    if (tx < TILE_Y) {
      r = row_params(ax, oy0 + tx, m.out_h);
      r_center[tx] = r.center;
      r_wsum[tx] = r.wsum;
      r_lo[tx] = r.lo;
      r_hi[tx] = r.hi;
    }
    int lo = r.hi > r.lo ? r.lo : 0x7fffffff, hi = r.hi > r.lo ? r.hi : 0;
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tx == 0) {
      s_span[0] = lo;
      s_span[1] = hi;
    }
  }
  __syncthreads();
  const int ilo = s_span[0], ihi = s_span[1];

  const size_t tplane = (size_t)ph * mw;
  const uint8_t* tp = tmp + (size_t)bk * 4 * tplane;
  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int i0 = ilo; i0 < ihi; i0 += TILE_K) {
    {
      const int r = tid / TILE_K, c = tid - r * TILE_K;
      w_s[r][c] = coeff(ax, r_center[r], r_wsum[r], r_lo[r], r_hi[r], i0 + c);
    }
    for (int e = tid; e < 4 * TILE_K * TILE_X; e += THREADS) {
      const int ch = e / (TILE_K * TILE_X);
      const int rem = e - ch * (TILE_K * TILE_X);
      const int r = rem / TILE_X, c = rem - r * TILE_X;
      const int gi = i0 + r, gox = ox0 + c;
      // rows past the union carry zero coefficients; reading them is safe
      t_s[ch][r][c] = (gi < ph && gox < mw) ? tp[ch * tplane + (size_t)gi * mw + gox] : 0;
    }
    __syncthreads();
#pragma unroll 8
    for (int ii = 0; ii < TILE_K; ++ii) {
      const int w = w_s[ty][ii];
      a0 += w * t_s[0][ii][tx];
      a1 += w * t_s[1][ii][tx];
      a2 += w * t_s[2][ii][tx];
      a3 += w * t_s[3][ii][tx];
    }
    __syncthreads();
  }
  if (live) {
    out[(size_t)oy * mw + ox] =
        pillow::unpremultiply(clip8(a0), clip8(a1), clip8(a2), clip8(a3));
  }
}

// (3) alpha-over in z-order. Block: 32 x 8 pixels of object k's box on
// canvas b; a pixel is handled here only when no later object covers it.
// grid (B*N, ceil(mw/32), ceil(mh/8)).
__global__ void __launch_bounds__(THREADS)
v3_blend(int* __restrict__ plane, const int* __restrict__ meta,
         const uchar4* __restrict__ res, int N, int hp, int wp, int ph,
         int pw, int mh, int mw) {
  const int bk = blockIdx.x;
  const Meta m = load_meta(meta, bk, ph, pw, mh, mw);
  const int c = blockIdx.y * TILE_X + threadIdx.x;
  const int r = blockIdx.z * TILE_Y + threadIdx.y;
  if (m.valid <= 0 || c >= m.out_w || r >= m.out_h) return;
  const int x = m.x1 + c, y = m.y1 + r;
  if (x < 0 || y < 0 || x >= wp || y >= hp) return;  // cut at the plane edge
  const int b = bk / N, k = bk - b * N;
  for (int k2 = k + 1; k2 < N; ++k2) {
    if (covers(load_meta(meta, b * N + k2, ph, pw, mh, mw), y, x)) return;
  }
  uchar4* px = reinterpret_cast<uchar4*>(plane) + ((size_t)b * hp + y) * wp + x;
  uchar4 d = *px;
  for (int k2 = 0; k2 <= k; ++k2) {
    const Meta m2 = load_meta(meta, b * N + k2, ph, pw, mh, mw);
    if (!covers(m2, y, x)) continue;
    d = alpha_over(d, res[((size_t)(b * N + k2) * mh + (y - m2.y1)) * mw + (x - m2.x1)]);
  }
  *px = d;
}

}  // namespace

// Launches the three kernels for B canvases (one chunk of the wrapper's
// batch); pointers are already offset to the chunk.
extern "C" int fused_v3_launch(void* plane, const void* objects,
                               const void* meta, void* tmp, void* res, int B,
                               int Bo, int N, int hp, int wp, int ph, int pw,
                               int mh, int mw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(TILE_X, TILE_Y);
  const unsigned bn = (unsigned)B * (unsigned)N;
  const unsigned tiles_x = (unsigned)((mw + TILE_X - 1) / TILE_X);
  v3_hpass<<<dim3(bn, tiles_x, (ph + TILE_Y - 1) / TILE_Y), block, 0, s>>>(
      static_cast<const uint8_t*>(objects), static_cast<const int*>(meta),
      static_cast<uint8_t*>(tmp), Bo, N, ph, pw, mh, mw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_out(bn, tiles_x, (mh + TILE_Y - 1) / TILE_Y);
  v3_vpass<<<grid_out, block, 0, s>>>(
      static_cast<const uint8_t*>(objects), static_cast<const int*>(meta),
      static_cast<const uint8_t*>(tmp), static_cast<uchar4*>(res), Bo, N, ph,
      pw, mh, mw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  v3_blend<<<grid_out, block, 0, s>>>(
      static_cast<int*>(plane), static_cast<const int*>(meta),
      static_cast<const uchar4*>(res), N, hp, wp, ph, pw, mh, mw);
  return (int)cudaGetLastError();
}
