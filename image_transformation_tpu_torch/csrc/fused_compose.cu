// K1: fused exact resize + alpha-over for Hopper (sm_90a).
//
// Replaces the TPU kernel image_transformation_tpu/ops/compose_pallas.py:
// _make_fused_kernel_v2 (launched by _pallas_fused_v2_impl). For each
// canvas b and each object k, in list order (z-order):
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
// What bounds it on this card: integer multiply-adds over the DENSE
// coefficient tables (4*ph*mw*pw + 4*mh*mw*ph per object: every tap of
// every row, zero or not), then the canvas bytes of the blend (one read and
// one write of every canvas pixel).
// What the design does about it: the two resample passes stage 32x32 tiles
// of the table and of the source through shared memory, so each table entry
// and each source pixel is read from device memory once per 32x8 output
// tile; identity and dropped objects skip both passes; the blend reads and
// writes each canvas pixel once and walks the objects in z-order in
// registers. Hopper runs blocks in no order, so z-order comes from that
// per-pixel loop, not from the grid. The resampled objects go through u8
// scratch in device memory between three launches; tap bounds instead of
// dense rows, and one fused launch, are later work.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   canvas  u8  [B, H, W, 4]      updated in place
//   objects u8  [Bo, N, ph, pw, 4]  Bo == 1 (shared by all canvases) or B
//   kh      i32 [B, N, mw, pw]
//   kv      i32 [B, N, mh, ph]
//   boxes   i32 [B, N, 4]         (x1, y1, x2, y2); only the origin is read
//   flags   u8  [B, N]            bit 0 live, bit 1 identity
//   tmp     u8  [B, N, 4, ph, mw] scratch (horizontal pass, premultiplied)
//   res     u8  [B, N, mh, mw, 4] scratch (resampled RGBA)

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TILE_X = 32;   // output columns per block (one warp)
constexpr int TILE_Y = 8;    // output rows per block
constexpr int TILE_K = 32;   // contraction step staged in shared memory
constexpr int THREADS = TILE_X * TILE_Y;
constexpr int PRECISION_BITS = 22;
constexpr int HALF = 1 << (PRECISION_BITS - 1);
constexpr uint8_t FLAG_LIVE = 1;
constexpr uint8_t FLAG_IDENTITY = 2;
constexpr int BLEND_THREADS = 256;

static_assert(TILE_Y * TILE_K == THREADS, "one staged source pixel per thread");

__device__ __forceinline__ int clip8(int ss) {
  const int v = (ss + HALF) >> PRECISION_BITS;  // arithmetic shift, as Pillow
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

__device__ __forceinline__ int muldiv255(int c, int a) {
  const int t = c * a + 128;
  return ((t >> 8) + t) >> 8;
}

__device__ __forceinline__ unsigned shift_div255(unsigned v) {
  return ((v >> 8) + v) >> 8;
}

// Pillow ImagingAlphaComposite for one pixel.
__device__ __forceinline__ uchar4 alpha_over(uchar4 d, uchar4 s) {
  const unsigned sa = s.w;
  if (sa == 0) return d;
  const unsigned blend = d.w * (255u - sa);
  const unsigned outa255 = sa * 255u + blend;
  const unsigned coef1 = (sa * 255u * 255u * 128u) / outa255;
  const unsigned coef2 = 255u * 128u - coef1;
  const unsigned bias = 0x80u << 7;
  uchar4 o;
  o.x = (unsigned char)(shift_div255(s.x * coef1 + d.x * coef2 + bias) >> 7);
  o.y = (unsigned char)(shift_div255(s.y * coef1 + d.y * coef2 + bias) >> 7);
  o.z = (unsigned char)(shift_div255(s.z * coef1 + d.z * coef2 + bias) >> 7);
  o.w = (unsigned char)shift_div255(outa255 + 0x80u);
  return o;
}

// (a) tmp[b,k,c,y,ox] = clip8(sum_j kh[b,k,ox,j] * premul(obj[y,j])[c]).
// Block: 32 output columns x 8 source rows of one (b, k); grid.z = B*N.
__global__ void __launch_bounds__(THREADS)
hpass_kernel(const uchar4* __restrict__ objects, const int* __restrict__ kh,
             const uint8_t* __restrict__ flags, uint8_t* __restrict__ tmp,
             int Bo, int N, int ph, int pw, int mw) {
  const int bk = blockIdx.z;
  const uint8_t f = flags[bk];
  if (!(f & FLAG_LIVE) || (f & FLAG_IDENTITY)) return;  // uniform per block
  const int b = bk / N, k = bk - b * N;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  const int ox0 = blockIdx.x * TILE_X, y0 = blockIdx.y * TILE_Y;
  const uchar4* obj = objects + ((size_t)(Bo == 1 ? 0 : b) * N + k) * ph * pw;
  const int* khp = kh + (size_t)bk * mw * pw;

  __shared__ int w_s[TILE_X][TILE_K + 1];  // +1: conflict-free column reads
  __shared__ int4 p_s[TILE_Y][TILE_K];

  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int j0 = 0; j0 < pw; j0 += TILE_K) {
    for (int e = tid; e < TILE_X * TILE_K; e += THREADS) {
      const int r = e / TILE_K, c = e - r * TILE_K;
      const int gox = ox0 + r, gj = j0 + c;
      w_s[r][c] = (gox < mw && gj < pw) ? khp[(size_t)gox * pw + gj] : 0;
    }
    {
      const int r = tid / TILE_K, c = tid - r * TILE_K;
      const int gy = y0 + r, gj = j0 + c;
      int4 p = make_int4(0, 0, 0, 0);
      if (gy < ph && gj < pw) {
        const uchar4 v = obj[(size_t)gy * pw + gj];
        p = make_int4(muldiv255(v.x, v.w), muldiv255(v.y, v.w),
                      muldiv255(v.z, v.w), v.w);
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
    const size_t plane = (size_t)ph * mw;
    uint8_t* t = tmp + (size_t)bk * 4 * plane + (size_t)y * mw + ox;
    t[0] = (uint8_t)clip8(a0);
    t[plane] = (uint8_t)clip8(a1);
    t[2 * plane] = (uint8_t)clip8(a2);
    t[3 * plane] = (uint8_t)clip8(a3);
  }
}

// (b) res[b,k,oy,ox] = unpremul(clip8(sum_i kv[b,k,oy,i] * tmp[b,k,:,i,ox])),
// or the raw object pixel for identity objects.
// Block: 32 output columns x 8 output rows of one (b, k); grid.z = B*N.
__global__ void __launch_bounds__(THREADS)
vpass_kernel(const uchar4* __restrict__ objects, const int* __restrict__ kv,
             const uint8_t* __restrict__ flags, const uint8_t* __restrict__ tmp,
             uchar4* __restrict__ res, int Bo, int N, int ph, int pw, int mh,
             int mw) {
  const int bk = blockIdx.z;
  const uint8_t f = flags[bk];
  if (!(f & FLAG_LIVE)) return;  // uniform per block
  const int b = bk / N, k = bk - b * N;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * TILE_X + tx;
  const int ox0 = blockIdx.x * TILE_X, oy0 = blockIdx.y * TILE_Y;
  const int ox = ox0 + tx, oy = oy0 + ty;
  uchar4* out = res + (size_t)bk * mh * mw;

  if (f & FLAG_IDENTITY) {  // Pillow's plain copy of the (padded) object
    if (ox < mw && oy < mh) {
      uchar4 v = make_uchar4(0, 0, 0, 0);
      if (oy < ph && ox < pw) {
        v = objects[((size_t)(Bo == 1 ? 0 : b) * N + k) * ph * pw +
                    (size_t)oy * pw + ox];
      }
      out[(size_t)oy * mw + ox] = v;
    }
    return;
  }

  const int* kvp = kv + (size_t)bk * mh * ph;
  const uint8_t* tp = tmp + (size_t)bk * 4 * ph * mw;
  __shared__ int w_s[TILE_Y][TILE_K];
  __shared__ int t_s[4][TILE_K][TILE_X];

  int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int i0 = 0; i0 < ph; i0 += TILE_K) {
    {
      const int r = tid / TILE_K, c = tid - r * TILE_K;
      const int goy = oy0 + r, gi = i0 + c;
      w_s[r][c] = (goy < mh && gi < ph) ? kvp[(size_t)goy * ph + gi] : 0;
    }
    for (int e = tid; e < 4 * TILE_K * TILE_X; e += THREADS) {
      const int ch = e / (TILE_K * TILE_X);
      const int rem = e - ch * (TILE_K * TILE_X);
      const int r = rem / TILE_X, c = rem - r * TILE_X;
      const int gi = i0 + r, gox = ox0 + c;
      t_s[ch][r][c] =
          (gi < ph && gox < mw) ? tp[((size_t)ch * ph + gi) * mw + gox] : 0;
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
  if (ox < mw && oy < mh) {
    int r = clip8(a0), g = clip8(a1), bl = clip8(a2);
    const int a = clip8(a3);
    if (a != 0) {
      r = min(255, (255 * r) / a);
      g = min(255, (255 * g) / a);
      bl = min(255, (255 * bl) / a);
    }
    out[(size_t)oy * mw + ox] = make_uchar4(r, g, bl, a);
  }
}

// (c) one thread per canvas pixel: alpha-over every live object covering it,
// k = 0..N-1 in order.
__global__ void __launch_bounds__(BLEND_THREADS)
blend_kernel(uchar4* __restrict__ canvas, const uchar4* __restrict__ res,
             const int* __restrict__ boxes, const uint8_t* __restrict__ flags,
             int B, int N, int H, int W, int mh, int mw) {
  const size_t idx = (size_t)blockIdx.x * BLEND_THREADS + threadIdx.x;
  if (idx >= (size_t)B * H * W) return;
  const int x = (int)(idx % W);
  const size_t row = idx / W;
  const int y = (int)(row % H);
  const int b = (int)(row / H);
  uchar4 d = canvas[idx];
  bool touched = false;
  for (int k = 0; k < N; ++k) {
    const int bk = b * N + k;
    if (!(flags[bk] & FLAG_LIVE)) continue;
    const int x1 = boxes[4 * bk], y1 = boxes[4 * bk + 1];
    if (x1 < 0 || y1 < 0 || x1 >= W || y1 >= H) continue;  // dropped
    const int dx = x - x1, dy = y - y1;
    if (dx < 0 || dy < 0 || dx >= mw || dy >= mh) continue;
    d = alpha_over(d, res[((size_t)bk * mh + dy) * mw + dx]);
    touched = true;
  }
  if (touched) canvas[idx] = d;
}

}  // namespace

extern "C" int fused_compose_launch(void* canvas, const void* objects,
                                    const void* kh, const void* kv,
                                    const void* boxes, const void* flags,
                                    void* tmp, void* res, int B, int Bo, int N,
                                    int H, int W, int ph, int pw, int mh,
                                    int mw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(TILE_X, TILE_Y);
  const dim3 grid_h((mw + TILE_X - 1) / TILE_X, (ph + TILE_Y - 1) / TILE_Y,
                    B * N);
  hpass_kernel<<<grid_h, block, 0, s>>>(
      static_cast<const uchar4*>(objects), static_cast<const int*>(kh),
      static_cast<const uint8_t*>(flags), static_cast<uint8_t*>(tmp), Bo, N,
      ph, pw, mw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_v((mw + TILE_X - 1) / TILE_X, (mh + TILE_Y - 1) / TILE_Y,
                    B * N);
  vpass_kernel<<<grid_v, block, 0, s>>>(
      static_cast<const uchar4*>(objects), static_cast<const int*>(kv),
      static_cast<const uint8_t*>(flags), static_cast<const uint8_t*>(tmp),
      static_cast<uchar4*>(res), Bo, N, ph, pw, mh, mw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t pixels = (size_t)B * H * W;
  const unsigned blocks =
      (unsigned)((pixels + BLEND_THREADS - 1) / BLEND_THREADS);
  blend_kernel<<<blocks, BLEND_THREADS, 0, s>>>(
      static_cast<uchar4*>(canvas), static_cast<const uchar4*>(res),
      static_cast<const int*>(boxes), static_cast<const uint8_t*>(flags), B, N,
      H, W, mh, mw);
  return (int)cudaGetLastError();
}
