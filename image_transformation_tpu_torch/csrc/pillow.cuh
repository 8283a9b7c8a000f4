// Pillow's 8-bit integer arithmetic, shared by the port's kernels.
//
// Resample.c (PRECISION_BITS = 22): clip8 of an int32 accumulator;
// Unpack.c / Pack.c: the MULDIV255 premultiply and the unpremultiply;
// AlphaComposite.c (PRECISION_BITS = 7): alpha-over of one RGBA pixel.
// Bit-exact counterparts of ops/resize.py and ops/compose.py.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace pillow {

constexpr int PRECISION_BITS = 22;
constexpr int HALF = 1 << (PRECISION_BITS - 1);

__device__ __forceinline__ int clip8(int ss) {
  const int v = (ss + HALF) >> PRECISION_BITS;  // arithmetic shift, as Pillow
  return v < 0 ? 0 : (v > 255 ? 255 : v);
}

// round(c * a / 255), Pillow's premultiply
__device__ __forceinline__ int muldiv255(int c, int a) {
  const int t = c * a + 128;
  return ((t >> 8) + t) >> 8;
}

// RGBa -> RGBA: min(255, floor(255 * c / a)); c passes through at a == 0
__device__ __forceinline__ uchar4 unpremultiply(int r, int g, int b, int a) {
  if (a != 0) {
    r = min(255, (255 * r) / a);
    g = min(255, (255 * g) / a);
    b = min(255, (255 * b) / a);
  }
  return make_uchar4(r, g, b, a);
}

__device__ __forceinline__ unsigned shift_div255(unsigned v) {
  return ((v >> 8) + v) >> 8;
}

// Pillow ImagingAlphaComposite for one pixel (src over dst).
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

}  // namespace pillow
