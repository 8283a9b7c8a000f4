// The run statistic: each canvas's mean Rec.709 luminance of a packed crop.
//
// Replaces no TPU kernel: the JAX package computes this statistic as a
// plain jnp.mean of a per-pixel luminance (packed_luma in
// image_transformation_tpu/ops/compose_pallas.py:2109) and leaves the
// reduction to XLA. It was added because the port's PyTorch form took two
// passes: a float16 copy of the crop's RGB bytes, then a reduction of the
// copy.
//
// What bounds it on this card: the bytes, one read of the crop (at 1080 x
// 1920 B=256, 2.12 GB: 0.634 ms at 3.35 TB/s). Its integer work is ~5
// instructions a pixel. What the design does about it:
// - grid: one block per (canvas, band of rows; 32 rows from the wrapper,
//   ops/compose_kernels.py:_LUMA_BAND_ROWS), so each block's
//   partial belongs to one canvas and nothing is carried between blocks.
//   Chosen over a persistent grid: at 1080 x 1920 B=256 it is 15,360
//   blocks, ~29 waves at 4 blocks an SM, so the last wave's imbalance is a
//   few percent, and the bands need no work queue;
// - a warp reads a row at a time: each lane issues UNROLL 16-byte loads
//   (ld.global.cs, evict-first: nothing rereads the plane before the next
//   render rewrites its windows) before it uses the first, ~4 KB a warp in
//   flight. A row whose start is not 16-byte aligned, or whose width is
//   not a multiple of 4, reads its head and tail words one by one;
// - exact integer sums, independent of order: a word's R and B bytes
//   (w & 0x00FF00FF), and its G and A bytes ((w >> 8) & 0x00FF00FF),
//   accumulate in 16-bit halves, flushed to 32-bit sums after each round
//   of loads (at most 34 words, 8,670 a half, before a flush); each row's
//   sums go to 64 bits, then warp shuffles and shared memory give the
//   block's three channel sums. An 8K canvas's channel sum, 33.2 M x 255,
//   passes 2^32 (a 4K canvas's reaches 98.5% of 2^31);
// - a second launch, one warp per canvas, adds its bands' partials and
//   computes (wr Sr + wg Sg + wb Sb) / (H W) in float64 with rounded
//   operations (no fused multiply-add), then rounds it to float32: the
//   plain version in ops/compose_kernels.py does the same operations.
//
// Interface (see ops/compose_kernels.py:packed_luma):
//   crop  i32 [B, H, W]       packed RGBA, last stride 1, any batch and row
//                             strides (in elements), 4-byte aligned
//   part  u64 [B, bands, 3]   scratch: each band's R, G and B sums
//   out   f32 [B]             the means

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 8;  // 16-byte loads a lane has in flight
constexpr unsigned PAIRS = 0x00FF00FFu;

__device__ __forceinline__ void add_word(unsigned w, unsigned& rb, unsigned& ga) {
  rb += w & PAIRS;         // R in bits 0-15, B in bits 16-31
  ga += (w >> 8) & PAIRS;  // G in bits 0-15 (A above it, unused)
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
luma_bands_kernel(const int* __restrict__ crop, long long sb, long long sh, int H, int W,
                  int bands, unsigned long long* __restrict__ part) {
  __shared__ unsigned long long s_sum[WARPS][3];
  const int b = blockIdx.x / bands, band = blockIdx.x - b * bands;
  const int per = (H + bands - 1) / bands;
  const int y1 = min(H, (band + 1) * per);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long sr = 0, sg = 0, sbl = 0;
  for (int y = band * per + warp; y < y1; y += WARPS) {
    const int* row = crop + b * sb + y * sh;
    // words before the first 16-byte boundary, then whole int4s, then the rest
    const int head = min(W, (int)((0u - (unsigned)(reinterpret_cast<uintptr_t>(row) >> 2)) & 3u));
    const int nv = (W - head) >> 2, tail = (W - head) & 3;
    unsigned rb = 0, ga = 0, r = 0, g = 0, bl = 0;
    if (lane < head) add_word((unsigned)__ldcs(row + lane), rb, ga);
    if (lane < tail) add_word((unsigned)__ldcs(row + head + 4 * nv + lane), rb, ga);
    const int4* vec = reinterpret_cast<const int4*>(row + head);
    for (int c = lane; c < nv; c += 32 * UNROLL) {
      int4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = c + 32 * u < nv ? __ldcs(vec + c + 32 * u) : make_int4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        add_word((unsigned)v[u].x, rb, ga);
        add_word((unsigned)v[u].y, rb, ga);
        add_word((unsigned)v[u].z, rb, ga);
        add_word((unsigned)v[u].w, rb, ga);
      }
      r += rb & 0xFFFFu;
      bl += rb >> 16;
      g += ga & 0xFFFFu;
      rb = ga = 0;
    }
    sr += r + (rb & 0xFFFFu);  // the head and tail, where no int4 round ran
    sbl += bl + (rb >> 16);
    sg += g + (ga & 0xFFFFu);
  }
  sr = warp_sum(sr);
  sg = warp_sum(sg);
  sbl = warp_sum(sbl);
  if (lane == 0) {
    s_sum[warp][0] = sr;
    s_sum[warp][1] = sg;
    s_sum[warp][2] = sbl;
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned long long t = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) t += s_sum[w][threadIdx.x];
    part[3 * (size_t)blockIdx.x + threadIdx.x] = t;
  }
}

__global__ void __launch_bounds__(THREADS)
luma_finish_kernel(const unsigned long long* __restrict__ part, int B, int bands, double n,
                   double wr, double wg, double wb, float* __restrict__ out) {
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (b >= B) return;  // b is the same across a warp
  const unsigned long long* p = part + 3 * (size_t)b * bands;
  unsigned long long r = 0, g = 0, bl = 0;
  for (int i = lane; i < bands; i += 32) {
    r += p[3 * i];
    g += p[3 * i + 1];
    bl += p[3 * i + 2];
  }
  r = warp_sum(r);
  g = warp_sum(g);
  bl = warp_sum(bl);
  if (lane == 0) {
    const double lum = __dadd_rn(__dadd_rn(__dmul_rn(wr, __ull2double_rn(r)),
                                           __dmul_rn(wg, __ull2double_rn(g))),
                                 __dmul_rn(wb, __ull2double_rn(bl)));
    out[b] = __double2float_rn(__ddiv_rn(lum, n));
  }
}

}  // namespace

// sb, sh: the crop's batch and row strides in elements; bands: the row
// bands a canvas is cut into (part holds B * bands * 3 sums); n: H * W, or
// 1 for an empty canvas
extern "C" int packed_luma_launch(const void* crop, void* part, void* out, int B, int H, int W,
                                  long long sb, long long sh, int bands, double n, double wr,
                                  double wg, double wb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  luma_bands_kernel<<<(unsigned)B * (unsigned)bands, THREADS, 0, s>>>(
      static_cast<const int*>(crop), sb, sh, H, W, bands,
      static_cast<unsigned long long*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  luma_finish_kernel<<<(unsigned)((B + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      static_cast<const unsigned long long*>(part), B, bands, n, wr, wg, wb,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}
