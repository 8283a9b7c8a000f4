// K3: fill of the previous render's windows on a reused plane, with the
// solid background colour or with the gradient background's ramp.
//
// Replaces the TPU kernels image_transformation_tpu/ops/compose_pallas.py:
// _make_restore_kernel (batch-max windows) and _make_restore_kernel_static
// (per-object windows), launched by _pallas_restore_windows. The fused
// render only changes pixels inside its windows, so writing the background
// colour over every window the previous render used returns the plane to
// an all-solid state without writing the whole plane again.
//
// What bounds it on this card: the bytes written, each pixel of the union
// of a canvas's windows once (at 1080p B=256 about 0.45 GB of windows
// against 2.1 GB for a full fill). What the design does about it: it
// writes only, never reads, and writes each pixel once:
// - a block takes a band of rows of ONE canvas across all its windows:
//   grid (B, bands), the canvas's N windows staged in shared memory, cut at
//   the plane's edge, and the rows between the first window's top and the
//   last window's bottom shared out among the bands;
// - a warp takes a row at a time, and its lanes take 16-byte groups of the
//   row, aligned to the group's address: a group wholly inside the union
//   of the windows that cross the row is one int4 store, the groups at a
//   window's ragged ends (and windows narrower than 4 px) store their
//   covered pixels one by one. Overlaps and gaps cost coverage tests, not
//   stores: no pixel is written twice.
// - the fill is a template parameter, so the solid form is the code it was
//   before the gradient forms came: SOLID stores bg; COL_RAMP (a vertical
//   gradient) stores ramp[y] on row y, loaded once a row; ROW_RAMP (a
//   horizontal gradient) stores ramp[c] at column c, read through the L1
//   (one packed row of the plane's width, 9 KB at 2304 columns), so its
//   stores stay the same 16-byte stores.
// - a ramp is one line shared by every canvas, or a line per canvas (a
//   batch of creatives, each on its own gradient): the body is one inlined
//   template, whose restore_kernel instances (solid, shared line) are the
//   kernels they were before, and whose restore_lines_kernel instances read
//   canvas b's line at ramp + b * line_stride.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   plane   i32 [B, hp, wp]   packed RGBA, updated in place (4-byte aligned)
//   origins i32 [B, N, 2]     (x, y) of each window's top-left corner
//   extents i32 [N, 2]        (h, w) of object k's window
//   ramp    i32 [wp] or [hp]  packed RGBA of each column (ROW_RAMP) or row
//                             (COL_RAMP) of the gradient plane; or [B, wp] or
//                             [B, hp], a line per canvas, line_stride apart

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;      // 8 warps, one row each at a time
constexpr int BAND_ROWS = 8;      // bands per canvas: ceil(max_wh / BAND_ROWS)
constexpr int MAX_SMEM = 232448;  // shared memory a block can use (227 KB)

enum Fill { SOLID = 0, ROW_RAMP = 1, COL_RAMP = 2 };

inline int smem_bytes(int n) { return (int)sizeof(int4) * n; }

template <int FILL>
__device__ __forceinline__ void restore_body(int* __restrict__ plane,
                                             const int* __restrict__ origins,
                                             const int* __restrict__ extents,
                                             const int* __restrict__ ramp, int N, int hp, int wp,
                                             int bg) {
  extern __shared__ int4 s_win[];  // (x0, y0, x1, y1) on the plane; (0, 0, 0, 0) when empty
  __shared__ int s_span[2];
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < N; k += THREADS) {
    const int x = origins[2 * (b * N + k)], y = origins[2 * (b * N + k) + 1];
    const int h = extents[2 * k], w = extents[2 * k + 1];
    int4 r = make_int4(max(x, 0), max(y, 0), min(x + w, wp), min(y + h, hp));
    if (r.z <= r.x || r.w <= r.y) r = make_int4(0, 0, 0, 0);
    s_win[k] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // the rows any window crosses
    int y0 = INT_MAX, y1 = 0;
    for (int k = 0; k < N; ++k) {
      const int4 r = s_win[k];
      if (r.w > r.y) {
        y0 = min(y0, r.y);
        y1 = max(y1, r.w);
      }
    }
    s_span[0] = y0;
    s_span[1] = y1;
  }
  __syncthreads();
  if (s_span[1] <= s_span[0]) return;  // every window lies past the plane
  const int chunk = (s_span[1] - s_span[0] + (int)gridDim.y - 1) / (int)gridDim.y;
  const int ya = s_span[0] + blockIdx.y * chunk, yb = min(s_span[1], ya + chunk);
  const int4 bg4 = make_int4(bg, bg, bg, bg);
  const int lane = threadIdx.x & 31;
  for (int y = ya + (threadIdx.x >> 5); y < yb; y += THREADS / 32) {
    int xa = INT_MAX, xb = 0;  // the row's span over the windows crossing it
    for (int k = 0; k < N; ++k) {
      const int4 r = s_win[k];
      if (y >= r.y && y < r.w) {
        xa = min(xa, r.x);
        xb = max(xb, r.z);
      }
    }
    if (xb <= xa) continue;
    int v = bg;
    int4 v4 = bg4;
    if (FILL == COL_RAMP) {
      v = __ldg(ramp + y);
      v4 = make_int4(v, v, v, v);
    }
    int* row = plane + ((size_t)b * hp + y) * wp;
    // column -a starts a 16-byte group: groups are aligned to their address
    const int a = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    for (int c = 4 * ((xa + a) >> 2) - a + 4 * lane; c < xb; c += 4 * 32) {
      unsigned m = 0;  // bit j: column c + j lies in a window crossing the row
      for (int k = 0; k < N; ++k) {
        const int4 r = s_win[k];
        if (y < r.y || y >= r.w) continue;
        const int lo = max(r.x - c, 0), hi = min(r.z - c, 4);
        if (hi > lo) m |= (0xfu >> (4 - hi)) & (0xfu << lo);
      }
      if (m == 0xfu) {
        if (FILL == ROW_RAMP) {  // c >= 0 here: the group lies inside a window
          const int* src = ramp + c;
          v4 = (reinterpret_cast<uintptr_t>(src) & 15) == 0
                   ? __ldg(reinterpret_cast<const int4*>(src))
                   : make_int4(__ldg(src), __ldg(src + 1), __ldg(src + 2), __ldg(src + 3));
        }
        *reinterpret_cast<int4*>(row + c) = v4;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (m >> j & 1u) row[c + j] = FILL == ROW_RAMP ? __ldg(ramp + c + j) : v;
        }
      }
    }
  }
}

template <int FILL>
__global__ void __launch_bounds__(THREADS)
restore_kernel(int* __restrict__ plane, const int* __restrict__ origins,
               const int* __restrict__ extents, const int* __restrict__ ramp, int N, int hp,
               int wp, int bg) {
  restore_body<FILL>(plane, origins, extents, ramp, N, hp, wp, bg);
}

// the ramp forms with a line per canvas: canvas b's at ramp + b * line_stride
template <int FILL>
__global__ void __launch_bounds__(THREADS)
restore_lines_kernel(int* __restrict__ plane, const int* __restrict__ origins,
                     const int* __restrict__ extents, const int* __restrict__ ramp, int N,
                     int hp, int wp, int line_stride) {
  restore_body<FILL>(plane, origins, extents, ramp + (size_t)blockIdx.x * line_stride, N, hp, wp,
                     0);
}

// LINES: restore_lines_kernel, canvas b's line at ramp + b * line_stride;
// else restore_kernel (a solid fill or one line), its instances only
template <int FILL, bool LINES = false>
int launch(void* plane, const void* origins, const void* extents, const void* ramp, int B, int N,
           int hp, int wp, int max_wh, int bg, void* stream, int line_stride = 0) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const void* kernel;
  if constexpr (LINES) {
    kernel = (const void*)restore_lines_kernel<FILL>;
  } else {
    kernel = (const void*)restore_kernel<FILL>;
  }
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int bands = max_wh > BAND_ROWS ? (max_wh + BAND_ROWS - 1) / BAND_ROWS : 1;
  const dim3 grid((unsigned)B, (unsigned)bands);
  if constexpr (LINES) {
    restore_lines_kernel<FILL><<<grid, THREADS, smem, s>>>(
        static_cast<int*>(plane), static_cast<const int*>(origins),
        static_cast<const int*>(extents), static_cast<const int*>(ramp), N, hp, wp, line_stride);
  } else {
    restore_kernel<FILL><<<grid, THREADS, smem, s>>>(
        static_cast<int*>(plane), static_cast<const int*>(origins),
        static_cast<const int*>(extents), static_cast<const int*>(ramp), N, hp, wp, bg);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory of K3's launch for N windows per canvas
extern "C" int restore_windows_smem(int N) { return smem_bytes(N); }

// max_wh: the largest window height, which sets the bands per canvas
extern "C" int restore_windows_launch(void* plane, const void* origins,
                                      const void* extents, int B, int N,
                                      int hp, int wp, int max_wh, int bg,
                                      void* stream) {
  return launch<SOLID>(plane, origins, extents, nullptr, B, N, hp, wp, max_wh, bg, stream);
}

// the gradient form: ramp holds wp packed columns (horizontal) or hp rows,
// one line for every canvas (line_stride 0) or a line per canvas, canvas b's
// at ramp + b * line_stride
extern "C" int restore_windows_ramp_launch(void* plane, const void* origins,
                                           const void* extents, const void* ramp, int B,
                                           int N, int hp, int wp, int max_wh, int horizontal,
                                           int line_stride, void* stream) {
  if (line_stride) {
    return horizontal ? launch<ROW_RAMP, true>(plane, origins, extents, ramp, B, N, hp, wp,
                                               max_wh, 0, stream, line_stride)
                      : launch<COL_RAMP, true>(plane, origins, extents, ramp, B, N, hp, wp,
                                               max_wh, 0, stream, line_stride);
  }
  return horizontal ? launch<ROW_RAMP>(plane, origins, extents, ramp, B, N, hp, wp, max_wh, 0,
                                       stream)
                    : launch<COL_RAMP>(plane, origins, extents, ramp, B, N, hp, wp, max_wh, 0,
                                       stream);
}
