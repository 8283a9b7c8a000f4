// K3: solid fill of the previous render's windows on a reused plane.
//
// Replaces the TPU kernels image_transformation_tpu/ops/compose_pallas.py:
// _make_restore_kernel (batch-max windows) and _make_restore_kernel_static
// (per-object windows), launched by _pallas_restore_windows. The fused
// render only changes pixels inside its windows, so writing the background
// colour over every window the previous render used returns the plane to
// an all-solid state without writing the whole plane again.
//
// What bounds it on this card: the bytes written (at 1080p B=256 about
// 0.45 GB of windows against 2.1 GB for a full fill). What the design does
// about it: it writes only, never reads; each block owns a few rows of one
// window and its threads write neighbouring int32 pixels of a row, so the
// stores coalesce. Two windows may overlap; both write the same bytes, so
// the order in which blocks run does not matter. Rectangles are cut at the
// plane's edge.
//
// Interface (all contiguous, on one device; see ops/compose_kernels.py):
//   plane   i32 [B, hp, wp]   packed RGBA, updated in place
//   origins i32 [B, N, 2]     (x, y) of each window's top-left corner
//   extents i32 [N, 2]        (h, w) of object k's window

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLS = 128;  // threads along a row
constexpr int ROWS = 4;    // rows per block

__global__ void __launch_bounds__(COLS * ROWS)
restore_kernel(int* __restrict__ plane, const int* __restrict__ origins,
               const int* __restrict__ extents, int N, int hp, int wp,
               int bg) {
  const int bk = blockIdx.x;
  const int b = bk / N, k = bk - b * N;
  const int wh = extents[2 * k], ww = extents[2 * k + 1];
  const int x0 = origins[2 * bk], y0 = origins[2 * bk + 1];
  const int r = blockIdx.y * ROWS + threadIdx.y;
  const int y = y0 + r;
  if (r >= wh || y < 0 || y >= hp) return;
  int* row = plane + ((size_t)b * hp + y) * wp;
  for (int c = threadIdx.x; c < ww; c += COLS) {
    const int x = x0 + c;
    if (x >= 0 && x < wp) row[x] = bg;
  }
}

}  // namespace

extern "C" int restore_windows_launch(void* plane, const void* origins,
                                      const void* extents, int B, int N,
                                      int hp, int wp, int max_wh, int bg,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)B * (unsigned)N, (max_wh + ROWS - 1) / ROWS);
  restore_kernel<<<grid, dim3(COLS, ROWS), 0, s>>>(
      static_cast<int*>(plane), static_cast<const int*>(origins),
      static_cast<const int*>(extents), N, hp, wp, bg);
  return (int)cudaGetLastError();
}
