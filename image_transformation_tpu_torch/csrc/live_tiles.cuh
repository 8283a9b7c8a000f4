// The live-tile walk of K2's resample (fused_v3.cu) and blend
// (box_blend.cuh).
//
// An envelope grid would give every placement (b, k) a block for each
// 32 x 32 tile of the envelope (mh, mw), and a tile past the placement's
// own output extent would exit at once. Where a placement is much smaller
// than the envelope (the UHD cell's logo, text and CTA beside its photo),
// most such blocks do nothing but take a resident slot, load the meta and
// retire.
//
// The walk launches a persistent grid instead (the card's SMs times the
// blocks an SM holds) and hands out only live tiles. Placement bk has
// tiles(bk) = ceil(w / 32) * ceil(h / 32) live tiles for its rectangle's
// (w, h) (0 for a dropped placement). A launch walks n placements from
// p0 on: each block builds the exclusive prefix of tiles() over them in
// shared memory, then takes flat tile indices below the total in
// increasing order: the blend the indices t = blockIdx.x + i * gridDim.x,
// the resample the next index of a counter in device memory, since its
// tiles' costs differ. A tile's placement comes from a cursor that only
// moves forward through the prefix (`advance`); within a placement the
// tile's column comes first, so blocks that run at one time work on
// neighbouring tiles of one placement.
//
// The prefix takes 4 bytes a placement beside each kernel's shared
// memory; `fit` finds how many placements a launch may walk before the
// prefix would lower the blocks an SM holds, and a longer launch is cut
// into launches of that many placements.
//
// The host learns no count: the walk reads the meta the launch reads
// anyway. The counter is two ints that the caller owns, zero before a
// launch; the last block of each launch to finish zeroes it again
// (`finish`), so launches in stream order find it zero.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace live_tiles {

constexpr int TILE = 32;

// live tiles of a rectangle (x, y, w, h), w = h = 0 for a dropped placement
__device__ __forceinline__ int count(const int4& r) {
  return ((r.z + TILE - 1) / TILE) * ((r.w + TILE - 1) / TILE);
}

// prefix[0..n]: the exclusive prefix of count(rects.get(p0 + i)) over
// i < n, prefix[n] the total. All THREADS threads of the block call it;
// `s_warp` holds THREADS / 32 ints of scratch. Ends with a barrier.
template <int THREADS, class Rects>
__device__ void build_prefix(int* prefix, int p0, int n, const Rects& rects, int* s_warp) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n ? count(rects.get(p0 + i)) : 0;
    int incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += u;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = carry;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int s = s_warp[w];
      if (w < warp) before += s;
      carry += s;
    }
    if (i < n) prefix[i] = before + incl - v;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  if (threadIdx.x == 0) prefix[n] = carry;
  __syncthreads();
}

// The placement of flat tile t (its index from p0), given a cursor with
// prefix[cur] <= t < prefix[n]: the last i >= cur with prefix[i] <= t
// (so tiles(p0 + i) > 0).
// Every lane of a warp calls it (each warp of a block finds the same bk);
// a step reads 32 entries of the prefix.
__device__ __forceinline__ int advance(const int* prefix, int n, int cur, int t) {
  const int lane = threadIdx.x & 31;
  for (;; cur += 32) {
    const int i = cur + 1 + lane;
    const unsigned past = __ballot_sync(0xffffffffu, i > n || prefix[i] > t);
    if (past != 0u) return cur + __ffs(past) - 1;
  }
}

// Called by one thread of every block after its last claim (an atomicAdd
// on claims[0]): the launch's last block to get here zeroes the counter for
// the next launch. Every block claims before it finishes, so no claim
// follows the reset.
__device__ __forceinline__ void finish(int* claims) {
  __threadfence();  // this block's claims are done before it counts itself
  if (atomicAdd(claims + 1, 1) == (int)(gridDim.x * gridDim.y * gridDim.z) - 1) {
    atomicExch(claims, 0);
    atomicExch(claims + 1, 0);
  }
}

// How a walk of `kernel` (`threads` threads, `base` bytes of dynamic
// shared memory before its prefix, at most `max_smem`) launches on the
// current device: `cap`, the most placements a launch walks, whose prefix
// of 4 * (cap + 1) bytes leaves the blocks an SM held without it;
// `resident`, those blocks; `sms`, the device's SMs. Where no prefix fits
// without lowering them, cap is 1 and resident what that leaves. Asked
// of the runtime once per (kernel, device, base) and kept. Returns the
// CUDA error (0 on success; cudaErrorInvalidValue where even one
// placement's prefix does not fit).
struct Fit {
  int cap, resident, sms;
};

inline cudaError_t fit(const void* kernel, int threads, int base, int max_smem, Fit* out) {
  static std::mutex lock;
  static std::map<std::tuple<const void*, int, int>, Fit> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple(kernel, dev, base);
  std::lock_guard<std::mutex> hold(lock);
  auto it = known.find(key);
  if (it == known.end()) {
    const int most = (max_smem - base) / 4 - 1;  // placements whose prefix fits at all
    if (most < 1) return cudaErrorInvalidValue;
    Fit f{1, 0, 0};
    int without = 0;
    err = cudaDeviceGetAttribute(&f.sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&without, kernel, threads, base);
    }
    // the resident blocks fall as the prefix grows: the largest n that keeps them
    int lo = 1, hi = most;
    while (err == cudaSuccess && lo < hi) {
      const int mid = lo + (hi - lo + 1) / 2;
      int r = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, kernel, threads, base + 4 * (mid + 1));
      if (r >= without) lo = mid; else hi = mid - 1;
    }
    f.cap = lo;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f.resident, kernel, threads,
                                                          base + 4 * (lo + 1));
    }
    if (err != cudaSuccess) return err;
    if (f.resident < 1) return cudaErrorInvalidValue;
    it = known.emplace(key, f).first;
  }
  *out = it->second;
  return cudaSuccess;
}

}  // namespace live_tiles
