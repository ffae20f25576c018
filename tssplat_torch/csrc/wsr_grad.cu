// K3 — antialias table gradient.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _wsr_grad_kernel (:908, the
// pl.pallas_call at :1021 in wsr_table_grad_pallas). Sums the per-pixel
// cotangents of the winner rows, ct (B,6,H,W), into per-face rows
// out (B,F+1,6) keyed by the winner id. A pixel counts where its id is > 0
// and one of its six cotangents is != 0 (-0.0 is zero); row F stays zero.
// A NaN or inf of a counted pixel reaches its own face's row only.
//
// Bound on the H100: bytes — every winner id (4 B/px), the six cotangents
// of each foreground pixel (24 B) and the table (24 B a row); the adds are
// few. On the main path the cotangent is K5's d g6, non-zero at ~15 k of
// 2 M pixels, so the id stream and the table's fill are most of the time.
// Design: the C entry zeroes the table (cudaMemsetAsync on the stream),
// then one CTA of 256 threads per (view, 8x128 tile), a tile's views
// adjacent in a flat grid, a warp per tile row and a thread per run of four
// pixels. A thread reads its four ids with one 16-byte load (scalar loads
// where W % 4 != 0 or a pointer is unaligned); a warp without a foreground
// pixel ends there, and only a run with one reads ct, one 16-byte load per
// channel plane. Neighbouring counted pixels of a run with the same id are
// summed in the thread; then the lanes whose first such sum has the same
// id are grouped with __match_any_sync, and the group's first lane adds the
// group's non-zero channels with one atomicAdd each: the atomics of a face
// that spans a warp's row fall from one per pixel to one per (warp, face).
// What is left is the id stream and the fill: with every id 0 the kernel
// takes ~80% of its main-path time (PERF.md). The TPU kernel's per-tile
// extraction of distinct winners exists because TPU scatters serialize; it
// is not carried over. Atomic order varies from run to run, so sums agree
// with a sequential sum to float32 rounding only.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kRun = 4;                        // pixels per thread
constexpr int kLanes = kTileW / kRun;          // 32: a warp per tile row
constexpr int kThreads = kTileH * kLanes;      // 256
constexpr unsigned kAll = 0xffffffffu;

// v[k] for k in 0..3 by selects (an indexed register array would live in
// local memory)
template <class T>
__device__ inline T pick4(const T v[kRun], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

__global__ void __launch_bounds__(kThreads)
wsr_grad_kernel(const int* __restrict__ ids, const float* __restrict__ ct,
                int B, int H, int W, int F, int ntx, bool vec,
                float* __restrict__ out) {
  const int b = blockIdx.x % B, tile = blockIdx.x / B;
  const int lane = threadIdx.x % kLanes;
  const int r = (tile / ntx) * kTileH + threadIdx.x / kLanes;
  const int c = (tile % ntx) * kTileW + lane * kRun;
  if (r >= H) return;                          // the whole warp: one row
  const long long HW = (long long)H * W;
  const long long px = b * HW + (long long)r * W + c;

  int id[kRun] = {0, 0, 0, 0};
  if (c < W) {
    if (vec) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(ids + px));
      id[0] = q.x; id[1] = q.y; id[2] = q.z; id[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (c + j < W) id[j] = __ldg(ids + px + j);
    }
  }
  bool fg = false;
#pragma unroll
  for (int j = 0; j < kRun; ++j) fg |= id[j] > 0;
  if (!__any_sync(kAll, fg)) return;

  // v[ch][j]: channel ch of pixel j, read only where the run has a
  // foreground pixel
  float v[6][kRun];
  const float* cp = ct + (long long)b * 6 * HW + (long long)r * W + c;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
#pragma unroll
    for (int j = 0; j < kRun; ++j) v[ch][j] = 0.0f;
    if (!fg) continue;
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(cp + ch * HW));
      v[ch][0] = q.x; v[ch][1] = q.y; v[ch][2] = q.z; v[ch][3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        if (id[j] > 0) v[ch][j] = __ldg(cp + ch * HW + j);
    }
  }

  // counted pixels; a head is the first of a stretch of counted pixels
  // with one id (pixels that do not count may lie between them), and
  // after the backward pass v[.][j] of a head holds its stretch's sum
  bool counted[kRun];
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    bool any = false;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) any |= v[ch][j] != 0.0f;
    counted[j] = id[j] > 0 && any;
  }
  unsigned heads = 0u;
  int prev = 0;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (!counted[j]) continue;
    if (id[j] != prev) heads |= 1u << j;
    prev = id[j];
  }
  float acc[6];
  int acc_id = 0;
#pragma unroll
  for (int j = kRun - 1; j >= 0; --j) {
    if (!counted[j]) continue;
    const bool same = id[j] == acc_id;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      acc[ch] = same ? v[ch][j] + acc[ch] : v[ch][j];
      v[ch][j] = acc[ch];
    }
    acc_id = id[j];
  }

  if (!__any_sync(kAll, heads != 0u)) return;

  // One match over each lane's first head: the lanes whose first head has
  // the same id form a group (a lane without a head is a group of its own,
  // key -1 - lane); the group's first lane adds the others' sums from
  // shared memory in lane order and the group's sum to the table. A lane's
  // later heads (its run holds counted pixels of two or more faces) add
  // alone: on the card a match round for them cost more than the atomics
  // it saved (PERF.md).
  __shared__ float sums[6][kThreads];
  float* table = out + (long long)b * (F + 1) * 6;
  const int j0 = heads ? __ffs(heads) - 1 : 0;
  const int key = heads ? pick4(id, j0) : -1 - lane;
  heads &= heads - 1u;
  float s[6];
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    s[ch] = key > 0 ? pick4(v[ch], j0) : 0.0f;
    sums[ch][threadIdx.x] = s[ch];
  }
  const unsigned group = __match_any_sync(kAll, key);
  __syncwarp();
  if (key > 0 && (group & ((1u << lane) - 1u)) == 0u) {
    const int warp0 = threadIdx.x - lane;
    for (unsigned m = group & (group - 1u); m; m &= m - 1u) {
      const int t = warp0 + __ffs(m) - 1;
#pragma unroll
      for (int ch = 0; ch < 6; ++ch) s[ch] += sums[ch][t];
    }
    float* row = table + (long long)(key - 1) * 6;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch)
      if (s[ch] != 0.0f) atomicAdd(row + ch, s[ch]);
  }
  while (heads) {
    const int j = __ffs(heads) - 1;
    heads &= heads - 1u;
    float* row = table + (long long)(pick4(id, j) - 1) * 6;
#pragma unroll
    for (int ch = 0; ch < 6; ++ch) {
      const float x = pick4(v[ch], j);
      if (x != 0.0f) atomicAdd(row + ch, x);
    }
  }
}

}  // namespace

extern "C" int tss_wsr_grad_launch(const void* ids, const void* ct, int B,
                                   int H, int W, int F, void* out,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      out, 0, (size_t)B * (F + 1) * 6 * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(ids) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  const int nty = (H + kTileH - 1) / kTileH, ntx = (W + kTileW - 1) / kTileW;
  const long long blocks = (long long)nty * ntx * B;
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  wsr_grad_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const int*>(ids), static_cast<const float*>(ct), B, H, W,
      F, ntx, vec, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
