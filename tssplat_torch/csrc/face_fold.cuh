// The walk over a batch of views in runs of four pixels, and the per-face
// fold of per-pixel gradients, shared by K6 (shade.cu), K7 (interp.cu) and
// K8 (winner_rows.cu).
//
// A CTA of 256 threads covers an 8x128 tile of one view: a warp per tile
// row, a thread per run of four pixels. The CTAs walk every tile of a view
// before the next view's, so the few hundred kilobytes of a view's face
// table stay in L2 while its pixels read them.
//
// The fold is K3's (csrc/wsr_grad.cu): neighbouring counted pixels of a
// run with the same face are summed in the thread; the lanes whose first
// such sum has the same face are grouped with __match_any_sync, and the
// group's first lane adds the others' sums from shared memory in lane
// order and makes one atomicAdd per non-zero column; a lane's later sums
// (its run holds pixels of two or more faces) add alone. Atomic order
// varies from run to run, so the sums agree with a sequential sum to
// float32 rounding only.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace ff {

constexpr int kTileH = 8;
constexpr int kTileW = 128;
constexpr int kRun = 4;                        // pixels per thread
constexpr int kLanes = kTileW / kRun;          // 32: a warp per tile row
constexpr int kThreads = kTileH * kLanes;      // 256
constexpr unsigned kAll = 0xffffffffu;
constexpr float kAreaEps = 1e-14f;             // ops/screen.py AREA_EPS
constexpr float kWEps = 1e-9f;                 // ops/screen.py W_EPS

// A thread's run: pixels (b, r, c .. c + n - 1) of the batch, px the flat
// index of (b, r, c); n is 0 past the image's last column.
struct Run {
  int b, r, c, n;
  long long px;
};

__device__ inline Run run_of(int H, int W) {
  const int ntx = (W + kTileW - 1) / kTileW;
  const int per_view = ntx * ((H + kTileH - 1) / kTileH);
  const int tile = blockIdx.x % per_view;
  Run u;
  u.b = blockIdx.x / per_view;
  u.r = (tile / ntx) * kTileH + threadIdx.x / kLanes;
  u.c = (tile % ntx) * kTileW + (threadIdx.x % kLanes) * kRun;
  u.n = u.c < W ? min(kRun, W - u.c) : 0;
  u.px = ((long long)u.b * H + u.r) * W + u.c;
  return u;
}

// CTAs of a launch over B views of H x W
inline long long blocks(int B, int H, int W) {
  return (long long)B * ((H + kTileH - 1) / kTileH) *
         ((W + kTileW - 1) / kTileW);
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// NDC centre of pixel index idx along an axis of n pixels (ops/screen.py
// ndc_center, the same operations in the same order)
__device__ inline float ndc_center(int idx, int n) {
  return ((float)idx + 0.5f) / (float)n * 2.0f - 1.0f;
}

// v[k] for k in 0..3 by selects (an indexed register array would live in
// local memory)
template <class T>
__device__ inline T pick4(const T v[kRun], int k) {
  return k == 0 ? v[0] : (k == 1 ? v[1] : (k == 2 ? v[2] : v[3]));
}

// The run's ids+1 (0 past the image): one 16-byte load where ``vec``
__device__ inline void load_ids(const int* ids, const Run& u, bool vec,
                                int id[kRun]) {
#pragma unroll
  for (int j = 0; j < kRun; ++j) id[j] = 0;
  if (u.n == 0) return;
  if (vec) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(ids + u.px));
    id[0] = q.x; id[1] = q.y; id[2] = q.z; id[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
      if (j < u.n) id[j] = __ldg(ids + u.px + j);
  }
}

// The run's rast rows (u, v, z/w, id+1), 0 past the image
__device__ inline void load_rast(const float* rast, const Run& u,
                                 float4 r[kRun]) {
  const float4* p = reinterpret_cast<const float4*>(rast) + u.px;
#pragma unroll
  for (int j = 0; j < kRun; ++j)
    r[j] = j < u.n ? __ldg(p + j) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Adds the columns col0 .. col0 + nv - 1 of a row of face id1 - 1
template <int NV>
__device__ inline void add_row(float* table, int id1, int width, int col0,
                               int nv, const float x[NV]) {
  float* row = table + (long long)(id1 - 1) * width + col0;
#pragma unroll
  for (int c = 0; c < NV; ++c)
    if (c < nv && x[c] != 0.0f) atomicAdd(row + c, x[c]);
}

// The fold of one chunk of NV columns (col0 .. col0 + nv - 1 of rows of
// ``width``) of a run's per-pixel values into the per-face table of its
// view. ``counted``: bit j where pixel j counts; ``key``: the id+1 of the
// lane's first counted pixel, or -1 - lane where it has none; ``group``:
// __match_any_sync(kAll, key). ``pixel(j, v)`` fills pixel j's values.
// Every lane of the warp calls it; ``sums`` is the CTA's [NV][kThreads].
template <int NV, class Pixel>
__device__ inline void fold(const int id[kRun], unsigned counted, int key,
                            unsigned group, float* table, int width,
                            int col0, int nv, float (*sums)[kThreads],
                            Pixel pixel) {
  float first[NV], acc[NV];
#pragma unroll
  for (int c = 0; c < NV; ++c) first[c] = acc[c] = 0.0f;
  int cur = 0;
  bool have_first = false;
  auto flush = [&]() {
    if (!have_first) {
#pragma unroll
      for (int c = 0; c < NV; ++c) first[c] = acc[c];
      have_first = true;
    } else {
      add_row<NV>(table, cur, width, col0, nv, acc);
    }
  };
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    if (!(counted >> j & 1u)) continue;
    float v[NV];
    pixel(j, v);
    if (id[j] != cur) {
      if (cur > 0) flush();
      cur = id[j];
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] = v[c];
    } else {
#pragma unroll
      for (int c = 0; c < NV; ++c) acc[c] += v[c];
    }
  }
  if (cur > 0) flush();

  const int lane = threadIdx.x % kLanes;
#pragma unroll
  for (int c = 0; c < NV; ++c) sums[c][threadIdx.x] = first[c];
  __syncwarp();
  if (key > 0 && (group & ((1u << lane) - 1u)) == 0u) {
    const int warp0 = threadIdx.x - lane;
    for (unsigned m = group & (group - 1u); m; m &= m - 1u) {
      const int t = warp0 + __ffs(m) - 1;
#pragma unroll
      for (int c = 0; c < NV; ++c) first[c] += sums[c][t];
    }
    add_row<NV>(table, key, width, col0, nv, first);
  }
  __syncwarp();                  // the sums are read before the next chunk
}

// The key and group of a run for ``fold``
__device__ inline int fold_key(const int id[kRun], unsigned counted) {
  return counted ? pick4(id, __ffs(counted) - 1)
                 : -1 - (int)(threadIdx.x % kLanes);
}

}  // namespace ff
