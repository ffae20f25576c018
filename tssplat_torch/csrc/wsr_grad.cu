// K3 — antialias table gradient.
//
// Replaces tssplat_tpu/ops/pallas_raster.py _wsr_grad_kernel (:908, the
// pl.pallas_call at :1021 in wsr_table_grad_pallas). Sums the per-pixel
// cotangents of the winner rows, ct (B,6,H,W), into per-face rows
// out (B,F+1,6) keyed by the winner id; background pixels and pixels whose
// 6 cotangents are all zero are skipped, and row F is never written.
//
// Bound on the H100: bytes — every winner id is read (4 B/px) and the six
// cotangents of foreground pixels (24 B each); the adds are negligible.
// Design: one thread per pixel, float atomicAdd of the nonzero channels
// into the zero-filled table. The TPU kernel's per-tile distinct-winner
// extraction exists because TPU scatters serialize; Hopper's L2 atomics
// make the direct scatter the simple choice. Atomic order varies from run
// to run, so sums agree with a sequential sum to float32 rounding only.

#include <cuda_runtime.h>

namespace {

__global__ void wsr_grad_kernel(const int* __restrict__ ids,
                                const float* __restrict__ ct, long long HW,
                                long long n_px, int F,
                                float* __restrict__ out) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_px) return;
  const int id = ids[p];
  if (id <= 0) return;
  const long long b = p / HW;
  const float* c = ct + b * 6 * HW + (p - b * HW);
  float v[6];
  bool any = false;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    v[ch] = c[ch * HW];
    any |= v[ch] != 0.0f;
  }
  if (!any) return;
  float* row = out + (b * (F + 1) + (id - 1)) * 6;
#pragma unroll
  for (int ch = 0; ch < 6; ++ch) {
    if (v[ch] != 0.0f) atomicAdd(row + ch, v[ch]);
  }
}

}  // namespace

extern "C" int tss_wsr_grad_launch(const void* ids, const void* ct, int B,
                                   int H, int W, int F, void* out,
                                   void* stream) {
  const long long HW = (long long)H * W;
  const long long n_px = (long long)B * HW;
  const int threads = 256;
  const long long blocks = (n_px + threads - 1) / threads;
  wsr_grad_kernel<<<(unsigned)blocks, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(ct), HW, n_px,
      F, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
