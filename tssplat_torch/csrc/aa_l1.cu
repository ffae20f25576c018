// K10 — the exact texture loss's image-space tail, forward and backward:
// the colours put back on the image, composited over the background,
// colour-antialiased, and the L1 against the target.
//
// Replaces no Pallas kernel: the JAX package runs this tail as XLA code
// (tssplat_tpu/materials/exact_stage.py, the colour antialias of
// tssplat_tpu/ops/rasterize.py antialias). PyTorch's chain (ops/aa_l1.py
// aa_l1_plain) zero-fills an (n·H·W, 3) image and puts the colours into
// it, composites, adds four padded delta images and takes |out - gt|: a
// dozen full-image passes forward and some twenty in autograd's backward,
// each moving 126-378 MB at the texture cell's 120 views of 512².
//
// Inputs the exact cache makes once (materials/exact_stage.py), P = n·H·W
// pixels: fg (P,) int32, the colour row of each pixel, -1 on background;
// aa (P,) int32, the row of w of each pixel that blends toward a
// neighbour, -1 where it blends toward none; w (n_aa, 4), its weights
// toward the right, left, lower and upper neighbour (ops/rasterize.py
// color_aa_weights: the colour antialias's pair weights, zero at the
// image's border where its pads put no pair); bg and gt (P, 3).
//
// Forward: per pixel p and channel, gb = bg + (c - bg)·m with c the
// colour of row fg[p] (0 on background) and m 1 on foreground, 0 on
// background; out = gb, then in the plain chain's order out + (gb of the
// right neighbour - gb)·w.x, + (left - gb)·w.y, + (lower - gb)·w.z,
// + (upper - gb)·w.w, each only where its weight is not 0 (the plain
// chain adds (…)·0 there, which leaves out as it was up to the sign of a
// zero). Built with -fmad=false, out equals the plain chain's to the bit.
// |out - gt| is summed in double per thread, per block in a fixed tree,
// and over the blocks by a second, one-block pass in a fixed order: the
// same sum in every run, with no float atomics. The sign of out - gt of
// each channel is kept as 2 bits of a byte a pixel (1: +, 2: -, 0: zero
// or NaN, torch.sgn's 0) for the backward.
// Backward: per foreground point i (pixel p = pix[i]) and channel, under
// the gradient g of the sum: d = g·s(p), then for each neighbour q inside
// the image (right, left, lower, upper) d - (g·s(p))·w_p(toward q) +
// (g·s(q))·w_q(toward p), the blend's transpose in the order of
// ops/aa_l1.py aa_l1_backward_plain; written to d colours (n_fg, 3)
// without atomics (a point's row is its own).
//
// Bound on the H100: bytes. The forward reads fg and aa (4 B each), bg
// and gt (12 B each) and writes a sign byte per pixel: 33 B a pixel, 1.04
// GB at 31.46 M pixels, 0.31 ms at 3.35 TB/s; the colours (12 B a point)
// and the neighbours read at silhouette edges add a few per cent. The
// backward touches a point's pixel, sign and record and its neighbours'
// records (~40 B a point, 1.27 M points). Design: four pixels a thread,
// so fg and aa are one 16-byte load each, bg and gt three, and the four
// signs one 4-byte store; a neighbour's composite is recomputed from the
// global arrays (in L1 or L2), only at pixels whose record has a weight.
// Where P is not a multiple of 4 or an array is not aligned, the same
// kernel reads and writes one element at a time.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 4;                 // pixels a thread (forward)
constexpr int kSumThreads = 1024;
constexpr unsigned kAll = 0xffffffffu;

struct Tail {
  const float* colors;   // (n_fg, 3)
  const int* fg;         // (P,)
  const int* aa;         // (P,)
  const float4* w;       // (n_aa,)
  const float* bg;       // (P, 3)
  const float* gt;       // (P, 3)
  long long P;
  int H, W;
};

// The composite of one channel: bg + (c - bg)·m, c and m from the
// pixel's colour row f (the plain chain's image of zeros and its mask)
__device__ __forceinline__ float composite(const float* __restrict__ colors,
                                           int f, float b, int ch) {
  const float c = f >= 0 ? __ldg(colors + 3LL * f + ch) : 0.0f;
  const float m = f >= 0 ? 1.0f : 0.0f;
  return b + (c - b) * m;
}

// The composite of pixel q's channel ch, read from the global arrays
__device__ __forceinline__ float composite_at(const Tail& t, long long q,
                                              int ch) {
  return composite(t.colors, __ldg(t.fg + q), __ldg(t.bg + 3 * q + ch), ch);
}

// out += (the neighbour q's composite - g)·w, channel by channel
__device__ __forceinline__ void blend(const Tail& t, long long q, float w,
                                      const float* g, float* out) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[ch] = out[ch] + (composite_at(t, q, ch) - g[ch]) * w;
}

// The antialiased colour out (3) of pixel p, whose colour row is f, weight
// row a and background b (3)
__device__ __forceinline__ void shade(const Tail& t, long long p, int f,
                                      int a, const float* b, float* out) {
  float g[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    g[ch] = composite(t.colors, f, b[ch], ch);
    out[ch] = g[ch];
  }
  if (a < 0) return;
  const float4 w = __ldg(t.w + a);
  const int c = (int)(p % t.W);
  const int r = (int)((p / t.W) % t.H);
  if (w.x != 0.0f && c < t.W - 1) blend(t, p + 1, w.x, g, out);
  if (w.y != 0.0f && c > 0) blend(t, p - 1, w.y, g, out);
  if (w.z != 0.0f && r < t.H - 1) blend(t, p + t.W, w.z, g, out);
  if (w.w != 0.0f && r > 0) blend(t, p - t.W, w.w, g, out);
}

__device__ __forceinline__ unsigned sign_bits(float d) {
  return d > 0.0f ? 1u : (d < 0.0f ? 2u : 0u);
}

// Forward: four pixels a thread; one double partial sum a block
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
aa_l1_kernel(Tail t, unsigned char* __restrict__ code,
             float* __restrict__ shaded, double* __restrict__ partial) {
  const long long p0 =
      ((long long)blockIdx.x * kThreads + threadIdx.x) * kPix;
  double acc = 0.0;
  if (p0 < t.P) {
    int f[kPix], a[kPix];
    float b[3 * kPix], y[3 * kPix], o[3 * kPix];
    if (kVec) {
      const int4 fv = __ldg(reinterpret_cast<const int4*>(t.fg + p0));
      const int4 av = __ldg(reinterpret_cast<const int4*>(t.aa + p0));
      f[0] = fv.x; f[1] = fv.y; f[2] = fv.z; f[3] = fv.w;
      a[0] = av.x; a[1] = av.y; a[2] = av.z; a[3] = av.w;
      const float4* bv = reinterpret_cast<const float4*>(t.bg + 3 * p0);
      const float4* yv = reinterpret_cast<const float4*>(t.gt + 3 * p0);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 u = __ldg(bv + k), v = __ldg(yv + k);
        b[4 * k] = u.x; b[4 * k + 1] = u.y; b[4 * k + 2] = u.z;
        b[4 * k + 3] = u.w;
        y[4 * k] = v.x; y[4 * k + 1] = v.y; y[4 * k + 2] = v.z;
        y[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        const bool in = p0 + k < t.P;
        f[k] = in ? __ldg(t.fg + p0 + k) : -1;
        a[k] = in ? __ldg(t.aa + p0 + k) : -1;
      }
#pragma unroll
      for (int i = 0; i < 3 * kPix; ++i) {
        const bool in = p0 + i / 3 < t.P;
        b[i] = in ? __ldg(t.bg + 3 * p0 + i) : 0.0f;
        y[i] = in ? __ldg(t.gt + 3 * p0 + i) : 0.0f;
      }
    }
    unsigned word = 0;
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (!kVec && p0 + k >= t.P) continue;
      shade(t, p0 + k, f[k], a[k], b + 3 * k, o + 3 * k);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float d = o[3 * k + ch] - y[3 * k + ch];
        acc += (double)fabsf(d);
        word |= sign_bits(d) << (8 * k + 2 * ch);
      }
    }
    if (kVec) {
      *reinterpret_cast<unsigned*>(code + p0) = word;
      if (shaded != nullptr) {
        float4* sv = reinterpret_cast<float4*>(shaded + 3 * p0);
#pragma unroll
        for (int k = 0; k < 3; ++k)
          sv[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                              o[4 * k + 3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (p0 + k >= t.P) continue;
        code[p0 + k] = (unsigned char)(word >> (8 * k));
        if (shaded != nullptr) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            shaded[3 * (p0 + k) + ch] = o[3 * k + ch];
        }
      }
    }
  }
  // the block's sum: lanes in a fixed tree, then the warps in order
  __shared__ double warp_sum[kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_down_sync(kAll, acc, s);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += warp_sum[i];
    partial[blockIdx.x] = s;
  }
}

// The blocks' partial sums in a fixed order, one block: out[0] = the sum
__global__ void __launch_bounds__(kSumThreads)
sum_kernel(const double* __restrict__ partial, int n,
           float* __restrict__ out) {
  __shared__ double warp_sum[kSumThreads / 32];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) s += partial[i];
#pragma unroll
  for (int k = 16; k > 0; k >>= 1) s += __shfl_down_sync(kAll, s, k);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    for (int i = 0; i < kSumThreads / 32; ++i) total += warp_sum[i];
    out[0] = (float)total;
  }
}

// g times the sign of channel ch in a pixel's sign byte
__device__ __forceinline__ float signed_g(float g, unsigned code, int ch) {
  const unsigned s = (code >> (2 * ch)) & 3u;
  return g * (s == 1u ? 1.0f : (s == 2u ? -1.0f : 0.0f));
}

// One neighbour q of a point's pixel: d - d_p·w_out (the point blended
// toward q) + (g·s(q))·w_in (q blended toward the point), where q lies in
// the image; ``k_in`` is the component of q's weights toward the point
__device__ __forceinline__ void transpose_pair(
    const int* __restrict__ aa, const float4* __restrict__ w,
    const unsigned char* __restrict__ code, float g, long long q,
    bool inside, float w_out, int k_in, const float* dp, float* d) {
  if (!inside) return;
  if (w_out != 0.0f) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) d[ch] = d[ch] - dp[ch] * w_out;
  }
  const int aq = __ldg(aa + q);
  if (aq < 0) return;
  const float4 wq = __ldg(w + aq);
  const float w_in = k_in == 0 ? wq.x : (k_in == 1 ? wq.y
                                          : (k_in == 2 ? wq.z : wq.w));
  if (w_in == 0.0f) return;
  const unsigned cq = __ldg(code + q);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) d[ch] = d[ch] + signed_g(g, cq, ch) * w_in;
}

// Backward: a thread a foreground point
__global__ void __launch_bounds__(kThreads)
aa_l1_grad_kernel(const int* __restrict__ aa, const float4* __restrict__ w,
                  const long long* __restrict__ pix,
                  const unsigned char* __restrict__ code,
                  const float* __restrict__ g_ptr, int n_fg, int H, int W,
                  float* __restrict__ d_colors) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_fg) return;
  const float g = __ldg(g_ptr);
  const long long p = __ldg(pix + i);
  const int c = (int)(p % W);
  const int r = (int)((p / W) % H);
  const unsigned cp = __ldg(code + p);
  float dp[3], d[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    dp[ch] = signed_g(g, cp, ch);
    d[ch] = dp[ch];
  }
  const int a = __ldg(aa + p);
  const float4 wp = a >= 0 ? __ldg(w + a) : make_float4(0.f, 0.f, 0.f, 0.f);
  transpose_pair(aa, w, code, g, p + 1, c < W - 1, wp.x, 1, dp, d);
  transpose_pair(aa, w, code, g, p - 1, c > 0, wp.y, 0, dp, d);
  transpose_pair(aa, w, code, g, p + W, r < H - 1, wp.z, 3, dp, d);
  transpose_pair(aa, w, code, g, p - W, r > 0, wp.w, 2, dp, d);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) d_colors[3 * i + ch] = d[ch];
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// The tail's forward over P = n·H·W pixels: colors (n_fg, 3), fg and aa
// (P,) int32, w (n_aa, 4), bg and gt (P, 3) -> code (P,) uint8, shaded
// (P, 3) unless null, partial (ceil(P / 1024),) double scratch, out (1,)
// float the L1 sum
extern "C" int tss_aa_l1_launch(const void* colors, const void* fg,
                                const void* aa, const void* w,
                                const void* bg, const void* gt, int P, int H,
                                int W, void* code, void* shaded,
                                void* partial, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 0 || H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(w, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (P == 0) {
    const cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), s);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  Tail t;
  t.colors = static_cast<const float*>(colors);
  t.fg = static_cast<const int*>(fg);
  t.aa = static_cast<const int*>(aa);
  t.w = static_cast<const float4*>(w);
  t.bg = static_cast<const float*>(bg);
  t.gt = static_cast<const float*>(gt);
  t.P = P;
  t.H = H;
  t.W = W;
  const long long per_block = (long long)kThreads * kPix;
  const unsigned blocks = (unsigned)((P + per_block - 1) / per_block);
  const bool vec = P % kPix == 0 && aligned(fg, 16) && aligned(aa, 16) &&
                   aligned(bg, 16) && aligned(gt, 16) && aligned(code, 4) &&
                   (shaded == nullptr || aligned(shaded, 16));
  unsigned char* cp = static_cast<unsigned char*>(code);
  float* sp = static_cast<float*>(shaded);
  double* pp = static_cast<double*>(partial);
  if (vec)
    aa_l1_kernel<true><<<blocks, kThreads, 0, s>>>(t, cp, sp, pp);
  else
    aa_l1_kernel<false><<<blocks, kThreads, 0, s>>>(t, cp, sp, pp);
  sum_kernel<<<1, kSumThreads, 0, s>>>(pp, (int)blocks,
                                       static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The tail's backward: aa (P,) int32, w (n_aa, 4), pix (n_fg,) int64,
// code (P,) uint8, g (1,) the gradient of the sum -> d_colors (n_fg, 3)
extern "C" int tss_aa_l1_grad_launch(const void* aa, const void* w,
                                     const void* pix, const void* code,
                                     const void* g, int n_fg, int H, int W,
                                     void* d_colors, void* stream) {
  if (n_fg < 0 || H < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(w, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_fg == 0) return static_cast<int>(cudaGetLastError());
  const unsigned blocks = (unsigned)((n_fg + kThreads - 1) / kThreads);
  aa_l1_grad_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(aa), static_cast<const float4*>(w),
      static_cast<const long long*>(pix),
      static_cast<const unsigned char*>(code), static_cast<const float*>(g),
      n_fg, H, W, static_cast<float*>(d_colors));
  return static_cast<int>(cudaGetLastError());
}
