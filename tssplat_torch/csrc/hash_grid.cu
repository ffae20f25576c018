// K9 — the multi-resolution hash-grid encoding, forward and backward.
//
// Replaces no Pallas kernel: the JAX package evaluates the grid as XLA code
// (tssplat_tpu/models/networks.py _grid_exact, :132). PyTorch would build
// (N,L,8) int64 rows and (N,L,8) weights in some twenty elementwise launches
// a level, gather (N,L,8,F) rows, and in autograd's backward fill and add
// eight full-size select gradients, sort the N·L·8 row keys and
// segment-sum them into the table.
//
// Forward: points x (N,3) and the table (L·H, F) -> features (N, L·F). Per
// (point, level) of resolution r: the lower corner floor(x·r) clamped to
// [0, r-1] and the fraction w = x·r - corner; corner c (bits (c>>2, c>>1,
// c) & 1 on axes 0, 1, 2) reads row (c0·(r+1) + c1)·(r+1) + c2 on a dense
// level, the spatial hash c0 ^ c1·2654435761 ^ c2·805459861 (uint32,
// wrapping) & (H-1) on a hashed one, plus l·H; its weight is (f0·f1)·f2
// with f = w or 1 - w; the eight products are summed from corner 0 in that
// order. Every operation in the order of ops/hash_grid.py grid_exact; built
// with -fmad=false, so the two agree to the bit.
// Backward: the cotangent ct (N, L·F) of the features -> d table (L·H, F),
// w·ct added into each corner's row with float atomics after one memset,
// and, where asked, d x (N,3): per level and axis the corners' dot products
// of row and cotangent times the other two factors, those of the upper
// corners less those of the lower ones, times r; the levels summed
// pairwise in level order across the point's lanes (ops/hash_grid.py
// hash_grid_backward_plain repeats each step).
//
// Bound on the H100: the gathered rows. Forward: x (12 B) and the feature
// row (4·L·F B) stream once a point; the L·8 rows of F floats a point are
// random reads into the table (64 MiB at gso's 16 x 2^19 x 2, nearly all
// of it touched at the cell's 1.28 M points), served mostly by the 50 MB
// L2. Backward: the cotangent row once, and L·8 atomic adds of F floats a
// point into the table gradient (the rows are read again only for d x).
// Design: a lane per (point, level), the levels of a point on neighbouring
// lanes (lanes per point: L rounded up to a power of two), so that a
// point's feature row is one coalesced store and its cotangent row one
// coalesced load; a lane's eight rows are independent loads in flight
// together; d x is summed over the point's lanes with shuffles, with no
// atomics. The table gradient takes float atomics, not the JAX package's
// static hash buckets: the buckets sort the rows once so that the TPU can
// segment-sum without a scatter, where the card adds each product in L2
// as it comes, and the exact cache's per-view raster order puts points
// that share a coarse level's rows on neighbouring lanes and warps. Those
// shared rows contend: before its atomic, each lane adds into the lower
// lane of the same level whose row is equal (a shuffle per point bit of
// the warp), which took the backward from 2.89 to 2.10 ms at the texture
// cell's 1.27 M raster-ordered points and changed nothing on the same
// points shuffled (2.70 ms either way; NVIDIA H100 80GB HBM3, 700 W).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr unsigned kPrime1 = 2654435761u;
constexpr unsigned kPrime2 = 805459861u;
constexpr unsigned kNoRow = 0xffffffffu;

// The levels' resolutions and which levels are dense (bit l), by value
struct Levels {
  int res[kMaxLevels];
  unsigned dense;
};

// A thread's (point, level); ``valid`` is false past the last point and on
// the padding lanes of a point (l >= L)
struct Lane {
  long long p;
  int l;
  bool valid;
};

__device__ inline Lane lane_of(long long N, int L, int lpp_log2) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  Lane u;
  u.p = t >> lpp_log2;
  u.l = (int)(t & ((1 << lpp_log2) - 1));
  u.valid = u.p < N && u.l < L;
  return u;
}

// The level's resolution from shared memory (an indexed parameter array
// would be copied to local memory)
__device__ inline int stage_res(const Levels& lv, int l) {
  __shared__ int s_res[kMaxLevels];
#pragma unroll
  for (int i = 0; i < kMaxLevels; ++i)
    if (threadIdx.x == i) s_res[i] = lv.res[i];
  __syncthreads();
  return s_res[l & (kMaxLevels - 1)];
}

// The eight corners of a lane's cell: rows (with the level's offset) and
// weights, and the factors (1 - w, w) of each axis
struct Cell {
  unsigned row[8];
  float w[8];
  float f[3][2];
};

__device__ inline void cell_of(const float* __restrict__ x, const Lane& u,
                               int r, bool dense, int log2H, Cell& c) {
  int i0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xl = __ldg(x + 3 * u.p + a) * (float)r;
    const float fl = floorf(xl);
    const int i = fl < 0.0f ? 0 : (fl > (float)(r - 1) ? r - 1 : (int)fl);
    const float w = xl - (float)i;
    i0[a] = i;
    c.f[a][0] = 1.0f - w;
    c.f[a][1] = w;
  }
  const unsigned base = (unsigned)u.l << log2H;
  const unsigned mask = (1u << log2H) - 1u;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
    const unsigned c0 = i0[0] + b0, c1 = i0[1] + b1, c2 = i0[2] + b2;
    const unsigned row =
        dense ? (c0 * (unsigned)(r + 1) + c1) * (unsigned)(r + 1) + c2
              : (c0 ^ (c1 * kPrime1) ^ (c2 * kPrime2)) & mask;
    c.row[k] = base + row;
    c.w[k] = (c.f[0][b0] * c.f[1][b1]) * c.f[2][b2];
  }
}

template <int F>
__device__ inline void load_row(const float* __restrict__ p, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(p);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = a.x;
      v[i + 1] = a.y;
      v[i + 2] = a.z;
      v[i + 3] = a.w;
    }
  }
}

template <int F>
__device__ inline void store_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    *p = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  }
}

// sm_90's vector atomics: one request per row of F <= 4 floats
template <int F>
__device__ inline void add_row(float* p, const float (&v)[F]) {
  if constexpr (F == 1) {
    atomicAdd(p, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int i = 0; i < F; i += 4)
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]));
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_grid_kernel(const float* __restrict__ x, const float* __restrict__ table,
                 long long N, int L, int lpp_log2, int log2H, Levels lv,
                 float* __restrict__ out) {
  const Lane u = lane_of(N, L, lpp_log2);
  const int r = stage_res(lv, u.l);
  if (!u.valid) return;
  Cell c;
  cell_of(x, u, r, (lv.dense >> u.l) & 1u, log2H, c);
  float t[8][F];
#pragma unroll
  for (int k = 0; k < 8; ++k) load_row<F>(table + (size_t)c.row[k] * F, t[k]);
  float acc[F];
#pragma unroll
  for (int i = 0; i < F; ++i) acc[i] = t[0][i] * c.w[0];
#pragma unroll
  for (int k = 1; k < 8; ++k)
#pragma unroll
    for (int i = 0; i < F; ++i) acc[i] = acc[i] + t[k][i] * c.w[k];
  store_row<F>(out + (u.p * L + u.l) * F, acc);
}

template <int F>
__global__ void __launch_bounds__(kThreads)
hash_grid_grad_kernel(const float* __restrict__ x,
                      const float* __restrict__ table,
                      const float* __restrict__ ct, long long N, int L,
                      int lpp_log2, int log2H, Levels lv,
                      float* __restrict__ d_table, float* __restrict__ d_x) {
  const Lane u = lane_of(N, L, lpp_log2);
  const int r = stage_res(lv, u.l);
  const int lpp = 1 << lpp_log2;
  float g[F];
  Cell c;
  if (u.valid) {
    load_row<F>(ct + (u.p * L + u.l) * F, g);
    cell_of(x, u, r, (lv.dense >> u.l) & 1u, log2H, c);
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) g[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c.row[k] = kNoRow;
      c.w[k] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) c.f[a][0] = c.f[a][1] = 0.0f;
  }

  if (d_table != nullptr) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      float v[F];
#pragma unroll
      for (int i = 0; i < F; ++i) v[i] = c.w[k] * g[i];
      // the warp's lanes of one level (a lane per point) whose rows are
      // equal add into the lower lane first, pairwise over the point bits
      bool live = u.valid;
      for (int s = lpp; s < 32; s <<= 1) {
        const unsigned other = __shfl_xor_sync(kAll, c.row[k], s);
        const bool olive = __shfl_xor_sync(kAll, live, s);
        float ov[F];
#pragma unroll
        for (int i = 0; i < F; ++i) ov[i] = __shfl_xor_sync(kAll, v[i], s);
        if (other == c.row[k] && live && olive) {
          if (threadIdx.x & s) {
            live = false;
          } else {
#pragma unroll
            for (int i = 0; i < F; ++i) v[i] = v[i] + ov[i];
          }
        }
      }
      if (live) add_row<F>(d_table + (size_t)c.row[k] * F, v);
    }
  }

  if (d_x != nullptr) {
    float pos[3] = {0.0f, 0.0f, 0.0f}, neg[3] = {0.0f, 0.0f, 0.0f};
    if (u.valid) {
      float t[8][F];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        load_row<F>(table + (size_t)c.row[k] * F, t[k]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int b0 = (k >> 2) & 1, b1 = (k >> 1) & 1, b2 = k & 1;
        float dot = t[k][0] * g[0];
#pragma unroll
        for (int i = 1; i < F; ++i) dot = dot + t[k][i] * g[i];
        const float f0 = c.f[0][b0], f1 = c.f[1][b1], f2 = c.f[2][b2];
        const float d0 = (dot * f2) * f1, d1 = (dot * f2) * f0,
                    d2 = dot * (f0 * f1);
        if (b0) pos[0] = pos[0] + d0; else neg[0] = neg[0] + d0;
        if (b1) pos[1] = pos[1] + d1; else neg[1] = neg[1] + d1;
        if (b2) pos[2] = pos[2] + d2; else neg[2] = neg[2] + d2;
      }
    }
    float gx[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) gx[a] = (pos[a] - neg[a]) * (float)r;
    // the point's levels summed pairwise in level order: lane l adds lane
    // l ^ s, lower level first
    for (int s = 1; s < lpp; s <<= 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float o = __shfl_xor_sync(kAll, gx[a], s);
        gx[a] = (u.l & s) ? o + gx[a] : gx[a] + o;
      }
    }
    if (u.valid && u.l == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a) d_x[3 * u.p + a] = gx[a];
    }
  }
}

int lanes_log2(int L) {
  int k = 0;
  while ((1 << k) < L) ++k;
  return k;
}

bool aligned(const void* p, int F) {
  const int a = 4 * (F < 4 ? F : 4);
  return reinterpret_cast<uintptr_t>(p) % a == 0;
}

// Levels from the host array lv_host = (res[0..L-1], dense[0..L-1])
Levels levels_of(const int* lv_host, int L) {
  Levels lv{};
  for (int l = 0; l < L; ++l) {
    lv.res[l] = lv_host[l];
    if (lv_host[L + l]) lv.dense |= 1u << l;
  }
  return lv;
}

unsigned grid_blocks(long long N, int L) {
  const long long threads = N << lanes_log2(L);
  return (unsigned)((threads + kThreads - 1) / kThreads);
}

template <int F>
void launch_fwd(const float* x, const float* table, long long N, int L,
                int log2H, const Levels& lv, float* out, cudaStream_t s) {
  hash_grid_kernel<F><<<grid_blocks(N, L), kThreads, 0, s>>>(
      x, table, N, L, lanes_log2(L), log2H, lv, out);
}

template <int F>
void launch_bwd(const float* x, const float* table, const float* ct,
                long long N, int L, int log2H, const Levels& lv,
                float* d_table, float* d_x, cudaStream_t s) {
  hash_grid_grad_kernel<F><<<grid_blocks(N, L), kThreads, 0, s>>>(
      x, table, ct, N, L, lanes_log2(L), log2H, lv, d_table, d_x);
}

}  // namespace

// x (N,3), table (L << log2H, F), levels lv (2L ints: resolutions, then
// dense flags) -> out (N, L·F); F in {1, 2, 4, 8}, 1 <= L <= 32
extern "C" int tss_hash_grid_launch(const void* x, const void* table, int N,
                                    int L, int F, int log2H, const void* lv,
                                    void* out, void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(table, F) || !aligned(out, F))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const Levels levels = levels_of(static_cast<const int*>(lv), L);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  float* op = static_cast<float*>(out);
  switch (F) {
    case 1: launch_fwd<1>(xp, tp, N, L, log2H, levels, op, s); break;
    case 2: launch_fwd<2>(xp, tp, N, L, log2H, levels, op, s); break;
    case 4: launch_fwd<4>(xp, tp, N, L, log2H, levels, op, s); break;
    case 8: launch_fwd<8>(xp, tp, N, L, log2H, levels, op, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward under ct (N, L·F): d_table (L << log2H, F), zeroed here,
// unless null; d_x (N,3) unless null
extern "C" int tss_hash_grid_grad_launch(const void* x, const void* table,
                                         const void* ct, int N, int L, int F,
                                         int log2H, const void* lv,
                                         void* d_table, void* d_x,
                                         void* stream) {
  if (L < 1 || L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(table, F) || !aligned(ct, F) ||
      (d_table != nullptr && !aligned(d_table, F)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_table != nullptr) {
    const cudaError_t err = cudaMemsetAsync(
        d_table, 0, ((size_t)L << log2H) * F * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N == 0) return static_cast<int>(cudaGetLastError());
  const Levels levels = levels_of(static_cast<const int*>(lv), L);
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  const float* cp = static_cast<const float*>(ct);
  float* dt = static_cast<float*>(d_table);
  float* dx = static_cast<float*>(d_x);
  switch (F) {
    case 1: launch_bwd<1>(xp, tp, cp, N, L, log2H, levels, dt, dx, s); break;
    case 2: launch_bwd<2>(xp, tp, cp, N, L, log2H, levels, dt, dx, s); break;
    case 4: launch_bwd<4>(xp, tp, cp, N, L, log2H, levels, dt, dx, s); break;
    case 8: launch_bwd<8>(xp, tp, cp, N, L, log2H, levels, dt, dx, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
