// 3x3x3 stride-1 max pool with zero-padded SAME borders, forward and
// backward, float32 and bfloat16, channels-last (B, T, H, W, C).
//
// Replaces the Pallas TPU kernel ivf_tpu/ops/pallas/maxpool3d.py, function
// pallas_maxpool3d_s1: forward _fwd_kernel (pallas_call in _run_fwd),
// backward _bwd_kernel (pallas_call in _run_bwd). That kernel gridded
// (B, T, C/128), read the t-1 / t / t+1 (H, W, 128) planes into VMEM and
// took a separable 3x3 shift-max per plane; its backward is the exact
// 27-term gather dx[t,h,w] = sum over in-range neighbours n of
// (x[t,h,w] == y[n]) * g[n], which credits every tied maximum.
//
// What bounds it on the H100: bytes. Counting each tensor once, the
// forward moves 8 bytes per element (read x, write y) for 26 max ops and
// the backward 16 (read x, y, g, write dx) for 27 compare-and-adds: far
// below the card's ~20 operations per byte, so the bound is the bytes over
// 3.35 TB/s. The 27 neighbour reads must come from L1/L2, not DRAM.
//
// Design: one thread per output (forward) or input (backward) element in
// a grid-stride loop, with the channel index fastest, so each of a warp's
// 27 neighbour loads is one contiguous 128-byte line and neighbouring
// blocks reuse the same lines through L1/L2. Out-of-range neighbours read
// as 0 in the forward (the zero padding of F.pad + max_pool3d, which the
// reference uses) and are skipped in the backward (their g is 0). NaN
// propagates through the max as in PyTorch's max_pool3d. Not yet done:
// shared-memory tiling of (H, W) planes with a halo, the separable form.
//
// bfloat16: the forward is the same template (the max is exact and the
// scan order F.max_pool3d's, so the bits equal the plain version's). The backward follows the Pallas
// kernel's bfloat16 arithmetic: the tie test on the exact float upcast,
// and the sums rounded to bfloat16 after every add in its order -- per
// frame the centre term, then the 8 spatial neighbours (dh, then dw, each
// -1..1); then frame t + frame t-1, then + frame t+1 -- so a neighbour out
// of range adds +0 as the kernel's zero fill does. Half the bytes of the
// float32 pair, the same bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

struct Geom {
  int b, t, h, w, c;
};

__device__ __forceinline__ long long offset(const Geom& g, int b, int t,
                                            int h, int w, int c) {
  return (((static_cast<long long>(b) * g.t + t) * g.h + h) * g.w + w) * g.c + c;
}

__device__ __forceinline__ void decode(long long i, const Geom& g, int& b,
                                       int& t, int& h, int& w, int& c) {
  c = static_cast<int>(i % g.c);
  long long r = i / g.c;
  w = static_cast<int>(r % g.w);
  r /= g.w;
  h = static_cast<int>(r % g.h);
  r /= g.h;
  t = static_cast<int>(r % g.t);
  b = static_cast<int>(r / g.t);
}

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);  // exact: v is one of the inputs or 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_fwd(const T* __restrict__ x, T* __restrict__ y, Geom g,
         long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int b, t, h, w, c;
    decode(i, g, b, t, h, w, c);
    // F.max_pool3d's scan: from -inf, the window in (t, h, w) order, a
    // value replacing the maximum only when larger (or NaN), so a window of
    // zeros of both signs keeps the sign of its first zero
    float m = -CUDART_INF_F;
    for (int dt = -1; dt <= 1; ++dt) {
      const int tt = t + dt;
      for (int dh = -1; dh <= 1; ++dh) {
        const int hh = h + dh;
        for (int dw = -1; dw <= 1; ++dw) {
          const int ww = w + dw;
          const bool inside = tt >= 0 && tt < g.t && hh >= 0 && hh < g.h &&
                              ww >= 0 && ww < g.w;
          const float v = inside ? load(x, offset(g, b, tt, hh, ww, c)) : 0.f;
          if (v > m || isnan(v)) m = v;
        }
      }
    }
    store(y, i, m);
  }
}

__global__ void __launch_bounds__(kThreads)
pool_bwd(const float* __restrict__ x, const float* __restrict__ y,
         const float* __restrict__ gy, float* __restrict__ dx, Geom g,
         long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int b, t, h, w, c;
    decode(i, g, b, t, h, w, c);
    const float xv = x[i];
    float acc = 0.f;
    for (int dt = -1; dt <= 1; ++dt) {
      const int tt = t + dt;
      if (tt < 0 || tt >= g.t) continue;
      for (int dh = -1; dh <= 1; ++dh) {
        const int hh = h + dh;
        if (hh < 0 || hh >= g.h) continue;
        for (int dw = -1; dw <= 1; ++dw) {
          const int ww = w + dw;
          if (ww < 0 || ww >= g.w) continue;
          const long long j = offset(g, b, tt, hh, ww, c);
          if (y[j] == xv) acc += gy[j];
        }
      }
    }
    dx[i] = acc;
  }
}

// the 9-term sum of one frame dt of the bfloat16 backward (see the header)
__device__ __forceinline__ float frame_sum_bf16(const __nv_bfloat16* __restrict__ y,
                                                const __nv_bfloat16* __restrict__ gy,
                                                const Geom& g, int b, int t, int h,
                                                int w, int c, float xv) {
  float acc = 0.f;
  for (int k = 0; k < 9; ++k) {
    // k = 0 is the centre; then (dh, dw) row by row, the centre skipped
    const int m = k == 0 ? 4 : (k <= 4 ? k - 1 : k);
    const int hh = h + m / 3 - 1;
    const int ww = w + m % 3 - 1;
    float term = 0.f;
    if (hh >= 0 && hh < g.h && ww >= 0 && ww < g.w) {
      const long long j = offset(g, b, t, hh, ww, c);
      if (__bfloat162float(y[j]) == xv) term = __bfloat162float(gy[j]);
    }
    acc = k == 0 ? term : __bfloat162float(__float2bfloat16_rn(acc + term));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
pool_bwd_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
              const __nv_bfloat16* __restrict__ gy, __nv_bfloat16* __restrict__ dx,
              Geom g, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int b, t, h, w, c;
    decode(i, g, b, t, h, w, c);
    const float xv = __bfloat162float(x[i]);
    const float centre = frame_sum_bf16(y, gy, g, b, t, h, w, c, xv);
    const float prev = t > 0 ? frame_sum_bf16(y, gy, g, b, t - 1, h, w, c, xv) : 0.f;
    const float next = t + 1 < g.t ? frame_sum_bf16(y, gy, g, b, t + 1, h, w, c, xv) : 0.f;
    const float acc = __bfloat162float(__float2bfloat16_rn(centre + prev));
    dx[i] = __float2bfloat16_rn(acc + next);
  }
}

int launch_geometry(int b, int t, int h, int w, int c, Geom* g,
                    long long* total, unsigned* blocks) {
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || c <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *g = Geom{b, t, h, w, c};
  *total = static_cast<long long>(b) * t * h * w * c;
  const long long want = (*total + kThreads - 1) / kThreads;
  const long long cap = 1LL << 20;  // grid-stride loop covers the rest
  *blocks = static_cast<unsigned>(want < cap ? want : cap);
  return 0;
}

}  // namespace

// y = maxpool3d_s1(x); x, y contiguous (b, t, h, w, c) float32 on the
// current device. Returns cudaGetLastError() (0 on success).
extern "C" int maxpool3d_s1_fwd_f32(const float* x, float* y, int b, int t,
                                    int h, int w, int c, void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  pool_fwd<float><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, g, total);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 forward: x, y contiguous (b, t, h, w, c) bfloat16.
extern "C" int maxpool3d_s1_fwd_bf16(const void* x, void* y, int b, int t,
                                     int h, int w, int c, void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  pool_fwd<__nv_bfloat16><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), g, total);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 backward (the Pallas kernel's order and rounding, see the
// header); all four tensors contiguous (b, t, h, w, c) bfloat16.
extern "C" int maxpool3d_s1_bwd_bf16(const void* x, const void* y,
                                     const void* gy, void* dx, int b, int t,
                                     int h, int w, int c, void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  pool_bwd_bf16<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(y),
      static_cast<const __nv_bfloat16*>(gy), static_cast<__nv_bfloat16*>(dx), g, total);
  return static_cast<int>(cudaGetLastError());
}

// dx = sum over in-range neighbours n of (x == y[n]) * gy[n]; all four
// tensors contiguous (b, t, h, w, c) float32 on the current device.
extern "C" int maxpool3d_s1_bwd_f32(const float* x, const float* y,
                                    const float* gy, float* dx, int b, int t,
                                    int h, int w, int c, void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  pool_bwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, y, gy, dx, g, total);
  return static_cast<int>(cudaGetLastError());
}
