// 3x3x3 stride-1 zero-padded SAME max pool with the argmax-index backward,
// bfloat16, channels-last (B, T, H, W, C).
//
// Replaces the JAX package's argmax-index pool VJP,
// ivf_tpu/ops/conv.py::_max_pool3d_same_argmax (forward _argmax_pool_core,
// backward _argmax_bwd). That one is plain XLA, not Pallas: a max
// reduce_window over packed uint32 words (the 16 value bits mapped to an
// order-preserving unsigned key, shifted left by 5, or'ed with the
// position's 5-bit window key), which yields the maximum and a uint8 index
// plane of the winning key; the backward adds, for each input, the
// cotangents of the covering windows whose index equals the input's key,
// in key order (kt, kh, kw). Each window sends its whole cotangent to ONE
// element, the largest key among tied maxima.
//
// What bounds it on the H100: bytes. The forward reads x (2 bytes) and
// writes y (2) and the index (1) per element for 27 compare-max ops; the
// backward reads g (2) and the index (1) and writes dx (2) for 27
// compare-adds: a few operations per byte, far below the ridge, so the
// bound is the bytes over 3.35 TB/s. The 27 neighbour reads come from
// L1/L2.
//
// Design: one thread per output (forward) or input (backward) element in
// a grid-stride loop, channel fastest, as in maxpool3d.cu. The packed word
// is 16 + 5 = 21 bits, so it is an int; padding positions enter as +0.0
// with their own keys, exactly as the zero pad of the reference does
// (a padding cell can win a window of negatives, and its share of the
// cotangent is then dropped). The backward accumulates in float and rounds
// to bfloat16 after every add, as the reference's bfloat16 adds do, so
// both directions give the plain version's bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// order-preserving map of the 16 bits to an unsigned key (the radix-sort
// flip): positives above negatives, both monotone
__device__ __forceinline__ int monotone(unsigned bits) {
  return (bits >> 15) == 0 ? static_cast<int>(bits | 0x8000u)
                           : static_cast<int>(~bits & 0xFFFFu);
}

__device__ __forceinline__ unsigned short from_monotone(int u) {
  return static_cast<unsigned short>((u >> 15) == 1 ? (u & 0x7FFF) : (~u & 0xFFFF));
}

__global__ void __launch_bounds__(kThreads)
argmax_fwd(const unsigned short* __restrict__ x, unsigned short* __restrict__ y,
           uint8_t* __restrict__ idx, Geom g, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int b, t, h, w, c;
    decode(i, g, b, t, h, w, c);
    int best = -1;
    // the window of output (t, h, w) covers padded positions t..t+2 (input
    // t-1..t+1); a position's key is its padded coordinate mod 3
    for (int kt = 0; kt < 3; ++kt) {
      const int tt = t + kt - 1;
      const int key_t = ((t + kt) % 3) * 9;
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = h + kh - 1;
        const int key_th = key_t + ((h + kh) % 3) * 3;
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = w + kw - 1;
          const bool inside = tt >= 0 && tt < g.t && hh >= 0 && hh < g.h &&
                              ww >= 0 && ww < g.w;
          const unsigned bits = inside ? x[offset(g, b, tt, hh, ww, c)] : 0u;
          const int packed = (monotone(bits) << 5) | (key_th + (w + kw) % 3);
          best = packed > best ? packed : best;
        }
      }
    }
    y[i] = from_monotone(best >> 5);
    idx[i] = static_cast<uint8_t>(best & 31);
  }
}

__global__ void __launch_bounds__(kThreads)
argmax_bwd(const uint8_t* __restrict__ idx, const __nv_bfloat16* __restrict__ gy,
           __nv_bfloat16* __restrict__ dx, Geom g, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    int b, t, h, w, c;
    decode(i, g, b, t, h, w, c);
    // this input's key in padded coordinates (the low pad is 1 on each axis)
    const int key = ((t + 1) % 3) * 9 + ((h + 1) % 3) * 3 + (w + 1) % 3;
    __nv_bfloat16 acc = __float2bfloat16_rn(0.f);
    // (kt, kh, kw) walks the covering windows t-1..t+1 in the reference's
    // order; a window outside the volume adds 0 * 0, as its zero pad does
    for (int kt = 0; kt < 3; ++kt) {
      const int tt = t + kt - 1;
      for (int kh = 0; kh < 3; ++kh) {
        const int hh = h + kh - 1;
        for (int kw = 0; kw < 3; ++kw) {
          const int ww = w + kw - 1;
          const bool inside = tt >= 0 && tt < g.t && hh >= 0 && hh < g.h &&
                              ww >= 0 && ww < g.w;
          float gv = 0.f;
          int sel = 255;
          if (inside) {
            const long long j = offset(g, b, tt, hh, ww, c);
            gv = __bfloat162float(gy[j]);
            sel = idx[j];
          }
          // g * (sel == key) rounds exactly (x1 or x0, inf * 0 = NaN as in
          // the reference); the add rounds to bfloat16 each time
          const float term = gv * (sel == key ? 1.f : 0.f);
          acc = __float2bfloat16_rn(__bfloat162float(acc) + term);
        }
      }
    }
    dx[i] = acc;
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

// y, idx = argmax pool of x; x, y contiguous (b, t, h, w, c) bfloat16 (as
// raw 16-bit words), idx the same shape in uint8. Returns cudaGetLastError().
extern "C" int argmax_pool_fwd_bf16(const void* x, void* y, void* idx, int b,
                                    int t, int h, int w, int c, void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  argmax_fwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(x), static_cast<unsigned short*>(y),
      static_cast<uint8_t*>(idx), g, total);
  return static_cast<int>(cudaGetLastError());
}

// dx = sum over the windows covering each input, in key order, of
// gy * (idx == key(input)); idx uint8, gy and dx bfloat16, all contiguous
// (b, t, h, w, c). Returns cudaGetLastError().
extern "C" int argmax_pool_bwd_bf16(const void* idx, const void* gy, void* dx,
                                    int b, int t, int h, int w, int c,
                                    void* stream) {
  Geom g;
  long long total;
  unsigned blocks;
  const int rc = launch_geometry(b, t, h, w, c, &g, &total, &blocks);
  if (rc != 0) return rc;
  argmax_bwd<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(idx), static_cast<const __nv_bfloat16*>(gy),
      static_cast<__nv_bfloat16*>(dx), g, total);
  return static_cast<int>(cudaGetLastError());
}
