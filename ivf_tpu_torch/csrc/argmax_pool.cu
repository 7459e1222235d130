// 3x3x3 stride-1 zero-padded SAME max pool with the argmax-index backward,
// bfloat16, channels-last (B, T, H, W, C).
//
// Replaces the JAX package's argmax-index pool VJP,
// ivf_tpu/ops/conv.py::_max_pool3d_same_argmax (forward _argmax_pool_core,
// backward _argmax_bwd). That one is plain XLA, not Pallas: a max
// reduce_window over packed words (the 16 value bits mapped to an
// order-preserving unsigned key, shifted left by 5, or'ed with the
// position's 5-bit window key ((t+1)%3)*9 + ((h+1)%3)*3 + (w+1)%3 in padded
// coordinates), which yields the maximum and a uint8 index plane of the
// winning key; the backward adds, for each input, the cotangents of the
// covering windows whose index equals the input's key, in key order
// (kt, kh, kw), rounding to bfloat16 after every add. Each window sends its
// whole cotangent to ONE element, the largest key among tied maxima.
//
// What bounds it on the H100: bytes. Each direction moves 5 bytes per
// element (forward: x 2, y 2, idx 1; backward: g 2, idx 1, dx 2) for 27
// compares or adds, far below the ridge, so the bound is the bytes over
// 3.35 TB/s. The design keeps every neighbour read on chip and the
// arithmetic per element small enough to stay under that bound.
//
// Tiling (both directions): a block takes all frames of one sample, a tile
// of th x tw positions and a chunk of v channel vectors (VW = 8 channels,
// 16 bytes, in the main instance; VW = 1 in the ragged one, for any C and
// any alignment). One thread owns one (h, w, vector) of the tile and walks
// the sample's frames in order. Frame by frame the block stages the tile
// plus its 1-voxel halo in shared memory, double-buffered: each thread
// loads its share of frame f+2 into registers while frame f is reduced,
// and writes it to shared memory after (one barrier per frame). The host
// plan (ops/kernels/argmax_pool.py::plan) picks the tile. Shorter runs of
// frames a block, each re-staging two halo frames, measured slower at
// every main-path shape, so there are none.
//
// Forward (argmax_fwd). Staging converts each element once into its packed
// int word, the pad's +0.0 (bits 0x0000) with the pad position's own key,
// so a pad cell can win a window of negatives and -0.0 loses to it. An
// integer max is associative and commutative and every position's word is
// fixed, so a separable max gives the 27-way max bit for bit: each thread
// takes the 3x3 (H, W) max of its position in the staged frame (3-input
// integer max, Hopper's DPX), keeps the last two frames' (H, W) maxima in
// registers and emits frame f-1 as the max over the three. y is
// from_monotone(max >> 5), idx is max & 31.
//
// Backward (argmax_bwd). The sum is not separable: its order and its
// roundings are part of the bits. Frames arrive in ascending order, so the
// thread keeps three accumulators (frames f+1, f, f-1 of its position) and
// adds frame f's nine windows to each in (kh, kw) order: element t gets its
// kt = 0 terms at frame t-1, kt = 1 at t and kt = 2 at t+1, so every
// element adds its 27 terms in the reference's (kt, kh, kw) order, and the
// oldest accumulator is then complete and stored (the accumulators of
// frames -1 and T are filled too and never stored). A term is
// fma(g, [idx == key], acc) on bf16x2 pairs, one rounding: g times 1.0 or
// 0.0 is exact (and inf or NaN times 0.0 is NaN, as in the reference), and
// two bfloat16 values add exactly in float unless the smaller is below
// 2^-16 of the larger, where it cannot move the bfloat16 rounding, so one
// correctly rounded bf16 fma equals the reference's float add followed by
// one rounding; subnormals are kept (no flush). The compare runs on bf16x2
// lanes too: the index bytes become the normal numbers 0x3F00 | idx, so
// set.eq.bf16x2 yields the 1.0 / 0.0 mask directly. Positions outside the
// volume stage g = +0 and index 0: their terms are +0, and an accumulator
// that starts at +0 never becomes -0, so adding them changes nothing; the
// frames outside the volume are skipped for that reason.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 224;  // argmax_pool.MAX_THREADS
constexpr int kStageSlots = 2;    // halo vectors a thread stages per frame, at most (argmax_pool.STAGE_SLOTS)
// blocks an SM must hold: caps the registers (65536 / (224 x 4) = 73 in
// the forward, 97 in the backward), since a block's frame steps wait on
// loads and the SM hides that latency with other blocks
constexpr int kFwdMinBlocks = 4, kBwdMinBlocks = 3;

struct Args {
  int t, h, w, c;  // the volume (the sample is blockIdx.y)
  int th, tw, v;   // tile: rows, columns, channel vectors
  int nw, nc;      // tiles along W, channel chunks
};

// where this block sits, and how its halo tile is laid out
struct Tile {
  int b, h0, w0, c0;  // sample, first row, column, channel
  int nhv;            // halo vectors
  long long frame;    // elements per frame
};

template <int VW>
__device__ __forceinline__ Tile tile_of(const Args& a) {
  Tile g;
  int bx = blockIdx.x;
  const int ci = bx % a.nc;
  bx /= a.nc;
  const int wi = bx % a.nw, hi = bx / a.nw;
  g.b = blockIdx.y;
  g.h0 = hi * a.th;
  g.w0 = wi * a.tw;
  g.c0 = ci * a.v * VW;
  g.nhv = (a.th + 2) * (a.tw + 2) * a.v;
  g.frame = static_cast<long long>(a.h) * a.w * a.c;
  return g;
}

// One staged halo vector of a thread: its offset inside a frame, whether it
// lies in the volume, and the (h, w) part of its window key.
struct Slot {
  int off, khw;
  bool in;
};

template <int VW>
__device__ __forceinline__ void make_slots(const Args& a, const Tile& g, Slot (&s)[kStageSlots]) {
#pragma unroll
  for (int k = 0; k < kStageSlots; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    const int v = e % a.v, hp = e / a.v;
    const int hr = hp / (a.tw + 2), wc = hp - hr * (a.tw + 2);
    const int h = g.h0 - 1 + hr, w = g.w0 - 1 + wc, c = g.c0 + v * VW;
    s[k].in = e < g.nhv && h >= 0 && h < a.h && w >= 0 && w < a.w && c < a.c;
    s[k].off = s[k].in ? (h * a.w + w) * a.c + c : 0;
    s[k].khw = ((h + 1) % 3) * 3 + (w + 1) % 3;  // h, w >= -1
  }
}

// 3-input integer max: one DPX instruction on Hopper
__device__ __forceinline__ int max3(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && CUDART_VERSION >= 12000
  return __vimax3_s32(a, b, c);
#else
  return max(a, max(b, c));
#endif
}

// monotone(bits) of two 16-bit lanes at once: bits ^ 0x8000 where the sign
// is clear, ~bits where it is set (the radix-sort flip)
__device__ __forceinline__ uint32_t monotone2(uint32_t bits) {
  const uint32_t s = (bits >> 15) & 0x00010001u;
  return bits ^ (0x80008000u | (s * 0x7FFFu));
}

// from_monotone of two 16-bit lanes: u ^ 0x8000 where the top bit is set,
// u ^ 0xFFFF where it is clear
__device__ __forceinline__ uint32_t from_monotone2(uint32_t u) {
  const uint32_t s = (u >> 15) & 0x00010001u;
  return u ^ 0xFFFFFFFFu ^ (s * 0x7FFFu);
}

// the 1.0 / 0.0 mask of a == b on bfloat16 pairs, and one rounded bf16 fma
__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.bf16x2.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// a thread's VW channels of 16-bit values as (VW + 1) / 2 lane pairs (the
// ragged instance uses the low lane of one pair)
template <int VW>
__device__ __forceinline__ void load16(const uint16_t* p, uint32_t (&r)[(VW + 1) / 2]) {
  if constexpr (VW == 8) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else {
    r[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store16(uint16_t* p, const uint32_t (&r)[(VW + 1) / 2]) {
  if constexpr (VW == 8) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else {
    *p = static_cast<uint16_t>(r[0]);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int VW>
__global__ void __launch_bounds__(kMaxThreads, kFwdMinBlocks)
argmax_fwd(const uint16_t* __restrict__ x, uint16_t* __restrict__ y, uint8_t* __restrict__ idx, Args a) {
  constexpr int NP = (VW + 1) / 2;
  extern __shared__ uint4 smem[];
  const Tile g = tile_of<VW>(a);
  // shared: two frame buffers of packed words; with VW = 8 each buffer is two
  // planes of uint4 (words 0-3, 4-7 of a vector) so that a warp's 16-byte
  // reads fall on consecutive addresses
  int* const words = reinterpret_cast<int*>(smem);
  auto plane = [&](int buf, int q) { return words + (buf * (VW == 8 ? 2 : 1) + q) * g.nhv * (VW == 8 ? 4 : 1); };

  Slot slot[kStageSlots];
  make_slots<VW>(a, g, slot);
  uint32_t raw[kStageSlots][NP];
  const long long sample = static_cast<long long>(g.b) * a.t;

  // frame f's halo vectors into registers (zeros outside the volume: the pad)
  auto load = [&](int f) {
    const bool frame_in = f >= 0 && f < a.t;
    const uint16_t* base = x + (sample + (frame_in ? f : 0)) * g.frame;
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      if (frame_in && slot[k].in) {
        load16<VW>(base + slot[k].off, raw[k]);
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p) raw[k][p] = 0u;
      }
    }
  };
  // ... converted to packed words (monotone(bits) << 5 | key) in buffer buf
  auto stage = [&](int f, int buf) {
    const int kt = ((f + 1) % 3) * 9;  // f >= -1
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e >= g.nhv) continue;
      const uint32_t key = kt + slot[k].khw;
      uint32_t p[2 * NP];
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const uint32_t m = monotone2(raw[k][q]);
        p[2 * q] = ((m & 0xFFFFu) << 5) | key;
        p[2 * q + 1] = ((m >> 16) << 5) | key;
      }
      if constexpr (VW == 8) {
        reinterpret_cast<uint4*>(plane(buf, 0))[e] = make_uint4(p[0], p[1], p[2], p[3]);
        reinterpret_cast<uint4*>(plane(buf, 1))[e] = make_uint4(p[4], p[5], p[6], p[7]);
      } else {
        plane(buf, 0)[e] = static_cast<int>(p[0]);
      }
    }
  };

  // this thread's output position
  const int tid = threadIdx.x;
  const bool active = tid < a.th * a.tw * a.v;
  const int v = tid % a.v, pos = tid / a.v;
  const int ph = pos / a.tw, pw = pos - ph * a.tw;
  const int hh = g.h0 + ph, ww = g.w0 + pw, cc = g.c0 + v * VW;
  const bool out_ok = active && hh < a.h && ww < a.w && cc < a.c;
  const int out_off = out_ok ? (hh * a.w + ww) * a.c + cc : 0;

  // (H, W) maxima of frames f-2 and f-1. The first two steps fill them
  // before any output reads them, yet left uninitialized they gave wrong
  // outputs on the card (and not in a CPU emulation); zeroed, the fault went
  // away. Its cause was not found: initialize every register array the loop
  // carries.
  int r0[VW] = {}, r1[VW] = {};
  const int steps = a.t + 2;  // input frames -1 .. t
  load(-1);
  stage(-1, 0);
  load(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int f = s - 1;
    if (active) {
      int cur[VW];
      int rows[3][VW];  // the max over W of rows h-1, h, h+1
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        int row[3][VW];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int e = ((ph + kh) * (a.tw + 2) + pw + kw) * a.v + v;
          if constexpr (VW == 8) {
            const uint4 lo = reinterpret_cast<const uint4*>(plane(s & 1, 0))[e];
            const uint4 hi = reinterpret_cast<const uint4*>(plane(s & 1, 1))[e];
            row[kw][0] = lo.x, row[kw][1] = lo.y, row[kw][2] = lo.z, row[kw][3] = lo.w;
            row[kw][4] = hi.x, row[kw][5] = hi.y, row[kw][6] = hi.z, row[kw][7] = hi.w;
          } else {
            row[kw][0] = plane(s & 1, 0)[e];
          }
        }
#pragma unroll
        for (int i = 0; i < VW; ++i) rows[kh][i] = max3(row[0][i], row[1][i], row[2][i]);
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) cur[i] = max3(rows[0][i], rows[1][i], rows[2][i]);
      if (s >= 2 && out_ok) {
        const long long o = (sample + f - 1) * g.frame + out_off;
        int best[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) best[i] = max3(r0[i], r1[i], cur[i]);
        uint32_t yb[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          const uint32_t u0 = static_cast<uint32_t>(best[2 * q]) >> 5;
          const uint32_t u1 = 2 * q + 1 < VW ? static_cast<uint32_t>(best[2 * q + 1]) >> 5 : 0u;
          yb[q] = from_monotone2(u0 | (u1 << 16));
        }
        store16<VW>(y + o, yb);
        if constexpr (VW == 8) {
          uint32_t lo = 0, hi = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            lo |= (static_cast<uint32_t>(best[i]) & 31u) << (8 * i);
            hi |= (static_cast<uint32_t>(best[i + 4]) & 31u) << (8 * i);
          }
          *reinterpret_cast<uint2*>(idx + o) = make_uint2(lo, hi);
        } else {
          idx[o] = static_cast<uint8_t>(best[0] & 31);
        }
      }
#pragma unroll
      for (int i = 0; i < VW; ++i) {
        r0[i] = r1[i];
        r1[i] = cur[i];
      }
    }
    if (s + 1 < steps) stage(f + 1, (s + 1) & 1);
    if (s + 2 < steps) load(f + 2);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <int VW>
__global__ void __launch_bounds__(kMaxThreads, kBwdMinBlocks)
argmax_bwd(const uint8_t* __restrict__ idx, const uint16_t* __restrict__ gy, uint16_t* __restrict__ dx, Args a) {
  constexpr int NP = (VW + 1) / 2;
  extern __shared__ uint4 smem[];
  const Tile g = tile_of<VW>(a);
  // shared: two frame buffers of g (VW bf16 a vector), then two of idx (VW bytes)
  uint16_t* const gbuf = reinterpret_cast<uint16_t*>(smem);
  uint8_t* const ibuf = reinterpret_cast<uint8_t*>(gbuf + 2 * g.nhv * VW);

  Slot slot[kStageSlots];
  make_slots<VW>(a, g, slot);
  uint32_t graw[kStageSlots][NP];
  uint32_t iraw[kStageSlots][VW == 8 ? 2 : 1];
  const long long sample = static_cast<long long>(g.b) * a.t;

  auto load = [&](int f) {  // f inside the volume
    const long long base = (sample + f) * g.frame;
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      if (slot[k].in) {
        load16<VW>(gy + base + slot[k].off, graw[k]);
        if constexpr (VW == 8) {
          const uint2 q = __ldg(reinterpret_cast<const uint2*>(idx + base + slot[k].off));
          iraw[k][0] = q.x;
          iraw[k][1] = q.y;
        } else {
          iraw[k][0] = __ldg(idx + base + slot[k].off);
        }
      } else {
#pragma unroll
        for (int p = 0; p < NP; ++p) graw[k][p] = 0u;
#pragma unroll
        for (int p = 0; p < (VW == 8 ? 2 : 1); ++p) iraw[k][p] = 0u;
      }
    }
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e >= g.nhv) continue;
      const int i = buf * g.nhv + e;
      if constexpr (VW == 8) {
        reinterpret_cast<uint4*>(gbuf)[i] = make_uint4(graw[k][0], graw[k][1], graw[k][2], graw[k][3]);
        reinterpret_cast<uint2*>(ibuf)[i] = make_uint2(iraw[k][0], iraw[k][1]);
      } else {
        gbuf[i] = static_cast<uint16_t>(graw[k][0]);
        ibuf[i] = static_cast<uint8_t>(iraw[k][0]);
      }
    }
  };

  const int tid = threadIdx.x;
  const bool active = tid < a.th * a.tw * a.v;
  const int v = tid % a.v, pos = tid / a.v;
  const int ph = pos / a.tw, pw = pos - ph * a.tw;
  const int hh = g.h0 + ph, ww = g.w0 + pw, cc = g.c0 + v * VW;
  const bool out_ok = active && hh < a.h && ww < a.w && cc < a.c;
  const int out_off = out_ok ? (hh * a.w + ww) * a.c + cc : 0;
  const int khw = ((hh + 1) % 3) * 3 + (ww + 1) % 3;
  // this position's key in frame e, as a bf16 pair of 0x3F00 | key
  auto key2 = [&](int e) { return (0x3F00u | static_cast<uint32_t>(((e + 1) % 3) * 9 + khw)) * 0x00010001u; };

  // accumulators of frames f+1, f, f-1 (bf16 pairs), all starting at +0
  uint32_t nxt[NP], cur[NP], prv[NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) nxt[p] = cur[p] = prv[p] = 0u;
  auto store = [&](int e, const uint32_t (&acc)[NP]) {
    if (out_ok && e >= 0) store16<VW>(dx + (sample + e) * g.frame + out_off, acc);
  };

  // the window frames inside the volume: the others' terms are +0
  const int steps = a.t;
  load(0);
  stage(0);
  if (steps > 1) load(1);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int f = s;
    if (active) {
      const uint32_t kn = key2(f + 1), kc = key2(f), kp = key2(f - 1);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int e = (s & 1) * g.nhv + ((ph + kh) * (a.tw + 2) + pw + kw) * a.v + v;
          uint32_t gv[NP], il[NP];
          if constexpr (VW == 8) {
            const uint4 q = reinterpret_cast<const uint4*>(gbuf)[e];
            const uint2 ib = reinterpret_cast<const uint2*>(ibuf)[e];
            gv[0] = q.x, gv[1] = q.y, gv[2] = q.z, gv[3] = q.w;
            // index bytes into bf16 lanes 0x3F00 | idx (normal numbers)
            il[0] = __byte_perm(ib.x, 0x3F3F3F3Fu, 0x4140);
            il[1] = __byte_perm(ib.x, 0x3F3F3F3Fu, 0x4342);
            il[2] = __byte_perm(ib.y, 0x3F3F3F3Fu, 0x4140);
            il[3] = __byte_perm(ib.y, 0x3F3F3F3Fu, 0x4342);
          } else {
            gv[0] = gbuf[e];
            il[0] = 0x3F00u | ibuf[e];
          }
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            nxt[p] = fma_bf16x2(gv[p], eq_bf16x2(il[p], kn), nxt[p]);  // kt = 0 of frame f+1
            cur[p] = fma_bf16x2(gv[p], eq_bf16x2(il[p], kc), cur[p]);  // kt = 1 of frame f
            prv[p] = fma_bf16x2(gv[p], eq_bf16x2(il[p], kp), prv[p]);  // kt = 2 of frame f-1
          }
        }
      }
      store(f - 1, prv);  // frame f-1 has all its 27 terms
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        prv[p] = cur[p];
        cur[p] = nxt[p];
        nxt[p] = 0u;
      }
    }
    if (s + 1 < steps) stage((s + 1) & 1);
    if (s + 2 < steps) load(f + 2);
    __syncthreads();
  }
  // the last frame: its later windows lie outside the volume
  if (active) store(a.t - 1, prv);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Launch {
  Args a;
  dim3 grid;
  int threads, nhv;
};

int plan_launch(int b, int t, int h, int w, int c, int vw, int v, int th, int tw, int threads, Launch* out) {
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || c <= 0 || v <= 0 || th <= 0 || tw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((vw != 8 && vw != 1) || (vw == 8 && c % 8 != 0)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(h) * w * c > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long nhv = static_cast<long long>(th + 2) * (tw + 2) * v;
  if (threads % 32 != 0 || threads > kMaxThreads || threads < th * tw * v || nhv > kStageSlots * threads) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const long long nh = (h + th - 1) / th, nw = (w + tw - 1) / tw, nc = (c / vw + v - 1) / v;
  if (nh * nw * nc > 0x7FFFFFFFLL || b > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  out->a = Args{t, h, w, c, th, tw, v, static_cast<int>(nw), static_cast<int>(nc)};
  out->grid = dim3(static_cast<unsigned>(nh * nw * nc), static_cast<unsigned>(b));
  out->threads = threads;
  out->nhv = static_cast<int>(nhv);
  return 0;
}

// dynamic shared memory above the default 48 KB needs the kernel's consent
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace

// y, idx = argmax pool of x; x, y contiguous (b, t, h, w, c) bfloat16 (as
// raw 16-bit words), idx the same shape in uint8. The tile (vw channels a
// thread, v vectors, th x tw positions, `threads` threads a block) comes
// from the host plan; vw = 8 needs c % 8 == 0 and 16-byte
// aligned x and y, 8-byte aligned idx. Returns a CUDA error code (0: launched).
extern "C" int argmax_pool_fwd_bf16(const void* x, void* y, void* idx, int b, int t, int h, int w, int c,
                                    int vw, int v, int th, int tw, int threads, void* stream) {
  Launch l;
  const int rc = plan_launch(b, t, h, w, c, vw, v, th, tw, threads, &l);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(2) * l.nhv * vw * 4;
  const auto* xs = static_cast<const uint16_t*>(x);
  auto* ys = static_cast<uint16_t*>(y);
  auto* is = static_cast<uint8_t*>(idx);
  if (vw == 8) {
    if (!aligned(x, 16) || !aligned(y, 16) || !aligned(idx, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
    const int e = allow_smem(argmax_fwd<8>, smem);
    if (e != 0) return e;
    argmax_fwd<8><<<l.grid, l.threads, smem, st>>>(xs, ys, is, l.a);
  } else {
    const int e = allow_smem(argmax_fwd<1>, smem);
    if (e != 0) return e;
    argmax_fwd<1><<<l.grid, l.threads, smem, st>>>(xs, ys, is, l.a);
  }
  return static_cast<int>(cudaGetLastError());
}

// dx = sum over the windows covering each input, in key order, of
// gy * (idx == key(input)), rounded to bfloat16 after every add; idx uint8,
// gy and dx bfloat16, all contiguous (b, t, h, w, c); the tile as for the
// forward (vw = 8: 16-byte aligned gy and dx, 8-byte aligned idx). Returns
// a CUDA error code (0: launched).
extern "C" int argmax_pool_bwd_bf16(const void* idx, const void* gy, void* dx, int b, int t, int h, int w,
                                    int c, int vw, int v, int th, int tw, int threads, void* stream) {
  Launch l;
  const int rc = plan_launch(b, t, h, w, c, vw, v, th, tw, threads, &l);
  if (rc != 0) return rc;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(2) * l.nhv * vw * 3;
  const auto* is = static_cast<const uint8_t*>(idx);
  const auto* gs = static_cast<const uint16_t*>(gy);
  auto* ds = static_cast<uint16_t*>(dx);
  if (vw == 8) {
    if (!aligned(gy, 16) || !aligned(dx, 16) || !aligned(idx, 8)) return static_cast<int>(cudaErrorMisalignedAddress);
    const int e = allow_smem(argmax_bwd<8>, smem);
    if (e != 0) return e;
    argmax_bwd<8><<<l.grid, l.threads, smem, st>>>(is, gs, ds, l.a);
  } else {
    const int e = allow_smem(argmax_bwd<1>, smem);
    if (e != 0) return e;
    argmax_bwd<1><<<l.grid, l.threads, smem, st>>>(is, gs, ds, l.a);
  }
  return static_cast<int>(cudaGetLastError());
}
