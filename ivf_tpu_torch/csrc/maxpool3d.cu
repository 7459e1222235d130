// 3x3x3 stride-1 max pool with zero-padded SAME borders, forward and the
// every-tie backward, float32 and bfloat16, channels-last (B, T, H, W, C).
//
// Replaces the Pallas TPU kernel ivf_tpu/ops/pallas/maxpool3d.py, function
// pallas_maxpool3d_s1: forward _fwd_kernel (pallas_call in _run_fwd),
// backward _bwd_kernel (pallas_call in _run_bwd). That kernel gridded
// (B, T, C/128), read the t-1 / t / t+1 (H, W, 128) planes into VMEM and
// took a separable 3x3 shift-max per plane (_hw_max9); its backward is the
// exact 27-term gather dx[t,h,w] = sum over the neighbours n of
// (x[t,h,w] == y[n]) ? g[n] : 0, which credits every tied maximum.
//
// What bounds it on the H100: bytes. Counting each tensor once, the
// forward moves 2 x dtype bytes an element (read x, write y) for 26
// compares and the backward 4 x dtype bytes (read x, y, g, write dx) for
// 27 compare-and-adds: far below the card's ~20 operations per byte, so
// the bound is the bytes over 3.35 TB/s. The design reads each tensor from
// device memory once and takes every neighbour from shared memory.
//
// Tiling (both directions; csrc/staged_pool.cuh, shared with the argmax
// pair of csrc/argmax_pool.cu): a block takes all frames of one sample, a
// tile of th x tw positions and a chunk of v channel vectors (VW channels
// a thread: 16 bytes, 4 float32 or 8 bfloat16, in the main instance; VW =
// 1 in the ragged one, for any C and any alignment). One thread owns one (h, w, vector) of the tile and walks
// the sample's frames in order. Frame by frame the block stages the tile
// plus its one-voxel halo in shared memory, double-buffered: each thread
// loads its share of frame f+2 into registers while frame f is reduced and
// writes it to shared memory after (one barrier a frame). Positions outside
// the volume stage +0.0, the zero pad. The host plan
// (ops/kernels/maxpool3d.py::plan) picks the tile.
//
// Forward (pool_fwd). F.max_pool3d scans a window from -inf in (t, h, w)
// order and takes a value when it is larger than the maximum so far or NaN
// (sel below): the result is the last NaN of the window if there is one,
// else the FIRST element equal to the maximum (a window of zeros of both
// signs keeps its first zero's sign). Split the window into consecutive
// runs of that order -- a row of 3 (fixed t, h), the 3 rows of a frame,
// the 3 frames -- and scan each run's results with the same sel in the same
// order: the last NaN lies in the last run holding a NaN, and that run's
// result is it, and a later run's non-NaN result does not replace a NaN;
// without NaN, the first run holding the maximum gives its first maximum,
// and later runs' equal results do not replace it. So the separable scan
// selects the same element, bit for bit. Not fmaxf, which drops NaN and
// may pick either zero. Each thread takes the W then the H scan of its
// position in the staged frame, keeps the last two frames' results in
// registers and emits frame f-1 as the scan of frames f-2, f-1, f (frame
// -1 and frame T are the pad, +0.0). bfloat16 runs two channels at once on
// bf16x2 compares of the exact values (sel), and stores the selected bits.
//
// Backward, float32 (pool_bwd). Output t adds its 27 terms in (dt, dh, dw)
// order. Frames arrive in ascending order, so a thread keeps x of frames
// f+1, f, f-1 of its position (read directly, no halo) and three
// accumulators, and adds frame f's nine (y, g) neighbours, in (dh, dw)
// order, to each: frame f is dt = -1 of output f+1, dt = 0 of f and dt = +1
// of f-1, so each output keeps its order; output f-1 is then complete and
// stored. A term is a select, not a multiply: an inf or NaN cotangent at an
// unselected neighbour adds nothing. The accumulators start at +0 and
// never become -0, so the +0 terms of the pad (staged y = g = 0) and of
// the frames outside the volume change nothing and those frames are
// skipped. The fused branch 3 (csrc/fused_branch3.cu) adds in this order
// too, and its float32 dx is held bit-equal to this kernel's.
//
// Backward, bfloat16 (pool_bwd<bf16>): the Pallas kernel's order and
// rounding. Per frame the sum S_f starts at the centre term and adds the 8
// spatial neighbours in (dh, dw) order, rounded to bfloat16 after every
// add; then dx[t] = ((S_t + S_{t-1}) + S_{t+1}), rounded after each add,
// a missing frame adding +0 (which turns a -0 sum into +0, so it is added,
// not skipped). At frame f a thread forms S_f for x[f+1], x[f] and x[f-1]:
// the first is kept, the second is added to the kept one of the step
// before, the third completes dx[f-1]. The tie test compares the exact
// values (set.eq on bf16x2, so -0 == +0 and NaN != NaN) and masks g with
// it; an add is one fma.rn.bf16x2 by 1.0: the exact sum rounded once, which
// is the float add plus one rounding of the plain version (two bfloat16
// values add exactly in float unless the smaller is below 2^-16 of the
// larger, where it cannot move the rounding), subnormals kept.
//
// No atomics: every output is written once by one thread, in a fixed
// order, so the bits repeat from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "staged_pool.cuh"

namespace {

// blocks an SM must hold: caps the registers (65536 / (224 x 5) = 58 in
// the forward, 97 in the backward), since a block's frame steps wait on
// loads and the SM hides that latency with other blocks. On the H100
// these were the fastest at 128 clips of a sweep of forward 2-6 and
// backward 2-4 (`chip_smoke.py --pool-sweep` times each pair; PERF.md
// keeps the readings); a backward cap of 4 spills and is slower in
// bfloat16, and at 4 clips in float32.
constexpr int kFwdMinBlocks = 5, kBwdMinBlocks = 3;

// A thread's VW channels of element type E (uint32_t: float32 bits;
// uint16_t: bfloat16 bits) as NW 32-bit words: one 16-byte access in the
// main instance, one element (in the low half for bfloat16) in the ragged.
template <typename E, int VW>
struct Vec {
  static constexpr bool kBf16 = sizeof(E) == 2;
  static constexpr int NW = kBf16 ? (VW + 1) / 2 : VW;
  static_assert(VW == 1 || NW == 4, "16-byte vectors or single elements");
  uint32_t w[NW];
};

template <typename E, int VW>
__device__ __forceinline__ void zero(Vec<E, VW>& r) {
#pragma unroll
  for (int i = 0; i < Vec<E, VW>::NW; ++i) r.w[i] = 0u;
}

template <typename E, int VW>
__device__ __forceinline__ void gload(const E* p, Vec<E, VW>& r) {
  if constexpr (Vec<E, VW>::NW == 4) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = q.x, r.w[1] = q.y, r.w[2] = q.z, r.w[3] = q.w;
  } else {
    r.w[0] = __ldg(p);
  }
}

template <typename E, int VW>
__device__ __forceinline__ void gstore(E* p, const Vec<E, VW>& r) {
  if constexpr (Vec<E, VW>::NW == 4) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
    *p = static_cast<E>(r.w[0]);
  }
}

// shared memory: a buffer of n staged vectors, 16 bytes or 4 bytes each
template <typename E, int VW>
__device__ __forceinline__ void sstore(uint32_t* buf, int e, const Vec<E, VW>& r) {
  if constexpr (Vec<E, VW>::NW == 4) {
    reinterpret_cast<uint4*>(buf)[e] = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
    buf[e] = r.w[0];
  }
}

template <typename E, int VW>
__device__ __forceinline__ void sload(const uint32_t* buf, int e, Vec<E, VW>& r) {
  if constexpr (Vec<E, VW>::NW == 4) {
    const uint4 q = reinterpret_cast<const uint4*>(buf)[e];
    r.w[0] = q.x, r.w[1] = q.y, r.w[2] = q.z, r.w[3] = q.w;
  } else {
    r.w[0] = buf[e];
  }
}

// one step of F.max_pool3d's scan on a word of a vector: v replaces m when
// larger or NaN. float32: one value. bfloat16: two lanes at once, by
// set.gt (ordered: false if either is NaN) or set.nan on bf16x2, which
// compare exact values (-0 == +0, subnormals kept) as the float32 upcast
// does; each true lane of the mask is 0xFFFF.
template <bool BF16>
__device__ __forceinline__ uint32_t sel(uint32_t m, uint32_t v) {
  if constexpr (BF16) {
    uint32_t gt, nan;
    asm("set.gt.u32.bf16x2 %0, %1, %2;" : "=r"(gt) : "r"(v), "r"(m));
    asm("set.nan.u32.bf16x2 %0, %1, %1;" : "=r"(nan) : "r"(v));
    const uint32_t take = gt | nan;
    return (v & take) | (m & ~take);
  } else {
    const float fm = __uint_as_float(m), fv = __uint_as_float(v);
    return (fv > fm || fv != fv) ? v : m;
  }
}

// a thread's staged halo vectors: offset inside a frame, -1 outside the volume
template <int VW>
__device__ __forceinline__ void make_slots(const Args& a, const Tile& g, int (&off)[kStageSlots]) {
#pragma unroll
  for (int k = 0; k < kStageSlots; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    const int v = e % a.v, hp = e / a.v;
    const int hr = hp / (a.tw + 2), wc = hp - hr * (a.tw + 2);
    const int h = g.h0 - 1 + hr, w = g.w0 - 1 + wc, c = g.c0 + v * VW;
    const bool in = e < g.nhv && h >= 0 && h < a.h && w >= 0 && w < a.w && c < a.c;
    off[k] = in ? (h * a.w + w) * a.c + c : -1;
  }
}

// the thread's own (h, w, vector) of the tile
struct Own {
  bool active;  // computes a position of the tile
  bool out_ok;  // ... that lies in the volume
  int ph, pw, v, off;
};

template <int VW>
__device__ __forceinline__ Own own_of(const Args& a, const Tile& g) {
  Own o;
  const int tid = threadIdx.x;
  o.active = tid < a.th * a.tw * a.v;
  o.v = tid % a.v;
  const int pos = tid / a.v;
  o.ph = pos / a.tw;
  o.pw = pos - o.ph * a.tw;
  const int hh = g.h0 + o.ph, ww = g.w0 + o.pw, cc = g.c0 + o.v * VW;
  o.out_ok = o.active && hh < a.h && ww < a.w && cc < a.c;
  o.off = o.out_ok ? (hh * a.w + ww) * a.c + cc : 0;
  return o;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <typename E, int VW>
__global__ void __launch_bounds__(kMaxThreads, kFwdMinBlocks)
pool_fwd(const E* __restrict__ x, E* __restrict__ y, Args a) {
  using V = Vec<E, VW>;
  extern __shared__ uint4 smem[];
  const Tile g = tile_of<VW>(a);
  const Own o = own_of<VW>(a, g);
  // two frame buffers of nhv vectors (V::NW words each)
  uint32_t* const buf0 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* const buf1 = buf0 + g.nhv * V::NW;

  int off[kStageSlots];
  make_slots<VW>(a, g, off);
  V raw[kStageSlots];
  const long long sample = static_cast<long long>(g.b) * a.t;

  auto load = [&](int f) {  // f inside the volume; zeros outside the frame: the pad
    const E* base = x + (sample + f) * g.frame;
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      if (off[k] >= 0) {
        gload(base + off[k], raw[k]);
      } else {
        zero(raw[k]);
      }
    }
  };
  auto stage = [&](uint32_t* buf) {
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < g.nhv) sstore(buf, e, raw[k]);
    }
  };

  // the (H, W) scans of frames f-2 and f-1 (words of vectors); frame -1 is
  // the pad. Every register array the loop carries starts initialized (an
  // uninitialized ring gave wrong outputs on the card in the argmax pair).
  constexpr int NW = V::NW;
  uint32_t r0[NW], r1[NW];
#pragma unroll
  for (int q = 0; q < NW; ++q) r0[q] = r1[q] = 0u;
  auto emit = [&](int f, const uint32_t (&cur)[NW]) {  // output frame f-1
    if (!o.out_ok) return;
    V out;
#pragma unroll
    for (int q = 0; q < NW; ++q) out.w[q] = sel<V::kBf16>(sel<V::kBf16>(r0[q], r1[q]), cur[q]);
    gstore(y + (sample + f - 1) * g.frame + o.off, out);
  };

  load(0);
  stage(buf0);
  if (a.t > 1) load(1);
  __syncthreads();
  for (int f = 0; f < a.t; ++f) {
    if (o.active) {
      const uint32_t* buf = (f & 1) ? buf1 : buf0;
      uint32_t cur[NW];
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        V n[3];
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) sload(buf, ((o.ph + kh) * (a.tw + 2) + o.pw + kw) * a.v + o.v, n[kw]);
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const uint32_t row = sel<V::kBf16>(sel<V::kBf16>(n[0].w[q], n[1].w[q]), n[2].w[q]);  // w-1, w, w+1
          cur[q] = kh == 0 ? row : sel<V::kBf16>(cur[q], row);                               // h-1, h, h+1
        }
      }
      if (f >= 1) emit(f, cur);
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        r0[q] = r1[q];
        r1[q] = cur[q];
      }
    }
    if (f + 1 < a.t) stage((f + 1) & 1 ? buf1 : buf0);
    if (f + 2 < a.t) load(f + 2);
    __syncthreads();
  }
  // frame T is the pad
  const uint32_t pad[NW] = {};
  if (o.active) emit(a.t, pad);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// the all-ones / all-zeros mask of a == b on bfloat16 pairs (exact values:
// -0 == +0, NaN != NaN), and one rounded bf16 fma
__device__ __forceinline__ uint32_t eq_mask_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("set.eq.u32.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

constexpr uint32_t kOneBf16x2 = 0x3F803F80u;

// round(a + b) on bfloat16 pairs: the exact sum rounded once
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) { return fma_bf16x2(a, kOneBf16x2, b); }

// The nine (dh, dw) neighbours of a thread's position in a staged frame,
// the bfloat16 order: the centre first, then the others row by row.
__device__ __forceinline__ int bf16_neighbour(int k) { return k == 0 ? 4 : (k <= 4 ? k - 1 : k); }

template <typename E, int VW>
__global__ void __launch_bounds__(kMaxThreads, kBwdMinBlocks)
pool_bwd(const E* __restrict__ x, const E* __restrict__ y, const E* __restrict__ gy, E* __restrict__ dx, Args a) {
  using V = Vec<E, VW>;
  constexpr bool kBf16 = V::kBf16;
  extern __shared__ uint4 smem[];
  const Tile g = tile_of<VW>(a);
  const Own o = own_of<VW>(a, g);
  // two frame buffers, each nhv vectors of y then nhv of g
  uint32_t* const base_s = reinterpret_cast<uint32_t*>(smem);
  const int plane = g.nhv * V::NW;
  auto ybuf = [&](int f) { return base_s + (f & 1) * 2 * plane; };
  auto gbuf = [&](int f) { return base_s + (f & 1) * 2 * plane + plane; };

  int off[kStageSlots];
  make_slots<VW>(a, g, off);
  V yraw[kStageSlots], graw[kStageSlots];
  const long long sample = static_cast<long long>(g.b) * a.t;

  auto load = [&](int f) {
    const long long base = (sample + f) * g.frame;
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      if (off[k] >= 0) {
        gload(y + base + off[k], yraw[k]);
        gload(gy + base + off[k], graw[k]);
      } else {
        zero(yraw[k]);
        zero(graw[k]);
      }
    }
  };
  auto stage = [&](int f) {
#pragma unroll
    for (int k = 0; k < kStageSlots; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < g.nhv) {
        sstore(ybuf(f), e, yraw[k]);
        sstore(gbuf(f), e, graw[k]);
      }
    }
  };
  auto load_x = [&](int f, V& r) {
    if (o.out_ok && f < a.t) {
      gload(x + (sample + f) * g.frame + o.off, r);
    } else {
      zero(r);
    }
  };
  auto store = [&](int f, const V& r) {
    if (o.out_ok) gstore(dx + (sample + f) * g.frame + o.off, r);
  };

  // x of frames f-1, f, f+1 and f+2 (loaded a step ahead), and the running
  // sums: float32, the three outputs' accumulators; bfloat16, the kept S_f
  // of x[f+1] and (S_f + S_{f-1}) of x[f]. All start at +0.
  V xm, xc, xp, xn, acc_m, acc_c, acc_p;
  zero(xm), zero(acc_m), zero(acc_c), zero(acc_p);
  load_x(0, xc);
  load_x(1, xp);
  load_x(2, xn);

  load(0);
  stage(0);
  if (a.t > 1) load(1);
  __syncthreads();
  for (int f = 0; f < a.t; ++f) {
    const bool has_next = f + 1 < a.t, has_prev = f >= 1;
    if (o.active) {
      const uint32_t* ys = ybuf(f);
      const uint32_t* gs = gbuf(f);
      if constexpr (!kBf16) {
#pragma unroll
        for (int m = 0; m < 9; ++m) {  // (dh, dw) order
          const int e = ((o.ph + m / 3) * (a.tw + 2) + o.pw + m % 3) * a.v + o.v;
          V yv, gv;
          sload(ys, e, yv);
          sload(gs, e, gv);
#pragma unroll
          for (int i = 0; i < VW; ++i) {
            const float yi = __uint_as_float(yv.w[i]), gi = __uint_as_float(gv.w[i]);
            float p = __uint_as_float(acc_p.w[i]), c = __uint_as_float(acc_c.w[i]),
                  mm = __uint_as_float(acc_m.w[i]);
            if (has_next && __uint_as_float(xp.w[i]) == yi) p += gi;  // dt = -1 of output f+1
            if (__uint_as_float(xc.w[i]) == yi) c += gi;              // dt =  0 of output f
            if (has_prev && __uint_as_float(xm.w[i]) == yi) mm += gi; // dt = +1 of output f-1
            acc_p.w[i] = __float_as_uint(p), acc_c.w[i] = __float_as_uint(c), acc_m.w[i] = __float_as_uint(mm);
          }
        }
        if (has_prev) store(f - 1, acc_m);  // all 27 terms of output f-1
        acc_m = acc_c;
        acc_c = acc_p;
        zero(acc_p);
      } else {
        // S_f of x[f+1], x[f], x[f-1]: centre first, rounded after every add
        V sp, sc, sm;
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          const int m = bf16_neighbour(k);
          const int e = ((o.ph + m / 3) * (a.tw + 2) + o.pw + m % 3) * a.v + o.v;
          V yv, gv;
          sload(ys, e, yv);
          sload(gs, e, gv);
#pragma unroll
          for (int q = 0; q < V::NW; ++q) {
            const uint32_t tp = gv.w[q] & eq_mask_bf16x2(xp.w[q], yv.w[q]);
            const uint32_t tc = gv.w[q] & eq_mask_bf16x2(xc.w[q], yv.w[q]);
            const uint32_t tm = gv.w[q] & eq_mask_bf16x2(xm.w[q], yv.w[q]);
            sp.w[q] = k == 0 ? tp : add_bf16x2(tp, sp.w[q]);
            sc.w[q] = k == 0 ? tc : add_bf16x2(tc, sc.w[q]);
            sm.w[q] = k == 0 ? tm : add_bf16x2(tm, sm.w[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < V::NW; ++q) {
          // x[f-1]: ((S_{f-1} + S_{f-2}) + S_f), complete
          if (has_prev) acc_m.w[q] = add_bf16x2(sm.w[q], acc_c.w[q]);
          // x[f]: S_f + S_{f-1} (S_{-1} = +0, added all the same)
          acc_c.w[q] = add_bf16x2(sc.w[q], acc_p.w[q]);
          // x[f+1]: S_f, kept
          acc_p.w[q] = sp.w[q];
        }
        if (has_prev) store(f - 1, acc_m);
      }
    }
    xm = xc;
    xc = xp;
    xp = xn;
    load_x(f + 3, xn);
    if (has_next) stage(f + 1);
    if (f + 2 < a.t) load(f + 2);
    __syncthreads();
  }
  // output T-1: its later frame lies outside the volume
  if (o.active) {
    if constexpr (kBf16) {
      V last;
#pragma unroll
      for (int q = 0; q < V::NW; ++q) last.w[q] = add_bf16x2(0u, acc_c.w[q]);  // + S_T = +0
      store(a.t - 1, last);
    } else {
      store(a.t - 1, acc_m);
    }
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// bytes a staged vector takes in shared memory
size_t slot_bytes(int vw) { return vw == 1 ? 4 : 16; }

template <typename E, int WIDE>
int fwd(const void* x, void* y, int b, int t, int h, int w, int c, int vw, int v, int th, int tw, int threads,
        void* stream) {
  Launch l;
  const int rc = plan_launch(b, t, h, w, c, vw, WIDE, v, th, tw, threads, &l);
  if (rc != 0) return rc;
  const size_t smem = 2 * l.nhv * slot_bytes(vw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const E*>(x);
  auto* ys = static_cast<E*>(y);
  if (vw == WIDE) {
    if (!aligned(x, 16) || !aligned(y, 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    pool_fwd<E, WIDE><<<l.grid, l.threads, smem, st>>>(xs, ys, l.a);
  } else {
    pool_fwd<E, 1><<<l.grid, l.threads, smem, st>>>(xs, ys, l.a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int WIDE>
int bwd(const void* x, const void* y, const void* gy, void* dx, int b, int t, int h, int w, int c, int vw, int v,
        int th, int tw, int threads, void* stream) {
  Launch l;
  const int rc = plan_launch(b, t, h, w, c, vw, WIDE, v, th, tw, threads, &l);
  if (rc != 0) return rc;
  const size_t smem = 4 * l.nhv * slot_bytes(vw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const E*>(x);
  const auto* ys = static_cast<const E*>(y);
  const auto* gs = static_cast<const E*>(gy);
  auto* ds = static_cast<E*>(dx);
  if (vw == WIDE) {
    if (!aligned(x, 16) || !aligned(y, 16) || !aligned(gy, 16) || !aligned(dx, 16)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    pool_bwd<E, WIDE><<<l.grid, l.threads, smem, st>>>(xs, ys, gs, ds, l.a);
  } else {
    pool_bwd<E, 1><<<l.grid, l.threads, smem, st>>>(xs, ys, gs, ds, l.a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y = maxpool3d_s1(x); x, y contiguous (b, t, h, w, c) on the current
// device, float32 (fwd_f32) or bfloat16 as raw 16-bit words (fwd_bf16). The
// tile (vw channels a thread, v vectors, th x tw positions, `threads`
// threads a block) comes from the host plan; vw = 4 (float32) or 8
// (bfloat16) needs c % vw == 0 and 16-byte aligned operands, vw = 1 takes
// any. Returns a CUDA error code (0: launched).
extern "C" int maxpool3d_s1_fwd_f32(const void* x, void* y, int b, int t, int h, int w, int c, int vw, int v,
                                    int th, int tw, int threads, void* stream) {
  return fwd<uint32_t, 4>(x, y, b, t, h, w, c, vw, v, th, tw, threads, stream);
}

extern "C" int maxpool3d_s1_fwd_bf16(const void* x, void* y, int b, int t, int h, int w, int c, int vw, int v,
                                     int th, int tw, int threads, void* stream) {
  return fwd<uint16_t, 8>(x, y, b, t, h, w, c, vw, v, th, tw, threads, stream);
}

// dx = the every-tie gather of gy over x and y = maxpool3d_s1(x) (float32:
// the 27 terms in (dt, dh, dw) order; bfloat16: the Pallas kernel's order
// and rounding, see the header); all four contiguous (b, t, h, w, c), the
// tile as for the forward. Returns a CUDA error code (0: launched).
extern "C" int maxpool3d_s1_bwd_f32(const void* x, const void* y, const void* gy, void* dx, int b, int t, int h,
                                    int w, int c, int vw, int v, int th, int tw, int threads, void* stream) {
  return bwd<uint32_t, 4>(x, y, gy, dx, b, t, h, w, c, vw, v, th, tw, threads, stream);
}

extern "C" int maxpool3d_s1_bwd_bf16(const void* x, const void* y, const void* gy, void* dx, int b, int t, int h,
                                     int w, int c, int vw, int v, int th, int tw, int threads, void* stream) {
  return bwd<uint16_t, 8>(x, y, gy, dx, b, t, h, w, c, vw, v, th, tw, threads, stream);
}
