// Fused Inception branch 3 of I3D: 3x3x3 stride-1 zero-padded SAME max pool
// -> 1x1x1 conv -> bias [-> ReLU], forward and input gradient, float32 and
// bfloat16, channels-last: x (B, T, H, W, Cin), w (Cin, Cout), b (Cout,).
//
// Replaces the Pallas TPU kernels of ivf_tpu/ops/pallas/fused_branch3.py:
//   fused_pool_conv (grid over (b, t) frames): forward _fwd_kernel (:57),
//     backward _bwd_kernel (:72);
//   fused_pool_conv_tblock (grid over whole samples): forward _fwd_kernel_tb
//     (:279), backward _bwd_kernel_tb (:327).
// All compute, with P = pool(x) and [y != 0] only under the ReLU,
//   y  = act(P @ w + b)
//   gc = (g * [y != 0]) @ w^T
//   dx[t,h,w,k] = sum over in-range neighbours n of (x[t,h,w,k] == P[n,k]) * gc[n,k]
// which credits every tied maximum (the rule of csrc/maxpool3d.cu). P and gc
// never go to device memory. dw and db are left to PyTorch, as the JAX
// package left them to XLA.
//
// One forward design (fpc_fwd) and one backward design (fpc_bwd), each a
// template over the element type and the frames a block covers; the two
// Pallas functions are two instances of each: fused_pool_conv keeps a
// block's output inside one (b, t) frame, as the Pallas grid does;
// fused_pool_conv_tblock gives a block a chunk of frames and so stages the
// temporal halo, and computes the backward's pool and gc, once per chunk
// instead of once per frame. The host plans (fwd_plan, bwd_plan) pick the
// tile, the chunk and the forward's instance (tile shape and channel slab)
// from the shape: the least time under a cost model fitted to the times
// `python3 chip_smoke.py --fused-sweep` reads for every candidate plan.
//
// What bounds them on the H100. Counting each tensor once, the forward
// moves (Cin + Cout) elements per voxel for 2 Cin Cout operations plus the
// max: 14-27 operations per byte in float32 (the CUDA-core ridge is 67
// TFLOP/s over 3.35 TB/s = 20) and far below the bf16 ridge (~295), so
// bytes bound them on paper. In practice latency does: a block walks Cin
// in slabs (the backward walks frames), and the fitted cost of one slab or
// frame step, ~1.5-2 us of barriers and copy latency before any work,
// dominates at the few-row Mixed_4 and Mixed_5 sites, where one or two
// blocks share an SM. The backward reads x, y and g (y and g once per
// channel slab of Cin) and writes dx, with a 27-term gather per element.
//
// fpc_fwd: one block per (box of bt x bh x bw output voxels, BN output
//   channels). For each slab of KS input channels it stages x over the box
//   plus its 1-voxel halo as one TMA box of a 5-D tensor map over (B, T, H,
//   W, Cin), whose zeros past the edges are the SAME padding, and the (KS,
//   BN) slab of w with 16-byte cp.async copies, in a ring of 2 stages (3 for
//   tiles of at most 32 rows), so the next slabs' copies overlap this slab's
//   work (issuing one 16-byte copy per thread and vector took much of a
//   few-row slab's time; a TMA box is one instruction); takes the separable max there on
//   16-byte vectors (over W in one pass, then over H and T sliding down the
//   frames; tiles of at most 32 rows take W, H and T in one pass, one
//   barrier less), writing the pooled slab straight into the GEMM's A
//   layout; then runs the GEMM on it. float32: CUDA cores, each output one
//   fmaf chain over Cin in ascending order, then + bias, ReLU: the unfused
//   maxpool3d_s1 + pw_gemm_f32 pair's bits (no TF32, no split of Cin).
//   bfloat16: mma.sync m16n8k16 on the tensor cores (operands through
//   ldmatrix), float32 accumulators, the bias in float32, the ReLU, one
//   rounding. The max of bf16 values is exact in bf16. Instances (kFwdF32,
//   kFwdBf16) set the tile (BM rows x BN columns), KS and the threads. A
//   shape whose channels or pointers do not allow TMA and 16-byte copies
//   (Cin or Cout not a multiple of 16 bytes) stages with element loads in
//   the same kernel.
// fpc_bwd: one block per (bh x bw tile of dx, KB input channels, chunk of
//   frames [f0, f1)). It walks the x frames f0-2 .. f1+1 in order; for frame
//   i it stages x over the tile plus a 2-voxel halo (16-byte cp.async
//   copies, overlapped with the previous frame's GEMM and gather; TMA boxes
//   measured slower here), takes the 3x3 spatial max S
//   over the tile plus 1 and updates two planes (Q = max(S[i-1], S[i]),
//   S[i]) so that P[i-1] = max(Q, S[i]) costs one pass; then computes gc of
//   frame i-1 over the same halo tile as a GEMM over Cout from g * [y != 0]
//   (g and y copied in chunks of 32 channels with cp.async, the next chunk
//   during this chunk's GEMM) and the w slab (read once per block); then
//   adds frame i-1's 9 terms to the dx accumulators of frames i-2, i-1 and
//   i (the whole-sample instance) or of its one frame (the per-frame
//   instance), which live in registers beside the x values they compare:
//   frames arrive in ascending order, so every dx element adds its 27 terms
//   in (dt, dh, dw) ascending order, as pool_bwd does, and the oldest frame
//   is then complete and stored. Out-of-range neighbours carry gc = 0 and
//   add +0, which leaves a sum that started at +0 unchanged, so the gather
//   has no branches. P lives in the element type (exact), gc in float32.
//   float32: the gc GEMM on CUDA cores, one fmaf chain over Cout in
//   ascending order (the pair's bits); bfloat16: mma.sync with float32
//   accumulators, dx rounded once. Tiles of up to 64 pixels with a halo of
//   up to 128 positions keep a block within ~115 KB of shared memory (two
//   per SM). The per-frame instance computes P and gc of 3 frames per
//   output frame; the whole-sample instance of chunk + 2 frames per chunk;
//   a chunk of one frame takes the per-frame kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Geom {
  int b, t, h, w, cin, cout;
};

__device__ __forceinline__ long long voxel(const Geom& g, int b, int t, int h, int w) {
  return ((static_cast<long long>(b) * g.t + t) * g.h + h) * g.w + w;
}

__device__ __forceinline__ bool inside(const Geom& g, int t, int h, int w) {
  return t >= 0 && t < g.t && h >= 0 && h < g.h && w >= 0 && w < g.w;
}

// max that propagates NaN, as PyTorch's max_pool3d and csrc/maxpool3d.cu do
__device__ __forceinline__ float max_nan(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// max_nan in one instruction (the sign of a zero maximum may differ, which
// neither the GEMM nor the gather's equality test can see)
__device__ __forceinline__ uint32_t fmax2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ uint32_t bmax2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r = __hmax2_nan(*reinterpret_cast<const __nv_bfloat162*>(&a),
                                       *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// the max of two 16-byte vectors of channels: 4 float32 or 8 bfloat16
template <typename T>
__device__ __forceinline__ uint4 vmax(const uint4& a, const uint4& b) {
  if constexpr (std::is_same<T, float>::value) {
    return make_uint4(fmax2(a.x, b.x), fmax2(a.y, b.y), fmax2(a.z, b.z), fmax2(a.w, b.w));
  } else {
    return make_uint4(bmax2(a.x, b.x), bmax2(a.y, b.y), bmax2(a.z, b.z), bmax2(a.w, b.w));
  }
}

template <typename T>
__device__ __forceinline__ uint4 vmax3(const uint4& a, const uint4& b, const uint4& c) {
  return vmax<T>(vmax<T>(a, b), c);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// element i (0 .. 16 / sizeof(T) - 1) of a vector, as float32
template <typename T>
__device__ __forceinline__ float lane_f(const uint4& v, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float((&v.x)[i]);
  } else {
    const uint32_t word = (&v.x)[i / 2];
    return __uint_as_float((i & 1) ? (word & 0xffff0000u) : (word << 16));
  }
}

// sets element i of a vector to v, rounded to T
template <typename T>
__device__ __forceinline__ void put_lane(uint4& vec, int i, float v) {
  if constexpr (std::is_same<T, float>::value) {
    (&vec.x)[i] = __float_as_uint(v);
  } else {
    const bf16 h = __float2bfloat16_rn(v);
    const uint32_t bits = *reinterpret_cast<const uint16_t*>(&h);
    uint32_t& word = (&vec.x)[i / 2];
    word = (i & 1) ? ((word & 0x0000ffffu) | (bits << 16)) : ((word & 0xffff0000u) | bits);
  }
}

// 16 bytes from device memory into shared memory; zeros when !pred (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  cp_async16_zfill(dst, src, pred ? 16 : 0);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d (16 x 8, float32) += a (16 x 16, bf16, row-major) * b (16 x 8, bf16)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero_smem(void* p, int bytes, int tid, int nt) {
  uint4* v = static_cast<uint4*>(p);
  for (int e = tid; e < bytes / 16; e += nt) v[e] = make_uint4(0, 0, 0, 0);
}

// ---------------------------------------------------------------------------
// fpc_fwd
// ---------------------------------------------------------------------------

template <typename T>
struct FwdArgs {
  CUtensorMap xmap;  // x as (B, T, H, W, Cin), boxes of the halo box x KS channels
  const T* x;
  const T* w;
  const T* bias;
  T* y;
  Geom g;
  int relu;
  int bt, bh, bw;  // the box of output voxels of one block
  int nt, nh, nw;  // boxes per sample along T, H and W
  int vec;         // TMA and 16-byte copies: channels, Cout and pointers allow them
};

template <typename T, int BM, int BN, int KS, int NT>
struct FwdCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kV = 16 / sizeof(T);        // channels per 16-byte vector
  static constexpr int kKV = KS / kV;              // vectors per voxel of a slab
  static constexpr int kWld = kF32 ? BN : BN + 8;  // w slab row (elements)
  static constexpr int kAld = kF32 ? BM + 4 : KS + 8;
  static constexpr int kAElems = kF32 ? KS * kAld : BM * kAld;  // f32 [KS][BM+4], bf16 [BM][KS+8]
  // small tiles: few blocks per SM hide little latency, so a deeper ring, and
  // the max in one pass (one barrier less per slab)
  static constexpr bool kOnePass = BM <= 32;
  static constexpr int kStages = kOnePass ? 3 : 2;
  static_assert(KS % kV == 0 && BN % kV == 0 && KS % 16 == 0, "slab and tile shapes");

  // float32 GEMM: a TY x TX thread grid, RM x 4 outputs each
  static constexpr int kTX = BN / 4, kTY = NT / kTX, kRM = BM / kTY;
  // bfloat16 GEMM: a WR x WC warp grid, WTM x WTN outputs each
  static constexpr int kWarps = NT / 32;
  static constexpr int kWR = BM / 16 < kWarps ? BM / 16 : kWarps, kWC = kWarps / kWR;
  static constexpr int kWTM = BM / kWR, kWTN = BN / kWC, kMI = kWTM / 16, kNI = kWTN / 8;

  // shared memory, from a 128-byte aligned base: the x stages (each a TMA
  // box), the w stages, the max over W (two passes), A, one mbarrier per
  // stage
  __host__ __device__ static int xs_bytes(int nv) { return (nv * KS * static_cast<int>(sizeof(T)) + 127) / 128 * 128; }
  __host__ __device__ static int ws_bytes() { return (KS * kWld * static_cast<int>(sizeof(T)) + 15) / 16 * 16; }
  __host__ __device__ static int wm_elems(int bt, int bh, int bw) {
    return kOnePass ? 0 : (bt + 2) * (bh + 2) * bw * KS;
  }
  static size_t smem_bytes(int bt, int bh, int bw) {
    const int nv = (bt + 2) * (bh + 2) * (bw + 2);
    return 128 + static_cast<size_t>(kStages) * (xs_bytes(nv) + ws_bytes()) +
           sizeof(T) * (static_cast<size_t>(wm_elems(bt, bh, bw)) + kAElems) + kStages * 8;
  }
};

template <typename T, int BM, int BN, int KS, int NT>
__global__ void __launch_bounds__(NT) fpc_fwd(const __grid_constant__ FwdArgs<T> a) {
  using C = FwdCfg<T, BM, BN, KS, NT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                                          ~static_cast<uintptr_t>(127));
  const Geom& g = a.g;
  const int tid = threadIdx.x;
  const int HT = a.bt + 2, HH = a.bh + 2, HW = a.bw + 2;
  const int nv = HT * HH * HW;
  const int xsb = C::xs_bytes(nv), wsb = C::ws_bytes();
  auto xs_of = [&](int st) { return reinterpret_cast<T*>(base + st * xsb); };  // [HT][HH][HW][KS]
  auto ws_of = [&](int st) { return reinterpret_cast<T*>(base + C::kStages * xsb + st * wsb); };  // [KS][kWld]
  T* wm = reinterpret_cast<T*>(base + C::kStages * (xsb + wsb));  // [HT][HH][bw][KS]: the max over W (two passes)
  T* as = wm + C::wm_elems(a.bt, a.bh, a.bw);  // the pooled slab in the GEMM's A layout
  uint64_t* bars = reinterpret_cast<uint64_t*>(as + C::kAElems);

  int blk = blockIdx.x;
  const int w0 = (blk % a.nw) * a.bw;
  blk /= a.nw;
  const int h0 = (blk % a.nh) * a.bh;
  blk /= a.nh;
  const int t0 = (blk % a.nt) * a.bt;
  const int b = blk / a.nt;
  const int n0 = blockIdx.y * BN;
  const int plane = a.bh * a.bw;
  const int nslabs = (g.cin + KS - 1) / KS;

  zero_smem(as, C::kAElems * sizeof(T), tid, NT);  // rows past the box stay 0
  if (tid == 0) {  // one barrier per stage, for its TMA copy of x
    for (int st = 0; st < C::kStages; ++st) mbar_init(smem_u32(&bars[st]), 1);
    mbar_init_fence();
  }
  __syncthreads();

  // slab `slab` into its stage: x over the halo box as one TMA box (zeros
  // past the edges of x: the SAME padding, and past Cin), completing on the
  // stage's barrier; the (KS, BN) slab of w with 16-byte cp.async copies
  auto stage = [&](int slab) {
    T* xs = xs_of(slab % C::kStages);
    T* ws = ws_of(slab % C::kStages);
    const int k0 = slab * KS;
    if (a.vec) {
      if (tid == 0) {
        const uint32_t bar = smem_u32(&bars[slab % C::kStages]);
        fence_proxy_async();
        mbar_expect_tx(bar, nv * KS * sizeof(T));
        tma_load_5d(smem_u32(xs), &a.xmap, bar, k0, w0 - 1, h0 - 1, t0 - 1, b);
      }
#pragma unroll 4
      for (int e = tid; e < KS * (BN / C::kV); e += NT) {
        const int c = e % (BN / C::kV), r = e / (BN / C::kV);
        const int k = k0 + r, n = n0 + c * C::kV;
        const bool ok = k < g.cin && n < g.cout;
        cp_async16(ws + r * C::kWld + c * C::kV, ok ? a.w + static_cast<long long>(k) * g.cout + n : a.w, ok);
      }
    } else {
      for (int e = tid; e < nv * KS; e += NT) {
        const int c = e % KS, p = e / KS, vw = p % HW, r = p / HW, vh = r % HH, vt = r / HH;
        const int tt = t0 - 1 + vt, hh = h0 - 1 + vh, ww = w0 - 1 + vw, k = k0 + c;
        xs[e] = (inside(g, tt, hh, ww) && k < g.cin) ? a.x[voxel(g, b, tt, hh, ww) * g.cin + k] : from_f<T>(0.f);
      }
      for (int e = tid; e < KS * BN; e += NT) {
        const int c = e % BN, r = e / BN;
        const int k = k0 + r, n = n0 + c;
        ws[r * C::kWld + c] =
            (k < g.cin && n < g.cout) ? a.w[static_cast<long long>(k) * g.cout + n] : from_f<T>(0.f);
      }
    }
  };

  // GEMM state
  const int lane = tid % 32, warp = tid / 32;
  const int tx = tid % C::kTX, ty = tid / C::kTX;
  const int wr = warp % C::kWR, wc = warp / C::kWR;
  float acc_f[C::kF32 ? C::kRM : 1][4];
  float acc_b[C::kF32 ? 1 : C::kMI][C::kF32 ? 1 : C::kNI][4];
  if constexpr (C::kF32) {
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_f[i][j] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C::kMI; ++i) {
#pragma unroll
      for (int j = 0; j < C::kNI; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) acc_b[i][j][q] = 0.f;
      }
    }
  }

  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nslabs) stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nslabs; ++s) {
    if (s + C::kStages - 1 < nslabs) stage(s + C::kStages - 1);
    cp_async_commit();
    cp_async_wait<C::kStages - 1>();
    if (a.vec) mbar_wait(smem_u32(&bars[s % C::kStages]), (s / C::kStages) & 1);
    __syncthreads();
    const uint4* xs = reinterpret_cast<const uint4*>(xs_of(s % C::kStages));
    const T* ws = ws_of(s % C::kStages);
    uint4* wv = reinterpret_cast<uint4*>(wm);
    auto store_a = [&](int r, int q, const uint4& out) {
      if constexpr (C::kF32) {
        float* af = reinterpret_cast<float*>(as);
        af[(q * 4 + 0) * C::kAld + r] = __uint_as_float(out.x);
        af[(q * 4 + 1) * C::kAld + r] = __uint_as_float(out.y);
        af[(q * 4 + 2) * C::kAld + r] = __uint_as_float(out.z);
        af[(q * 4 + 3) * C::kAld + r] = __uint_as_float(out.w);
      } else {
        *reinterpret_cast<uint4*>(as + r * C::kAld + q * 8) = out;
      }
    };

    if constexpr (C::kOnePass) {
      // one thread per (row, vector) of A: over W, then H, then T, from x
#pragma unroll 2
      for (int e = tid; e < a.bt * plane * C::kKV; e += NT) {
        const int q = e % C::kKV, r = e / C::kKV, at = r / plane, p = r - at * plane;
        const int u = p / a.bw, v = p - u * a.bw;
        uint4 out;
#pragma unroll
        for (int dt = 0; dt < 3; ++dt) {
          const int c0 = (((at + dt) * HH + u) * HW + v) * C::kKV + q, row = HW * C::kKV;
          const uint4 hmax = vmax3<T>(vmax3<T>(xs[c0], xs[c0 + C::kKV], xs[c0 + 2 * C::kKV]),
                                      vmax3<T>(xs[c0 + row], xs[c0 + row + C::kKV], xs[c0 + row + 2 * C::kKV]),
                                      vmax3<T>(xs[c0 + 2 * row], xs[c0 + 2 * row + C::kKV],
                                               xs[c0 + 2 * row + 2 * C::kKV]));
          out = dt == 0 ? hmax : vmax<T>(out, hmax);
        }
        store_a(r, q, out);
      }
      __syncthreads();
    } else {
    // max over W: one thread per (frame, row, column, vector) of the halo box
#pragma unroll 4
    for (int e = tid; e < HT * HH * a.bw * C::kKV; e += NT) {
      const int q = e % C::kKV, r = e / C::kKV, v = r % a.bw, row = r / a.bw;
      const int base = (row * HW + v) * C::kKV + q;
      wv[e] = vmax3<T>(xs[base], xs[base + C::kKV], xs[base + 2 * C::kKV]);
    }
    __syncthreads();
    // max over H, then over T (sliding down the frames), into A: row r =
    // (frame, h, w) of the box
#pragma unroll 2
    for (int e = tid; e < plane * C::kKV; e += NT) {
      const int q = e % C::kKV, p = e / C::kKV, u = p / a.bw, v = p - u * a.bw;
      const int col = (u * a.bw + v) * C::kKV + q, step = a.bw * C::kKV, frame = HH * step;
      uint4 m0 = vmax3<T>(wv[col], wv[col + step], wv[col + 2 * step]);
      uint4 m1 = vmax3<T>(wv[frame + col], wv[frame + col + step], wv[frame + col + 2 * step]);
      for (int at = 2; at < HT; ++at) {
        const int c2 = at * frame + col;
        const uint4 m2 = vmax3<T>(wv[c2], wv[c2 + step], wv[c2 + 2 * step]);
        store_a((at - 2) * plane + p, q, vmax3<T>(m0, m1, m2));
        m0 = m1;
        m1 = m2;
      }
    }
    __syncthreads();
    }

    if constexpr (C::kF32) {
      // the operands of a group of k first (their loads in flight together),
      // then the fmaf chains, k ascending
      const float* af = reinterpret_cast<const float*>(as);
      const float* wf = reinterpret_cast<const float*>(ws);
      constexpr int kG = C::kRM >= 4 ? 4 : 8;
#pragma unroll
      for (int k0 = 0; k0 < KS; k0 += kG) {
        float av[kG][C::kRM];
        float4 bv[kG];
#pragma unroll
        for (int kk = 0; kk < kG; ++kk) {
          const int k = k0 + kk;
          if constexpr (C::kRM == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(af + k * C::kAld + ty * 4);
            av[kk][0] = t4.x;
            av[kk][1] = t4.y;
            av[kk][2] = t4.z;
            av[kk][3] = t4.w;
          } else {
#pragma unroll
            for (int i = 0; i < C::kRM; ++i) av[kk][i] = af[k * C::kAld + ty * C::kRM + i];
          }
          bv[kk] = *reinterpret_cast<const float4*>(wf + k * BN + tx * 4);
        }
#pragma unroll
        for (int kk = 0; kk < kG; ++kk) {
#pragma unroll
          for (int i = 0; i < C::kRM; ++i) {
            acc_f[i][0] = fmaf(av[kk][i], bv[kk].x, acc_f[i][0]);
            acc_f[i][1] = fmaf(av[kk][i], bv[kk].y, acc_f[i][1]);
            acc_f[i][2] = fmaf(av[kk][i], bv[kk].z, acc_f[i][2]);
            acc_f[i][3] = fmaf(av[kk][i], bv[kk].w, acc_f[i][3]);
          }
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        uint32_t af[C::kMI][4];
#pragma unroll
        for (int mi = 0; mi < C::kMI; ++mi) {
          ldsm_x4(af[mi], as + (wr * C::kWTM + mi * 16 + lane % 16) * C::kAld + kk * 16 + (lane / 16) * 8);
        }
#pragma unroll
        for (int nj = 0; nj < C::kNI / 2; ++nj) {
          uint32_t bq[4];
          ldsm_x4_t(bq, ws + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * C::kWld + wc * C::kWTN + nj * 16 +
                            (lane / 16) * 8);
#pragma unroll
          for (int mi = 0; mi < C::kMI; ++mi) {
            mma_bf16(acc_b[mi][2 * nj], af[mi], bq[0], bq[1]);
            mma_bf16(acc_b[mi][2 * nj + 1], af[mi], bq[2], bq[3]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + bias, ReLU, one rounding, rows of the box inside the sample only
  auto row_voxel = [&](int r, long long* out) -> bool {
    if (r >= a.bt * plane) return false;
    const int at = r / plane, p = r % plane;
    const int t = t0 + at, h = h0 + p / a.bw, w = w0 + p % a.bw;
    if (!inside(g, t, h, w)) return false;
    *out = voxel(g, b, t, h, w) * g.cout;
    return true;
  };
  if constexpr (C::kF32) {
    const int n = n0 + tx * 4;
#pragma unroll
    for (int i = 0; i < C::kRM; ++i) {
      long long o;
      if (!row_voxel(ty * C::kRM + i, &o)) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = n + j < g.cout ? acc_f[i][j] + a.bias[n + j] : 0.f;
        if (a.relu && v[j] < 0.f) v[j] = 0.f;
      }
      if (a.vec && n + 3 < g.cout) {
        *reinterpret_cast<float4*>(a.y + o + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (n + j < g.cout) a.y[o + n + j] = v[j];
        }
      }
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < C::kMI; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        long long o;
        if (!row_voxel(wr * C::kWTM + mi * 16 + lane / 4 + half * 8, &o)) continue;
#pragma unroll
        for (int ni = 0; ni < C::kNI; ++ni) {
          const int n = n0 + wc * C::kWTN + ni * 8 + (lane % 4) * 2;
          float v0 = n < g.cout ? acc_b[mi][ni][2 * half] + to_f(a.bias[n]) : 0.f;
          float v1 = n + 1 < g.cout ? acc_b[mi][ni][2 * half + 1] + to_f(a.bias[n + 1]) : 0.f;
          if (a.relu) {
            v0 = v0 < 0.f ? 0.f : v0;
            v1 = v1 < 0.f ? 0.f : v1;
          }
          if (a.vec && n + 1 < g.cout) {
            *reinterpret_cast<__nv_bfloat162*>(a.y + o + n) = __floats2bfloat162_rn(v0, v1);
          } else {
            if (n < g.cout) a.y[o + n] = __float2bfloat16_rn(v0);
            if (n + 1 < g.cout) a.y[o + n + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fpc_bwd
// ---------------------------------------------------------------------------

template <typename T>
struct BwdArgs {
  const T* x;
  const T* y;
  const T* g;
  const T* w;
  T* dx;
  Geom geo;
  int relu;
  int bh, bw, chunk;      // a block's tile of dx: bh x bw pixels, `chunk` frames
  int nh, nw, nchunks;    // tiles per frame along H and W, chunks per sample
  int vec;                // 16-byte copies: channels, Cout and pointers allow them
};

template <typename T, int KB, int NT>
struct BwdCfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kKQ = KB / kV;         // vectors per position
  static constexpr int kMaxRows = 128;        // gc GEMM rows: the halo tile, padded to 16
  static constexpr int kJC = 32;              // Cout per chunk of g * [y != 0]
  static constexpr int kJV = kJC / kV;        // vectors per position of a chunk
  static constexpr int kGld = kF32 ? KB : KB + 4;  // gc plane row (floats)
  static constexpr int kIPT = 2;              // dx vectors per thread
  // float32 gc GEMM: a TY x TX thread grid, up to RP rows x 4 channels each
  static constexpr int kTX = KB / 4, kTY = NT / kTX, kRP = kMaxRows / kTY;
  // bf16 gc GEMM: tasks of 16 rows x 32 channels, up to kTasks per warp
  static constexpr int kGroups = KB / 32, kWarps = NT / 32;
  static constexpr int kTasks = (kMaxRows / 16 * kGroups + kWarps - 1) / kWarps;
  static_assert(kMaxRows % kTY == 0 && KB % 32 == 0, "block shape");

  __host__ __device__ static int cout_pad(int cout) { return (cout + kJC - 1) / kJC * kJC; }
  __host__ __device__ static int rows(int hpos) { return (hpos + 15) / 16 * 16; }
  __host__ __device__ static int ms_ld(int mrows) { return kF32 ? mrows + 1 : kJC + 8; }
  __host__ __device__ static int ms_bytes(int mrows) {
    return kF32 ? (kJC * ms_ld(mrows) * 4 + 15) / 16 * 16 : mrows * ms_ld(mrows) * 2;
  }
  __host__ __device__ static int w_bytes(int cout) {
    return kF32 ? cout_pad(cout) * KB * 4 : KB * (cout_pad(cout) + 8) * 2;
  }
  // g and y of a chunk as loaded: [mrows][kJC] each
  __host__ __device__ static int raw_bytes(int mrows) { return 2 * mrows * kJC * static_cast<int>(sizeof(T)); }
  static size_t smem_bytes(int bh, int bw, int cout) {
    const int xp = (bh + 4) * (bw + 4), hp = (bh + 2) * (bw + 2);
    return static_cast<size_t>(xp) * KB * sizeof(T) + 3 * static_cast<size_t>(hp) * KB * sizeof(T) +
           static_cast<size_t>(hp) * kGld * 4 + ms_bytes(rows(hp)) + raw_bytes(rows(hp)) + w_bytes(cout) +
           (static_cast<size_t>(xp + 2 * hp) * 4 + 15) / 16 * 16;
  }
  static bool fits(int bh, int bw) {
    return (bh + 2) * (bw + 2) <= kMaxRows && bh * bw * kKQ <= kIPT * NT;
  }
};

// kOne: the per-frame instance (one output frame per block: one accumulator
// per owned vector); else the whole-sample instance (a chunk of frames: the
// accumulators of frames i-2, i-1 and i).
template <typename T, int KB, int NT, bool kOne>
__global__ void __launch_bounds__(NT, 2) fpc_bwd(const BwdArgs<T> a) {
  using C = BwdCfg<T, KB, NT>;
  constexpr int kSlots = kOne ? 1 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Geom& g = a.geo;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int XW = a.bw + 4, PW = a.bw + 2;
  const int xpos = (a.bh + 4) * XW, hpos = (a.bh + 2) * PW;
  const int mrows = C::rows(hpos), msld = C::ms_ld(mrows);
  const int coutp = C::cout_pad(g.cout);
  uint4* xst = reinterpret_cast<uint4*>(smem_raw);  // [xpos][KQ]  x of one frame
  uint4* sp = xst + xpos * C::kKQ;                   // [hpos][KQ]  S of the previous frame
  uint4* qm = sp + hpos * C::kKQ;                    // [hpos][KQ]  max of the last two S
  uint4* pl = qm + hpos * C::kKQ;                    // [hpos][KQ]  the pool of frame i - 1
  float* gcs = reinterpret_cast<float*>(pl + hpos * C::kKQ);  // [hpos][kGld]  gc of frame i - 1
  unsigned char* ms = reinterpret_cast<unsigned char*>(gcs + hpos * C::kGld);  // g * [y != 0], a chunk
  uint4* raw = reinterpret_cast<uint4*>(ms + C::ms_bytes(mrows));  // [2][mrows][kJV]: g, y of a chunk
  T* wsm = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(raw) + C::raw_bytes(mrows));  // the w slab
  int* xoff = reinterpret_cast<int*>(reinterpret_cast<unsigned char*>(wsm) + C::w_bytes(g.cout));
  int* hoff = xoff + xpos;  // pixel (h * W + w) of each position in its frame, -1 outside
  int* hx = hoff + hpos;    // the x-tile index of each halo position's top-left neighbour

  const int h0 = (blockIdx.x / a.nw) * a.bh, w0 = (blockIdx.x % a.nw) * a.bw;
  const int k0 = blockIdx.y * KB;
  const int b = blockIdx.z / a.nchunks;
  const int f0 = (blockIdx.z % a.nchunks) * a.chunk;
  const int f1 = min(g.t, f0 + a.chunk);
  const long long hw = static_cast<long long>(g.h) * g.w;
  auto frame_base = [&](int f) { return (static_cast<long long>(b) * g.t + f) * hw; };

  for (int p = tid; p < xpos; p += NT) {
    const int h = h0 - 2 + p / XW, w = w0 - 2 + p % XW;
    xoff[p] = (h >= 0 && h < g.h && w >= 0 && w < g.w) ? h * g.w + w : -1;
  }
  for (int p = tid; p < hpos; p += NT) {
    const int u = p / PW, v = p % PW, h = h0 - 1 + u, w = w0 - 1 + v;
    hoff[p] = (h >= 0 && h < g.h && w >= 0 && w < g.w) ? h * g.w + w : -1;
    hx[p] = u * XW + v;
  }
  // the w slab, once: float32 w^T [coutp][KB]; bf16 [KB][coutp + 8]
  if constexpr (C::kF32) {
    float* wt = reinterpret_cast<float*>(wsm);
    for (int e = tid; e < coutp * KB; e += NT) {
      const int c = e % KB, j = e / KB, k = k0 + c;
      wt[e] = (j < g.cout && k < g.cin) ? a.w[static_cast<long long>(k) * g.cout + j] : 0.f;
    }
  } else {
    for (int e = tid; e < KB * (coutp + 8); e += NT) {
      const int j = e % (coutp + 8), c = e / (coutp + 8), k = k0 + c;
      wsm[e] = (j < g.cout && k < g.cin) ? a.w[static_cast<long long>(k) * g.cout + j] : from_f<T>(0.f);
    }
  }
  zero_smem(sp, 2 * hpos * 16 * C::kKQ, tid, NT);  // sp and qm
  __syncthreads();

  auto stage = [&](int i) {  // x of frame i over the tile plus 2
    const long long base = frame_base(i);
    if (a.vec) {
#pragma unroll 4
      for (int e = tid; e < xpos * C::kKQ; e += NT) {
        const int q = e % C::kKQ, p = e / C::kKQ, off = xoff[p], k = k0 + q * C::kV;
        const bool ok = off >= 0 && k < g.cin;
        cp_async16(xst + e, ok ? a.x + (base + off) * g.cin + k : a.x, ok);
      }
    } else {
      T* xe = reinterpret_cast<T*>(xst);
      for (int e = tid; e < xpos * KB; e += NT) {
        const int c = e % KB, p = e / KB, off = xoff[p], k = k0 + c;
        xe[e] = (off >= 0 && k < g.cin) ? a.x[(base + off) * g.cin + k] : from_f<T>(0.f);
      }
    }
  };

  // g and y of frame f, Cout j0 .. j0 + kJC, at the halo positions, copied
  // into `raw` as they are (cp.async; the copy overlaps other work) ...
  uint4* raw_y = raw + mrows * C::kJV;
  auto load_m = [&](int f, int j0) {
    const long long fbase = frame_base(f);
#pragma unroll 4
    for (int e = tid; e < mrows * C::kJV; e += NT) {
      const int jv = e % C::kJV, p = e / C::kJV, j = j0 + jv * C::kV;
      const int off = p < hpos ? hoff[p] : -1;
      const bool ok = off >= 0 && j < g.cout;
      const long long o = ok ? (fbase + off) * g.cout + j : 0;
      if (a.vec) {
        cp_async16(raw + e, a.g + o, ok);
        cp_async16(raw_y + e, a.y + o, ok);
      } else {
        uint4 m = make_uint4(0, 0, 0, 0);
        if (ok) {
#pragma unroll
          for (int c = 0; c < C::kV; ++c) {
            const bool in = j + c < g.cout;
            const float gc = in ? to_f(a.g[o + c]) : 0.f;
            put_lane<T>(m, c, a.relu && in && to_f(a.y[o + c]) == 0.f ? 0.f : gc);
          }
        }
        raw[e] = m;
        raw_y[e] = make_uint4(0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu);  // mask applied
      }
    }
  };
  // ... then g * [y != 0] into the GEMM's A layout
  auto store_m = [&]() {
#pragma unroll 2
    for (int e = tid; e < mrows * C::kJV; e += NT) {
      const int jv = e % C::kJV, p = e / C::kJV;
      const uint4 gv = raw[e], yv = raw_y[e];
      uint4 mv = gv;
      if (a.relu) {
        const uint32_t* gw = &gv.x;
        const uint32_t* yw = &yv.x;
        uint32_t* mw = &mv.x;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if constexpr (C::kF32) {
            mw[q] = (yw[q] & 0x7fffffffu) ? gw[q] : 0u;
          } else {
            const uint32_t lo = (yw[q] & 0x00007fffu) ? (gw[q] & 0x0000ffffu) : 0u;
            const uint32_t hi = (yw[q] & 0x7fff0000u) ? (gw[q] & 0xffff0000u) : 0u;
            mw[q] = lo | hi;
          }
        }
      }
      if constexpr (C::kF32) {
        float* mf = reinterpret_cast<float*>(ms);
        mf[(jv * 4 + 0) * msld + p] = __uint_as_float(mv.x);
        mf[(jv * 4 + 1) * msld + p] = __uint_as_float(mv.y);
        mf[(jv * 4 + 2) * msld + p] = __uint_as_float(mv.z);
        mf[(jv * 4 + 3) * msld + p] = __uint_as_float(mv.w);
      } else {
        *reinterpret_cast<uint4*>(ms + (p * msld + jv * 8) * 2) = mv;
      }
    }
  };

  // the dx vectors this thread owns: (pixel, vector) of the tile; per owned
  // vector the x values and the accumulators of its frames in flight
  const int owned = a.bh * a.bw * C::kKQ;
  int own_q[C::kIPT], own_h[C::kIPT], own_x[C::kIPT], own_off[C::kIPT];
  uint4 xr[C::kIPT][kSlots];
  float acc[C::kIPT][kSlots][C::kV];
#pragma unroll
  for (int it = 0; it < C::kIPT; ++it) {
    const int e = tid + it * NT, p = e / C::kKQ, u = p / a.bw, v = p % a.bw;
    const int h = h0 + u, w = w0 + v, k = k0 + (e % C::kKQ) * C::kV;
    own_q[it] = e % C::kKQ;
    own_h[it] = u * PW + v;               // top-left of the 3 x 3 neighbours in the halo tile
    own_x[it] = (u + 2) * XW + v + 2;     // the pixel in the x tile
    own_off[it] = (e < owned && h < g.h && w < g.w && k < g.cin) ? h * g.w + w : -1;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      xr[it][s] = make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int c = 0; c < C::kV; ++c) acc[it][s][c] = 0.f;
    }
  }

  if (f0 - 2 >= 0) stage(f0 - 2);
  cp_async_commit();
  for (int i = f0 - 2; i <= f1 + 1; ++i) {
    const int f = i - 1;
    const bool do_gc = i >= f0 && f >= 0 && f < g.t;
    const bool have = i >= 0 && i < g.t;
    if (do_gc) {  // the first chunk of frame f lands during the S pass
      load_m(f, 0);
      cp_async_commit();
      cp_async_wait<1>();  // x of frame i
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // S = the 3x3 spatial max of frame i over the tile plus 1; P[i-1] = max(Q, S);
    // Q = max(S[i-1], S); S[i-1] = S
#pragma unroll 2
    for (int e = tid; e < hpos * C::kKQ; e += NT) {
      const int q = e % C::kKQ, p = e / C::kKQ;
      uint4 s = make_uint4(0, 0, 0, 0);
      if (have) {
        const uint4* c0 = xst + hx[p] * C::kKQ + q;
        s = vmax3<T>(c0[0], c0[C::kKQ], c0[2 * C::kKQ]);
        s = vmax<T>(s, vmax3<T>(c0[XW * C::kKQ], c0[(XW + 1) * C::kKQ], c0[(XW + 2) * C::kKQ]));
        s = vmax<T>(s, vmax3<T>(c0[2 * XW * C::kKQ], c0[(2 * XW + 1) * C::kKQ], c0[(2 * XW + 2) * C::kKQ]));
      }
      const uint4 prev = sp[e];
      pl[e] = vmax<T>(qm[e], s);
      qm[e] = vmax<T>(prev, s);
      sp[e] = s;
    }
    // the owned x of frame i: kept for the frames it is a target of
    if (!kOne || i == f0) {
#pragma unroll
      for (int it = 0; it < C::kIPT; ++it) {
        if (tid + it * NT < owned) {
          xr[it][kSlots - 1] = have ? xst[own_x[it] * C::kKQ + own_q[it]] : make_uint4(0, 0, 0, 0);
        }
      }
    }
    __syncthreads();
    if (i + 1 >= 0 && i + 1 < g.t && i + 1 <= f1 + 1) stage(i + 1);
    cp_async_commit();

    // targets of frame f's terms: frames f+1 (its first), f, f-1 (its last)
    bool act[kSlots];
    if constexpr (kOne) {
      act[0] = i >= f0 && i <= f0 + 2;
    } else {
      act[0] = i - 2 >= f0 && i - 2 < f1;
      act[1] = i - 1 >= f0 && i - 1 < f1;
      act[2] = i >= f0 && i < f1;
    }
    if (do_gc) {
      // gc of frame f over the halo tile: (g * [y != 0]) @ w[k0 .., :]^T
      float accf[C::kF32 ? C::kRP : 1][4];
      float accb[C::kF32 ? 1 : C::kTasks][4][4];
      const int tx = tid % C::kTX, ty = tid / C::kTX;
      if constexpr (C::kF32) {
#pragma unroll
        for (int r = 0; r < C::kRP; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) accf[r][c] = 0.f;
        }
      } else {
#pragma unroll
        for (int r = 0; r < C::kTasks; ++r) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
#pragma unroll
            for (int c = 0; c < 4; ++c) accb[r][n][c] = 0.f;
          }
        }
      }
      for (int j0 = 0; j0 < coutp; j0 += C::kJC) {
        if (j0 == 0) {
          cp_async_wait<1>();  // the chunk; x of frame i + 1 may still be in flight
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
        store_m();
        __syncthreads();
        if (j0 + C::kJC < coutp) {  // the next chunk lands during this chunk's GEMM
          load_m(f, j0 + C::kJC);
          cp_async_commit();
        }
        if constexpr (C::kF32) {
          // the operands of 4 j first, then the fmaf chains, j ascending
          const float* mf = reinterpret_cast<const float*>(ms);
          const float* wt = reinterpret_cast<const float*>(wsm);
#pragma unroll 2
          for (int jg = 0; jg < C::kJC; jg += 4) {
            float4 bv[4];
            float av[4][C::kRP];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              bv[jj] = *reinterpret_cast<const float4*>(wt + (j0 + jg + jj) * KB + tx * 4);
#pragma unroll
              for (int r = 0; r < C::kRP; ++r) av[jj][r] = mf[(jg + jj) * msld + min(ty + C::kTY * r, mrows - 1)];
            }
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
              for (int r = 0; r < C::kRP; ++r) {
                if (ty + C::kTY * r < hpos) {
                  accf[r][0] = fmaf(av[jj][r], bv[jj].x, accf[r][0]);
                  accf[r][1] = fmaf(av[jj][r], bv[jj].y, accf[r][1]);
                  accf[r][2] = fmaf(av[jj][r], bv[jj].z, accf[r][2]);
                  accf[r][3] = fmaf(av[jj][r], bv[jj].w, accf[r][3]);
                }
              }
            }
          }
        } else {
          const bf16* mb = reinterpret_cast<const bf16*>(ms);
#pragma unroll
          for (int kk = 0; kk < C::kJC / 16; ++kk) {
#pragma unroll
            for (int r = 0; r < C::kTasks; ++r) {
              const int task = warp + C::kWarps * r, mt = task / C::kGroups, grp = task % C::kGroups;
              if (mt * 16 >= mrows) continue;
              uint32_t af[4];
              ldsm_x4(af, mb + (mt * 16 + lane % 16) * msld + kk * 16 + (lane / 16) * 8);
#pragma unroll
              for (int np = 0; np < 2; ++np) {
                uint32_t bq[4];
                ldsm_x4(bq, wsm + (grp * 32 + np * 16 + lane % 8 + (lane / 16) * 8) * (coutp + 8) + j0 +
                                kk * 16 + ((lane / 8) % 2) * 8);
                mma_bf16(accb[r][2 * np], af, bq[0], bq[1]);
                mma_bf16(accb[r][2 * np + 1], af, bq[2], bq[3]);
              }
            }
          }
        }
        __syncthreads();
      }
      // gc into shared memory; 0 at positions outside the frame
      if constexpr (C::kF32) {
#pragma unroll
        for (int r = 0; r < C::kRP; ++r) {
          const int p = ty + C::kTY * r;
          if (p >= hpos) continue;
          *reinterpret_cast<float4*>(gcs + p * C::kGld + tx * 4) =
              hoff[p] >= 0 ? make_float4(accf[r][0], accf[r][1], accf[r][2], accf[r][3])
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
#pragma unroll
        for (int r = 0; r < C::kTasks; ++r) {
          const int task = warp + C::kWarps * r, mt = task / C::kGroups, grp = task % C::kGroups;
          if (mt * 16 >= mrows) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = mt * 16 + lane / 4 + half * 8;
            if (p >= hpos) continue;
            const bool ok = hoff[p] >= 0;
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              const int c = grp * 32 + n * 8 + (lane % 4) * 2;
              *reinterpret_cast<float2*>(gcs + p * C::kGld + c) =
                  ok ? make_float2(accb[r][n][2 * half], accb[r][n][2 * half + 1]) : make_float2(0.f, 0.f);
            }
          }
        }
      }
      __syncthreads();

      // frame f's 9 terms, (dh, dw) ascending, into each target's sum
#pragma unroll
      for (int it = 0; it < C::kIPT; ++it) {
        if (tid + it * NT >= owned) continue;
        const int q = own_q[it];
        float xs_[kSlots][C::kV];
#pragma unroll
        for (int sl = 0; sl < kSlots; ++sl) {
#pragma unroll
          for (int c = 0; c < C::kV; ++c) xs_[sl][c] = lane_f<T>(xr[it][sl], c);
        }
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
          for (int dw = 0; dw < 3; ++dw) {
            const int hp = own_h[it] + dh * PW + dw;
            const uint4 pv = pl[hp * C::kKQ + q];
            float gq[C::kV];
            const float4* gp = reinterpret_cast<const float4*>(gcs + hp * C::kGld + q * C::kV);
#pragma unroll
            for (int c4 = 0; c4 < C::kV / 4; ++c4) {
              const float4 t4 = gp[c4];
              gq[4 * c4 + 0] = t4.x;
              gq[4 * c4 + 1] = t4.y;
              gq[4 * c4 + 2] = t4.z;
              gq[4 * c4 + 3] = t4.w;
            }
#pragma unroll
            for (int c = 0; c < C::kV; ++c) {
              const float pc = lane_f<T>(pv, c);
#pragma unroll
              for (int sl = kSlots - 1; sl >= 0; --sl) {
                if (act[sl]) acc[it][sl][c] += xs_[sl][c] == pc ? gq[c] : 0.f;
              }
            }
          }
        }
      }
    }

    // the oldest target has all its terms: store it (then, whole-sample,
    // shift the window)
    const bool done = kOne ? i == f0 + 2 : act[0];
#pragma unroll
    for (int it = 0; it < C::kIPT; ++it) {
      if (done && own_off[it] >= 0) {
        const int k = k0 + own_q[it] * C::kV;
        const long long o = (frame_base(kOne ? f0 : i - 2) + own_off[it]) * g.cin + k;
        if (a.vec) {
          if constexpr (C::kF32) {
            *reinterpret_cast<float4*>(a.dx + o) =
                make_float4(acc[it][0][0], acc[it][0][1], acc[it][0][2], acc[it][0][3]);
          } else {
            uint4 out;
            uint32_t* ow = &out.x;
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2) {
              const __nv_bfloat162 pr = __floats2bfloat162_rn(acc[it][0][2 * c2], acc[it][0][2 * c2 + 1]);
              ow[c2] = *reinterpret_cast<const uint32_t*>(&pr);
            }
            *reinterpret_cast<uint4*>(a.dx + o) = out;
          }
        } else {
#pragma unroll
          for (int c = 0; c < C::kV; ++c) {
            if (k + c < g.cin) a.dx[o + c] = from_f<T>(acc[it][0][c]);
          }
        }
      }
      if constexpr (!kOne) {
#pragma unroll
        for (int c = 0; c < C::kV; ++c) {
          acc[it][0][c] = acc[it][1][c];
          acc[it][1][c] = acc[it][2][c];
          acc[it][2][c] = 0.f;
        }
        xr[it][0] = xr[it][1];
        xr[it][1] = xr[it][2];
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// host side: instances, plans, launches
// ---------------------------------------------------------------------------

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on the H100
constexpr int kSmemPerSm = 233472;  // shared memory of one SM
constexpr int kSms = 132;

int ceil_div(int a, int b) { return (a + b - 1) / b; }

struct FwdInst {
  int bm, bn, ks, nt;
};

// The forward instances of each element type; a plan names one by index.
// Of the instances swept (tiles of 16-128 rows and 32-128 columns, slabs of
// 16-128 channels), those the plans choose at I3D's nine branch-3 sites:
// wide boxes with narrow slabs where rows are many (Mixed_3), short boxes
// with 128-channel slabs where they are few (Mixed_5: fewer slabs in series).
constexpr FwdInst kFwdF32[] = {{128, 32, 16, 256}, {64, 64, 16, 256}, {32, 128, 16, 256}, {64, 32, 32, 256},
                               {16, 32, 128, 128}};
constexpr FwdInst kFwdBf16[] = {{128, 32, 32, 256}, {64, 64, 32, 128}, {32, 64, 64, 256}, {32, 64, 128, 256}};
constexpr int kFwdInstsMax = 5;

template <typename T>
constexpr const FwdInst* fwd_insts() {
  return std::is_same<T, float>::value ? kFwdF32 : kFwdBf16;
}

template <typename T>
constexpr int fwd_inst_count() {
  return std::is_same<T, float>::value ? sizeof(kFwdF32) / sizeof(FwdInst) : sizeof(kFwdBf16) / sizeof(FwdInst);
}

struct FwdPlan {
  int inst, bt, bh, bw;
};
struct BwdPlan {
  int bh, bw, chunk;
};

// A plan forced from outside (the sweep in chip_smoke.py); inst < 0: none.
FwdPlan g_fwd_force = {-1, 0, 0, 0};
BwdPlan g_bwd_force = {0, 0, 0};

// Plans by (dtype, instance, shape): a plan costs a search, a launch a lookup.
template <typename P>
class PlanCache {
 public:
  bool get(const int (&key)[8], P* out) {
    std::lock_guard<std::mutex> guard(mu_);
    for (int i = 0; i < count_; ++i) {
      if (std::memcmp(entries_[i].key, key, sizeof(key)) == 0) {
        *out = entries_[i].plan;
        return true;
      }
    }
    return false;
  }
  void put(const int (&key)[8], const P& plan) {
    std::lock_guard<std::mutex> guard(mu_);
    std::memcpy(entries_[next_].key, key, sizeof(key));
    entries_[next_].plan = plan;
    next_ = (next_ + 1) % kEntries;
    if (count_ < kEntries) ++count_;
  }

 private:
  static constexpr int kEntries = 64;
  struct Entry {
    int key[8];
    P plan;
  };
  std::mutex mu_;
  Entry entries_[kEntries];
  int count_ = 0, next_ = 0;
};

constexpr int kMaxDevices = 64;

// Lets `kernel` use up to kSmemLimit bytes of dynamic shared memory, once
// per device.
template <typename K>
int allow_smem(K kernel, bool (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (e != cudaSuccess) return static_cast<int>(e);
    done[dev] = true;
  }
  return 0;
}

size_t fwd_smem(bool f32, const FwdInst& in, int bt, int bh, int bw) {  // FwdCfg::smem_bytes
  const size_t es = f32 ? 4 : 2;
  const bool one_pass = in.bm <= 32;  // FwdCfg::kOnePass
  const size_t stages = one_pass ? 3 : 2;
  const size_t wld = f32 ? in.bn : in.bn + 8;
  const size_t ald = f32 ? in.bm + 4 : in.ks + 8;
  const size_t aelems = f32 ? in.ks * ald : in.bm * ald;
  const size_t nv = static_cast<size_t>(bt + 2) * (bh + 2) * (bw + 2);
  const size_t wm = one_pass ? 0 : static_cast<size_t>(bt + 2) * (bh + 2) * bw * in.ks;
  const size_t xsb = (nv * in.ks * es + 127) / 128 * 128, wsb = (in.ks * wld * es + 15) / 16 * 16;
  return 128 + stages * (xsb + wsb) + es * (wm + aelems) + stages * 8;
}

// Blocks of `threads` threads and `smem` bytes that fit on one SM at once.
int blocks_per_sm(size_t smem, int threads) {
  const int by_smem = static_cast<int>(kSmemPerSm / (smem + 1024));
  const int by_threads = 2048 / threads;
  return by_smem < by_threads ? by_smem : by_threads;
}

// Cost model of the forward, in microseconds on the H100: per wave of
// blocks, per channel slab, a fixed cost (barriers, copy latency) plus the
// slab's staged 16-byte vectors, pool loads and multiply-adds per thread,
// times the blocks sharing an SM (fwd_terms). The constants are the
// non-negative least-squares fit that `chip_smoke.py --fused-sweep` prints
// (phase fused_fit) from the times it reads for every candidate plan, here
// from its run on an H100 80GB HBM3 at 700 W.
constexpr double kFwdCostF32[4] = {1.1239, 0.0, 0.0310, 0.0007};
constexpr double kFwdCostBf16[4] = {1.2449, 0.0, 0.0269, 0.0};

// The terms of the forward cost model (fwd_cost is their dot product with
// kFwdCost*); false if the plan does not fit in shared memory.
bool fwd_terms(bool f32, const Geom& g, const FwdInst& in, int bt, int bh, int bw, double (&t)[4]) {
  const size_t smem = fwd_smem(f32, in, bt, bh, bw);
  if (smem > static_cast<size_t>(kSmemLimit)) return false;
  const int per_sm = blocks_per_sm(smem, in.nt);
  if (per_sm < 1) return false;
  const long long blocks = static_cast<long long>(g.b) * ceil_div(g.t, bt) * ceil_div(g.h, bh) *
                           ceil_div(g.w, bw) * ceil_div(g.cout, in.bn);
  const double waves = static_cast<double>((blocks + kSms * per_sm - 1) / (kSms * per_sm));
  const double res = static_cast<double>(std::min<long long>(per_sm, (blocks + kSms - 1) / kSms));
  const int es = f32 ? 4 : 2, kv = in.ks * es / 16;
  const double nv = static_cast<double>(bt + 2) * (bh + 2) * (bw + 2);
  const double vec = nv * kv + static_cast<double>(in.ks) * in.bn * es / 16;
  const double pool = in.bm <= 32 ? static_cast<double>(bt) * bh * bw * kv * 27
                                  : static_cast<double>(bt + 2) * (bh + 2) * bw * kv * 3 +
                                        static_cast<double>(bh) * bw * kv * 3 * (bt + 2);
  const double mac = static_cast<double>(in.bm) * in.bn * in.ks * (f32 ? 1.0 : 1.0 / 16);
  const double k = waves * ceil_div(g.cin, in.ks);
  t[0] = k;
  t[1] = k * res * vec / in.nt;
  t[2] = k * res * pool / in.nt;
  t[3] = k * res * mac / in.nt;
  return true;
}

double fwd_cost(bool f32, const Geom& g, const FwdInst& in, int bt, int bh, int bw) {
  double t[4];
  if (!fwd_terms(f32, g, in, bt, bh, bw, t)) return 1e30;
  const double* c = f32 ? kFwdCostF32 : kFwdCostBf16;
  return c[0] * t[0] + c[1] * t[1] + c[2] * t[2] + c[3] * t[3];
}

// The plans a forward launch chooses from (and `chip_smoke.py --fused-sweep`
// times): each instance that does not leave half its column tile empty,
// with boxes of 1 frame (per-frame) or 1, 2, 4 and T frames (whole-sample),
// 1/4, 1/2, all of W or 8 columns, and as many rows as fit.
template <typename T>
int fwd_candidates(const Geom& g, bool tblock, FwdPlan* out, int cap) {
  int n = 0;
  const int bts[4] = {1, 2, 4, g.t}, bws[4] = {g.w, ceil_div(g.w, 2), ceil_div(g.w, 4), 8};
  for (int i = 0; i < fwd_inst_count<T>(); ++i) {
    const FwdInst& in = fwd_insts<T>()[i];
    if (in.bn > 32 && in.bn / 2 >= g.cout) continue;
    for (int a = 0; a < (tblock ? 4 : 1); ++a) {
      for (int c = 0; c < 4; ++c) {
        const int bt = bts[a], bw = bws[c];
        if (bt > g.t || bw > g.w || bt * bw > in.bm) continue;
        const FwdPlan p{i, bt, std::min(g.h, in.bm / (bt * bw)), bw};
        bool seen = false;
        for (int k = 0; k < n; ++k) {
          seen |= out[k].inst == p.inst && out[k].bt == p.bt && out[k].bh == p.bh && out[k].bw == p.bw;
        }
        if (!seen && n < cap) out[n++] = p;
      }
    }
  }
  return n;
}

template <typename T>
FwdPlan fwd_plan(const Geom& g, bool tblock) {
  if (g_fwd_force.inst >= 0) return g_fwd_force;
  static PlanCache<FwdPlan> cache;
  const int key[8] = {static_cast<int>(sizeof(T)), tblock, g.b, g.t, g.h, g.w, g.cin, g.cout};
  FwdPlan best{0, 1, 1, 1};
  if (cache.get(key, &best)) return best;
  FwdPlan cands[kFwdInstsMax * 16];
  const int n = fwd_candidates<T>(g, tblock, cands, kFwdInstsMax * 16);
  double best_cost = 1e31, best_vol = 0;
  long long best_blocks = 0;
  for (int k = 0; k < n; ++k) {
    const FwdPlan& p = cands[k];
    const FwdInst& in = fwd_insts<T>()[p.inst];
    const double c = fwd_cost(std::is_same<T, float>::value, g, in, p.bt, p.bh, p.bw);
    const long long blocks = static_cast<long long>(g.b) * ceil_div(g.t, p.bt) * ceil_div(g.h, p.bh) *
                             ceil_div(g.w, p.bw) * ceil_div(g.cout, in.bn);
    const double vol = static_cast<double>(blocks) * (p.bt + 2) * (p.bh + 2) * (p.bw + 2);  // staged voxels
    // a tie (the model sees the same waves and slabs) goes to more blocks
    // while some SMs would idle, else to the fewer staged voxels
    const bool tie = c <= best_cost * (1 + 1e-9);
    const bool wins = c < best_cost * (1 - 1e-9) ||
                      (tie && (std::min(blocks, best_blocks) < kSms ? blocks > best_blocks : vol < best_vol));
    if (wins) {
      best_cost = c;
      best_blocks = blocks;
      best_vol = vol;
      best = p;
    }
  }
  cache.put(key, best);
  return best;
}

template <typename T, int BM, int BN, int KS, int NT>
int launch_fwd_inst(FwdArgs<T> args, cudaStream_t stream) {
  using C = FwdCfg<T, BM, BN, KS, NT>;
  const size_t smem = C::smem_bytes(args.bt, args.bh, args.bw);
  // a shape the TMA cannot take stages with element loads
  args.vec = args.vec && encode_5d(&args.xmap, std::is_same<T, float>::value, args.x, args.g, args.g.cin, KS,
                                   args.bw + 2, args.bh + 2, args.bt + 2);
  if (smem > static_cast<size_t>(kSmemLimit) || args.bt * args.bh * args.bw > BM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set[kMaxDevices] = {};
  const int rc = allow_smem(fpc_fwd<T, BM, BN, KS, NT>, smem_set);
  if (rc != 0) return rc;
  const long long rows = static_cast<long long>(args.g.b) * args.nt * args.nh * args.nw;
  if (rows > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(rows), ceil_div(args.g.cout, BN));
  fpc_fwd<T, BM, BN, KS, NT><<<grid, NT, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int I>
int launch_fwd_idx(const FwdArgs<T>& args, cudaStream_t stream) {
  if constexpr (I >= fwd_inst_count<T>()) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    constexpr FwdInst in = fwd_insts<T>()[I];
    return launch_fwd_inst<T, in.bm, in.bn, in.ks, in.nt>(args, stream);
  }
}

template <typename T>
int dispatch_fwd(int inst, const FwdArgs<T>& args, cudaStream_t stream) {
  switch (inst) {
    case 0: return launch_fwd_idx<T, 0>(args, stream);
    case 1: return launch_fwd_idx<T, 1>(args, stream);
    case 2: return launch_fwd_idx<T, 2>(args, stream);
    case 3: return launch_fwd_idx<T, 3>(args, stream);
    case 4: return launch_fwd_idx<T, 4>(args, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// A channels-last (B, T, H, W, c) tensor as a 5-D TMA tensor map, cut into
// boxes of (box_t, box_h, box_w, box_c); zeros past its edges.
bool encode_5d(CUtensorMap* map, bool f32, const void* base, const Geom& g, int c, int box_c, int box_w,
               int box_h, int box_t) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || box_c > 256 || box_w > 256 || box_h > 256 || box_t > 256) return false;
  const cuuint64_t es = f32 ? 4 : 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(g.w), static_cast<cuuint64_t>(g.h),
                              static_cast<cuuint64_t>(g.t), static_cast<cuuint64_t>(g.b)};
  const cuuint64_t strides[4] = {dims[0] * es, dims[0] * dims[1] * es, dims[0] * dims[1] * dims[2] * es,
                                 dims[0] * dims[1] * dims[2] * dims[3] * es};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(box_c), static_cast<cuuint32_t>(box_w),
                             static_cast<cuuint32_t>(box_h), static_cast<cuuint32_t>(box_t), 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int check_geometry(const Geom& g) {
  if (g.b <= 0 || g.t <= 0 || g.h <= 0 || g.w <= 0 || g.cin <= 0 || g.cout <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch_fwd(bool tblock, const T* x, const T* w, const T* bias, T* y, int b, int t, int h, int wd,
               int cin, int cout, int relu, void* stream) {
  const Geom g{b, t, h, wd, cin, cout};
  const int rc = check_geometry(g);
  if (rc != 0) return rc;
  const FwdPlan pl = fwd_plan<T>(g, tblock);
  if (pl.inst < 0 || pl.inst >= fwd_inst_count<T>() || pl.bt < 1 || pl.bh < 1 || pl.bw < 1 || (!tblock && pl.bt != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  constexpr int v = 16 / sizeof(T);
  FwdArgs<T> args{{}, x, w, bias, y, g, relu, pl.bt, pl.bh, pl.bw, ceil_div(t, pl.bt), ceil_div(h, pl.bh),
                  ceil_div(wd, pl.bw),
                  cin % v == 0 && cout % v == 0 && aligned16(x) && aligned16(w) && aligned16(y)};
  return dispatch_fwd<T>(pl.inst, args, static_cast<cudaStream_t>(stream));
}

// ---- backward plan and launch ----

constexpr int kBwdThreads = 256;
constexpr int kBwdKbF32 = 32, kBwdKbBf16 = 64;

// Cost model of the backward, in microseconds on the H100 (fitted as
// kFwdCost*): per wave, per frame step a fixed cost; per step the staged x
// and the pool planes; per step that computes gc the loads of g and y, the
// gc GEMM, the gather (three accumulators per vector in the whole-sample
// kernel, one in the one-frame kernel) and a cost per Cout chunk.
constexpr double kBwdCostF32[6] = {1.74, 0.0819, 0.0009, 0.0, 0.0719, 0.3009};
constexpr double kBwdCostBf16[6] = {1.9697, 0.0, 0.0069, 0.0691, 0.0490, 0.0148};

template <typename T>
bool bwd_fits(const Geom& g, int bh, int bw) {
  using C = BwdCfg<T, std::is_same<T, float>::value ? kBwdKbF32 : kBwdKbBf16, kBwdThreads>;
  return C::fits(bh, bw) && C::smem_bytes(bh, bw, g.cout) <= static_cast<size_t>(kSmemLimit);
}

// The terms of the backward cost model (bwd_cost is their dot product with
// kBwdCost*); false if the plan does not fit.
template <typename T>
bool bwd_terms(const Geom& g, int bh, int bw, int chunk, double (&t)[6]) {
  constexpr bool f32 = std::is_same<T, float>::value;
  using C = BwdCfg<T, f32 ? kBwdKbF32 : kBwdKbBf16, kBwdThreads>;
  const int kb = f32 ? kBwdKbF32 : kBwdKbBf16;
  if (!bwd_fits<T>(g, bh, bw) || chunk < 1) return false;
  const int per_sm = blocks_per_sm(C::smem_bytes(bh, bw, g.cout), kBwdThreads);
  if (per_sm < 1) return false;
  const long long blocks = static_cast<long long>(ceil_div(g.h, bh)) * ceil_div(g.w, bw) * ceil_div(g.cin, kb) *
                           g.b * ceil_div(g.t, chunk);
  const double waves = static_cast<double>((blocks + kSms * per_sm - 1) / (kSms * per_sm));
  const double res = static_cast<double>(std::min<long long>(per_sm, (blocks + kSms - 1) / kSms));
  const double xp = (bh + 4) * (bw + 4), hp = (bh + 2) * (bw + 2), mrows = C::rows((bh + 2) * (bw + 2));
  const double full = std::min(chunk, g.t) + 2, steps = full + 2;
  const double m = mrows * g.cout * 2 * sizeof(T) / 16;
  const double gemm = hp * kb * g.cout * (f32 ? 1.0 : 1.0 / 16);
  const double gather = static_cast<double>(bh) * bw * C::kKQ * 9 * (chunk == 1 ? 1 : 3);
  const double xs = (xp + 3 * hp) * C::kKQ;
  t[0] = waves * steps;
  t[1] = waves * res * full * m / kBwdThreads;
  t[2] = waves * res * full * gemm / kBwdThreads;
  t[3] = waves * res * full * gather / kBwdThreads;
  t[4] = waves * res * steps * xs / kBwdThreads;
  t[5] = waves * full * ceil_div(g.cout, C::kJC);
  return true;
}

template <typename T>
double bwd_cost(const Geom& g, int bh, int bw, int chunk) {
  double t[6];
  if (!bwd_terms<T>(g, bh, bw, chunk, t)) return 1e30;
  const double* c = std::is_same<T, float>::value ? kBwdCostF32 : kBwdCostBf16;
  double sum = 0;
  for (int i = 0; i < 6; ++i) sum += c[i] * t[i];
  return sum;
}

// The plans a backward launch chooses from (and the sweep times): tiles of
// up to 64 pixels whose halo fits, chunks of 1 frame (per-frame) or 1, 2, 4
// and T frames (whole-sample).
template <typename T>
int bwd_candidates(const Geom& g, bool tblock, BwdPlan* out, int cap) {
  constexpr int kTiles[10][2] = {{4, 8}, {7, 7}, {8, 8}, {7, 8}, {6, 10}, {4, 14}, {5, 12}, {4, 16}, {14, 4}, {2, 28}};
  const int chunks[4] = {1, 2, 4, g.t};
  int n = 0;
  for (const auto& tile : kTiles) {
    const int bh = std::min(g.h, tile[0]), bw = std::min(g.w, tile[1]);
    if (!bwd_fits<T>(g, bh, bw)) continue;
    for (int a = 0; a < (tblock ? 4 : 1); ++a) {
      const BwdPlan p{bh, bw, chunks[a]};
      if (p.chunk > g.t) continue;
      bool seen = false;
      for (int k = 0; k < n; ++k) seen |= out[k].bh == p.bh && out[k].bw == p.bw && out[k].chunk == p.chunk;
      if (!seen && n < cap) out[n++] = p;
    }
  }
  return n;
}

template <typename T>
BwdPlan bwd_plan(const Geom& g, bool tblock) {
  if (g_bwd_force.bh > 0) return g_bwd_force;
  static PlanCache<BwdPlan> cache;
  const int key[8] = {static_cast<int>(sizeof(T)), tblock, g.b, g.t, g.h, g.w, g.cin, g.cout};
  BwdPlan best{0, 0, 1};
  if (cache.get(key, &best)) return best;
  BwdPlan cands[40];
  const int n = bwd_candidates<T>(g, tblock, cands, 40);
  double best_cost = 1e31;
  for (int k = 0; k < n; ++k) {
    const double c = bwd_cost<T>(g, cands[k].bh, cands[k].bw, cands[k].chunk);
    if (c < best_cost) {
      best_cost = c;
      best = cands[k];
    }
  }
  cache.put(key, best);
  return best;
}

template <typename T>
int launch_bwd(bool tblock, const T* x, const T* y, const T* gy, const T* w, T* dx, int b, int t, int h,
               int wd, int cin, int cout, int relu, void* stream) {
  constexpr int kb = std::is_same<T, float>::value ? kBwdKbF32 : kBwdKbBf16;
  using C = BwdCfg<T, kb, kBwdThreads>;
  const Geom g{b, t, h, wd, cin, cout};
  int rc = check_geometry(g);
  if (rc != 0) return rc;
  const BwdPlan pl = bwd_plan<T>(g, tblock);
  if (pl.bh < 1 || pl.bw < 1 || pl.chunk < 1 || !bwd_fits<T>(g, pl.bh, pl.bw) || (!tblock && pl.chunk != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = ceil_div(t, pl.chunk);
  if (static_cast<long long>(b) * nchunks > 65535 || ceil_div(cin, kb) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = C::smem_bytes(pl.bh, pl.bw, cout);
  // a chunk of one frame takes the one-frame kernel, whichever entry asked
  const bool one = pl.chunk == 1;
  static bool smem_set[2][kMaxDevices] = {};
  rc = one ? allow_smem(fpc_bwd<T, kb, kBwdThreads, true>, smem_set[1])
           : allow_smem(fpc_bwd<T, kb, kBwdThreads, false>, smem_set[0]);
  if (rc != 0) return rc;
  constexpr int v = 16 / sizeof(T);
  const BwdArgs<T> args{x, y, gy, w, dx, g, relu, pl.bh, pl.bw, pl.chunk, ceil_div(h, pl.bh), ceil_div(wd, pl.bw),
                        nchunks,
                        cin % v == 0 && cout % v == 0 && aligned16(x) && aligned16(y) && aligned16(gy) &&
                            aligned16(dx)};
  const dim3 grid(args.nh * args.nw, ceil_div(cin, kb), b * nchunks);
  if (one) {
    fpc_bwd<T, kb, kBwdThreads, true><<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  } else {
    fpc_bwd<T, kb, kBwdThreads, false><<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(args);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (b, t, h, w, cout) = act(pool(x) @ w + bias), per-frame instance. x (b,
// t, h, w, cin), w (cin, cout), bias (cout,): contiguous, all of one dtype
// (float32, or bfloat16 for the _bf16 entries), on the current device.
// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// _tblock_ entries run the whole-sample instance.
extern "C" int fused_pool_conv_fwd_f32(const float* x, const float* w, const float* bias,
                                       float* y, int b, int t, int h, int wd, int cin,
                                       int cout, int relu, void* stream) {
  return launch_fwd(false, x, w, bias, y, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_tblock_fwd_f32(const float* x, const float* w,
                                              const float* bias, float* y, int b, int t,
                                              int h, int wd, int cin, int cout, int relu,
                                              void* stream) {
  return launch_fwd(true, x, w, bias, y, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                        const __nv_bfloat16* bias, __nv_bfloat16* y, int b,
                                        int t, int h, int wd, int cin, int cout, int relu,
                                        void* stream) {
  return launch_fwd(false, x, w, bias, y, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_tblock_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                               const __nv_bfloat16* bias, __nv_bfloat16* y,
                                               int b, int t, int h, int wd, int cin, int cout,
                                               int relu, void* stream) {
  return launch_fwd(true, x, w, bias, y, b, t, h, wd, cin, cout, relu, stream);
}

// dx (b, t, h, w, cin) = the input gradient of the forward given its input
// x, its output y and the gradient gy of y (both (b, t, h, w, cout)); w
// (cin, cout); one dtype throughout. Returns cudaGetLastError().
extern "C" int fused_pool_conv_bwd_f32(const float* x, const float* y, const float* gy,
                                       const float* w, float* dx, int b, int t, int h,
                                       int wd, int cin, int cout, int relu, void* stream) {
  return launch_bwd(false, x, y, gy, w, dx, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_tblock_bwd_f32(const float* x, const float* y,
                                              const float* gy, const float* w, float* dx,
                                              int b, int t, int h, int wd, int cin, int cout,
                                              int relu, void* stream) {
  return launch_bwd(true, x, y, gy, w, dx, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                                        const __nv_bfloat16* gy, const __nv_bfloat16* w,
                                        __nv_bfloat16* dx, int b, int t, int h, int wd,
                                        int cin, int cout, int relu, void* stream) {
  return launch_bwd(false, x, y, gy, w, dx, b, t, h, wd, cin, cout, relu, stream);
}

extern "C" int fused_pool_conv_tblock_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* y,
                                               const __nv_bfloat16* gy, const __nv_bfloat16* w,
                                               __nv_bfloat16* dx, int b, int t, int h, int wd,
                                               int cin, int cout, int relu, void* stream) {
  return launch_bwd(true, x, y, gy, w, dx, b, t, h, wd, cin, cout, relu, stream);
}

// Forces the plans of the next launches (the sweep of chip_smoke.py): the
// forward's instance (an index of kFwdF32 / kFwdBf16) and box, the
// backward's tile and chunk. fwd_inst < 0 and bwd_bh <= 0 restore the
// plans. Returns 0.
extern "C" int fused_branch3_force_plan(int fwd_inst, int bt, int bh, int bw, int bwd_bh, int bwd_bw,
                                        int bwd_chunk) {
  g_fwd_force = FwdPlan{fwd_inst, bt, bh, bw};
  g_bwd_force = BwdPlan{bwd_bh, bwd_bw, bwd_chunk};
  return 0;
}

// The plans the launches would take for this shape, written to out[0..6]:
// fwd instance, bt, bh, bw; bwd bh, bw, chunk. dtype 0 float32, 1 bf16.
extern "C" int fused_branch3_plan(int dtype, int tblock, int b, int t, int h, int wd, int cin, int cout,
                                  int* out) {
  const Geom g{b, t, h, wd, cin, cout};
  if (check_geometry(g) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const FwdPlan f = dtype == 0 ? fwd_plan<float>(g, tblock != 0) : fwd_plan<bf16>(g, tblock != 0);
  const BwdPlan k = dtype == 0 ? bwd_plan<float>(g, tblock != 0) : bwd_plan<bf16>(g, tblock != 0);
  out[0] = f.inst;
  out[1] = f.bt;
  out[2] = f.bh;
  out[3] = f.bw;
  out[4] = k.bh;
  out[5] = k.bw;
  out[6] = k.chunk;
  return 0;
}

// The candidate plans of the whole-sample launches for this shape (a
// superset of the per-frame ones), 4 ints each into out (at most cap
// plans): forward (bwd = 0) instance, bt, bh, bw; backward bh, bw, chunk, 0.
// Returns their number. dtype 0 float32, 1 bf16.
extern "C" int fused_branch3_candidates(int dtype, int bwd, int t, int h, int wd, int cin, int cout, int* out,
                                        int cap) {
  const Geom g{1, t, h, wd, cin, cout};
  if (check_geometry(g) != 0 || cap <= 0) return 0;
  if (bwd) {
    BwdPlan c[40];
    const int n = dtype == 0 ? bwd_candidates<float>(g, true, c, 40) : bwd_candidates<bf16>(g, true, c, 40);
    for (int k = 0; k < n && k < cap; ++k) {
      out[4 * k] = c[k].bh;
      out[4 * k + 1] = c[k].bw;
      out[4 * k + 2] = c[k].chunk;
      out[4 * k + 3] = 0;
    }
    return std::min(n, cap);
  }
  FwdPlan c[kFwdInstsMax * 16];
  const int n = dtype == 0 ? fwd_candidates<float>(g, true, c, kFwdInstsMax * 16)
                           : fwd_candidates<bf16>(g, true, c, kFwdInstsMax * 16);
  for (int k = 0; k < n && k < cap; ++k) {
    out[4 * k] = c[k].inst;
    out[4 * k + 1] = c[k].bt;
    out[4 * k + 2] = c[k].bh;
    out[4 * k + 3] = c[k].bw;
  }
  return std::min(n, cap);
}

// The terms of the cost model of a plan for this shape (at most 6 doubles
// into out): forward (bwd = 0) plan (instance, bt, bh, bw), backward plan
// (bh, bw, chunk, unused). Returns the number of terms (4 forward, 6
// backward), 0 if the plan does not fit. The plans' cost is the terms' dot
// product with kFwdCost* / kBwdCost*, which `chip_smoke.py --fused-sweep`
// fits to the times it reads.
extern "C" int fused_branch3_cost_terms(int dtype, int bwd, int b, int t, int h, int wd, int cin, int cout, int p0,
                                        int p1, int p2, int p3, double* out) {
  const Geom g{b, t, h, wd, cin, cout};
  if (check_geometry(g) != 0) return 0;
  if (bwd) {
    double terms[6];
    const bool ok = dtype == 0 ? bwd_terms<float>(g, p0, p1, p2, terms) : bwd_terms<bf16>(g, p0, p1, p2, terms);
    if (!ok) return 0;
    for (int i = 0; i < 6; ++i) out[i] = terms[i];
    return 6;
  }
  if (p0 < 0 || p0 >= (dtype == 0 ? fwd_inst_count<float>() : fwd_inst_count<bf16>()) || p1 < 1 || p2 < 1 ||
      p3 < 1) {
    return 0;
  }
  double terms[4];
  if (!fwd_terms(dtype == 0, g, dtype == 0 ? kFwdF32[p0] : kFwdBf16[p0], p1, p2, p3, terms)) return 0;
  for (int i = 0; i < 4; ++i) out[i] = terms[i];
  return 4;
}
