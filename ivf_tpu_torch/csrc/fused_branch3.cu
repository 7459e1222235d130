// Fused Inception branch 3 of I3D: 3x3x3 stride-1 zero-padded SAME max pool
// -> 1x1x1 conv -> bias [-> ReLU], forward and input gradient, float32 and
// bfloat16, channels-last: x (B, T, H, W, Cin), w (Cin, Cout), b (Cout,).
//
// Replaces the Pallas TPU kernels of ivf_tpu/ops/pallas/fused_branch3.py:
//   fused_pool_conv (grid over (b, t) frames): forward _fwd_kernel, backward
//     _bwd_kernel  ->  fpc_frame_fwd, fpc_frame_bwd here;
//   fused_pool_conv_tblock (grid over whole samples): forward
//     _fwd_kernel_tb, backward _bwd_kernel_tb  ->  fpc_tblock_fwd,
//     fpc_tblock_bwd here.
// All four compute, with P = pool(x) and [y != 0] only under the ReLU,
//   y  = act(P @ w + b)
//   gc = (g * [y != 0]) @ w^T
//   dx[t,h,w,k] = sum over in-range neighbours n of (x[t,h,w,k] == P[n,k]) * gc[n,k]
// which credits every tied maximum (the rule of csrc/maxpool3d.cu). The
// pooled tensor and gc never go to device memory: they live in registers
// and shared memory. Out-of-range neighbours read as 0 in the pool (the
// zero padding) and are skipped in the gather. dw and db are left to
// PyTorch, as the JAX package left them to XLA.
//
// Rounding: the pool and the gather are exact. Each GEMM output is one
// fmaf chain over its depth in ascending order (Cin for y, Cout for gc),
// and the gather adds its terms in (dt, dh, dw) ascending order, as
// pw_gemm_f32 and pool_bwd do; so on the same inputs these kernels give
// the same bits as the unfused maxpool3d_s1 + pointwise_conv pair.
//
// What bounds it on the H100. Counting each tensor once, the forward
// moves 4 (Cin + Cout) bytes per voxel for 2 Cin Cout FLOPs plus 26 Cin
// max ops; at Mixed_3b (Cin 192, Cout 32) that is ~14 operations per
// byte, under the card's float32 ridge (67 TFLOP/s over 3.35 TB/s = 20),
// so bytes bound it; at Mixed_3c and later (Cout 64-128) operations do.
// The backward reads x, y, g and writes dx: bytes bound it except at the
// Cout-128 sites. Against those bounds these kernels are simple, not fast:
// CUDA-core fmaf tiles, no tensor cores, TMA or double buffering.
//
// Why the design differs from the TPU's. The Pallas kernels hold whole
// (H, W, Cin) frames or whole (T, H, W, 128) samples in VMEM, which holds
// many MB; a Hopper block has at most 227 KB of shared memory. So every
// kernel here tiles (H, W) and recomputes the pool over a halo.
//
// fpc_frame_fwd: a 64 x 64 tile of the GEMM over the rows (h, w) of one
//   (b, t) frame, pw_gemm_f32's loop, where loading the A operand computes
//   each pooled (row, k) from the 27 neighbours in x[t-1..t+1]; the
//   re-reads hit L1/L2. Each x frame is read by three frames' tiles, as in
//   the Pallas grid.
// fpc_tblock_fwd: one block per (b, 4 x 4 spatial tile, up to 8 frames,
//   64 output channels): it stages x over the tile plus a 1-voxel halo in
//   (T, H, W), 16 input channels at a time (10 x 6 x 6 x 16 floats), takes
//   the separable max there (H, then W, then T) into a 128-row K-major
//   slab, and runs the GEMM on it; each x voxel comes from device memory
//   about once, plus the halo. 50,752 bytes of dynamic shared memory. A
//   sample of more than 8 frames takes several blocks.
// fpc_tblock_bwd: one block per (b, 8 x 8 spatial tile, 32 input
//   channels) walks all T frames in order with a ring of three frames: for
//   frame i it stages x over the tile plus a 2-voxel halo and takes the
//   3x3 spatial max over the 10 x 10 halo tile; for frame i-1 it finishes
//   the pool (the temporal max of three such planes) and computes gc over
//   the same 10 x 10 tile (a 128 x 32 GEMM over Cout, from g * [y != 0]
//   and w^T); for frame i-2 it gathers the 27 terms against the ring. So
//   gc and the pool are computed once per frame. The TPU grid's three-step
//   temporal split existed for Mosaic's stack frame and is not copied.
//   144,000 bytes of dynamic shared memory: one block per SM.
// fpc_frame_bwd: the same walk over frames t-2..t+2 only, gathering frame
//   t alone: one block per (b, t, spatial tile, channel slab) computes gc
//   and the pool at t-1, t and t+1, as the Pallas kernel does, so each
//   frame's gc is computed three times.
//
// bfloat16 (the *_bf16 entries): every kernel is a template over the
// element type of x, w, b, y, g and dx. A bf16 element is widened to
// float32 as it is loaded, shared memory holds float32 as in the float32
// kernels (the same 50,752 and 144,000 bytes), and each output is rounded
// to bf16 once as it is stored. This is the Pallas kernels' bf16 path
// (ivf_tpu/ops/pallas/fused_branch3.py:57-69, :72-118, :279-290,
// :327-386): the pool is exact in bf16, a bf16 x bf16 product is exact in
// float32, so the forward is the float32 GEMM on the widened operands, plus
// the bias in float32, the ReLU and one rounding; the backward takes
// [y != 0] on the bf16 y and runs in float32 to one rounding of dx. Against
// the float32 kernels it halves the bytes, so its bounds halve: 0.0034 ms
// forward and 0.0067 ms backward at Mixed_3b (batch 4). Tensor cores
// (wgmma) and TMA are left for a later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float max3(float a, float b, float c) {
  return max_nan(max_nan(a, b), c);
}

// element loads widen to float32; stores round to the element type
__device__ __forceinline__ float ld(const float* __restrict__ p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* __restrict__ p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* __restrict__ p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* __restrict__ p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// fpc_frame_fwd
// ---------------------------------------------------------------------------

constexpr int kTileM = 64;  // rows (h, w) of one frame per block
constexpr int kTileN = 64;  // output channels per block
constexpr int kTileK = 16;  // input channels per shared-memory slab

// zero-padded SAME 3x3x3 max at (b, t, h, w, k), read from device memory
template <typename T>
__device__ __forceinline__ float pool27(const T* __restrict__ x, const Geom& g,
                                        int b, int t, int h, int w, int k) {
  float m = ld(x, voxel(g, b, t, h, w) * g.cin + k);
  for (int dt = -1; dt <= 1; ++dt) {
    for (int dh = -1; dh <= 1; ++dh) {
      for (int dw = -1; dw <= 1; ++dw) {
        const int tt = t + dt, hh = h + dh, ww = w + dw;
        m = max_nan(m, inside(g, tt, hh, ww) ? ld(x, voxel(g, b, tt, hh, ww) * g.cin + k) : 0.f);
      }
    }
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fpc_frame_fwd(const T* __restrict__ x, const T* __restrict__ wgt,
              const T* __restrict__ bias, T* __restrict__ y, Geom g, int relu) {
  __shared__ float ps[kTileK][kTileM + 1];
  __shared__ float ws[kTileK][kTileN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int hw = g.h * g.w;
  const int row0 = blockIdx.x * kTileM;
  const int col0 = blockIdx.y * kTileN;
  const int bt = blockIdx.z;
  const int b = bt / g.t;
  const int t = bt % g.t;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < g.cin; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK;
      const int c = e % kTileK;
      const int row = row0 + r;
      const int k = k0 + c;
      ps[c][r] = (row < hw && k < g.cin) ? pool27(x, g, b, t, row / g.w, row % g.w, k) : 0.f;
    }
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
      const int r = e / kTileN;
      const int c = e % kTileN;
      const int k = k0 + r;
      const int n = col0 + c;
      ws[r][c] = (k < g.cin && n < g.cout) ? ld(wgt, static_cast<long long>(k) * g.cout + n) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[4];
      float bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= hw) continue;
    const long long out = (static_cast<long long>(bt) * hw + row) * g.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= g.cout) continue;
      float v = acc[i][j] + ld(bias, n);
      if (relu && v < 0.f) v = 0.f;
      st(y, out + n, v);
    }
  }
}

// ---------------------------------------------------------------------------
// fpc_tblock_fwd
// ---------------------------------------------------------------------------

constexpr int kTbT = 8;                      // frames per block
constexpr int kTbS = 4;                      // spatial tile: 4 x 4
constexpr int kTbK = 16;                     // input channels per slab
constexpr int kTbN = 64;                     // output channels per block
constexpr int kTbRows = kTbT * kTbS * kTbS;  // 128 GEMM rows (tt, hh, ww)
constexpr int kTbPsLd = kTbRows + 1;         // padded row of the K-major slab
constexpr int kTbXs = (kTbT + 2) * (kTbS + 2) * (kTbS + 2) * kTbK;  // staged x
constexpr int kTbHm = (kTbT + 2) * kTbS * (kTbS + 2) * kTbK;        // H-max
constexpr int kTbSmemFloats = kTbXs + kTbHm + kTbK * kTbPsLd + kTbK * kTbN;
constexpr int kTbSmemBytes = kTbSmemFloats * 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fpc_tblock_fwd(const T* __restrict__ x, const T* __restrict__ wgt,
               const T* __restrict__ bias, T* __restrict__ y, Geom g, int relu,
               int tiles_w, int tchunks) {
  extern __shared__ float smem[];
  float* xs = smem;        // [T+2][6][6][K]; then the W-max [T+2][4][4][K]
  float* hm = xs + kTbXs;  // [T+2][4][6][K]
  float* ps = hm + kTbHm;  // [K][kTbPsLd], the pooled slab, K-major
  float* ws = ps + kTbK * kTbPsLd;  // [K][kTbN]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int h0 = (blockIdx.x / tiles_w) * kTbS;
  const int w0 = (blockIdx.x % tiles_w) * kTbS;
  const int col0 = blockIdx.y * kTbN;
  const int b = blockIdx.z / tchunks;
  const int t0 = (blockIdx.z % tchunks) * kTbT;

  // rows ty + 16 * i: frame t0 + i, pixel (h0 + ty / 4, w0 + ty % 4)
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < g.cin; k0 += kTbK) {
    for (int e = threadIdx.x; e < kTbXs; e += kThreads) {
      const int c = e % kTbK;
      const int p = e / kTbK;
      const int t = t0 - 1 + p / 36;
      const int h = h0 - 1 + (p / 6) % 6;
      const int w = w0 - 1 + p % 6;
      const int k = k0 + c;
      xs[e] = (inside(g, t, h, w) && k < g.cin) ? ld(x, voxel(g, b, t, h, w) * g.cin + k) : 0.f;
    }
    for (int e = threadIdx.x; e < kTbK * kTbN; e += kThreads) {
      const int k = k0 + e / kTbN;
      const int n = col0 + e % kTbN;
      ws[e] = (k < g.cin && n < g.cout) ? ld(wgt, static_cast<long long>(k) * g.cout + n) : 0.f;
    }
    __syncthreads();
    // max over H: hm[a][hh][v] = max of xs[a][hh .. hh + 2][v]
    for (int e = threadIdx.x; e < kTbHm; e += kThreads) {
      const int c = e % kTbK;
      const int p = e / kTbK;
      const int v = p % 6;
      const int hh = (p / 6) % 4;
      const int a = p / 24;
      const int base = ((a * 6 + hh) * 6 + v) * kTbK + c;
      hm[e] = max3(xs[base], xs[base + 6 * kTbK], xs[base + 12 * kTbK]);
    }
    __syncthreads();
    // max over W, into xs: wm[a][hh][ww] = max of hm[a][hh][ww .. ww + 2]
    for (int e = threadIdx.x; e < (kTbT + 2) * 16 * kTbK; e += kThreads) {
      const int c = e % kTbK;
      const int p = e / kTbK;
      const int ww = p % 4;
      const int hh = (p / 4) % 4;
      const int a = p / 16;
      const int base = ((a * 4 + hh) * 6 + ww) * kTbK + c;
      xs[e] = max3(hm[base], hm[base + kTbK], hm[base + 2 * kTbK]);
    }
    __syncthreads();
    // max over T: row r = (tt, hh, ww) takes the planes of frames tt-1..tt+1
    for (int e = threadIdx.x; e < kTbRows * kTbK; e += kThreads) {
      const int c = e % kTbK;
      const int r = e / kTbK;
      const int base = r * kTbK + c;
      ps[c * kTbPsLd + r] = max3(xs[base], xs[base + 16 * kTbK], xs[base + 32 * kTbK]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTbK; ++k) {
      float a[8];
      float bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ps[k * kTbPsLd + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = ws[k * kTbN + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const int h = h0 + ty / 4;
  const int w = w0 + ty % 4;
  if (h >= g.h || w >= g.w) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + i;
    if (t >= g.t) continue;
    const long long out = voxel(g, b, t, h, w) * g.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = col0 + tx + 16 * j;
      if (n >= g.cout) continue;
      float v = acc[i][j] + ld(bias, n);
      if (relu && v < 0.f) v = 0.f;
      st(y, out + n, v);
    }
  }
}

// ---------------------------------------------------------------------------
// fpc_frame_bwd and fpc_tblock_bwd: one walk over frames
// ---------------------------------------------------------------------------

constexpr int kBS = 8;               // spatial tile of dx: 8 x 8
constexpr int kBHalo = kBS + 2;      // pool and gc: the tile plus 1 voxel
constexpr int kBX = kBS + 4;         // staged x: the tile plus 2 voxels
constexpr int kBP = kBHalo * kBHalo;  // 100 halo positions
constexpr int kBK = 32;              // input channels per block
constexpr int kBJ = 16;              // output channels per GEMM slab
constexpr int kBRows = 128;          // GEMM rows: the 100 positions, padded
constexpr int kBGsLd = kBRows + 1;
constexpr int kBWtLd = kBK + 1;
constexpr int kBPlane = kBP * kBK;
constexpr int kBSmemFloats =
    kBX * kBX * kBK + 9 * kBPlane + kBJ * kBGsLd + kBJ * kBWtLd;
constexpr int kBSmemBytes = kBSmemFloats * 4;

template <typename T>
struct BwdArgs {
  const T* x;
  const T* y;
  const T* g;
  const T* w;
  T* dx;
  Geom geo;
  int relu;
};

__device__ __forceinline__ int ring(int i) { return ((i % 3) + 3) % 3; }

// dx over frames [f0, f1) of one (b, 8 x 8 tile at (h0, w0), channels k0..)
// block, walking frames f0-2 .. f1+1: see the note at the top of the file.
template <typename T>
__device__ void bwd_walk(const BwdArgs<T>& a, float* smem, int b, int h0, int w0, int k0,
                         int f0, int f1) {
  const Geom& g = a.geo;
  float* xst = smem;                     // [12 * 12][K]  x of one frame
  float* hm = xst + kBX * kBX * kBK;     // [3][100][K]   3x3 spatial max planes
  float* pl = hm + 3 * kBPlane;          // [3][100][K]   the pool
  float* gcb = pl + 3 * kBPlane;         // [3][100][K]   gc
  float* gs = gcb + 3 * kBPlane;         // [J][kBGsLd]   g * [y != 0], J-major
  float* wt = gs + kBJ * kBGsLd;         // [J][kBWtLd]   w^T slab
  const int tid = threadIdx.x;

  for (int i = f0 - 2; i <= f1 + 1; ++i) {
    // 1. the 3x3 spatial max of frame i over the 10 x 10 halo tile
    const bool have = i >= 0 && i < g.t;
    if (have) {
      for (int e = tid; e < kBX * kBX * kBK; e += kThreads) {
        const int c = e % kBK;
        const int p = e / kBK;
        const int h = h0 - 2 + p / kBX;
        const int w = w0 - 2 + p % kBX;
        const int k = k0 + c;
        xst[e] = (inside(g, i, h, w) && k < g.cin) ? ld(a.x, voxel(g, b, i, h, w) * g.cin + k) : 0.f;
      }
    }
    __syncthreads();
    float* hmi = hm + ring(i) * kBPlane;
    for (int e = tid; e < kBPlane; e += kThreads) {
      float m = 0.f;
      if (have) {
        const int c = e % kBK;
        const int p = e / kBK;
        const int u = p / kBHalo;
        const int v = p % kBHalo;
        m = xst[(u * kBX + v) * kBK + c];
#pragma unroll
        for (int du = 0; du < 3; ++du) {
#pragma unroll
          for (int dv = 0; dv < 3; ++dv) m = max_nan(m, xst[((u + du) * kBX + v + dv) * kBK + c]);
        }
      }
      hmi[e] = m;
    }
    __syncthreads();

    // 2. the pool and gc of frame f = i - 1
    const int f = i - 1;
    if (f >= f0 - 1 && f >= 0 && f < g.t) {
      const float* ha = hm + ring(f - 1) * kBPlane;
      const float* hb = hm + ring(f) * kBPlane;
      const float* hc = hm + ring(f + 1) * kBPlane;
      float* plf = pl + ring(f) * kBPlane;
      for (int e = tid; e < kBPlane; e += kThreads) plf[e] = max3(hb[e], ha[e], hc[e]);

      // gc[p][c] = sum_j (g * [y != 0])[p][j] * w[k0 + c][j], p over the halo tile
      const int tx = tid % 8;  // columns tx + 8 * jj
      const int ty = tid / 8;  // rows ty + 32 * ii
      float acc[4][4];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[ii][jj] = 0.f;
      }
      for (int j0 = 0; j0 < g.cout; j0 += kBJ) {
        for (int e = tid; e < kBJ * kBRows; e += kThreads) {
          const int jj = e % kBJ;
          const int p = e / kBJ;
          const int h = h0 - 1 + p / kBHalo;
          const int w = w0 - 1 + p % kBHalo;
          const int j = j0 + jj;
          float v = 0.f;
          if (p < kBP && j < g.cout && inside(g, f, h, w)) {
            const long long o = voxel(g, b, f, h, w) * g.cout + j;
            v = ld(a.g, o);
            if (a.relu && ld(a.y, o) == 0.f) v = 0.f;
          }
          gs[jj * kBGsLd + p] = v;
        }
        for (int e = tid; e < kBJ * kBK; e += kThreads) {
          const int jj = e % kBJ;
          const int c = e / kBJ;
          const int j = j0 + jj;
          const int k = k0 + c;
          wt[jj * kBWtLd + c] =
              (j < g.cout && k < g.cin) ? ld(a.w, static_cast<long long>(k) * g.cout + j) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < kBJ; ++jj) {
          float av[4];
          float bv[4];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) av[ii] = gs[jj * kBGsLd + ty + 32 * ii];
#pragma unroll
          for (int q = 0; q < 4; ++q) bv[q] = wt[jj * kBWtLd + tx + 8 * q];
#pragma unroll
          for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[ii][q] = fmaf(av[ii], bv[q], acc[ii][q]);
          }
        }
        __syncthreads();
      }
      float* gcf = gcb + ring(f) * kBPlane;
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int p = ty + 32 * ii;
        if (p >= kBP) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) gcf[p * kBK + tx + 8 * q] = acc[ii][q];
      }
    }
    __syncthreads();

    // 3. gather frame fg = i - 2: thread (pixel column tid / 32, channel tid % 32)
    const int fg = i - 2;
    if (fg >= f0 && fg < f1) {
      const int c = tid % kBK;
      const int k = k0 + c;
      const int wl = tid / kBK;  // 0..7
      const int w = w0 + wl;
      for (int hl = 0; hl < kBS; ++hl) {
        const int h = h0 + hl;
        if (k >= g.cin || h >= g.h || w >= g.w) continue;
        const long long o = voxel(g, b, fg, h, w) * g.cin + k;
        const float xv = ld(a.x, o);
        float acc = 0.f;
        for (int dt = -1; dt <= 1; ++dt) {
          const int tt = fg + dt;
          if (tt < 0 || tt >= g.t) continue;
          const float* plt = pl + ring(tt) * kBPlane;
          const float* gct = gcb + ring(tt) * kBPlane;
          for (int dh = -1; dh <= 1; ++dh) {
            if (h + dh < 0 || h + dh >= g.h) continue;
            for (int dw = -1; dw <= 1; ++dw) {
              if (w + dw < 0 || w + dw >= g.w) continue;
              const int p = ((hl + 1 + dh) * kBHalo + wl + 1 + dw) * kBK + c;
              if (plt[p] == xv) acc += gct[p];
            }
          }
        }
        st(a.dx, o, acc);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fpc_frame_bwd(BwdArgs<T> a, int tiles_w) {
  extern __shared__ float smem[];
  const int t = blockIdx.z % a.geo.t;
  bwd_walk(a, smem, blockIdx.z / a.geo.t, (blockIdx.x / tiles_w) * kBS,
           (blockIdx.x % tiles_w) * kBS, blockIdx.y * kBK, t, t + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fpc_tblock_bwd(BwdArgs<T> a, int tiles_w) {
  extern __shared__ float smem[];
  bwd_walk(a, smem, blockIdx.z, (blockIdx.x / tiles_w) * kBS, (blockIdx.x % tiles_w) * kBS,
           blockIdx.y * kBK, 0, a.geo.t);
}

int check_geometry(const Geom& g) {
  if (g.b <= 0 || g.t <= 0 || g.h <= 0 || g.w <= 0 || g.cin <= 0 || g.cout <= 0 ||
      g.t > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T>
int launch_fwd(bool tblock, const T* x, const T* w, const T* bias, T* y, int b, int t, int h,
               int wd, int cin, int cout, int relu, void* stream) {
  const Geom g{b, t, h, wd, cin, cout};
  int rc = check_geometry(g);
  if (rc != 0) return rc;
  const auto cs = static_cast<cudaStream_t>(stream);
  if (!tblock) {
    if (static_cast<long long>(b) * t > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(ceil_div(h * wd, kTileM), ceil_div(cout, kTileN), b * t);
    fpc_frame_fwd<T><<<grid, kThreads, 0, cs>>>(x, w, bias, y, g, relu);
    return static_cast<int>(cudaGetLastError());
  }
  const int tchunks = ceil_div(t, kTbT);
  if (static_cast<long long>(b) * tchunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  rc = static_cast<int>(cudaFuncSetAttribute(
      fpc_tblock_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kTbSmemBytes));
  if (rc != 0) return rc;
  const int tiles_w = ceil_div(wd, kTbS);
  const dim3 grid(ceil_div(h, kTbS) * tiles_w, ceil_div(cout, kTbN), b * tchunks);
  fpc_tblock_fwd<T><<<grid, kThreads, kTbSmemBytes, cs>>>(x, w, bias, y, g, relu, tiles_w,
                                                          tchunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(bool tblock, const T* x, const T* y, const T* gy, const T* w, T* dx, int b,
               int t, int h, int wd, int cin, int cout, int relu, void* stream) {
  const Geom g{b, t, h, wd, cin, cout};
  const long long planes = tblock ? b : static_cast<long long>(b) * t;
  int rc = check_geometry(g);
  if (rc != 0 || planes > 65535) return rc != 0 ? rc : static_cast<int>(cudaErrorInvalidValue);
  auto kernel = tblock ? fpc_tblock_bwd<T> : fpc_frame_bwd<T>;
  rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBSmemBytes));
  if (rc != 0) return rc;
  const int tiles_w = ceil_div(wd, kBS);
  const dim3 grid(ceil_div(h, kBS) * tiles_w, ceil_div(cin, kBK), static_cast<unsigned>(planes));
  const BwdArgs<T> args{x, y, gy, w, dx, g, relu};
  kernel<<<grid, kThreads, kBSmemBytes, static_cast<cudaStream_t>(stream)>>>(args, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (b, t, h, w, cout) = act(pool(x) @ w + bias), per-frame kernel. x (b, t,
// h, w, cin), w (cin, cout), bias (cout,): contiguous, all of one dtype
// (float32, or bfloat16 for the _bf16 entries), on the current device.
// Launches on `stream`; returns cudaGetLastError() (0 on success). The
// _tblock_ entries run the whole-sample kernels.
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
