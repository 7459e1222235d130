// Pointwise (1x1x1) 3D convolution as a GEMM: Y = act(X @ W + b), float32
// (pw_gemm_f32) and bfloat16 (pw_gemm_bf16).
//
// Replaces the Pallas TPU kernel ivf_tpu/ops/pallas/pointwise_conv.py,
// function pallas_pointwise_conv (kernel body _kernel, pallas_call in
// _pw_impl). That kernel ran (256 x Cin) row blocks through the MXU with
// bias + ReLU in the epilogue, after zero-padding every operand to the
// 128-lane tile. Its VJP reuses it for dx = m @ W^T; so does this one
// (ivf_tpu_torch/ops/kernels/pointwise_conv.py).
//
// What bounds it on the H100: X is (N, Cin) with N = B*T*H*W, W is
// (Cin, Cout). It does Cin*Cout / (2*(Cin + Cout)) FLOPs per byte of X and
// Y, 16 for the 64 -> 64 Conv3d_2b and ~46 for the 192 -> 176 trio of
// Mixed_3b. Against the card's float32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte) the Inception 1x1x1 convs are bound by
// operations, Conv3d_2b and the N = B logits head by bytes.
//
// Design: one 256-thread block per 64 x 64 tile of Y. K advances in slabs
// of 16 staged through shared memory (X stored K-major so the inner loop
// reads a broadcast row); each thread keeps a 4 x 4 micro-tile in
// registers (rows ty + 16*i, columns tx + 16*j, so that shared-memory reads
// of W and the stores of Y are consecutive across a warp) and accumulates
// with fmaf. Bias and ReLU are applied in registers before the one store.
// Ragged N / Cin / Cout edges are masked in the loads and the store: no
// padded copies. Not yet done: tensor cores (TF32/bf16 wgmma), TMA, double
// buffering of the slabs.
//
// bfloat16 (pw_gemm_bf16): the Pallas kernel's bf16 arithmetic --
// bf16 operands, float32 accumulation, the bias upcast and added in
// float32, the ReLU, one rounding to bf16 at the store. In bf16 the card's
// ridge is ~295 operations per byte, so every 1x1x1 conv of I3D (<= ~190
// per byte) is bound by bytes: X and Y at 2 bytes a value. Design: one
// 128-thread block per 64 x 64 tile of Y; K in slabs of 32 staged in
// shared memory (zero-filled past the ragged N / Cin / Cout edges, so no
// shape is assumed, N = batch for the logits head included); each of the
// four warps owns a 32 x 32 quarter as 2 x 2 nvcuda::wmma 16x16x16 bf16
// fragments with float32 accumulators on the tensor cores; the epilogue
// goes through shared memory to add the bias, apply the ReLU and store
// bf16 with the edges masked. Not yet done: wgmma, TMA, vector loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int kTileM = 64;     // rows of X and Y per block
constexpr int kTileN = 64;     // columns of W and Y per block
constexpr int kTileK = 16;     // depth of one shared-memory slab
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
pw_gemm_f32(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ bias, float* __restrict__ y,
            long long n, int cin, int cout, int relu) {
  __shared__ float xs[kTileK][kTileM + 1];
  __shared__ float ws[kTileK][kTileN];

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long row0 = static_cast<long long>(blockIdx.x) * kTileM;
  const int col0 = blockIdx.y * kTileN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < cin; k0 += kTileK) {
    for (int e = threadIdx.x; e < kTileM * kTileK; e += kThreads) {
      const int r = e / kTileK;
      const int c = e % kTileK;
      const long long gr = row0 + r;
      const int gc = k0 + c;
      xs[c][r] = (gr < n && gc < cin) ? x[gr * cin + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < kTileK * kTileN; e += kThreads) {
      const int r = e / kTileN;
      const int c = e % kTileN;
      const int gr = k0 + r;
      const int gc = col0 + c;
      ws[r][c] = (gr < cin && gc < cout)
                     ? w[static_cast<long long>(gr) * cout + gc]
                     : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[4];
      float b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = row0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[c];
      if (relu && v < 0.f) v = 0.f;
      y[r * cout + c] = v;
    }
  }
}

constexpr int kBfTile = 64;     // rows and columns of Y per block
constexpr int kBfK = 32;        // depth of one shared-memory slab
constexpr int kBfThreads = 128; // four warps, 32 x 32 of Y each
constexpr int kBfPad = 8;       // keeps wmma's leading dimensions a multiple of 8

__global__ void __launch_bounds__(kBfThreads)
pw_gemm_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
             long long n, int cin, int cout, int relu) {
  using namespace nvcuda;
  __shared__ __align__(32) __nv_bfloat16 xs[kBfTile][kBfK + kBfPad];
  __shared__ __align__(32) __nv_bfloat16 ws[kBfK][kBfTile + kBfPad];
  __shared__ __align__(32) float cs[kBfTile][kBfTile + 4];

  const long long row0 = static_cast<long long>(blockIdx.x) * kBfTile;
  const int col0 = blockIdx.y * kBfTile;
  const int warp = threadIdx.x / 32;
  const int wr = (warp / 2) * 32;  // the warp's rows and columns in the tile
  const int wc = (warp % 2) * 32;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  for (int k0 = 0; k0 < cin; k0 += kBfK) {
    for (int e = threadIdx.x; e < kBfTile * kBfK; e += kBfThreads) {
      const int r = e / kBfK;
      const int c = e % kBfK;
      const long long gr = row0 + r;
      const int gc = k0 + c;
      xs[r][c] = (gr < n && gc < cin) ? x[gr * cin + gc] : zero;
    }
    for (int e = threadIdx.x; e < kBfK * kBfTile; e += kBfThreads) {
      const int r = e / kBfTile;
      const int c = e % kBfTile;
      const int gr = k0 + r;
      const int gc = col0 + c;
      ws[r][c] = (gr < cin && gc < cout) ? w[static_cast<long long>(gr) * cout + gc] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBfK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(a[i], &xs[wr + 16 * i][kk], kBfK + kBfPad);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(b[j], &ws[kk][wc + 16 * j], kBfTile + kBfPad);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&cs[wr + 16 * i][wc + 16 * j], acc[i][j], kBfTile + 4,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kBfTile * kBfTile; e += kBfThreads) {
    const int r = e / kBfTile;
    const int c = e % kBfTile;
    const long long gr = row0 + r;
    const int gc = col0 + c;
    if (gr >= n || gc >= cout) continue;
    float v = cs[r][c];
    if (bias != nullptr) v += __bfloat162float(bias[gc]);
    if (relu && v < 0.f) v = 0.f;
    y[gr * cout + gc] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// Y (n, cout) = act(X (n, cin) @ W (cin, cout) + bias), all row-major and
// contiguous on the current device; bias may be null. Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pw_conv_f32(const float* x, const float* w, const float* bias,
                           float* y, long long n, int cin, int cout,
                           int relu, void* stream) {
  if (n <= 0 || cin < 0 || cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (n + kTileM - 1) / kTileM;
  if (row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((cout + kTileN - 1) / kTileN));
  pw_gemm_f32<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, bias, y, n, cin, cout, relu);
  return static_cast<int>(cudaGetLastError());
}

// The bfloat16 GEMM: X (n, cin), W (cin, cout), bias (cout) or null, Y
// (n, cout), all bfloat16, row-major and contiguous on the current device;
// float32 accumulation, one rounding at the store. Returns
// cudaGetLastError() (0 on success).
extern "C" int pw_conv_bf16(const void* x, const void* w, const void* bias,
                            void* y, long long n, int cin, int cout,
                            int relu, void* stream) {
  if (n <= 0 || cin < 0 || cout <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long row_tiles = (n + kBfTile - 1) / kBfTile;
  if (row_tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(row_tiles),
                  static_cast<unsigned>((cout + kBfTile - 1) / kBfTile));
  pw_gemm_bf16<<<grid, kBfThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), n, cin,
      cout, relu);
  return static_cast<int>(cudaGetLastError());
}
