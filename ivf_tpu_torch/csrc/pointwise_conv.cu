// Pointwise (1x1x1) 3D convolution as a GEMM: Y = act(X @ W + b), float32
// (pw_gemm_f32) and bfloat16 (the pw_gemm_bf16_* kernels).
//
// Replaces the Pallas TPU kernel ivf_tpu/ops/pallas/pointwise_conv.py,
// function pallas_pointwise_conv (kernel body _kernel, pallas_call in
// _pw_impl). That kernel ran (256 x Cin) row blocks through the MXU with
// bias + ReLU in the epilogue, after zero-padding every operand to the
// 128-lane tile. Its VJP reuses it for dx = m @ W^T; so does this one
// (ivf_tpu_torch/ops/kernels/pointwise_conv.py).
//
// float32 (pw_gemm_f32). X is (N, Cin) with N = B*T*H*W, W is (Cin, Cout).
// It does Cin*Cout / (2*(Cin + Cout)) FLOPs per byte of X and Y, 16 for the
// 64 -> 64 Conv3d_2b and ~46 for the 192 -> 176 trio of Mixed_3b. Against
// the card's float32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte) the Inception 1x1x1 convs are bound by operations, Conv3d_2b
// and the N = B logits head by bytes. Design: one 256-thread block per
// 64 x 64 tile of Y; K in slabs of 16 staged through shared memory (X
// K-major so the inner loop reads a broadcast row); a 4 x 4 fmaf
// micro-tile per thread; bias and ReLU in registers before the one store;
// ragged edges masked, no padded copies. It still lacks tensor cores
// (TF32 wgmma), TMA and double-buffered slabs, and takes W only as a
// contiguous (Cin, Cout) array (its wrapper makes the copy).
//
// bfloat16: the Pallas kernel's bf16 arithmetic -- bf16 operands, float32
// accumulation, the bias upcast and added in float32, the ReLU, one
// rounding to bf16 at the store. In bf16 the card's ridge is ~295
// operations per byte and every 1x1x1 conv of I3D does at most ~190, so
// each is bound by bytes: the aim is to read X once at full bandwidth and
// write Y once (25088 x 192 -> 176, Mixed_3b's trio at batch 4: 18.5 MB,
// 5.5 us at 3.35 TB/s). W is read as stored, in either layout: (Cin, Cout)
// row-major ("MN-major": Cout contiguous) or the column-major view of a
// (Cout, Cin) conv weight ("K-major": Cin contiguous), so neither the
// forward nor the dx launch copies it. Two paths; the wrapper picks one
// from the shapes, strides and alignment (bf16_plan):
//
// (a) pw_gemm_bf16_tma<BN, TB>, N >= 64 with 16-byte-aligned bases and row
//     strides and Cout a multiple of 8 (every trunk conv of I3D, forward
//     and dx). A persistent grid of at most one 384-thread block per SM
//     walks 128 x BN tiles of Y; the column tiles of one row tile are
//     consecutive tiles, so neighbouring blocks read the same X rows and
//     the second read hits L2. BN (32 to 256 in steps of 32: one wgmma
//     shape each) is the wrapper's choice (tma_width): the least work for
//     the busiest SM, waves x K slabs x (BN + a slab's fixed cost of ~64
//     columns). Many rows take wide tiles, so X is read once or twice; few
//     rows with a long K (Mixed_4, Mixed_5) take narrow ones, spread over
//     more SMs, as a slab's wgmma time grows with BN. One producer
//     warpgroup (one thread, 40 registers after setmaxnreg) keeps a 3-4
//     stage ring of 64-deep K slabs in flight: TMA copies of X (128 x 64) and of W (BN x 64
//     K-major, or 64-column atoms of 64 K rows MN-major), both with the
//     128-byte swizzle, completing on the stage's "full" mbarrier. Two
//     consumer warpgroups (232 registers each) take 64 rows each and run
//     wgmma.mma_async m64nBNk16 .f32.bf16.bf16 with both operands read
//     from shared memory through descriptors in the same swizzle mode
//     (the B descriptor's transpose bit is the W layout, TB), then release
//     the stage on its "empty" mbarrier. TMA zero-fills past the ragged N
//     and K edges. Epilogue: bias in float32, ReLU, one rounding, the
//     64 x BN tile staged in padded shared memory (conflict-free), then
//     16-byte stores with the ragged rows and columns masked.
// (b) pw_gemm_bf16_splitk_{partial,reduce}, every other shape: the logits
//     head (N = batch, 1024 -> 174, and its dx), N < 64, unaligned bases or
//     strides, Cout or Cin not a multiple of 8. K is split into enough
//     chunks of a multiple of 8 to give ~67k threads; each thread sums one
//     output over one chunk in K order with fmaf (16-byte loads where X's
//     rows and W's columns are K-contiguous and aligned, single elements
//     otherwise) into a float32 scratch the wrapper allocates; a second
//     kernel adds the chunks in chunk order, then the bias, the ReLU, one
//     rounding. No atomics: equal bits run to run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

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

// ---- bfloat16, path (a): TMA + wgmma ----

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;             // rows of X and Y per tile: two consumer warpgroups of 64
constexpr int kBK = 64;              // K per slab: 128 bytes of bf16, one 128-byte swizzle row
constexpr int kTmaThreads = 384;     // producer warpgroup + two consumer warpgroups
constexpr int kSmemLimit = 232448;   // dynamic shared memory a block may use on the H100
constexpr int kMaxStages = 4;

template <int BN>
struct TmaCfg {
  static constexpr int kAtoms = (BN + 63) / 64;           // 64-column atoms of an MN-major W slab
  static constexpr int kABytes = kBM * kBK * 2;            // X slab: 128 rows of 128 B
  static constexpr int kBBytesK = BN * kBK * 2;            // K-major W slab: BN rows of 128 B
  static constexpr int kBBytesMN = kAtoms * kBK * 64 * 2;  // MN-major: kAtoms x 64 K rows of 128 B
  static constexpr int kBBytes = kBBytesK > kBBytesMN ? kBBytesK : kBBytesMN;
  static constexpr int kStageBytes = kABytes + kBBytes;    // a multiple of 1024
  static constexpr int kOutPitch = BN + 8;                 // bf16 per staged output row
  static constexpr int kOutBytes = 2 * 64 * kOutPitch * 2;
  static constexpr int kBarBytes = 2 * kMaxStages * 8;
  static constexpr int kFit = (kSmemLimit - 1024 - kOutBytes - kBarBytes) / kStageBytes;
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + kOutBytes + kBarBytes;
  static_assert(kStages >= 2, "shared memory holds fewer than two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// One TMA copy of a (c1, c0) box of `map` into shared memory at `dst`,
// completing on the mbarrier `bar`; c0 is the contiguous coordinate.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo16, uint32_t sbo16) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo16) << 16) |
         (static_cast<uint64_t>(sbo16) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of the accumulators above the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma.mma_async m64nNk16, float32 += bf16 x bf16, A and B from shared
// memory; TB is the B transpose bit (1: W MN-major).
template <int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n96(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, %51;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n160(float (&d)[80], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, %83;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, %99;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n224(float (&d)[112], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111"
      "}, %112, %113, p, 1, 1, 0, %115;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TB));
}

template <int BN, int TB>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 32) wgmma_n32<TB>(d, da, db);
  else if constexpr (BN == 64) wgmma_n64<TB>(d, da, db);
  else if constexpr (BN == 96) wgmma_n96<TB>(d, da, db);
  else if constexpr (BN == 128) wgmma_n128<TB>(d, da, db);
  else if constexpr (BN == 160) wgmma_n160<TB>(d, da, db);
  else if constexpr (BN == 192) wgmma_n192<TB>(d, da, db);
  else if constexpr (BN == 224) wgmma_n224<TB>(d, da, db);
  else if constexpr (BN == 256) wgmma_n256<TB>(d, da, db);
}

// Y (n, cout) = act(X (n, cin) @ W + bias). xmap: X as cin-wide rows, box
// 64 x 128. wmap, TB = 0: W as a (cout, cin) array (K-major), box 64 x BN;
// TB = 1: W as a (cin, cout) array (MN-major), box 64 x 64.
template <int BN, int TB>
__global__ void __launch_bounds__(kTmaThreads, 1)
pw_gemm_bf16_tma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const bf16* __restrict__ bias, bf16* __restrict__ y, int n, int cin, int cout,
                 int col_tiles, int relu) {
  using C = TmaCfg<BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  bf16* out_stage = reinterpret_cast<bf16*>(smem + C::kStages * C::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes + C::kOutBytes);
  uint64_t* full = bars;                // TMA bytes of stage s have landed
  uint64_t* empty = bars + kMaxStages;  // both consumer warpgroups are done with stage s

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int tiles = ((n + kBM - 1) / kBM) * col_tiles;
  const int kslabs = (cin + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (t == 0) {
      const uint32_t bytes = C::kABytes + (TB ? C::kAtoms * kBK * 128 : BN * 128);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int r0 = (tile / col_tiles) * kBM;
        const int c0 = (tile % col_tiles) * BN;
        for (int kb = 0; kb < kslabs; ++kb, ++it) {
          const int s = it % C::kStages;
          mbar_wait(smem_u32(&empty[s]), ((it / C::kStages) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]);
          mbar_expect_tx(bar, bytes);
          const uint32_t a = smem_u32(smem + s * C::kStageBytes);
          tma_load_2d(a, &xmap, bar, kb * kBK, r0);
          if (TB) {
#pragma unroll
            for (int at = 0; at < C::kAtoms; ++at) {
              tma_load_2d(a + C::kABytes + at * (kBK * 128), &wmap, bar, c0 + 64 * at, kb * kBK);
            }
          } else {
            tma_load_2d(a + C::kABytes, &wmap, bar, kb * kBK, c0);
          }
        }
      }
    }
  } else {  // consumers: warpgroup g takes rows 64 g .. 64 g + 63 of every tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1;
    const int warp = t / 32, lane = t % 32;
    bf16* stage_out = out_stage + g * 64 * C::kOutPitch;
    float acc[BN / 2];
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const long long r0 = static_cast<long long>(tile / col_tiles) * kBM + g * 64;
      const int c0 = (tile % col_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < kslabs; ++kb, ++it) {
        const int s = it % C::kStages;
        mbar_wait(smem_u32(&full[s]), (it / C::kStages) & 1);
        const uint32_t a = smem_u32(smem + s * C::kStageBytes) + g * 64 * 128;
        const uint32_t b = smem_u32(smem + s * C::kStageBytes) + C::kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          // K-major: 16 K values are 32 bytes along a swizzled 128-byte row;
          // 8-row groups 1024 bytes apart. MN-major: 16 K rows are 2048
          // bytes; 8-row groups 1024 apart, 64-column atoms 8192 apart.
          const uint64_t da = smem_desc(a + kk * 32, 1, 64);
          const uint64_t db = TB ? smem_desc(b + kk * 2048, 512, 64) : smem_desc(b + kk * 32, 1, 64);
          wgmma_tile<BN, TB>(acc, da, db);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        mbar_arrive(smem_u32(&empty[s]));
      }
      // d[4j], d[4j+1]: row warp*16 + lane/4, columns 8j + 2(lane%4) + {0, 1};
      // d[4j+2], d[4j+3]: the same columns 8 rows below.
      const int rl = warp * 16 + lane / 4;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + (lane % 4) * 2;
        const int gc = c0 + cl;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr && gc < cout) {  // cout % 8 == 0: gc + 1 < cout too
          b0 = __bfloat162float(bias[gc]);
          b1 = __bfloat162float(bias[gc + 1]);
        }
        float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1, acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
        if (relu) {
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = v[q] < 0.f ? 0.f : v[q];
        }
        *reinterpret_cast<__nv_bfloat162*>(&stage_out[rl * C::kOutPitch + cl]) =
            __floats2bfloat162_rn(v[0], v[1]);
        *reinterpret_cast<__nv_bfloat162*>(&stage_out[(rl + 8) * C::kOutPitch + cl]) =
            __floats2bfloat162_rn(v[2], v[3]);
      }
      warpgroup_bar(1 + g);
      constexpr int kChunks = BN / 8;  // 16-byte pieces of a staged row
      for (int q = t; q < 64 * kChunks; q += 128) {
        const int r = q / kChunks, cq = q % kChunks;
        const long long gr = r0 + r;
        const int gc = c0 + cq * 8;
        if (gr < n && gc < cout) {
          *reinterpret_cast<uint4*>(y + gr * cout + gc) =
              *reinterpret_cast<const uint4*>(&stage_out[r * C::kOutPitch + cq * 8]);
        }
      }
      warpgroup_bar(1 + g);
    }
  }
}

// ---- bfloat16, path (b): split K, two passes ----

constexpr int kSplitThreads = 256;

// part[split][i] (i = row * cout + col): X[row, k] * W[k, col] summed with
// fmaf over k in [split * chunk, split * chunk + chunk) in order. `vec`: X's
// rows and W's columns are K-contiguous and 16-byte aligned, chunk and cin
// multiples of 8.
__global__ void __launch_bounds__(kSplitThreads)
pw_gemm_bf16_splitk_partial(const bf16* __restrict__ x, long long sxn, long long sxk,
                            const bf16* __restrict__ w, long long swk, long long swc,
                            float* __restrict__ part, int n, int cin, int cout, int chunk, int vec) {
  const long long nc = static_cast<long long>(n) * cout;
  const long long i = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (i >= nc) return;
  const long long row = i / cout;
  const long long col = i % cout;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(cin, k0 + chunk);
  const bf16* xr = x + row * sxn;
  const bf16* wc = w + col * swc;
  float acc = 0.f;
  if (vec) {
    for (int k = k0; k < k1; k += 8) {
      const uint4 xv = *reinterpret_cast<const uint4*>(xr + k);
      const uint4 wv = *reinterpret_cast<const uint4*>(wc + k);
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
      const __nv_bfloat162* wp = reinterpret_cast<const __nv_bfloat162*>(&wv);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 xf = __bfloat1622float2(xp[q]);
        const float2 wf = __bfloat1622float2(wp[q]);
        acc = fmaf(xf.x, wf.x, acc);
        acc = fmaf(xf.y, wf.y, acc);
      }
    }
  } else {
    for (int k = k0; k < k1; ++k) {
      acc = fmaf(__bfloat162float(xr[k * sxk]), __bfloat162float(wc[k * swk]), acc);
    }
  }
  part[blockIdx.y * nc + i] = acc;
}

// Y[i] = act(sum over splits, in split order, of part[s][i] + bias[col]).
__global__ void __launch_bounds__(kSplitThreads)
pw_gemm_bf16_splitk_reduce(const float* __restrict__ part, int splits, const bf16* __restrict__ bias,
                           bf16* __restrict__ y, int n, int cout, int relu) {
  const long long nc = static_cast<long long>(n) * cout;
  const long long i = static_cast<long long>(blockIdx.x) * kSplitThreads + threadIdx.x;
  if (i >= nc) return;
  float v = part[i];
  for (int s = 1; s < splits; ++s) v += part[s * nc + i];
  if (bias != nullptr) v += __bfloat162float(bias[i % cout]);
  if (relu && v < 0.f) v = 0.f;
  y[i] = __float2bfloat16_rn(v);
}

// ---- bfloat16 host side ----

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in the driver API: reached through the
// runtime's entry-point query, so the library links no libcuda.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiledFn>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A bf16 array of `rows` rows of `cols` elements, `ld` elements apart, cut
// into boxes of box_rows x box_cols with the 128-byte swizzle; zeros past
// the edges.
bool encode_2d(CUtensorMap* map, const void* base, long long rows, long long cols, long long ld,
               int box_cols, int box_rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// W's tensor maps, kept by (pointer, shape, stride, box): a map holds no
// data, so a reused address of the same shape may take the same map.
struct WMap {
  const void* ptr;
  long long rows, cols, ld;
  int box_cols, box_rows;
  CUtensorMap map;
};
constexpr int kWMaps = 64;
std::mutex g_wmap_lock;
WMap g_wmaps[kWMaps];
int g_wmap_count = 0, g_wmap_next = 0;

bool weight_map(CUtensorMap* out, const void* base, long long rows, long long cols, long long ld,
                int box_cols, int box_rows) {
  std::lock_guard<std::mutex> guard(g_wmap_lock);
  for (int i = 0; i < g_wmap_count; ++i) {
    const WMap& e = g_wmaps[i];
    if (e.ptr == base && e.rows == rows && e.cols == cols && e.ld == ld && e.box_cols == box_cols &&
        e.box_rows == box_rows) {
      *out = e.map;
      return true;
    }
  }
  WMap e{base, rows, cols, ld, box_cols, box_rows, {}};
  if (!encode_2d(&e.map, base, rows, cols, ld, box_cols, box_rows)) return false;
  g_wmaps[g_wmap_next] = e;
  g_wmap_next = (g_wmap_next + 1) % kWMaps;
  if (g_wmap_count < kWMaps) ++g_wmap_count;
  *out = e.map;
  return true;
}

constexpr int kMaxDevices = 64;

int sm_count() {
  static int counts[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

template <int BN, int TB>
int launch_tma(const CUtensorMap& xm, const CUtensorMap& wm, const bf16* bias, bf16* y, long long n,
               int cin, int cout, int col_tiles, int relu, cudaStream_t stream) {
  using C = TmaCfg<BN>;
  static bool smem_set[kMaxDevices] = {};  // the > 48 KB opt-in, once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(pw_gemm_bf16_tma<BN, TB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const long long tiles = (n + kBM - 1) / kBM * col_tiles;
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  pw_gemm_bf16_tma<BN, TB><<<grid, kTmaThreads, C::kSmemBytes, stream>>>(
      xm, wm, bias, y, static_cast<int>(n), cin, cout, col_tiles, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int TB>
int dispatch_tma(int bn, const CUtensorMap& xm, const CUtensorMap& wm, const bf16* bias, bf16* y,
                 long long n, int cin, int cout, int relu, cudaStream_t stream) {
  const int col_tiles = (cout + bn - 1) / bn;
  switch (bn) {
    case 32: return launch_tma<32, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 64: return launch_tma<64, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 96: return launch_tma<96, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 128: return launch_tma<128, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 160: return launch_tma<160, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 192: return launch_tma<192, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 224: return launch_tma<224, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    case 256: return launch_tma<256, TB>(xm, wm, bias, y, n, cin, cout, col_tiles, relu, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p, long long ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0;
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

// The bfloat16 GEMM, path (a): X (n, cin) with rows `ldx` elements apart;
// W (cin, cout) with, if w_mn_major, rows `ldw` apart (Cout contiguous),
// else columns `ldw` apart (Cin contiguous: the view of a (cout, cin)
// weight); bias (cout) or null; Y (n, cout) contiguous; all bfloat16 on the
// current device. Needs n >= 64, cout % 8 == 0, 16-byte-aligned X, W and Y,
// ldx and ldw multiples of 8; `bn` (32, 64, ..., 256) is the column tile.
// Float32 accumulation, one rounding at the store. Returns
// cudaGetLastError() (0 on success) or cudaErrorInvalidValue.
extern "C" int pw_conv_bf16_tma(const void* x, long long ldx, const void* w, long long ldw,
                                int w_mn_major, const void* bias, void* y, long long n, int cin,
                                int cout, int bn, int relu, void* stream) {
  if (n < 64 || n > 0x7fffffffLL || cin <= 0 || cout <= 0 || cout % 8 != 0 || ldx < cin ||
      ldw < (w_mn_major ? cout : cin) || !aligned16(x, ldx) || !aligned16(w, ldw) ||
      !aligned16(y, cout)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap xm, wm;
  if (!encode_2d(&xm, x, n, cin, ldx, kBK, kBM)) return static_cast<int>(cudaErrorInvalidValue);
  const bool ok = w_mn_major ? weight_map(&wm, w, cin, cout, ldw, 64, kBK)
                             : weight_map(&wm, w, cout, cin, ldw, kBK, bn);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const bf16* b = static_cast<const bf16*>(bias);
  bf16* out = static_cast<bf16*>(y);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_mn_major ? dispatch_tma<1>(bn, xm, wm, b, out, n, cin, cout, relu, st)
                    : dispatch_tma<0>(bn, xm, wm, b, out, n, cin, cout, relu, st);
}

// The bfloat16 GEMM, path (b): any strides (in elements: X[r, k] at
// x[r * sxn + k * sxk], W[k, c] at w[k * swk + c * swc]); Y (n, cout)
// contiguous; `part` a float32 scratch of splits * n * cout; K cut into
// `splits` chunks of `chunk` (a multiple of 8 when `vec`). Two launches,
// no atomics. Returns cudaGetLastError() (0 on success).
extern "C" int pw_conv_bf16_splitk(const void* x, long long sxn, long long sxk, const void* w,
                                   long long swk, long long swc, const void* bias, void* y,
                                   void* part, long long n, int cin, int cout, int splits, int chunk,
                                   int vec, int relu, void* stream) {
  const long long nc = n * cout;
  if (n <= 0 || n > 0x7fffffffLL || cin < 0 || cout <= 0 || splits <= 0 || splits > 65535 ||
      chunk < 0 || static_cast<long long>(splits) * chunk < cin ||
      (vec && (chunk % 8 != 0 || cin % 8 != 0 || sxk != 1 || swk != 1 || !aligned16(x, sxn) ||
               !aligned16(w, swc)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = (nc + kSplitThreads - 1) / kSplitThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  pw_gemm_bf16_splitk_partial<<<dim3(static_cast<unsigned>(blocks), splits), kSplitThreads, 0, st>>>(
      static_cast<const bf16*>(x), sxn, sxk, static_cast<const bf16*>(w), swk, swc, p,
      static_cast<int>(n), cin, cout, chunk, vec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  pw_gemm_bf16_splitk_reduce<<<static_cast<unsigned>(blocks), kSplitThreads, 0, st>>>(
      p, splits, static_cast<const bf16*>(bias), static_cast<bf16*>(y), static_cast<int>(n), cout,
      relu);
  return static_cast<int>(cudaGetLastError());
}
