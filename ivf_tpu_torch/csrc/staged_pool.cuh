// The tiling of the staged pool kernels (csrc/argmax_pool.cu,
// csrc/maxpool3d.cu): a block takes all frames of one sample (blockIdx.y),
// a tile of th x tw positions and a chunk of v channel vectors of VW
// channels (blockIdx.x), and stages each frame of the tile with its
// one-voxel halo in shared memory. The host plan is
// ops/kernels/argmax_pool.py::plan; plan_launch refuses what it would not
// give.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 224;  // argmax_pool.MAX_THREADS
constexpr int kStageSlots = 2;    // halo vectors a thread stages per frame, at most (argmax_pool.STAGE_SLOTS)

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

struct Launch {
  Args a;
  dim3 grid;
  int threads, nhv;
};

// The grid of a plan (vw channels a thread: `wide`, one 16-byte vector,
// or 1; v vectors, th x tw positions, `threads` threads a block), or an
// error code for one the kernels do not take.
int plan_launch(int b, int t, int h, int w, int c, int vw, int wide, int v, int th, int tw, int threads,
                Launch* out) {
  if (b <= 0 || t <= 0 || h <= 0 || w <= 0 || c <= 0 || v <= 0 || th <= 0 || tw <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if ((vw != wide && vw != 1) || c % vw != 0) return static_cast<int>(cudaErrorInvalidValue);
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

bool aligned(const void* p, uintptr_t n) { return reinterpret_cast<uintptr_t>(p) % n == 0; }

}  // namespace
