// Fused ConvLSTM gate block, forward and backward: float32, bfloat16 gates
// with a float32 state, and all bfloat16.
//
// Replaces the Pallas TPU kernel ivf_tpu/ops/pallas/fused_gates.py,
// function pallas_gate_math (kernel body _gate_kernel, pallas_call in
// _forward; its VJP _gate_core_bwd is the JAX autodiff of the jnp twin
// _ref_math). With z = gx + gh in (i, f, c, o) order on the last axis:
//
//   i, f, o = sigmoid(z_i, z_f, z_o)
//   c' = f * c + i * tanh(z_c)
//   h' = o * tanh(c')
//
// What bounds it on the H100: it is elementwise, a few dozen operations per
// (row, channel) against 44 bytes forward and 64 backward, so it is bound
// by bytes (3.35 TB/s). At the clstm_kth layer-1 shapes (16 x 60 x 80 rows,
// Ch = 4) the forward moves 13.5 MB (4.0 us) and the backward 19.7 MB
// (5.9 us); layer 2 (16 x 15 x 20 rows) moves under 1 MB, less than a
// launch costs.
//
// Design: one pass over the operands as they lie, with nothing copied.
// The TPU version split z four ways, zero-padded each part to (rows, 128)
// tiles and summed gx + gh before the call. Here one thread owns one
// (row p, channel k) and reads its four gates in place from the NHWC gate
// tensors at p * 4Ch + g * Ch + k; gx + gh is added in registers (gh may
// be null when the x- and h-convs were merged into one). The threads of a
// warp cover 32 consecutive (p, k), so the four gate loads of a warp
// together read one contiguous span of the gate tensor.
//
// Backward: the kernel recomputes the gates from the saved operands and
// writes dz (p, 4Ch) and dc (p, Ch) in one pass, where eager PyTorch would
// launch about fifteen elementwise kernels. The autograd wrapper saves gx
// and gh as they are (both are alive as conv outputs anyway) rather than
// a summed z: that keeps the forward's writes at h' and c' only, and the
// backward reads gh once more (4.9 MB at layer 1) instead. dz is the
// gradient of both gx and gh.
//
// Accurate expf and tanhf (no --use_fast_math, no __expf): the kernel is
// held to its plain PyTorch version at ~1e-6.
//
// bfloat16 entries (lstm_gates_{fwd,bwd}_bf16): the JAX package's bf16
// search hands the gate block bf16 gates (its convs run in the weights'
// dtype) and a float32 state, and gets h' and c' back in float32. These
// kernels read __nv_bfloat16 gates and compute in float32 registers,
// rounding to bf16 exactly where the plain version in
// ops/kernels/fused_gates.py does (which follows XLA on the CPU): in the
// forward z = bf16(gx + gh), XLA's bf16 logistic
// s(x) = 1 / bf16(1 + bf16(exp(-x))), i = bf16(s(z_i)), g = bf16(tanh(z_c)),
// f and o unrounded; in the backward every bf16 op of the JAX autodiff's
// jaxpr rounds. Each float32 operation is an explicit __f*_rn intrinsic in
// the plain version's order, so nvcc contracts nothing into an fma and the
// kernels repeat PyTorch's elementwise roundings. Bytes per (row, channel):
// 28 forward (8 + 8 bf16 gates, 4 + 8 f32), 44 backward (16 + 8 bf16 in and
// out of the gates, 20 f32), so layer 1 of clstm_kth moves 8.6 MB (2.6 us)
// forward and 13.5 MB (4.0 us) backward.

//
// All-bfloat16 entries (lstm_gates_{fwd,bwd}_bf16s): the JAX package's bf16
// train step casts the clips to bf16, so its recurrent state, and h', c',
// their cotangents and dz, are bf16 too. XLA keeps no excess precision where
// every consumer is bf16, so every operation of the kernel body and of the
// autodiff of _ref_math rounds to bf16 (the plain version,
// ops/kernels/fused_gates.py bf16_gate_forward / _gate_math_bwd_bf16, has
// the JAX package's bits on the CPU); these kernels round at each of those
// points, with __f*_rn intrinsics so nothing is contracted. Bytes per (row,
// channel): 22 forward (8 + 8 gates, 2 c, 2 + 2 out), 32 backward (8 + 8
// gates, 2 c, 2 + 2 cotangents, 8 dz, 2 dc), so layer 1 of clstm_kth moves
// 6.8 MB (2.0 us) forward and 9.8 MB (2.9 us) backward. But the kernels
// are bound by their arithmetic, not their bytes: about 150 dependent
// float32 operations and bf16 roundings an element (accurate expf, tanhf
// and divisions, so the plain version's bits hold). A thread takes one
// element of c, as the float32 and bf16-gate kernels do. Threads that owned
// 2, 4 or 8 consecutive elements (4- to 16-byte vectors) were no faster on
// the H100 and the wider ones slower: a thread's chains leave too few
// threads to hide the latency (PERF.md section 6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ void load_gates(const float* __restrict__ gx,
                                           const float* __restrict__ gh,
                                           long long base, int ch, float z[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    z[g] = gx[base + g * ch];
    if (gh != nullptr) z[g] += gh[base + g * ch];
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_fwd(const float* __restrict__ gx, const float* __restrict__ gh,
               const float* __restrict__ c, float* __restrict__ h_out,
               float* __restrict__ c_out, long long n, int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    float z[4];
    load_gates(gx, gh, p * 4 * ch + k, ch, z);
    const float i = sigmoidf_(z[0]);
    const float f = sigmoidf_(z[1]);
    const float g = tanhf(z[2]);
    const float o = sigmoidf_(z[3]);
    const float cn = f * c[e] + i * g;
    c_out[e] = cn;
    h_out[e] = o * tanhf(cn);
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd(const float* __restrict__ gx, const float* __restrict__ gh,
               const float* __restrict__ c, const float* __restrict__ dh,
               const float* __restrict__ dc_out, float* __restrict__ dz,
               float* __restrict__ dc, long long n, int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    const long long base = p * 4 * ch + k;
    float z[4];
    load_gates(gx, gh, base, ch, z);
    const float i = sigmoidf_(z[0]);
    const float f = sigmoidf_(z[1]);
    const float g = tanhf(z[2]);
    const float o = sigmoidf_(z[3]);
    const float cv = c[e];
    const float tc = tanhf(f * cv + i * g);
    const float dhv = dh[e];
    const float dcn = dc_out[e] + dhv * o * (1.f - tc * tc);
    dz[base] = dcn * g * i * (1.f - i);
    dz[base + ch] = dcn * cv * f * (1.f - f);
    dz[base + 2 * ch] = dcn * i * (1.f - g * g);
    dz[base + 3 * ch] = dhv * tc * o * (1.f - o);
    dc[e] = dcn * f;
  }
}

// ---- bfloat16 gates, float32 state -----------------------------------------

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// XLA's bf16 logistic before its last rounding
__device__ __forceinline__ float sigmoid_bf16(float x) {
  return __fdiv_rn(1.f, bf16r(__fadd_rn(1.f, bf16r(expf(-x)))));
}

__device__ __forceinline__ void load_gates(const __nv_bfloat16* __restrict__ gx,
                                           const __nv_bfloat16* __restrict__ gh,
                                           long long base, int ch, float z[4]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    z[g] = __bfloat162float(gx[base + g * ch]);
    if (gh != nullptr) z[g] = bf16r(__fadd_rn(z[g], __bfloat162float(gh[base + g * ch])));
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ gx,
                           const __nv_bfloat16* __restrict__ gh, const float* __restrict__ c,
                           float* __restrict__ h_out, float* __restrict__ c_out, long long n,
                           int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    float z[4];
    load_gates(gx, gh, p * 4 * ch + k, ch, z);
    const float i = bf16r(sigmoid_bf16(z[0]));
    const float g = bf16r(tanhf(z[2]));
    const float cn = __fadd_rn(__fmul_rn(sigmoid_bf16(z[1]), c[e]), __fmul_rn(i, g));
    c_out[e] = cn;
    h_out[e] = __fmul_rn(sigmoid_bf16(z[3]), tanhf(cn));
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd_bf16_kernel(const __nv_bfloat16* __restrict__ gx,
                           const __nv_bfloat16* __restrict__ gh, const float* __restrict__ c,
                           const float* __restrict__ dh, const float* __restrict__ dc_out,
                           __nv_bfloat16* __restrict__ dz, float* __restrict__ dc,
                           long long n, int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    const long long base = p * 4 * ch + k;
    float z[4];
    load_gates(gx, gh, base, ch, z);
    // the recomputed forward, each bf16 op of the jaxpr rounded
    const float i = bf16r(sigmoid_bf16(z[0]));
    const float f = bf16r(sigmoid_bf16(z[1]));
    const float g = bf16r(tanhf(z[2]));
    const float o = bf16r(sigmoid_bf16(z[3]));
    const float cv = c[e];
    const float tc = tanhf(__fadd_rn(__fmul_rn(f, cv), bf16r(__fmul_rn(i, g))));
    const float dhv = dh[e];
    const float ev = __fmul_rn(__fmul_rn(o, dhv), __fsub_rn(1.f, tc));
    const float dcn = __fadd_rn(__fadd_rn(dc_out[e], ev), __fmul_rn(ev, tc));
    const float dcb = bf16r(dcn);
    const float dzc = bf16r(__fmul_rn(bf16r(__fmul_rn(i, dcb)), bf16r(__fsub_rn(1.f, g))));
    const float si = bf16r(__fmul_rn(i, bf16r(__fsub_rn(1.f, i))));
    const float sf = bf16r(__fmul_rn(f, bf16r(__fsub_rn(1.f, f))));
    const float so = bf16r(__fmul_rn(o, bf16r(__fsub_rn(1.f, o))));
    dz[base] = __float2bfloat16_rn(__fmul_rn(bf16r(__fmul_rn(dcb, g)), si));
    dz[base + ch] = __float2bfloat16_rn(__fmul_rn(bf16r(__fmul_rn(dcn, cv)), sf));
    dz[base + 2 * ch] = __float2bfloat16_rn(__fadd_rn(dzc, bf16r(__fmul_rn(dzc, g))));
    dz[base + 3 * ch] = __float2bfloat16_rn(__fmul_rn(bf16r(__fmul_rn(dhv, tc)), so));
    dc[e] = __fmul_rn(f, dcn);
  }
}

// ---- all bfloat16 -----------------------------------------------------------

// One (row, channel): z[4] = bf16(gx + gh) float-held, c bf16 float-held.
__device__ __forceinline__ void gate_fwd_bf16s(const float z[4], float c, float& h, float& cn) {
  const float i = bf16r(sigmoid_bf16(z[0]));
  const float f = bf16r(sigmoid_bf16(z[1]));
  const float g = bf16r(tanhf(z[2]));
  const float o = bf16r(sigmoid_bf16(z[3]));
  cn = bf16r(__fadd_rn(bf16r(__fmul_rn(f, c)), bf16r(__fmul_rn(i, g))));
  h = bf16r(__fmul_rn(o, bf16r(tanhf(cn))));
}

// The autodiff of _ref_math, every op rounded; dz[4] and dc before their
// last rounding, which the store does.
__device__ __forceinline__ void gate_bwd_bf16s(const float z[4], float c, float dh, float dco,
                                               float dz[4], float& dc) {
  const float i = bf16r(sigmoid_bf16(z[0]));
  const float f = bf16r(sigmoid_bf16(z[1]));
  const float g = bf16r(tanhf(z[2]));
  const float o = bf16r(sigmoid_bf16(z[3]));
  const float tc = bf16r(tanhf(bf16r(__fadd_rn(bf16r(__fmul_rn(f, c)), bf16r(__fmul_rn(i, g))))));
  const float e = bf16r(__fmul_rn(bf16r(__fmul_rn(o, dh)), bf16r(__fsub_rn(1.f, tc))));
  const float dcn = bf16r(__fadd_rn(bf16r(__fadd_rn(dco, e)), bf16r(__fmul_rn(e, tc))));
  const float dzc = bf16r(__fmul_rn(bf16r(__fmul_rn(i, dcn)), bf16r(__fsub_rn(1.f, g))));
  dz[0] = __fmul_rn(bf16r(__fmul_rn(dcn, g)), bf16r(__fmul_rn(i, bf16r(__fsub_rn(1.f, i)))));
  dz[1] = __fmul_rn(bf16r(__fmul_rn(dcn, c)), bf16r(__fmul_rn(f, bf16r(__fsub_rn(1.f, f)))));
  dz[2] = __fadd_rn(dzc, bf16r(__fmul_rn(dzc, g)));
  dz[3] = __fmul_rn(bf16r(__fmul_rn(dh, tc)), bf16r(__fmul_rn(o, bf16r(__fsub_rn(1.f, o)))));
  dc = __fmul_rn(f, dcn);
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_fwd_bf16s_kernel(const __nv_bfloat16* __restrict__ gx,
                            const __nv_bfloat16* __restrict__ gh,
                            const __nv_bfloat16* __restrict__ c, __nv_bfloat16* __restrict__ h_out,
                            __nv_bfloat16* __restrict__ c_out, long long n, int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    float z[4], h, cn;
    load_gates(gx, gh, p * 4 * ch + k, ch, z);
    gate_fwd_bf16s(z, __bfloat162float(c[e]), h, cn);
    h_out[e] = __float2bfloat16_rn(h);
    c_out[e] = __float2bfloat16_rn(cn);
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd_bf16s_kernel(const __nv_bfloat16* __restrict__ gx,
                            const __nv_bfloat16* __restrict__ gh,
                            const __nv_bfloat16* __restrict__ c, const __nv_bfloat16* __restrict__ dh,
                            const __nv_bfloat16* __restrict__ dc_out, __nv_bfloat16* __restrict__ dz,
                            __nv_bfloat16* __restrict__ dc, long long n, int ch) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long p = e / ch;
    const int k = static_cast<int>(e - p * ch);
    const long long base = p * 4 * ch + k;
    float z[4], d[4], dcv;
    load_gates(gx, gh, base, ch, z);
    gate_bwd_bf16s(z, __bfloat162float(c[e]), __bfloat162float(dh[e]), __bfloat162float(dc_out[e]),
                   d, dcv);
#pragma unroll
    for (int g = 0; g < 4; ++g) dz[base + g * ch] = __float2bfloat16_rn(d[g]);
    dc[e] = __float2bfloat16_rn(dcv);
  }
}

int grid_for(long long n) {
  // enough blocks to fill the card several times over; the loop strides
  // over the rest
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 132 * 32 ? blocks : 132 * 32);
}

}  // namespace

// gx, gh: (rows, 4 * ch) in (i, f, c, o) order, gh may be null; c, h_out,
// c_out: (rows, ch); all contiguous float32 on the current device.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int lstm_gates_fwd_f32(const float* gx, const float* gh,
                                  const float* c, float* h_out, float* c_out,
                                  long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_fwd<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, h_out, c_out, n, ch);
  return static_cast<int>(cudaGetLastError());
}

// The VJP: given dh = dL/dh' and dc_out = dL/dc' (rows, ch), writes
// dz = dL/dz (rows, 4 * ch) and dc = dL/dc (rows, ch).
extern "C" int lstm_gates_bwd_f32(const float* gx, const float* gh,
                                  const float* c, const float* dh,
                                  const float* dc_out, float* dz, float* dc,
                                  long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_bwd<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, dh, dc_out, dz, dc, n, ch);
  return static_cast<int>(cudaGetLastError());
}

// As lstm_gates_fwd_f32, with bfloat16 gates gx, gh and float32 c, h_out,
// c_out.
extern "C" int lstm_gates_fwd_bf16(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                   const float* c, float* h_out, float* c_out,
                                   long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_fwd_bf16_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, h_out, c_out, n, ch);
  return static_cast<int>(cudaGetLastError());
}

// As lstm_gates_bwd_f32, with bfloat16 gates and dz, float32 c, dh,
// dc_out and dc.
extern "C" int lstm_gates_bwd_bf16(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                   const float* c, const float* dh, const float* dc_out,
                                   __nv_bfloat16* dz, float* dc, long long rows, int ch,
                                   void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_bwd_bf16_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, dh, dc_out, dz, dc, n, ch);
  return static_cast<int>(cudaGetLastError());
}

// As lstm_gates_fwd_f32, all bfloat16: gx, gh (may be null), c, h_out,
// c_out.
extern "C" int lstm_gates_fwd_bf16s(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                    const __nv_bfloat16* c, __nv_bfloat16* h_out,
                                    __nv_bfloat16* c_out, long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_fwd_bf16s_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, h_out, c_out, n, ch);
  return static_cast<int>(cudaGetLastError());
}

// As lstm_gates_bwd_f32, all bfloat16.
extern "C" int lstm_gates_bwd_bf16s(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                    const __nv_bfloat16* c, const __nv_bfloat16* dh,
                                    const __nv_bfloat16* dc_out, __nv_bfloat16* dz,
                                    __nv_bfloat16* dc, long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  lstm_gates_bwd_bf16s_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      gx, gh, c, dh, dc_out, dz, dc, n, ch);
  return static_cast<int>(cudaGetLastError());
}
