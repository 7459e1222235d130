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
// launch costs. From device memory the float32 backward runs within a few
// percent of a build that makes the same loads and stores with its
// arithmetic replaced by sums (PERF.md).
//
// Design: one pass over the operands as they lie, with nothing copied.
// The TPU version split z four ways, zero-padded each part to (rows, 128)
// tiles and summed gx + gh before the call. Here a thread owns V
// consecutive channels of one row p and reads its four gates in place from
// the NHWC gate tensors at p * 4Ch + g * Ch + k, V values a load; gx + gh
// is added in registers (gh may be null when the x- and h-convs were merged
// into one). The float32 pair takes two channels a thread where it can:
// four (one 16-byte access per gate) made each thread's dependent chains
// four long and lost at every size; one channel keeps every operand's
// access 4 bytes wide.
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
// 6.8 MB (2.0 us) forward and 9.8 MB (2.9 us) backward.
//
// Evaluated with accurate expf, tanhf and divisions, the block is ~150
// dependent float32 operations and roundings an element, and bound by that
// latency rather than its bytes (2.5x and 2.2x the byte bound). But every
// activation in it has a bf16 input, so it has only 65,536 possible
// values: lstm_gate_tables_build evaluates the exact device functions on
// all of them once per device and process, and keeps only the inputs whose
// value is not a constant of the sign (or, for tanh, the input itself):
// ~4,900 entries, 9.8 KB. Each block copies them into shared memory with
// cp.async while its threads' first operands load, and each activation
// becomes a clamped index and one shared-memory load; the products and sums
// between them stay rounded float32 operations in the plain version's
// order. An element with an infinite or NaN gate or c takes the exact
// functions instead, so no table entry stands for a NaN. So the kernels
// give the plain version's bits on all 65,536 values of every operand
// (chip_smoke.py checks them). What is left bounds them by instructions
// issued more than by bytes: two elements a thread (4-byte accesses) round
// their bf16 results in pairs (cvt.rn.bf16x2.f32, each value rounded as
// alone), and four blocks of 256 threads an SM keep the tables' copies from
// L2 few (PERF.md gives the alternatives' times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;

// ---- float32 ----------------------------------------------------------------

// The float32 kernels: a thread takes V consecutive channels of one row and
// moves each operand's V values as one V * 4-byte access (lstm_gates_*_f32
// take V = 2 where Ch is even and every base 8-byte aligned, else 1); a
// grid of kF32Threads-thread blocks, at most kF32BlocksPerSm an SM, strides
// over the rest. Element e = p Ch + k of c has gate g at
// 4 p Ch + g Ch + k = 4 e - 3 k + g Ch, so a thread walks e and k alone:
// one division a thread, for its first k. The index is 32-bit where the
// gate tensor has fewer than 2^31 elements, else 64-bit: 64-bit index
// arithmetic made the backward 7-12% slower from L2 (PERF.md).
constexpr int kF32Threads = 64;
constexpr int kF32BlocksPerSm = 16;

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int V, typename I>
__device__ __forceinline__ void load_f32(const float* __restrict__ p, I i, float (&x)[V]) {
  if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = p[i];
  }
}

template <int V, typename I>
__device__ __forceinline__ void store_f32(float* __restrict__ p, I i, const float (&x)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p + i) = make_float2(x[0], x[1]);
  } else {
    p[i] = x[0];
  }
}

// z[g] = gx + gh (gh may be null) of the V channels from gate index base
template <int V, typename I>
__device__ __forceinline__ void load_z(const float* __restrict__ gx, const float* __restrict__ gh, I base,
                                       int ch, float (&z)[4][V]) {
#pragma unroll
  for (int g = 0; g < 4; ++g) load_f32<V>(gx, base + static_cast<I>(g * ch), z[g]);
  if (gh != nullptr) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float y[V];
      load_f32<V>(gh, base + static_cast<I>(g * ch), y);
#pragma unroll
      for (int j = 0; j < V; ++j) z[g][j] = __fadd_rn(z[g][j], y[j]);
    }
  }
}

// c' = f c + i g. The parent build's nvcc contracted f * c + i * g into
// fma(i, g, f * c); written out, so every build gives the same bits.
__device__ __forceinline__ float cell_f32(float f, float c, float i, float g) {
  return __fmaf_rn(i, g, __fmul_rn(f, c));
}

// Walks the thread's groups of V elements: the first at e = V times the
// thread's index, then `stride` elements (stride_k channels) apart;
// `body` takes each group's e and gate index 4 e - 3 k.
template <int V, typename I, class Body>
__device__ __forceinline__ void f32_walk(I n, int ch, I stride, int stride_k, Body body) {
  I e = (static_cast<I>(blockIdx.x) * kF32Threads + threadIdx.x) * V;
  int k = static_cast<int>(e % static_cast<I>(ch));
  for (; e < n; e += stride) {
    body(e, 4 * e - 3 * static_cast<I>(k));
    k += stride_k;
    if (k >= ch) k -= ch;
  }
}

template <int V, typename I>
__global__ void __launch_bounds__(kF32Threads, kF32BlocksPerSm)
lstm_gates_fwd_f32_kernel(const float* __restrict__ gx, const float* __restrict__ gh,
                          const float* __restrict__ c, float* __restrict__ h_out,
                          float* __restrict__ c_out, I n, int ch, I stride, int stride_k) {
  f32_walk<V>(n, ch, stride, stride_k, [&](I e, I base) {
    float z[4][V], cv[V], h[V], cn[V];
    load_z<V>(gx, gh, base, ch, z);
    load_f32<V>(c, e, cv);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float i = sigmoidf_(z[0][j]);
      const float f = sigmoidf_(z[1][j]);
      const float g = tanhf(z[2][j]);
      const float o = sigmoidf_(z[3][j]);
      cn[j] = cell_f32(f, cv[j], i, g);
      h[j] = __fmul_rn(o, tanhf(cn[j]));
    }
    store_f32<V>(c_out, e, cn);
    store_f32<V>(h_out, e, h);
  });
}

// The VJP, recomputing the gates; every product and sum as the parent
// build's nvcc compiled them (its contractions into fma written out).
template <int V, typename I>
__global__ void __launch_bounds__(kF32Threads, kF32BlocksPerSm)
lstm_gates_bwd_f32_kernel(const float* __restrict__ gx, const float* __restrict__ gh,
                          const float* __restrict__ c, const float* __restrict__ dh,
                          const float* __restrict__ dc_out, float* __restrict__ dz,
                          float* __restrict__ dc, I n, int ch, I stride, int stride_k) {
  f32_walk<V>(n, ch, stride, stride_k, [&](I e, I base) {
    float z[4][V], cv[V], dhv[V], dco[V], d[4][V], dcv[V];
    load_z<V>(gx, gh, base, ch, z);
    load_f32<V>(c, e, cv);
    load_f32<V>(dh, e, dhv);
    load_f32<V>(dc_out, e, dco);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float i = sigmoidf_(z[0][j]);
      const float f = sigmoidf_(z[1][j]);
      const float g = tanhf(z[2][j]);
      const float o = sigmoidf_(z[3][j]);
      const float tc = tanhf(cell_f32(f, cv[j], i, g));
      // dc' + dh' o (1 - tc^2)
      const float dcn = __fmaf_rn(__fmul_rn(dhv[j], o), __fmaf_rn(-tc, tc, 1.f), dco[j]);
      d[0][j] = __fmul_rn(__fmul_rn(__fmul_rn(dcn, g), i), __fsub_rn(1.f, i));
      d[1][j] = __fmul_rn(__fmul_rn(__fmul_rn(dcn, cv[j]), f), __fsub_rn(1.f, f));
      d[2][j] = __fmul_rn(__fmul_rn(dcn, i), __fmaf_rn(-g, g, 1.f));
      d[3][j] = __fmul_rn(__fmul_rn(__fmul_rn(dhv[j], tc), o), __fsub_rn(1.f, o));
      dcv[j] = __fmul_rn(dcn, f);
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) store_f32<V>(dz, base + static_cast<I>(g * ch), d[g]);
    store_f32<V>(dc, e, dcv);
  });
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

// One (row, channel) as the JAX package rounds it: z[4] = bf16(gx + gh)
// float-held, c bf16 float-held. The exact functions the tables are built
// from, and the kernels' path for an element with an infinite or NaN input.
__device__ __noinline__ void gate_fwd_bf16s(const float z[4], float c, float& h, float& cn) {
  const float i = bf16r(sigmoid_bf16(z[0]));
  const float f = bf16r(sigmoid_bf16(z[1]));
  const float g = bf16r(tanhf(z[2]));
  const float o = bf16r(sigmoid_bf16(z[3]));
  cn = bf16r(__fadd_rn(bf16r(__fmul_rn(f, c)), bf16r(__fmul_rn(i, g))));
  h = bf16r(__fmul_rn(o, bf16r(tanhf(cn))));
}

// The autodiff of _ref_math, every op rounded; dz[4] and dc before their
// last rounding, which the store does.
__device__ __noinline__ void gate_bwd_bf16s(const float z[4], float c, float dh, float dco, float dz[4],
                                            float& dc) {
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

// The activation tables. Every activation of the block has a bf16 input
// (the four z, c' and its rounding), so each is a function of 16 bits:
// bf16(s(z)) and bf16(tanh(z)). lstm_gate_tables_build evaluates the exact
// functions above (gate_*_bf16s's own sigmoid_bf16 and tanhf) on all 65,536
// inputs on the card and derives, for each, the range of magnitude bits
// [lo, hi) outside which the value is a constant of the sign: s(+-0) = 0.5
// below lo and s(+-inf) (1 and 0) from hi on, tanh(+-inf) = +-1 from hi on
// and tanh(z) = z below lo. Only that range is packed, per sign, between
// the two constants: [s(0), s(lo), ..., s(hi - 1), s(inf)] for each sign,
// the same for tanh, so that a clamped index reads the table, the small
// constant or the large one with one shared-memory load. About 2 x 1,800
// sigmoid and 2 x 700 tanh entries, 9.8 KB. The backward's factor
// bf16(s * bf16(1 - s)) is two operations on the tabled s: a table of it
// cost more (its copy) than it saved.
constexpr uint32_t kInfBits = 0x7F80;  // magnitude bits of inf; above: NaN
constexpr int kTableBytesMax = 48 * 1024;  // without opting in to more shared memory
constexpr int kTablesOutOfRange = -1;  // lstm_gate_tables_build: the derived ranges do not fit
constexpr int kMaxDevices = 64;

// The packed tables of one device, in two regions, each 16-byte aligned:
// S (bf16 sigmoid, ns entries) and T (bf16 tanh, nt). Both kernels copy
// both into shared memory.
struct ActTab {
  const uint16_t* packed;
  int slo, sspan;  // sigmoid: magnitude bits [slo, slo + sspan) tabled
  int tlo, tspan;  // tanh
  int ns, nt;
};

ActTab g_tables[kMaxDevices];
int g_sms[kMaxDevices];

__device__ __forceinline__ float bf16f(uint32_t bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ uint32_t bf16b(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__global__ void act_eval_kernel(uint16_t* __restrict__ sig, uint16_t* __restrict__ tnh,
                                int* __restrict__ range) {
  const uint32_t u = blockIdx.x * blockDim.x + threadIdx.x;
  if (u >= 65536) return;
  const float z = bf16f(u);
  sig[u] = static_cast<uint16_t>(bf16b(sigmoid_bf16(z)));
  tnh[u] = static_cast<uint16_t>(bf16b(tanhf(z)));
  if (u == 0) {
    range[0] = range[2] = kInfBits;
    range[1] = range[3] = 0;
  }
}

// range = {sigmoid lo, hi, tanh lo, hi} over the finite inputs of both signs
__global__ void act_range_kernel(const uint16_t* __restrict__ sig, const uint16_t* __restrict__ tnh,
                                 int* __restrict__ range) {
  const uint32_t u = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = static_cast<int>(u & 0x7FFF);
  if (u >= 65536 || a >= static_cast<int>(kInfBits)) return;
  const uint32_t sign = u & 0x8000;
  if (sig[u] != sig[sign]) atomicMin(&range[0], a);
  if (sig[u] != sig[sign | kInfBits]) atomicMax(&range[1], a + 1);
  if (tnh[u] != u) atomicMin(&range[2], a);
  if (tnh[u] != tnh[sign | kInfBits]) atomicMax(&range[3], a + 1);
}

// One entry j of the packed tables.
__global__ void act_pack_kernel(const uint16_t* __restrict__ sig, const uint16_t* __restrict__ tnh,
                                uint16_t* __restrict__ packed, ActTab t) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= t.ns + t.nt) return;
  const bool s = j < t.ns;
  const int off = s ? j : j - t.ns, lo = s ? t.slo : t.tlo, span = s ? t.sspan : t.tspan;
  if (off >= 2 * (span + 2)) {  // padding
    packed[j] = 0;
    return;
  }
  const int sign = off / (span + 2), i = off - sign * (span + 2);
  const uint32_t a = i == 0 ? 0u : (i == span + 1 ? kInfBits : static_cast<uint32_t>(lo + i - 1));
  const uint32_t u = (static_cast<uint32_t>(sign) << 15) | a;
  packed[j] = s ? sig[u] : tnh[u];
}

// A family's packed slot of input bits u: the small constant, the table or
// the large constant of u's sign.
__device__ __forceinline__ int tab_slot(uint32_t u, int lo, int span) {
  const int a = static_cast<int>(u & 0x7FFF);
  return static_cast<int>(u >> 15) * (span + 2) + min(max(a - lo + 1, 0), span + 1);
}

// bf16(tanh) of finite bf16 bits u, as bits, from the T region at sh + ns
__device__ __forceinline__ uint32_t tab_tanh(const uint16_t* sh, const ActTab& t, uint32_t u) {
  const uint32_t v = sh[t.ns + tab_slot(u, t.tlo, t.tspan)];
  return static_cast<int>(u & 0x7FFF) < t.tlo ? u : v;
}

// The all-bf16 kernels: a grid of kBf16sThreads-thread blocks, at most
// kBf16sBlocksPerSm an SM, each of which first copies the tables into its
// shared memory (cp.async) while its threads load their first operands. A
// thread takes V consecutive elements of c (V = 2 where Ch is even and
// every base 4-byte aligned: one 4-byte access per operand and gate, and
// the bf16 roundings two at a time), then the ones the grid's stride apart.
constexpr int kBf16sThreads = 256;
constexpr int kBf16sBlocksPerSm = 4;

// An element e, its row p and channel k; or the grid's stride in the same
// three.
struct Walk {
  long long e, p;
  int k;
};
using Stride = Walk;

__device__ __forceinline__ Walk walk_next(Walk w, const Stride& s, int ch) {
  w.e += s.e;
  w.p += s.p;
  w.k += s.k;
  if (w.k >= ch) {
    w.k -= ch;
    ++w.p;
  }
  return w;
}

// V bf16 values in one word, as loaded and stored: element j in bits
// 16 j to 16 j + 15.
template <int V>
struct Packed {
  uint32_t w;
  __device__ __forceinline__ uint32_t operator[](int j) const { return (w >> (16 * j)) & 0xFFFF; }
};

// V floats: bf16 values widened, or float results before their rounding.
template <int V>
struct Floats {
  float x[V];
};

template <int V>
__device__ __forceinline__ Packed<V> load_packed(const uint16_t* __restrict__ p, long long i) {
  Packed<V> b;
  if constexpr (V == 1) {
    b.w = p[i];
  } else {
    b.w = *reinterpret_cast<const uint32_t*>(p + i);
  }
  return b;
}

template <int V>
__device__ __forceinline__ void store_packed(uint16_t* __restrict__ p, long long i, const Packed<V>& b) {
  if constexpr (V == 1) {
    p[i] = static_cast<uint16_t>(b.w);
  } else {
    *reinterpret_cast<uint32_t*>(p + i) = b.w;
  }
}

template <int V>
__device__ __forceinline__ Floats<V> unpack(const Packed<V>& b) {
  Floats<V> f;
#pragma unroll
  for (int j = 0; j < V; ++j)
    f.x[j] = __uint_as_float(j == 1 ? b.w & 0xFFFF0000u : b.w << 16);
  return f;
}

// Each float rounded to bf16 (nearest even), two at a time.
template <int V>
__device__ __forceinline__ Packed<V> pack(const Floats<V>& f) {
  Packed<V> b;
  if constexpr (V == 1) {
    b.w = bf16b(f.x[0]);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f.x[0], f.x[1]);
    b.w = *reinterpret_cast<const uint32_t*>(&h);
  }
  return b;
}

template <int V>
__device__ __forceinline__ Floats<V> rnd(const Floats<V>& f) {
  return unpack(pack(f));
}

template <int V>
__device__ __forceinline__ Floats<V> mul(const Floats<V>& a, const Floats<V>& b) {
  Floats<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.x[j] = __fmul_rn(a.x[j], b.x[j]);
  return r;
}

template <int V>
__device__ __forceinline__ Floats<V> add(const Floats<V>& a, const Floats<V>& b) {
  Floats<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.x[j] = __fadd_rn(a.x[j], b.x[j]);
  return r;
}

template <int V>
__device__ __forceinline__ Floats<V> one_minus(const Floats<V>& a) {
  Floats<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.x[j] = __fsub_rn(1.f, a.x[j]);
  return r;
}

// bf16(s * bf16(1 - s)): the logistic's derivative factor of a bf16 s
template <int V>
__device__ __forceinline__ Floats<V> sig_factor(const Floats<V>& s) {
  return rnd(mul(s, rnd(one_minus(s))));
}

template <int V>
__device__ __forceinline__ Floats<V> tab_sig(const uint16_t* sh, const ActTab& t, const Packed<V>& z) {
  Floats<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.x[j] = bf16f(sh[tab_slot(z[j], t.slo, t.sspan)]);
  return r;
}

template <int V>
__device__ __forceinline__ Floats<V> tab_tanh(const uint16_t* sh, const ActTab& t, const Packed<V>& z) {
  Floats<V> r;
#pragma unroll
  for (int j = 0; j < V; ++j) r.x[j] = bf16f(tab_tanh(sh, t, z[j]));
  return r;
}

// V elements' operands as loaded; the gate sum waits for the compute.
template <int V>
struct In {
  Packed<V> gx[4], gh[4], c, dh, dco;
};

template <int V, bool kBwd>
__device__ __forceinline__ void load_in(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gh,
                                        const uint16_t* __restrict__ c, const uint16_t* __restrict__ dh,
                                        const uint16_t* __restrict__ dc_out, const Walk& w, int ch, In<V>& in) {
  const long long base = w.p * 4 * ch + w.k;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    in.gx[g] = load_packed<V>(gx, base + g * ch);
    if (gh != nullptr) in.gh[g] = load_packed<V>(gh, base + g * ch);
  }
  in.c = load_packed<V>(c, w.e);
  if constexpr (kBwd) {
    in.dh = load_packed<V>(dh, w.e);
    in.dco = load_packed<V>(dc_out, w.e);
  }
}

// The gates, bf16(gx + gh) where gh is given. True when a gate or c of an
// element is infinite or NaN (magnitude bits 0x7F80 or more): the
// elements take the exact functions.
template <int V>
__device__ __forceinline__ bool gates_of(const In<V>& in, bool with_gh, Packed<V> (&z)[4]) {
  uint32_t over = (in.c.w & 0x7FFF7FFFu) + 0x00800080u;
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    z[g] = with_gh ? pack(add(unpack(in.gx[g]), unpack(in.gh[g]))) : in.gx[g];
    over |= (z[g].w & 0x7FFF7FFFu) + 0x00800080u;
  }
  return (over & 0x80008000u) != 0;
}

// Copies the tables into shared memory, then walks the thread's elements,
// V at a time: `compute` takes one group's operands.
template <int V, bool kBwd, class Compute>
__device__ __forceinline__ void bf16s_walk(uint16_t* sh, const ActTab& t, const uint16_t* __restrict__ gx,
                                           const uint16_t* __restrict__ gh, const uint16_t* __restrict__ c,
                                           const uint16_t* __restrict__ dh, const uint16_t* __restrict__ dc_out,
                                           long long n, int ch, const Stride& stride, Compute compute) {
  for (int j = threadIdx.x; j < (t.ns + t.nt) / 8; j += blockDim.x)
    cp_async16_zfill(sh + 8 * j, t.packed + 8 * j, 16);
  cp_async_commit();
  Walk w;
  w.e = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
  w.p = w.e / ch;
  w.k = static_cast<int>(w.e - w.p * ch);
  In<V> in;
  if (w.e < n) load_in<V, kBwd>(gx, gh, c, dh, dc_out, w, ch, in);
  cp_async_wait<0>();
  __syncthreads();
  while (w.e < n) {
    compute(in, w);
    w = walk_next(w, stride, ch);
    if (w.e < n) load_in<V, kBwd>(gx, gh, c, dh, dc_out, w, ch, in);
  }
}

// Bits b placed as element j of a packed group.
template <int V>
__device__ __forceinline__ void put(Packed<V>& p, int j, uint32_t b) {
  p.w |= b << (16 * j);
}

template <int V>
__global__ void __launch_bounds__(kBf16sThreads, kBf16sBlocksPerSm)
lstm_gates_fwd_bf16s_kernel(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gh,
                            const uint16_t* __restrict__ c, uint16_t* __restrict__ h_out,
                            uint16_t* __restrict__ c_out, long long n, int ch, Stride stride, ActTab t) {
  extern __shared__ __align__(16) uint16_t sh[];
  bf16s_walk<V, false>(sh, t, gx, gh, c, nullptr, nullptr, n, ch, stride, [&](const In<V>& in, const Walk& w) {
    Packed<V> z[4];
    const Floats<V> cv = unpack(in.c);
    if (gates_of(in, gh != nullptr, z)) {
      Packed<V> hb = {}, cb = {};
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float zf[4] = {bf16f(z[0][j]), bf16f(z[1][j]), bf16f(z[2][j]), bf16f(z[3][j])};
        float h, cn;
        gate_fwd_bf16s(zf, cv.x[j], h, cn);
        put(hb, j, bf16b(h));
        put(cb, j, bf16b(cn));
      }
      store_packed<V>(h_out, w.e, hb);
      store_packed<V>(c_out, w.e, cb);
      return;
    }
    const Floats<V> i = tab_sig(sh, t, z[0]), f = tab_sig(sh, t, z[1]);
    const Floats<V> g = tab_tanh(sh, t, z[2]), o = tab_sig(sh, t, z[3]);
    const Packed<V> cn = pack(add(rnd(mul(f, cv)), rnd(mul(i, g))));
    store_packed<V>(c_out, w.e, cn);
    store_packed<V>(h_out, w.e, pack(mul(o, tab_tanh(sh, t, cn))));
  });
}

template <int V>
__global__ void __launch_bounds__(kBf16sThreads, kBf16sBlocksPerSm)
lstm_gates_bwd_bf16s_kernel(const uint16_t* __restrict__ gx, const uint16_t* __restrict__ gh,
                            const uint16_t* __restrict__ c, const uint16_t* __restrict__ dh,
                            const uint16_t* __restrict__ dc_out, uint16_t* __restrict__ dz,
                            uint16_t* __restrict__ dc, long long n, int ch, Stride stride, ActTab t) {
  extern __shared__ __align__(16) uint16_t sh[];
  bf16s_walk<V, true>(sh, t, gx, gh, c, dh, dc_out, n, ch, stride, [&](const In<V>& in, const Walk& w) {
    Packed<V> z[4];
    const Floats<V> cv = unpack(in.c), dhv = unpack(in.dh), dco = unpack(in.dco);
    const long long base = w.p * 4 * ch + w.k;
    if (gates_of(in, gh != nullptr, z)) {
      Packed<V> d[4] = {}, dcb = {};
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float zf[4] = {bf16f(z[0][j]), bf16f(z[1][j]), bf16f(z[2][j]), bf16f(z[3][j])};
        float df[4], dcv;
        gate_bwd_bf16s(zf, cv.x[j], dhv.x[j], dco.x[j], df, dcv);
#pragma unroll
        for (int g = 0; g < 4; ++g) put(d[g], j, bf16b(df[g]));
        put(dcb, j, bf16b(dcv));
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) store_packed<V>(dz, base + g * ch, d[g]);
      store_packed<V>(dc, w.e, dcb);
      return;
    }
    // the recomputed forward and the autodiff of _ref_math, every op
    // rounded, in gate_bwd_bf16s's order
    const Floats<V> i = tab_sig(sh, t, z[0]), f = tab_sig(sh, t, z[1]);
    const Floats<V> g = tab_tanh(sh, t, z[2]), o = tab_sig(sh, t, z[3]);
    const Floats<V> tc = tab_tanh(sh, t, pack(add(rnd(mul(f, cv)), rnd(mul(i, g)))));
    const Floats<V> e = rnd(mul(rnd(mul(o, dhv)), rnd(one_minus(tc))));
    const Floats<V> dcn = rnd(add(rnd(add(dco, e)), rnd(mul(e, tc))));
    const Floats<V> dzc = rnd(mul(rnd(mul(i, dcn)), rnd(one_minus(g))));
    store_packed<V>(dz, base, pack(mul(rnd(mul(dcn, g)), sig_factor(i))));
    store_packed<V>(dz, base + ch, pack(mul(rnd(mul(dcn, cv)), sig_factor(f))));
    store_packed<V>(dz, base + 2 * ch, pack(add(dzc, rnd(mul(dzc, g)))));
    store_packed<V>(dz, base + 3 * ch, pack(mul(rnd(mul(dhv, tc)), sig_factor(o))));
    store_packed<V>(dc, w.e, pack(mul(f, dcn)));
  });
}

// The current device and its SM count (read once). Returns 0, or the
// error that stops a launch.
int current_device(int& dev, int& sms) {
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (g_sms[dev] == 0 &&
      (err = cudaDeviceGetAttribute(&g_sms[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return static_cast<int>(err);
  sms = g_sms[dev];
  return 0;
}

// A grid-stride launch over the n elements of c (rows, ch), v a thread:
// blocks of `threads`, at most `per_sm` an SM, and the grid's stride.
struct Grid {
  int blocks;
  Stride stride;
};

Grid grid_stride(long long n, int ch, int v, int threads, int per_sm, int sms) {
  Grid g;
  const long long need = (n / v + threads - 1) / threads;
  const long long most = static_cast<long long>(sms) * per_sm;
  g.blocks = static_cast<int>(need < most ? need : most);
  g.stride.e = static_cast<long long>(g.blocks) * threads * v;
  g.stride.p = g.stride.e / ch;
  g.stride.k = static_cast<int>(g.stride.e - g.stride.p * ch);
  return g;
}

// Two elements a thread when ch is even and every base is a multiple of
// `align` bytes (one access of two elements per operand); else one.
int pair_width(int ch, int align, std::initializer_list<const void*> ptrs) {
  bool two = ch % 2 == 0;
  for (const void* p : ptrs) two = two && reinterpret_cast<uintptr_t>(p) % align == 0;
  return two ? 2 : 1;
}

// The launch of an all-bf16 kernel: the current device's tables, its grid
// for V elements a thread, and the shared memory it takes. Returns 0, or
// the error that stops the launch.
struct Bf16sLaunch {
  ActTab t;
  int smem;
  Grid grid;
};

int bf16s_launch(long long n, int ch, int v, Bf16sLaunch& l) {
  int dev = 0, sms = 0;
  const int rc = current_device(dev, sms);
  if (rc != 0) return rc;
  if (g_tables[dev].packed == nullptr) return static_cast<int>(cudaErrorNotReady);
  l.t = g_tables[dev];
  l.smem = 2 * (l.t.ns + l.t.nt);
  l.grid = grid_stride(n, ch, v, kBf16sThreads, kBf16sBlocksPerSm, sms);
  return 0;
}

template <int V>
int launch_fwd_bf16s(const void* gx, const void* gh, const void* c, void* h_out, void* c_out, long long n, int ch,
                     void* stream) {
  Bf16sLaunch l;
  const int rc = bf16s_launch(n, ch, V, l);
  if (rc != 0) return rc;
  lstm_gates_fwd_bf16s_kernel<V><<<l.grid.blocks, kBf16sThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gh), static_cast<const uint16_t*>(c),
      static_cast<uint16_t*>(h_out), static_cast<uint16_t*>(c_out), n, ch, l.grid.stride, l.t);
  return static_cast<int>(cudaGetLastError());
}

template <int V>
int launch_bwd_bf16s(const void* gx, const void* gh, const void* c, const void* dh, const void* dc_out, void* dz,
                     void* dc, long long n, int ch, void* stream) {
  Bf16sLaunch l;
  const int rc = bf16s_launch(n, ch, V, l);
  if (rc != 0) return rc;
  lstm_gates_bwd_bf16s_kernel<V><<<l.grid.blocks, kBf16sThreads, l.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(gx), static_cast<const uint16_t*>(gh), static_cast<const uint16_t*>(c),
      static_cast<const uint16_t*>(dh), static_cast<const uint16_t*>(dc_out), static_cast<uint16_t*>(dz),
      static_cast<uint16_t*>(dc), n, ch, l.grid.stride, l.t);
  return static_cast<int>(cudaGetLastError());
}

// The float32 kernels' grid for v elements a thread. Returns 0, or the
// error that stops the launch.
int f32_grid(long long n, int ch, int v, Grid& g) {
  int dev = 0, sms = 0;
  const int rc = current_device(dev, sms);
  if (rc == 0) g = grid_stride(n, ch, v, kF32Threads, kF32BlocksPerSm, sms);
  return rc;
}

// f(V, index) with V as an integral_constant and a value of the index type:
// 32-bit where the gate tensor's 4 n elements fit in an int.
template <class F>
int with_f32_layout(long long n, int v, F f) {
  using U = uint32_t;
  using L = long long;
  using std::integral_constant;
  if (4 * n < (1LL << 31))
    return v == 2 ? f(integral_constant<int, 2>{}, U{}) : f(integral_constant<int, 1>{}, U{});
  return v == 2 ? f(integral_constant<int, 2>{}, L{}) : f(integral_constant<int, 1>{}, L{});
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
  const int v = pair_width(ch, 8, {gx, gh, c, h_out, c_out});
  Grid g;
  const int rc = f32_grid(n, ch, v, g);
  if (rc != 0) return rc;
  return with_f32_layout(n, v, [&](auto vt, auto it) {
    using I = decltype(it);
    lstm_gates_fwd_f32_kernel<decltype(vt)::value, I><<<g.blocks, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(
        gx, gh, c, h_out, c_out, static_cast<I>(n), ch, static_cast<I>(g.stride.e), g.stride.k);
    return static_cast<int>(cudaGetLastError());
  });
}

// The VJP: given dh = dL/dh' and dc_out = dL/dc' (rows, ch), writes
// dz = dL/dz (rows, 4 * ch) and dc = dL/dc (rows, ch).
extern "C" int lstm_gates_bwd_f32(const float* gx, const float* gh,
                                  const float* c, const float* dh,
                                  const float* dc_out, float* dz, float* dc,
                                  long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  const int v = pair_width(ch, 8, {gx, gh, c, dh, dc_out, dz, dc});
  Grid g;
  const int rc = f32_grid(n, ch, v, g);
  if (rc != 0) return rc;
  return with_f32_layout(n, v, [&](auto vt, auto it) {
    using I = decltype(it);
    lstm_gates_bwd_f32_kernel<decltype(vt)::value, I><<<g.blocks, kF32Threads, 0, static_cast<cudaStream_t>(stream)>>>(
        gx, gh, c, dh, dc_out, dz, dc, static_cast<I>(n), ch, static_cast<I>(g.stride.e), g.stride.k);
    return static_cast<int>(cudaGetLastError());
  });
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
// c_out. Needs the current device's tables (lstm_gate_tables_build);
// returns cudaErrorNotReady without them.
extern "C" int lstm_gates_fwd_bf16s(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                    const __nv_bfloat16* c, __nv_bfloat16* h_out,
                                    __nv_bfloat16* c_out, long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  return pair_width(ch, 4, {gx, gh, c, h_out, c_out}) == 2
             ? launch_fwd_bf16s<2>(gx, gh, c, h_out, c_out, n, ch, stream)
             : launch_fwd_bf16s<1>(gx, gh, c, h_out, c_out, n, ch, stream);
}

// As lstm_gates_bwd_f32, all bfloat16; needs the tables as the forward.
extern "C" int lstm_gates_bwd_bf16s(const __nv_bfloat16* gx, const __nv_bfloat16* gh,
                                    const __nv_bfloat16* c, const __nv_bfloat16* dh,
                                    const __nv_bfloat16* dc_out, __nv_bfloat16* dz,
                                    __nv_bfloat16* dc, long long rows, int ch, void* stream) {
  if (rows <= 0 || ch <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = rows * ch;
  return pair_width(ch, 4, {gx, gh, c, dh, dc_out, dz, dc}) == 2
             ? launch_bwd_bf16s<2>(gx, gh, c, dh, dc_out, dz, dc, n, ch, stream)
             : launch_bwd_bf16s<1>(gx, gh, c, dh, dc_out, dz, dc, n, ch, stream);
}

// Sizes for lstm_gate_tables_build: out[0] the scratch bytes, out[1] the
// most bytes the packed tables may take.
extern "C" void lstm_gate_tables_sizes(long long* out) {
  out[0] = 65536 * (2 + 2) + 4 * sizeof(int);
  out[1] = kTableBytesMax;
}

// Builds the current device's activation tables on `stream` (three
// kernels; the all-bf16 entries read them): `scratch` of
// lstm_gate_tables_sizes()[0] bytes is free again on return, `packed` of
// `packed_bytes` bytes holds the tables until lstm_gate_tables_release.
// Synchronizes `stream`: once to read the derived ranges, once after the
// packing, so that every stream may use the tables. Returns 0, a CUDA
// error, or kTablesOutOfRange when the ranges are empty or the packed
// tables would not fit in `packed_bytes` or kTableBytesMax.
extern "C" int lstm_gate_tables_build(void* scratch, void* packed, long long packed_bytes, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sig = static_cast<uint16_t*>(scratch);
  auto* tnh = sig + 65536;
  auto* range = reinterpret_cast<int*>(tnh + 65536);
  act_eval_kernel<<<256, 256, 0, s>>>(sig, tnh, range);
  act_range_kernel<<<256, 256, 0, s>>>(sig, tnh, range);
  int r[4] = {0, 0, 0, 0};
  if ((err = cudaMemcpyAsync(r, range, sizeof r, cudaMemcpyDeviceToHost, s)) != cudaSuccess ||
      (err = cudaStreamSynchronize(s)) != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  ActTab t;
  t.packed = static_cast<const uint16_t*>(packed);
  t.slo = r[0];
  t.sspan = r[1] - r[0];
  t.tlo = r[2];
  t.tspan = r[3] - r[2];
  t.ns = (2 * (t.sspan + 2) + 7) / 8 * 8;
  t.nt = (2 * (t.tspan + 2) + 7) / 8 * 8;
  const long long bytes = 2LL * (t.ns + t.nt);
  if (t.sspan <= 0 || t.tspan <= 0 || bytes > packed_bytes || bytes > kTableBytesMax) return kTablesOutOfRange;
  act_pack_kernel<<<(t.ns + t.nt + 255) / 256, 256, 0, s>>>(sig, tnh, static_cast<uint16_t*>(packed), t);
  if ((err = cudaStreamSynchronize(s)) != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  g_tables[dev] = t;
  return 0;
}

// The current device's table ranges: out = {sigmoid lo, span, tanh lo,
// span, S entries, T entries}. Returns cudaErrorNotReady before a build.
extern "C" int lstm_gate_tables_info(int* out) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || g_tables[dev].packed == nullptr) return static_cast<int>(cudaErrorNotReady);
  const ActTab& t = g_tables[dev];
  const int v[6] = {t.slo, t.sspan, t.tlo, t.tspan, t.ns, t.nt};
  for (int j = 0; j < 6; ++j) out[j] = v[j];
  return 0;
}

// Forgets the current device's tables (the caller synchronizes first and
// then frees `packed`); the all-bf16 entries need a new build.
extern "C" int lstm_gate_tables_release() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices) g_tables[dev] = ActTab{};
  return 0;
}
