"""Fused ConvLSTM gate block (sigmoid gates), forward and backward.

Port of ``ivf_tpu/ops/pallas/fused_gates.py::pallas_gate_math``. With
``z = gates_x + gates_h`` in (i, f, c, o) order on the last axis::

    i, f, o = sigmoid(z_i, z_f, z_o)
    c' = f * c + i * tanh(z_c)
    h' = o * tanh(c')

On CUDA tensors both directions run in ``csrc/fused_gates.cu``, which
reads the gate tensors in place and adds ``gates_x + gates_h`` itself; on
CPU tensors in the plain versions below. The backward is a kernel too
(the JAX package took the autodiff of its jnp twin, which XLA fused into
one pass): given ``dh'`` and ``dc'``, with ``tc = tanh(c')``::

    dc'_total = dc' + dh' * o * (1 - tc^2)
    dz_o = dh' * tc * o * (1 - o)
    dz_i = dc'_total * tanh(z_c) * i * (1 - i)
    dz_f = dc'_total * c * f * (1 - f)
    dz_c = dc'_total * i * (1 - tanh(z_c)^2)
    dc   = dc'_total * f

and ``dz`` is the gradient of both ``gates_x`` and ``gates_h``.

bfloat16: the JAX package's bf16 search hands the kernel bfloat16 gates
(its convs cast to the weights' dtype) and a float32 state (the carry
keeps the clip's dtype), and returns ``h'`` and ``c'`` in ``c``'s dtype.
That mixed case, and the all-float32 one, are the two this module takes;
any other mix raises ``TypeError``. Its arithmetic is the JAX package's on
the CPU, rounding where XLA rounds:

* forward (the Pallas kernel body, compiled as one fusion):
  ``z = bf16(gates_x + gates_h)``; XLA's bf16 logistic
  ``s(x) = 1 / bf16(1 + bf16(exp(-x)))``; ``i = bf16(s(z_i))``,
  ``g = bf16(tanh(z_c))``, while ``f = s(z_f)`` and ``o = s(z_o)`` reach
  their float32 consumers unrounded (XLA's excess precision); then
  ``c' = f * c + i * g`` and ``h' = o * tanh(c')`` in float32;
* backward (the autodiff of ``_ref_math``, op by op): every bfloat16
  operation of its jaxpr rounds, the float32 ones do not; ``dz`` is
  bfloat16 and ``dc`` float32.

The kernel entries ``lstm_gates_{fwd,bwd}_bf16`` compute in float32
registers and round at the same points; they count their launches apart
from the float32 entries.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ivf_tpu_torch.ops.kernels import build


def _gates(gates_x, gates_h, c):
    z = gates_x if gates_h is None else gates_x + gates_h
    i, f, g, o = torch.split(z, c.shape[-1], dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 (nearest even), held in float32."""
    return t.bfloat16().float()


class _SigmoidBf16(torch.autograd.Function):
    """XLA's bfloat16 logistic with the logistic's own derivative, as
    ``jax.lax.logistic``'s JVP takes it: ``g * bf16(s * bf16(1 - s))`` on
    the bf16 output ``s``. The chain rule through ``1 / (1 + exp(-x))``
    would give ``0 * inf = NaN`` where ``exp(-x)`` overflows (x below
    about -88.7), where JAX's gradient is 0."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / _bf16(1 + _bf16(torch.exp(-x)))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        s = _bf16(s)
        return g * _bf16(s * _bf16(1 - s))


def sigmoid_bf16(x: torch.Tensor) -> torch.Tensor:
    """XLA's bfloat16 logistic on float32-held bf16 values, before its last
    rounding: ``1 / bf16(1 + bf16(exp(-x)))``; differentiable with the
    logistic's derivative (``_SigmoidBf16``)."""
    return _SigmoidBf16.apply(x)


def _mixed_z(gates_x, gates_h, c):
    """The four bf16 gate pre-activations, float32-held: ``gates_x +
    gates_h`` is a bfloat16 add, rounded."""
    z = gates_x if gates_h is None else gates_x + gates_h
    return torch.split(z.float(), c.shape[-1], dim=-1)


def mixed_gate_forward(gates_x, gates_h, c, act) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate block with bfloat16 gates and a float32 c as XLA compiles
    the JAX package's jnp gate math on the CPU: ``act`` gives a gate's
    bf16 activation before its last rounding; ``i`` and ``tanh(z_c)``
    feed a bf16 product and are rounded, while ``f``, ``o`` and ``i * g``
    reach their float32 consumers unrounded. Returns float32 (h', c')."""
    zi, zf, zc, zo = _mixed_z(gates_x, gates_h, c)
    i, g = _bf16(act(zi)), _bf16(torch.tanh(zc))
    new_c = act(zf) * c + i * g
    return act(zo) * torch.tanh(new_c), new_c


def _mixed(gates_x: torch.Tensor) -> bool:
    return gates_x.dtype == torch.bfloat16


def check_dtypes(gates_x, gates_h, c) -> None:
    """The two dtype cases of the JAX paths: all float32, or bfloat16
    gates with a float32 state. Anything else raises ``TypeError``."""
    gh = gates_x.dtype if gates_h is None else gates_h.dtype
    if c.dtype != torch.float32 or gates_x.dtype != gh or gh not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"fused_gates: gates {gates_x.dtype}/{gh} with state {c.dtype}; the kernels "
            "take float32 gates or bfloat16 gates, each with a float32 state"
        )


def gate_math_plain(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward, the JAX package's jnp twin ``_ref_math`` (with
    bf16 gates, the Pallas kernel's rounding): returns (h', c') in c's
    dtype."""
    if _mixed(gates_x):
        return mixed_gate_forward(gates_x, gates_h, c, sigmoid_bf16)
    i, f, g, o = _gates(gates_x, gates_h, c)
    new_c = f * c + i * g
    return o * torch.tanh(new_c), new_c


def _gate_math_bwd_mixed(gates_x, gates_h, c, dh, dc_out):
    """The autodiff of ``_ref_math`` with bf16 z and float32 c, op by op in
    the order of its jaxpr: ``_bf16`` wherever the op's result is
    bfloat16."""
    zi, zf, zc, zo = _mixed_z(gates_x, gates_h, c)
    i, f = _bf16(sigmoid_bf16(zi)), _bf16(sigmoid_bf16(zf))
    g, o = _bf16(torch.tanh(zc)), _bf16(sigmoid_bf16(zo))
    tc = torch.tanh(f * c + _bf16(i * g))
    e = o * dh * (1 - tc)
    dcn = dc_out + e + e * tc  # float32: dc' + dh o (1 - tanh(c')^2)
    dcn_b = _bf16(dcn)
    dzc = _bf16(_bf16(i * dcn_b) * _bf16(1 - g))
    dz = torch.cat(
        [
            _bf16(_bf16(dcn_b * g) * _bf16(i * _bf16(1 - i))),
            _bf16(_bf16(dcn * c) * _bf16(f * _bf16(1 - f))),
            _bf16(dzc + _bf16(dzc * g)),
            _bf16(_bf16(dh * tc) * _bf16(o * _bf16(1 - o))),
        ],
        dim=-1,
    )
    return dz.bfloat16(), f * dcn


def gate_math_bwd_plain(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain backward, the formulas of the module docstring (with bf16
    gates, the JAX autodiff's rounding): returns (dz (..., 4 Ch) in the
    gates' dtype, dc (..., Ch) float32)."""
    if _mixed(gates_x):
        return _gate_math_bwd_mixed(gates_x, gates_h, c, dh, dc_out)
    i, f, g, o = _gates(gates_x, gates_h, c)
    tc = torch.tanh(f * c + i * g)
    dcn = dc_out + dh * o * (1 - tc * tc)
    dz = torch.cat(
        [
            dcn * g * i * (1 - i),
            dcn * c * f * (1 - f),
            dcn * i * (1 - g * g),
            dh * tc * o * (1 - o),
        ],
        dim=-1,
    )
    return dz, dcn * f


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_gates")
    ptr, rows_ch = ctypes.c_void_p, [ctypes.c_longlong, ctypes.c_int]
    for suffix in ("f32", "bf16"):
        fwd, bwd = getattr(lib, f"lstm_gates_fwd_{suffix}"), getattr(lib, f"lstm_gates_bwd_{suffix}")
        fwd.argtypes = [ptr] * 5 + rows_ch + [ptr]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ptr] * 7 + rows_ch + [ptr]
        bwd.restype = ctypes.c_int
    return lib


def _check_cuda_operands(gates_x, gates_h, c, gate_dtype, *state_like) -> None:
    named = [("gates_x", gates_x, gate_dtype), ("c", c, torch.float32)]
    if gates_h is not None:
        named.append(("gates_h", gates_h, gate_dtype))
    named += [(f"grad{k}", t, torch.float32) for k, t in enumerate(state_like)]
    for name, t, dtype in named:
        if not t.is_cuda or t.device != c.device:
            raise ValueError(f"fused_gates: {name} must be on {c.device}")
        if t.dtype != dtype:
            raise TypeError(f"fused_gates: {name} is {t.dtype}; this entry takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_gates: {name} must be contiguous")
    if c.dim() == 0 or gates_x.shape != (*c.shape[:-1], 4 * c.shape[-1]):
        raise ValueError(
            f"fused_gates: gates {tuple(gates_x.shape)} is not (..., 4 * Ch) over c {tuple(c.shape)}"
        )
    if gates_h is not None and gates_h.shape != gates_x.shape:
        raise ValueError(f"fused_gates: gates_h {tuple(gates_h.shape)} != gates_x {tuple(gates_x.shape)}")
    for t in state_like:
        if t.shape != c.shape:
            raise ValueError(f"fused_gates: gradient {tuple(t.shape)} != c {tuple(c.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_fwd(suffix, gate_dtype, counter, gates_x, gates_h, c):
    _check_cuda_operands(gates_x, gates_h, c, gate_dtype)
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)
    if c.numel() == 0:
        return h_out, c_out
    ch = c.shape[-1]
    rc = getattr(_lib(), f"lstm_gates_fwd_{suffix}")(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        c.numel() // ch, ch, torch.cuda.current_stream(c.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates_fwd_{suffix} launch failed with CUDA error {rc}")
    counter.launches += 1
    return h_out, c_out


def _launch_bwd(suffix, gate_dtype, counter, gates_x, gates_h, c, dh, dc_out):
    _check_cuda_operands(gates_x, gates_h, c, gate_dtype, dh, dc_out)
    dz, dc = torch.empty_like(gates_x), torch.empty_like(c)
    if c.numel() == 0:
        return dz, dc
    ch = c.shape[-1]
    rc = getattr(_lib(), f"lstm_gates_bwd_{suffix}")(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), dh.data_ptr(), dc_out.data_ptr(),
        dz.data_ptr(), dc.data_ptr(), c.numel() // ch, ch,
        torch.cuda.current_stream(c.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates_bwd_{suffix} launch failed with CUDA error {rc}")
    counter.launches += 1
    return dz, dc


def lstm_gates_fwd_cuda(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_fwd_f32``; returns (h', c'). Counts its launches
    in ``lstm_gates_fwd_cuda.launches``."""
    return _launch_fwd("f32", torch.float32, lstm_gates_fwd_cuda, gates_x, gates_h, c)


def lstm_gates_bwd_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_f32``; returns (dz, dc). Counts its launches
    in ``lstm_gates_bwd_cuda.launches``."""
    return _launch_bwd("f32", torch.float32, lstm_gates_bwd_cuda, gates_x, gates_h, c, dh, dc_out)


def lstm_gates_fwd_bf16_cuda(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_fwd_bf16``: bfloat16 gates, float32 c; returns
    float32 (h', c'). Counts in ``lstm_gates_fwd_bf16_cuda.launches``."""
    return _launch_fwd("bf16", torch.bfloat16, lstm_gates_fwd_bf16_cuda, gates_x, gates_h, c)


def lstm_gates_bwd_bf16_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_bf16``; returns (dz bfloat16, dc float32).
    Counts in ``lstm_gates_bwd_bf16_cuda.launches``."""
    return _launch_bwd(
        "bf16", torch.bfloat16, lstm_gates_bwd_bf16_cuda, gates_x, gates_h, c, dh, dc_out
    )


for _fn in (
    lstm_gates_fwd_cuda, lstm_gates_bwd_cuda, lstm_gates_fwd_bf16_cuda, lstm_gates_bwd_bf16_cuda
):
    _fn.launches = 0


def _forward(gates_x, gates_h, c):
    if c.is_cuda:
        fn = lstm_gates_fwd_bf16_cuda if _mixed(gates_x) else lstm_gates_fwd_cuda
        return fn(gates_x, gates_h, c)
    if c.device.type == "cpu":
        return gate_math_plain(gates_x, gates_h, c)
    raise RuntimeError(f"fused_gates: no kernel for device {c.device}")


def _backward(gates_x, gates_h, c, dh, dc_out):
    if c.is_cuda:
        fn = lstm_gates_bwd_bf16_cuda if _mixed(gates_x) else lstm_gates_bwd_cuda
        return fn(gates_x, gates_h, c, dh, dc_out)
    if c.device.type == "cpu":
        return gate_math_bwd_plain(gates_x, gates_h, c, dh, dc_out)
    raise RuntimeError(f"fused_gates: no kernel for device {c.device}")


class _GateMath(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates_x, gates_h, c):
        h_out, c_out = _forward(gates_x, gates_h, c)
        # gates_x and gates_h as they are, not a summed z: see the source
        # note of csrc/fused_gates.cu
        ctx.save_for_backward(gates_x, gates_h, c)
        return h_out, c_out

    @staticmethod
    def backward(ctx, dh, dc_out):
        gates_x, gates_h, c = ctx.saved_tensors
        dz, dc = _backward(gates_x, gates_h, c, dh.contiguous(), dc_out.contiguous())
        return dz, (dz if gates_h is not None else None), dc


def gate_math(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid-gate LSTM block over contiguous gates (..., 4 Ch) in
    (i, f, c, o) order and state c (..., Ch); ``gates_h`` may be None.
    Gates float32 or bfloat16, c float32 (``check_dtypes``). Returns
    (h', c') in float32; differentiable in all three."""
    check_dtypes(gates_x, gates_h, c)
    return _GateMath.apply(gates_x, gates_h, c)
