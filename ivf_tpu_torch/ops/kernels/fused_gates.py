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
Its bf16 train step casts the clips to bfloat16, so there the state is
bfloat16 too. Those two cases, and the all-float32 one, are the three
this module takes; any other mix raises ``TypeError``. The mixed case's
arithmetic is the JAX package's on the CPU, rounding where XLA rounds:

* forward (the Pallas kernel body, compiled as one fusion):
  ``z = bf16(gates_x + gates_h)``; XLA's bf16 logistic
  ``s(x) = 1 / bf16(1 + bf16(exp(-x)))``; ``i = bf16(s(z_i))``,
  ``g = bf16(tanh(z_c))``, while ``f = s(z_f)`` and ``o = s(z_o)`` reach
  their float32 consumers unrounded (XLA's excess precision); then
  ``c' = f * c + i * g`` and ``h' = o * tanh(c')`` in float32;
* backward (the autodiff of ``_ref_math``, op by op): every bfloat16
  operation of its jaxpr rounds, the float32 ones do not; ``dz`` is
  bfloat16 and ``dc`` float32.

All bfloat16 (gates, c, and so h', c', dh', dc', dz, dc): XLA keeps no
excess precision where every consumer is bfloat16, so every operation of
the Pallas kernel body and of the ``_ref_math`` autodiff rounds, the
logistic ``bf16(1 / bf16(1 + bf16(exp(-x))))`` included
(``bf16_gate_forward``, ``_gate_math_bwd_bf16``; the compiled HLO of both
shows a bf16 convert after every op).

The kernel entries ``lstm_gates_{fwd,bwd}_bf16`` (bf16 gates, f32 state)
and ``lstm_gates_{fwd,bwd}_bf16s`` (all bf16) compute in float32
registers and round at the same points; each pair counts its launches
apart from the others. The all-bf16 pair reads its activations from
tables of the exact device functions over all 65,536 bf16 inputs, built
once per device at first use (``lstm_gate_tables_cuda``, counted apart);
``gate_table_twin`` is their plain twin, for the tests. While
``torch.export`` traces, the float32 forward is the custom op
``ivf_tpu_torch::lstm_gates_fwd_f32`` (``custom_ops.py``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from ivf_tpu_torch.ops.kernels import build, custom_ops


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


def bf16_gate_forward(gates_x, gates_h, c, act) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gate block with bfloat16 gates and a bfloat16 c as XLA compiles
    the JAX package's gate math on the CPU: every op rounds to bfloat16.
    ``act`` gives a gate's bf16 activation before its last rounding.
    Differentiable (through ``act``'s and the casts' backward); returns
    bfloat16 (h', c')."""
    zi, zf, zc, zo = _mixed_z(gates_x, gates_h, c)
    i, f, o = _bf16(act(zi)), _bf16(act(zf)), _bf16(act(zo))
    new_c = _bf16(_bf16(f * c.float()) + _bf16(i * _bf16(torch.tanh(zc))))
    return _bf16(o * _bf16(torch.tanh(new_c))).bfloat16(), new_c.bfloat16()


def _mixed(gates_x: torch.Tensor) -> bool:
    return gates_x.dtype == torch.bfloat16


def _all_bf16(c: torch.Tensor) -> bool:
    return c.dtype == torch.bfloat16


# the (gates, state) dtypes of each kernel entry pair, by its C name's suffix
_DTYPES = {
    "f32": (torch.float32, torch.float32),
    "bf16": (torch.bfloat16, torch.float32),
    "bf16s": (torch.bfloat16, torch.bfloat16),
}


def check_dtypes(gates_x, gates_h, c) -> None:
    """The three dtype cases of the JAX paths: all float32, bfloat16 gates
    with a float32 state, or all bfloat16. Anything else raises
    ``TypeError``."""
    gh = gates_x.dtype if gates_h is None else gates_h.dtype
    if gates_x.dtype != gh or (gh, c.dtype) not in _DTYPES.values():
        raise TypeError(
            f"fused_gates: gates {gates_x.dtype}/{gh} with state {c.dtype}; the kernels "
            "take float32 gates with a float32 state, or bfloat16 gates with a float32 "
            "or a bfloat16 state"
        )


def gate_math_plain(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward, the JAX package's jnp twin ``_ref_math`` (with
    bf16 gates, the Pallas kernel's rounding): returns (h', c') in c's
    dtype."""
    if _all_bf16(c):
        return bf16_gate_forward(gates_x, gates_h, c, sigmoid_bf16)
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


def _gate_math_bwd_bf16(gates_x, gates_h, c, dh, dc_out):
    """The autodiff of ``_ref_math`` all in bfloat16, op by op in the order
    of its compiled HLO, every op rounded; returns bfloat16 (dz, dc)."""
    b = _bf16
    zi, zf, zc, zo = _mixed_z(gates_x, gates_h, c)
    i, f, g, o = (b(sigmoid_bf16(zi)), b(sigmoid_bf16(zf)), b(torch.tanh(zc)), b(sigmoid_bf16(zo)))
    cf, dh, dc_out = c.float(), dh.float(), dc_out.float()
    tc = b(torch.tanh(b(b(f * cf) + b(i * g))))
    e = b(b(o * dh) * b(1 - tc))
    dcn = b(b(dc_out + e) + b(e * tc))  # dc' + dh o (1 - tanh(c')^2)
    dzc = b(b(i * dcn) * b(1 - g))
    dz = torch.cat(
        [
            b(dcn * g) * b(i * b(1 - i)),
            b(dcn * cf) * b(f * b(1 - f)),
            dzc + b(dzc * g),
            b(dh * tc) * b(o * b(1 - o)),
        ],
        dim=-1,
    )
    return dz.bfloat16(), (f * dcn).bfloat16()


def gate_math_bwd_plain(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain backward, the formulas of the module docstring (with bf16
    gates, the JAX autodiff's rounding): returns (dz (..., 4 Ch) in the
    gates' dtype, dc (..., Ch) in c's dtype)."""
    if _all_bf16(c):
        return _gate_math_bwd_bf16(gates_x, gates_h, c, dh, dc_out)
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


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Sets the argument types of ``csrc/fused_gates.cu``'s entries on
    ``lib``."""
    ptr, rows_ch = ctypes.c_void_p, [ctypes.c_longlong, ctypes.c_int]
    for suffix in _DTYPES:
        fwd, bwd = getattr(lib, f"lstm_gates_fwd_{suffix}"), getattr(lib, f"lstm_gates_bwd_{suffix}")
        fwd.argtypes = [ptr] * 5 + rows_ch + [ptr]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ptr] * 7 + rows_ch + [ptr]
        bwd.restype = ctypes.c_int
    if hasattr(lib, "lstm_gate_tables_build"):
        lib.lstm_gate_tables_sizes.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
        lib.lstm_gate_tables_sizes.restype = None
        lib.lstm_gate_tables_build.argtypes = [ptr, ptr, ctypes.c_longlong, ptr]
        lib.lstm_gate_tables_info.argtypes = [ctypes.POINTER(ctypes.c_int)]
        for name in ("lstm_gate_tables_build", "lstm_gate_tables_info", "lstm_gate_tables_release"):
            getattr(lib, name).restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return bind(build.library("fused_gates"))


_tables = {}  # CUDA device index -> its packed activation tables (kept alive)
_tables_lock = threading.Lock()


def _index(device: torch.device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


def lstm_gate_tables_cuda(device: torch.device) -> None:
    """Build ``device``'s activation tables for the all-bf16 entries
    (``lstm_gate_tables_build``: three kernels on the current stream, which
    it synchronizes) and keep them; raises if they do not build. Counts
    its builds in ``lstm_gate_tables_cuda.launches``."""
    lib = _lib()
    sizes = (ctypes.c_longlong * 2)()
    lib.lstm_gate_tables_sizes(sizes)
    with torch.cuda.device(device):
        scratch = torch.empty(sizes[0], dtype=torch.uint8, device=device)
        packed = torch.empty(sizes[1], dtype=torch.uint8, device=device)
        rc = lib.lstm_gate_tables_build(scratch.data_ptr(), packed.data_ptr(), sizes[1],
                                        torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"lstm_gate_tables_build on {device} failed with "
            + ("ranges that do not fit its shared-memory budget" if rc == -1 else f"CUDA error {rc}")
        )
    _tables[_index(device)] = packed
    lstm_gate_tables_cuda.launches += 1


def _ensure_tables(device: torch.device) -> None:
    if _index(device) not in _tables:
        with _tables_lock:
            if _index(device) not in _tables:
                lstm_gate_tables_cuda(device)


def packed_gate_tables(device: torch.device) -> Optional[dict]:
    """``device``'s packed tables as the kernels read them, as int32 bits
    in ``gate_table_twin``'s layout (its "s" and "t"); None before they are
    built."""
    packed = _tables.get(_index(device))
    info = gate_tables_info(device)
    if packed is None or info is None:
        return None
    words = packed.view(torch.int16).to(torch.int32) & 0xFFFF
    ns = info["s_entries"]
    return {"s": words[:2 * (info["sspan"] + 2)], "t": words[ns:ns + 2 * (info["tspan"] + 2)]}


def gate_tables_info(device: torch.device) -> Optional[dict]:
    """``device``'s table ranges as the card derived them (magnitude bits),
    or None before they are built."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(device):
        if _lib().lstm_gate_tables_info(out) != 0:
            return None
    return dict(zip(("slo", "sspan", "tlo", "tspan", "s_entries", "t_entries"), out))


def release_gate_tables() -> None:
    """Forget every device's tables (the next all-bf16 launch builds them
    again)."""
    with _tables_lock:
        for index in list(_tables):
            with torch.cuda.device(index):
                torch.cuda.synchronize()
                _lib().lstm_gate_tables_release()
            del _tables[index]


# the kernels' table constants (csrc/fused_gates.cu): the magnitude bits of
# inf (above them NaN), and the most bytes the packed tables may take
_INF_BITS = 0x7F80
GATE_TABLE_BYTES_MAX = 48 * 1024


def _bf16_of_bits(u: torch.Tensor) -> torch.Tensor:
    """bfloat16 values of the bit patterns ``u`` (int32 in [0, 65536))."""
    return torch.where(u >= 32768, u - 65536, u).to(torch.int16).view(torch.bfloat16)


def _bits_of(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of ``t`` rounded to bfloat16, int32."""
    return t.bfloat16().view(torch.int16).to(torch.int32) & 0xFFFF


def _exact_activations(u: torch.Tensor):
    """The all-bf16 block's two activations of the bf16 inputs ``u``,
    exactly as the plain block computes them, as bits: ``bf16(s(z))`` and
    ``bf16(tanh(z))``."""
    z = _bf16_of_bits(u).float()
    return _bits_of(sigmoid_bf16(z)), _bits_of(torch.tanh(z))


def _packed(values: torch.Tensor, lo: int, span: int) -> torch.Tensor:
    """Per sign, the value at +-0, the values at magnitudes [lo, lo + span)
    and the value at +-inf: the kernels' layout of one family."""
    mags = torch.arange(lo - 1, lo + span + 1, device=values.device)
    mags[0], mags[-1] = 0, _INF_BITS
    return torch.cat([values[mags], values[mags | 0x8000]])


def gate_table_twin(device="cpu") -> dict:
    """The plain twin of the all-bf16 kernels' activation tables
    (``lstm_gate_tables_build`` in ``csrc/fused_gates.cu``), for the
    tests; nothing on the main path uses it. Evaluates the plain block's
    activations on all 65,536 bf16 inputs and derives the ranges of
    magnitude bits [lo, lo + span) outside which a value is a constant of
    the input's sign (the value at +-0 below, at +-inf from the end on) or,
    for tanh below lo, the input itself; packs each family as the kernels
    do (``_packed``). Returns the ranges, the packed families (bits) and
    the bytes of the kernels' tables (S and T regions, each 16-byte
    aligned), which each block copies into shared memory. On ``device``:
    on the card, with the kernels' own ``expf`` / ``tanhf``."""
    u = torch.arange(65536, dtype=torch.int32, device=device)
    s, t = _exact_activations(u)
    a, sign = u & 0x7FFF, u & 0x8000
    finite = a < _INF_BITS

    def bounds(small_differs, large_differs):
        return int(a[finite & small_differs].min()), int(a[finite & large_differs].max()) + 1

    slo, shi = bounds(s != s[sign], s != s[sign | _INF_BITS])
    tlo, thi = bounds(t != u, t != t[sign | _INF_BITS])
    ns, nt = (-(-2 * (span + 2) // 8) * 8 for span in (shi - slo, thi - tlo))
    return {
        "slo": slo, "sspan": shi - slo, "tlo": tlo, "tspan": thi - tlo,
        "s": _packed(s, slo, shi - slo), "t": _packed(t, tlo, thi - tlo),
        "bytes": 2 * (ns + nt),
    }


def gate_table_lookup(twin: dict, u: torch.Tensor):
    """The kernels' reading of the tables for bf16 inputs ``u`` (int32
    bits), in plain PyTorch: a clamped index per family (the sign's small
    constant, the table, or the sign's large constant), tanh passing its
    input through below its range, and the exact functions for NaN.
    Returns the bits of (s, tanh)."""
    a, sign = u & 0x7FFF, u >> 15

    def slot(lo, span):
        return sign * (span + 2) + (a - lo + 1).clamp(0, span + 1)

    s = twin["s"][slot(twin["slo"], twin["sspan"])]
    t = torch.where(a < twin["tlo"], u, twin["t"][slot(twin["tlo"], twin["tspan"])])
    nan = a > _INF_BITS
    exact = _exact_activations(u[nan])
    for out, x in zip((s, t), exact):
        out[nan] = x
    return s, t


# the operand slots of ``exhaustive_operands``, in the order of its blocks
EXHAUSTIVE_SLOTS = ("z_i", "z_f", "z_c", "z_o", "c", "dh", "dc_out")


def exhaustive_operands(with_gh: bool, ch: int = 4, seed: int = 0, device="cpu"):
    """All-bf16 gate operands that put each of the 65,536 bf16 bit
    patterns into every operand slot in turn, for the tests: block j of
    65,536 consecutive elements of c holds every pattern, in order, in slot
    ``EXHAUSTIVE_SLOTS[j]`` (a gate of z, c, dh or dc'), the other operands
    seeded normals (gates x3 and x2, c x2). With ``gates_h`` the patterns'
    gate in it is -0.0, so z is the pattern itself, NaN payloads and -0
    included. Returns (gates_x, gates_h or None, c, dh, dc_out), rows of
    ``ch`` channels."""
    gen = torch.Generator().manual_seed(seed)
    n = len(EXHAUSTIVE_SLOTS) * 65536
    rows = n // ch
    patterns = _bf16_of_bits(torch.arange(65536, dtype=torch.int32))
    gx = (torch.randn(rows, 4, ch, generator=gen) * 3).bfloat16()
    gh = (torch.randn(rows, 4, ch, generator=gen) * 2).bfloat16() if with_gh else None
    c, dh, dc_out = ((torch.randn(n, generator=gen) * scale).bfloat16() for scale in (2, 1, 1))
    for j, slot in enumerate(EXHAUSTIVE_SLOTS):
        block = slice(j * 65536, (j + 1) * 65536)
        if j < 4:
            for t, value in ((gx, patterns), (gh, torch.tensor(-0.0, dtype=torch.bfloat16))):
                if t is not None:
                    flat = t[:, j, :].reshape(-1)
                    flat[block] = value
                    t[:, j, :] = flat.view(rows, ch)
        else:
            {"c": c, "dh": dh, "dc_out": dc_out}[slot][block] = patterns
    gates = [t if t is None else t.view(rows, 4 * ch).to(device) for t in (gx, gh)]
    return (*gates, *(t.view(rows, ch).to(device) for t in (c, dh, dc_out)))


def first_unequal(got: dict, want: dict, ch: int) -> Optional[str]:
    """The first output of ``got`` (name -> bf16 tensor of
    ``exhaustive_operands``' shapes) whose bits differ from ``want``'s,
    named by its slot and input pattern; None when all are equal."""
    for name, a in got.items():
        bad = (a.view(torch.int16) != want[name].view(torch.int16)).flatten().nonzero()
        if len(bad):
            i = int(bad[0])
            e = (i // (4 * ch)) * ch + i % ch if a.shape[-1] == 4 * ch else i
            return (f"{name}: {len(bad)} unequal, first at element {e} (slot "
                    f"{EXHAUSTIVE_SLOTS[e // 65536]}, input 0x{e % 65536:04x}): "
                    f"0x{int(a.flatten()[i].view(torch.int16)) & 0xFFFF:04x} against "
                    f"0x{int(want[name].flatten()[i].view(torch.int16)) & 0xFFFF:04x}")
    return None


def _check_cuda_operands(gates_x, gates_h, c, gate_dtype, state_dtype, *state_like) -> None:
    named = [("gates_x", gates_x, gate_dtype), ("c", c, state_dtype)]
    if gates_h is not None:
        named.append(("gates_h", gates_h, gate_dtype))
    named += [(f"grad{k}", t, state_dtype) for k, t in enumerate(state_like)]
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


def _launch_fwd(suffix, counter, gates_x, gates_h, c):
    _check_cuda_operands(gates_x, gates_h, c, *_DTYPES[suffix])
    if suffix == "bf16s":
        _ensure_tables(c.device)
    h_out, c_out = torch.empty_like(c), torch.empty_like(c)
    if c.numel() == 0:
        return h_out, c_out
    ch = c.shape[-1]
    rc = getattr(_lib(), f"lstm_gates_fwd_{suffix}")(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
        c.numel() // ch, ch, build.stream(c),
    )
    if rc != 0:
        raise RuntimeError(f"lstm_gates_fwd_{suffix} launch failed with CUDA error {rc}")
    counter.launches += 1
    return h_out, c_out


def _launch_bwd(suffix, counter, gates_x, gates_h, c, dh, dc_out):
    _check_cuda_operands(gates_x, gates_h, c, *_DTYPES[suffix], dh, dc_out)
    if suffix == "bf16s":
        _ensure_tables(c.device)
    dz, dc = torch.empty_like(gates_x), torch.empty_like(c)
    if c.numel() == 0:
        return dz, dc
    ch = c.shape[-1]
    rc = getattr(_lib(), f"lstm_gates_bwd_{suffix}")(
        gates_x.data_ptr(), _ptr(gates_h), c.data_ptr(), dh.data_ptr(), dc_out.data_ptr(),
        dz.data_ptr(), dc.data_ptr(), c.numel() // ch, ch,
        build.stream(c),
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
    return _launch_fwd("f32", lstm_gates_fwd_cuda, gates_x, gates_h, c)


def lstm_gates_bwd_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_f32``; returns (dz, dc). Counts its launches
    in ``lstm_gates_bwd_cuda.launches``."""
    return _launch_bwd("f32", lstm_gates_bwd_cuda, gates_x, gates_h, c, dh, dc_out)


def lstm_gates_fwd_bf16_cuda(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_fwd_bf16``: bfloat16 gates, float32 c; returns
    float32 (h', c'). Counts in ``lstm_gates_fwd_bf16_cuda.launches``."""
    return _launch_fwd("bf16", lstm_gates_fwd_bf16_cuda, gates_x, gates_h, c)


def lstm_gates_bwd_bf16_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_bf16``; returns (dz bfloat16, dc float32).
    Counts in ``lstm_gates_bwd_bf16_cuda.launches``."""
    return _launch_bwd("bf16", lstm_gates_bwd_bf16_cuda, gates_x, gates_h, c, dh, dc_out)


def lstm_gates_fwd_bf16s_cuda(
    gates_x: torch.Tensor, gates_h: Optional[torch.Tensor], c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_fwd_bf16s``: bfloat16 gates and c; returns
    bfloat16 (h', c'). Counts in ``lstm_gates_fwd_bf16s_cuda.launches``."""
    return _launch_fwd("bf16s", lstm_gates_fwd_bf16s_cuda, gates_x, gates_h, c)


def lstm_gates_bwd_bf16s_cuda(
    gates_x: torch.Tensor,
    gates_h: Optional[torch.Tensor],
    c: torch.Tensor,
    dh: torch.Tensor,
    dc_out: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``lstm_gates_bwd_bf16s``: everything bfloat16; returns (dz,
    dc). Counts in ``lstm_gates_bwd_bf16s_cuda.launches``."""
    return _launch_bwd("bf16s", lstm_gates_bwd_bf16s_cuda, gates_x, gates_h, c, dh, dc_out)


_ENTRIES = {  # suffix -> (forward, backward) wrappers
    "f32": (lstm_gates_fwd_cuda, lstm_gates_bwd_cuda),
    "bf16": (lstm_gates_fwd_bf16_cuda, lstm_gates_bwd_bf16_cuda),
    "bf16s": (lstm_gates_fwd_bf16s_cuda, lstm_gates_bwd_bf16s_cuda),
}


for _pair in _ENTRIES.values():
    for _fn in _pair:
        _fn.launches = 0
lstm_gate_tables_cuda.launches = 0


def _entries(gates_x, c):
    return _ENTRIES[next(k for k, dts in _DTYPES.items() if dts == (gates_x.dtype, c.dtype))]


# the float32 forward as the custom op ivf_tpu_torch::lstm_gates_fwd_f32 (custom_ops.py)
lstm_gates_fwd_f32_op = custom_ops.define(
    "lstm_gates_fwd_f32", gate_math_plain, lstm_gates_fwd_cuda,
    lambda gates_x, gates_h, c: (torch.empty_like(c), torch.empty_like(c)),
)


def _forward(gates_x, gates_h, c):
    if custom_ops.through_op("fused_gates", gates_x):
        return lstm_gates_fwd_f32_op(gates_x, gates_h, c)
    if c.is_cuda:
        return _entries(gates_x, c)[0](gates_x, gates_h, c)
    if c.device.type == "cpu":
        return gate_math_plain(gates_x, gates_h, c)
    raise RuntimeError(f"fused_gates: no kernel for device {c.device}")


def _backward(gates_x, gates_h, c, dh, dc_out):
    if c.is_cuda:
        return _entries(gates_x, c)[1](gates_x, gates_h, c, dh, dc_out)
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
    Gates float32 with c float32, or gates bfloat16 with c float32 or
    bfloat16 (``check_dtypes``). Returns (h', c') in c's dtype;
    differentiable in all three."""
    check_dtypes(gates_x, gates_h, c)
    return _GateMath.apply(gates_x, gates_h, c)
