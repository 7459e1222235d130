"""Pointwise (1x1x1) conv + bias + ReLU: ``act(X @ W + b)``.

Port of ``ivf_tpu/ops/pallas/pointwise_conv.py::pallas_pointwise_conv``.
On a CUDA tensor the GEMM runs in the hand-written kernels of
``csrc/pointwise_conv.cu`` (never cuBLAS); on a CPU tensor it runs the
plain PyTorch version ``pointwise_conv_plain``. The VJP follows the JAX
package's ``_pw_bwd``: ``m = g * [y > 0]``, ``dx = m @ W^T`` through the
same kernel, ``dw = X^T m`` and ``db = sum(m)`` in plain PyTorch (JAX also
left them outside the kernel), each only when autograd asks for it.

float32 runs ``pw_gemm_f32`` (a register-blocked CUDA-core GEMM in one of
five tile instances, ``F32_TILES``) or, for a handful of rows (the logits
head), ``pw_gemm_f32_rows``; ``f32_plan`` picks one from the shapes,
strides and alignment. Every output is one fmaf chain over K in ascending
order, then the bias, then the ReLU: no TF32, no split of K, so the fused
branch 3 gives the same bits. W is read as stored, (Cin, Cout) row-major
or the column-major view of a (Cout, Cin) conv weight, so neither the
forward nor the ``dx`` launch (on ``W.t()``) copies it.

bfloat16 (``pointwise_conv_bf16_cuda``, its own launch counter): float32
accumulation, the bias added in float32, the ReLU, one rounding to
bfloat16, as the Pallas kernel; the backward's ReLU mask is taken on the
bfloat16 output, and ``dw``, ``db`` are summed in float32 and cast to the
parameters' dtype, as the JAX package's VJP does. The bf16 kernels read W
as stored too. ``bf16_plan`` picks the path from the shapes, strides and
alignment: the TMA + ``wgmma`` streaming kernel for the trunk's GEMMs, the
split-K pair (a float32 scratch summed in a fixed order, no atomics) for
the logits head and any other shape.

While ``torch.export`` traces, the float32 GEMM is the custom op
``ivf_tpu_torch::pw_gemm_f32`` (``custom_ops.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ivf_tpu_torch.ops.kernels import build, custom_ops


def pointwise_conv_plain(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool
) -> torch.Tensor:
    """The plain version: ``x2 @ w + bias``, then ReLU; bfloat16 operands
    are multiplied and summed in float32 and rounded once at the end."""
    dtype = x2.dtype
    if dtype == torch.bfloat16:
        x2, w = x2.float(), w.float()
        bias = bias.float() if bias is not None else None
    y = x2 @ w
    if bias is not None:
        y = y + bias
    return (torch.relu(y) if relu else y).to(dtype)


# bf16 path (a): column tiles of these widths (one wgmma shape each), on
# 128-row tiles and 64-deep K slabs
TMA_WIDTHS = tuple(range(32, 257, 32))
TMA_MIN_ROWS = 64
TMA_ROWS, TMA_SLAB = 128, 64
# a slab's fixed cost (barrier round trips, wgmma latency) in columns of
# wgmma work: the choice of width is flat from 10 to 100 on the H100
TMA_SLAB_COST_COLS = 64
H100_SMS = 132
# bf16 path (b): threads to aim for, ~512 on each of the H100's 132 SMs
SPLITK_THREADS = 132 * 512


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_width(n: int, cin: int, cout: int, sms: int = H100_SMS) -> int:
    """The column-tile width of the TMA path: the one that minimizes the
    work of the busiest SM, waves of tiles x K slabs x (width + a slab's
    fixed cost). Many rows take wide tiles (X read once); few rows with a
    long K take narrow ones, to spread over more SMs."""
    def cost(bn):
        waves = _cdiv(_cdiv(n, TMA_ROWS) * _cdiv(cout, bn), sms)
        return waves * _cdiv(cin, TMA_SLAB) * (bn + TMA_SLAB_COST_COLS)

    return min(TMA_WIDTHS, key=lambda bn: (cost(bn), bn))


def bf16_plan(n: int, cin: int, cout: int, x_stride, x_ptr: int, w_stride, w_ptr: int,
              sms: int = H100_SMS) -> dict:
    """Which bf16 kernel takes ``X (n, cin) @ W (cin, cout)``, from the
    shapes, the element strides and the byte addresses alone.

    ``"tma"`` (the streaming path) needs n >= 64, Cout a multiple of 8, X's
    rows contiguous with a row stride of a multiple of 8 elements, and W
    contiguous along Cout (``w_mn_major``) or along Cin (the view of a
    (Cout, Cin) weight) with its other stride a multiple of 8; both bases
    16-byte aligned. Cout is cut into ``col_tiles`` tiles of ``bn``
    columns (``tma_width`` on ``sms`` SMs).
    Anything else is ``"splitk"``: K in ``splits`` chunks of ``chunk`` (a
    multiple of 8), enough for ~``SPLITK_THREADS`` threads, with 16-byte
    loads (``vec``) where X's rows and W's columns are K-contiguous and
    aligned."""
    def aligned(ptr, ld):
        return ptr % 16 == 0 and ld % 8 == 0

    w_mn = w_stride[1] == 1 and aligned(w_ptr, w_stride[0])
    w_k = w_stride[0] == 1 and aligned(w_ptr, w_stride[1])
    x_rows = x_stride[1] == 1 and aligned(x_ptr, x_stride[0])
    if n >= TMA_MIN_ROWS and cin > 0 and cout % 8 == 0 and x_rows and (w_mn or w_k):
        bn = tma_width(n, cin, cout, sms)
        return {"path": "tma", "bn": bn, "col_tiles": _cdiv(cout, bn), "w_mn_major": w_mn}
    splits = max(1, min(_cdiv(SPLITK_THREADS, max(1, n * cout)), _cdiv(cin, 8)))
    chunk = _cdiv(_cdiv(cin, splits), 8) * 8
    splits = _cdiv(cin, chunk) if cin else 1
    vec = cin % 8 == 0 and x_rows and w_stride[0] == 1 and aligned(w_ptr, w_stride[1])
    return {"path": "splitk", "splits": splits, "chunk": chunk, "vec": vec}


# float32 tile instances of pw_gemm_f32, in the order of csrc/pointwise_conv.cu
# (F32Tile0 ..): "BMxBN/TMxTN" -> (BM, BN, TM, TN); the block has
# (BM/TM)*(BN/TN) threads, each TM x TN outputs
F32_TILES = {
    "128x64/8x4": (128, 64, 8, 4),
    "64x64/8x4": (64, 64, 8, 4),
    "64x32/4x4": (64, 32, 4, 4),
    "32x32/4x4": (32, 32, 4, 4),
    "32x32/2x4": (32, 32, 2, 4),
}
F32_SLAB = 32  # K per slab
F32_ROWS_MAX = 16  # n at or below this takes pw_gemm_f32_rows (4 rows x 8 columns a block)
# the planner's cost model of a tile, in microseconds: C0 + K slabs * (C1 *
# b + C2 * ceil(b / R)), b the blocks of the busiest SM: C1 is a block's
# share of the SM's rate per slab, C2 a slab's latency for each round of R
# blocks that the SM runs at once; fitted to `chip_smoke.py --f32-tile-sweep`
# (every main-path shape, forward and dx, at every tile), R the best of 1-6
F32_COST = {  # name -> (C0, C1, C2, R)
    "128x64/8x4": (2.4489, 1.7125, 0.1493, 2),
    "64x64/8x4": (1.8806, 0.8432, 0.3314, 4),
    "64x32/4x4": (2.6921, 0.5174, 0.1334, 4),
    "32x32/4x4": (2.6774, 0.1433, 0.498, 3),
    "32x32/2x4": (2.05, 0.3409, 0.1763, 5),
}


def f32_tile_cost(name: str, n: int, cin: int, cout: int, sms: int = H100_SMS) -> float:
    """The cost model's microseconds for tile ``name`` at X (n, cin) @ W
    (cin, cout) on ``sms`` SMs."""
    bm, bn, _, _ = F32_TILES[name]
    c0, c1, c2, r = F32_COST[name]
    busiest = _cdiv(_cdiv(n, bm) * _cdiv(cout, bn), sms)
    return c0 + _cdiv(cin, F32_SLAB) * (c1 * busiest + c2 * _cdiv(busiest, r))


def f32_plan(n: int, cin: int, cout: int, x_stride, x_ptr: int, w_stride, w_ptr: int,
             sms: int = H100_SMS, tile: Optional[str] = None) -> dict:
    """Which float32 kernel takes ``X (n, cin) @ W (cin, cout)``, from the
    shapes, the element strides and the byte addresses alone.

    ``"rows"`` (``pw_gemm_f32_rows``) for n <= ``F32_ROWS_MAX``, else the
    tile of ``F32_TILES`` with the least ``f32_tile_cost``; ``tile``
    forces one (a name of ``F32_TILES`` or ``"rows"``). W is staged
    K-major (``w_k_major``) when its K stride is 1 and its Cout stride is
    not (the view of a (Cout, Cin) weight), else MN-major. ``vec`` lists
    where 16-byte copies and stores go: ``x`` (X's rows contiguous, row
    stride a multiple of 4, 16-byte aligned), ``w`` (likewise along W's
    contiguous dimension), ``y`` (Cout a multiple of 4)."""
    if tile is None:
        tile = "rows" if n <= F32_ROWS_MAX else min(
            F32_TILES, key=lambda t: (f32_tile_cost(t, n, cin, cout, sms), -F32_TILES[t][0] * F32_TILES[t][1]))
    elif tile != "rows" and tile not in F32_TILES:
        raise ValueError(f"pointwise_conv: no float32 tile {tile!r}; tiles: rows, {', '.join(F32_TILES)}")
    w_k_major = w_stride[0] == 1 and w_stride[1] != 1
    lead = w_stride[1] if w_k_major else w_stride[0]
    contiguous = w_stride[0] == 1 if w_k_major else w_stride[1] == 1
    vec = []
    if x_stride[1] == 1 and x_stride[0] % 4 == 0 and x_ptr % 16 == 0:
        vec.append("x")
    if contiguous and lead % 4 == 0 and w_ptr % 16 == 0:
        vec.append("w")
    if cout % 4 == 0:
        vec.append("y")
    return {"path": "rows" if tile == "rows" else "tile", "tile": tile, "w_k_major": w_k_major, "vec": vec}


_F32_VEC_BITS = {"x": 1, "w": 2, "y": 4}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("pointwise_conv")
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pw_conv_f32.argtypes = [ptr, ll, ptr, ll, ll, ptr, ptr, ll, i, i, i, i, i, i, ptr]
    lib.pw_conv_bf16_tma.argtypes = [ptr, ll, ptr, ll, i, ptr, ptr, ll, i, i, i, i, ptr]
    lib.pw_conv_bf16_splitk.argtypes = [ptr, ll, ll, ptr, ll, ll, ptr, ptr, ptr, ll, i, i, i, i, i, i, ptr]
    for fn in (lib.pw_conv_f32, lib.pw_conv_bf16_tma, lib.pw_conv_bf16_splitk):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x2, w, bias, dtype, strided=()) -> None:
    """Device, dtype and shapes; contiguity of every operand not named in
    ``strided``."""
    tensors = [("x", x2), ("w", w)] + ([("bias", bias)] if bias is not None else [])
    for name, t in tensors:
        if not t.is_cuda or t.device != x2.device:
            raise ValueError(f"pointwise_conv: {name} must be on {x2.device}")
        if t.dtype != dtype:
            raise TypeError(f"pointwise_conv: {name} is {t.dtype}; the kernel takes {dtype}")
        if not t.is_contiguous() and name not in strided:
            raise ValueError(f"pointwise_conv: {name} must be contiguous")
    if x2.dim() != 2 or w.dim() != 2 or x2.shape[1] != w.shape[0]:
        raise ValueError(
            f"pointwise_conv: x {tuple(x2.shape)} @ w {tuple(w.shape)} is not (N, Cin) @ (Cin, Cout)"
        )
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"pointwise_conv: bias {tuple(bias.shape)} != ({w.shape[1]},)")


@functools.lru_cache(maxsize=None)
def _sm_count(index: Optional[int]) -> int:
    return torch.cuda.get_device_properties(index if index is not None else 0).multi_processor_count


def _raise_on(symbol: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")


def pointwise_conv_cuda(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool,
    tile: Optional[str] = None,
) -> torch.Tensor:
    """Launch the float32 GEMM: x2 (N, Cin) contiguous, w (Cin, Cout) with
    any strides (read as stored), bias (Cout,) contiguous or None; float32
    on one CUDA device; Y (N, Cout) contiguous. ``f32_plan`` picks the
    kernel (``tile`` forces one). Counts its launches in
    ``pointwise_conv_cuda.launches``."""
    _check_cuda_operands(x2, w, bias, torch.float32, strided=("w",))
    n, cin = x2.shape
    cout = w.shape[1]
    y = torch.empty((n, cout), device=x2.device, dtype=torch.float32)
    if n == 0 or cout == 0:
        return y
    plan = f32_plan(n, cin, cout, x2.stride(), x2.data_ptr(), w.stride(), w.data_ptr(),
                    _sm_count(x2.device.index), tile)
    rc = _lib().pw_conv_f32(
        x2.data_ptr(), x2.stride(0), w.data_ptr(), w.stride(0), w.stride(1),
        bias.data_ptr() if bias is not None else None, y.data_ptr(), n, cin, cout,
        -1 if plan["path"] == "rows" else list(F32_TILES).index(plan["tile"]), int(plan["w_k_major"]),
        sum(_F32_VEC_BITS[v] for v in plan["vec"]), int(relu), build.stream(x2),
    )
    _raise_on("pw_conv_f32", rc)
    pointwise_conv_cuda.launches += 1
    return y


def pointwise_conv_bf16_cuda(
    x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool
) -> torch.Tensor:
    """Launch the bf16 GEMM: x2 (N, Cin) and w (Cin, Cout) with any
    strides, bias (Cout,) contiguous or None; bfloat16 on one CUDA device;
    Y (N, Cout) contiguous. ``bf16_plan`` picks the kernel. Counts calls
    (one per GEMM, whichever path) in ``pointwise_conv_bf16_cuda.launches``."""
    _check_cuda_operands(x2, w, bias, torch.bfloat16, strided=("x", "w"))
    n, cin = x2.shape
    cout = w.shape[1]
    y = torch.empty((n, cout), device=x2.device, dtype=torch.bfloat16)
    if n == 0 or cout == 0:
        return y
    plan = bf16_plan(n, cin, cout, x2.stride(), x2.data_ptr(), w.stride(), w.data_ptr(),
                     _sm_count(x2.device.index))
    b = bias.data_ptr() if bias is not None else None
    if plan["path"] == "tma":
        mn = plan["w_mn_major"]
        rc = _lib().pw_conv_bf16_tma(
            x2.data_ptr(), x2.stride(0), w.data_ptr(), w.stride(0) if mn else w.stride(1), int(mn),
            b, y.data_ptr(), n, cin, cout, plan["bn"], int(relu), build.stream(x2),
        )
        _raise_on("pw_conv_bf16_tma", rc)
    else:
        part = torch.empty((plan["splits"], n, cout), device=x2.device, dtype=torch.float32)
        rc = _lib().pw_conv_bf16_splitk(
            x2.data_ptr(), x2.stride(0), x2.stride(1), w.data_ptr(), w.stride(0), w.stride(1),
            b, y.data_ptr(), part.data_ptr(), n, cin, cout, plan["splits"], plan["chunk"],
            int(plan["vec"]), int(relu), build.stream(x2),
        )
        _raise_on("pw_conv_bf16_splitk", rc)
    pointwise_conv_bf16_cuda.launches += 1
    return y


pointwise_conv_cuda.launches = 0
pointwise_conv_bf16_cuda.launches = 0


def _gemm_plain(x2: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor], relu: bool) -> torch.Tensor:
    # W may be a transposed view (the layers' weight, dx's W^T): the plain
    # version multiplies a contiguous copy, whichever layout came in
    return pointwise_conv_plain(x2, w.contiguous(), bias, relu)


def _gemm_f32_fake(x2, w, bias, relu):
    return x2.new_empty((x2.shape[0], w.shape[1]))


# the float32 GEMM as the custom op ivf_tpu_torch::pw_gemm_f32 (custom_ops.py)
pw_gemm_f32_op = custom_ops.define("pw_gemm_f32", _gemm_plain, pointwise_conv_cuda, _gemm_f32_fake)


def _matmul_act(x2, w, bias, relu):
    if custom_ops.through_op("pointwise_conv", x2):
        return pw_gemm_f32_op(x2, w, bias, relu)
    if x2.is_cuda:
        fn = pointwise_conv_bf16_cuda if x2.dtype == torch.bfloat16 else pointwise_conv_cuda
        return fn(x2, w, bias, relu)
    if x2.device.type == "cpu":
        return _gemm_plain(x2, w, bias, relu)
    raise RuntimeError(f"pointwise_conv: no kernel for device {x2.device}")


class _PointwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, bias, relu):
        y = _matmul_act(x2, w, bias, relu)
        ctx.relu = relu
        ctx.has_bias = bias is not None
        ctx.save_for_backward(x2, w, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x2, w, y = ctx.saved_tensors
        m = torch.where(y > 0, g, 0.0) if ctx.relu else g
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _matmul_act(m.contiguous(), w.t(), None, False)
        if ctx.needs_input_grad[1]:
            dw = (x2.t().float() @ m.float()).to(w.dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = m.float().sum(0).to(w.dtype)
        return dx, dw, db, None


def pointwise_conv(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    relu: bool = True,
) -> torch.Tensor:
    """x: (..., Cin) contiguous; w: (Cin, Cout); bias: (Cout,) or None.
    Returns (..., Cout). Differentiable in x, w and bias."""
    lead = x.shape[:-1]
    y = _PointwiseConv.apply(x.reshape(-1, x.shape[-1]), w, bias, relu)
    return y.reshape(*lead, w.shape[1])
