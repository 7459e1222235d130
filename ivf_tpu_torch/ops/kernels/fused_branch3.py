"""Fused Inception branch 3: 3x3x3 stride-1 max pool -> 1x1x1 conv -> bias
[-> ReLU], forward and backward.

Port of ``ivf_tpu/ops/pallas/fused_branch3.py``: ``fused_pool_conv`` (the
Pallas grid over (b, t) frames) and ``fused_pool_conv_tblock`` (over whole
samples). Both compute one function, with the branch-3 pool's every-tie
rule (``maxpool3d.py``)::

    y  = act(pool(x) @ w + b)
    gc = (g * [y != 0]) @ w^T          ([y != 0] only with the ReLU)
    dx = the pool's 27-term gather of gc against pool(x)

On CUDA tensors each direction runs a kernel of ``csrc/fused_branch3.cu``
(one forward and one backward design; the two functions are two instances
of each, a block covering one frame or a chunk of frames), which keeps the
pooled tensor and ``gc`` out of device memory; the library plans each
launch's tile, chunk and instance from the shape (``plan``, chosen among
``candidates`` by a cost model fitted to ``chip_smoke.py --fused-sweep``,
``cost_terms``). On CPU tensors both run the plain versions below, the
pool's plain versions around a matmul. ``dw`` and ``db`` are plain
PyTorch outside the kernels, as in JAX, from a recomputed pool, and only
when autograd asks for them: the mask search freezes the weights.

bfloat16 (x, w, b all bf16, as I3D hands them over in the bf16 search):
the forward pools exactly in bf16, sums the bf16 products in float32,
adds the bias in float32, applies the ReLU and rounds once to bf16; the
backward runs the float32 computation on the exact float32 values of the
bf16 ``g``, ``w`` and ``x`` (the ReLU mask taken on the bf16 ``y``) and
rounds ``dx`` once; ``dw`` and ``db`` are summed in float32 and cast to
the parameters' dtypes (``ivf_tpu/ops/pallas/fused_branch3.py:57-118,
240-245``). Each kernel has a ``_bf16`` entry with its own launch
counter. While ``torch.export`` traces, the float32 forwards are the
custom ops ``ivf_tpu_torch::fused_pool_conv{,_tblock}_fwd_f32``
(``custom_ops.py``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ivf_tpu_torch.ops.kernels import build, custom_ops
from ivf_tpu_torch.ops.kernels.maxpool3d import maxpool3d_s1_bwd_plain, maxpool3d_s1_fwd_plain
from ivf_tpu_torch.ops.kernels.pointwise_conv import pointwise_conv_plain


def _relu_mask(y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``g * [y != 0]``: the ReLU's gradient on its saved output."""
    return torch.where(y != 0, g, 0.0)


def fused_pool_conv_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool
) -> torch.Tensor:
    """Plain forward: the pool's plain forward, then the pointwise conv's."""
    cout = w.shape[1]
    pooled = maxpool3d_s1_fwd_plain(x)
    y = pointwise_conv_plain(pooled.reshape(-1, x.shape[-1]), w, b, relu)
    return y.reshape(*x.shape[:-1], cout)


def fused_pool_conv_bwd_plain(
    x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, w: torch.Tensor, relu: bool
) -> torch.Tensor:
    """Plain input gradient: ``gc = (g * [y != 0]) @ w^T``, then the pool's
    plain gather against the recomputed pool, in float32 (bfloat16
    operands are widened exactly and ``dx`` is rounded once)."""
    m = (_relu_mask(y, g) if relu else g).float()
    xf = x.float()
    gc = (m.reshape(-1, w.shape[1]) @ w.float().t().contiguous()).reshape(x.shape)
    return maxpool3d_s1_bwd_plain(xf, maxpool3d_s1_fwd_plain(xf), gc).to(x.dtype)


def _weight_grads(x, y, g, relu):
    """(dw, db) in float32 from a recomputed pool (the JAX package's
    ``_vjp_bwd``); the caller casts them to the parameters' dtypes."""
    ge = (_relu_mask(y, g) if relu else g).float()
    dw = torch.einsum("bthwi,bthwo->io", maxpool3d_s1_fwd_plain(x).float(), ge)
    return dw, ge.sum(dim=(0, 1, 2, 3))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("fused_branch3")
    dims = [ctypes.c_int] * 7  # b, t, h, w, cin, cout, relu
    for variant in ("", "tblock_"):
        for suffix in ("f32", "bf16"):
            fwd = getattr(lib, f"fused_pool_conv_{variant}fwd_{suffix}")
            fwd.argtypes = [ctypes.c_void_p] * 4 + dims + [ctypes.c_void_p]
            fwd.restype = ctypes.c_int
            bwd = getattr(lib, f"fused_pool_conv_{variant}bwd_{suffix}")
            bwd.argtypes = [ctypes.c_void_p] * 5 + dims + [ctypes.c_void_p]
            bwd.restype = ctypes.c_int
    # the plans (tile, chunk, instance) the launches take, and a way to
    # force one (chip_smoke.py --fused-sweep)
    lib.fused_branch3_force_plan.argtypes = [ctypes.c_int] * 7
    lib.fused_branch3_plan.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.fused_branch3_candidates.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int]
    lib.fused_branch3_cost_terms.argtypes = [ctypes.c_int] * 12 + [ctypes.c_void_p]
    for fn in (lib.fused_branch3_force_plan, lib.fused_branch3_plan, lib.fused_branch3_candidates,
               lib.fused_branch3_cost_terms):
        fn.restype = ctypes.c_int
    return lib


def plan(dtype: torch.dtype, tblock: bool, shape, cout: int) -> dict:
    """The plan the kernels take for x of ``shape`` (B, T, H, W, Cin):
    the forward's instance and box (frames, rows, columns), the
    backward's tile and chunk of frames."""
    out = (ctypes.c_int * 7)()
    rc = _lib().fused_branch3_plan(0 if dtype == torch.float32 else 1, int(tblock), *shape, cout, out)
    if rc != 0:
        raise RuntimeError(f"fused_branch3_plan failed with CUDA error {rc}")
    return {"fwd": {"inst": out[0], "box": list(out[1:4])}, "bwd": {"tile": list(out[4:6]), "chunk": out[6]}}


def candidates(dtype: torch.dtype, direction: str, shape, cout: int) -> list:
    """The plans the launches choose from for x of ``shape`` (B, T, H, W,
    Cin): forward (instance, (frames, rows, columns)), backward ((rows,
    columns), chunk); the per-frame entries take those of 1 frame."""
    out = (ctypes.c_int * 512)()
    n = _lib().fused_branch3_candidates(0 if dtype == torch.float32 else 1, int(direction == "bwd"),
                                        *shape[1:], cout, out, 128)
    rows = [tuple(out[4 * k:4 * k + 4]) for k in range(n)]
    if direction == "fwd":
        return [(r[0], r[1:]) for r in rows]
    return [(r[:2], r[2]) for r in rows]


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_cuda_operands(x, w, b=None, *out_like) -> None:
    if x.dim() != 5 or w.dim() != 2 or w.shape[0] != x.shape[-1]:
        raise ValueError(
            f"fused_pool_conv: x {tuple(x.shape)}, w {tuple(w.shape)} are not "
            "(B, T, H, W, Cin), (Cin, Cout)"
        )
    if x.dtype not in _SUFFIX:
        raise TypeError(f"fused_pool_conv: x is {x.dtype}; the kernels take float32 or bfloat16")
    named = [("x", x), ("w", w)] + ([("b", b)] if b is not None else [])
    named += [(f"y/g{k}", t) for k, t in enumerate(out_like)]
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"fused_pool_conv: {name} must be on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"fused_pool_conv: {name} is {t.dtype}; x is {x.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fused_pool_conv: {name} must be contiguous")
    if b is not None and tuple(b.shape) != (w.shape[1],):
        raise ValueError(f"fused_pool_conv: b {tuple(b.shape)} != ({w.shape[1]},)")
    for t in out_like:
        if t.shape != (*x.shape[:-1], w.shape[1]):
            raise ValueError(f"fused_pool_conv: y/g {tuple(t.shape)} is not (B, T, H, W, Cout)")


def _launch_fwd(symbol, dtype, counter, x, w, b, relu):
    _check_cuda_operands(x, w, b)
    if x.dtype != dtype:
        raise TypeError(f"{symbol}: x is {x.dtype}; this entry takes {dtype}")
    y = torch.empty((*x.shape[:-1], w.shape[1]), device=x.device, dtype=dtype)
    if y.numel() == 0:
        return y
    rc = getattr(_lib(), symbol)(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), *x.shape, w.shape[1],
        int(relu), build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")
    counter.launches += 1
    return y


def _launch_bwd(symbol, dtype, counter, x, y, g, w, relu):
    _check_cuda_operands(x, w, None, y, g)
    if x.dtype != dtype:
        raise TypeError(f"{symbol}: x is {x.dtype}; this entry takes {dtype}")
    dx = torch.empty_like(x)
    if x.numel() == 0 or y.numel() == 0:
        return dx.zero_()
    rc = getattr(_lib(), symbol)(
        x.data_ptr(), y.data_ptr(), g.data_ptr(), w.data_ptr(), dx.data_ptr(), *x.shape,
        w.shape[1], int(relu), build.stream(x),
    )
    if rc != 0:
        raise RuntimeError(f"{symbol} launch failed with CUDA error {rc}")
    counter.launches += 1
    return dx


def _entry(direction: str, variant: str, dtype: torch.dtype):
    """The counted launch wrapper of one kernel entry, e.g.
    ``fused_pool_conv_tblock_bwd_bf16``."""
    symbol = f"fused_pool_conv_{variant}{direction}_{_SUFFIX[dtype]}"
    launch = _launch_fwd if direction == "fwd" else _launch_bwd

    def fn(x, *args):
        return launch(symbol, dtype, fn, x, *args)

    bf16 = "_bf16" if dtype == torch.bfloat16 else ""
    fn.__name__ = fn.__qualname__ = f"fused_pool_conv_{variant}{direction}{bf16}_cuda"
    fn.__doc__ = f"Launch ``{symbol}``; counts in ``.launches``."
    fn.launches = 0
    return fn


# fwd: (x, w, b, relu) -> y; bwd: (x, y, g, w, relu) -> dx
fused_pool_conv_fwd_cuda = _entry("fwd", "", torch.float32)
fused_pool_conv_bwd_cuda = _entry("bwd", "", torch.float32)
fused_pool_conv_tblock_fwd_cuda = _entry("fwd", "tblock_", torch.float32)
fused_pool_conv_tblock_bwd_cuda = _entry("bwd", "tblock_", torch.float32)
fused_pool_conv_fwd_bf16_cuda = _entry("fwd", "", torch.bfloat16)
fused_pool_conv_bwd_bf16_cuda = _entry("bwd", "", torch.bfloat16)
fused_pool_conv_tblock_fwd_bf16_cuda = _entry("fwd", "tblock_", torch.bfloat16)
fused_pool_conv_tblock_bwd_bf16_cuda = _entry("bwd", "tblock_", torch.bfloat16)


def _fwd_fake(x, w, b, relu):
    return x.new_empty((*x.shape[:-1], w.shape[1]))


# the float32 forwards as the custom ops ivf_tpu_torch::fused_pool_conv{,_tblock}_fwd_f32
# (custom_ops.py)
fused_pool_conv_fwd_f32_op = custom_ops.define(
    "fused_pool_conv_fwd_f32", fused_pool_conv_plain, fused_pool_conv_fwd_cuda, _fwd_fake
)
fused_pool_conv_tblock_fwd_f32_op = custom_ops.define(
    "fused_pool_conv_tblock_fwd_f32", fused_pool_conv_plain, fused_pool_conv_tblock_fwd_cuda, _fwd_fake
)


def _function(name: str, kernels, op):
    """The autograd Function of one variant: ``kernels[dtype]`` = (fwd,
    bwd) launch wrappers on CUDA tensors, the plain versions on CPU
    tensors, no other device; the float32 forward through ``op`` while
    ``torch.export`` traces."""

    def route(x, direction, plain_fn, *args):
        if direction == 0 and custom_ops.through_op(name, x):
            return op(x, *args)
        if x.is_cuda:
            if x.dtype not in kernels:
                raise TypeError(f"{name}: no kernel for {x.dtype}")
            return kernels[x.dtype][direction](x, *args)
        if x.device.type == "cpu":
            return plain_fn(x, *args)
        raise RuntimeError(f"{name}: no kernel for device {x.device}")

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, b, relu):
            y = route(x, 0, fused_pool_conv_plain, w, b, relu)
            ctx.relu = relu
            ctx.b_dtype = b.dtype
            ctx.save_for_backward(x, y, w)
            return y

        @staticmethod
        def backward(ctx, g):
            x, y, w = ctx.saved_tensors
            g = g.contiguous()
            dx = dw = db = None
            if ctx.needs_input_grad[0]:
                dx = route(x, 1, fused_pool_conv_bwd_plain, y, g, w, ctx.relu)
            if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
                dw, db = _weight_grads(x, y, g, ctx.relu)
                dw = dw.to(w.dtype) if ctx.needs_input_grad[1] else None
                db = db.to(ctx.b_dtype) if ctx.needs_input_grad[2] else None
            return dx, dw, db, None

    Fn.__name__ = Fn.__qualname__ = name
    return Fn


_FusedPoolConv = _function(
    "fused_pool_conv",
    {
        torch.float32: (fused_pool_conv_fwd_cuda, fused_pool_conv_bwd_cuda),
        torch.bfloat16: (fused_pool_conv_fwd_bf16_cuda, fused_pool_conv_bwd_bf16_cuda),
    },
    fused_pool_conv_fwd_f32_op,
)
_FusedPoolConvTBlock = _function(
    "fused_pool_conv_tblock",
    {
        torch.float32: (fused_pool_conv_tblock_fwd_cuda, fused_pool_conv_tblock_bwd_cuda),
        torch.bfloat16: (fused_pool_conv_tblock_fwd_bf16_cuda, fused_pool_conv_tblock_bwd_bf16_cuda),
    },
    fused_pool_conv_tblock_fwd_f32_op,
)


def fused_pool_conv(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """maxpool 3x3x3 (stride 1, zero-padded SAME) -> 1x1x1 conv -> bias
    [-> ReLU], per-frame kernels. x: (B, T, H, W, Cin); w: (Cin, Cout);
    b: (Cout,). Differentiable in all three (every-tie pool rule)."""
    return _FusedPoolConv.apply(x.contiguous(), w.contiguous(), b.contiguous(), relu)


def fused_pool_conv_tblock(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True
) -> torch.Tensor:
    """The same function as ``fused_pool_conv``, with the whole-sample
    kernels (each x voxel read about once per direction)."""
    return _FusedPoolConvTBlock.apply(x.contiguous(), w.contiguous(), b.contiguous(), relu)


def cost_terms(dtype: torch.dtype, direction: str, shape, cout: int, plan) -> list:
    """The terms of the planner's cost model for one plan (a ``candidates``
    entry): its cost is their dot product with the constants of
    ``csrc/fused_branch3.cu``. Empty if the plan does not fit."""
    flat = [plan[0], *plan[1]] if direction == "fwd" else [*plan[0], plan[1], 0]
    out = (ctypes.c_double * 6)()
    n = _lib().fused_branch3_cost_terms(0 if dtype == torch.float32 else 1, int(direction == "bwd"), *shape,
                                        cout, *flat, out)
    return list(out[:n])
