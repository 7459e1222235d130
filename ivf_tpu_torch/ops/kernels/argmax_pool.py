"""3x3x3 stride-1 zero-padded SAME max pool with the argmax-index backward,
bfloat16.

Port of ``ivf_tpu/ops/conv.py::_max_pool3d_same_argmax`` (``_monotone_u16``,
``_window_key``, ``_argmax_pool_core``, ``_argmax_bwd``), the branch-3 pool
of the bfloat16 mask search (``pool_impl='argmax'``). On CUDA tensors both
directions run in ``csrc/argmax_pool.cu``; on CPU tensors in the plain
versions below.

The kernels tile the volume: a block takes all frames of one sample, a
tile of positions and a chunk of channels, stages each frame of the tile
with its halo in shared memory and walks the frames in order
(the forward keeps the last frames' (H, W) maxima in registers, the
backward three accumulators, so each input adds its 27 terms in key
order). ``plan`` picks the tile from the shape: 8 channels a thread where
C % 8 == 0 and the pointers are aligned, else the ragged instance, 1
channel a thread, with the same bits.

The forward maximises a packed word per position: the 16 value bits mapped
to an order-preserving unsigned key, shifted left by 5, or'ed with the
position's window key ``(t % 3) * 9 + (h % 3) * 3 + w % 3`` in padded
coordinates (distinct inside any 3-wide window). That is 21 bits, so an
``int32`` holds it. The maximum's high bits give y, its low 5 bits a
``uint8`` index plane, the only residual of the backward:

    dx[i] = sum over the windows j covering i, in key order (kt, kh, kw),
            of g[j] * (idx[j] == key(i))

Each window sends its whole cotangent to one element, the largest key among
tied maxima: ``F.max_pool3d`` picks the first maximum and the Pallas pool
credits all of them. The three agree where window maxima are unique.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ivf_tpu_torch.ops.kernels import build, custom_ops

_PAD = (0, 0, 1, 1, 1, 1, 1, 1)  # zero halo of one voxel on T, H, W
_NBITS = 5  # bits of a window key: 27 positions


def _monotone(bits: torch.Tensor) -> torch.Tensor:
    """Order-preserving map of 16-bit float bits (int32 in [0, 65535]) to
    an unsigned key: positives above negatives, both monotone."""
    return torch.where(bits >> 15 == 0, bits | 0x8000, ~bits & 0xFFFF)


def _from_monotone(u: torch.Tensor) -> torch.Tensor:
    bits = torch.where(u >> 15 == 1, u & 0x7FFF, ~u & 0xFFFF)
    return torch.where(bits >= 0x8000, bits - 0x10000, bits).to(torch.int16)


def _window_key(t: int, h: int, w: int, offset: int, device, window=(3, 3, 3)) -> torch.Tensor:
    """(1, t, h, w, 1) int32 key of each position inside any window of
    shape ``window`` (the w consecutive coordinates of an axis are
    distinct mod w), its coordinates shifted by ``offset`` (1 puts an
    unpadded input in padded coordinates)."""
    wt, wh, ww = window
    kt, kh, kw = (
        (torch.arange(n, device=device, dtype=torch.int32) + offset) % k
        for n, k in zip((t, h, w), window)
    )
    key = kt[:, None, None] * (wh * ww) + kh[None, :, None] * ww + kw[None, None, :]
    return key[None, ..., None]


def argmax_pool_fwd_plain(x: torch.Tensor):
    """Plain forward: (y, idx) for bfloat16 x (B, T, H, W, C); idx uint8."""
    _, t, h, w, _ = x.shape
    xp = F.pad(x, _PAD)
    bits = xp.view(torch.int16).to(torch.int32) & 0xFFFF
    packed = (_monotone(bits) << _NBITS) | _window_key(t + 2, h + 2, w + 2, 0, x.device)
    best = packed.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1).amax(dim=(-3, -2, -1))
    y = _from_monotone(best >> _NBITS).view(torch.bfloat16)
    return y.contiguous(), (best & 31).to(torch.uint8).contiguous()


def argmax_pool_bwd_plain(idx: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain backward: the covering windows' cotangents whose index equals
    the input's key, added in key order and rounded to g's dtype after
    every add, as the reference does."""
    _, t, h, w, _ = g.shape
    gp = F.pad(g, _PAD)
    ip = F.pad(idx, _PAD, value=255)  # 255 is no key
    key = _window_key(t, h, w, 1, g.device).to(torch.uint8)
    dx = torch.zeros_like(g)
    for kt in range(3):
        for kh in range(3):
            for kw in range(3):
                gs = gp[:, kt : kt + t, kh : kh + h, kw : kw + w]
                sel = ip[:, kt : kt + t, kh : kh + h, kw : kw + w]
                dx = dx + gs * (sel == key).to(g.dtype)
    return dx


# kMaxThreads and kStageSlots of csrc/argmax_pool.cu and csrc/maxpool3d.cu
MAX_THREADS = 224
STAGE_SLOTS = 2  # halo vectors a thread stages per frame, at most


class Plan(NamedTuple):
    """A launch of the staged pool kernels (this pair and the
    ``maxpool3d_s1`` pair): ``vw`` channels a thread (one 16-byte vector,
    or 1: the ragged instance), ``v`` vectors and ``th`` x ``tw``
    positions of one sample's frames a block, ``threads`` threads a
    block."""

    vw: int
    v: int
    th: int
    tw: int
    threads: int


def _round32(n: int) -> int:
    return -(-n // 32) * 32


def tile_plan(vw: int, v: int, th: int, tw: int) -> Plan:
    """The launch of a (th x tw positions, v vectors of vw channels) tile
    with the fewest threads the kernels take for it: one a computed
    (position, vector), and at most ``STAGE_SLOTS`` halo vectors each."""
    nhv = (th + 2) * (tw + 2) * v
    return Plan(vw, v, th, tw, max(_round32(th * tw * v), _round32(math.ceil(nhv / STAGE_SLOTS))))


def best_tile(h: int, w: int, v: int, positions: int) -> tuple:
    """The (th, tw) tile of at most ``positions`` positions of an h x w
    frame that stages and computes the fewest positions per frame (halo
    and ragged edges counted, a computed position twice a staged one) and
    whose halo of v vectors a block's threads can stage."""
    best = None
    for th in range(1, min(h, positions) + 1):
        for tw in range(1, min(w, positions // th) + 1):
            if (th + 2) * (tw + 2) * v > STAGE_SLOTS * MAX_THREADS:
                continue
            tiles = math.ceil(h / th) * math.ceil(w / tw)
            cost = tiles * ((th + 2) * (tw + 2) + 2 * th * tw)
            if best is None or (cost, tiles) < best[0]:
                best = ((cost, tiles), th, tw)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, c: int, vec: bool = True, wide: int = 8) -> Plan:
    """The tile for frames of h x w positions and c channels (every block
    walks a whole sample's frames); ``vec``: the operands allow 16-byte
    vectors of ``wide`` channels (8 bfloat16, 4 float32 in
    ``maxpool3d.plan``), used where C % wide == 0. Channel chunks of 4-8
    vectors that divide C where one does (up to 32 channels in the ragged
    instance); the ``best_tile`` of at most ``MAX_THREADS // v``
    positions."""
    vw = wide if vec and c % wide == 0 else 1
    nv = c // vw
    if vw > 1:
        v = next((d for d in (8, 7, 6, 5, 4) if nv % d == 0), min(nv, 8))
    else:
        v = min(nv, 32)
    return tile_plan(vw, v, *best_tile(h, w, v, max(1, MAX_THREADS // v)))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.library("argmax_pool")
    dims = [ctypes.c_int] * 10  # b, t, h, w, c, then the plan
    for fn in (lib.argmax_pool_fwd_bf16, lib.argmax_pool_bwd_bf16):
        fn.argtypes = [ctypes.c_void_p] * 3 + dims + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(x: torch.Tensor, *others) -> None:
    if x.dim() != 5:
        raise ValueError(f"argmax_pool: expected (B, T, H, W, C), got {tuple(x.shape)}")
    for t, dtype in ((x, torch.bfloat16), *others):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"argmax_pool: operands must be on {x.device}")
        if t.dtype != dtype:
            raise TypeError(f"argmax_pool: {t.dtype} operand; the kernel takes {dtype}")
        if t.shape != x.shape:
            raise ValueError(f"argmax_pool: shape {tuple(t.shape)} != {tuple(x.shape)}")
        if not t.is_contiguous():
            raise ValueError("argmax_pool: operands must be contiguous (B, T, H, W, C)")


def _plan_for(shape, ptrs, given):
    """``given``, or the plan for ``shape`` with 16-byte vectors where every
    (pointer, alignment) of ``ptrs`` allows them."""
    if given is not None:
        return Plan(*given)
    return plan(*shape[2:], vec=all(p % a == 0 for p, a in ptrs))


def argmax_pool_fwd_cuda(x: torch.Tensor, tile: Plan = None):
    """Launch the forward kernel on bfloat16 x; returns (y, idx). ``tile``
    overrides the plan (the tests force each instance). Counts in
    ``argmax_pool_fwd_cuda.launches``."""
    _check_cuda_operands(x)
    y = torch.empty_like(x)
    idx = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    if x.numel() == 0:
        return y, idx
    p = _plan_for(x.shape, ((x.data_ptr(), 16), (y.data_ptr(), 16), (idx.data_ptr(), 8)), tile)
    rc = _lib().argmax_pool_fwd_bf16(x.data_ptr(), y.data_ptr(), idx.data_ptr(), *x.shape, *p, build.stream(x))
    if rc != 0:
        raise RuntimeError(f"argmax_pool_fwd_bf16 launch failed with CUDA error {rc} ({p})")
    argmax_pool_fwd_cuda.launches += 1
    return y, idx


def argmax_pool_bwd_cuda(idx: torch.Tensor, g: torch.Tensor, tile: Plan = None) -> torch.Tensor:
    """Launch the backward kernel; ``tile`` as for the forward. Counts in
    ``argmax_pool_bwd_cuda.launches``."""
    _check_cuda_operands(g, (idx, torch.uint8))
    dx = torch.empty_like(g)
    if g.numel() == 0:
        return dx
    p = _plan_for(g.shape, ((g.data_ptr(), 16), (dx.data_ptr(), 16), (idx.data_ptr(), 8)), tile)
    rc = _lib().argmax_pool_bwd_bf16(idx.data_ptr(), g.data_ptr(), dx.data_ptr(), *g.shape, *p, build.stream(g))
    if rc != 0:
        raise RuntimeError(f"argmax_pool_bwd_bf16 launch failed with CUDA error {rc} ({p})")
    argmax_pool_bwd_cuda.launches += 1
    return dx


argmax_pool_fwd_cuda.launches = 0
argmax_pool_bwd_cuda.launches = 0


def _on_device(t: torch.Tensor, cuda_fn, plain_fn, *args):
    custom_ops.refuse_export("argmax_pool", t.dtype)
    if t.is_cuda:
        return cuda_fn(*args)
    if t.device.type == "cpu":
        return plain_fn(*args)
    raise RuntimeError(f"argmax_pool: no kernel for device {t.device}")


class _ArgmaxPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y, idx = _on_device(x, argmax_pool_fwd_cuda, argmax_pool_fwd_plain, x)
        ctx.save_for_backward(idx)
        return y

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        g = g.contiguous()
        return _on_device(g, argmax_pool_bwd_cuda, argmax_pool_bwd_plain, idx, g)


def argmax_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 stride-1 zero-padded SAME max pool over contiguous bfloat16
    (B, T, H, W, C); differentiable with the argmax-index backward."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"argmax_pool: {x.dtype} input; the pool takes bfloat16")
    return _ArgmaxPool.apply(x.contiguous())
