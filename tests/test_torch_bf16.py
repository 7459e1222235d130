"""bfloat16 in ivf_tpu_torch against the JAX package at bfloat16, and the
exact-float32 pin of the port's entry points.

* The argmax-index pool's plain version against ``ivf_tpu/ops/conv.py``'s
  ``_max_pool3d_same_argmax`` (forward and VJP), bit for bit, on data with
  tied maxima, negative plateaus (where a zero-pad cell wins) and borders.
* The bfloat16 plain versions of ``pointwise_conv`` and ``maxpool3d_s1``
  against the Pallas functions in interpret mode.
* I3D logits and input gradient in bfloat16 on four routes (the default,
  which becomes ``pool_impl='argmax'``; ``use_pallas`` + ``pallas_pool``;
  ``use_pallas`` + ``fuse_pool_conv`` per frame and ``'tblock'``) and
  ``find_masks`` on 8x32x32 clips, against the JAX package.
* The bf16 upgrade rule, every pool impl in bfloat16 against JAX's, and
  that ``find_masks`` leaves the caller's TF32 flags as it found them.

Inputs are drawn with numpy. Each tolerance names the gap measured here.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.ops.conv import _argmax_pool_core, _max_pool3d_same_argmax
from ivf_tpu.ops.pallas.maxpool3d import pallas_maxpool3d_s1
from ivf_tpu.ops.pallas.pointwise_conv import pallas_pointwise_conv
import ivf_tpu_torch.api as tapi
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.models import i3d_smth as t_i3d_smth
from ivf_tpu_torch.ops.kernels import argmax_pool as tap
from ivf_tpu_torch.ops.kernels import maxpool3d as tpool
from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict

SHAPE = (1, 8, 32, 32, 3)
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
ROUTES = {
    "default": {},
    "kernels": dict(use_pallas=True, pallas_pool=True),
    "fused": dict(use_pallas=True, fuse_pool_conv=True),
    "tblock": dict(use_pallas=True, fuse_pool_conv="tblock"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(a) -> np.ndarray:
    """The 16-bit patterns of a bfloat16 JAX array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _t32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).bfloat16()


def _tie_data(shape, seed):
    """Halves in [-2, 2]: tied maxima everywhere, and channel 1 a negative
    plateau, so the zero pad wins the border windows there."""
    x = np.round(np.random.RandomState(seed).randn(*shape) * 2).clip(-4, 4) / 2
    if shape[-1] > 1:
        x[..., 1] = -1.5
    x[0, 0, 0, 0, 0] = -0.0
    return x.astype(np.float32)


def _jax_argmax(x, g):
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    y, vjp = jax.vjp(lambda a: _max_pool3d_same_argmax(a, (3, 3, 3), (1, 1, 1)), xb)
    (dx,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    _, idx = _argmax_pool_core(xb, (3, 3, 3), (1, 1, 1))
    return y, np.asarray(idx), dx


# edge shapes of the argmax pool: T, H or W of 1 and 2, C of 1 and 9
ARGMAX_EDGE_SHAPES = [(2, 1, 3, 4, 1), (1, 2, 5, 2, 9), (1, 3, 1, 2, 9), (2, 2, 2, 2, 1), (1, 1, 1, 1, 9),
                      (1, 2, 1, 1, 1)]


@pytest.mark.parametrize("shape", [(2, 4, 6, 6, 8), (1, 3, 5, 7, 3)] + ARGMAX_EDGE_SHAPES)
def test_argmax_pool_plain_forward_is_bit_equal_to_jax(shape):
    """y and the uint8 index plane: equal bits (0 of any element differ)."""
    x = _tie_data(shape, 0)
    y_ref, idx_ref, _ = _jax_argmax(x, np.ones(shape, np.float32))
    y, idx = tap.argmax_pool_fwd_plain(_bf16(x))
    np.testing.assert_array_equal(_bits(y), _bits(y_ref))
    np.testing.assert_array_equal(idx.numpy(), idx_ref)


@pytest.mark.parametrize("shape", [(2, 4, 6, 6, 8), (1, 3, 5, 7, 3)] + ARGMAX_EDGE_SHAPES)
def test_argmax_pool_plain_backward_is_bit_equal_to_jax(shape):
    """dx through the autograd wrapper: equal bits (the key-order sum,
    rounded to bfloat16 after every add as XLA's bfloat16 adds are)."""
    x = _tie_data(shape, 1)
    g = (np.random.RandomState(2).randn(*shape) * 3.3).astype(np.float32)
    _, _, dx_ref = _jax_argmax(x, g)
    xt = _bf16(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tap.argmax_pool(xt), xt, _bf16(g))
    np.testing.assert_array_equal(_bits(dx), _bits(dx_ref))


@pytest.mark.parametrize("shape", [(1, 3, 4, 5, 2), (2, 2, 3, 1, 9)])
def test_argmax_pool_plain_backward_nan_and_inf_cotangents_match_jax(shape):
    """An inf and a NaN in the cotangent: the same elements come out NaN in
    both packages (an unselected inf or NaN times the 0.0 mask is NaN), and
    the others keep equal bits."""
    x = _tie_data(shape, 4)
    g = (np.random.RandomState(5).randn(*shape) * 3.3).astype(np.float32)
    g[0, 1, 2, 0, 0] = np.inf
    g[0, 0, 1, 0, 1] = np.nan
    _, _, dx_ref = _jax_argmax(x, g)
    xt = _bf16(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tap.argmax_pool(xt), xt, _bf16(g))
    nan = torch.isnan(dx.float()).numpy()
    np.testing.assert_array_equal(nan, np.isnan(np.asarray(dx_ref, np.float32)))
    assert nan.sum() > 1
    np.testing.assert_array_equal(_bits(dx)[~nan], _bits(dx_ref)[~nan])


def test_xla_cpu_flushes_subnormal_cotangents_the_port_keeps_them():
    """Known divergence, not a port fault: XLA's CPU backend flushes
    subnormals to zero (float32 and bfloat16), so JAX's argmax VJP maps a
    cotangent of all 1e-39 to a dx of all 0; the port's plain version adds
    the subnormal and keeps it, and the CUDA kernels are held to the plain
    version (tests/test_torch_gpu.py). This test asserts the gap itself."""
    shape = (1, 3, 4, 5, 2)
    x = _tie_data(shape, 6)
    g = np.full(shape, 1e-39, np.float32)
    _, _, dx_ref = _jax_argmax(x, g)
    assert not np.asarray(dx_ref, np.float32).any()
    xt = _bf16(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tap.argmax_pool(xt), xt, _bf16(g))
    sub = float(_bf16(g).flatten()[0])
    assert 0 < sub < float(torch.finfo(torch.bfloat16).tiny)
    assert dx.float().max().item() >= sub and dx.float().min().item() >= 0


ARGMAX_PLAN_SHAPES = {
    **{f"{site}_b{b}": (b, *shape) for b in (4, 128) for site, shape in (
        ("Mixed_3b", (8, 28, 28, 192)), ("Mixed_3c", (8, 28, 28, 256)), ("Mixed_4b", (4, 14, 14, 480)),
        ("Mixed_4c", (4, 14, 14, 512)), ("Mixed_4f", (4, 14, 14, 528)), ("Mixed_5b", (2, 7, 7, 832)))},
    "c1": (2, 3, 5, 7, 1), "c3": (1, 3, 5, 7, 3), "c17": (1, 3, 9, 10, 17), "c1001": (1, 2, 64, 1, 1001),
    "thw1": (3, 1, 1, 1, 24), "w_strip": (3, 5, 1, 64, 8), "tall": (1, 2, 300, 3, 16),
}


@pytest.mark.parametrize("vec", [True, False], ids=["vec", "unaligned"])
@pytest.mark.parametrize("shape", list(ARGMAX_PLAN_SHAPES.values()), ids=list(ARGMAX_PLAN_SHAPES))
def test_argmax_plan_fits_the_kernels(shape, vec):
    """The tile plan (CPU only): what plan_launch (csrc/staged_pool.cuh)
    accepts (thread count a multiple of 32, at most MAX_THREADS, one
    thread per computed (position, vector), at most STAGE_SLOTS halo
    vectors a thread), 8 channels a thread exactly where C % 8 == 0 and the
    operands are aligned, and whole chunks of 4-8 vectors at every
    main-path width."""
    _, _, h, w, c = shape
    p = tap.plan(h, w, c, vec=vec)
    assert p.vw == (8 if vec and c % 8 == 0 else 1)
    nv = c // p.vw
    assert 1 <= p.v <= nv and p.th <= h and p.tw <= w
    assert p.threads % 32 == 0 and p.th * p.tw * p.v <= p.threads <= tap.MAX_THREADS
    assert (p.th + 2) * (p.tw + 2) * p.v <= tap.STAGE_SLOTS * p.threads
    if vec and c in (192, 256, 480, 512, 528, 832):
        assert nv % p.v == 0 and 4 <= p.v <= 8


def test_argmax_backward_keeps_the_gradients_mass_on_plateaus():
    """Each window hands its whole cotangent to one tied element (the
    largest key), so on an all-equal positive input the input gradient
    sums to the output gradient's sum, where the every-tie gather of the
    Pallas pool gives up to 27 times a window's share; small integers keep
    every bfloat16 sum exact."""
    shape = (1, 3, 4, 5, 2)
    x = np.ones(shape, np.float32)
    g = np.random.RandomState(3).randint(1, 4, shape).astype(np.float32)
    _, _, dx_ref = _jax_argmax(x, g)
    xt = _bf16(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tap.argmax_pool(xt), xt, _bf16(g))
    np.testing.assert_array_equal(_bits(dx), _bits(dx_ref))
    assert dx.float().sum().item() == g.sum()
    every_tie = tpool.maxpool3d_s1_bwd_bf16_plain(_bf16(x), _bf16(x), _bf16(g))
    assert every_tie.float().sum().item() > 3 * g.sum()


@pytest.mark.parametrize("relu,use_bias", [(True, True), (False, False)], ids=["relu_bias", "linear"])
def test_bf16_pointwise_plain_matches_pallas(relu, use_bias):
    """bf16 operands, float32 sums, one rounding: forward and dx against the
    Pallas kernel in interpret mode at the ragged (2,3,5,5,112)->48, within
    one bfloat16 ulp of the largest output (2**-7 of it; the float32 sums
    differ in order only, and 0 elements differed here)."""
    rng = np.random.RandomState(6)
    x = np.maximum(rng.randn(2, 3, 5, 5, 112), 0).astype(np.float32)
    w = (rng.randn(112, 48) / 10).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    g = rng.randn(2, 3, 5, 5, 48).astype(np.float32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    bias = jb(b) if use_bias else None
    y_ref, vjp = jax.vjp(
        lambda a: pallas_pointwise_conv(a, jb(w), bias, relu=relu, interpret=True), jb(x)
    )
    (dx_ref,) = vjp(jb(g))
    xt = _bf16(x).requires_grad_(True)
    y = tpw.pointwise_conv(xt, _bf16(w), _bf16(b) if use_bias else None, relu=relu)
    (dx,) = torch.autograd.grad(y, xt, _bf16(g))
    assert y.dtype == dx.dtype == torch.bfloat16
    for got, want in ((y, y_ref), (dx, dx_ref)):
        want = np.asarray(want, np.float32)
        tol = 2.0**-7 * np.abs(want).max()
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol)


# The bf16 pointwise GEMMs of I3D's main path at batch 4 (site, N, Cin,
# Cout), the forward's W being the layers' column-major view of the
# (Cout, Cin) weight, and the plan each forward and dx launch must get on
# the H100's 132 SMs: (bn, col_tiles) of the TMA path (narrow tiles where
# few rows meet a long K), or the split-K (splits, vec).
PW_MAIN_PATH = [
    ("Conv3d_2b", 100352, 64, 64, (64, 1), (64, 1)),
    ("Mixed_3b_trio", 25088, 192, 176, (96, 2), (96, 2)),
    ("Mixed_3b_b3b", 25088, 192, 32, (32, 1), (96, 2)),
    ("Mixed_3c_trio", 25088, 256, 288, (160, 2), (128, 2)),
    ("Mixed_3c_b3b", 25088, 256, 64, (64, 1), (128, 2)),
    ("Mixed_4b_trio", 3136, 480, 304, (64, 5), (96, 5)),
    ("Mixed_4b_b3b", 3136, 480, 64, (32, 2), (96, 5)),
    ("Mixed_4c_trio", 3136, 512, 296, (64, 5), (128, 4)),
    ("Mixed_4d_trio", 3136, 512, 280, (64, 5), (128, 4)),
    ("Mixed_4e_trio", 3136, 512, 288, (64, 5), (128, 4)),
    ("Mixed_4cde_b3b", 3136, 512, 64, (32, 2), (128, 4)),
    ("Mixed_4f_trio", 3136, 528, 448, (96, 5), (128, 5)),
    ("Mixed_4f_b3b", 3136, 528, 128, (32, 4), (128, 5)),
    ("Mixed_5b_trio", 392, 832, 448, (32, 14), (32, 26)),
    ("Mixed_5c_trio", 392, 832, 624, (32, 20), (32, 26)),
    ("Mixed_5bc_b3b", 392, 832, 128, (32, 4), (32, 26)),
    ("logits", 4, 1024, 174, (64, True), (11, False)),
]
_BASE = 1 << 20  # a 16-byte-aligned address


@pytest.mark.parametrize("site,n,cin,cout,fwd,dx", PW_MAIN_PATH, ids=[r[0] for r in PW_MAIN_PATH])
def test_bf16_plan_at_every_main_path_shape(site, n, cin, cout, fwd, dx):
    """The bf16 wrapper's choice of kernel is a plain function of shapes,
    strides and addresses: every trunk GEMM, forward (W K-major, the view
    of the (Cout, Cin) weight) and dx (W^T MN-major), takes the TMA path;
    the logits head (N = batch) the split-K pair."""
    plan_fwd = tpw.bf16_plan(n, cin, cout, (cin, 1), _BASE, (1, cin), _BASE)
    plan_dx = tpw.bf16_plan(n, cout, cin, (cout, 1), _BASE, (cin, 1), _BASE)
    for plan, want, mn, k, c in ((plan_fwd, fwd, False, cin, cout), (plan_dx, dx, True, cout, cin)):
        if site == "logits":
            assert plan["path"] == "splitk"
            assert (plan["splits"], plan["vec"]) == want
            assert plan["chunk"] % 8 == 0 and (plan["splits"] - 1) * plan["chunk"] < k <= plan["splits"] * plan["chunk"]
        else:
            assert plan == {"path": "tma", "bn": want[0], "col_tiles": want[1], "w_mn_major": mn}
            assert want[0] * (want[1] - 1) < c <= want[0] * want[1]
            # at bench.py's 128 clips every tile count fills the card: wide
            # tiles, X read fewer times
            assert tpw.tma_width(32 * n, k, c) >= want[0]


@pytest.mark.parametrize(
    "n,cin,cout,x_stride,x_ptr,w_stride,w_ptr,path",
    [
        (64, 64, 64, (64, 1), _BASE, (64, 1), _BASE, "tma"),  # W (Cin, Cout) row-major
        (63, 64, 64, (64, 1), _BASE, (64, 1), _BASE, "splitk"),  # N < 64
        (1, 64, 64, (64, 1), _BASE, (1, 64), _BASE, "splitk"),
        (200, 64, 64, (64, 1), _BASE + 2, (1, 64), _BASE, "splitk"),  # X base not 16-byte aligned
        (200, 64, 64, (64, 1), _BASE, (1, 64), _BASE + 8, "splitk"),  # W base not aligned
        (1000, 174, 64, (174, 1), _BASE, (1, 174), _BASE, "splitk"),  # Cin = 174: 348-byte rows
        (1000, 64, 174, (64, 1), _BASE, (1, 64), _BASE, "splitk"),  # Cout = 174
        (1000, 64, 64, (1, 1000), _BASE, (1, 64), _BASE, "splitk"),  # X column-major
        (1000, 64, 64, (128, 1), _BASE, (1, 72), _BASE, "tma"),  # padded row strides
    ],
    ids=["w_row_major", "n63", "n1", "x_unaligned", "w_unaligned", "cin174", "cout174", "x_colmajor",
         "padded_strides"],
)
def test_bf16_plan_routes_unaligned_and_small_shapes_to_split_k(
        n, cin, cout, x_stride, x_ptr, w_stride, w_ptr, path):
    plan = tpw.bf16_plan(n, cin, cout, x_stride, x_ptr, w_stride, w_ptr)
    assert plan["path"] == path
    if path == "splitk":
        assert plan["chunk"] % 8 == 0 and plan["splits"] * plan["chunk"] >= cin
        assert (plan["splits"] - 1) * plan["chunk"] < cin
        assert plan["vec"] == (cin % 8 == 0 and x_stride[1] == 1 and w_stride[0] == 1
                               and x_ptr % 16 == 0 and w_ptr % 16 == 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_pointwise_cpu_path_gives_the_same_bits_with_a_column_major_weight(dtype, relu):
    """The layers pass W as the column-major view of the (Cout, Cin)
    weight: the CPU path's forward and dx give the bits of a contiguous W."""
    rng = np.random.RandomState(8)
    x = _t32(np.maximum(rng.randn(2, 3, 5, 5, 112), 0)).to(dtype)
    wk = _t32(rng.randn(48, 112) / 10).to(dtype)  # (Cout, Cin), as a conv weight
    b = _t32(rng.randn(48)).to(dtype)
    g = _t32(rng.randn(2, 3, 5, 5, 48)).to(dtype)
    outs = []
    for w in (wk.t(), wk.t().contiguous()):
        xt = x.clone().requires_grad_(True)
        y = tpw.pointwise_conv(xt, w, b, relu=relu)
        (dx,) = torch.autograd.grad(y, xt, g)
        outs.append((y.detach(), dx))
    assert not outs[0][0].equal(torch.zeros_like(outs[0][0]))
    for a, c in zip(*outs):
        assert torch.equal(a.view(torch.int16) if dtype == torch.bfloat16 else a,
                           c.view(torch.int16) if dtype == torch.bfloat16 else c)


@pytest.mark.parametrize("relu,use_bias", [(True, True), (False, False)], ids=["relu_bias", "linear"])
def test_bf16_pointwise_vjp_with_a_column_major_weight_matches_pallas(relu, use_bias):
    """The bf16 VJP with W as the layers pass it (the (Cout, Cin) weight's
    column-major view; dx launches on its transpose, (Cout, Cin) row-major)
    against the Pallas kernel in interpret mode: forward and dx within one
    bfloat16 ulp of the largest value, as the contiguous-W test."""
    rng = np.random.RandomState(9)
    x = np.maximum(rng.randn(2, 3, 5, 5, 112), 0).astype(np.float32)
    wk = (rng.randn(48, 112) / 10).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    g = rng.randn(2, 3, 5, 5, 48).astype(np.float32)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    bias = jb(b) if use_bias else None
    y_ref, vjp = jax.vjp(
        lambda a: pallas_pointwise_conv(a, jb(wk.T), bias, relu=relu, interpret=True), jb(x)
    )
    (dx_ref,) = vjp(jb(g))
    xt = _bf16(x).requires_grad_(True)
    y = tpw.pointwise_conv(xt, _bf16(wk).t(), _bf16(b) if use_bias else None, relu=relu)
    (dx,) = torch.autograd.grad(y, xt, _bf16(g))
    for got, want in ((y, y_ref), (dx, dx_ref)):
        want = np.asarray(want, np.float32)
        tol = 2.0**-7 * np.abs(want).max()
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 2, 3, 3, 130)])
def test_bf16_maxpool_plain_matches_pallas(shape):
    """Forward and backward: equal bits with the Pallas pool in interpret
    mode (the backward in its bfloat16 frame order and rounding)."""
    x = np.maximum(np.round(np.random.RandomState(4).randn(*shape) * 2) / 2, 0)
    g = np.random.RandomState(5).randn(*shape)
    y_ref, vjp = jax.vjp(pallas_maxpool3d_s1, jnp.asarray(x, jnp.float32).astype(jnp.bfloat16))
    (dx_ref,) = vjp(jnp.asarray(g, jnp.float32).astype(jnp.bfloat16))
    xt = _bf16(x).requires_grad_(True)
    y = tpool.maxpool3d_s1(xt)
    (dx,) = torch.autograd.grad(y, xt, _bf16(g))
    np.testing.assert_array_equal(_bits(y), _bits(y_ref))
    np.testing.assert_array_equal(_bits(dx), _bits(dx_ref))


def _jax_variables(model, seed=0, logit_scale=0.005):
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(SHAPE))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            k = rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            if any(getattr(p, "key", None) == "logits" for p in path):
                k = k * logit_scale
            return k.astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _to_bf16(variables):
    """The JAX package's cast (ivf_tpu/api.py:669-675): every float32 leaf."""
    return jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), variables)


@pytest.fixture(scope="module")
def weights():
    variables = _jax_variables(j_i3d_smth(**SMALL, dropout_rate=0.0))
    return variables, i3d_variables_to_state_dict(variables)


def _bf16_errors(weights, flags, model=None):
    """(logit error over the largest logit, input-gradient error in
    relative L2) of the port's bfloat16 I3D (``model``, or built with
    ``flags``) against the JAX model with ``flags`` at bfloat16."""
    variables, sd = weights
    x = np.random.RandomState(1).uniform(0, 255, SHAPE).astype(np.float32)
    r = np.random.RandomState(2).randn(5).astype(np.float32)
    jmodel = j_i3d_smth(**SMALL, dropout_rate=0.0, **flags)

    def score(v, a):
        logits = jmodel.apply(v, a).astype(jnp.float32)
        return (logits[0] * r).sum(), logits

    (_, want_logits), want_grad = jax.jit(jax.value_and_grad(score, argnums=1, has_aux=True))(
        _to_bf16(variables), jnp.asarray(x)
    )
    if model is None:
        model = t_i3d_smth(**SMALL, **flags)
    model.load_state_dict(sd)
    model = model.to(torch.bfloat16).eval().requires_grad_(False)
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    assert logits.dtype == torch.bfloat16
    (grad,) = torch.autograd.grad(logits.float(), xt, torch.from_numpy(r)[None])
    assert grad.dtype == torch.float32
    want_logits = np.asarray(want_logits)
    want_grad = np.asarray(want_grad, np.float32)
    logit_err = np.abs(logits.float().detach().numpy() - want_logits).max() / np.abs(want_logits).max()
    grad_err = np.linalg.norm(grad.numpy() - want_grad) / np.linalg.norm(want_grad)
    return logit_err, grad_err


@pytest.mark.parametrize("route", list(ROUTES))
def test_i3d_bf16_logits_and_input_gradient_match_jax(weights, route):
    """Logits within 1e-2 of the largest logit (the JAX package's own bf16
    bound against torch, scripts/tpu_parity_check.py:102-106; measured
    4.5e-3 default, 2.3e-3 kernels, fused and tblock). The input gradient
    in relative L2 norm within 0.35 (measured 0.246 on the first two
    routes, 0.245 on the fused ones): bfloat16 rounds the activations into
    new ties and flips some maxima of the trunk pools, so the two
    frameworks' gradients differ about as much as JAX's own bfloat16
    gradient differs from its float32 one (0.38 and 0.34 here)."""
    flags = dict(ROUTES[route], pool_impl="argmax") if route == "default" else ROUTES[route]
    logit_err, grad_err = _bf16_errors(weights, flags)
    assert logit_err <= 1e-2, logit_err
    assert grad_err <= 0.35, grad_err


def test_bf16_grad_cam_arithmetic_matches_jax():
    """The CAM from given bfloat16 activations and gradients, in bfloat16
    as JAX computes it (channel weights, weighted sum, ReLU, bilinear
    upsampling, per-frame normalization): within 2 bfloat16 ulps of 1,
    2**-7 (measured 2**-7)."""
    from ivf_tpu.interpret.gradcam import cam_from_activation as j_cam
    from ivf_tpu_torch.interpret.gradcam import cam_from_activation as t_cam

    rng = np.random.RandomState(0)
    act = np.maximum(rng.randn(2, 1, 2, 2, 64), 0).astype(np.float32)
    grads = (rng.randn(2, 1, 2, 2, 64) * 1e-3).astype(np.float32)
    want = np.stack([
        np.asarray(j_cam(jnp.asarray(a, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16), 8, (32, 32), True),
                   np.float32)
        for a, g in zip(act, grads)
    ])
    got = t_cam(_bf16(act), _bf16(grads), 8, (32, 32), True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2.0**-7)


def _set_small(cfg, out_dir, steps=4):
    cfg.output_dir = str(out_dir)
    cfg.model_name = "fm"
    cfg.model.num_classes = 5
    cfg.model.compute_dtype = "bfloat16"
    cfg.data.batch_size = 2
    cfg.mask.opt_iter = steps
    cfg.mask.top_layer = "Mixed_4f"
    return cfg


# The central init's choice is pinned in both packages for the comparison:
# at this size the unperturbed and the fully frozen class scores differ by
# one to three bfloat16 ulps, so the candidates' score-drop ratios are
# rounding noise (measured: 0.625 in JAX, 0.0 in the port, for the same
# candidate) and either package may pick any candidate. The init's code is
# the float32 one, held against JAX in tests/test_torch_api.py.
PINNED_INIT = np.where((np.arange(8) >= 2) & (np.arange(8) < 6), 5.0, -5.0).astype(np.float32)


@pytest.fixture(scope="module")
def jax_bf16_run(weights, tmp_path_factory):
    """The JAX package's find_masks at bfloat16 (its argmax upgrade on)."""
    import ivf_tpu.interpret.mask_opt as j_mask_opt

    variables, sd = weights
    out = tmp_path_factory.mktemp("jax_bf16")
    cfg = _set_small(JConfig(), out)
    cfg.data.num_workers = 1
    built = []

    def small(cfg, softmax_override=None):
        built.append(cfg.model.pool_impl)
        return j_i3d_smth(**SMALL, dropout_rate=0.0, softmax=True, pool_impl=cfg.model.pool_impl)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(japi, "build_model", small)
        mp.setattr(j_mask_opt, "init_mask_central", lambda *a, **k: jnp.asarray(PINNED_INIT))
        tm, gc = japi.find_masks(
            cfg, variables, dataset=JSyntheticClips(2, t=8, hw=32, num_classes=5, lazy=False),
            save_viz=False,
        )
    assert built == ["argmax"]
    return dict(tm=tm, gc=gc, sd=sd)


def _port_find_masks(out_dir, sd, **model_flags):
    cfg = _set_small(TConfig(), out_dir)
    for name, value in model_flags.items():
        setattr(cfg.model, name, value)
    orig = tapi.build_model
    built = []

    def small_model(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        model.pool_shape = (1, 1, 1)  # logits pool for 32x32 inputs
        built.append((cfg.model.pool_impl, next(model.parameters()).dtype))
        return model

    def pinned_init(score_fn, seqs, targets, **kw):
        return torch.from_numpy(PINNED_INIT).expand(seqs.shape[0], -1).clone()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "build_model", small_model)
        mp.setattr(tapi, "init_mask_central", pinned_init)
        tm, gc = tapi.find_masks(
            cfg, sd, SyntheticClips(2, t=8, hw=32, num_classes=5, lazy=False), device="cpu", save_viz=False
        )
    return tm, gc, built


@pytest.mark.parametrize("route", list(ROUTES))
def test_find_masks_bf16_matches_jax(jax_bf16_run, tmp_path, route):
    """find_masks at bfloat16, 4 steps from the pinned init, against the
    JAX package's (its default route, the argmax pool). Scores, float32
    upcasts of bfloat16 probabilities: atol 3e-2 (measured 1.2e-2 default
    route, 1.6e-2 kernel route; JAX's own bfloat16 vs float32: 8.3e-3).
    Masks: atol 3e-2 (measured 8.6e-3 and 1.2e-2; the kernel route's
    every-tie pool backward gives another gradient). CAMs, bfloat16 maps
    normalized per frame to [0, 1]: atol 0.25 (measured 0.16 on both
    routes; JAX's own bfloat16 vs float32: 0.07): the activations and
    gradients at Mixed_4f differ by bfloat16 rounding, while the CAM
    arithmetic itself agrees to 2**-7 (test above). Predictions agree.
    The fused routes are held to the same bounds."""
    tm, gc, built = _port_find_masks(tmp_path, jax_bf16_run["sd"], **ROUTES[route])
    assert built == [("argmax", torch.bfloat16)]
    names = sorted(p.name for p in (Path(tmp_path) / "fm" / "results").glob("*.p"))
    assert names == ["allGradCamResults_fm_None_.p", "allTimeMaskResults_fm_None_.p", "emission_journal.p"]
    for got, want in zip(tm, jax_bf16_run["tm"]):
        assert got["pred_class"] == want["pred_class"]
        for key in ("original_score_guess", "freeze_score", "reverse_score"):
            assert isinstance(got[key], float)
            np.testing.assert_allclose(got[key], float(want[key]), atol=3e-2)
        assert got["time_mask"].dtype == np.float32
        np.testing.assert_allclose(got["time_mask"], np.asarray(want["time_mask"], np.float32), atol=3e-2)
    for got, want in zip(gc, jax_bf16_run["gc"]):
        assert got["GCHeatMap"].shape == (8, 32, 32) and got["GCHeatMap"].dtype == np.float32
        np.testing.assert_allclose(got["GCHeatMap"], np.asarray(want["GCHeatMap"], np.float32), atol=0.25)


@pytest.mark.parametrize(
    "dtype,impl,want",
    [
        ("bfloat16", "reduce_window", "argmax"),
        ("bfloat16", "argmax", "argmax"),
        ("float32", "reduce_window", "reduce_window"),
    ],
)
def test_bf16_argmax_upgrade_copies_and_leaves_float32(dtype, impl, want):
    """The JAX package's rule: bfloat16 with the default pool becomes
    'argmax' on a copy; the caller's config is untouched; float32 never
    changes."""
    cfg = TConfig()
    cfg.model.compute_dtype, cfg.model.pool_impl = dtype, impl
    before = dataclasses.asdict(cfg)
    out = tapi._bf16_argmax_upgrade(cfg)
    assert out.model.pool_impl == want
    assert dataclasses.asdict(cfg) == before
    assert (out is cfg) == (want == impl)


@pytest.mark.parametrize("impl", ["shift", "eqbwd", "argmax_full", "argmax_shift"])
def test_bf16_pool_impls_match_jax_and_unknown_impls_raise(weights, impl):
    """The pool impls that raised in bfloat16 before the port had them now
    build through ``build_model`` (nothing falls back to another pool: the
    model carries the impl) and match the JAX model with the same impl at
    bfloat16, at the bounds of
    ``test_i3d_bf16_logits_and_input_gradient_match_jax`` (logits 1e-2 of
    the largest; input gradient 0.35 in relative L2; measured here: logits
    7.9e-3 for each impl, whose forward values do not depend on it;
    gradients 0.180 shift, 0.260 eqbwd, 0.202 argmax_full, 0.194
    argmax_shift). An unknown impl still raises."""
    cfg = TConfig()
    cfg.model.num_classes, cfg.model.compute_dtype, cfg.model.pool_impl = 5, "bfloat16", impl
    model = tapi.build_model(cfg, device="cpu")
    assert model.pool_impl == impl and next(model.parameters()).dtype == torch.bfloat16
    model.pool_shape = SMALL["pool_shape"]
    logit_err, grad_err = _bf16_errors(weights, dict(pool_impl=impl), model)
    assert logit_err <= 1e-2, logit_err
    assert grad_err <= 0.35, grad_err
    cfg.model.pool_impl = impl + "_v2"
    with pytest.raises(NotImplementedError, match="pool_impl"):
        tapi.build_model(cfg, device="cpu")


@pytest.mark.parametrize("route", ["fused", "tblock"])
def test_bf16_fused_routes_give_the_pool_kernel_routes_logits(weights, route):
    """In bfloat16 the fused branch 3 computes what the unfused kernel pair
    does forward (the exact bf16 pool, then float32 sums rounded once), so
    the I3D logits of both fused routes equal the pool-kernel route's bits
    on the CPU; no argmax pool runs on a fused route."""
    _, sd = weights
    x = torch.from_numpy(np.random.RandomState(3).uniform(0, 255, SHAPE).astype(np.float32))
    logits = {}
    for name in ("kernels", route):
        model = t_i3d_smth(**SMALL, **ROUTES[name], pool_impl="argmax")
        model.load_state_dict(sd)
        model = model.to(torch.bfloat16).eval()
        with torch.no_grad():
            logits[name] = model(x)
    assert torch.equal(logits[route].view(torch.int16), logits["kernels"].view(torch.int16))


def _tf32_state():
    out = {}
    for name, get in (
        ("cudnn", lambda: torch.backends.cudnn.allow_tf32),
        ("cublas", lambda: torch.backends.cuda.matmul.allow_tf32),
        ("matmul_precision", torch.get_float32_matmul_precision),
        ("conv", lambda: torch.backends.cudnn.conv.fp32_precision),
        ("matmul", lambda: torch.backends.cuda.matmul.fp32_precision),
        ("cudnn_deterministic", lambda: torch.backends.cudnn.deterministic),
        ("cudnn_benchmark", lambda: torch.backends.cudnn.benchmark),
    ):
        try:
            out[name] = get()
        except (AttributeError, RuntimeError) as exc:
            out[name] = type(exc).__name__
    return out


@pytest.mark.parametrize("cudnn_tf32", [True, False], ids=["tf32_on", "tf32_off"])
def test_find_masks_leaves_the_callers_tf32_flags_as_it_found_them(tmp_path, cudnn_tf32):
    """Inside find_masks TF32 is off, cuDNN deterministic and
    ``cudnn.benchmark`` as the caller set it; after it, the caller's flags
    read as before (the port sets them only inside its entry points)."""
    from ivf_tpu_torch import precision

    before_cudnn = torch.backends.cudnn.allow_tf32
    seen = []
    try:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        state = _tf32_state()
        cfg = _set_small(TConfig(), tmp_path, steps=1)
        cfg.model.compute_dtype = "float32"
        orig = tapi.build_model

        def watch(cfg, softmax_override=None, device=None):
            seen.append(_tf32_state())
            model = orig(cfg, softmax_override, device)
            model.pool_shape = (1, 1, 1)
            return model

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tapi, "build_model", watch)
            tapi.find_masks(cfg, None, SyntheticClips(1, t=8, hw=32, num_classes=5), device="cpu")
        assert _tf32_state() == state
        with precision.reference_numerics():
            assert _tf32_state() == seen[0]
        assert seen[0]["cudnn"] is False and seen[0]["cublas"] is False
        assert seen[0]["cudnn_deterministic"] is True and state["cudnn_deterministic"] is False
        assert seen[0]["cudnn_benchmark"] == state["cudnn_benchmark"]
    finally:
        torch.backends.cudnn.allow_tf32 = before_cudnn
