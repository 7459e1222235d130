"""The space-to-depth I3D stem (``ivf_tpu_torch.ops.conv.conv3d_stem_s2d``)
against the JAX package's ``conv3d_stem_s2d`` and against the port's plain
stem (``conv3d_same`` at stride 2, whose input gradient is the polyphase
form), on the CPU, forward and input gradient, float32 and bfloat16; and
the guard that routes I3D's stem to it (``models/layers.py::Unit3D``).

The s2d form sums the same products in another order, so it equals the
plain stem within rounding, never bit for bit. Tolerances, as a share of
the reference's largest magnitude: float32 1e-5 (measured <= 1.1e-6 for
outputs and input gradients); bfloat16 2**-7, two bf16 ulps at the top
binade (measured: outputs 0 against JAX, which like this form rounds the
conv before it adds the bias, and <= 0.0046 against the plain stem,
which adds it inside the conv; input gradients <= 0.0019). The input
gradient is float32 in both dtypes (the clips are float32; the conv
casts them).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.ops import conv as jconv
from ivf_tpu_torch.models import i3d_smth as t_i3d_smth
from ivf_tpu_torch.models import layers as tlayers
from ivf_tpu_torch.ops import conv as tconv

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(shape, dtype, cout=8, bias=True, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    k = torch.from_numpy((rng.randn(cout, shape[-1], 7, 7, 7) * 0.1).astype(np.float32)).to(dtype)
    b = torch.from_numpy(rng.randn(cout).astype(np.float32)).to(dtype) if bias else None
    out_shape = (shape[0], *(d // 2 for d in shape[1:4]), cout)
    g = torch.from_numpy(rng.randn(*out_shape).astype(np.float32)).to(dtype)
    return x, k, b, g


def _port(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    y = fn(xt)
    names, todo = set(), [y.grad_fn]
    while todo:
        node = todo.pop()
        if node is not None and type(node).__name__ not in names:
            names.add(type(node).__name__)
            todo.extend(f for f, _ in node.next_functions)
    (dx,) = torch.autograd.grad(y, xt, g)
    return y.detach(), dx, names


def _close(got, want, dtype):
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape,bias",
    [
        ((1, 8, 12, 12, 3), True),  # the stem's (2, 3) pads on every axis
        ((2, 4, 6, 10, 3), False),  # unequal axes, no bias
        ((1, 16, 32, 32, 3), True),  # the CPU tests' clip size
        ((1, 2, 4, 2, 3), True),  # one output frame and column
        ((1, 4, 4, 6, 5), False),  # another Cin (40 regrouped channels)
    ],
)
def test_conv3d_stem_s2d_matches_jax_and_the_plain_stem(shape, bias, dtype):
    x, k, b, g = _case(shape, dtype, bias=bias)
    y, dx, names = _port(lambda a: tconv.conv3d_stem_s2d(a, k, b), x, g)
    y_plain, dx_plain, plain_names = _port(lambda a: tconv.conv3d_same(a, k, (2, 2, 2), b), x, g)
    assert y.dtype == dtype and dx.dtype == torch.float32
    assert "_Stride1Conv3dFwdGradBackward" in names and "_StridedConv3dPolyphaseBackward" in plain_names

    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    kj = jnp.asarray(k.float().numpy().transpose(2, 3, 4, 1, 0)).astype(jdt)
    bj = None if b is None else jnp.asarray(b.float().numpy()).astype(jdt)
    yj, vjp = jax.vjp(lambda a: jconv.conv3d_stem_s2d(a, kj, bj), jnp.asarray(x))
    (dxj,) = vjp(jnp.asarray(g.float().numpy()).astype(yj.dtype))
    _close(y, yj.astype(jnp.float32), dtype)
    _close(dx, dxj.astype(jnp.float32), dtype)
    _close(y, y_plain.float().numpy(), dtype)
    _close(dx, dx_plain.float().numpy(), dtype)


@pytest.mark.parametrize(
    "shape,s2d,stride,want_s2d",
    [
        ((1, 8, 12, 12, 3), True, (2, 2, 2), True),
        ((1, 7, 12, 12, 3), True, (2, 2, 2), False),  # odd T: the plain stem
        ((1, 8, 12, 11, 3), True, (2, 2, 2), False),  # odd W
        ((1, 8, 12, 12, 3), True, (1, 2, 2), False),  # a stride-mod stem
        ((1, 8, 12, 12, 3), False, (2, 2, 2), False),  # flag off
    ],
    ids=["even", "odd_t", "odd_w", "stride_1_in_t", "off"],
)
def test_unit3d_takes_the_s2d_stem_only_under_the_reference_guard(monkeypatch, shape, s2d, stride, want_s2d):
    """``Unit3D`` runs ``conv3d_stem_s2d`` exactly where
    ``ivf_tpu/models/layers.py:135-143`` does (kernel 7x7x7, stride 2,
    even T, H, W) and ``conv3d_same`` otherwise; either way the output is
    the plain stem's, within the float32 tolerance."""
    calls = []
    real = tlayers.conv3d_stem_s2d
    monkeypatch.setattr(tlayers, "conv3d_stem_s2d", lambda *a: calls.append(1) or real(*a))
    unit = tlayers.Unit3D(3, 8, (7, 7, 7), stride, s2d=s2d)
    gen = torch.Generator().manual_seed(0)
    tlayers.variance_scaling_(unit.conv3d.weight, 2.0, gen)
    x = torch.from_numpy(np.random.RandomState(1).randn(*shape).astype(np.float32))
    with torch.no_grad():
        y = unit(x)
        w, b = unit.folded()
        want = torch.relu(tconv.conv3d_same(x, w, stride, b))
    assert bool(calls) == want_s2d
    _close(y, want.numpy(), torch.float32)


@pytest.mark.parametrize("shape,kernel", [((1, 7, 8, 8, 3), 7), ((1, 8, 8, 8, 3), 5)])
def test_conv3d_stem_s2d_refuses_what_the_guard_refuses(shape, kernel):
    with pytest.raises(ValueError):
        tconv.conv3d_stem_s2d(torch.zeros(shape), torch.zeros(8, 3, kernel, kernel, kernel))


def test_i3d_stem_s2d_reaches_the_stem_only():
    """The flag goes to the stem's Unit3D (the only 7x7x7 stride-2 conv) and
    defaults to the reference's True; state dicts keep the 7x7x7 weight."""
    on, off = t_i3d_smth(num_classes=5), t_i3d_smth(num_classes=5, stem_s2d=False)
    assert on.Conv3d_1a_7x7.s2d and not off.Conv3d_1a_7x7.s2d
    assert on.Conv3d_1a_7x7.conv3d.weight.shape == (64, 3, 7, 7, 7)
    assert {k: v.shape for k, v in on.state_dict().items()} == {k: v.shape for k, v in off.state_dict().items()}


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kernel,padding", [((2, 24, 5, 6, 7), 4, 1), ((1, 5, 4, 4, 4), 3, 0), ((1, 3, 6, 5, 4), 3, 2)])
def test_stride1_conv_gradients_match_autograd(shape, kernel, padding, dtype):
    """``_Stride1Conv3dFwdGrad``, the s2d stem's conv: the input gradient
    as a forward conv, and the weight and bias gradients, against autograd
    through ``F.conv3d`` (float32: 1e-5 of the largest gradient, sums in
    another order; bfloat16: 2**-7)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (torch.randn(6, shape[1], kernel, kernel, kernel, generator=gen) * 0.2).to(dtype)
    b = torch.randn(6, generator=gen).to(dtype)
    grads = []
    for fn in (tconv._Stride1Conv3dFwdGrad.apply, lambda *a: torch.nn.functional.conv3d(*a[:3], padding=a[3])):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        y = fn(*leaves, padding)
        g = torch.randn(y.shape, generator=torch.Generator().manual_seed(6)).to(dtype)
        grads.append((y.detach(), *torch.autograd.grad(y, leaves, g)))
    for got, want in zip(*grads):
        _close(got, want.float().numpy(), dtype)
