"""ivf_tpu_torch ops vs the JAX package's ops, on the CPU.

The port's kernel wrappers take their plain PyTorch versions on CPU
tensors, so these tests hold the plain versions (and the autograd rules
around them) against the Pallas functions run in interpret mode. The
CUDA kernels themselves are held against the plain versions by
tests/test_torch_gpu.py, which skips without a card, and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.ops import conv as jconv
from ivf_tpu.ops.padding import same_pad_amounts as j_same_pad_amounts
from ivf_tpu.ops.pallas.maxpool3d import pallas_maxpool3d_s1
from ivf_tpu.ops.pallas.pointwise_conv import pallas_pointwise_conv
from ivf_tpu_torch.ops import conv as tconv
from ivf_tpu_torch.ops.kernels import maxpool3d as tpool
from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw
from ivf_tpu_torch.ops.padding import explicit_same_padding, same_pad_amounts


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "size,kernel,stride",
    [(8, 7, 2), (7, 7, 2), (16, 3, 1), (5, 3, 2), (4, 2, 2), (3, 1, 1), (1, 3, 2)],
)
def test_same_pad_amounts_match_jax(size, kernel, stride):
    assert same_pad_amounts(size, kernel, stride) == j_same_pad_amounts(size, kernel, stride)


def test_explicit_same_padding_rejects_rank_mismatch():
    with pytest.raises(ValueError):
        explicit_same_padding((8, 8), (3, 3, 3), (1, 1, 1))


@pytest.mark.parametrize(
    "shape,kernel,stride,bias",
    [
        ((1, 8, 12, 12, 3), (7, 7, 7), (2, 2, 2), False),  # stem: (2, 3) pads
        ((2, 7, 9, 10, 3), (7, 7, 7), (2, 2, 2), True),  # odd sizes
        ((1, 4, 6, 6, 5), (3, 3, 3), (1, 1, 1), True),
        ((2, 5, 7, 6, 4), (3, 3, 3), (2, 2, 2), False),  # (0, 1) / (1, 1) mix
        ((1, 3, 5, 5, 6), (1, 1, 1), (1, 1, 1), True),
    ],
)
def test_conv3d_same_matches_jax(shape, kernel, stride, bias):
    """Strided and asymmetric TF-SAME cases; tolerance: float32 sums of
    up to 7*7*7*3 terms in two libraries' orders."""
    rng = np.random.RandomState(0)
    cin, cout = shape[-1], 8
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(*kernel, cin, cout) * 0.1).astype(np.float32)
    b = rng.randn(cout).astype(np.float32) if bias else None
    ref = np.asarray(
        jconv.conv3d_same(jnp.asarray(x), jnp.asarray(k), stride, None if b is None else jnp.asarray(b))
    )
    out = tconv.conv3d_same(
        _t(x), _t(k.transpose(4, 3, 0, 1, 2)), stride, None if b is None else _t(b)
    )
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "window,stride,shape",
    [
        ((1, 3, 3), (1, 2, 2), (1, 4, 9, 8, 3)),
        ((3, 3, 3), (2, 2, 2), (2, 5, 7, 6, 2)),
        ((2, 2, 2), (2, 2, 2), (1, 4, 4, 5, 3)),
        ((3, 3, 3), (1, 1, 1), (1, 3, 4, 5, 2)),
    ],
)
def test_max_pool3d_same_matches_jax(window, stride, shape):
    """Zero padding (not -inf): the input holds negatives, so a window
    that overlaps the border takes the padded 0. Tie-free values, so the
    forward and the gradient must agree exactly."""
    rng = np.random.RandomState(1)
    x = (rng.permutation(int(np.prod(shape))).reshape(shape) - 20.0).astype(np.float32) * 0.01

    def jfn(a):
        return jconv.max_pool3d_same(a, window, stride)

    y_ref, vjp = jax.vjp(jfn, jnp.asarray(x))
    g_np = rng.randn(*y_ref.shape).astype(np.float32)
    (dx_ref,) = vjp(jnp.asarray(g_np))
    xt = _t(x).requires_grad_(True)
    y = tconv.max_pool3d_same(xt, window, stride)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    (dx,) = torch.autograd.grad(y, xt, _t(g_np))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_ref))


@pytest.mark.parametrize("window", [(1, 1, 1), (2, 7, 7), (1, 2, 2)])
def test_avg_pool3d_valid_matches_jax(window):
    x = np.random.RandomState(2).randn(2, 3, 7, 7, 4).astype(np.float32)
    ref = np.asarray(jconv.avg_pool3d_valid(jnp.asarray(x), window, (1, 1, 1)))
    out = tconv.avg_pool3d_valid(_t(x), window, (1, 1, 1))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("use_bias", [True, False])
def test_pointwise_plain_matches_pallas_fwd_and_vjp(relu, use_bias):
    """Forward and VJP (dx through the kernel path, dw/db outside) against
    the Pallas kernel in interpret mode, at the ragged (2,3,5,5,112)->48
    of tests/test_ops.py; rtol 2e-4 / atol 2e-5 as pinned there."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 3, 5, 5, 112).astype(np.float32)
    w = (rng.randn(112, 48) * 0.1).astype(np.float32)
    b = rng.randn(48).astype(np.float32)
    g = rng.randn(2, 3, 5, 5, 48).astype(np.float32)
    if use_bias:
        fn = lambda x, w, b: pallas_pointwise_conv(x, w, b, relu=relu, interpret=True)  # noqa: E731
        args = (x, w, b)
    else:
        fn = lambda x, w: pallas_pointwise_conv(x, w, None, relu=relu, interpret=True)  # noqa: E731
        args = (x, w)
    y_ref, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    grads_ref = vjp(jnp.asarray(g))

    targs = [_t(a).requires_grad_(True) for a in args]
    y = tpw.pointwise_conv(targs[0], targs[1], targs[2] if use_bias else None, relu=relu)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=2e-4, atol=2e-5)
    grads = torch.autograd.grad(y, targs, _t(g))
    for got, ref in zip(grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


def test_pointwise_backward_dx_with_frozen_weights():
    """With frozen weights (the mask search) only dx is asked for, and it
    is ``[y > 0] @ w^T`` through the same GEMM path."""
    x = torch.randn(10, 6, requires_grad=True)
    w = torch.randn(6, 4)
    b = torch.randn(4)
    y = tpw.pointwise_conv(x, w, b, relu=True)
    (dx,) = torch.autograd.grad(y.sum(), [x])
    m = (x @ w + b > 0).float()
    torch.testing.assert_close(dx, m @ w.t())


def _post_relu_with_ties(shape, seed):
    """relu(N(0,1)) rounded to halves: half the values are exact zeros and
    the rest take few values, so windows whose maximum is tied (at zero, at
    the zero padding, or at a positive value) are common."""
    x = np.round(np.random.RandomState(seed).randn(*shape) * 2) / 2
    return np.maximum(x, 0).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (1, 2, 3, 3, 130)])
def test_maxpool_plain_matches_pallas(shape):
    """Forward bit-exact; backward (the every-tie 27-term gather on both
    sides) to 1e-5, float sums in another order."""
    x = _post_relu_with_ties(shape, 4)
    g = np.random.RandomState(5).randn(*shape).astype(np.float32)
    y_ref, vjp = jax.vjp(pallas_maxpool3d_s1, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    y = tpool.maxpool3d_s1(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    (dx,) = torch.autograd.grad(y, xt, _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_ref), rtol=1e-5, atol=1e-5)
    # ties exist and got credit: the every-tie rule differs from F.max_pool3d
    x2 = _t(x).requires_grad_(True)
    (dx_native,) = torch.autograd.grad(tconv.max_pool3d_same(x2, (3, 3, 3), (1, 1, 1)), x2, _t(g))
    assert not torch.equal(dx_native, dx)


def test_every_tie_backward_multiplies_the_gradient_on_a_plateau():
    """On an all-equal input each window's maximum is tied across its whole
    in-range neighbourhood. F.max_pool3d's backward keeps the gradient's
    total (one element per window); the every-tie gather of the Pallas
    kernel, and identically of the port, credits every voxel once per
    window that holds it: 27 times an interior voxel's share."""
    shape = (1, 3, 4, 5, 2)
    x = np.ones(shape, np.float32)
    g = np.ones(shape, np.float32)
    _, vjp = jax.vjp(pallas_maxpool3d_s1, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(g))
    xt = _t(x).requires_grad_(True)
    (dx,) = torch.autograd.grad(tpool.maxpool3d_s1(xt), xt, _t(g))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(dx_ref))
    per_dim = [np.minimum(np.arange(n) + 1, n - 1) - np.maximum(np.arange(n) - 1, 0) + 1
               for n in shape[1:4]]
    windows = np.einsum("t,h,w->thw", *per_dim)[None, ..., None] * g
    np.testing.assert_array_equal(dx.numpy(), windows)
    assert dx.max().item() == 27.0
    x2 = _t(x).requires_grad_(True)
    (dx_native,) = torch.autograd.grad(tconv.max_pool3d_same(x2, (3, 3, 3), (1, 1, 1)), x2, _t(g))
    assert dx_native.sum().item() == g.sum()


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """CUDA wrappers check device, dtype, shape and contiguity before any
    launch; the dispatchers raise for a device with no kernel."""
    x = torch.randn(4, 3)
    w = torch.randn(3, 2)
    with pytest.raises(ValueError):
        tpw.pointwise_conv_cuda(x, w, None, True)  # CPU tensors
    with pytest.raises(ValueError):
        tpool.maxpool3d_s1_fwd_cuda(torch.randn(1, 2, 3, 3, 4))
    with pytest.raises(ValueError):
        tpool.maxpool3d_s1_fwd_cuda(torch.randn(2, 3, 3, 4))  # not 5-D
    with pytest.raises(RuntimeError):
        tpw.pointwise_conv(torch.empty(4, 3, device="meta"), torch.empty(3, 2, device="meta"))
    with pytest.raises(RuntimeError):
        tpool.maxpool3d_s1(torch.empty(1, 2, 3, 3, 4, device="meta"))
