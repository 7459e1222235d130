"""ivf_tpu_torch's fused branch 3 (pool -> 1x1x1 conv -> bias [-> ReLU]) vs
the JAX package's Pallas ``fused_pool_conv`` / ``fused_pool_conv_tblock``
in interpret mode, on the CPU (the port's plain versions).

Inputs are post-ReLU values rounded to halves (exact zeros, tied maxima,
windows whose maximum is the zero padding) or 0/1 plateaus, so a wrong
border or tie rule shows. Forward, dx, dw and db under the cotangent of
``sum(sin(y))`` (tests/test_ops.py), rtol 1e-5 / atol 1e-5: the pool and
the gather are exact, the two GEMMs sum in other orders. In bfloat16 the
same cases against the Pallas functions at bf16. The CUDA kernels
are held against the plain versions by tests/test_torch_gpu.py and
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.ops.pallas import fused_branch3 as jfb
from ivf_tpu_torch.ops.kernels import fused_branch3 as tfb
from ivf_tpu_torch.ops.kernels import maxpool3d as tpool
from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw

VARIANTS = {
    "frame": (jfb.fused_pool_conv, tfb.fused_pool_conv),
    "tblock": (jfb.fused_pool_conv_tblock, tfb.fused_pool_conv_tblock),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ties(shape, rng):
    """relu(N(0, 1)) rounded to halves: half exact zeros, few values."""
    return np.maximum(np.round(rng.randn(*shape) * 2) / 2, 0).astype(np.float32)


def _plateaus(shape, rng):
    """0/1 values, 30% ones: most windows hold several tied maxima."""
    return (rng.rand(*shape) < 0.3).astype(np.float32)


CASES = {  # (x shape, Cout, input maker)
    "base": ((2, 4, 6, 6, 24), 16, _ties),
    "cin136": ((1, 2, 5, 5, 136), 16, _ties),  # two of JAX's 128-lane Cin blocks
    "t1": ((2, 1, 4, 5, 8), 8, _ties),
    "t2": ((1, 2, 3, 4, 12), 8, _ties),
    "plateaus": ((1, 4, 5, 6, 16), 24, _plateaus),
}


def _inputs(case):
    shape, cout, make = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    x = make(shape, rng)
    w = (rng.randn(shape[-1], cout) * 0.2).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_fused_pool_conv_matches_pallas(variant, relu, case):
    jfn, tfn = VARIANTS[variant]
    x, w, b = _inputs(case)

    def jloss(x, w, b):
        y = jfn(x, w, b, relu)
        return jnp.sum(jnp.sin(y)), y

    (_, y_ref), grads_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)
    )
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    y = tfn(*args, relu)
    grads = torch.autograd.grad(torch.sin(y).sum(), args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    for name, got, want in zip(("dx", "dw", "db"), grads, grads_ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5, err_msg=name)
    if case == "plateaus":  # ties got credit beyond one element per window
        assert grads[0].abs().sum() > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_bf16_fused_pool_conv_matches_pallas(variant, relu, case):
    """bf16 x, w and b (the JAX package's bf16 search) against the Pallas
    functions in interpret mode at bf16, the cotangent of
    ``sum(sin(float32(y)))``. The forward is held within one bf16 ulp of
    the largest output (the pool is exact, the float32 sums differ in
    order only, one rounding); dx, dw and db, all bf16 as in JAX, gave
    equal bits in every case here and are held to equal bits."""
    jfn, tfn = VARIANTS[variant]
    x, w, b = _inputs(case)
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731

    def jloss(x, w, b):
        y = jfn(x, w, b, relu)
        return jnp.sum(jnp.sin(y.astype(jnp.float32))), y

    (_, y_ref), grads_ref = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jb(x), jb(w), jb(b)
    )
    args = [torch.from_numpy(a).bfloat16().requires_grad_(True) for a in (x, w, b)]
    y = tfn(*args, relu)
    grads = torch.autograd.grad(torch.sin(y.float()).sum(), args)
    assert y.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in grads)
    want = np.asarray(y_ref.astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(y.detach().float().numpy(), want, rtol=0, atol=ulp)
    for name, got, want in zip(("dx", "dw", "db"), grads, grads_ref):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)), err_msg=name
        )


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_version_is_the_pool_kernel_then_the_pointwise_conv(variant, relu):
    """The port's unfused kernel route (``maxpool3d_s1`` then
    ``pointwise_conv``), run by autograd, gives the same bits on the CPU:
    the same plain ops in the same order."""
    x, w, b = (torch.from_numpy(a) for a in _inputs("base"))
    g = torch.randn(*x.shape[:-1], w.shape[1], generator=torch.Generator().manual_seed(0))
    xf = x.clone().requires_grad_(True)
    y = VARIANTS[variant][1](xf, w, b, relu)
    (dx,) = torch.autograd.grad(y, xf, g)
    xu = x.clone().requires_grad_(True)
    yu = tpw.pointwise_conv(tpool.maxpool3d_s1(xu), w, b, relu=relu)
    (dxu,) = torch.autograd.grad(yu, xu, g)
    assert torch.equal(y, yu)
    assert torch.equal(dx, dxu)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_weight_gradients_run_only_when_asked(variant, monkeypatch):
    """The mask search freezes the weights: its backward computes dx alone
    and never recomputes the pool for dw/db."""
    calls = []
    real = tfb._weight_grads

    def counted(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(tfb, "_weight_grads", counted)
    x, w, b = (torch.from_numpy(a) for a in _inputs("t2"))
    fn = VARIANTS[variant][1]
    xg = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(fn(xg, w, b).sum(), xg)
    assert calls == [] and dx.shape == x.shape
    wg = w.clone().requires_grad_(True)
    (dw,) = torch.autograd.grad(fn(x, wg, b).sum(), wg)
    assert calls == [1] and dw.shape == w.shape


def test_fused_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers check device, dtype and shapes before any launch;
    the autograd route raises for a device with no kernel."""
    x, w, b = (torch.from_numpy(a) for a in _inputs("t2"))
    for fwd in (tfb.fused_pool_conv_fwd_cuda, tfb.fused_pool_conv_tblock_fwd_cuda):
        with pytest.raises(ValueError):
            fwd(x, w, b, True)  # CPU tensors
        with pytest.raises(ValueError):
            fwd(x[0], w, b, True)  # not 5-D
    y = torch.zeros(*x.shape[:-1], w.shape[1])
    for bwd in (tfb.fused_pool_conv_bwd_cuda, tfb.fused_pool_conv_tblock_bwd_cuda):
        with pytest.raises(ValueError):
            bwd(x, y, y, w, True)
    for fn in (tfb.fused_pool_conv, tfb.fused_pool_conv_tblock):
        with pytest.raises(RuntimeError):
            fn(x.to("meta"), w.to("meta"), b.to("meta"))
