"""Guided backprop in the port (``ivf_tpu_torch/interpret/guided_backprop.py``,
``I3D(guided_relu=True)``) against the JAX package's, on the CPU.

The guided ReLU's forward and VJP are elementwise selections, so they are
held to equal bits in float32 and bfloat16. ``guided_backprop_i3d`` runs a
small I3D (1, 8, 32, 32, 3) with numpy-drawn weights on the plain flags
and on the kernel route (``use_pallas`` + ``pallas_pool``; the JAX Pallas
kernels in interpret mode, the port's wrappers on their plain versions):
the saliency maps are compared after dividing both by the reference's
largest magnitude, at the I3D input-gradient tolerance of
``tests/test_torch_model.py`` (rtol 1e-3 / atol 1e-4: the trunk's float32
sums in two libraries' orders). Under the guided activation no fusion
runs (``ivf_tpu/models/layers.py:205``): the tests count the fused calls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.interpret.guided_backprop import guided_backprop_i3d as j_guided_backprop_i3d
from ivf_tpu.interpret.guided_backprop import guided_relu as j_guided_relu
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu_torch.interpret import guided_backprop_i3d, guided_relu
from ivf_tpu_torch.models import i3d_smth
from ivf_tpu_torch.models import layers
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict
from tests.test_torch_model import make_jax_variables

SHAPE = (1, 8, 32, 32, 3)
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1), dropout_rate=0.0)
TARGET = 2
ROUTES = {"plain": {}, "kernels": dict(use_pallas=True, pallas_pool=True)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ref():
    """JAX guided saliency on both routes and the unguided logits, once."""
    variables = make_jax_variables(j_i3d_smth(**SMALL), SHAPE)
    clip = np.random.RandomState(1).uniform(0, 255, SHAPE[1:]).astype(np.float32)
    out = {"sd": i3d_variables_to_state_dict(variables), "clip": clip}
    for route, flags in ROUTES.items():
        fn = jax.jit(lambda c, flags=flags: j_guided_backprop_i3d(variables, c, TARGET, **SMALL, **flags))
        out[route] = np.asarray(fn(jnp.asarray(clip)))
    out["logits"] = np.asarray(jax.jit(j_i3d_smth(**SMALL).apply)(variables, jnp.asarray(clip[None])))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_guided_relu_forward_and_vjp_match_jax(dtype):
    """Equal bits: ``max(x, 0)`` forward; the backward passes g only where
    x > 0 and g > 0 (the reference's GuidedBackpropReLU, grad-cam.py:147-163,
    and the JAX custom VJP), zeros and both signs of each included."""
    rng = np.random.RandomState(0)
    x = rng.randn(257).astype(np.float32)
    g = rng.randn(257).astype(np.float32)
    x[:8], g[8:16] = 0.0, 0.0
    jt = getattr(jnp, dtype)
    want_y, vjp = jax.vjp(j_guided_relu, jnp.asarray(x, jt))
    (want_g,) = vjp(jnp.asarray(g, jt))
    tt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tt).requires_grad_(True)
    y = guided_relu(xt)
    (got_g,) = torch.autograd.grad(y, xt, torch.from_numpy(g).to(tt))
    assert y.dtype == got_g.dtype == tt
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(want_y, np.float32))
    np.testing.assert_array_equal(got_g.float().numpy(), np.asarray(want_g, np.float32))
    replica = torch.from_numpy(g).to(tt) * (xt.detach() > 0).to(tt) * (torch.from_numpy(g) > 0).to(tt)
    np.testing.assert_array_equal(got_g.float().numpy(), replica.float().numpy())


@pytest.mark.parametrize("route", list(ROUTES))
def test_guided_backprop_i3d_matches_jax(ref, route):
    """d score[target] / d clip on the plain route and on the kernel route
    (the pool kernel's every-tie backward on both sides), from a state
    dict on the CPU; finite and non-zero."""
    got = guided_backprop_i3d(ref["sd"], torch.from_numpy(ref["clip"]), TARGET, device="cpu",
                              **SMALL, **ROUTES[route]).numpy()
    want = ref[route]
    assert got.shape == SHAPE[1:] and np.isfinite(got).all() and np.abs(got).max() > 0
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, rtol=1e-3, atol=1e-4)


def test_guided_forward_equals_the_unguided_forward(ref):
    """The guided model keeps the forward: within rtol 1e-4 / atol 1e-5 of
    the unguided (fused) model, the JAX test's tolerance (only the fused
    trio's summation order differs), and within the logits tolerance of
    ``tests/test_torch_model.py`` of JAX's."""
    x = torch.from_numpy(ref["clip"][None])
    models = {}
    for guided in (False, True):
        models[guided] = i3d_smth(**SMALL, guided_relu=guided)
        models[guided].load_state_dict(ref["sd"])
    with torch.no_grad():
        plain, guided = (models[g](x).numpy() for g in (False, True))
    np.testing.assert_allclose(guided, plain, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(guided, ref["logits"], rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize(
    "flags",
    [dict(fuse_pool_conv=True), dict(fuse_pool_conv="tblock"), dict(fuse_3x3=True)],
    ids=["fused_frame", "fused_tblock", "fuse_3x3"],
)
def test_guided_turns_every_fusion_off(ref, flags, monkeypatch):
    """With ``guided_relu`` the fused branch 3, the block-diagonal 3x3x3
    and the fused trio never run (the JAX rule ``act is jax.nn.relu``);
    every pointwise conv runs with ``relu=False`` and the guided ReLU after
    it: 38 calls (``Conv3d_2b_1x1``, four units in each of the nine blocks,
    the logits). The saliency has the bits of the same model without the
    fusion flags. Control: without guidance the same flags fuse 9 times."""
    calls = {"fused": 0, "fused_3x3": 0, "relu": []}

    def counted(fn, key):
        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapped

    def pointwise(x, w, b=None, relu=True):
        calls["relu"].append(relu)
        return pointwise_conv(x, w, b, relu)

    pointwise_conv = layers.pointwise_conv
    monkeypatch.setattr(layers, "fused_pool_conv", counted(layers.fused_pool_conv, "fused"))
    monkeypatch.setattr(layers, "fused_pool_conv_tblock", counted(layers.fused_pool_conv_tblock, "fused"))
    monkeypatch.setattr(layers.InceptionModule, "_fused_3x3",
                        counted(layers.InceptionModule._fused_3x3, "fused_3x3"))
    monkeypatch.setattr(layers, "pointwise_conv", pointwise)
    clip = torch.from_numpy(ref["clip"])
    base = dict(SMALL, use_pallas=True, pallas_pool=True)
    got = guided_backprop_i3d(ref["sd"], clip, TARGET, device="cpu", **base, **flags)
    assert calls["fused"] == calls["fused_3x3"] == 0
    assert calls["relu"] == [False] * 38
    calls["relu"].clear()
    want = guided_backprop_i3d(ref["sd"], clip, TARGET, device="cpu", **base)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    guided_backprop_i3d(ref["sd"], clip, TARGET, device="cpu", guided_relu=False, **base, **flags)
    assert calls["fused"] + calls["fused_3x3"] == 9
    assert calls["relu"].count(True) == 1 + 9 * (1 if "fuse_pool_conv" in flags else 2)
