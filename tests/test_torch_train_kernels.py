"""The port's training step on its kernel routes against the JAX
package's, on the CPU, where each kernel wrapper runs its plain version
and the JAX Pallas kernels run in interpret mode.

One train step of I3D with ``use_pallas`` + ``pallas_pool`` (the
pointwise kernel with no bias and no ReLU before each unfolded BN, the
branch-3 pool pair with its every-tie backward), ``Unit3D`` in training
on the pointwise route (``dx`` through the kernel, ``dW`` and ``db`` as
plain products, as ``ivf_tpu/ops/pallas/pointwise_conv.py:57-75``), and
the torch-family ConvLSTM with sigmoid gates on the gate kernel route and
the Keras ``kernel_l2`` term. Helpers, conditioning notes and the SGD-lr-1
gradient read-out are those of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.models import CNN3D as JCNN3D
from ivf_tpu.models import ConvLSTMClassifier as JClassifier
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.models.layers import Unit3D as JUnit3D
from ivf_tpu_torch.models import CNN3D, ConvLSTMClassifier, i3d_smth
from ivf_tpu_torch.models.layers import Unit3D
from ivf_tpu_torch.utils.convert import variables_to_state_dict
from tests.test_torch_train import (
    CLSTM_KW,
    I3D_KW,
    check_bf16_step,
    check_float32_step,
    fill_variables,
    grad_gap,
    i3d_reference,
    jax_sgd1_step,
    port_i3d_step,
    port_sgd1_step,
)

KERNELS = dict(use_pallas=True, pallas_pool=True)
CLSTM_SHAPE = (4, 6, 24, 24, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's steps many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_i3d_train_step_on_the_kernel_route_matches_jax():
    """Loss within 5e-5 (read: 3.6e-6); the gradients within 1e-3 (read:
    5.4e-4 as one vector, 4.6e-4 of the largest per tensor: the every-tie
    pool leaves no near-tie to route the gradient another way, unlike the
    plain route's 0.7%); BN statistics within 1e-4 (read: 3.9e-6)."""
    ref = i3d_reference({"kernels": (KERNELS, "float32")})
    model, (loss, got) = port_i3d_step(ref, KERNELS, "float32")
    want_loss, want = ref["kernels"]
    check_float32_step(model, got, want, loss, want_loss, 1e-3, 5e-5, 1e-4)


def test_unit3d_training_on_the_kernel_route_matches_jax():
    """``Unit3D`` training on the pointwise kernel route (no bias, no ReLU in
    the kernel, then BN and ReLU) against the JAX Pallas kernel in
    interpret mode: output, ``dx``, ``dW``, the BN scale and bias
    gradients within 1e-5 of their largest value, the statistics within
    1e-6."""
    rng = np.random.RandomState(8)
    x = rng.randn(2, 4, 6, 6, 16).astype(np.float32)
    r = rng.randn(2, 4, 6, 6, 8).astype(np.float32)
    jmod = JUnit3D(8, (1, 1, 1), use_pallas=True)
    variables = fill_variables(jmod, x.shape, seed=9)

    def loss(params, a):
        y, upd = jmod.apply({"params": params, "batch_stats": variables["batch_stats"]}, a, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(y * r), (y, upd)

    (_, (jy, upd)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        variables["params"], jnp.asarray(x))
    unit = Unit3D(16, 8, use_pallas=True).train()
    unit.load_state_dict(variables_to_state_dict(variables))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = unit(xt)
    gx, gw, gs, gb = torch.autograd.grad(y, [xt, unit.conv3d.weight, unit.bn.weight, unit.bn.bias],
                                         torch.from_numpy(r))
    want = variables_to_state_dict({"params": jgp, "batch_stats": upd["batch_stats"]})
    pairs = [(y, np.asarray(jy)), (gx, np.asarray(jgx)), (gw, want["conv3d.weight"]),
             (gs, want["bn.weight"]), (gb, want["bn.bias"])]
    for got, ref in pairs:
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(unit.bn.running_mean.numpy(), want["bn.running_mean"], atol=1e-6)
    np.testing.assert_allclose(unit.bn.running_var.numpy(), want["bn.running_var"], atol=1e-6)


@pytest.fixture(scope="module")
def clstm_ref():
    jmodel = JClassifier(**CLSTM_KW, dropout_rate=0.0, use_pallas=True)
    variables = fill_variables(jmodel, CLSTM_SHAPE, seed=2)
    rng = np.random.RandomState(3)
    x = rng.rand(*CLSTM_SHAPE).astype(np.float32)
    y = np.array([0, 2, 1, 2], np.int32)
    return variables, x, y, jax_sgd1_step(jmodel, variables, x, y, kernel_l2=0.01)


def _clstm(use_pallas):
    return ConvLSTMClassifier(**CLSTM_KW, use_pallas=use_pallas, input_size=CLSTM_SHAPE[2:4],
                              clip_len=CLSTM_SHAPE[1])


@pytest.mark.parametrize("use_pallas", [True, False], ids=["gate_kernel", "plain"])
def test_convlstm_train_step_matches_jax(clstm_ref, use_pallas):
    """The torch-family ConvLSTM (shared BN updated once per layer and
    step, sigmoid gates) with ``kernel_l2`` 0.01 on ``wx``, against JAX's
    Pallas gate route, the port's gate route and its plain gate math
    alike: loss within 1e-5 (read: 2.4e-7), gradients within 1e-4 (read:
    1.3e-6 as one vector and of the largest per tensor), BN statistics
    within 1e-5 (read: 6e-8)."""
    variables, x, y, (want_loss, want) = clstm_ref
    model = _clstm(use_pallas)
    loss, got = port_sgd1_step(model, variables, x, y, kernel_l2=0.01)
    check_float32_step(model, got, want, loss, want_loss, 1e-4, 1e-5, 1e-5)


@pytest.fixture(scope="module")
def clstm_bf16_ref(clstm_ref):
    """JAX's bf16 train step of the same ConvLSTM, weights and clips."""
    variables, x, y, _ = clstm_ref
    jmodel = JClassifier(**CLSTM_KW, dropout_rate=0.0, use_pallas=True)
    return jax_sgd1_step(jmodel, variables, x, y, "bfloat16", kernel_l2=0.01)


def _scale_output_gate_cotangent(monkeypatch, factor):
    """The control: every gate block's ``z_o`` cotangent times ``factor``
    (on ``gates_x`` and ``gates_h``), on both gate routes."""
    import ivf_tpu_torch.ops.convlstm_cell as cell

    def hooked(fn):
        def block(gates_x, gates_h, c, *args):
            ch = c.shape[-1]

            def scale(g):
                g = g.clone()
                g[..., 3 * ch:] *= factor
                return g

            for t in (gates_x, gates_h):
                if t is not None and t.requires_grad:
                    t.register_hook(scale)
            return fn(gates_x, gates_h, c, *args)

        return block

    monkeypatch.setattr(cell, "gate_math", hooked(cell.gate_math))
    monkeypatch.setattr(cell, "fused_gate_math", hooked(cell.fused_gate_math))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["gate_kernel", "plain"])
def test_convlstm_bf16_train_step_against_jax(clstm_ref, clstm_bf16_ref, use_pallas, monkeypatch):
    """The bf16 ConvLSTM step (bf16 copies of float32 masters, ``kernel_l2``
    0.01) casts the clips to bf16 as JAX's does, so its state is bf16 and
    the gate block runs all in bf16 (``fused_gates.bf16_gate_forward``,
    ``_gate_math_bwd_bf16``; the kernel route and the plain one). Against
    JAX's bf16 step: the gradient within 0.04 as one vector (read: 0.0261
    on the kernel route, 0.0259 plain; with a float32 state it read
    0.185-0.187; JAX's own two gate routes are 0.0093 apart and its bf16
    step is 0.242 from its float32 step). What is left is rounding on the
    CPU: XLA reduces a bf16 cotangent onto a broadcast bf16 parameter one
    bf16 add after another (the first layer's ``bx`` gradient is 26% off),
    where the port sums in float32 and rounds once; and PyTorch's CPU
    bf16 ``rsqrt`` rounds the square root first, an ulp from XLA's on some
    BN variances. The control, every output gate's cotangent times 0.9,
    must fail the limit (read: 0.0971 and 0.0963). Loss within 2e-3 of
    JAX's bf16 loss (read: 9.5e-4; JAX's bf16 and float32 losses are
    6.0e-3 apart); BN statistics within 5e-4 (read: 2.0e-4); float32
    masters and statistics."""
    variables, x, y, _ = clstm_ref
    want_loss, want = clstm_bf16_ref
    model = _clstm(use_pallas)
    loss, got = port_sgd1_step(model, variables, x, y, "bfloat16", kernel_l2=0.01)
    check_bf16_step(model, got, want, loss, want_loss, 2e-3, 5e-4)
    params = [n for n, _ in model.named_parameters()]
    assert grad_gap(got, want, params) < 0.04
    _scale_output_gate_cotangent(monkeypatch, 0.9)
    _, bad = port_sgd1_step(_clstm(use_pallas), variables, x, y, "bfloat16", kernel_l2=0.01)
    assert grad_gap(bad, want, params) > 0.04


def test_kernel_l2_reaches_the_input_kernels_only(clstm_ref):
    """The penalty's gradient is ``2 * 0.01 * wx`` on ``wx`` and nothing on
    ``wh``: the difference of two steps with and without it."""
    variables, x, y, _ = clstm_ref
    model = _clstm(True)
    l_on, on = port_sgd1_step(model, variables, x, y, kernel_l2=0.01)
    l_off, off = port_sgd1_step(model, variables, x, y)
    sd = variables_to_state_dict(variables)
    wx = [n for n in sd if n.endswith(".wx")]
    assert len(wx) == 2
    np.testing.assert_allclose(l_on - l_off, 0.01 * sum(float((sd[n] ** 2).sum()) for n in wx), rtol=1e-4)
    for n in wx:
        np.testing.assert_allclose(on[n] - off[n], 0.02 * sd[n].numpy(), rtol=1e-3, atol=1e-6)
    for n in sd:
        if n.endswith(".wh"):
            np.testing.assert_array_equal(on[n], off[n])


def test_bf16_plain_gate_gradient_matches_jax_where_exp_overflows():
    """The plain bf16 gate block (bf16 gates, float32 state) on
    pre-activations past exp's range (|z| ~ 100, as seeded weights on raw
    0-255 frames give them in training): JAX's gradient is finite (the
    logistic's derivative s(1 - s)); the port's was NaN (the chain rule
    through 1 / (1 + exp(-z))) before ``fused_gates._SigmoidBf16``. Now
    finite everywhere and, on the three sigmoid gates, zero where JAX's is
    zero and within one bf16 ulp of the largest gradient elsewhere (read:
    equal bits on 69 of 72, the rest within 7e-21). The tanh gate's column is the plain route's
    known bf16 divergence (float32 ``1 - tanh**2`` against JAX's
    bf16-rounded ``(1 - o)(1 + o)``, 16% on one element here) and is left
    out."""
    from ivf_tpu.ops.convlstm_cell import fused_gate_math as j_gate_math
    from ivf_tpu_torch.ops.convlstm_cell import fused_gate_math

    rng = np.random.RandomState(12)
    z = (rng.randn(6, 16) * 60).astype(np.float32)
    z[:, ::3] = -120.0
    c = rng.randn(6, 4).astype(np.float32)
    zb = torch.from_numpy(z).bfloat16().requires_grad_(True)
    h, cn = fused_gate_math(zb, None, torch.from_numpy(c))
    (got,) = torch.autograd.grad(h.sum() + cn.sum(), zb)

    def f(zz):
        hh, cc = j_gate_math(zz, None, jnp.asarray(c))
        return hh.sum() + cc.sum()

    want = np.asarray(jax.grad(f)(jnp.asarray(z).astype(jnp.bfloat16)).astype(jnp.float32))
    got = got.float().numpy()
    assert np.isfinite(got).all()
    sig = np.r_[0:8, 12:16]  # the i, f and o gates of 4 hidden units
    got, want = got[:, sig], want[:, sig]
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())


def _bf16_forward_backward(model, sd, clips):
    """Logits, new BN statistics and float32 master gradients of one bf16
    training forward and backward, as ``make_train_step`` runs them."""
    model.load_state_dict(sd)
    model.train()
    params = dict(model.named_parameters())
    compute = {n: p.to(torch.bfloat16) for n, p in params.items()}
    logits = torch.func.functional_call(model, compute, (clips,), strict=False)
    grads = torch.autograd.grad(logits.float().logsumexp(-1).sum(), list(params.values()))
    return [logits.detach(), *grads, *(b.clone() for b in model.buffers())]


@pytest.mark.parametrize("arch", ["i3d_bf16_default", "i3d_bf16_kernels", "cnn_3d"])
def test_bf16_step_clip_cast_keeps_the_bits_of_float32_clips(arch):
    """The bf16 train step now casts uint8 and float32 clips to bf16 before
    the model, as the JAX package's does. I3D's and ``cnn_3d``'s first
    conv rounded a float32 clip to bf16 before, so their logits, BN
    statistics and gradients keep their bits: uint8 pixel values as
    float32 against the same values cast to bf16."""
    shape = (4, 8, 32, 32, 3) if arch.startswith("i3d") else (4, 4, 32, 32, 3)
    if arch == "cnn_3d":
        jmodel = JCNN3D(num_classes=3, dropout_rate=0.0)
        model = CNN3D(num_classes=3, dropout_rate=0.0, input_size=shape[2:4], clip_len=shape[1])
    else:
        flags = dict(pool_impl="argmax") if arch == "i3d_bf16_default" else KERNELS
        jmodel = j_i3d_smth(**I3D_KW, dropout_rate=0.0)
        model = i3d_smth(**I3D_KW, dropout_rate=0.0, **flags)
    sd = variables_to_state_dict(fill_variables(jmodel, shape, seed=5, logit_scale=0.05))
    clips = torch.from_numpy(np.random.RandomState(6).randint(0, 256, shape).astype(np.float32))
    want = _bf16_forward_backward(model, sd, clips)
    got = _bf16_forward_backward(model, sd, clips.bfloat16())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
