"""The port's training step against the JAX package's, on the CPU.

One train step of I3D (plain, and the bfloat16 default route with the
argmax pool) and of ``cnn_3d`` (float32 and bfloat16), from the same
numpy-drawn weights and clips, through ``ivf_tpu.train.make_train_step``
and ``ivf_tpu_torch.train.make_train_step`` with dropout 0 (``jax.random``
draws are not reproduced). Both take one SGD step with lr 1 and no
momentum, so ``p - p_new`` is the gradient; the loss, every gradient and
the BN running statistics are compared. Also: training-mode BatchNorm and
the port's dropout. The kernel routes (I3D ``use_pallas`` + ``pallas_pool``,
``Unit3D``'s pointwise route, the ConvLSTM's gate kernel) are in
``tests/test_torch_train_kernels.py``, which uses the helpers here.

Conditioning. Training-mode BN normalizes over B*T*H*W values per
channel, few at this size (4 at I3D's Mixed_5c), and a seeded deep
network with training BN amplifies rounding: the port's own float32 I3D
step against float64 differs by 0.66% (global relative L2) on the plain
route. In bfloat16 that amplification leaves a whole network's gradient
mostly rounding noise: JAX's own bf16 I3D step is 119% from its float32
one at 4x8x32x32 and still 113% at 8x16x64x64, ``cnn_3d``'s 31% at both
4x4x32x32 and 8x4x64x64 (the channel-mean head hands every channel the
same cotangent, which training BN's backward mostly cancels). So the
whole bf16 steps are held where they are well conditioned (loss, BN
statistics, float32 masters, gradient norms, and for ``cnn_3d`` the
gradient's distance to float32), and the bf16 backward's direction is
held per Inception block at the Mixed_4b and Mixed_5c sites, where BN sees
196-392 values a channel and JAX's own bf16 gradient is 7% from float32
(``test_i3d_bf16_training_block_matches_jax``). Each test states its
tolerances against these measures.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.models import CNN3D as JCNN3D
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.models.layers import InceptionModule as JInception
from ivf_tpu.models.layers import TorchBatchNorm as JBN
from ivf_tpu.train import build_optimizer as j_build_optimizer
from ivf_tpu.train import create_train_state as j_create_train_state
from ivf_tpu.train import make_train_step as j_make_train_step
from ivf_tpu_torch.models import CNN3D, ConvLSTMClassifier, i3d_smth
from ivf_tpu_torch.models.layers import Dropout, InceptionModule, TorchBatchNorm, set_dropout_generator
from ivf_tpu_torch.train import build_optimizer, create_train_state, make_train_step, step_generator
from ivf_tpu_torch.utils.convert import variables_to_state_dict

I3D_SHAPE = (4, 8, 32, 32, 3)  # batch 4: at batch 2 Mixed_5c's BN sees 2 values and passes no gradient
I3D_KW = dict(num_classes=5, pool_shape=(1, 1, 1))
CLSTM_KW = dict(
    num_classes=3, nb_lstm_units=4, lstm_layers=2, conv_stride=2, effective_steps=(2, 5),
    recurrent_activation="sigmoid",
)
CNN_SHAPE = (4, 4, 32, 32, 3)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's steps many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fill_variables(model, shape, seed=0, logit_scale=1.0):
    """Numpy-drawn ``{'params', 'batch_stats'}`` for a JAX model: He-scaled
    kernels (the classifier head's times ``logit_scale``), BN scales and
    variances in [0.5, 1.5], small biases and means."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def fill(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] in ("kernel", "wx", "wh"):
            k = rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            if any(n in ("logits", "end_fc", "fc") for n in names):
                k = k * logit_scale
            return k.astype(np.float32)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def jax_sgd1_step(jmodel, variables, x, y, compute_dtype="float32", kernel_l2=0.0):
    """JAX ``make_train_step`` with SGD lr 1: (loss, gradients as the
    port's state dict, new BN statistics as the port's state dict)."""
    tx = j_build_optimizer("sgd", 1.0, momentum=0.0)
    state = j_create_train_state(jmodel, jax.random.PRNGKey(0), jnp.asarray(x[:1]), tx, variables)
    step = j_make_train_step(donate=False, kernel_l2=kernel_l2, compute_dtype=compute_dtype)
    new, metrics = step(state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b), state.params, new.params)
    tree = {"params": grads, "batch_stats": jax.device_get(new.batch_stats)}
    return float(metrics["loss"]), {k: v.numpy() for k, v in variables_to_state_dict(tree).items()}


def port_sgd1_step(model, variables, x, y, compute_dtype="float32", kernel_l2=0.0):
    """The same step through the port: (loss, gradients and new BN
    statistics by state-dict name)."""
    model.load_state_dict(variables_to_state_dict(variables))
    state = create_train_state(model, build_optimizer("sgd", 1.0, momentum=0.0))
    before = {n: p.detach().clone() for n, p in state.params().items()}
    step = make_train_step(kernel_l2=kernel_l2, compute_dtype=compute_dtype)
    state, metrics = step(state, torch.from_numpy(x), torch.from_numpy(y))
    out = {n: (before[n] - p.detach()).numpy() for n, p in state.params().items()}
    out.update({n: b.numpy() for n, b in state.batch_stats().items()})
    return float(metrics["loss"]), out


def grad_gap(got: dict, want: dict, names) -> float:
    """Relative L2 distance of the gradients ``names`` as one vector."""
    num = sum(float(((got[n] - want[n]) ** 2).sum()) for n in names)
    den = sum(float((want[n] ** 2).sum()) for n in names)
    return float(np.sqrt(num / den))


def _i3d_inputs():
    x = np.random.RandomState(1).randn(*I3D_SHAPE).astype(np.float32)
    return x, np.array([1, 3, 0, 4], np.int32)


I3D_ROUTES = {
    "plain": (dict(), "float32"),
    "bf16_default": (dict(pool_impl="argmax"), "bfloat16"),
}


@pytest.fixture(scope="module")
def i3d_ref():
    """One JAX train step per I3D route (the float32 plain step is also the
    one the bfloat16 step is measured against), from one set of weights."""
    return i3d_reference(I3D_ROUTES)


def i3d_reference(routes):
    variables = fill_variables(j_i3d_smth(**I3D_KW, dropout_rate=0.0), I3D_SHAPE, logit_scale=0.05)
    x, y = _i3d_inputs()
    out = {"variables": variables, "x": x, "y": y}
    for route, (flags, dtype) in routes.items():
        out[route] = jax_sgd1_step(j_i3d_smth(**I3D_KW, dropout_rate=0.0, **flags), variables, x, y, dtype)
    return out


def port_i3d_step(i3d_ref, flags, dtype):
    model = i3d_smth(**I3D_KW, dropout_rate=0.0, **flags)
    return model, port_sgd1_step(model, i3d_ref["variables"], i3d_ref["x"], i3d_ref["y"], dtype)


def _port_i3d(i3d_ref, route):
    flags, dtype = I3D_ROUTES[route]
    model = i3d_smth(**I3D_KW, dropout_rate=0.0, **flags)
    return model, port_sgd1_step(model, i3d_ref["variables"], i3d_ref["x"], i3d_ref["y"], dtype)


def check_float32_step(model, got, want, loss, want_loss, grad_tol, loss_tol, stat_tol):
    """Loss within ``loss_tol``; the gradients within ``grad_tol`` as one
    vector and each tensor within ``grad_tol`` of the largest gradient;
    the BN statistics within ``stat_tol``."""
    assert abs(loss - want_loss) < loss_tol, (loss, want_loss)
    params = [n for n, _ in model.named_parameters()]
    gap = grad_gap(got, want, params)
    assert gap < grad_tol, gap
    scale = max(np.abs(want[n]).max() for n in params)
    for n in params:
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=grad_tol * scale, err_msg=n)
    for n, _ in model.named_buffers():
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=stat_tol, err_msg=n)


def check_bf16_step(model, got, want, loss, want_loss, loss_tol, stat_tol):
    """Loss within ``loss_tol`` of JAX's bf16 step, the BN statistics within
    ``stat_tol`` of its; every gradient finite; the float32 masters and BN
    statistics stay float32."""
    assert abs(loss - want_loss) < loss_tol, (loss, want_loss)
    for n, _ in model.named_buffers():
        np.testing.assert_allclose(got[n], want[n], rtol=0, atol=stat_tol, err_msg=n)
    assert all(np.isfinite(got[n]).all() for n, _ in model.named_parameters())
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(b.dtype == torch.float32 for b in model.buffers())


def grad_norm_ratios(got: dict, want: dict, names) -> dict:
    """Per top-level module, the norm of ``got``'s gradients over ``want``'s."""
    ratios = {}
    for mod in dict.fromkeys(n.split(".")[0] for n in names):
        part = [n for n in names if n.split(".")[0] == mod]
        ratios[mod] = np.sqrt(sum(float((got[n] ** 2).sum()) for n in part)
                              / sum(float((want[n] ** 2).sum()) for n in part))
    return ratios


def test_i3d_train_step_matches_jax_float32(i3d_ref):
    """Plain route: loss within 5e-5 (read: 6.8e-6); the gradients within
    2% (read: 0.70% as one vector, 0.80% of the largest per tensor; the
    port's own float32 step is 0.66% from float64); BN statistics within
    1e-4 (read: 3.8e-6)."""
    model, (loss, got) = _port_i3d(i3d_ref, "plain")
    want_loss, want = i3d_ref["plain"]
    check_float32_step(model, got, want, loss, want_loss, 0.02, 5e-5, 1e-4)


def test_i3d_train_step_matches_jax_bfloat16(i3d_ref):
    """The bfloat16 default route (argmax pool, bf16 compute copy of float32
    masters), whole step against JAX's bf16 step: loss within 0.01 (read:
    3.2e-3), BN statistics within 0.05 (read: 0.019, Mixed_5c's running
    variances, where BN sees 4 values), float32 masters and statistics,
    every gradient finite, and each module's gradient norm within [0.6,
    1.5] of JAX's (read: 1.00 at the logits, 0.69-0.89 below; with other
    labels 1.04-1.23). The control, Mixed_4b's output cotangent halved,
    must leave the band (read: 0.34-0.37 on every module up to Mixed_4b).
    The direction of a whole
    bf16 I3D gradient is rounding noise at any size this test can afford
    (the port's is 104% from JAX's bf16 gradient, JAX's own 155% from
    float32; module docstring); it is held per block in
    ``test_i3d_bf16_training_block_matches_jax``."""
    model, (loss, got) = _port_i3d(i3d_ref, "bf16_default")
    want_loss, want = i3d_ref["bf16_default"]
    check_bf16_step(model, got, want, loss, want_loss, 0.01, 0.05)
    params = [n for n, _ in model.named_parameters()]
    ratios = grad_norm_ratios(got, want, params)
    assert all(0.6 <= r <= 1.5 for r in ratios.values()), ratios
    flags, dtype = I3D_ROUTES["bf16_default"]
    control = i3d_smth(**I3D_KW, dropout_rate=0.0, **flags)
    control.Mixed_4b.register_forward_hook(lambda mod, args, out: out.register_hook(lambda g: g * 0.5) and None)
    _, bad = port_sgd1_step(control, i3d_ref["variables"], i3d_ref["x"], i3d_ref["y"], dtype)
    assert not all(0.6 <= r <= 1.5 for r in grad_norm_ratios(bad, want, params).values())


# (site, input shape, out_channels): Mixed_4b as at 16x224x224 input with
# batch 2 and 4 frames (392 values a channel), Mixed_5c with batch 4 and
# 2 frames (196)
BLOCK_SITES = {
    "Mixed_4b": ((2, 4, 14, 14, 480), (192, 96, 208, 16, 48, 64)),
    "Mixed_5c": ((4, 2, 7, 7, 832), (384, 192, 384, 48, 128, 128)),
}
BLOCK_ROUTES = {"bf16_default": dict(pool_impl="argmax"), "bf16_kernels": dict(use_pallas=True, pallas_pool=True)}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("route", list(BLOCK_ROUTES))
@pytest.mark.parametrize("site", list(BLOCK_SITES))
def test_i3d_bf16_training_block_matches_jax(site, route):
    """One Inception block in training mode as the bf16 train step runs it
    (bf16 copies of float32 masters, a bf16 input, training BN with float32
    running statistics; the argmax branch-3 pool on the default route, the
    pointwise kernel with no bias and no ReLU and the every-tie pool pair on
    the kernel route, JAX's Pallas kernels in interpret mode), against
    JAX's under ``jax.jit``, loss ``sum(y * r)``: y within 0.6% (read:
    0.15-0.30%; JAX's own bf16 block is 0.7% from float32), dx within 3.2%
    (read: 1.8-2.6%), the parameter gradients within 5% as one vector
    (read: 2.3-3.6%; JAX's own 7%) and each tensor's gradient norm within
    5% of JAX's (read: 0.970-1.022), BN statistics within 5e-4 (read:
    2.1e-4). The control, b1b's output cotangent scaled by 0.9 inside the
    port's block (a 10% error in one branch's dx), must fail the dx and
    gradient limits (read: dx 5.9-6.7%, gradients 9.0-9.7%)."""
    shape, oc = BLOCK_SITES[site]
    flags = BLOCK_ROUTES[route]
    jmod = JInception(oc, **flags)
    variables = fill_variables(jmod, shape, seed=9)
    rng = np.random.RandomState(8)
    x = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape[:-1], oc[0] + oc[2] + oc[4] + oc[5]).astype(np.float32)

    def loss(params, a):
        p = jax.tree.map(lambda t: t.astype(jnp.bfloat16), params)
        y, upd = jmod.apply({"params": p, "batch_stats": variables["batch_stats"]}, a.astype(jnp.bfloat16),
                            train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * r), (y, upd)

    (_, (jy, upd)), (jgp, jgx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], jnp.asarray(x))
    stats = jax.tree.map(lambda a: a.astype(jnp.float32), upd["batch_stats"])
    want = {k: v.numpy() for k, v in variables_to_state_dict({"params": jgp, "batch_stats": stats}).items()}
    def port_block(control):
        block = InceptionModule(shape[-1], oc, **flags).train()
        block.load_state_dict(variables_to_state_dict(variables))
        if control:
            block.b1b.register_forward_hook(lambda mod, args, out: out.register_hook(lambda g: g * 0.9) and None)
        params = dict(block.named_parameters())
        xt = torch.from_numpy(x).requires_grad_(True)
        compute = {n: p.to(torch.bfloat16) for n, p in params.items()}
        y = torch.func.functional_call(block, compute, (xt.bfloat16(),), strict=False)
        grads = torch.autograd.grad((y.float() * torch.from_numpy(r)).sum(), [xt] + list(params.values()))
        got = {n: g.numpy() for n, g in zip(params, grads[1:])}
        return block, y.float().detach().numpy(), grads[0].numpy(), got

    block, y, dx, got = port_block(control=False)
    names = [n for n, _ in block.named_parameters()]
    assert _rel(y, np.asarray(jy.astype(jnp.float32))) < 0.006
    assert _rel(dx, np.asarray(jgx)) < 0.032
    assert grad_gap(got, want, names) < 0.05
    for n in names:
        assert abs(np.linalg.norm(got[n]) / np.linalg.norm(want[n]) - 1) < 0.05, n
    for n, b in block.named_buffers():
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.numpy(), want[n], rtol=0, atol=5e-4, err_msg=n)
    _, _, dx, got = port_block(control=True)
    assert _rel(dx, np.asarray(jgx)) > 0.032 and grad_gap(got, want, names) > 0.05


@pytest.fixture(scope="module")
def cnn_ref():
    """JAX ``cnn_3d`` steps in float32 and bfloat16 from one set of weights."""
    jmodel = JCNN3D(num_classes=3, dropout_rate=0.0)
    variables = fill_variables(jmodel, CNN_SHAPE, seed=4, logit_scale=0.2)
    x = np.random.RandomState(5).randn(*CNN_SHAPE).astype(np.float32)
    y = np.array([0, 1, 2, 1], np.int32)
    steps = {dt: jax_sgd1_step(jmodel, variables, x, y, dt) for dt in ("float32", "bfloat16")}
    return variables, x, y, steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cnn3d_train_step_matches_jax(cnn_ref, dtype):
    """``cnn_3d`` (temporal SAME average pool, channel-mean head). float32:
    loss within 1e-5 (read: 1.2e-7), gradients within 1e-4 (read: 7.0e-6
    as one vector, 8.0e-7 of the largest per tensor), BN statistics within
    1e-5 (read: 1.2e-7). bfloat16, against JAX's bf16 step: loss within
    1e-3 (read: 7.4e-5), BN statistics within 1e-3 (read: 3.8e-4); the
    gradient no further from JAX's float32 gradient than 1.1x JAX's own
    bf16 gradient is (read: 0.298 against 0.312; the port's gradient
    halved reads 0.546, a zero one 1.0) and within 0.3 of JAX's bf16
    gradient (read: 0.244)."""
    variables, x, y, steps = cnn_ref
    model = CNN3D(num_classes=3, dropout_rate=0.0, input_size=CNN_SHAPE[2:4], clip_len=CNN_SHAPE[1])
    loss, got = port_sgd1_step(model, variables, x, y, dtype)
    want_loss, want = steps[dtype]
    if dtype == "float32":
        check_float32_step(model, got, want, loss, want_loss, 1e-4, 1e-5, 1e-5)
        return
    check_bf16_step(model, got, want, loss, want_loss, 1e-3, 1e-3)
    params = [n for n, _ in model.named_parameters()]
    f32 = steps["float32"][1]
    assert grad_gap(got, f32, params) < 1.1 * grad_gap(want, f32, params)
    assert grad_gap(got, want, params) < 0.3
    halved = {n: 0.5 * g for n, g in got.items()}
    assert grad_gap(halved, f32, params) > 1.1 * grad_gap(want, f32, params)


def test_cnn3d_eval_logits_match_jax(cnn_ref):
    """Eval mode (BN folded, dropout off): logits rtol 1e-4 / atol 1e-5."""
    variables, x, _, _ = cnn_ref
    jmodel = JCNN3D(num_classes=3, dropout_rate=0.5)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x)))
    model = CNN3D(num_classes=3, input_size=CNN_SHAPE[2:4], clip_len=CNN_SHAPE[1])
    model.load_state_dict(variables_to_state_dict(variables))
    got = model.eval()(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps,momentum", [(1e-3, 0.01), (1e-5, 0.1)])
def test_batchnorm_training_matches_jax(dtype, eps, momentum):
    """Training-mode BN: batch mean, biased variance for the output, the
    unbiased one into the running variance, torch's momentum. Output and
    running statistics float32 within 1e-5; bfloat16 (bf16 input and
    affine parameters, float32 statistics) within one bf16 ulp of the
    output's scale (2**-7 relative) and the statistics within momentum x
    2**-6 of the largest batch statistic: they take the batch's bf16
    statistics times the momentum, and one bf16 ulp flips where the two
    packages' float32 sums round apart (read: 2.4e-4 at momentum 0.01, one
    ulp of a batch variance of ~6 times 0.01)."""
    rng = np.random.RandomState(7)
    x = (3.0 + 2.0 * rng.randn(4, 3, 5, 5, 6)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.randn(6).astype(np.float32)
    mean, var = rng.randn(6).astype(np.float32), rng.uniform(0.5, 1.5, 6).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = {"scale": jnp.asarray(scale, jdt), "bias": jnp.asarray(bias, jdt)}
    y, upd = JBN(eps=eps, momentum=momentum).apply(
        {"params": params, "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}},
        jnp.asarray(x, jdt), train=True, mutable=["batch_stats"],
    )
    tdt = getattr(torch, dtype)
    bn = TorchBatchNorm(6, eps, momentum).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    bn.weight.data, bn.bias.data = bn.weight.data.to(tdt), bn.bias.data.to(tdt)
    got = bn(torch.from_numpy(x).to(tdt)).float().detach().numpy()
    want = np.asarray(y.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        stat_tol = 1e-5
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0**-7 * np.abs(want).max())
        axes = (0, 1, 2, 3)
        stat_tol = momentum * 2.0**-6 * max(np.abs(x.mean(axes)).max(), x.var(axes, ddof=1).max())
    assert bn.running_mean.dtype == torch.float32
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=stat_tol)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=stat_tol)


def test_training_unfolds_and_eval_folds():
    """BN folds into the conv in eval mode only; the fused 1x1 trio and
    branch 3 are off in training (``ivf_tpu/models/layers.py:205``)."""
    model = i3d_smth(**I3D_KW, use_pallas=True, fuse_pool_conv=True)
    assert model.Mixed_3b.b0.folding
    model.train()
    assert not model.Mixed_3b.b0.folding and not model.Conv3d_1a_7x7.folding


def test_dropout_keep_rate_scale_and_draws():
    """flax semantics: keep with probability 1 - p (read within 4 sigma of a
    binomial), kept values scaled by exactly 1 / (1 - p); the same (seed,
    step) gives the same mask, another step another; identity in eval;
    training without a generator raises."""
    p, n = 0.3, 100_000
    drop = Dropout(p).train()
    x = torch.full((n,), 2.0)
    drop.generator = step_generator(11, 5, "cpu")
    a = drop(x)
    kept = a != 0
    sigma = np.sqrt(n * p * (1 - p))
    assert abs(int(kept.sum()) - n * (1 - p)) < 4 * sigma
    assert torch.equal(a[kept], torch.full((int(kept.sum()),), 2.0 / (1 - p)))
    drop.generator = step_generator(11, 5, "cpu")
    assert torch.equal(drop(x), a)
    drop.generator = step_generator(11, 6, "cpu")
    assert not torch.equal(drop(x), a)
    drop.generator = step_generator(12, 5, "cpu")
    assert not torch.equal(drop(x), a)
    assert torch.equal(drop.eval()(x), x)
    drop.train().generator = None
    with pytest.raises(RuntimeError):
        drop(x)


def test_models_draw_dropout_in_training_only():
    """I3D (before the logits conv), the torch-family ConvLSTM (per layer
    and step) and ``cnn_3d`` draw masks from the step generator in
    training: two steps' generators give two outputs, equal generators
    equal ones; eval ignores dropout."""
    clip = torch.from_numpy(np.random.RandomState(10).rand(2, 6, 24, 24, 3).astype(np.float32))
    models = [
        ConvLSTMClassifier(**CLSTM_KW, dropout_rate=0.5, input_size=(24, 24), clip_len=6),
        CNN3D(num_classes=3, dropout_rate=0.5, input_size=(24, 24), clip_len=6),
        i3d_smth(num_classes=5, dropout_rate=0.5, pool_shape=(1, 1, 1)),
    ]
    for model in models:
        model.reset_parameters(torch.Generator().manual_seed(0))
        inp = clip if not hasattr(model, "Mixed_5c") else torch.randn(2, 8, 32, 32, 3)
        outs = []
        for step in (0, 0, 1):
            set_dropout_generator(model, step_generator(3, step, "cpu"))
            outs.append(model.train()(inp).detach())
        assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2]), type(model).__name__
        set_dropout_generator(model, None)
        e1, e2 = model.eval()(inp), model(inp)
        assert torch.equal(e1, e2)
