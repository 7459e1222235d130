"""ivf_tpu_torch I3D vs the JAX I3D at (1, 8, 32, 32, 3), weights carried
across by ``ivf_tpu_torch.utils.convert``.

The weights are drawn with numpy (BN statistics included, so folding is
exercised) and the logits kernel is scaled so the softmax is not
saturated. Tolerance: the pin of tests/test_models.py for logits (rtol
1e-3 / atol 1e-4); input gradients are compared after dividing both by
the reference's largest magnitude, at atol 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.interpret.gradcam import grad_cam_batched as j_grad_cam_batched
from ivf_tpu.interpret.gradcam import i3d_grad_cam_fns as j_grad_cam_fns
from ivf_tpu.models import I3D as JI3D
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu_torch.interpret.gradcam import grad_cam_batched, i3d_grad_cam_fns
from ivf_tpu_torch.models import I3D as TI3D
from ivf_tpu_torch.models import i3d_smth as t_i3d_smth
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict

SHAPE = (1, 8, 32, 32, 3)
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))


def make_jax_variables(model, shape, seed=0, logit_scale=0.005):
    """Numpy-drawn {'params', 'batch_stats'} for a JAX I3D."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            k = rng.randn(*leaf.shape) * np.sqrt(2.0 / fan_in)
            if any(getattr(p, "key", None) == "logits" for p in path):
                k = k * logit_scale
            return k.astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)  # bias, mean

    return jax.tree_util.tree_map_with_path(fill, tree)


def _port(sd, **kw):
    model = t_i3d_smth(**SMALL, **kw)
    model.load_state_dict(sd)
    return model.eval()


@pytest.fixture(scope="module")
def ref():
    """JAX logits and input gradients on the default XLA path and on the
    Pallas path (pointwise + branch-3 pool kernels, interpret mode)."""
    base = j_i3d_smth(**SMALL, dropout_rate=0.0)
    variables = make_jax_variables(base, SHAPE)
    x = np.random.RandomState(1).uniform(0, 255, SHAPE).astype(np.float32)
    r = np.random.RandomState(2).randn(5).astype(np.float32)
    out = {"variables": variables, "x": x, "r": r, "sd": i3d_variables_to_state_dict(variables)}
    for key, flags in (("xla", {}), ("pallas", dict(use_pallas=True, pallas_pool=True))):
        out[key] = _jax_logits_and_grad(flags, variables, x, r)
    return out


def _jax_logits_and_grad(flags, variables, x, r):
    model = j_i3d_smth(**SMALL, dropout_rate=0.0, **flags)

    def score(v, a):
        logits = model.apply(v, a)
        return (logits[0] * r).sum(), logits

    (_, logits), grad = jax.jit(jax.value_and_grad(score, argnums=1, has_aux=True))(
        variables, jnp.asarray(x)
    )
    return np.asarray(logits), np.asarray(grad)


def _port_logits_and_grad(model, x, r):
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    (grad,) = torch.autograd.grad(logits, xt, torch.from_numpy(r)[None])
    return logits.detach().numpy(), grad.numpy()


def test_converted_state_dict_is_exactly_the_port_model_state(ref):
    model = t_i3d_smth(**SMALL)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ref["sd"].items()}
    assert got == want
    assert ref["sd"]["Mixed_3b.b1b.conv3d.weight"].shape == (128, 96, 3, 3, 3)
    np.testing.assert_array_equal(
        ref["sd"]["Mixed_3b.b0.bn.running_var"].numpy(),
        ref["variables"]["batch_stats"]["Mixed_3b"]["b0"]["bn"]["var"],
    )


@pytest.mark.parametrize(
    "flags",
    [
        {},
        dict(fold_bn=False, fuse_1x1=False),
        dict(use_pallas=True),
        dict(pallas_pool=True),
        dict(use_pallas=True, pallas_pool=True),
        dict(stem_s2d=True),
        dict(stem_s2d=False),
    ],
    ids=["xla", "unfolded", "pointwise", "pool", "both", "s2d_stem", "plain_stem"],
)
def test_i3d_logits_and_input_grad_match_jax(ref, flags):
    """Flags off: against the JAX default path. With the pool kernel on:
    against the JAX Pallas path, whose every-tie pool backward is the
    same rule (see the next test for why the two paths differ). The JAX
    model runs its default space-to-depth stem; the port's stem either
    way (``stem_s2d``, on by default) is held to it."""
    logits, grad = _port_logits_and_grad(_port(ref["sd"], **flags), ref["x"], ref["r"])
    want_logits, want_grad = ref["pallas" if flags.get("pallas_pool") else "xla"]
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=1e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(grad / scale, want_grad / scale, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("variant", [True, "tblock"], ids=["frame", "tblock"])
def test_fused_branch3_logits_and_input_grad_match_jax(ref, variant):
    """``fuse_pool_conv``: against JAX ``I3D(fuse_pool_conv=...)``, whose
    fused Pallas kernels run in interpret mode. The converted state dict
    loads unchanged (b3b keeps its conv3d/bn names and is folded at run
    time). The fused branch has the pool kernel's every-tie rule, so the
    gradient also matches the JAX Pallas pool path."""
    flags = dict(fuse_pool_conv=variant)
    want_logits, want_grad = _jax_logits_and_grad(flags, ref["variables"], ref["x"], ref["r"])
    logits, grad = _port_logits_and_grad(_port(ref["sd"], **flags), ref["x"], ref["r"])
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=1e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(grad / scale, want_grad / scale, rtol=1e-3, atol=1e-4)
    _, pool_grad = ref["pallas"]
    np.testing.assert_allclose(grad / scale, pool_grad / scale, rtol=1e-3, atol=1e-4)


def test_pool_kernel_tie_rule_moves_the_input_gradient_in_both_packages(ref):
    """The branch-3 pool kernel credits EVERY tied maximum. The stride-2
    trunk pools with window 3 (MaxPool3d_3a/4a) copy each maximum into
    neighbouring outputs, so the next Inception block's branch-3 pool sees
    positive ties everywhere, and a window with k tied maxima hands out k
    times its gradient (see the plateau test in tests/test_torch_ops.py).
    The input gradient grows far beyond the default path's, in the JAX
    reference and, identically, in the port. Logits are unchanged."""
    (lx, gx), (lp, gp) = ref["xla"], ref["pallas"]
    np.testing.assert_allclose(lp, lx, rtol=1e-3, atol=1e-4)
    gap = np.abs(gp - gx).max() / np.abs(gx).max()
    assert gap > 0.1
    _, port_off = _port_logits_and_grad(_port(ref["sd"]), ref["x"], ref["r"])
    _, port_on = _port_logits_and_grad(_port(ref["sd"], pallas_pool=True), ref["x"], ref["r"])
    port_gap = np.abs(port_on - port_off).max() / np.abs(port_off).max()
    np.testing.assert_allclose(port_gap, gap, rtol=1e-3)


def test_head_options_match_jax(ref):
    """stride_mod_layers / last_stride (T' = 2 at Mixed_5c), temporal_mean
    and last_relu='relu', with the softmax head."""
    kw = dict(
        stride_mod_layers=("MaxPool3d_5a_2x2",), last_stride=1, temporal_mean=True,
        last_relu="relu", softmax=True,
    )
    jmodel = j_i3d_smth(**SMALL, dropout_rate=0.0, **kw)
    want = np.asarray(jax.jit(jmodel.apply)(ref["variables"], jnp.asarray(ref["x"])))
    got = _port(ref["sd"], **kw)(torch.from_numpy(ref["x"])).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)
    assert np.isclose(got.sum(), 1.0, atol=1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(stride_mod_layers=("MaxPool3d_4a_3x3", "MaxPool3d_5a_2x2"), last_stride=1),
        dict(stride_mod_layers=("Conv3d_1a_7x7",), last_stride=2),
        dict(pool_shape=(2, 4, 5)),
    ],
)
def test_logits_pool_shape_matches_jax(kw):
    assert TI3D(**kw).logits_pool_shape() == JI3D(**kw).logits_pool_shape()


@pytest.mark.parametrize(
    "endpoint,per_frame", [("Mixed_4f", True), ("Mixed_5c", False)]
)
def test_i3d_grad_cam_matches_jax(ref, endpoint, per_frame):
    """Batched Grad-CAM (trunk/head split at ``endpoint``) on two clips.
    Mixed_4f is (2, 2, 2) at this input size: bilinear upsampling, the
    temporal repeat and the per-frame normalization are exercised;
    Mixed_5c is 1x1x1, whose constant map normalizes to exact zeros in
    both. CAMs
    live in [0, 1]; atol 1e-4 covers float drift through the trunk."""
    jmodel = j_i3d_smth(**SMALL, dropout_rate=0.0, softmax=True)
    clips = np.random.RandomState(3).uniform(0, 255, (2,) + SHAPE[1:]).astype(np.float32)
    targets = np.array([1, 3])
    ffn, hfn = j_grad_cam_fns(jmodel, ref["variables"], endpoint)
    want, want_scores = jax.jit(
        lambda c, t: j_grad_cam_batched(ffn, hfn, c, t, normalize_per_frame=per_frame)
    )(jnp.asarray(clips), jnp.asarray(targets))
    model = _port(ref["sd"], softmax=True)
    got, scores = grad_cam_batched(
        *i3d_grad_cam_fns(model, endpoint), torch.from_numpy(clips), torch.from_numpy(targets),
        normalize_per_frame=per_frame,
    )
    assert got.shape == (2, 8, 32, 32)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if endpoint == "Mixed_4f":
        assert got.max() == 1.0 and got.min() == 0.0
