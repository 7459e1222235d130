"""Every ``pool_impl`` of the port (``ivf_tpu_torch/ops/conv.py::
max_pool3d_same``) against the JAX package's (``ivf_tpu/ops/conv.py:
150-445``), on the CPU.

Ops: each impl x {float32, bfloat16} at the geometries of
``tests/test_ops.py:455-680`` (the branch pool, every trunk pool, odd
sizes), on ReLU-ed values on a quarter grid, so ties are everywhere (zeros
meet the zero padding at every border, equal values inside windows). The
forward and the input gradient of a seeded cotangent (``jax.vjp`` under
``jax.jit``) are equal bit for bit, bfloat16 included (XLA's CPU fusions
round these bfloat16 adds as the port does): each impl has the same tie
rule in both packages
(first maximum, largest key, every tie, 0.5 / 0.5 per pairwise max), and
the backwards add in the same order. The one exception the test allows is
``shift``'s: its slice gradients reach the input through autograd's
accumulation in the port and XLA's adds in JAX, in an order neither
package fixes, so float32 may differ by rounding (``SHIFT_TOL``, 1e-6 of
the largest gradient; equal bits measured).

I3D (SMALL, 1x8x32x32, float32): the logits and the input gradient of each
impl against the JAX model's with the same impl, at the tolerances of
``tests/test_torch_model.py`` (logits rtol 1e-3 / atol 1e-4, gradient atol
1e-4 of its largest value). In float32 ``argmax``/``argmax_full`` are
``reduce_window`` and ``argmax_shift`` is ``shift``, so three JAX programs
serve six cases; each is computed once per module.

``find_masks`` per impl in bfloat16 (SMALL I3D, 4 clips of 8x32x32, 4
steps): finite masks in [0, 1], the scores of the forward equal across
impls (the forward values do not depend on the impl), and masks within
``MASK_TOL`` of the default bfloat16 route's (another tie rule only; the
tolerance of the pool-kernel route, ``tests/test_torch_api.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu_torch.api as tapi
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.ops.conv import max_pool3d_same as j_pool
from ivf_tpu_torch.config import POOL_IMPLS
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.models import i3d_smth as t_i3d_smth
from ivf_tpu_torch.ops.conv import max_pool3d_same as t_pool
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
GEOMETRIES = [  # (B, T, H, W, C), window, strides
    ((2, 8, 14, 14, 32), (3, 3, 3), (1, 1, 1)),  # branch-3 pools
    ((2, 8, 28, 28, 16), (1, 3, 3), (1, 2, 2)),  # pool 2a / 3a
    ((2, 8, 14, 14, 16), (3, 3, 3), (2, 2, 2)),  # pool 4a
    ((2, 7, 15, 15, 8), (2, 2, 2), (2, 2, 2)),  # pool 5a, odd sizes
    ((1, 16, 9, 9, 8), (3, 3, 3), (1, 2, 2)),  # a spool with temporal stride 1
    ((1, 7, 9, 11, 3), (3, 3, 3), (2, 2, 2)),  # asymmetric SAME
    ((1, 5, 6, 4, 2), (3, 3, 3), (1, 1, 1)),  # T, H, W below the window's reach
]
SHIFT_TOL = 1e-6
MASK_TOL = 0.05
SHAPE = (1, 8, 32, 32, 3)
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
# the JAX program each impl runs in float32 (the argmax impls act in 16 bits)
F32_EQUIVALENT = {"reduce_window": "reduce_window", "argmax": "reduce_window", "argmax_full": "reduce_window",
                  "shift": "shift", "argmax_shift": "shift", "eqbwd": "eqbwd"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: where test workers share the
    cores, threads that wait on each other make the port's runs many times
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tied(shape, seed):
    """ReLU-ed values on a quarter grid: exact in bfloat16, tied often."""
    rng = np.random.RandomState(seed)
    return np.maximum(np.round(rng.randn(*shape) * 4) / 4, 0).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", POOL_IMPLS)
@pytest.mark.parametrize("shape,window,strides", GEOMETRIES)
def test_pool_impl_matches_jax_with_ties(shape, window, strides, impl, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _tied(shape, 0)
    pool = lambda a: j_pool(a, window, strides, impl)  # noqa: E731

    @jax.jit
    def pool_and_vjp(a, g):
        y, vjp = jax.vjp(pool, a)
        return y, vjp(g)[0]

    y_shape = jax.eval_shape(pool, jnp.asarray(x, jdt)).shape
    g = np.random.RandomState(1).randn(*y_shape).astype(np.float32)
    y_j, dx_j = pool_and_vjp(jnp.asarray(x, jdt), jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y_t = t_pool(xt, window, strides, impl)
    y_t.backward(torch.from_numpy(g).to(tdt))
    assert y_t.dtype == tdt and xt.grad.dtype == tdt
    np.testing.assert_array_equal(y_t.detach().float().numpy(), np.asarray(y_j, np.float32))
    got, want = xt.grad.float().numpy(), np.asarray(dx_j, np.float32)
    if impl in ("shift", "argmax_shift") and dtype == "float32":
        assert np.abs(got - want).max() <= SHIFT_TOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


def test_shift_splits_ties_as_jax_does():
    """Zeros meet the zero padding at every border and fill whole windows:
    ``torch.maximum`` gives half the gradient to each side of a tie, as
    ``lax.max``'s balanced rule does, so both packages' gradients carry the
    same halves, quarters and eighths."""
    x = np.zeros((1, 4, 5, 5, 2), np.float32)
    x[0, 1, 2, 2, 0] = 1.0
    for window, strides in (((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (2, 2, 2))):
        _, vjp = jax.vjp(lambda a: j_pool(a, window, strides, "shift"), jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_()
        y = t_pool(xt, window, strides, "shift")
        y.backward(torch.ones_like(y))
        (want,) = vjp(jnp.ones(y.shape, jnp.float32))
        got = xt.grad.numpy()
        np.testing.assert_array_equal(got, np.asarray(want))
        frac = got[got != 0] % 1
        assert (frac != 0).any()  # split ties: fractions of a window's gradient


@pytest.mark.parametrize("impl", ["argmax", "argmax_full", "argmax_shift"])
def test_argmax_impls_route_bf16_branch_pools_to_the_kernel_wrapper(impl, monkeypatch):
    """In bfloat16 the stride-1 pools of every argmax impl go through the
    argmax pool's wrapper (a CUDA kernel on the card); float32 never
    does."""
    from ivf_tpu_torch.ops import conv

    calls = []
    wrapped = conv.argmax_pool
    monkeypatch.setattr(conv, "argmax_pool", lambda x: calls.append(x.shape) or wrapped(x))
    x = torch.from_numpy(_tied((1, 4, 6, 6, 8), 2))
    for dtype, strides in ((torch.bfloat16, (1, 1, 1)), (torch.bfloat16, (2, 2, 2)), (torch.float32, (1, 1, 1))):
        t_pool(x.to(dtype), (3, 3, 3), strides, impl)
    assert calls == [(1, 4, 6, 6, 8)]


def test_unknown_pool_impl_raises():
    with pytest.raises(NotImplementedError, match="pool impl"):
        t_pool(torch.zeros(1, 2, 2, 2, 1), (3, 3, 3), (1, 1, 1), "select_and_scatter")


# I3D per impl


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


@pytest.fixture(scope="module")
def i3d_ref():
    """The numpy-drawn variables, the clip, the head's weights r, and a
    cache of the JAX model's (logits, input gradient of (logits * r).sum())
    per float32 program."""
    variables = _jax_variables(j_i3d_smth(**SMALL, dropout_rate=0.0))
    x = np.random.RandomState(1).uniform(0, 255, SHAPE).astype(np.float32)
    r = np.random.RandomState(2).randn(5).astype(np.float32)
    return dict(variables=variables, x=x, r=r, sd=i3d_variables_to_state_dict(variables), jax={})


def _jax_logits_and_grad(ref, impl):
    if impl not in ref["jax"]:
        model = j_i3d_smth(**SMALL, dropout_rate=0.0, pool_impl=impl)

        def score(a):
            logits = model.apply(ref["variables"], a)
            return (logits[0] * ref["r"]).sum(), logits

        (_, logits), grad = jax.jit(jax.value_and_grad(score, has_aux=True))(jnp.asarray(ref["x"]))
        ref["jax"][impl] = (np.asarray(logits), np.asarray(grad))
    return ref["jax"][impl]


@pytest.mark.parametrize("impl", POOL_IMPLS)
def test_i3d_logits_and_input_gradient_match_jax(i3d_ref, impl):
    want_logits, want_grad = _jax_logits_and_grad(i3d_ref, F32_EQUIVALENT[impl])
    model = t_i3d_smth(**SMALL, pool_impl=impl)
    model.load_state_dict(i3d_ref["sd"])
    model.eval().requires_grad_(False)
    x = torch.from_numpy(i3d_ref["x"]).requires_grad_()
    logits = model(x)
    (logits[0] * torch.from_numpy(i3d_ref["r"])).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=1e-3, atol=1e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(x.grad.numpy() / scale, want_grad / scale, atol=1e-4)


# find_masks per impl, bfloat16


def _bf16_find_masks(tmp_path, sd, impl):
    cfg = TConfig()
    cfg.output_dir, cfg.model_name = str(tmp_path), impl
    cfg.model.num_classes, cfg.model.compute_dtype, cfg.model.pool_impl = 5, "bfloat16", impl
    cfg.data.batch_size, cfg.mask.opt_iter, cfg.mask.top_layer = 4, 4, "Mixed_4f"
    orig = tapi.build_model

    def small_model(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        model.pool_shape = (1, 1, 1)
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "build_model", small_model)
        tm, _ = tapi.find_masks(cfg, sd, SyntheticClips(4, t=8, hw=32, num_classes=5, lazy=False),
                                device="cpu", save_viz=False)
    return tm


@pytest.fixture(scope="module")
def bf16_default_run(i3d_ref, tmp_path_factory):
    return _bf16_find_masks(tmp_path_factory.mktemp("bf16_default"), i3d_ref["sd"], "argmax")


@pytest.mark.parametrize("impl", POOL_IMPLS)
def test_bf16_find_masks_per_impl(i3d_ref, bf16_default_run, tmp_path, impl):
    tm = _bf16_find_masks(tmp_path, i3d_ref["sd"], impl)
    assert len(tm) == len(bf16_default_run) == 4
    for got, want in zip(tm, bf16_default_run):
        mask = got["time_mask"]
        assert mask.dtype == np.float32 and np.isfinite(mask).all() and 0 <= mask.min() and mask.max() <= 1
        for key in ("pred_class", "original_score_guess", "original_score_true"):
            assert got[key] == want[key], key
        if impl in ("reduce_window", "argmax"):
            # find_masks makes a bfloat16 reduce_window run an argmax one
            np.testing.assert_array_equal(mask, want["time_mask"])
        assert np.abs(mask - want["time_mask"]).max() <= MASK_TOL
