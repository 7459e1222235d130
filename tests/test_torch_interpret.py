"""ivf_tpu_torch perturbations, mask search and Grad-CAM math vs the JAX
package, on the CPU.

The JAX functions take one clip and are vmapped here; the port's take the
batch written out. The search tests use a small differentiable score
function, written the same way in both frameworks, in place of I3D (the
I3D path is held by tests/test_torch_model.py and tests/test_torch_api.py).
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.interpret import gradcam as jgc
from ivf_tpu.interpret import mask_opt as jmo
from ivf_tpu.interpret import perturb as jpt
from ivf_tpu_torch.interpret import gradcam as tgc
from ivf_tpu_torch.interpret import mask_opt as tmo
from ivf_tpu_torch.interpret import perturb as tpt

T, K = 8, 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _seq(b=3, seed=0):
    """Clips whose frames differ strongly, so freezing frames moves the
    score."""
    rng = np.random.RandomState(seed)
    frame_level = rng.rand(b, T, 1, 1, 3) * 4.0
    return (frame_level + 0.1 * rng.rand(b, T, 4, 4, 3)).astype(np.float32)


_WC = (np.random.RandomState(7).randn(T * 3, K) * 0.5).astype(np.float32)


def j_score(clip):
    """Class probabilities of one clip (T, H, W, C)."""
    feats = jnp.mean(clip, axis=(1, 2)).reshape(-1)
    return jax.nn.softmax(feats @ jnp.asarray(_WC))


def t_score(clips):
    """Class probabilities of clips (B, T, H, W, C)."""
    feats = clips.mean(dim=(2, 3)).reshape(clips.shape[0], -1)
    return torch.softmax(feats @ _t(_WC), dim=-1)


def _masks():
    """Soft masks (B, T) with runs of every kind above the 0.1 threshold:
    odd and even lengths, at both borders, and values below it."""
    return np.array(
        [
            [0.9, 0.8, 0.05, 0.3, 0.6, 0.7, 0.02, 0.95],
            [0.05, 0.2, 0.4, 0.6, 0.8, 0.15, 0.05, 0.01],
            [0.5, 0.11, 0.09, 0.12, 0.13, 0.14, 0.99, 0.08],
        ],
        np.float32,
    )


def _value_and_mask_grad_jax(fn, seq, mask, r):
    def loss(m):
        out = jax.vmap(fn)(jnp.asarray(seq), m)
        return jnp.sum(out * r), out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(mask))
    return np.asarray(out), np.asarray(g)


def _value_and_mask_grad_torch(fn, seq, mask, r):
    m = _t(mask).requires_grad_(True)
    out = fn(_t(seq), m)
    (g,) = torch.autograd.grad((out * _t(r)).sum(), m)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize(
    "kind", ["freeze_scan", "freeze_closed", "reverse", "freeze_snapped"]
)
def test_perturbations_match_jax_values_and_mask_grads(kind):
    """Values (rtol 1e-5 / atol 1e-6) and d/d(mask) of a random projection
    (rtol 1e-5 / atol 1e-5 of the largest entry: each entry sums a few
    hundred float32 products, in two libraries' orders)."""
    seq = _seq()
    mask = _masks()
    r = np.random.RandomState(1).randn(*seq.shape).astype(np.float32)
    jfn, tfn = {
        "freeze_scan": (
            partial(jpt.freeze_perturb, closed_form=False),
            partial(tpt.freeze_perturb, closed_form=False),
        ),
        "freeze_closed": (
            partial(jpt.freeze_perturb, closed_form=True),
            partial(tpt.freeze_perturb, closed_form=True),
        ),
        "reverse": (jpt.reverse_perturb, tpt.reverse_perturb),
        "freeze_snapped": (
            partial(jpt.perturb_sequence, perturbation_type="freeze", snap_values=True),
            partial(tpt.perturb_sequence, perturbation_type="freeze", snap_values=True),
        ),
    }[kind]
    want, want_g = _value_and_mask_grad_jax(jfn, seq, mask, r)
    if kind == "freeze_snapped":  # a hard {0, 1} mask carries no gradient
        got = tfn(_t(seq), _t(mask)).numpy()
        np.testing.assert_array_equal(want_g, 0.0)
    else:
        got, got_g = _value_and_mask_grad_torch(tfn, seq, mask, r)
        scale = np.abs(want_g).max()
        np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_freeze_transition_matrix_forms_agree_and_match_jax():
    mask = _masks()
    scan = tpt.freeze_transition_matrix(_t(mask), closed_form=False).numpy()
    closed = tpt.freeze_transition_matrix(_t(mask), closed_form=True).numpy()
    want = np.asarray(jax.vmap(jpt.freeze_transition_matrix)(jnp.asarray(mask)))
    np.testing.assert_allclose(scan, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(closed, scan, rtol=1e-4, atol=1e-6)
    assert np.allclose(np.triu(scan[0], 1), 0.0)


def test_tv_norm_and_snap_match_jax():
    mask = _masks()
    m = _t(mask).requires_grad_(True)
    tv = tpt.tv_norm(m)
    (g,) = torch.autograd.grad(tv.sum(), m)
    want, want_g = jax.value_and_grad(lambda a: jnp.sum(jax.vmap(jpt.tv_norm)(a)))(
        jnp.asarray(mask)
    )
    np.testing.assert_allclose(tv.sum().item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(
        tpt.snap_mask(_t(mask)).numpy(), np.asarray(jpt.snap_mask(jnp.asarray(mask)))
    )


def test_init_mask_central_matches_jax():
    seqs = _seq(b=6, seed=2)
    targets = np.array([0, 1, 2, 3, 0, 1])
    want = jax.vmap(partial(jmo.init_mask_central, j_score))(
        jnp.asarray(seqs), jnp.asarray(targets)
    )
    got = tmo.init_mask_central(t_score, _t(seqs), _t(targets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len({tuple(row) for row in got.tolist()}) > 1  # the choice varies


def _jax_search(seqs, targets, inits, **kw):
    fn = jax.jit(jax.vmap(partial(jmo.find_mask, j_score, **kw)))
    return jax.tree.map(np.asarray, fn(jnp.asarray(seqs), jnp.asarray(targets), jnp.asarray(inits)))


def _torch_search(seqs, targets, inits, **kw):
    res = tmo.find_mask_from_carry(
        t_score, _t(seqs), _t(targets), tmo.make_search_carry(_t(inits)), **kw
    )
    return tmo.MaskSearchResult(*(a.numpy() for a in res))


def _inits(b, seed=3):
    return np.where(np.random.RandomState(seed).rand(b, T) > 0.5, 5.0, -5.0).astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(n_steps=60, closed_form=False),
        dict(n_steps=60, closed_form=False, early_stop=True, eta=1e-4, eta_patience=2),
        dict(n_steps=20, closed_form=True, perturbation_type="reverse"),
        dict(n_steps=0, closed_form=True),
    ],
    ids=["fixed", "early_stop", "closed_reverse", "no_steps"],
)
def test_search_trajectory_matches_jax(kw):
    """Hand-written per-row Adam vs optax, the early-stop streak and the
    last-in-loop reported losses. Masks atol 1e-5 after 60 steps (Adam
    normalizes step sizes, so float drift stays at its own scale)."""
    seqs = _seq(b=4, seed=4)
    targets = np.array([0, 1, 2, 3])
    inits = _inits(4)
    want = _jax_search(seqs, targets, inits, **kw)
    got = _torch_search(seqs, targets, inits, **kw)
    np.testing.assert_allclose(got.mask, want.mask, atol=1e-5)
    for name in ("loss", "l1_loss", "tv_loss", "freeze_score", "reverse_score", "orig_score"):
        np.testing.assert_allclose(
            getattr(got, name), getattr(want, name), rtol=1e-5, atol=1e-6, err_msg=name
        )
    np.testing.assert_array_equal(got.n_steps_run, want.n_steps_run)
    if kw.get("early_stop"):
        assert len(set(got.n_steps_run.tolist())) > 1  # rows froze apart
        assert got.n_steps_run.min() < kw["n_steps"]


def test_search_rows_are_independent():
    """Rows never interact: a batch of three gives each row the result it
    gets alone, early stop included (a frozen row keeps its state while
    the others step)."""
    seqs = _seq(b=3, seed=5)
    targets = np.array([0, 2, 3])
    inits = _inits(3, seed=6)
    kw = dict(n_steps=40, closed_form=False, early_stop=True, eta=1e-4, eta_patience=1)
    batch = _torch_search(seqs, targets, inits, **kw)
    for i in range(3):
        alone = _torch_search(seqs[i : i + 1], targets[i : i + 1], inits[i : i + 1], **kw)
        for name in ("mask", "loss", "freeze_score", "reverse_score", "n_steps_run"):
            np.testing.assert_allclose(
                getattr(batch, name)[i : i + 1], getattr(alone, name), rtol=1e-6, atol=1e-7
            )


@pytest.mark.parametrize("weight_mode", ["global", "per_frame"])
@pytest.mark.parametrize("per_frame_norm", [False, True])
def test_cam_from_activation_matches_jax(weight_mode, per_frame_norm):
    rng = np.random.RandomState(8)
    act = np.maximum(rng.randn(2, 2, 3, 4, 6), 0).astype(np.float32)
    grads = rng.randn(2, 2, 3, 4, 6).astype(np.float32)
    grads[1] = -np.abs(grads[1])  # all-negative weights: the zero guard
    want = jax.vmap(
        lambda a, g: jgc.cam_from_activation(a, g, 8, (12, 16), per_frame_norm, weight_mode)
    )(jnp.asarray(act), jnp.asarray(grads))
    got = tgc.cam_from_activation(_t(act), _t(grads), 8, (12, 16), per_frame_norm, weight_mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    if weight_mode == "global":
        assert got[1].abs().max() == 0


@pytest.mark.parametrize(
    "src,dst", [((2, 2, 2), (32, 32)), ((3, 7, 7), (224, 224)), ((2, 3, 5), (17, 23)), ((1, 1, 1), (5, 4))]
)
def test_bilinear_resize_equals_jax_image_resize(src, dst):
    """F.interpolate(bilinear, align_corners=False) upsampling vs
    jax.image.resize(..., 'bilinear') on (T', H', W') maps: equal to
    float32 rounding (the 1x1 map takes the exact-constant route)."""
    cam = np.random.RandomState(9).rand(*src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(cam), (src[0], *dst), "bilinear"))
    if src[1:] == (1, 1):
        got = _t(cam)[None].expand(1, src[0], *dst)[0].numpy()
    else:
        got = torch.nn.functional.interpolate(
            _t(cam)[None], size=dst, mode="bilinear", align_corners=False
        )[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
