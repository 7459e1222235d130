"""The one-clip search entries ``find_mask`` and ``find_mask_batched``
(``ivf_tpu_torch/interpret/mask_opt.py``) against the JAX package's, on the
CPU (``tests/test_interpret.py::test_find_mask_batched_vmap`` restated).

A cheap temporally sensitive score (class probabilities from the frames'
channel means) stands in for the model, one-clip for JAX and batched for
the port. Masks within atol 1e-5 and the reported losses and scores
within rtol 1e-5 / atol 1e-6 after up to 60 Adam steps, the tolerances of
``tests/test_torch_interpret.py``'s search test (Adam normalizes step
sizes, so float drift stays at its own scale); step counts equal.
"""

from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.interpret import mask_opt as jmo
from ivf_tpu_torch.interpret import mask_opt as tmo

T, K = 8, 4
_WC = (np.random.RandomState(7).randn(T * 3, K) * 0.5).astype(np.float32)


def j_score(clip):
    """Class probabilities of one clip (T, H, W, C)."""
    return jax.nn.softmax(jnp.mean(clip, axis=(1, 2)).reshape(-1) @ jnp.asarray(_WC))


def t_score(clips):
    """Class probabilities of clips (B, T, H, W, C)."""
    return torch.softmax(clips.mean(dim=(2, 3)).reshape(clips.shape[0], -1) @ torch.from_numpy(_WC), dim=-1)


def _seqs(b, seed=4):
    rng = np.random.RandomState(seed)
    return (rng.rand(b, T, 1, 1, 3) * 4.0 + 0.1 * rng.rand(b, T, 4, 4, 3)).astype(np.float32)


def _inits(b, seed=3):
    return np.where(np.random.RandomState(seed).rand(b, T) > 0.5, 5.0, -5.0).astype(np.float32)


def _close(got: tmo.MaskSearchResult, want, n_steps: int) -> None:
    np.testing.assert_allclose(got.mask.numpy(), np.asarray(want.mask), atol=1e-5)
    for name in ("loss", "l1_loss", "tv_loss", "freeze_score", "reverse_score", "orig_score"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(got.n_steps_run.numpy(), np.asarray(want.n_steps_run))
    assert int(got.n_steps_run.max()) <= n_steps


KWS = {
    "fixed": dict(n_steps=60, closed_form=False),
    "early_stop": dict(n_steps=60, closed_form=False, early_stop=True, eta=1e-4, eta_patience=2),
    "reverse": dict(n_steps=20, perturbation_type="reverse"),
    "no_steps": dict(n_steps=0),
}


@pytest.mark.parametrize("kw", list(KWS.values()), ids=list(KWS))
def test_find_mask_matches_jax(kw):
    """One clip, JAX's keyword arguments; each field without a batch
    dimension, as JAX's."""
    seq, init = _seqs(1)[0], _inits(1)[0]
    want = jax.jit(partial(jmo.find_mask, j_score, **kw))(jnp.asarray(seq), 2, jnp.asarray(init))
    got = tmo.find_mask(t_score, torch.from_numpy(seq), 2, torch.from_numpy(init), **kw)
    assert got.mask.shape == (T,) and got.loss.shape == ()
    _close(got, want, kw["n_steps"])


@pytest.mark.parametrize("kw", list(KWS.values()), ids=list(KWS))
def test_find_mask_batched_matches_jax(kw):
    """Four clips against JAX's vmapped search; rows freeze apart under
    early stop; row 1 run alone through ``find_mask`` gives row 1's mask
    (``test_find_mask_batched_vmap``'s check)."""
    seqs, inits, targets = _seqs(4), _inits(4), np.array([0, 1, 2, 3])
    want = jax.jit(partial(jmo.find_mask_batched, j_score, **kw))(
        jnp.asarray(seqs), jnp.asarray(targets), jnp.asarray(inits))
    got = tmo.find_mask_batched(t_score, torch.from_numpy(seqs), torch.from_numpy(targets),
                                torch.from_numpy(inits), **kw)
    assert got.mask.shape == (4, T)
    _close(got, want, kw["n_steps"])
    if kw.get("early_stop"):
        assert len(set(got.n_steps_run.tolist())) > 1
    single = tmo.find_mask(t_score, torch.from_numpy(seqs[1]), 1, torch.from_numpy(inits[1]), **kw)
    np.testing.assert_allclose(single.mask.numpy(), got.mask[1].numpy(), rtol=1e-6, atol=1e-7)
