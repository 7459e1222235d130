"""Temporal-mask optimization, batched (port of
``ivf_tpu/interpret/mask_opt.py``).

The JAX package vmaps a one-clip search; here every function takes the
batch dimension written out: clips ``(B, T, H, W, C)``, targets ``(B,)``,
mask logits ``(B, T)``; ``find_mask`` is the one-clip entry, run as a
batch of one, and every ``score_fn`` is batched (``ScoreFn`` below). Rows
never interact: the loss is summed over rows before ``backward``, so each
row's gradient is its own loss's gradient, and the Adam state, step count
and early-stop flags are kept per row.

  * loss = lam1*sum|sigmoid(m)| + lam2*TV(sigmoid(m), p=3, q=3)
          + score(perturb(seq, sigmoid(m)))[target]
  * Adam by hand, matching ``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)``
    with a per-row step count: under ``early_stop`` a frozen row keeps
    its logits AND its whole Adam state, which ``torch.optim.Adam``
    cannot do for single rows.
  * central init: the T//2-1 candidate masks (ones with i edge frames
    zeroed) are scored one after another under ``no_grad``, each over the
    whole batch; the first whose score-drop ratio falls below the
    threshold wins, else the last.
  * random init: ``init_mask_random`` maps uniforms to logits as the JAX
    package does; ``draw_mask_random`` draws them per clip id from a
    ``torch.Generator``. ``jax.random`` streams cannot be reproduced in
    torch, so the draws differ from the JAX package's; the transform is
    the same.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple, Tuple

import torch

from ivf_tpu_torch.interpret.perturb import perturb_sequence, tv_norm
from ivf_tpu_torch.precision import reference_numerics_fn

ScoreFn = Callable[[torch.Tensor], torch.Tensor]
# ScoreFn: clips (B, T, H, W, C) -> class probabilities (B, num_classes)

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class MaskSearchResult(NamedTuple):
    mask: torch.Tensor  # sigmoid(mask_logits), (B, T)
    loss: torch.Tensor  # last in-loop total loss, (B,)
    l1_loss: torch.Tensor
    tv_loss: torch.Tensor
    freeze_score: torch.Tensor  # class score under the optimized perturbation
    reverse_score: torch.Tensor  # class score under reverse perturbation
    orig_score: torch.Tensor  # unperturbed class score
    n_steps_run: torch.Tensor  # steps applied per row (== N unless early_stop)


@dataclass(frozen=True)
class SearchCarry:
    """The exact per-row loop state of the search."""

    logits: torch.Tensor  # (B, T) float32 mask logits
    mu: torch.Tensor  # (B, T) Adam first moment
    nu: torch.Tensor  # (B, T) Adam second moment
    count: torch.Tensor  # (B,) int32 Adam step count
    loss: torch.Tensor  # (B,) last in-loop total loss
    active: torch.Tensor  # (B,) bool, False once early_stop froze the row
    n_run: torch.Tensor  # (B,) int32 steps applied
    aux: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # last (l1, tv, score)
    streak: torch.Tensor  # (B,) int32 consecutive sub-eta steps


def _pick(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return scores.gather(1, targets[:, None])[:, 0]


@torch.no_grad()
@reference_numerics_fn
def init_mask_central(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    threshold: float = 0.9,
    mask_type: str = "freeze",
) -> torch.Tensor:
    """Central init, the reference's selection rule (mask.py:121-154).
    Returns float32 logits (B, T) in {-5, +5}."""
    b, t = seqs.shape[:2]
    n_cand = t // 2 - 1
    if n_cand < 1:
        # degenerate tiny clips: the reference would crash; all-on mask
        return torch.full((b, t), 5.0, device=seqs.device)
    orig = _pick(score_fn(seqs), targets)
    frozen = _pick(score_fn(seqs[:, :1].expand_as(seqs).contiguous()), targets)
    pos = torch.arange(t, device=seqs.device)
    ii = torch.arange(1, n_cand + 1, device=seqs.device)
    cand_masks = ((pos[None, :] >= ii[:, None]) & (pos[None, :] < t - ii[:, None])).to(seqs.dtype)
    cand_scores = torch.stack(
        [
            _pick(score_fn(perturb_sequence(seqs, m.expand(b, t), mask_type)), targets)
            for m in cand_masks
        ],
        dim=1,
    )
    ratios = (orig[:, None] - cand_scores) / (orig - frozen)[:, None]
    below = ratios < threshold
    first_below = below.to(torch.int32).argmax(dim=1)  # first True, 0 if none
    chosen = torch.where(below.any(dim=1), first_below, n_cand - 1)
    return torch.where(cand_masks[chosen] == 0, -5.0, 5.0).float()


def init_mask_random(u: torch.Tensor) -> torch.Tensor:
    """Random init (mask.py:156-165) from uniforms ``u`` (..., T) in [0, 1):
    +2.5 where u > 0.7, else -2.5, and +0.1 at frame min(8, T-1) of a
    constant mask (its TV norm would be NaN). Returns float32 logits."""
    t = u.shape[-1]
    mask = ((u > 0.7).float() - 0.5) * 5.0
    all_same = torch.abs(mask.sum(-1)) == 2.5 * t
    nudge = torch.zeros_like(mask)
    nudge[..., min(8, t - 1)] = torch.where(all_same, 0.1, 0.0)
    return mask + nudge


def draw_mask_random(seed: int, clip_id: str, t: int) -> torch.Tensor:
    """The random init of one clip, (T,) float32 logits: uniforms drawn on
    the CPU from a generator seeded by the CRC-32 of the clip id with
    ``seed`` as the CRC's initial value (the CPU generator keeps 32 bits of
    its seed), so a clip's init does not depend on which flush it runs in."""
    gen = torch.Generator().manual_seed(zlib.crc32(str(clip_id).encode(), seed & 0xFFFFFFFF))
    return init_mask_random(torch.rand(t, generator=gen, dtype=torch.float32))


def make_search_carry(mask_init_logits: torch.Tensor) -> SearchCarry:
    """Initial loop state for logits ``(B, T)``."""
    logits = mask_init_logits.float()
    b = logits.shape[0]
    zero = torch.zeros(b, device=logits.device)
    zero_i = torch.zeros(b, dtype=torch.int32, device=logits.device)
    return SearchCarry(
        logits=logits,
        mu=torch.zeros_like(logits),
        nu=torch.zeros_like(logits),
        count=zero_i,
        loss=torch.full((b,), 999999.0, device=logits.device),
        active=torch.ones(b, dtype=torch.bool, device=logits.device),
        n_run=zero_i,
        aux=(zero, zero, zero),
        streak=zero_i,
    )


def mask_loss(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    logits: torch.Tensor,
    lam1: float = 0.01,
    lam2: float = 0.02,
    perturbation_type: str = "freeze",
    closed_form: bool = True,
):
    """Per-row total loss (B,) and its (l1, tv, class score) parts."""
    m = torch.sigmoid(logits)
    l1 = lam1 * torch.abs(m).sum(-1)
    tv = lam2 * tv_norm(m, 3.0, 3.0)
    perturbed = perturb_sequence(seqs, m, perturbation_type, closed_form=closed_form)
    class_score = _pick(score_fn(perturbed), targets).float()
    return l1 + tv + class_score, (l1, tv, class_score)


@reference_numerics_fn
def search_step(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    carry: SearchCarry,
    lam1: float = 0.01,
    lam2: float = 0.02,
    lr: float = 0.2,
    perturbation_type: str = "freeze",
    early_stop: bool = False,
    eta: float = 1e-5,
    closed_form: bool = True,
    eta_patience: int = 1,
) -> SearchCarry:
    """One Adam step on every active row."""
    logits = carry.logits.detach().requires_grad_(True)
    loss, aux = mask_loss(
        score_fn, seqs, targets, logits, lam1, lam2, perturbation_type, closed_form
    )
    (g,) = torch.autograd.grad(loss.sum(), logits)
    loss = loss.detach()
    aux = tuple(a.detach() for a in aux)
    active, streak = carry.active, carry.streak
    if early_stop:
        sub_eta = torch.abs(carry.loss - loss) < eta
        streak = torch.where(sub_eta, streak + 1, 0)
        active = active & (streak < eta_patience)
    mu = (1 - _B1) * g + _B1 * carry.mu
    nu = (1 - _B2) * (g * g) + _B2 * carry.nu
    count = carry.count + 1
    c = count.to(g.dtype)[:, None]
    mu_hat = mu / (1 - _B1**c)
    nu_hat = nu / (1 - _B2**c)
    new_logits = carry.logits + (-lr) * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
    row = active[:, None]
    return SearchCarry(
        logits=torch.where(row, new_logits, carry.logits),
        mu=torch.where(row, mu, carry.mu),
        nu=torch.where(row, nu, carry.nu),
        count=torch.where(active, count, carry.count),
        loss=loss,
        active=active,
        n_run=carry.n_run + active.to(torch.int32),
        aux=aux,
        streak=streak,
    )


@torch.no_grad()
@reference_numerics_fn
def finalize_search(
    score_fn: ScoreFn, seqs: torch.Tensor, targets: torch.Tensor, carry: SearchCarry
) -> MaskSearchResult:
    """Carry -> result. The reported losses are the LAST IN-LOOP values
    (computed before the final Adam step), as the reference writes them;
    the mask and the reverse score use the post-step logits."""
    mask = torch.sigmoid(carry.logits)
    reverse_score = _pick(score_fn(perturb_sequence(seqs, mask, "reverse")), targets)
    orig_score = _pick(score_fn(seqs), targets)
    l1, tv, freeze_score = carry.aux
    return MaskSearchResult(
        mask=mask,
        loss=carry.loss,
        l1_loss=l1,
        tv_loss=tv,
        freeze_score=freeze_score,
        reverse_score=reverse_score,
        orig_score=orig_score,
        n_steps_run=carry.n_run,
    )


def search_segment(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    carry: SearchCarry,
    n_steps: int = 100,
    lam1: float = 0.01,
    lam2: float = 0.02,
    lr: float = 0.2,
    perturbation_type: str = "freeze",
    early_stop: bool = False,
    eta: float = 1e-5,
    closed_form: bool = True,
    eta_patience: int = 1,
) -> SearchCarry:
    """``n_steps`` of the search from ``carry`` -> the new carry, with no
    read of the device in between (``ivf_tpu/interpret/mask_opt.py:211``).
    The carry is the exact loop state, so chained segments give
    ``find_mask_from_carry``'s bits: a frozen row keeps its logits, Adam
    state and step count, and its loss and scores are recomputed from the
    same logits."""
    for _ in range(n_steps):
        carry = search_step(
            score_fn, seqs, targets, carry, lam1, lam2, lr, perturbation_type,
            early_stop, eta, closed_form, eta_patience,
        )
    return carry


def find_mask_from_carry(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    carry: SearchCarry,
    n_steps: int = 300,
    lam1: float = 0.01,
    lam2: float = 0.02,
    lr: float = 0.2,
    perturbation_type: str = "freeze",
    early_stop: bool = False,
    eta: float = 1e-5,
    closed_form: bool = True,
    eta_patience: int = 1,
) -> MaskSearchResult:
    """``n_steps`` of the search from ``carry``, then finalize."""
    for _ in range(n_steps):
        carry = search_step(
            score_fn, seqs, targets, carry, lam1, lam2, lr, perturbation_type,
            early_stop, eta, closed_form, eta_patience,
        )
        # once every row froze, further steps leave the carry unchanged
        if early_stop and not bool(carry.active.any()):
            break
    if n_steps == 0:  # degenerate: report metrics at the unstepped logits
        with torch.no_grad():
            loss, aux = mask_loss(
                score_fn, seqs, targets, carry.logits, lam1, lam2,
                perturbation_type, closed_form,
            )
        carry = replace(carry, loss=loss, aux=aux)
    return finalize_search(score_fn, seqs, targets, carry)


def find_mask_batched(
    score_fn: ScoreFn,
    seqs: torch.Tensor,
    targets: torch.Tensor,
    mask_init_logits: torch.Tensor,
    **kwargs,
) -> MaskSearchResult:
    """The search over a batch of clips ``(B, T, H, W, C)`` from logits
    ``(B, T)`` (``ivf_tpu/interpret/mask_opt.py::find_mask_batched``, a
    vmap there): ``find_mask_from_carry`` from a fresh carry, with its
    keyword arguments. ``score_fn`` maps clips ``(B, T, H, W, C)`` to class
    probabilities ``(B, num_classes)``; rows never interact."""
    return find_mask_from_carry(score_fn, seqs, targets, make_search_carry(mask_init_logits), **kwargs)


def find_mask(
    score_fn: ScoreFn,
    seq: torch.Tensor,
    target,
    mask_init_logits: torch.Tensor,
    n_steps: int = 300,
    lam1: float = 0.01,
    lam2: float = 0.02,
    lr: float = 0.2,
    perturbation_type: str = "freeze",
    early_stop: bool = False,
    eta: float = 1e-5,
    closed_form: bool = True,
    eta_patience: int = 1,
) -> MaskSearchResult:
    """Optimize a temporal mask for one clip ``(T, H, W, C)``, class
    ``target``, from logits ``(T,)`` (``ivf_tpu/interpret/mask_opt.py::
    find_mask``): the batched search on a batch of one. ``score_fn`` is
    batched, as everywhere in this module: clips ``(B, T, H, W, C)`` ->
    probabilities ``(B, num_classes)``. Returns the row's result, each
    field without the batch dimension."""
    res = find_mask_batched(
        score_fn, seq[None], torch.as_tensor([int(target)], device=seq.device), mask_init_logits[None],
        n_steps=n_steps, lam1=lam1, lam2=lam2, lr=lr, perturbation_type=perturbation_type,
        early_stop=early_stop, eta=eta, closed_form=closed_form, eta_patience=eta_patience,
    )
    return MaskSearchResult(*(field[0] for field in res))
