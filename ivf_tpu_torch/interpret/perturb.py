"""Temporal perturbations + regularizers for the mask search, batched.

Port of ``ivf_tpu/interpret/perturb.py``. The JAX functions take one clip
and are vmapped; here the batch dimension is written out: ``seq`` is
``(B, T, H, W, C)`` and ``mask`` is ``(B, T)``.

* ``freeze_perturb``: masked frames repeat the previous (possibly already
  frozen) frame, ``out[u] = (1-m[u])*seq[u] + m[u]*out[u-1]``, as one
  batched ``torch.matmul`` with the lower-triangular transition matrix.
* ``reverse_perturb``: inside every contiguous run of mask > 0.1, frame at
  run position p swaps with position L-1-p, blended with the mask value
  of the earlier of the two.
* ``tv_norm``: the reference's TV norm with its interior differences
  counted twice on purpose.

The mask is cast to the sequence's dtype. In a bfloat16 ``find_masks`` the
clips stay float32 up to the model's first conv, so the perturbation runs
in float32, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

MASK_THRESHOLD = 0.1


def snap_mask(mask: torch.Tensor) -> torch.Tensor:
    """Round the mask to {0, 1} at 0.5."""
    return (mask > 0.5).to(mask.dtype)


def freeze_transition_matrix(mask: torch.Tensor, closed_form: bool = False) -> torch.Tensor:
    """Lower-triangular ``(B, T, T)`` matrices W with ``out = W @ seq``
    equal to the freeze recurrence: ``W[u, k] = (1-m[k]) * prod(m[k+1..u])``
    with column 0 absorbing the unperturbed first frame.

    ``closed_form=False`` unrolls the recurrence row by row
    (``row_u = m[u] * row_{u-1} + (1 - m[u]) * e_u``); ``closed_form=True``
    builds W from log-space cumulative sums ``L[u] = sum_{1<=j<=u} log m[j]``
    as ``exp(L[u] - L[k])``: the same values up to ~1e-4 relative
    reassociation, in a few elementwise ops.
    """
    b, t = mask.shape
    if not closed_form:
        eye = torch.eye(t, dtype=mask.dtype, device=mask.device)
        rows = [eye[0].expand(b, t)]
        for u in range(1, t):
            m_u = mask[:, u : u + 1]
            rows.append(m_u * rows[-1] + (1.0 - m_u) * eye[u])
        return torch.stack(rows, dim=1)

    logm = torch.log(torch.clamp(mask, min=torch.finfo(mask.dtype).tiny))
    # index 0 is excluded by the recurrence
    logm = torch.cat([torch.zeros_like(logm[:, :1]), logm[:, 1:]], dim=1)
    cum = torch.cumsum(logm, dim=1)
    # valid (k <= u) exponents are <= 0; the clamp only stops the upper
    # triangle from overflowing to inf, which would poison the gradient
    tail = torch.exp(torch.clamp(cum[:, :, None] - cum[:, None, :], max=0.0))
    idx = torch.arange(t, device=mask.device)
    coef = torch.where(idx == 0, 1.0, 1.0 - mask)  # (1-m[k]); k=0 -> 1
    lower = idx[:, None] >= idx[None, :]
    return torch.where(lower, coef[:, None, :] * tail, 0.0)


def freeze_perturb(seq: torch.Tensor, mask: torch.Tensor, closed_form: bool = False) -> torch.Tensor:
    """Freeze perturbation of ``seq (B, T, ...)`` under ``mask (B, T)``."""
    b, t = mask.shape
    w = freeze_transition_matrix(mask.to(seq.dtype), closed_form=closed_form)
    return torch.matmul(w, seq.reshape(b, t, -1)).reshape(seq.shape)


def _run_geometry(on: torch.Tensor):
    """For boolean ``on (B, T)``: (pos, length, run_start) of each
    position's maximal contiguous True run (meaningless where ``on`` is
    False)."""
    t = on.shape[1]
    off_csum = torch.cumsum((~on).to(torch.int64), dim=1)  # equal <=> no gap
    idx = torch.arange(t, device=on.device)
    same = on[:, :, None] & on[:, None, :] & (off_csum[:, :, None] == off_csum[:, None, :])
    run_start = torch.where(same, idx, t + 1).amin(dim=2)
    run_len = same.sum(dim=2)
    return idx - run_start, run_len, run_start


def reverse_perturb(seq: torch.Tensor, mask: torch.Tensor, thresh: float = MASK_THRESHOLD) -> torch.Tensor:
    """Reverse perturbation: inside every contiguous run of ``mask >
    thresh`` the frame at run position p swaps with position L-1-p,
    blended with coefficient ``mask[run_start + min(p, L-1-p)]``. Run
    middles (odd L) and frames outside runs stay original."""
    b, t = mask.shape
    m = mask.to(seq.dtype)
    on = m > thresh
    pos, run_len, run_start = _run_geometry(on)
    partner = torch.clamp(run_start + run_len - 1 - pos, 0, t - 1)
    coeff_idx = torch.clamp(run_start + torch.minimum(pos, run_len - 1 - pos), 0, t - 1)
    coeff = torch.gather(m, 1, coeff_idx)
    flat = seq.reshape(b, t, -1)
    swapped = torch.gather(flat, 1, partner[:, :, None].expand_as(flat))
    do_swap = on & (pos != run_len - 1 - pos)
    c = coeff[:, :, None]
    blend = (1.0 - c) * flat + c * swapped
    return torch.where(do_swap[:, :, None], blend, flat).reshape(seq.shape)


def perturb_sequence(
    seq: torch.Tensor,
    mask: torch.Tensor,
    perturbation_type: str = "freeze",
    snap_values: bool = False,
    closed_form: bool = False,
) -> torch.Tensor:
    """Dispatcher mirroring the reference's ``mask.perturb_sequence``."""
    if snap_values:
        mask = snap_mask(mask)
    if perturbation_type == "freeze":
        return freeze_perturb(seq, mask, closed_form=closed_form)
    if perturbation_type == "reverse":
        return reverse_perturb(seq, mask)
    raise ValueError(f"unknown perturbation_type {perturbation_type}")


def tv_norm(mask: torch.Tensor, p: float = 3.0, q: float = 3.0) -> torch.Tensor:
    """Total variation over the last axis: sum over u in [1, T-2] of
    |m[u-1]-m[u]|^p + |m[u+1]-m[u]|^p, then ^(1/p), then ^q."""
    d = torch.abs(mask[..., :-1] - mask[..., 1:]) ** p
    val = d[..., :-1].sum(-1) + d[..., 1:].sum(-1)
    return (val ** (1.0 / p)) ** q


def find_submasks_from_mask(mask, thresh: float = MASK_THRESHOLD) -> list:
    """The contiguous runs of ``mask > thresh`` as lists of frame indices
    (host side, for analysis and viz; ``ivf_tpu/interpret/perturb.py:
    193-211``)."""
    mask = np.asarray(mask)
    submasks, current, in_run = [], [], False
    for j, v in enumerate(mask):
        if v > thresh and not in_run:
            current, in_run = [j], True
        elif v > thresh and in_run:
            current.append(j)
        elif v <= thresh and in_run:
            submasks.append(current)
            in_run = False
        if j == len(mask) - 1 and in_run:
            submasks.append(current)
            in_run = False
    return submasks
