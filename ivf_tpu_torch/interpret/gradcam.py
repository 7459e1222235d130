"""Grad-CAM for video, batched (port of ``ivf_tpu/interpret/gradcam.py``).

For I3D the target activation is the trunk output at ``endpoint``
(``features_to``); its gradient comes from differentiating the head
(``head_from``) with respect to it. For the ConvLSTM it is the last
layer's hidden sequence ``clstm_output``; its gradient is taken with
respect to a zero ``feature_offset`` added to it after the recurrence has
read it (``convlstm_grad_cam``). CAM = ReLU(sum_c w_c * act_c) with
channel weights the mean gradient over (T', H', W') ('global', the torch
reference) or over (H', W') per frame ('per_frame', the TF reference),
upsampled bilinearly to the clip's (H, W), repeated in time to T frames
and normalized to [0, 1] per frame or per clip.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ivf_tpu_torch.precision import reference_numerics_fn


def cam_from_activation(
    activation: torch.Tensor,
    grads: torch.Tensor,
    clip_len: int,
    spatial_size: Tuple[int, int],
    normalize_per_frame: bool = False,
    weight_mode: str = "global",
) -> torch.Tensor:
    """activation/grads: (B, T', H', W', C) -> cams (B, T, H, W) in [0, 1]."""
    dims = (2, 3) if weight_mode == "per_frame" else (1, 2, 3)
    weights = grads.mean(dim=dims, keepdim=True)
    cam = torch.relu((weights * activation).sum(-1))  # (B, T', H', W')
    if cam.shape[2:] == (1, 1):
        # one pixel upsamples to a constant map; F.interpolate's weighted
        # sum can be off by an ulp, which the normalization below would
        # blow up to [0, 1] where jax.image.resize gives exact zeros
        cam = cam.expand(*cam.shape[:2], *spatial_size)
    else:
        # jax.image.resize 'bilinear' upsampling == half-pixel bilinear with
        # edge clamping (a test holds the two equal); T' rides as channels
        cam = F.interpolate(cam, size=tuple(spatial_size), mode="bilinear", align_corners=False)
    cam = cam.repeat_interleave(clip_len // cam.shape[1], dim=1)
    # the reference divides unguarded (NaN on an all-zero CAM); emit zeros
    red = (2, 3) if normalize_per_frame else (1, 2, 3)
    mn = cam.amin(dim=red, keepdim=True)
    mx = (cam - mn).amax(dim=red, keepdim=True)
    return torch.where(mx > 0, (cam - mn) / mx, 0.0)


@reference_numerics_fn
def grad_cam_batched(
    features_fn: Callable[[torch.Tensor], torch.Tensor],
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    clips: torch.Tensor,
    targets: Optional[torch.Tensor],
    normalize_per_frame: bool = False,
    weight_mode: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad-CAM of ``targets (B,)`` (None: each clip's predicted class) for
    clips (B, T, H, W, C). Returns (cams (B, T, H, W), class scores (B,
    num_classes))."""
    with torch.no_grad():
        act = features_fn(clips)
    act = act.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = head_fn(act)
        if targets is None:
            targets = scores.detach().argmax(dim=-1)
        picked = scores.gather(1, targets[:, None]).sum()
        (grads,) = torch.autograd.grad(picked, act)
    cams = cam_from_activation(
        act.detach(), grads, clips.shape[1], (clips.shape[2], clips.shape[3]),
        normalize_per_frame, weight_mode,
    )
    return cams, scores.detach()


def grad_cam(
    features_fn: Callable[[torch.Tensor], torch.Tensor],
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    clip: torch.Tensor,
    target_index=None,
    normalize_per_frame: bool = False,
    weight_mode: str = "global",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad-CAM for one clip (T, H, W, C) (``ivf_tpu/interpret/gradcam.py::
    grad_cam``) with the batched ``features_fn`` / ``head_fn`` of
    ``i3d_grad_cam_fns``; ``target_index`` None explains the predicted
    class. Returns (cam (T, H, W) in [0, 1], class scores)."""
    targets = None if target_index is None else torch.as_tensor([int(target_index)], device=clip.device)
    cams, scores = grad_cam_batched(
        features_fn, head_fn, clip[None], targets, normalize_per_frame, weight_mode
    )
    return cams[0], scores[0]


def i3d_grad_cam_fns(model, endpoint: str = "Mixed_5c"):
    """(features_fn, head_fn) for an ``ivf_tpu_torch`` I3D, batched."""
    return (
        lambda clips: model.features_to(clips, endpoint),
        lambda act: model.head_from(act, endpoint),
    )


@reference_numerics_fn
def convlstm_grad_cam(
    model,
    clips: torch.Tensor,
    targets: Optional[torch.Tensor],
    normalize_per_frame: bool = False,
    weight_mode: str = "per_frame",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad-CAM of an ``ivf_tpu_torch`` ConvLSTMClassifier for ``targets
    (B,)``, batched. The features are ``clstm_output`` (B, T, H'', W'', C)
    and the gradient of the picked class scores is taken with respect to a
    zero ``feature_offset``; one pass gives both, since adding zeros leaves
    ``clstm_output`` as it is. Rows are independent in eval mode, so the
    gradient of the summed picked scores is each clip's own, as under the
    JAX package's per-clip ``vmap``. ``targets`` None explains each clip's
    predicted class. Returns (cams (B, T, H, W), class scores (B,
    num_classes))."""
    with torch.enable_grad():
        offset = torch.zeros(
            model.clstm_output_shape(clips), device=clips.device, dtype=clips.dtype,
            requires_grad=True,
        )
        scores, feats = model.scores_and_features(clips, feature_offset=offset)
        if targets is None:
            targets = scores.detach().argmax(dim=-1)
        picked = scores.gather(1, targets[:, None]).sum()
        (grads,) = torch.autograd.grad(picked, offset)
    cams = cam_from_activation(
        feats.detach(), grads, clips.shape[1], (clips.shape[2], clips.shape[3]),
        normalize_per_frame, weight_mode,
    )
    return cams, scores.detach()
