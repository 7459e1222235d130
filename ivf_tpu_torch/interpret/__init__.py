"""Perturbations, the batched temporal-mask search, Grad-CAM (video and
2-D) and guided backprop, with the names the JAX package's
``ivf_tpu/interpret/__init__.py`` exports."""

from ivf_tpu_torch.interpret.perturb import (
    perturb_sequence,
    freeze_perturb,
    reverse_perturb,
    tv_norm,
    snap_mask,
    find_submasks_from_mask,
)
from ivf_tpu_torch.interpret.mask_opt import (
    init_mask_central,
    init_mask_random,
    find_mask,
    find_mask_from_carry,
    make_search_carry,
    search_segment,
    finalize_search,
    MaskSearchResult,
)
from ivf_tpu_torch.interpret.gradcam import grad_cam
from ivf_tpu_torch.interpret.gradcam2d import (
    grad_cam_image,
    guided_backprop_image,
    combine_cam_gb,
)
from ivf_tpu_torch.interpret.guided_backprop import guided_relu, guided_backprop_i3d

__all__ = [
    "perturb_sequence",
    "freeze_perturb",
    "reverse_perturb",
    "tv_norm",
    "snap_mask",
    "find_submasks_from_mask",
    "init_mask_central",
    "init_mask_random",
    "find_mask",
    "find_mask_from_carry",
    "make_search_carry",
    "search_segment",
    "finalize_search",
    "MaskSearchResult",
    "grad_cam",
    "grad_cam_image",
    "guided_backprop_image",
    "combine_cam_gb",
    "guided_relu",
    "guided_backprop_i3d",
]
