"""2-D Grad-CAM and guided backprop, the vendored library's surface (port of
``ivf_tpu/interpret/gradcam2d.py``).

The reference's vendored ``pytorch-grad-cam/grad-cam.py``:

  * ``GradCam.__call__`` (grad-cam.py:96-145): forward to a target layer,
    backprop the chosen class score to it, CAM = ReLU(sum_c w_c * A_c)
    with channel weights the spatial mean of the gradients, bilinear
    resize to the input size, min-max normalize. The model is given as
    two functions, ``features_fn`` (image -> activation) and ``head_fn``
    (activation -> class scores), in place of the reference's hooks.
  * ``GuidedBackpropReLUModel`` (grad-cam.py:165-205): the score's
    gradient with respect to the input through a forward whose ReLUs are
    ``guided_relu`` (``interpret/guided_backprop.py``).
  * ``preprocess_image`` (grad-cam.py:74-87), ``show_cam_on_image``
    (grad-cam.py:89-94) and the ``cam * gb`` product of its ``__main__``
    (grad-cam.py:254-258).

Images are channels-last ``(H, W, C)`` tensors, one image a call, as in
the JAX package.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ivf_tpu_torch.precision import reference_numerics_fn

IMAGENET_MEANS = (0.485, 0.456, 0.406)
IMAGENET_STDS = (0.229, 0.224, 0.225)


def preprocess_image(img: np.ndarray, bgr: bool = True) -> torch.Tensor:
    """(H, W, 3) float image in [0, 1] -> normalized (H, W, 3) float32 on
    the CPU (grad-cam.py:74-87): the channels reversed (the reference's
    images come from cv2, BGR; ``bgr=False`` for RGB input), then the
    ImageNet mean and std. Channels stay last."""
    img = np.asarray(img, np.float32)
    if bgr:
        img = img[:, :, ::-1]
    mean = np.asarray(IMAGENET_MEANS, np.float32)
    std = np.asarray(IMAGENET_STDS, np.float32)
    return torch.from_numpy((img - mean) / std)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) weights of ``jax.image.resize(..., 'bilinear')`` along
    one axis (``jax._src.image.scale.compute_weight_mat``, antialiased):
    the triangle kernel at half-pixel sample points, widened by the
    shrink factor when shrinking, each column normalized to sum 1."""
    inv_scale = n_in / n_out
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = torch.clamp_min(1 - dist / max(inv_scale, 1.0), 0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * float(np.finfo(np.float32).eps), w / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0)


def resize_bilinear(x: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """An (H, W) map resized to ``size`` as ``jax.image.resize(x, size,
    'bilinear')`` does, both ways: half-pixel bilinear with edge clamping
    when growing, the antialiasing triangle filter when shrinking. A 1x1
    map becomes a constant map exactly (its weights are all 1), as
    ``interpret/gradcam.py`` keeps it."""
    wh = _resize_weights(x.shape[0], int(size[0]), x.device)
    ww = _resize_weights(x.shape[1], int(size[1]), x.device)
    return wh.t() @ x.float() @ ww


@reference_numerics_fn
def grad_cam_image(
    features_fn: Callable[[torch.Tensor], torch.Tensor],
    head_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    target_index: Optional[int] = None,
    output_size: Optional[Tuple[int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grad-CAM for one image (H, W, C) (GradCam.__call__,
    grad-cam.py:109-145). ``features_fn``: image -> activation (H', W',
    C'); ``head_fn``: activation -> class scores. ``target_index`` None
    explains the predicted class. Returns (cam of ``output_size``, default
    (H, W), in [0, 1]; the scores). An all-zero CAM gives zeros where the
    reference divides by zero, as ``interpret/gradcam.py`` does."""
    with torch.no_grad():
        act = features_fn(image)
    act = act.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = head_fn(act)
        if target_index is None:
            target_index = int(scores.detach().argmax())
        (grads,) = torch.autograd.grad(scores[target_index], act)
    weights = grads.mean(dim=(0, 1), keepdim=True)
    cam = torch.relu((weights * act.detach()).sum(-1))
    cam = resize_bilinear(cam, output_size or image.shape[:2])
    mn = cam.min()
    mx = (cam - mn).max()
    return torch.where(mx > 0, (cam - mn) / torch.where(mx > 0, mx, 1), 0.0), scores.detach()


@reference_numerics_fn
def guided_backprop_image(
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    image: torch.Tensor,
    target_index: Optional[int] = None,
) -> torch.Tensor:
    """Input-space guided-backprop saliency for one image
    (GuidedBackpropReLUModel.__call__, grad-cam.py:181-205): d
    score[target] / d image, shape (H, W, C). ``score_fn`` must be a
    forward whose ReLUs are ``guided_relu`` (``I3D(guided_relu=True)`` for
    video). ``target_index`` None takes the predicted class."""
    x = image.detach().requires_grad_(True)
    with torch.enable_grad():
        scores = score_fn(x)
        if target_index is None:
            target_index = int(scores.detach().argmax())
        (g,) = torch.autograd.grad(scores[target_index], x)
    return g


def combine_cam_gb(cam: torch.Tensor, gb: torch.Tensor) -> torch.Tensor:
    """cam (H, W) x guided-backprop map (H, W, C) -> the masked saliency,
    the reference ``__main__``'s ``cam_gb`` (grad-cam.py:254-258)."""
    return cam[..., None] * gb


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def show_cam_on_image(img, mask, path: str = "cam.jpg") -> np.ndarray:
    """JET-heatmap blend, written to ``path`` (grad-cam.py:89-94). img:
    (H, W, 3) RGB in [0, 1]; mask: (H, W) in [0, 1]; arrays or tensors.
    Returns the blended uint8 image."""
    from PIL import Image

    from ivf_tpu_torch.viz.render import _apply_jet

    heatmap = _apply_jet(_numpy(mask))[:, :, ::-1].astype(np.float32) / 255
    cam = heatmap + _numpy(img).astype(np.float32)
    cam = cam / max(float(np.max(cam)), 1e-12)
    out = np.uint8(255 * cam)
    Image.fromarray(out).save(path)
    return out
