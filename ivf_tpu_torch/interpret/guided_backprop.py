"""Guided backpropagation (port of ``ivf_tpu/interpret/guided_backprop.py``).

The vendored ``pytorch-grad-cam/grad-cam.py`` GuidedBackpropReLU (lines
147-205): the forward is a plain ReLU; the backward passes the gradient
only where both the forward input and the incoming gradient are positive.
The reference swaps every ReLU module of a model for it; here the model
opts in (``I3D(guided_relu=True)``: the same weights, the same forward,
the guided backward), as in the JAX package. ``guided_relu`` itself lives
with the model's other activations (``models/layers.py``).
"""

from __future__ import annotations

from typing import Mapping, Union

import torch

from ivf_tpu_torch.models.layers import guided_relu
from ivf_tpu_torch.precision import reference_numerics

__all__ = ["guided_relu", "guided_backprop_i3d"]


def guided_backprop_i3d(
    state_dict_or_model: Union[Mapping[str, torch.Tensor], torch.nn.Module],
    clip: torch.Tensor,
    target_index: int,
    device=None,
    **i3d_kwargs,
) -> torch.Tensor:
    """Input-space saliency of one clip ``(T, H, W, C)`` by guided backprop
    through an I3D (GuidedBackpropReLUModel.__call__, grad-cam.py:165-205):
    d score[target] / d clip, shaped like the clip.

    Given a state dict, the model is ``I3D(guided_relu=True,
    **i3d_kwargs)`` loaded with it, in the state dict's floating dtype, on
    ``device`` (default ``cuda``, as every entry point; ``"cpu"`` to run
    on the CPU), in eval mode. Given a model, it is
    used as it is, on its own device: build it with ``guided_relu=True``
    for the guided backward. The clip is moved to the model's device and
    cast to its dtype."""
    from ivf_tpu_torch.data.loaders import resolve_device
    from ivf_tpu_torch.models.i3d import I3D

    if isinstance(state_dict_or_model, torch.nn.Module):
        model = state_dict_or_model
    else:
        i3d_kwargs.setdefault("guided_relu", True)
        model = I3D(**i3d_kwargs)
        model.load_state_dict(state_dict_or_model)
        dtype = next(v.dtype for v in state_dict_or_model.values() if v.is_floating_point())
        model = model.to(resolve_device(device), dtype).eval()
    p = next(model.parameters())
    x = clip.detach().to(p.device, p.dtype)[None].requires_grad_(True)
    with reference_numerics(), torch.enable_grad():
        score = model(x)[0, int(target_index)]
        (g,) = torch.autograd.grad(score, x)
    return g[0]

