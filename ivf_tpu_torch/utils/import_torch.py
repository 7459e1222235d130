"""Import reference torch checkpoints (``.pth`` / ``.pth.tar`` / ``.pt``) into
the port's state dicts (port of ``ivf_tpu/utils/import_torch.py``, copied,
not imported).

I3D (``video_features_pytorch/models/I3D_doubled*.py``): the port's I3D
keeps the reference's names (``<EP>.conv3d.weight|bias``,
``<EP>.bn.{weight,bias,running_mean,running_var,num_batches_tracked}``,
Inception branches ``b0``, ``b1a``, ``b1b``, ``b2a``, ``b2b``, ``b3b``,
``logits.conv3d.*``), so the import is a renaming only: DataParallel's
``module.`` prefix goes, the rest of the reference's keys are dropped.

ConvLSTM (``models/convolution_lstm.py`` + ``CLSTM_4.py``):
  ``clstm.cell<i>.Wx{i,f,c,o}.weight`` concatenated in gate order (i, f,
  c, o) on Cout -> ``clstm.cells.<i>.wx``; the biases -> ``bx``; the
  bias-free ``Wh*`` convs -> ``wh`` (the zero peephole ``Wci`` / ``Wcf`` /
  ``Wco`` constants are not in the state dict);
  ``clstm.bn.*`` -> ``clstm.bn.*`` (the shared-BN quirk);
  ``endFC.weight`` -> ``end_fc.weight``, its input features permuted from
  torch's (C, H', W') flatten order to the port's (H', W', C), per
  effective step.

``remove_module_prefix`` strips DataParallel's ``module.`` prefix
(``utils.remove_module_from_checkpoint_state_dict``,
video_features_pytorch/utils.py:94-104). Floating tensors arrive as
float32, the BN counts as long.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import torch

_GATE_ORDER = ("i", "f", "c", "o")
_I3D_KEY = re.compile(
    r"\.(conv3d\.(weight|bias)|bn\.(weight|bias|running_mean|running_var|num_batches_tracked))$"
)


def remove_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {re.sub(r"^module\.", "", k): v for k, v in state_dict.items()}


def _t(value) -> torch.Tensor:
    t = torch.as_tensor(value).detach().to("cpu")
    return (t.float() if t.is_floating_point() else t.long()).contiguous()


def _count(sd: Mapping[str, Any], key: str) -> torch.Tensor:
    return _t(sd[key]) if key in sd else torch.zeros((), dtype=torch.long)


def i3d_state_dict(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Reference I3D state dict -> the port's I3D state dict."""
    return {k: _t(v) for k, v in remove_module_prefix(state_dict).items() if _I3D_KEY.search(k)}


def fc_geometry(
    image_size: Tuple[int, int], conv_stride: int, pool_kernel: Tuple[int, int], lstm_layers: int
) -> Tuple[int, int]:
    """(H', W') of the last layer's pooled output, as ``CLSTM_4.py:54-63``
    and the JAX package's importer compute it."""
    shrink = (conv_stride * pool_kernel[0]) ** lstm_layers
    return image_size[0] // shrink, image_size[1] // shrink


def convlstm_state_dict(
    state_dict: Mapping[str, Any],
    image_size: Tuple[int, int],
    conv_stride: int,
    pool_kernel: Tuple[int, int],
    lstm_layers: int,
    nb_lstm_units: int,
) -> Dict[str, torch.Tensor]:
    """Reference CLSTM_4 state dict -> the port's ConvLSTMClassifier state
    dict. ``image_size`` and the strides give (H', W'), which the fc
    weight's permutation needs."""
    sd = remove_module_prefix(state_dict)
    out: Dict[str, torch.Tensor] = {}
    cells = sorted({int(m.group(1)) for k in sd if (m := re.match(r"clstm\.cell(\d+)\.", k))})
    for ci in cells:
        for w in ("x", "h"):
            out[f"clstm.cells.{ci}.w{w}"] = torch.cat(
                [_t(sd[f"clstm.cell{ci}.W{w}{g}.weight"]) for g in _GATE_ORDER], dim=0
            )
        out[f"clstm.cells.{ci}.bx"] = torch.cat([_t(sd[f"clstm.cell{ci}.Wx{g}.bias"]) for g in _GATE_ORDER])
    if "clstm.bn.weight" in sd:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"clstm.bn.{leaf}"] = _t(sd[f"clstm.bn.{leaf}"])
        out["clstm.bn.num_batches_tracked"] = _count(sd, "clstm.bn.num_batches_tracked")
    if "endFC.weight" in sd:
        w = _t(sd["endFC.weight"])  # (num_classes, in_features)
        hp, wp = fc_geometry(image_size, conv_stride, pool_kernel, lstm_layers)
        c = nb_lstm_units
        n_eff = w.shape[1] // (c * hp * wp)
        # torch's flatten order per effective step (C, H', W') -> (H', W', C)
        w = w.reshape(w.shape[0], n_eff, c, hp, wp).permute(0, 1, 3, 4, 2)
        out["end_fc.weight"] = w.reshape(w.shape[0], -1).contiguous()
        out["end_fc.bias"] = _t(sd["endFC.bias"])
    return out


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """Load a reference .pth.tar checkpoint (returns its state_dict)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt
