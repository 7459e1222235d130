"""Export the port's weights to reference torch checkpoints (``.pth.tar``)
(port of ``ivf_tpu/utils/export_torch.py``, copied, not imported).

The exact inverse of ``utils/import_torch.py``: a model trained or
fine-tuned in the port goes back to the reference stack
(``video_features_pytorch``), which loads it with ``strict=True``.

Name maps mirror the reference modules:
  I3D:      ``<EP>.conv3d.weight|bias``, ``<EP>.bn.{weight,bias,
            running_mean,running_var,num_batches_tracked}``
            (``models/I3D_doubled.py:43-118`` Unit3D layout): the port's
            own names;
  ConvLSTM: ``clstm.cell<i>.Wx{i,f,c,o}.{weight,bias}``,
            ``clstm.cell<i>.Wh{i,f,c,o}.weight`` (Wh convs are bias-free,
            ``models/convolution_lstm.py:25-32``), shared ``clstm.bn.*``,
            ``endFC.{weight,bias}`` with the (H', W', C) -> (C, H', W')
            flatten permutation of ``CLSTM_4.py:54-63``.

``num_batches_tracked`` is the port's BN count (0 for weights converted
from a JAX tree, as the JAX package's exporter writes it).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from ivf_tpu_torch.utils.import_torch import _GATE_ORDER, _I3D_KEY, _count, _t, fc_geometry


def i3d_state_dict_to_reference(state_dict: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's I3D state dict -> the reference I3D state dict."""
    return {k: _t(v) for k, v in state_dict.items() if _I3D_KEY.search(k)}


def convlstm_state_dict_to_reference(
    state_dict: Mapping[str, Any],
    image_size: Tuple[int, int],
    conv_stride: int,
    pool_kernel: Tuple[int, int],
    lstm_layers: int,
    nb_lstm_units: int,
) -> Dict[str, torch.Tensor]:
    """The port's ConvLSTMClassifier state dict -> the reference CLSTM_4
    state dict (the geometry re-permutes the fc weight to torch's (C, H',
    W') flatten order)."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}
    cells = sorted({int(k.split(".")[2]) for k in sd if k.startswith("clstm.cells.") and k.endswith(".wx")})
    for ci in cells:
        wx, wh, bx = (_t(sd[f"clstm.cells.{ci}.{n}"]) for n in ("wx", "wh", "bx"))
        c = wx.shape[0] // 4
        for gi, g in enumerate(_GATE_ORDER):
            out[f"clstm.cell{ci}.Wx{g}.weight"] = wx[gi * c : (gi + 1) * c].contiguous()
            out[f"clstm.cell{ci}.Wx{g}.bias"] = bx[gi * c : (gi + 1) * c].contiguous()
            out[f"clstm.cell{ci}.Wh{g}.weight"] = wh[gi * c : (gi + 1) * c].contiguous()
    if "clstm.bn.weight" in sd:
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"clstm.bn.{leaf}"] = _t(sd[f"clstm.bn.{leaf}"])
        out["clstm.bn.num_batches_tracked"] = _count(sd, "clstm.bn.num_batches_tracked")
    if "end_fc.weight" in sd:
        w = _t(sd["end_fc.weight"])  # (classes, in_features)
        hp, wp = fc_geometry(image_size, conv_stride, pool_kernel, lstm_layers)
        c = nb_lstm_units
        n_eff = w.shape[1] // (c * hp * wp)
        # the port's (H', W', C) per effective step -> torch's (C, H', W')
        w = w.reshape(w.shape[0], n_eff, hp, wp, c).permute(0, 1, 4, 2, 3)
        out["endFC.weight"] = w.reshape(w.shape[0], -1).contiguous()
        out["endFC.bias"] = _t(sd["end_fc.bias"])
    return out


def save_checkpoint_file(
    path: str,
    state_dict: Mapping[str, Any],
    epoch: int = 0,
    best_loss: float = float("inf"),
    arch: str = "",
) -> None:
    """Write a reference-layout .pth.tar (utils.py:142-148 checkpoint keys:
    the training drivers save {'epoch', 'arch', 'state_dict', 'best_loss'},
    e.g. train_i3d_smth.py:184-189)."""
    torch.save(
        {"epoch": epoch, "arch": arch, "state_dict": dict(state_dict), "best_loss": best_loss},
        path,
    )
