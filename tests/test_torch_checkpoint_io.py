"""Checkpoint I/O of the port against the JAX package, on the CPU: TF
bundles both ways in every dtype, the TF import, the reference torch
import and export, ``num_batches_tracked``, and ``pretrained_model_path``
in each of its forms.

Every JAX reference runs once per module, in a module fixture. Weights
are numpy draws (``tests/test_torch_train.py::fill_variables``); the
ConvLSTM's torch-layout geometry has H'W' = 96 and two effective steps,
so a wrong fc permutation shows.
"""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu.models import ConvLSTMClassifier as JClassifier
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.train import build_optimizer as j_build_optimizer
from ivf_tpu.train import create_train_state as j_create_train_state
from ivf_tpu.utils import export_torch as jexport
from ivf_tpu.utils import tf_bundle as jtb
from ivf_tpu.utils.checkpoint import Checkpointer as JCheckpointer
from ivf_tpu.utils.import_tf import load_tf_checkpoint as j_load_tf_checkpoint
from ivf_tpu_torch import api as tapi
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.models import ConvLSTMClassifier, i3d_smth
from ivf_tpu_torch.models.layers import TorchBatchNorm
from ivf_tpu_torch.train import build_optimizer, create_train_state, make_train_step
from ivf_tpu_torch.utils import export_torch, import_tf, import_torch, tf_bundle
from ivf_tpu_torch.utils.checkpoint import Checkpointer
from ivf_tpu_torch.utils.convert import variables_to_state_dict
from tests.test_torch_train import fill_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same(got: dict, want: dict) -> None:
    """Key by key: the same names, dtypes, shapes and bits."""
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = torch.as_tensor(got[k]), torch.as_tensor(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype, b.dtype, a.shape, b.shape)
        assert torch.equal(a, b), k


# -- TF bundles, both ways, every dtype -------------------------------------------

BF16 = np.dtype(ml_dtypes.bfloat16)
# every code of the JAX reader's table (``ivf_tpu/utils/tf_bundle.py:_DTYPES``)
BUNDLE_DTYPES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16", 6: "int8", 9: "int64",
                 10: "bool", 14: "bfloat16", 19: "float16"}


def _array(code: int, shape=(3, 5)) -> np.ndarray:
    rng = np.random.RandomState(code)
    name = BUNDLE_DTYPES[code]
    if name == "bool":
        return np.asarray(rng.rand(*shape) > 0.5)
    if name.startswith(("int", "uint")):
        info = np.iinfo(name)
        return np.asarray(rng.randint(max(info.min, -(2**31)), min(info.max, 2**31 - 1), shape)).astype(name)
    dtype = BF16 if name == "bfloat16" else np.dtype(name)
    return np.asarray(rng.randn(*shape) * 100).astype(np.float32).astype(dtype)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).contiguous().numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def _tensors(code: int) -> dict:
    return {"a/kernel": _array(code), "b/scalar": _array(code, ()), "c/empty": _array(code, (0, 2)),
            "d/vec": _array(code, (7,))}


@pytest.mark.parametrize("code", sorted(BUNDLE_DTYPES), ids=lambda c: BUNDLE_DTYPES[c])
def test_port_reads_the_jax_packages_bundle(tmp_path, monkeypatch, code):
    """JAX's ``save_bundle`` (its code table widened to every code its
    reader knows: it writes no bf16, int16 or int8 as it stands) -> the
    port's ``load_bundle``: names, shapes, dtypes and bits."""
    for c, name in BUNDLE_DTYPES.items():
        monkeypatch.setitem(jtb._DTYPE_CODES, BF16 if name == "bfloat16" else np.dtype(name), c)
    tensors = _tensors(code)
    prefix = str(tmp_path / "model.ckpt")
    jtb.save_bundle(prefix, tensors)
    got = tf_bundle.load_bundle(prefix)
    listed = tf_bundle.list_variables(prefix)
    assert sorted(got) == sorted(tensors)
    for k, want in tensors.items():
        assert got[k].dtype == tf_bundle._DTYPES[code] and tuple(got[k].shape) == want.shape, k
        assert listed[k] == (want.shape, tf_bundle._DTYPES[code])
        assert _bits(got[k]) == _bits(want), k


@pytest.mark.parametrize("code", sorted(BUNDLE_DTYPES), ids=lambda c: BUNDLE_DTYPES[c])
def test_jax_package_reads_the_ports_bundle(tmp_path, code):
    """The port's ``save_bundle`` (torch tensors, bfloat16 included) -> JAX's
    ``load_bundle``: the same dtype code, shapes and bits."""
    tensors = {k: torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) if a.dtype == BF16
               else torch.from_numpy(a) for k, a in _tensors(code).items()}
    prefix = str(tmp_path / "ckpt" / "model.ckpt")
    tf_bundle.save_bundle(prefix, tensors)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["model.ckpt.data-00000-of-00001", "model.ckpt.index"]
    got = jtb.load_bundle(prefix)
    assert sorted(got) == sorted(tensors)
    for k, want in tensors.items():
        assert got[k].dtype == jtb._DTYPES[code] and got[k].shape == tuple(want.shape), k
        assert _bits(got[k]) == _bits(want), k


# -- the TF import ------------------------------------------------------------------

# the Keras ConvLSTM graph of the TF family: 2 layers x 4 units, (3, 5)
# kernels, stride 2, 'valid' padding, per-layer BN, 6 classes
CLSTM_TF = dict(num_classes=6, nb_lstm_units=4, lstm_layers=2, conv_kernel_size=(3, 5), conv_stride=2,
                block_order="tf", shared_bn=False, x_padding="valid", recurrent_activation="hard_sigmoid",
                unit_forget_bias=True, effective_steps=(3,), input_size=(24, 32), clip_len=4)
I3D_SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
I3D_BRANCH = {"b0": ("Branch_0", "Conv3d_0a_1x1"), "b1a": ("Branch_1", "Conv3d_0a_1x1"),
              "b1b": ("Branch_1", "Conv3d_0b_3x3"), "b2a": ("Branch_2", "Conv3d_0a_1x1"),
              "b2b": ("Branch_2", "Conv3d_0b_3x3"), "b3b": ("Branch_3", "Conv3d_0b_1x1")}


def _keras_bundle(gap: bool, seed: int) -> dict:
    """Keras-named tensors (``video_features_tf/models/clstm.py``) with Adam
    slots and a global step, as ``tests/test_import_tf.py`` builds them;
    the dense width from the port's model."""
    rng = np.random.RandomState(seed)
    tensors = {"global_step": np.asarray(42, np.int64)}
    cin = 3
    for li in range(2):
        sfx = "" if li == 0 else f"_{li}"
        kern = (rng.randn(3, 5, cin, 16) * 0.3).astype(np.float32)
        tensors[f"conv_lst_m2d{sfx}/kernel"] = kern
        tensors[f"conv_lst_m2d{sfx}/recurrent_kernel"] = (rng.randn(3, 5, 4, 16) * 0.3).astype(np.float32)
        tensors[f"conv_lst_m2d{sfx}/bias"] = (rng.randn(16) * 0.1).astype(np.float32)
        tensors[f"conv_lst_m2d{sfx}/kernel/Adam"] = np.zeros_like(kern)
        tensors[f"conv_lst_m2d{sfx}/kernel/Adam_1"] = np.zeros_like(kern)
        tensors[f"batch_normalization{sfx}/gamma"] = (1 + 0.1 * rng.randn(4)).astype(np.float32)
        tensors[f"batch_normalization{sfx}/beta"] = (0.1 * rng.randn(4)).astype(np.float32)
        tensors[f"batch_normalization{sfx}/moving_mean"] = (0.05 * rng.randn(4)).astype(np.float32)
        tensors[f"batch_normalization{sfx}/moving_variance"] = (1 + 0.1 * rng.rand(4)).astype(np.float32)
        cin = 4
    if gap:
        tensors["conv3d/kernel"] = (rng.randn(1, 1, 1, 4, 6) * 0.3).astype(np.float32)
        tensors["conv3d/bias"] = (rng.randn(6) * 0.1).astype(np.float32)
    else:
        width = ConvLSTMClassifier(**CLSTM_TF).end_fc.in_features
        tensors["dense/kernel"] = (rng.randn(width, 6) * 0.1).astype(np.float32)
        tensors["dense/bias"] = (rng.randn(6) * 0.1).astype(np.float32)
    return tensors


def _sonnet_bundle(variables) -> dict:
    """A JAX I3D tree under Sonnet's names (``video_features_tf/models/
    i3d.py``), as ``tests/test_import_tf.py::test_i3d_tf_import_roundtrip``
    builds them."""
    tensors = {"global_step": np.asarray(7, np.int64)}

    def unit(scope, node, stats):
        if "kernel" in node:
            tensors[f"{scope}/conv_3d/w"] = np.asarray(node["kernel"])
        if "bias" in node:
            tensors[f"{scope}/conv_3d/b"] = np.asarray(node["bias"])
        if "bn" in node:
            tensors[f"{scope}/batch_norm/beta"] = np.asarray(node["bn"]["bias"])
            tensors[f"{scope}/batch_norm/gamma"] = np.asarray(node["bn"]["scale"])
            tensors[f"{scope}/batch_norm/moving_mean"] = np.asarray(stats["bn"]["mean"])
            tensors[f"{scope}/batch_norm/moving_variance"] = np.asarray(stats["bn"]["var"])

    params, stats = variables["params"], variables["batch_stats"]
    for ep, node in params.items():
        if ep == "logits":
            unit("RGB/inception_i3d/Logits/Conv3d_0c_1x1", node, {})
        elif "kernel" in node:
            unit(f"RGB/inception_i3d/{ep}", node, stats[ep])
        else:
            for u, sub in node.items():
                br, conv = I3D_BRANCH[u]
                unit(f"RGB/inception_i3d/{ep}/{br}/{conv}", sub, stats[ep][u])
    return tensors


@pytest.fixture(scope="module")
def tf_refs(tmp_path_factory):
    """Three bundles written by JAX's ``save_bundle`` and JAX's import of
    each (``load_tf_checkpoint``)."""
    root = tmp_path_factory.mktemp("tf")
    i3d_vars = fill_variables(j_i3d_smth(**I3D_SMALL, dropout_rate=0.0), (1, 8, 32, 32, 3), seed=3)
    out = {}
    for name, family, tensors in (("clstm", "clstm", _keras_bundle(False, 7)),
                                  ("clstm_gap", "clstm", _keras_bundle(True, 8)),
                                  ("i3d", "i3d", _sonnet_bundle(i3d_vars))):
        prefix = str(root / name / "model.ckpt")
        jtb.save_bundle(prefix, tensors)
        out[name] = (prefix, family, j_load_tf_checkpoint(prefix, family))
    return out


@pytest.mark.parametrize("name", ["clstm", "clstm_gap", "i3d"])
def test_tf_import_matches_jax(tf_refs, name):
    """The port's ``load_tf_checkpoint`` equals JAX's followed by
    ``convert.variables_to_state_dict``, key by key with equal bits (Adam
    slots and the global step skipped, Sonnet's missing gamma filled with
    ones); the clstm and i3d imports load ``strict=True`` into the port's
    models."""
    prefix, family, jvars = tf_refs[name]
    got = import_tf.load_tf_checkpoint(prefix, family)
    _same(got, variables_to_state_dict(jvars))
    if name == "clstm":
        ConvLSTMClassifier(**CLSTM_TF).load_state_dict(got, strict=True)
    elif name == "i3d":
        i3d_smth(**I3D_SMALL).load_state_dict(got, strict=True)


def test_tf_import_widens_bfloat16_exactly(tmp_path, tf_refs):
    """A bundle saved in bfloat16 imports as its float32 widening, as the
    JAX package's import followed by the float32 conversion gives it."""
    prefix, _, _ = tf_refs["clstm"]
    tensors = {k: (v.bfloat16() if v.is_floating_point() else v) for k, v in tf_bundle.load_bundle(prefix).items()}
    bf_prefix = str(tmp_path / "bf16.ckpt")
    tf_bundle.save_bundle(bf_prefix, tensors)
    got = import_tf.load_tf_checkpoint(bf_prefix, "clstm")
    _same(got, variables_to_state_dict(j_load_tf_checkpoint(bf_prefix, "clstm")))
    assert not torch.equal(got["clstm.cells.0.wx"], import_tf.load_tf_checkpoint(prefix, "clstm")["clstm.cells.0.wx"])


# -- the reference torch import and export ------------------------------------------

# torch family, 2 layers x 4 units, stride 1, 32x48 frames: (H', W') = (8,
# 12) and two effective steps in the fc input
CLSTM_TORCH = dict(num_classes=3, nb_lstm_units=4, lstm_layers=2, conv_stride=1, effective_steps=(2, 5),
                   use_entire_seq=True)
CLSTM_SHAPE = (1, 6, 32, 48, 3)
GEOMETRY = dict(image_size=(32, 48), conv_stride=1, pool_kernel=(2, 2), lstm_layers=2, nb_lstm_units=4)


def _port_clstm():
    return ConvLSTMClassifier(**CLSTM_TORCH, input_size=CLSTM_SHAPE[2:4], clip_len=CLSTM_SHAPE[1])


@pytest.fixture(scope="module")
def torch_refs(tmp_path_factory):
    """JAX's export of seeded I3D and ConvLSTM trees, and the reference
    files it writes (``save_checkpoint_file``; DataParallel's ``module.``
    prefix on the I3D's)."""
    root = tmp_path_factory.mktemp("torch")
    i3d_vars = fill_variables(j_i3d_smth(**I3D_SMALL, dropout_rate=0.0), (1, 8, 32, 32, 3), seed=5)
    clstm_vars = fill_variables(JClassifier(**CLSTM_TORCH), CLSTM_SHAPE, seed=6)
    out = {"i3d": (i3d_vars, jexport.i3d_variables_to_state_dict(i3d_vars)),
           "clstm": (clstm_vars, jexport.convlstm_variables_to_state_dict(clstm_vars, **GEOMETRY))}
    assert out["clstm"][1]["endFC.weight"].shape == (3, 2 * 8 * 12 * 4)
    for name, (_, ref) in out.items():
        path = str(root / f"{name}.pth.tar")
        sd = {f"module.{k}": v for k, v in ref.items()} if name == "i3d" else ref
        jexport.save_checkpoint_file(path, sd, epoch=3, arch=name)
        out[name] += (path,)
    return out


def _import(name, path):
    ref = import_torch.load_checkpoint_file(path)
    return import_torch.i3d_state_dict(ref) if name == "i3d" else import_torch.convlstm_state_dict(ref, **GEOMETRY)


@pytest.mark.parametrize("name", ["i3d", "clstm"])
def test_reference_file_imports_to_the_converted_state_dict(torch_refs, name):
    """A reference ``.pth.tar`` that JAX's exporter wrote imports to the
    port's conversion of the same tree with equal bits, the BN counts
    included, and loads ``strict=True``; the ConvLSTM's fc read without
    its permutation would differ."""
    jvars, ref, path = torch_refs[name]
    got = _import(name, path)
    want = variables_to_state_dict(jvars)
    _same(got, want)
    (i3d_smth(**I3D_SMALL) if name == "i3d" else _port_clstm()).load_state_dict(got, strict=True)
    if name == "clstm":
        assert not torch.equal(ref["endFC.weight"], want["end_fc.weight"])


@pytest.mark.parametrize("name", ["i3d", "clstm"])
def test_export_equals_the_jax_packages(torch_refs, name):
    """The port's export of the converted tree equals the JAX package's
    export key by key: names, dtypes (the long ``num_batches_tracked``
    too) and bits; and the port's import inverts it."""
    jvars, ref, _ = torch_refs[name]
    sd = variables_to_state_dict(jvars)
    got = (export_torch.i3d_state_dict_to_reference(sd) if name == "i3d"
           else export_torch.convlstm_state_dict_to_reference(sd, **GEOMETRY))
    _same(got, ref)
    back = import_torch.i3d_state_dict(got) if name == "i3d" else import_torch.convlstm_state_dict(got, **GEOMETRY)
    _same(back, sd)


def test_checkpoint_file_has_the_reference_keys(tmp_path, torch_refs):
    """``save_checkpoint_file`` writes the reference's {'epoch', 'arch',
    'state_dict', 'best_loss'}; the JAX package's reader returns its state
    dict."""
    from ivf_tpu.utils.import_torch import load_checkpoint_file as j_load_checkpoint_file

    _, ref, _ = torch_refs["clstm"]
    path = str(tmp_path / "x.pth.tar")
    export_torch.save_checkpoint_file(path, ref, epoch=7, best_loss=0.25, arch="CLSTM_4")
    ckpt = torch.load(path, weights_only=False)
    assert sorted(ckpt) == ["arch", "best_loss", "epoch", "state_dict"]
    assert (ckpt["epoch"], ckpt["arch"], ckpt["best_loss"]) == (7, "CLSTM_4", 0.25)
    _same(j_load_checkpoint_file(path), ref)


# -- num_batches_tracked --------------------------------------------------------------


def test_batchnorm_counts_batches_as_torch_does():
    """``num_batches_tracked``: a long scalar, one added per training-mode
    call and none in eval, as ``torch.nn.BatchNorm2d``'s; the same state
    dict names; a state dict without it loads with 0."""
    port, ref = TorchBatchNorm(4, 1e-5, 0.1), torch.nn.BatchNorm2d(4)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    x = torch.randn(2, 5, 5, 4)
    for mode in ("train", "train", "eval", "train"):
        for m in (port, ref):
            getattr(m, mode)()
        port(x), ref(x.permute(0, 3, 1, 2))
    assert port.num_batches_tracked.dtype == torch.long and port.num_batches_tracked.shape == ()
    assert int(port.num_batches_tracked) == int(ref.num_batches_tracked) == 3
    fresh = TorchBatchNorm(4)
    sd = {k: v for k, v in port.state_dict().items() if k != "num_batches_tracked"}
    fresh.load_state_dict(sd, strict=True)
    assert int(fresh.num_batches_tracked) == 0


def test_trained_convlstm_exports_its_counts_and_reloads_strict(tmp_path):
    """One train step of the torch-family ConvLSTM counts its shared BN once
    per layer and step (2 x 6); the export carries the count, and the
    file imports back to the model's state dict and loads ``strict=True``."""
    model = _port_clstm()
    model.reset_parameters(torch.Generator().manual_seed(0))
    state = create_train_state(model, build_optimizer("sgd", 0.1, momentum=0.0))
    clips = torch.from_numpy(np.random.RandomState(1).rand(2, *CLSTM_SHAPE[1:]).astype(np.float32))
    make_train_step()(state, clips, torch.tensor([0, 2]))
    assert int(model.clstm.bn.num_batches_tracked) == 12
    path = str(tmp_path / "clstm.pth.tar")
    export_torch.save_checkpoint_file(path, export_torch.convlstm_state_dict_to_reference(model.state_dict(), **GEOMETRY))
    back = _import("clstm", path)
    _same(back, model.state_dict())
    _port_clstm().load_state_dict(back, strict=True)


# -- pretrained_model_path ------------------------------------------------------------

T, HW = 4, 16


def _cfg(tmp_path, family: str, path: str = "") -> TConfig:
    cfg = TConfig()
    cfg.output_dir, cfg.model_name = str(tmp_path / "out"), "run"
    m = cfg.model
    m.conv_model, m.num_classes, m.clstm_hidden, m.clstm_layers, m.conv_stride = "clstm", 3, 4, 2, 1
    m.effective_steps, m.pretrained_model_path = (1, 3), path
    if family == "tf":
        m.block_order, m.padding_clstm, m.recurrent_activation = "tf", "valid", "hard_sigmoid"
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, T, HW
    cfg.optim.num_epochs = 0
    return cfg


def _keras_names(sd: dict) -> dict:
    """The port's TF-family ConvLSTM state dict under the Keras graph's
    names (the inverse of the TF import's walk)."""
    tensors = {}
    for i in range(2):
        sfx = "" if i == 0 else f"_{i}"
        tensors[f"conv_lst_m2d{sfx}/kernel"] = sd[f"clstm.cells.{i}.wx"].permute(2, 3, 1, 0)
        tensors[f"conv_lst_m2d{sfx}/recurrent_kernel"] = sd[f"clstm.cells.{i}.wh"].permute(2, 3, 1, 0)
        tensors[f"conv_lst_m2d{sfx}/bias"] = sd[f"clstm.cells.{i}.bx"]
        for tf_name, name in (("gamma", "weight"), ("beta", "bias"), ("moving_mean", "running_mean"),
                              ("moving_variance", "running_var")):
            tensors[f"batch_normalization{sfx}/{tf_name}"] = sd[f"clstm.bns.{i}.{name}"]
    tensors["dense/kernel"] = sd["end_fc.weight"].t()
    tensors["dense/bias"] = sd["end_fc.bias"]
    return tensors


def _write(form: str, cfg: TConfig, sd: dict, root) -> str:
    if form == "tf_bundle":
        prefix = str(root / "tf" / "model.ckpt")
        tf_bundle.save_bundle(prefix, _keras_names(sd))
        return prefix
    if form == "torch_file":
        path = str(root / "model.pth.tar")
        m = cfg.model
        export_torch.save_checkpoint_file(path, export_torch.convlstm_state_dict_to_reference(
            sd, image_size=(HW, HW), conv_stride=m.conv_stride, pool_kernel=tuple(m.pool_kernel),
            lstm_layers=m.clstm_layers, nb_lstm_units=m.clstm_hidden))
        return path
    state = tapi._train_state(cfg, "cpu")
    state.model.load_state_dict(sd)
    Checkpointer(str(root / "ckpt")).save(state, epoch=2, is_best=True)
    return str(root / "ckpt")


@pytest.mark.parametrize("form", ["tf_bundle", "torch_file", "checkpoint_dir"])
def test_pretrained_model_path_gives_the_bits_of_the_weights_in_memory(tmp_path, form):
    """Each form of ``pretrained_model_path`` (a TF Saver prefix of the TF
    family, a reference ``.pth.tar`` of the torch family, a directory of the
    port's ``Checkpointer``) loads into ``init_eval_state`` and ``train``
    the weights it was written from: equal state dicts and equal logits
    against the same weights loaded in memory."""
    cfg = _cfg(tmp_path, "tf" if form == "tf_bundle" else "torch")
    weights = tapi._construct_model(cfg, False)
    weights.reset_parameters(torch.Generator().manual_seed(11))
    sd = weights.state_dict()
    cfg.model.pretrained_model_path = _write(form, cfg, sd, tmp_path)
    model, state = tapi.init_eval_state(cfg, device="cpu")
    _same(model.state_dict(), sd)
    clips = torch.from_numpy(np.random.RandomState(2).rand(2, T, HW, HW, 3).astype(np.float32) * 255)
    with torch.no_grad():
        assert torch.equal(model(clips), weights.eval()(clips))
    data = SyntheticClips(4, t=T, hw=HW, num_classes=3)
    trained, _ = tapi.train(cfg, train_dataset=data, val_dataset=data, device="cpu")
    _same(trained.model.state_dict(), sd)


def test_orbax_directory_and_missing_path_raise(tmp_path):
    """A JAX orbax checkpoint directory (written by the JAX package's
    ``Checkpointer``) raises ``NotImplementedError`` naming item 14; a path
    that is none of the forms raises ``FileNotFoundError``."""
    jmodel = JClassifier(num_classes=3, nb_lstm_units=4, lstm_layers=2, conv_stride=1, effective_steps=(1, 3))
    jstate = j_create_train_state(jmodel, jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)),
                                  j_build_optimizer("sgd", 0.1, momentum=0.0))
    ckpt = JCheckpointer(str(tmp_path / "orbax"))
    ckpt.save(jstate, epoch=0)
    ckpt.wait_until_finished()
    cfg = _cfg(tmp_path, "torch", str(tmp_path / "orbax"))
    with pytest.raises(NotImplementedError, match="orbax.*item 14"):
        tapi.init_eval_state(cfg, device="cpu")
    cfg.model.pretrained_model_path = str(tmp_path / "nothing.ckpt")
    with pytest.raises(FileNotFoundError):
        tapi.init_eval_state(cfg, device="cpu")
