"""``python -m ivf_tpu_torch.cli`` against the JAX package's CLI and the
port's API, on the CPU (``--device cpu``).

The flag table of the overrides is held field by field against
``ivf_tpu.config.apply_cli_overrides``; ``find-masks`` and ``train
--resume`` run a tiny torch-family ConvLSTM (2 layers x 4 units, 4
frames of 16x16) on generated JPEG trees and must give the API's bits;
``make-records`` writes the JAX package's bytes; what is not ported
raises and names its ROADMAP item. Each JAX reference runs once per
module.
"""

import argparse
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from PIL import Image

from ivf_tpu import cli as jcli
from ivf_tpu.config import Config as JConfig
from ivf_tpu.config import _OVERRIDES as J_OVERRIDES
from ivf_tpu.config import add_cli_overrides as j_add_cli_overrides
from ivf_tpu.config import apply_cli_overrides as j_apply_cli_overrides
from ivf_tpu_torch import api as tapi
from ivf_tpu_torch import cli
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.config import add_cli_overrides, apply_cli_overrides
from ivf_tpu_torch.data.records import RecordReader
from ivf_tpu_torch.utils import export_torch
from ivf_tpu_torch.utils.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parents[1]
T, HW, CLASSES = 4, 16, 3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- the override flags -------------------------------------------------------------


def _override_argv(short: bool) -> list:
    """One value for every flag of the JAX package's table, each distinct
    from its default; ``--iteration`` too."""
    defaults = dataclasses.asdict(JConfig())
    argv = []
    for i, (flag, short_flag, dest, typ) in enumerate(J_OVERRIDES):
        section, name = dest.split(".") if "." in dest else (None, dest)
        default = defaults[section][name] if section else defaults[name]
        if dest == "model.stride_mod_layers":
            value = "Mixed_4b,,Mixed_5b"
        elif typ is str:
            value = f"v{i}"
        elif typ is int and (isinstance(default, bool) or name == "refill"):
            value = "0" if default or default is None else "1"
        elif typ is int:
            value = str(i + 100)
        else:
            value = str(0.125 * i)
        argv += [short_flag if short else flag, value]
    return argv + ["-i" if short else "--iteration", "7"]


@pytest.mark.parametrize("short", [False, True], ids=["long", "short"])
def test_cli_overrides_set_the_fields_the_jax_package_sets(short):
    """One argv that sets every flag, through both packages' parsers and
    ``apply_cli_overrides``: the port's config equals the JAX package's
    field by field (``dataclasses.asdict``; the port's one extra field,
    ``pallas_pool``, untouched), with the bool coercion of ``refill``
    (``Optional[bool]``), the split ``--mod_stride_layers`` and the
    ``--iteration`` suffix on ``model_name``."""
    argv = _override_argv(short)
    jp, tp = argparse.ArgumentParser(), argparse.ArgumentParser()
    j_add_cli_overrides(jp)
    add_cli_overrides(tp)
    want = dataclasses.asdict(j_apply_cli_overrides(JConfig(), jp.parse_args(argv)))
    got = dataclasses.asdict(apply_cli_overrides(TConfig(), tp.parse_args(argv)))
    defaults = dataclasses.asdict(JConfig())
    for section, fields in want.items():
        if not isinstance(fields, dict):
            assert got[section] == fields, section
            continue
        for name, value in fields.items():
            assert got[section][name] == value and type(got[section][name]) is type(value), (section, name)
    assert got["model"]["pallas_pool"] == dataclasses.asdict(TConfig())["model"]["pallas_pool"]
    for _, _, dest, _ in J_OVERRIDES:
        section, name = dest.split(".") if "." in dest else (None, dest)
        before = defaults[section][name] if section else defaults[name]
        after = got[section][name] if section else got[name]
        assert after != before or dest == "model_name", dest
    assert got["mask"]["refill"] is False and got["model"]["stride_mod_layers"] == ("Mixed_4b", "Mixed_5b")
    # the suffix goes on first, and --subDir then sets the name, in both
    assert got["model_name"] == want["model_name"] == f"v{[d for *_, d, _ in J_OVERRIDES].index('model_name')}"
    only = ["-i" if short else "--iteration", "7"]
    assert apply_cli_overrides(TConfig(), tp.parse_args(only)).model_name == "model7"
    assert j_apply_cli_overrides(JConfig(), jp.parse_args(only)).model_name == "model7"


# -- runs on generated trees --------------------------------------------------------


def _jpeg_tree(root, split: str, n: int, seed: int) -> None:
    clips = np.random.RandomState(seed).randint(0, 256, (n, T, HW, HW, 3)).astype(np.uint8)
    for i, clip in enumerate(clips):
        d = os.path.join(root, split, str(i % CLASSES), f"{split}{i}")
        os.makedirs(d, exist_ok=True)
        for k, frame in enumerate(clip):
            Image.fromarray(frame).save(os.path.join(d, f"frame{k + 1:02d}.jpg"), "JPEG", quality=95)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``<root>/{train,validation}/<class>/<clip_id>/frameNN.jpg``: 8 and 4
    clips of 4 frames of 16x16."""
    root = str(tmp_path_factory.mktemp("tree"))
    _jpeg_tree(root, "train", 8, 0)
    _jpeg_tree(root, "validation", 4, 1)
    return root


def _config_file(tmp_path, tree, name: str, **extra) -> str:
    """A reference-style flat config (``Config.load`` of a .json)."""
    flat = {
        "model_name": name, "output_dir": str(tmp_path / "out"), "data_folder": tree, "clip_size": T,
        "input_spatial_size": HW, "batch_size": 4, "num_workers": 2, "conv_model": "clstm",
        "num_classes": CLASSES, "clstm_hidden": 4, "clstm_layers": 2, "conv_stride": 1,
        "effective_steps": [1, 3], "dropout": 0.0, "optIter": 3, "lr": 0.01, **extra,
    }
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(flat))
    return str(path)


def _records(run_dir: Path) -> dict:
    """The run's pickles by file name, its run name taken out."""
    out = {}
    for p in sorted(run_dir.rglob("*.p")):
        with open(p, "rb") as f:
            out[p.relative_to(run_dir).as_posix().replace(f"_{run_dir.name}_", "_")] = pickle.load(f)
    return out


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    return a == b


def test_find_masks_from_a_reference_checkpoint_gives_the_apis_bits(tmp_path, tree):
    """``find-masks --checkpoint <reference .pth.tar> --device cpu`` (the
    bf16 gate-kernel route, ``-cdt bfloat16 -pls 1``) writes the pickles of
    ``api.find_masks`` with the same weights passed in memory, bit for
    bit; ``grad-cam`` writes the Grad-CAM records alone."""
    cfg_path = _config_file(tmp_path, tree, "cli")
    cfg = TConfig.load(cfg_path)
    model = tapi._construct_model(cfg, False)
    model.reset_parameters(torch.Generator().manual_seed(5))
    weights = model.state_dict()
    pth = str(tmp_path / "clstm.pth.tar")
    m = cfg.model
    export_torch.save_checkpoint_file(pth, export_torch.convlstm_state_dict_to_reference(
        weights, image_size=(HW, HW), conv_stride=m.conv_stride, pool_kernel=tuple(m.pool_kernel),
        lstm_layers=m.clstm_layers, nb_lstm_units=m.clstm_hidden))
    flags = ["-cdt", "bfloat16", "-pls", "1"]
    got = cli.main(["find-masks", "-c", cfg_path, "--checkpoint", pth, "--device", "cpu", *flags])
    api_cfg = TConfig.load(_config_file(tmp_path, tree, "api"))
    api_cfg.model.compute_dtype, api_cfg.model.use_pallas = "bfloat16", True
    want = tapi.find_masks(api_cfg, weights, device="cpu")
    assert len(want[0]) == 4 and _equal(got, want)
    got_files, want_files = _records(tmp_path / "out" / "cli"), _records(tmp_path / "out" / "api")
    assert got_files and _equal(got_files, want_files)
    cams = cli.main(["grad-cam", "-c", _config_file(tmp_path, tree, "cam"), "--checkpoint", pth, "--device", "cpu",
                     *flags])
    assert cams[0] == [] and _equal(cams[1], want[1])


def test_train_resume_and_export_give_the_apis_bits(tmp_path, tree):
    """``train -ne 1`` then ``train -ne 2 --resume`` (bf16, gate kernel
    route) end with the state of ``api.train`` over two epochs, bit for
    bit; ``export-checkpoint`` of that run's directory (its ``model_best``)
    writes a reference file that loads back with the same weights and BN
    count; ``infer`` runs from it."""
    flags = ["--device", "cpu", "-cdt", "bfloat16", "-pls", "1"]
    cfg_path = _config_file(tmp_path, tree, "cli")
    cli.main(["train", "-c", cfg_path, "-ne", "1", *flags])
    state, history = cli.main(["train", "-c", cfg_path, "-ne", "2", "--resume", *flags])
    assert [h["epoch"] for h in history] == [1]
    api_cfg = TConfig.load(_config_file(tmp_path, tree, "api", num_epochs=2))
    api_cfg.model.compute_dtype, api_cfg.model.use_pallas = "bfloat16", True
    want, _ = tapi.train(api_cfg, device="cpu")
    for name, t in want.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[name], t), name
    out = str(tmp_path / "export.pth.tar")
    sd = cli.main(["export-checkpoint", "-c", cfg_path, "--checkpoint", str(tmp_path / "out" / "cli"),
                   "--out", out, "--device", "cpu"])
    cfg = TConfig.load(cfg_path)
    cfg.model.pretrained_model_path = out
    loaded, _ = tapi.init_eval_state(cfg, device="cpu")
    best = Checkpointer(str(tmp_path / "out" / "cli")).load_variables("model_best")  # what a directory gives
    assert sorted(best) == sorted(loaded.state_dict())
    for name, t in loaded.state_dict().items():
        assert torch.equal(best[name], t), name
    assert int(loaded.clstm.bn.num_batches_tracked) == 2 * 2 * T  # one epoch of 2 steps: layers x frames each
    assert sorted(sd) == sorted(torch.load(out, weights_only=False)["state_dict"])
    res = cli.main(["infer", "-c", cfg_path, "--checkpoint", out, "--device", "cpu"])
    assert np.load(tmp_path / "out" / "cli" / "y_hat.npy").shape == (4,) and np.isfinite(res["loss"])


@pytest.fixture(scope="module")
def jax_records(tree, tmp_path_factory):
    """The JAX package's ``make-records`` over the validation tree."""
    out = str(tmp_path_factory.mktemp("jrec") / "val.ivfrecords")
    jcli.main(["make-records", "--frames-root", os.path.join(tree, "validation"), "--out", out, "--nb-frames", "3"])
    return out


def test_make_and_inspect_records_match_the_jax_package(tmp_path, tree, jax_records, capsys):
    """``make-records`` writes the JAX package's bytes; ``inspect-records``
    reads record 2 back, in this process and through ``python -m
    ivf_tpu_torch.cli``."""
    out = str(tmp_path / "val.ivfrecords")
    cli.main(["make-records", "--frames-root", os.path.join(tree, "validation"), "--out", out, "--nb-frames", "3"])
    assert Path(out).read_bytes() == Path(jax_records).read_bytes()
    meta, frames = cli.main(["inspect-records", out, "--index", "2"])
    want_meta, want_frames = RecordReader(out).read(2)
    assert meta == want_meta and np.array_equal(frames, want_frames) and frames.shape == (3, HW, HW, 3)
    proc = subprocess.run([sys.executable, "-m", "ivf_tpu_torch.cli", "inspect-records", out, "--index", "2"],
                          capture_output=True, text=True, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "4 records" in proc.stdout and "(3, 16, 16, 3)" in proc.stdout


@pytest.mark.parametrize(
    "argv,error,match",
    [
        (["infer", "-dp", "2"], RuntimeError, "process group"),
        (["find-masks", "--multihost", "-dp", "2"], ValueError, "2-rank mesh in a world of 1"),
        (["grad-cam", "--profile", "{tmp}/trace", "-c", "{tmp}/missing.json"], FileNotFoundError, "missing"),
    ],
    ids=["data-parallel", "multihost", "profile"],
)
def test_unported_commands_and_flags_raise(argv, error, match, monkeypatch, tmp_path):
    """``-dp 2`` with no process group raises; ``--multihost`` joins the
    JAX package's coordinator (here a world of one gloo rank over a
    ``file://`` store), and ``-dp 2`` that is not the world's size raises.
    ``--profile`` (ported: it raised before) lets the error of the command
    it wraps through and still writes its trace."""
    argv = [a.format(tmp=tmp_path) for a in argv]
    for name in ("MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    if "--multihost" in argv:
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"file://{tmp_path / 'rendezvous'}")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
        monkeypatch.setenv("JAX_PROCESS_ID", "0")
    try:
        with pytest.raises(error, match=match):
            cli.main(argv + ["--device", "cpu"])
        assert dist.is_initialized() == ("--multihost" in argv)
        if "--profile" in argv:
            assert list((tmp_path / "trace").glob("*.pt.trace.json"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_device_defaults_to_cuda_and_detect_anomaly_is_on(tmp_path, tree, monkeypatch):
    """``--device`` defaults to ``cuda``: with no card the API raises; with
    ``--detect-anomaly`` the command runs under
    ``torch.autograd.set_detect_anomaly``."""
    cfg_path = _config_file(tmp_path, tree, "dev")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["infer", "-c", cfg_path])
    seen = []
    monkeypatch.setattr(tapi, "infer", lambda cfg, device: seen.append((torch.is_anomaly_enabled(), device))
                        or {"loss": 0.0, "top1": 0.0, "top5": 0.0})
    cli.main(["infer", "-c", cfg_path, "--device", "cpu", "--detect-anomaly"])
    cli.main(["infer", "-c", cfg_path, "--device", "cpu"])
    assert seen == [(True, "cpu"), (False, "cpu")]
