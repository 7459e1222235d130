"""``ivf_tpu_torch/utils/profiling.py``, the CLI's ``--profile`` and
``--detect-anomaly``, the package re-exports and the quickstart, on the
CPU, against the JAX package's counterparts where it has them.

``detect_anomaly`` must raise in the forward where the JAX package's
``jax_debug_nans`` does (``tests/test_aux.py::test_profiling_utils``: 0 / 0)
and in the backward; ``trace`` and ``--profile`` must write a trace that
names the ops they ran. The quickstart runs at its own tiny size on the
CPU (~10 s).
"""

import json
import os

import numpy as np
import pytest
import torch

import ivf_tpu.interpret as j_interpret
import ivf_tpu.ops as j_ops
from ivf_tpu.utils.profiling import StepTimer as JStepTimer
from ivf_tpu_torch import cli, quickstart
from ivf_tpu_torch.utils import profiling
from ivf_tpu_torch.utils.profiling import StepTimer, detect_anomaly, trace


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_step_timer_matches_jax(monkeypatch):
    """The same meter, read on one clock: mean step time, clips/s, report."""
    clock = iter([10.0, 10.5, 20.0, 21.5] * 2)
    monkeypatch.setattr(profiling.time, "time", lambda: next(clock))
    import ivf_tpu.utils.profiling as jp

    monkeypatch.setattr(jp.time, "time", lambda: next(clock))
    meters = []
    for cls in (StepTimer, JStepTimer):
        t = cls()
        assert t.mean_step_time == 0.0 and t.clips_per_sec == 0.0
        for n in (8, 4):
            t.start()
            t.stop(n_clips=n)
        meters.append((t.times, t.mean_step_time, t.clips_per_sec, t.report()))
    assert meters[0] == meters[1]
    assert meters[0][1] == 1.0 and meters[0][2] == 6.0 and "clips/sec" in meters[0][3]


def test_detect_anomaly_raises_in_the_forward_and_the_backward():
    """0 / 0 raises at the division (the JAX test's case); a NaN made by a
    backward raises there; nothing raises outside the block or with
    ``enable=False``; autograd's anomaly mode is on inside only."""
    zero = torch.zeros(())
    with detect_anomaly(True):
        assert torch.is_anomaly_enabled()
        torch.empty(1000)  # an allocation holds whatever was there: not read
        with pytest.raises(FloatingPointError, match="div"):
            zero / zero
    assert not torch.is_anomaly_enabled()
    assert torch.isnan(zero / zero)
    with detect_anomaly(False):
        assert not torch.is_anomaly_enabled()
        zero / zero
    x = torch.zeros(3, requires_grad=True)
    y = torch.sqrt(x) * torch.zeros(3)  # d sqrt at 0 is inf; inf * 0 is NaN
    with detect_anomaly(True), pytest.raises(FloatingPointError):
        y.sum().backward()


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with trace(str(tmp_path)):
        torch.nn.functional.conv3d(torch.randn(1, 2, 4, 4, 4), torch.randn(3, 2, 3, 3, 3)).sum()
    (path,) = tmp_path.glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert "aten::conv3d" in names and "aten::sum" in names


def _tiny_config(tmp_path) -> str:
    data = tmp_path / "data"
    quickstart.make_synthetic_dataset(str(data), clips_per_class=1, t=4, hw=16)
    cfg = {"model_name": "p", "output_dir": str(tmp_path / "runs"), "data_folder": str(data),
           "conv_model": "clstm", "num_classes": 2, "batch_size": 2, "clip_size": 4, "input_spatial_size": 16,
           "clstm_hidden": 4, "clstm_layers": 1, "conv_stride": 1, "num_workers": 1, "optIter": 5}
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_profile_and_detect_anomaly(tmp_path):
    """``find-masks --profile DIR`` writes a trace of the search (the
    ConvLSTM's convs and the mask's Adam steps); ``--detect-anomaly`` runs
    the same search to its end: no op of the port's search path makes a
    NaN."""
    cfg = _tiny_config(tmp_path)
    out = cli.main(["find-masks", "-c", cfg, "--device", "cpu", "--profile", str(tmp_path / "trace")])
    (path,) = (tmp_path / "trace").glob("*.pt.trace.json")
    names = {e.get("name") for e in json.loads(path.read_text())["traceEvents"]}
    assert {"aten::conv2d", "aten::sigmoid", "aten::sqrt"} <= names
    again = cli.main(["find-masks", "-c", cfg, "--device", "cpu", "--detect-anomaly"])
    assert len(out[0]) == len(again[0]) == 2
    for a, b in zip(out[0], again[0]):
        np.testing.assert_array_equal(a["time_mask"], b["time_mask"])


@pytest.mark.parametrize("package", ["interpret", "ops"])
def test_reexported_names_match_jax(package):
    """The JAX package's ``__all__`` lists, every name importable."""
    import importlib

    port = importlib.import_module(f"ivf_tpu_torch.{package}")
    jax_pkg = {"interpret": j_interpret, "ops": j_ops}[package]
    assert port.__all__ == jax_pkg.__all__
    assert all(callable(getattr(port, name)) for name in port.__all__)


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    """``python -m ivf_tpu_torch.quickstart DIR --cpu``: two epochs, the
    inference files, masks and CAMs for the first batch, the artifacts."""
    res = quickstart.main([str(tmp_path), "--cpu"])
    assert len(res["history"]) == 2 and len(res["masks"]) == len(res["cams"]) == 4
    assert all(np.isfinite(r["time_mask"]).all() for r in res["masks"])
    assert res["files"]["results"] > 0 and res["files"]["cam_saved_images"] > 0
    run = tmp_path / "runs" / "quickstart"
    assert all(os.path.exists(run / n) for n in ("y_true.npy", "y_hat.npy"))
    assert "temporal masks" in capsys.readouterr().out
