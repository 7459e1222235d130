"""The port's config loading (``ivf_tpu_torch/config.py``) against the JAX
package's (``ivf_tpu/config.py``): the four presets in ``configs/``, loaded
by both packages' ``Config.load``, give equal ``to_dict()`` and
``experiment_params()`` (exact equality: the values are the presets' own
Python objects), and each builds a port model on the CPU. The one field
the JAX config lacks, ``model.pallas_pool`` (the port's branch-3 pool
kernel switch), is held at its default False and left out of the
comparison.
"""

import json
import os

import pytest
import torch

import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.models.convlstm import ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = [
    "configs/config_i3d_smth.py",
    "configs/config_i3d_kth.py",
    "configs/config_clstm_kth.py",
    "configs/config_clstm_kth_records.py",
]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the full-width models initialize: where
    test workers share the cores, threads that wait on each other make
    the builds many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_dict(cfg: TConfig) -> dict:
    d = cfg.to_dict()
    assert d["model"].pop("pallas_pool") is False
    return d


def _port_params(cfg: TConfig) -> dict:
    p = cfg.experiment_params()
    assert p.pop("model.pallas_pool") is False
    return p


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_loads_as_in_the_jax_package(preset):
    path = os.path.join(REPO, preset)
    got, want = TConfig.load(path), JConfig.load(path)
    assert _port_dict(got) == want.to_dict()
    assert _port_params(got) == want.experiment_params()


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_builds_a_port_model(preset):
    cfg = TConfig.load(os.path.join(REPO, preset))
    model = tapi.build_model(cfg, device="cpu")
    assert isinstance(model, I3D if "i3d" in preset else ConvLSTMClassifier)
    assert not model.training
    assert all(p.device.type == "cpu" and p.dtype == torch.float32 for p in model.parameters())
    if "i3d_smth" in preset:
        assert cfg.model.num_classes == 174 and cfg.data.clip_size == 16
        assert cfg.mask.opt_iter == 300 and cfg.mask.lam1 == 0.01
    if "kth" in preset:
        assert cfg.model.num_classes == 6 and cfg.data.clip_size == 32
        assert cfg.data.input_spatial_size == (120, 160)
    if preset.endswith("records.py"):
        assert cfg.data.input_mode == "records"
        assert cfg.data.train_subjects == tuple(range(1, 17))
        assert (cfg.model.conv_kernel_size, cfg.model.conv_kernel_size_2) == (3, 5)
        assert not model.clstm.shared_bn and model.clstm.x_padding == "valid"


def test_defaults_are_the_jax_packages():
    assert _port_dict(TConfig()) == JConfig().to_dict()
    assert _port_params(TConfig()) == JConfig().experiment_params()


FLAT = {
    # 0/1 ints for bools, at the top level and in sections
    "async_checkpoint": 1,
    "shuffle": 0,
    "soft_max": 1,
    "batch_norm": 0,
    "use_pallas": 1,
    "use_entire_seq": 1,
    # the reference's comma-separated string
    "stride_mod_layers": "Mixed_5b,Mixed_5c",
    # tuple keys given as lists
    "effective_steps": [3, 7],
    "pool_kernel": [3, 3],
    "record_paths_val": ["a.ivfrecords", "b.ivfrecords"],
    "val_subjects": [17, 18],
    # renamed keys
    "splitType": "alternate",
    "optIter": 12,
    "maskInitType": "random",
    "maskPerturbType": "reverse",
    "gradCamType": "true",
    "kernel_size_1": 3,
    "kernel_size_2": 5,
    # a key no field takes (the reference's configs carry extras)
    "column_units": 512,
}


def test_from_dict_reads_the_reference_keys_as_the_jax_package():
    got, want = TConfig.from_dict(FLAT), JConfig.from_dict(FLAT)
    assert _port_dict(got) == want.to_dict()
    assert got.async_checkpoint is True and got.data.shuffle is False and got.model.use_pallas is True
    assert got.model.stride_mod_layers == ("Mixed_5b", "Mixed_5c")
    assert got.data.record_paths_val == ("a.ivfrecords", "b.ivfrecords")
    assert (got.split_type, got.mask.opt_iter, got.mask.mask_init_type) == ("alternate", 12, "random")
    # a list of layers is taken as it is
    listed = TConfig.from_dict({"stride_mod_layers": ["Mixed_4b"]})
    assert listed.model.stride_mod_layers == ("Mixed_4b",)


def test_load_reads_json(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(FLAT))
    assert _port_dict(TConfig.load(str(path))) == JConfig.load(str(path)).to_dict()
