"""ivf_tpu_torch.api.find_masks end to end vs the JAX package's
find_masks, plus the port's import and device rules.

Both packages' find_masks run 4 SyntheticClips of 8x32x32 (5 classes,
opt_iter=8, central init, 'guessed' targets, Grad-CAM at Mixed_4f so the
CAM is not a single pixel) with the same numpy-drawn weights. The JAX side runs its
default flags (XLA pool, no Pallas).
"""

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict

PKG_DIR = Path(ivf_tpu_torch.__file__).resolve().parent
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
RECORD_KEYS = {
    "true_class", "pred_class", "video_id", "time_mask", "original_score_guess",
    "original_score_true", "freeze_score", "reverse_score",
}


def _jax_variables(model, seed=0, logit_scale=0.005):
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3)))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            k = rng.randn(*leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
            if any(getattr(p, "key", None) == "logits" for p in path):
                k = k * logit_scale
            return k.astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def _set_small(cfg, out_dir):
    cfg.output_dir = str(out_dir)
    cfg.model_name = "fm"
    cfg.model.num_classes = 5
    cfg.data.batch_size = 4
    cfg.mask.opt_iter = 8
    cfg.mask.top_layer = "Mixed_4f"
    return cfg


def _load_pickles(out_dir):
    res = Path(out_dir) / "fm" / "results"
    names = sorted(p.name for p in res.glob("all*Results_*.p"))
    return names, [pickle.loads((res / n).read_bytes()) for n in names]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax")
    model = j_i3d_smth(**SMALL, dropout_rate=0.0, softmax=True)
    variables = _jax_variables(model)
    cfg = _set_small(JConfig(), out)
    cfg.data.num_workers = 1
    orig = japi.build_model
    japi.build_model = lambda cfg, softmax_override=None: model
    try:
        tm, gc = japi.find_masks(
            cfg, variables, dataset=JSyntheticClips(4, t=8, hw=32, num_classes=5, lazy=False),
            save_viz=False,
        )
    finally:
        japi.build_model = orig
    return dict(out=out, tm=tm, gc=gc, sd=i3d_variables_to_state_dict(variables))


def _port_run(out_dir, sd, **model_flags):
    cfg = _set_small(TConfig(), out_dir)
    for name, value in model_flags.items():
        setattr(cfg.model, name, value)
    orig = tapi.build_model

    def small_model(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        model.pool_shape = (1, 1, 1)  # logits pool for 32x32 inputs
        return model

    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "build_model", small_model)
        tm, gc = tapi.find_masks(
            cfg, sd, SyntheticClips(4, t=8, hw=32, num_classes=5, lazy=False),
            stats=stats, device="cpu", save_viz=False,
        )
    return tm, gc, stats


@pytest.fixture(scope="module")
def pool_kernel_run(jax_run, tmp_path_factory):
    """The port's pool-kernel route: pointwise and branch-3 pool kernels."""
    out = tmp_path_factory.mktemp("pool_kernels")
    return _port_run(out, jax_run["sd"], use_pallas=True, pallas_pool=True)


@pytest.mark.parametrize("flags", [False, True], ids=["xla_path", "kernel_path"])
def test_find_masks_matches_jax(jax_run, tmp_path, flags):
    """Per-clip records, key names and pickle names against the JAX find_masks.

    Kernel path off: the same math as JAX's default path; masks atol 1e-4
    and scores atol 1e-5 after 8 Adam steps through I3D. Kernel path on:
    the forward is the same (scores, predictions, CAMs tight), but the
    branch-3 pool's every-tie backward gives another mask gradient
    (tests/test_torch_model.py shows it equal to the JAX Pallas path's), so
    the masks drift apart: 0.031 measured here after 8 steps; held at 0.05.
    """
    tm, gc, stats = _port_run(tmp_path, jax_run["sd"], use_pallas=flags, pallas_pool=flags)
    names, (gc_pickled, tm_pickled) = _load_pickles(tmp_path)
    want_names, _ = _load_pickles(jax_run["out"])
    assert names == want_names == ["allGradCamResults_fm_None_.p", "allTimeMaskResults_fm_None_.p"]
    assert stats["searched_rows"] == 4 and stats["n_steps_run"] == [8] * 4
    mask_tol, score_tol = (0.05, 0.05) if flags else (1e-4, 1e-5)
    for got, want, pickled in zip(tm, jax_run["tm"], tm_pickled):
        assert set(got) == set(want) == RECORD_KEYS
        assert set(pickled) == RECORD_KEYS
        for key in ("true_class", "pred_class", "video_id"):
            assert got[key] == want[key]
        for key in ("original_score_guess", "original_score_true"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        for key in ("freeze_score", "reverse_score"):
            np.testing.assert_allclose(got[key], want[key], atol=score_tol)
        assert got["time_mask"].shape == (8,) and got["time_mask"].dtype == np.float32
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=mask_tol)
    for got, want, pickled in zip(gc, jax_run["gc"], gc_pickled):
        assert set(got) == set(want) == set(pickled)
        assert got["GCHeatMap"].shape == (8, 32, 32)
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)


@pytest.mark.parametrize("variant", [True, "tblock"], ids=["frame", "tblock"])
def test_fused_branch3_find_masks_matches_the_pool_kernel_path(jax_run, pool_kernel_run, tmp_path, variant):
    """``fuse_pool_conv`` (with ``use_pallas``) against the pool-kernel
    route (``use_pallas`` + ``pallas_pool``): the same tie rule, and on the
    CPU the same plain ops in the same order, so the records agree to
    rounding (equal bits measured here). Masks atol 1e-4, scores 1e-5,
    CAMs 1e-4."""
    tm, gc, stats = _port_run(tmp_path, jax_run["sd"], use_pallas=True, fuse_pool_conv=variant)
    want_tm, want_gc, _ = pool_kernel_run
    assert stats["searched_rows"] == 4 and stats["n_steps_run"] == [8] * 4
    for got, want in zip(tm, want_tm):
        assert set(got) == set(want) == RECORD_KEYS
        assert got["pred_class"] == want["pred_class"]
        for key in ("original_score_guess", "original_score_true", "freeze_score", "reverse_score"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=1e-4)
    for got, want in zip(gc, want_gc):
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)


def test_find_masks_without_device_raises_when_cuda_is_absent(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _set_small(TConfig(), tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.find_masks(cfg, None, SyntheticClips(1, t=8, hw=32, num_classes=5))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.build_model(cfg)
    assert not list(Path(tmp_path).rglob("*.p"))


# the pool impls against JAX's reduce_window run: argmax_full is
# reduce_window in float32 (the argmax impls act in 16 bits), so it gets the
# kernels-off tolerances of test_find_masks_matches_jax; shift and eqbwd
# differ from it only in the backward's tie rule, so they get the pool-kernel
# route's (masks 0.05, scores 0.05). Measured, masks / scores: 4.1e-5 /
# 1.9e-6 argmax_full, 4.1e-5 / 1.7e-6 shift, 0.031 / 0.013 eqbwd. The
# forward does not depend on the impl: CAMs (3.7e-6 measured) and the
# clips' own scores stay at 1e-4 / 1e-5.
IMPL_TOL = {"argmax_full": (1e-4, 1e-5), "shift": (0.05, 0.05), "eqbwd": (0.05, 0.05)}


@pytest.mark.parametrize(
    "field,value",
    [
        ("model.pool_impl", "shift"),
        ("model.conv_model", "cnn_3d"),
        ("model.pool_impl", "eqbwd"),
        ("model.pool_impl", "argmax_full"),
        ("model.pool_impl", "select_and_scatter"),
    ],
)
def test_unported_settings_raise(jax_run, tmp_path, field, value):
    """What the port lacks raises (``cnn_3d``, and a pool impl the JAX
    package does not have either); nothing falls back. The pool impls the
    port added since run ``find_masks`` and match the JAX package's
    default run (``IMPL_TOL``)."""
    if value not in IMPL_TOL:
        cfg = _set_small(TConfig(), tmp_path)
        section, name = field.split(".")
        setattr(getattr(cfg, section), name, value)
        with pytest.raises(NotImplementedError):
            tapi.find_masks(cfg, None, SyntheticClips(1, t=8, hw=32, num_classes=5), device="cpu")
        return
    tm, gc, stats = _port_run(tmp_path, jax_run["sd"], pool_impl=value)
    mask_tol, score_tol = IMPL_TOL[value]
    assert stats["searched_rows"] == 4 and stats["n_steps_run"] == [8] * 4
    for got, want in zip(tm, jax_run["tm"]):
        assert got["pred_class"] == want["pred_class"]
        for key in ("original_score_guess", "original_score_true"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        for key in ("freeze_score", "reverse_score"):
            np.testing.assert_allclose(got[key], want[key], atol=score_tol)
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=mask_tol)
    for got, want in zip(gc, jax_run["gc"]):
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)


def _port_modules():
    names = []
    for path in sorted(PKG_DIR.rglob("*.py")):
        rel = path.relative_to(PKG_DIR.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


def test_importing_the_port_loads_no_jax():
    """Every module of the package, imported in a fresh interpreter, leaves
    jax, ivf_tpu, cv2 and matplotlib out of sys.modules."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'ivf_tpu', 'cv2', 'matplotlib'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(PKG_DIR.parent))
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", _port_modules())
def test_port_sources_import_nothing_of_jax(module):
    """No import statement of the package names jax, its libraries,
    ivf_tpu (the port copies what it needs instead), cv2 or matplotlib (the
    card host has neither; the port renders with numpy and Pillow)."""
    path = PKG_DIR.parent.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    tree = ast.parse(path.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "ivf_tpu", "cv2", "matplotlib"}, roots
    assert "import_module" not in path.read_text()
