"""``find_masks`` from the config's data (``ivf_tpu_torch/api.py``:
``build_dataset``, ``build_loader``, ``find_masks(dataset=None, split=...)``)
and ``grad_cam_run``, on the CPU against the JAX package.

I3D at 8x32x32 (5 classes, logits pool (1, 1, 1), Grad-CAM at Mixed_4f,
numpy-drawn weights, as ``tests/test_torch_api.py``) over a frame tree
``validation/<class>/<clip_id>/frameNN.jpg`` of 6 clips in loader batches
of 4: the port's run from the tree gives each clip the bits of the same
decoded clips handed over as a list, and matches the JAX ``find_masks``
on the same tree (one JAX run per module): scores atol 1e-5 and CAMs 1e-4
as in ``tests/test_torch_api.py``, masks 2e-4 (after 8 Adam steps, five
clips agree to <= 5e-6 and one, vid1, to 1.1e-4: float32 rounding that
its search amplifies, its scores 7.4e-6 apart; the test there holds its
four clips at 1e-4).
``build_dataset`` gives the JAX package's items for every layout (frame
trees by split and step size, KTH trees with the ``validation`` -> ``test``
-> flat-root fallback, record shards by split, by per-subject selection
and as ``.tfrecords``), and runs from records and from a KTH tree have the
bits of their lists. ``grad_cam_run`` matches the JAX one for I3D and the
ConvLSTM (CAMs atol 1e-4).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data import tfrecords as jtf
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data import RecordWriter
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict, i3d_variables_to_state_dict

T, HW, CLASSES, STEPS, N_CLIPS = 8, 32, 5, 8, 6
SCORES = ("original_score_guess", "original_score_true", "freeze_score", "reverse_score")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the tiny models' ops are too small to share, and
    under test workers that share the cores, waiting threads slow the runs
    many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jpeg_tree(clips_by_dir: dict) -> None:
    from PIL import Image

    for d, clip in clips_by_dir.items():
        os.makedirs(d, exist_ok=True)
        for i, frame in enumerate(clip):
            Image.fromarray(frame).save(os.path.join(d, f"frame{i + 1:02d}.jpg"), "JPEG", quality=95)


def _clips(n, t=T, h=HW, w=HW, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, t, h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """``<root>/validation/<class>/<clip_id>/`` (6 clips, 8 frames of 32x32)
    and a ``train`` split of 16 frames (read at step size 2)."""
    root = tmp_path_factory.mktemp("smth")
    clips = _clips(N_CLIPS)
    _jpeg_tree({os.path.join(root, "validation", str(i % CLASSES), f"vid{i}"): clips[i] for i in range(N_CLIPS)})
    train = _clips(2, t=2 * T, seed=1)
    _jpeg_tree({os.path.join(root, "train", str(i), f"tr{i}"): train[i] for i in range(2)})
    return str(root)


def _i3d_variables(model, seed=0, logit_scale=0.005):
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)))

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


@pytest.fixture(scope="module")
def i3d(tmp_path_factory):
    model = j_i3d_smth(num_classes=CLASSES, pool_shape=(1, 1, 1), dropout_rate=0.0, softmax=True)
    variables = _i3d_variables(model)
    return dict(model=model, variables=variables, sd=i3d_variables_to_state_dict(variables))


def _i3d_cfg(cfg, data_folder, out_dir, name="fm"):
    cfg.output_dir, cfg.model_name = str(out_dir), name
    cfg.data.data_folder = data_folder
    cfg.data.clip_size, cfg.data.input_spatial_size, cfg.data.batch_size = T, HW, 4
    cfg.model.num_classes = CLASSES
    cfg.mask.opt_iter = STEPS
    cfg.mask.top_layer = "Mixed_4f"
    return cfg


def _small_i3d(monkeypatch):
    orig = tapi.build_model

    def small(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        if hasattr(model, "pool_shape"):
            model.pool_shape = (1, 1, 1)  # logits pool for 32x32 inputs
        return model

    monkeypatch.setattr(tapi, "build_model", small)


def _port_run(cfg, sd, dataset=None, split="validation"):
    stats = {}
    with pytest.MonkeyPatch.context() as mp:
        _small_i3d(mp)
        tm, gc = tapi.find_masks(cfg, sd, dataset, stats=stats, device="cpu", split=split, save_viz=False)
    return tm, gc, stats


def _assert_same_bits(a, b):
    """Two runs' records and CAMs equal bit for bit per clip id."""
    (tm_a, gc_a), (tm_b, gc_b) = a[:2], b[:2]
    by_id = lambda rows: {r["video_id"]: r for r in rows}  # noqa: E731
    ta, tb, ga, gb = by_id(tm_a), by_id(tm_b), by_id(gc_a), by_id(gc_b)
    assert set(ta) == set(tb) and set(ga) == set(gb) and (ta or ga)
    for vid in ta:
        assert set(ta[vid]) == set(tb[vid])
        np.testing.assert_array_equal(ta[vid]["time_mask"], tb[vid]["time_mask"])
        assert all(ta[vid][k] == tb[vid][k] for k in SCORES + ("true_class", "pred_class"))
    for vid in ga:
        np.testing.assert_array_equal(ga[vid]["GCHeatMap"], gb[vid]["GCHeatMap"])


def _items(dataset):
    return [dataset[i] for i in range(len(dataset))]


@pytest.fixture(scope="module")
def jax_tree_run(i3d, tree, tmp_path_factory):
    """The JAX package's find_masks over the frame tree's validation split."""
    cfg = _i3d_cfg(JConfig(), tree, tmp_path_factory.mktemp("jax_tree"))
    cfg.data.num_workers = 1
    orig = japi.build_model
    japi.build_model = lambda cfg, softmax_override=None: i3d["model"]
    try:
        stats = {}
        tm, gc = japi.find_masks(cfg, i3d["variables"], split="validation", save_viz=False, stats=stats)
    finally:
        japi.build_model = orig
    return tm, gc, stats


@pytest.fixture(scope="module")
def port_tree_run(i3d, tree, tmp_path_factory):
    return _port_run(_i3d_cfg(TConfig(), tree, tmp_path_factory.mktemp("port_tree")), i3d["sd"])


def test_tree_run_has_the_bits_of_the_list(i3d, tree, port_tree_run, tmp_path):
    """``dataset=None`` reads the tree through build_dataset and the loader;
    the same decoded clips and ids handed over as a list give equal bits."""
    cfg = _i3d_cfg(TConfig(), tree, tmp_path)
    items = _items(tapi.build_dataset(cfg, "validation", get_item_id=True))
    assert sorted(it[2] for it in items) == [f"vid{i}" for i in range(N_CLIPS)]
    listed = _port_run(cfg, i3d["sd"], items)
    _assert_same_bits(port_tree_run, listed)
    st = port_tree_run[2]
    assert (st["search_launches"], st["searched_rows"], st["padded_rows"]) == (2, N_CLIPS, 2)


def test_tree_run_matches_jax(port_tree_run, jax_tree_run):
    """Against the JAX find_masks on the same tree: the same ids, classes,
    counters and order; masks atol 2e-4, scores 1e-5, CAMs 1e-4 (module
    docstring)."""
    tm, gc, st = port_tree_run
    want_tm, want_gc, want_st = jax_tree_run
    assert [r["video_id"] for r in tm] == [r["video_id"] for r in want_tm]
    keys = ("score_launches", "search_launches", "searched_rows", "padded_rows")
    assert {k: st[k] for k in keys} == {k: want_st[k] for k in keys}
    for got, want in zip(tm, want_tm):
        assert set(got) == set(want)
        assert (got["true_class"], got["pred_class"]) == (want["true_class"], want["pred_class"])
        for key in SCORES:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=2e-4)
    for got, want in zip(gc, want_gc):
        assert got["video_id"] == want["video_id"]
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)


def test_split_train_reads_the_train_tree(i3d, tree, tmp_path):
    """``split='train'`` reads ``<data_folder>/train`` at ``step_size_train``."""
    cfg = _i3d_cfg(TConfig(), tree, tmp_path)
    cfg.data.step_size_train = 2
    cfg.mask.opt_iter = 1
    tm, gc, _ = _port_run(cfg, i3d["sd"], split="train")
    assert sorted(r["video_id"] for r in tm) == ["tr0", "tr1"] and gc[0]["GCHeatMap"].shape == (T, HW, HW)


# -- build_dataset over every layout, against the JAX package -------------------


# KTH clip tags, the second and fifth off the ``original`` whitelist
KTH_TAGS = ("person17_boxing_d1_1", "person05_boxing_d1_1", "person18_handwaving_d3_1", "person17_boxing_d2_1",
            "person25_walking_d1_1")


def _kth_tree(root, n, t=T, h=HW, w=HW, seed=2):
    clips = _clips(n, t, h, w, seed)
    _jpeg_tree({os.path.join(root, str(i)): clips[i] for i in range(n)})
    for i in range(n):
        with open(os.path.join(root, str(i), "class.txt"), "w") as f:
            f.write(f"{i % 2}\n")
        with open(os.path.join(root, str(i), "label.txt"), "w") as f:
            f.write(f"{KTH_TAGS[i]}\n")


@pytest.fixture(scope="module")
def layouts(tree, tmp_path_factory):
    """Data roots of each layout build_dataset reads."""
    root = tmp_path_factory.mktemp("layouts")
    kth_test, kth_flat, kth_val = (str(root / n) for n in ("kth_test", "kth_flat", "kth_val"))
    _kth_tree(os.path.join(kth_test, "test"), 3)
    _kth_tree(os.path.join(kth_test, "train"), 2, seed=3)
    _kth_tree(kth_flat, 5)
    _kth_tree(os.path.join(kth_val, "validation"), 2, seed=4)
    _kth_tree(os.path.join(kth_val, "test"), 3, seed=5)
    clips = _clips(5, seed=6)
    records = root / "records"
    records.mkdir()
    for s in (17, 18, 19):  # KTH per-subject shards, and split shards
        with RecordWriter(str(records / f"kth_subject_{s}.ivfrecords")) as w:
            for k in range(s - 16):
                w.write(clips[k], label=k % 2, video_id=f"s{s}_{k}", extra={"subject": s})
    from PIL import Image
    import io

    def jpeg(frame):
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, "JPEG", quality=95)
        return buf.getvalue()

    jtf.write_tfrecord(str(records / "val.tfrecords"), [
        jtf.build_example(f"tf{k}", k, [jpeg(f) for f in clips[k][: 4 + k]], height=HW, width=HW) for k in range(3)
    ])
    return dict(tree=tree, kth_test=kth_test, kth_flat=kth_flat, kth_val=kth_val, records=str(records))


def _layout_cfg(cfg, layouts, layout):
    cfg.data.clip_size = T
    if layout.startswith("kth"):
        cfg.model.conv_model = "clstm_kth"
        cfg.data.data_folder = layouts[layout]
    elif layout == "smth":
        cfg.data.data_folder = layouts["tree"]
        cfg.data.step_size_train = 2
    elif layout == "records_split":
        cfg.data.input_mode = "records"
        cfg.data.record_paths = (os.path.join(layouts["records"], "kth_subject_19.ivfrecords"),)
        cfg.data.record_paths_val = (os.path.join(layouts["records"], "kth_subject_18.ivfrecords"),)
    elif layout == "records_subjects":
        cfg.data.input_mode = "records"
        cfg.data.records_folder = layouts["records"]
        cfg.data.train_subjects, cfg.data.val_subjects = (17,), (18, 19)
    elif layout == "tfrecords":
        cfg.data.input_mode = "tfrecords"
        cfg.data.record_paths = (os.path.join(layouts["records"], "val.tfrecords"),)
    return cfg


@pytest.mark.parametrize("split", ["validation", "train"])
@pytest.mark.parametrize(
    "layout", ["smth", "kth_test", "kth_flat", "kth_val", "records_split", "records_subjects", "tfrecords"]
)
def test_build_dataset_is_the_jax_packages(layouts, layout, split):
    got = tapi.build_dataset(_layout_cfg(TConfig(), layouts, layout), split, get_item_id=True)
    want = japi.build_dataset(_layout_cfg(JConfig(), layouts, layout), split, get_item_id=True)
    assert type(got).__name__ == type(want).__name__
    assert len(got) == len(want)
    for a, b in zip(_items(got), _items(want)):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].shape[0] == T and tuple(a[1:]) == tuple(b[1:])
    # KTH: the eval split falls back from validation to test, a split with
    # no directory to the flat root (kth_val has no numbered dirs there)
    roots = {
        ("kth_test", "validation"): "test", ("kth_test", "train"): "train",
        ("kth_flat", "validation"): "", ("kth_flat", "train"): "",
        ("kth_val", "validation"): "validation", ("kth_val", "train"): "",
    }
    if layout.startswith("kth"):
        assert got.root == os.path.join(layouts[layout], roots[layout, split]).rstrip("/")
    assert len(got) > 0 or (layout, split) == ("kth_val", "train")


def _clstm_cfg(cfg, out_dir, name="fm"):
    cfg.output_dir, cfg.model_name = str(out_dir), name
    m = cfg.model
    m.conv_model, m.num_classes, m.clstm_hidden, m.clstm_layers, m.conv_stride = "clstm_kth", 2, 4, 1, 1
    m.effective_steps, m.dropout = (3, 7), 0.0
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, T, HW
    cfg.mask.opt_iter = 4
    return cfg


def _clstm_variables(model, seed):
    """Numpy-drawn variables for a JAX ConvLSTMClassifier, as
    ``tests/test_torch_convlstm.py`` draws them: unit-fan-in cell kernels
    (the first layer's over 128, for raw 0-255 frames), random biases, BN
    parameters and statistics."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)))

    def fill(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        if names[-1] in ("wx", "wh", "kernel"):
            k = rng.randn(*leaf.shape) / np.sqrt(int(np.prod(leaf.shape[:-1])))
            if names[-1] == "wx" and "cells_0" in names:
                k = k / 128.0
            return k.astype(np.float32)
        if names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def clstm(tmp_path_factory):
    cfg = _clstm_cfg(JConfig(), tmp_path_factory.mktemp("clstm_init"))
    model = japi.build_model(cfg, softmax_override=True)
    variables = _clstm_variables(model, seed=1)
    return dict(cfg=cfg, variables=variables, sd=convlstm_variables_to_state_dict(variables))


@pytest.mark.parametrize("kth_filter", [False, True], ids=["all", "whitelist"])
def test_kth_tree_run_has_the_bits_of_the_list(clstm, layouts, tmp_path, kth_filter):
    """The ConvLSTM over a flat KTH tree (``validation`` falls back to the
    root): the bits of the same clips as a list; with the whitelist filter
    only the whitelisted tags run."""
    cfg = _clstm_cfg(TConfig(), tmp_path)
    cfg.data.data_folder = layouts["kth_flat"]
    cfg.mask.kth_clips_filter = kth_filter
    items = _items(tapi.build_dataset(cfg, "validation", get_item_id=True))
    tree_run = tapi.find_masks(cfg, clstm["sd"], device="cpu", save_viz=False)
    cfg.model_name = "list"
    _assert_same_bits(tree_run, tapi.find_masks(cfg, clstm["sd"], items, device="cpu", save_viz=False))
    ids = sorted(r["video_id"] for r in tree_run[0])
    assert ids == sorted(t for t in KTH_TAGS if not kth_filter or t not in KTH_TAGS[1::3])


def test_records_run_has_the_bits_of_the_list(i3d, layouts, tmp_path):
    """``input_mode='records'`` with per-subject shards: the validation
    subjects' records run, with the bits of their decoded clips as a list."""
    cfg = _layout_cfg(_i3d_cfg(TConfig(), "", tmp_path), layouts, "records_subjects")
    items = _items(tapi.build_dataset(cfg, "validation", get_item_id=True))
    run = _port_run(cfg, i3d["sd"])
    assert sorted(r["video_id"] for r in run[0]) == sorted(f"s{s}_{k}" for s in (18, 19) for k in range(s - 16))
    cfg.model_name = "list"
    _assert_same_bits(run, _port_run(cfg, i3d["sd"], items))


# -- grad_cam_run ---------------------------------------------------------------


@pytest.mark.parametrize("targets", [None, [3, None, 0]], ids=["predicted", "given"])
def test_grad_cam_run_i3d_matches_jax(i3d, tree, tmp_path, monkeypatch, targets):
    """The standalone per-clip Grad-CAM on uint8 clips: CAMs atol 1e-4."""
    clips = np.stack([it[0] for it in _items(tapi.build_dataset(
        _i3d_cfg(TConfig(), tree, tmp_path), "validation", get_item_id=True))[:3]])
    _small_i3d(monkeypatch)
    got = tapi.grad_cam_run(_i3d_cfg(TConfig(), tree, tmp_path), i3d["sd"], clips, targets, device="cpu")
    monkeypatch.setattr(japi, "build_model", lambda cfg, softmax_override=None: i3d["model"])
    want = japi.grad_cam_run(_i3d_cfg(JConfig(), tree, tmp_path), i3d["variables"], clips, targets)
    assert got.shape == want.shape == (3, T, HW, HW) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("family", ["torch", "tf"])
def test_grad_cam_run_convlstm_matches_jax(clstm, tmp_path, family):
    """The ConvLSTM's per-clip Grad-CAM (channel weights over the clip for
    the torch family, per frame for the TF family): CAMs atol 1e-4."""
    clips = _clips(2, seed=9)
    got_cfg, want_cfg = _clstm_cfg(TConfig(), tmp_path), _clstm_cfg(JConfig(), tmp_path)
    variables = clstm["variables"]
    if family == "tf":
        for cfg in (got_cfg, want_cfg):
            cfg.model.block_order = "tf"
        variables = _clstm_variables(japi.build_model(want_cfg, softmax_override=True), seed=2)
    got = tapi.grad_cam_run(got_cfg, convlstm_variables_to_state_dict(variables), clips, [1, None], device="cpu")
    want = japi.grad_cam_run(want_cfg, variables, clips, [1, None])
    assert got.shape == (2, T, HW, HW)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
