"""The port's result rendering and ``find_masks(..., save_viz=True)``
against the JAX package's (``ivf_tpu/viz/render.py``, ``ivf_tpu/api.py:
1172-1288``), on the CPU.

Render functions get the same seeded numpy inputs in both packages: the
returned arrays are bit-equal, the PNGs and GIFs byte-equal, and the JPEGs
(Pillow at quality 95 in the port, ``cv2.imwrite`` in JAX) decode within
``JPEG_TOL`` levels: the measured gap is 0 (the files are byte-equal here:
both encoders are libjpeg-turbo at the same quality and 4:2:0 chroma).
The jet table equals ``cv2.applyColorMap`` at all 256 levels. The port's
bilinear resize (``resize_to``) is held to ``cv2.resize`` within
``RESIZE_TOL`` (float32: 2e-3 measured on 0-255 images) and one level
(uint8: cv2 sums in 11-bit fixed point, the port in float32).

``find_masks`` on the SMALL I3D (2 clips of 8x32x32, 3 steps, Grad-CAM at
Mixed_4f) in both packages writes the same folders and files. Two fields of
a folder's name are scores printed to 4 decimals, which can flip between
the packages, so they are parsed and compared within the scores'
tolerance, as are the ClassScore values (``SCORE_TOL``, the tolerance of
``tests/test_torch_api.py``'s scores). The port's other cases use the tiny
ConvLSTM of ``tests/test_e2e.py`` (1 layer x 4 hidden, 2 classes) with its
seeded init: the txt-only run without Grad-CAM (``tests/test_e2e.py:842``),
the KTH run's PerturbImgs (``:423``), async against inline viz (``:891``)
and a run torn by a failing viz job, then resumed.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import cv2
import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu.viz.render as jrender
import ivf_tpu_torch.api as tapi
import ivf_tpu_torch.viz.render as trender
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu.interpret.perturb import find_submasks_from_mask as j_find_submasks
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.interpret.perturb import find_submasks_from_mask as t_find_submasks
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict

JPEG_TOL = 2  # decoded levels; measured 0
RESIZE_TOL = {np.float32: 2e-3, np.uint8: 1}
SCORE_TOL = 1e-5
SMALL = dict(num_classes=5, pool_shape=(1, 1, 1))
CLSTM = dict(conv_model="clstm", num_classes=2, clstm_hidden=4, clstm_layers=1, conv_stride=1,
             effective_steps=(3, 7))
DIR_RE = re.compile(r"(?P<id>.+)g_(?P<pred>\d+)_gs(?P<gs>\d+\.\d{4})_cs(?P<cs>\d+\.\d{4})$")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the tiny models' ops are too
    small to share, and where test workers share the cores, threads that
    wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _files(root) -> dict:
    """relative path -> bytes of every file under ``root``."""
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _render_inputs(seed=0, t=6, h=24, w=20):
    rng = np.random.RandomState(seed)
    clip = rng.randint(0, 256, (t, h, w, 3)).astype(np.float32)
    cam = rng.uniform(0, 1, (t, h, w)).astype(np.float32)
    mask = rng.uniform(0, 1, t).astype(np.float32)
    pert = rng.uniform(0, 255, (t, h, w, 3)).astype(np.float32)
    return clip, cam, mask, pert


def test_jet_table_equals_cv2_at_every_level():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(trender.JET_BGR[levels], cv2.applyColorMap(levels, cv2.COLORMAP_JET))
    x01 = np.random.RandomState(1).uniform(0, 1, (24, 20)).astype(np.float32)
    np.testing.assert_array_equal(trender._apply_jet(x01), jrender._apply_jet(x01))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape,size", [((24, 20, 3), (40, 36)), ((32, 32, 3), (16, 12)), ((9, 30), (30, 9))])
def test_resize_bilinear_matches_cv2(dtype, shape, size):
    img = np.random.RandomState(2).uniform(0, 255, shape).astype(dtype)
    got, want = trender.resize_bilinear(img, size), cv2.resize(img, size)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max() <= RESIZE_TOL[dtype]


@pytest.mark.parametrize("round_up", [True, False])
@pytest.mark.parametrize("n", [6, 16])
def test_find_temp_mask_dots_match_jax(round_up, n):
    mask = np.random.RandomState(n).uniform(0, 1, n).astype(np.float32)
    assert trender.find_temp_mask_dots(224, 200, mask, round_up) == jrender.find_temp_mask_dots(
        224, 200, mask, round_up)


@pytest.mark.parametrize("mark_imgs", [True, False])
def test_visualize_results_matches_jax(tmp_path, mark_imgs):
    clip, _, mask, pert = _render_inputs()
    trender.visualize_results(clip, pert, mask, str(tmp_path / "t"), case="c7", mark_imgs=mark_imgs)
    jrender.visualize_results(clip, pert, mask, str(tmp_path / "j"), case="c7", mark_imgs=mark_imgs)
    got, want = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(got) == sorted(want) == sorted(
        [f"PerturbImgs/casec7pert{i}.png" for i in range(6)] + ["PerturbImgs/casec7.txt"])
    assert got == want


def test_visualize_results_on_gradcam_matches_jax(tmp_path):
    rng = np.random.RandomState(3)
    panels = rng.randint(0, 256, (6, 24, 60, 3)).astype(np.uint8)
    mask = rng.uniform(0, 1, 6).astype(np.float32)
    got = trender.visualize_results_on_gradcam(panels, mask, str(tmp_path / "t"), "x", 20, 24)
    want = jrender.visualize_results_on_gradcam(panels, mask, str(tmp_path / "j"), "x", 20, 24)
    np.testing.assert_array_equal(got, want)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")


@pytest.mark.parametrize("resize_to", [None, (30, 26)], ids=["native", "resized"])
def test_create_image_arrays_matches_jax(tmp_path, resize_to):
    clip, cam, mask, pert = _render_inputs()
    got = trender.create_image_arrays(clip, cam, mask, pert, str(tmp_path / "t"), "freezeA", resize_to)
    want = jrender.create_image_arrays(clip, cam, mask, pert, str(tmp_path / "j"), "freezeA", resize_to)
    t_files, j_files = _files(tmp_path / "t"), _files(tmp_path / "j")
    assert sorted(t_files) == sorted(j_files)
    assert sum(n.endswith(".jpg") for n in t_files) == 6 and "mygif.gif" in t_files
    jpegs = [n for n in t_files if n.endswith(".jpg")]
    if resize_to is None:
        np.testing.assert_array_equal(got, want)
        assert {n: v for n, v in t_files.items() if n not in jpegs} == {
            n: v for n, v in j_files.items() if n not in jpegs}
        for name in jpegs:
            a, b = (np.asarray(Image.open(tmp_path / side / name), np.int16) for side in ("t", "j"))
            assert np.abs(a - b).max() <= JPEG_TOL, name
    else:
        # the resized heatmap may be a level off cv2's; the blend's max
        # normalization carries that into the CAM panel (so the JPEGs of
        # the two panels are not compared)
        assert got.shape == want.shape == (6, 26, 90, 3)
        assert np.abs(got.astype(np.int16) - want).max() <= 4
        for name in jpegs:
            assert Image.open(tmp_path / "t" / name).size == (90, 26)


@pytest.mark.parametrize("mask", [
    [0.0, 0.5, 0.6, 0.0, 0.9, 0.9],
    [0.2, 0.2, 0.05, 0.3],
    [0.05, 0.1, 0.11, 0.1],
    [0.0, 0.0],
    [1.0],
])
def test_find_submasks_from_mask_matches_jax(mask):
    mask = np.asarray(mask, np.float32)
    assert t_find_submasks(mask) == j_find_submasks(mask)
    assert t_find_submasks(mask, 0.5) == j_find_submasks(mask, 0.5)


@pytest.mark.parametrize("conv_model,model_name,subjects", [
    ("i3d_smth", "run", ()), ("i3d_kth", "run", ()), ("clstm", "KTH_run", ()), ("clstm", "run", (3, 5)),
    ("clstm_kth", "x", ()),
])
def test_is_kth_run_matches_jax(conv_model, model_name, subjects):
    cfgs = []
    for cfg in (TConfig(), JConfig()):
        cfg.model.conv_model, cfg.model_name = conv_model, model_name
        cfg.data.val_subjects = subjects
        cfgs.append(cfg)
    assert tapi._is_kth_run(cfgs[0]) == japi._is_kth_run(cfgs[1])


# find_masks on the SMALL I3D in both packages


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


def _i3d_cfg(cfg, out_dir):
    cfg.output_dir, cfg.model_name = str(out_dir), "viz"
    cfg.model.num_classes = 5
    cfg.data.batch_size, cfg.data.num_workers = 2, 1
    cfg.mask.opt_iter, cfg.mask.top_layer = 3, "Mixed_4f"
    return cfg


@pytest.fixture(scope="module")
def jax_i3d_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_viz")
    model = j_i3d_smth(**SMALL, dropout_rate=0.0, softmax=True)
    variables = _jax_variables(model)
    orig = japi.build_model
    japi.build_model = lambda cfg, softmax_override=None: model
    try:
        tm, _ = japi.find_masks(
            _i3d_cfg(JConfig(), out), variables,
            dataset=JSyntheticClips(2, t=8, hw=32, num_classes=5, lazy=False), save_viz=True,
        )
    finally:
        japi.build_model = orig
    return dict(out=out, tm=tm, sd=i3d_variables_to_state_dict(variables))


def _port_i3d(out_dir, sd, **kwargs):
    orig = tapi.build_model

    def small_model(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        model.pool_shape = (1, 1, 1)  # logits pool for 32x32 inputs
        return model

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "build_model", small_model)
        return tapi.find_masks(
            _i3d_cfg(TConfig(), out_dir), sd, SyntheticClips(2, t=8, hw=32, num_classes=5, lazy=False),
            device="cpu", **kwargs,
        )


@pytest.fixture(scope="module")
def port_i3d_run(jax_i3d_run, tmp_path_factory):
    out = tmp_path_factory.mktemp("port_viz")
    tm, gc = _port_i3d(out, jax_i3d_run["sd"])
    return dict(out=out, tm=tm, gc=gc)


def _viz_tree(out_dir) -> dict:
    """(label, clip id, pred, file name) -> (guess score, true score, path)
    of every file under ``cam_saved_images``, the folder names' scores
    parsed."""
    root = Path(out_dir) / "viz" / "cam_saved_images"
    tree = {}
    for path in sorted(root.rglob("*")):
        if path.is_file():
            rel = path.relative_to(root).parts
            label, clip_dir, combined, name = rel[0], rel[1], rel[2], "/".join(rel[3:])
            m = DIR_RE.fullmatch(clip_dir)
            assert m and combined == "combined", rel
            tree[(label, m["id"], m["pred"], name)] = (float(m["gs"]), float(m["cs"]), path)
    return tree


def test_find_masks_viz_tree_matches_jax(jax_i3d_run, port_i3d_run):
    got, want = _viz_tree(port_i3d_run["out"]), _viz_tree(jax_i3d_run["out"])
    assert sorted(got) == sorted(want)
    per_clip = {f"{p}{c}" for p in ("freeze", "reverse") for c in ("clip0", "clip1")}
    names = {k[3] for k in got}
    assert {"mygif.gif", *("img%02d.jpg" % i for i in range(1, 9))} <= names
    assert {f"MASKVALScase{pc}.txt" for pc in per_clip} <= names
    assert {f"case{pc}_{i}.png" for pc in per_clip for i in range(8)} <= names
    for key, (gs, cs, path) in got.items():
        # the folder name's scores, printed to 4 decimals, within a last digit
        assert abs(gs - want[key][0]) <= 1e-4 + SCORE_TOL and abs(cs - want[key][1]) <= 1e-4 + SCORE_TOL
        if key[3].startswith("ClassScore"):
            assert abs(float(path.read_text()) - float(want[key][2].read_text())) <= SCORE_TOL, key
    records = {r["video_id"]: r for r in port_i3d_run["tm"]}
    for (label, vid, pred, name), (_, _, path) in got.items():
        rec = records[vid]
        assert (int(label), int(pred)) == (rec["true_class"], rec["pred_class"])
        m = re.fullmatch(r"ClassScore(Freeze|Reverse)case(.+)\.txt", name)
        if m:
            assert m[2] == vid and float(path.read_text()) == rec[f"{m[1].lower()}_score"]
        if name == "mygif.gif":
            assert Image.open(path).n_frames == 8


def test_find_masks_save_viz_keeps_the_bits(jax_i3d_run, port_i3d_run, tmp_path):
    tm, gc = _port_i3d(tmp_path, jax_i3d_run["sd"], save_viz=False)
    assert not (tmp_path / "viz" / "cam_saved_images").exists()
    for got, want in zip(tm, port_i3d_run["tm"]):
        assert got.keys() == want.keys()
        for key, value in got.items():
            assert np.array_equal(value, want[key]), key
    for got, want in zip(gc, port_i3d_run["gc"]):
        assert np.array_equal(got["GCHeatMap"], want["GCHeatMap"])


# the port's other cases: the tiny ConvLSTM, its seeded init


def _clstm_run(out_dir, name, n_clips=4, **kwargs):
    cfg = TConfig()
    cfg.output_dir, cfg.model_name = str(out_dir), name
    for key, value in CLSTM.items():
        setattr(cfg.model, key, value)
    cfg.model.dropout = 0.0
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, 8, 32
    cfg.mask.opt_iter = 2
    for key in [k for k in kwargs if hasattr(cfg.mask, k)]:
        setattr(cfg.mask, key, kwargs.pop(key))
    return tapi.find_masks(
        cfg, None, SyntheticClips(n_clips, t=8, hw=32, num_classes=2, lazy=False), device="cpu", **kwargs)


def test_classscore_txt_without_gradcam(tmp_path):
    """The ClassScore files are written whenever the search ran, Grad-CAM
    or not; no image on a txt-only run (non-KTH); the folder name carries
    the clip's guess and true-class scores (``tests/test_e2e.py:842``)."""
    tm, gc = _clstm_run(tmp_path, "txt_only", do_gradcam=False)
    assert len(tm) == 4 and not gc
    root = tmp_path / "txt_only" / "cam_saved_images"
    files = [p for p in root.rglob("*") if p.is_file()]
    assert not [p for p in files if p.suffix in (".jpg", ".png", ".gif")]
    assert len(files) == 8
    for rec in tm:
        vid = rec["video_id"]
        folder = (root / str(rec["true_class"]) /
                  f"{vid}g_{rec['pred_class']}_gs{rec['original_score_guess']:5.4f}"
                  f"_cs{rec['original_score_true']:5.4f}" / "combined")
        assert float((folder / f"ClassScoreFreezecase{vid}.txt").read_text()) == rec["freeze_score"]
        assert float((folder / f"ClassScoreReversecase{vid}.txt").read_text()) == rec["reverse_score"]


def test_no_search_writes_no_artifacts(tmp_path):
    tm, gc = _clstm_run(tmp_path, "cam_only", run_temp_mask=False)
    assert not tm and len(gc) == 4
    assert not (tmp_path / "cam_only" / "cam_saved_images").exists()


def test_kth_run_renders_the_perturbed_sequence(tmp_path):
    """A KTH run (here by its run name, as ``_is_kth_run`` reads it) also
    writes ``PerturbImgs/case<id>pert<i>.png`` of the unsnapped
    ``mask_perturb_type`` perturbation (``tests/test_e2e.py:423``): the
    PNGs are ``visualize_results`` of the clip and that perturbation."""
    tm, _ = _clstm_run(tmp_path, "kth_viz")
    root = tmp_path / "kth_viz" / "cam_saved_images"
    clips = SyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False)
    for k, rec in enumerate(tm):
        vid = rec["video_id"]
        pert_dirs = list(root.glob(f"*/{vid}g_*/combined/PerturbImgs"))
        assert len(pert_dirs) == 1
        assert sorted(p.name for p in pert_dirs[0].iterdir()) == sorted(
            [f"case{vid}pert{i}.png" for i in range(8)] + [f"case{vid}.txt"])
        clip = torch.from_numpy(clips[k][0]).float()[None]
        pert = tapi.perturb_sequence(clip, torch.from_numpy(rec["time_mask"])[None], "freeze")[0].numpy()
        jrender.visualize_results(clip[0].numpy(), pert, rec["time_mask"], str(tmp_path / "want"), case=vid)
        want = _files(tmp_path / "want" / "PerturbImgs")
        assert {n: v for n, v in _files(pert_dirs[0]).items()} == {n: v for n, v in want.items() if vid in n}
    # a run that is not KTH renders no perturbed sequence
    _clstm_run(tmp_path, "smth_viz")
    assert not list((tmp_path / "smth_viz").rglob("PerturbImgs"))


def test_async_viz_matches_inline(tmp_path):
    """The writer thread (``mask.async_viz``) writes the inline run's tree
    byte for byte (``tests/test_e2e.py:891``), over two flushes."""
    trees = {}
    for flag in (True, False):
        _clstm_run(tmp_path, f"aviz_{int(flag)}", n_clips=6, async_viz=flag)
        trees[flag] = _files(tmp_path / f"aviz_{int(flag)}" / "cam_saved_images")
    assert len(trees[True]) == 6 * 29
    assert trees[True] == trees[False]


def test_torn_viz_run_resumes_with_every_artifact(tmp_path, monkeypatch):
    """A viz job that fails mid-flush tears the run: the journal holds
    only the flushes whose artifacts are all on disk (the append follows
    the files), so ``resume`` restores those and runs the rest; the
    resumed run has every clip's folder and the bits of an uninterrupted
    run."""
    ref_tm, ref_gc = _clstm_run(tmp_path, "ref", n_clips=8)
    render = tapi.create_image_arrays

    def fail_on_clip5(clip, cam, mask, pert, out_folder, case_tag="freeze", resize_to=None):
        if case_tag.endswith("clip5"):
            raise RuntimeError("disk full")
        return render(clip, cam, mask, pert, out_folder, case_tag, resize_to)

    monkeypatch.setattr(tapi, "create_image_arrays", fail_on_clip5)
    with pytest.raises(RuntimeError, match="disk full"):
        _clstm_run(tmp_path, "torn", n_clips=8)
    monkeypatch.setattr(tapi, "create_image_arrays", render)
    journal = tapi._EmissionJournal.load(str(tmp_path / "torn" / "results" / "emission_journal.p"))
    assert sorted(journal) == [f"clip{i}" for i in range(4)]
    root = tmp_path / "torn" / "cam_saved_images"
    for vid in journal:
        assert len(list(root.glob(f"*/{vid}g_*/combined/mygif.gif"))) == 1
    stats = {}
    tm, gc = _clstm_run(tmp_path, "torn", n_clips=8, resume=True, stats=stats)
    assert stats["resumed_clips"] == 4 and stats["searched_rows"] == 4
    assert _files(root).keys() == _files(tmp_path / "ref" / "cam_saved_images").keys()
    by_id = {r["video_id"]: r for r in ref_tm}
    for rec in tm:
        for key, value in rec.items():
            assert np.array_equal(value, by_id[rec["video_id"]][key]), key
    cams = {r["video_id"]: r["GCHeatMap"] for r in ref_gc}
    assert all(np.array_equal(r["GCHeatMap"], cams[r["video_id"]]) for r in gc)


def test_viz_folder_is_the_jax_render_of_the_clip(tmp_path):
    """A clip's ``combined`` folder holds, byte for byte, what the JAX
    package's two ``create_image_arrays`` calls (freeze, then reverse)
    write for the clip, its CAM, its mask and the snapped perturbations:
    the port leaves out only the freeze pass's ``img*.jpg`` and GIF, which
    the reverse pass overwrites."""
    tm, gc = _clstm_run(tmp_path, "tree", n_clips=4)
    root = tmp_path / "tree" / "cam_saved_images"
    clips = SyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False)
    cams = {r["video_id"]: r["GCHeatMap"] for r in gc}
    for k, rec in enumerate(tm):
        vid = rec["video_id"]
        clip = torch.from_numpy(clips[k][0]).float()[None]
        mask = torch.from_numpy(rec["time_mask"])[None]
        want_dir = tmp_path / "want" / vid
        for p in ("freeze", "reverse"):
            pert = tapi.perturb_sequence(clip, mask, p, snap_values=True)[0].numpy()
            jrender.create_image_arrays(clip[0].numpy(), cams[vid], rec["time_mask"], pert, str(want_dir),
                                        case_tag=p + vid)
        (folder,) = root.glob(f"*/{vid}g_*/combined")
        got = {n: v for n, v in _files(folder).items() if not n.startswith("ClassScore")}
        assert got == _files(want_dir)
