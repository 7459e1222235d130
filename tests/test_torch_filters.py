"""The port's filters, compaction across loader batches, the ``min_score``
probe and the run switches (``ivf_tpu_torch/api.py::find_masks``), on the
CPU: the counterparts of ``tests/test_e2e.py:135,647,664,719`` (the
``min_score`` skip, the KTH filter with no matches, compaction of
filtered batches, the remainder flush).

The runs use the tiny ConvLSTM of ``tests/test_torch_refill.py`` (1 layer
x 4 hidden, 2 classes, 8x32x32 clips, batches of 4) with the JAX model's
seeded init carried across by ``utils.convert``. Within the port, a
compacted or probed run gives each kept clip the bits of the unfiltered
run, on the monolithic, chunked and refill paths. Against
``ivf_tpu.api.find_masks`` (one JAX run per module: 12 clips, a subset
file keeping 9, the probe at 0.5, the refill path): the same kept and
skipped ids, the same counters and emission order, masks atol 1e-4,
scores 1e-5, CAMs 1e-4 (the tolerances of ``tests/test_torch_refill.py``).
"""

import json
import os
import pickle
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data import kth_clips_of_interest as jkth
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data import kth_clips_of_interest as tkth
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict

MODEL = dict(
    conv_model="clstm", num_classes=2, clstm_hidden=4, clstm_layers=1, conv_stride=1,
    effective_steps=(3, 7),
)
PATHS = {  # the three search paths of find_masks
    "monolithic": dict(opt_iter=4),
    "chunked": dict(opt_iter=4, chunk_steps=2),
    "refill": dict(opt_iter=8, chunk_steps=2, early_stop=True, eta=3e-3),
}
SCORES = ("original_score_guess", "original_score_true", "freeze_score", "reverse_score")
COUNTERS = ("score_launches", "search_launches", "searched_rows", "padded_rows", "segments_launched",
            "refill_flushes", "refill_requeued_rows", "resumed_clips", "resumed_skipped")
SUBSET = [f"clip{i}" for i in range(12) if i not in (1, 6, 10)]  # 9 of 12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module: the tiny model's ops are too
    small to share, and where test workers share the cores, threads that
    wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configure(cfg, out_dir, name, **mask):
    cfg.output_dir, cfg.model_name = str(out_dir), name
    for key, value in MODEL.items():
        setattr(cfg.model, key, value)
    cfg.model.dropout = 0.0
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, 8, 32
    for key, value in mask.items():
        setattr(cfg.mask, key, value)
    return cfg


@pytest.fixture(scope="module")
def jax_variables(tmp_path_factory):
    cfg = _configure(JConfig(), tmp_path_factory.mktemp("init"), "init")
    model = japi.build_model(cfg, softmax_override=True)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3)))


@pytest.fixture(scope="module")
def state_dict(jax_variables):
    return convlstm_variables_to_state_dict(jax_variables)


@pytest.fixture(scope="module")
def subset_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("subset") / "subset.csv"
    path.write_text("".join(f"{cid},kept\n" for cid in SUBSET) + "\n")
    return str(path)


def _port_run(out_dir, sd, name="fm", n_clips=8, dataset=None, kwargs=None, **mask):
    cfg = _configure(TConfig(), out_dir, name, **mask)
    stats = {}
    dataset = dataset or SyntheticClips(n_clips, t=8, hw=32, num_classes=2, lazy=False)
    kwargs = {"save_viz": False, **(kwargs or {})}
    tm, gc = tapi.find_masks(cfg, sd, dataset, stats=stats, device="cpu", **kwargs)
    return tm, gc, stats


def _journal(out_dir, name="fm"):
    return tapi._EmissionJournal.load(os.path.join(str(out_dir), name, "results", "emission_journal.p"))


def _pickles(out_dir, name="fm"):
    res = os.path.join(str(out_dir), name, "results")
    return {n: pickle.load(open(os.path.join(res, n), "rb")) for n in sorted(os.listdir(res)) if n.endswith(".p")
            and n.startswith("all")}


@pytest.fixture(scope="module")
def jax_filtered_run(jax_variables, subset_file, tmp_path_factory):
    """The JAX package's find_masks over 12 clips with the subset file and
    the probe, on the refill path."""
    out = tmp_path_factory.mktemp("jax_filtered")
    cfg = _configure(JConfig(), out, "fm", subset_file=subset_file, min_score=0.5, **PATHS["refill"])
    cfg.data.num_workers = 1
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the loose-eta warning
        tm, gc = japi.find_masks(
            cfg, jax_variables, dataset=JSyntheticClips(12, t=8, hw=32, num_classes=2, lazy=False),
            save_viz=False, stats=stats,
        )
    journal = japi._EmissionJournal.load(os.path.join(str(out), "fm", "results", "emission_journal.p"))
    return dict(tm=tm, gc=gc, stats=stats, journal=journal)


@pytest.fixture(scope="module")
def unfiltered_runs(state_dict, tmp_path_factory):
    """The port over 12 clips with no filter, on each search path."""
    out = tmp_path_factory.mktemp("unfiltered")
    return {path: _port_run(out, state_dict, path, n_clips=12, **mask) for path, mask in PATHS.items()}


def _by_id(records):
    return {r["video_id"]: r for r in records}


def _assert_bits_of(run, ref):
    """Each clip of ``run`` has the bits of the same clip in ``ref``."""
    for got, want in ((run[0], ref[0]), (run[1], ref[1])):
        want = _by_id(want)
        for rec in got:
            for key, value in rec.items():
                other = want[rec["video_id"]][key]
                assert np.array_equal(value, other) if isinstance(value, np.ndarray) else value == other, (
                    rec["video_id"], key)


def test_filters_match_jax(jax_filtered_run, state_dict, subset_file, tmp_path):
    """The port against ``ivf_tpu.api.find_masks`` with a subset file and
    the ``min_score`` probe on the refill path: the same kept and skipped
    ids, counters, stop steps and emission order; masks 1e-4, scores 1e-5,
    CAMs 1e-4."""
    tm, gc, st = _port_run(tmp_path, state_dict, n_clips=12, subset_file=subset_file, min_score=0.5,
                           **PATHS["refill"])
    want = jax_filtered_run
    assert {k: st[k] for k in COUNTERS} == {k: want["stats"][k] for k in COUNTERS}
    assert st["n_steps_run"] == want["stats"]["n_steps_run"]
    assert st["score_launches"] == 3 and st["refill_requeued_rows"] > 0, st  # ceil(9 / 4) probes
    journal = _journal(tmp_path)
    skips = sorted(v for v, r in journal.items() if r.get("skip"))
    assert skips == sorted(v for v, r in want["journal"].items() if r.get("skip"))
    assert 0 < len(skips) < 9 and sorted(journal) == sorted(SUBSET)
    assert [r["video_id"] for r in tm] == [r["video_id"] for r in want["tm"]]
    assert [r["video_id"] for r in gc] == [r["video_id"] for r in want["gc"]]
    for got, ref in zip(tm, want["tm"]):
        assert set(got) == set(ref)
        for key in ("true_class", "pred_class", "video_id"):
            assert got[key] == ref[key]
        for key in SCORES:
            np.testing.assert_allclose(got[key], ref[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], ref["time_mask"], atol=1e-4)
    for got, ref in zip(gc, want["gc"]):
        np.testing.assert_allclose(got["GCHeatMap"], ref["GCHeatMap"], atol=1e-4)
    assert want["stats"]["early_stop_summary"] == st["early_stop_summary"]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_compacts_filtered_batches(unfiltered_runs, state_dict, tmp_path, path):
    """``class_oi`` keeps the even clips, 2 of each loader batch: they
    compact across loader batches into full flushes, 6 kept clips in a
    full flush and a padded final one, and each kept clip has the bits of
    the unfiltered run."""
    run = _port_run(tmp_path, state_dict, n_clips=12, class_oi=0, **PATHS[path])
    tm, _, st = run
    assert [r["video_id"] for r in sorted(tm, key=lambda r: int(r["video_id"][4:]))] == [
        f"clip{i}" for i in (0, 2, 4, 6, 8, 10)]
    assert all(r["true_class"] == 0 for r in tm)
    assert (st["search_launches"], st["searched_rows"], st["score_launches"]) == (2, 6, 2)
    assert st["padded_rows"] == 2 + 4 * st["refill_flushes"] - st["refill_requeued_rows"]
    _assert_bits_of(run, unfiltered_runs[path])


def test_compaction_fills_every_flush(state_dict, tmp_path):
    """The reference workload keeps ~1/174 of the clips: 8 clips of
    alternating labels, class 0 kept, give exactly one full flush and no
    padding (``tests/test_e2e.py:664``)."""
    tm, _, st = _port_run(tmp_path, state_dict, class_oi=0, opt_iter=2, kwargs=dict(do_gradcam=False))
    assert {r["video_id"] for r in tm} == {f"clip{i}" for i in (0, 2, 4, 6)}
    assert (st["search_launches"], st["searched_rows"], st["padded_rows"]) == (1, 4, 0)


def test_final_flush_handles_remainder(state_dict, tmp_path):
    """A tail short of a batch still runs, in one padded final flush
    (``tests/test_e2e.py:719``)."""
    tm, _, st = _port_run(tmp_path, state_dict, n_clips=6, opt_iter=2, kwargs=dict(do_gradcam=False))
    assert len(tm) == 6
    assert (st["search_launches"], st["searched_rows"], st["padded_rows"]) == (2, 6, 2)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_probe_keeps_the_bits_of_the_staging_forward(unfiltered_runs, state_dict, tmp_path, path):
    """A probe that keeps every clip (``min_score`` 1e-30): its class
    scores replace the staging forward's, so the flushes launch no
    forward of their own, and every clip has the unprobed run's bits."""
    run = _port_run(tmp_path, state_dict, n_clips=12, min_score=1e-30, **PATHS[path])
    st, ref = run[2], unfiltered_runs[path][2]
    assert len(run[0]) == 12 and not any(r.get("skip") for r in _journal(tmp_path).values())
    assert st["score_launches"] == 3 and ref["score_launches"] == 3  # probes / staging forwards
    assert (st["search_launches"], st["padded_rows"]) == (ref["search_launches"], ref["padded_rows"])
    _assert_bits_of(run, unfiltered_runs[path])


def test_min_score_skip_keeps_nothing(state_dict, tmp_path):
    """An impossible threshold (``tests/test_e2e.py:135``): every clip is
    probed and journaled as a skip, nothing is searched, the results are
    empty and the pickles are still written."""
    tm, gc, st = _port_run(tmp_path, state_dict, min_score=1.1, opt_iter=2)
    assert tm == [] and gc == []
    assert (st["score_launches"], st["search_launches"], st["searched_rows"]) == (2, 0, 0)
    journal = _journal(tmp_path)
    assert sorted(journal) == [f"clip{i}" for i in range(8)] and all(r["skip"] for r in journal.values())
    assert list(_pickles(tmp_path).values()) == [[], []]


def test_kth_filter_no_matches(state_dict, tmp_path):
    """``kth_clips_filter`` where no id is on the whitelist
    (``tests/test_e2e.py:647``): empty results, no launch, the pickles
    still written."""
    tm, gc, st = _port_run(tmp_path, state_dict, kth_clips_filter=True, opt_iter=2, kwargs=dict(max_batches=1))
    assert tm == [] and gc == []
    assert (st["score_launches"], st["search_launches"]) == (0, 0)
    assert list(_pickles(tmp_path).values()) == [[], []]


class _KTHClips:
    """SyntheticClips under KTH tags, two of them on the 'original'
    whitelist, one on the other split's."""

    TAGS = ["person17_boxing_d1_1", "person01_boxing_d1_1", "person25_walking_d4_1", "person07_boxing_d2_1",
            "person18_handwaving_d3_1", "person17_boxing_d1_2"]

    def __init__(self):
        self.clips = SyntheticClips(len(self.TAGS), t=8, hw=32, num_classes=2, lazy=False)

    def __len__(self):
        return len(self.TAGS)

    def __getitem__(self, i):
        clip, label, _ = self.clips[i]
        return clip, label, self.TAGS[i]


@pytest.mark.parametrize("split_type", ["original", "alternate"])
def test_kth_filter_keeps_the_whitelist(state_dict, tmp_path, split_type):
    """The KTH whitelist of ``cfg.split_type`` decides which tags run."""
    cfg = _configure(TConfig(), tmp_path, "fm", kth_clips_filter=True, opt_iter=2)
    cfg.split_type = split_type
    tm, _ = tapi.find_masks(cfg, state_dict, _KTHClips(), device="cpu", do_gradcam=False, save_viz=False)
    want = [t for t in _KTHClips.TAGS if jkth.tag_matches(t, split_type)]
    assert [r["video_id"] for r in tm] == want and want
    assert want == (["person17_boxing_d1_1", "person25_walking_d4_1", "person18_handwaving_d3_1"]
                    if split_type == "original" else ["person07_boxing_d2_1"])


def test_kth_whitelist_is_the_jax_packages():
    """The port's copy of the whitelist: the same lists, the same matches."""
    tags = [f"person{p:02d}_{a}_d{d}_{r}" for p in range(1, 26) for a in jkth._ACTIONS for d in range(1, 5)
            for r in (1, 2)]
    for split_type in ("original", "alternate"):
        assert tkth.clips_of_interest(split_type) == jkth.clips_of_interest(split_type)
        assert [tkth.tag_matches(t, split_type) for t in tags] == [jkth.tag_matches(t, split_type) for t in tags]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_subset_file_keeps_its_ids(unfiltered_runs, state_dict, subset_file, tmp_path, path):
    """The subset file's first column lists the ids to run: those run, in
    compacted flushes, with the unfiltered run's bits."""
    run = _port_run(tmp_path, state_dict, n_clips=12, subset_file=subset_file, **PATHS[path])
    assert sorted(r["video_id"] for r in run[0]) == sorted(SUBSET)
    assert (run[2]["search_launches"], run[2]["searched_rows"]) == (3, 9)
    _assert_bits_of(run, unfiltered_runs[path])


class _NoIds:
    def __init__(self, n):
        self.clips = SyntheticClips(n, t=8, hw=32, num_classes=2, lazy=False)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i][:2]


def test_items_without_ids_get_batch_row_ids(state_dict, tmp_path):
    """Items of (clip, label) take the id ``b{loader batch}_{row}``."""
    tm, gc, _ = _port_run(tmp_path, state_dict, dataset=_NoIds(6), opt_iter=2)
    ids = ["b0_0", "b0_1", "b0_2", "b0_3", "b1_0", "b1_1"]
    assert [r["video_id"] for r in tm] == [r["video_id"] for r in gc] == ids
    assert sorted(_journal(tmp_path)) == sorted(ids)


def test_kept_rows_are_copies(state_dict, tmp_path, monkeypatch):
    """Each kept row is copied out of the item it came from, so it pins no
    storage of the dataset behind it. The rows held are those find_masks
    stacks to upload; the loader's own stack (``ClipLoader._assemble``)
    builds a new batch array of the items by design."""
    dataset = SyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False)
    staged = []
    upload = tapi.np.stack

    def stack(rows, *args, **kwargs):
        rows = list(rows)
        if sys._getframe(1).f_globals.get("__name__") == tapi.__name__:
            staged.extend(r for r in rows if isinstance(r, np.ndarray) and r.dtype == np.uint8)
        return upload(rows, *args, **kwargs)

    monkeypatch.setattr(tapi.np, "stack", stack)
    _port_run(tmp_path, state_dict, dataset=dataset, opt_iter=1, kwargs=dict(do_gradcam=False))
    assert staged and not any(np.shares_memory(r, dataset.clips) for r in staged)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_switches(unfiltered_runs, state_dict, tmp_path, path):
    """``run_temp_mask=False`` runs Grad-CAM alone (the CAMs of the full
    run, no search, masks None in the journal); ``do_gradcam=False`` emits
    no CAM (the masks of the full run, CAMs None in the journal)."""
    ref = unfiltered_runs[path]
    tm, gc, st = _port_run(tmp_path, state_dict, "cams", n_clips=12, kwargs=dict(run_temp_mask=False),
                           **PATHS[path])
    assert tm == [] and len(gc) == 12
    assert (st["search_launches"], st["searched_rows"], st["padded_rows"], st["segments_launched"]) == (0, 0, 0, 0)
    assert st["score_launches"] == 3 and st["n_steps_run"] == [] and "early_stop_summary" not in st
    assert all(r["mask"] is None and r["cam"] is not None for r in _journal(tmp_path, "cams").values())
    _assert_bits_of(([], gc), ([], ref[1]))
    tm, gc, st = _port_run(tmp_path, state_dict, "masks", n_clips=12, kwargs=dict(do_gradcam=False),
                           **PATHS[path])
    assert gc == [] and len(tm) == 12
    assert {k: st[k] for k in COUNTERS} == {k: ref[2][k] for k in COUNTERS}
    assert all(r["cam"] is None and r["mask"] is not None for r in _journal(tmp_path, "masks").values())
    _assert_bits_of((tm, []), (ref[0], []))
    with open(os.path.join(str(tmp_path), "masks", "results", "search_stats.json")) as f:
        saved = json.load(f)
    assert "n_steps_run" not in saved and saved["search_launches"] == st["search_launches"]
    tm, gc, st = _port_run(tmp_path, state_dict, "none", n_clips=4,
                           kwargs=dict(run_temp_mask=False, do_gradcam=False), **PATHS[path])
    assert tm == gc == [] and st["score_launches"] == 1 and not _journal(tmp_path, "none")
    assert not os.path.exists(os.path.join(str(tmp_path), "none", "results", "search_stats.json"))


def test_early_stop_summary(unfiltered_runs, state_dict, tmp_path, capsys):
    """Under early stop the summary of the stop steps goes into the stats
    (segment fields too, the search being chunked) and is printed."""
    st = unfiltered_runs["refill"][2]
    summary = st["early_stop_summary"]
    steps = np.asarray(st["n_steps_run"])
    assert summary["clips"] == 12 and summary["steps_run_max"] == steps.max()
    assert summary["segments_launched"] == st["segments_launched"]
    assert summary["segments_fixed_schedule"] == st["search_launches"] * 4
    assert "early_stop_summary" not in unfiltered_runs["chunked"][2]
    _port_run(tmp_path, state_dict, n_clips=4, kwargs=dict(do_gradcam=False), **PATHS["refill"])
    out = capsys.readouterr().out
    assert "[find-masks] early-stop over 4 clips" in out and "fixed-schedule" in out


def test_unknown_mask_init_raises(state_dict, tmp_path):
    with pytest.raises(ValueError, match="mask_init_type"):
        _port_run(tmp_path, state_dict, n_clips=1, mask_init_type="gaussian")
