"""The port's emission journal, ``resume``, random mask init and the
journal's writer thread (``ivf_tpu_torch/api.py::find_masks``,
``interpret/mask_opt.py::init_mask_random``), on the CPU: the counterparts
of ``tests/test_resume_masks.py`` and ``tests/test_e2e.py:918``.

The runs use the tiny ConvLSTM of ``tests/test_torch_refill.py`` (1 layer
x 4 hidden, 2 classes, 8x32x32 clips, batches of 4) with the JAX model's
seeded init carried across by ``utils.convert``. Within the port the paths
are held to equal bits per clip: an interrupted and resumed run against an
uninterrupted one (monolithic, chunked and refill), a resume from a torn
journal, random init under resume, and the writer thread against inline
writes. Against ``ivf_tpu.api.find_masks`` (one JAX run per module: an
interrupted and resumed run with ``min_score`` and random init, the port
fed the inits JAX drew): the same kept and skipped ids, the same counters,
masks atol 1e-4, scores 1e-5, CAMs 1e-4 (the tolerances of
``tests/test_torch_refill.py``); each package reads the other's journal.
"""

import os
import pickle
import warnings
import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu.interpret.mask_opt import init_mask_random as jax_init_mask_random
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.interpret.mask_opt import draw_mask_random, init_mask_random
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict

MODEL = dict(
    conv_model="clstm", num_classes=2, clstm_hidden=4, clstm_layers=1, conv_stride=1,
    effective_steps=(3, 7),
)
SEARCH = dict(opt_iter=4, chunk_steps=2)
PATHS = {  # the three search paths of find_masks
    "monolithic": dict(opt_iter=4),
    "chunked": dict(opt_iter=4, chunk_steps=2),
    "refill": dict(opt_iter=8, chunk_steps=2, early_stop=True, eta=3e-3),
}
SCORES = ("original_score_guess", "original_score_true", "freeze_score", "reverse_score")
COUNTERS = ("score_launches", "search_launches", "searched_rows", "padded_rows", "resumed_clips",
            "resumed_skipped")
# the JAX reference: interrupted after one loader batch, then resumed, with
# the min_score probe (2 classes: the probabilities straddle 0.5) and
# random init
JAX_RUN = dict(SEARCH, min_score=0.5, mask_init_type="random")


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


def _journal_path(out_dir, name):
    return os.path.join(str(out_dir), name, "results", "emission_journal.p")


def _journal_records(path):
    recs = []
    with open(path, "rb") as f:
        while True:
            try:
                recs.append(pickle.load(f))
            except EOFError:
                return recs


@pytest.fixture(scope="module")
def jax_variables(tmp_path_factory):
    cfg = _configure(JConfig(), tmp_path_factory.mktemp("init"), "init")
    model = japi.build_model(cfg, softmax_override=True)
    return jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3)))


@pytest.fixture(scope="module")
def state_dict(jax_variables):
    return convlstm_variables_to_state_dict(jax_variables)


def _port_run(out_dir, sd, name="fm", n_clips=8, kwargs=None, **mask):
    cfg = _configure(TConfig(), out_dir, name, **mask)
    stats = {}
    tm, gc = tapi.find_masks(
        cfg, sd, SyntheticClips(n_clips, t=8, hw=32, num_classes=2, lazy=False), stats=stats,
        device="cpu", **{"save_viz": False, **(kwargs or {})},
    )
    return tm, gc, stats


def _jax_inits(seed, ids, t=8):
    """The random inits the JAX package draws for ``ids``
    (``ivf_tpu/api.py:1076-1092``): the seed's key folded with each id's
    CRC-32, then ``init_mask_random``."""
    base = jax.random.PRNGKey(seed)
    return {
        cid: np.asarray(jax_init_mask_random(jax.random.fold_in(base, jnp.uint32(zlib.crc32(cid.encode()))), t))
        for cid in ids
    }


@pytest.fixture(scope="module")
def jax_resume_run(jax_variables, tmp_path_factory):
    """The JAX package's find_masks interrupted after one loader batch,
    then resumed: stats of both runs, the resumed run's records, its
    journal."""
    out = tmp_path_factory.mktemp("jax_resume")
    cfg = _configure(JConfig(), out, "fm", **JAX_RUN)
    cfg.data.num_workers = 1
    ds = JSyntheticClips(8, t=8, hw=32, num_classes=2, lazy=False)
    partial, resumed = {}, {}
    japi.find_masks(cfg, jax_variables, dataset=ds, save_viz=False, max_batches=1, stats=partial)
    tm, gc = japi.find_masks(cfg, jax_variables, dataset=ds, save_viz=False, resume=True, stats=resumed)
    return dict(tm=tm, gc=gc, partial=partial, resumed=resumed, journal=_journal_path(out, "fm"))


def _by_id(records):
    return {r["video_id"]: r for r in records}


def _assert_same_bits(a, b):
    """Per-clip records (and CAMs) of two port runs, keyed by clip id."""
    (tm0, gc0), (tm1, gc1) = a, b
    for x, y in ((tm0, tm1), (gc0, gc1)):
        x, y = _by_id(x), _by_id(y)
        assert set(x) == set(y), (sorted(x), sorted(y))
        for vid in x:
            assert set(x[vid]) == set(y[vid])
            for key, value in x[vid].items():
                if isinstance(value, np.ndarray):
                    assert np.array_equal(value, y[vid][key]), (vid, key)
                else:
                    assert value == y[vid][key], (vid, key)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_resume_completes_partial_run(state_dict, tmp_path, path):
    """Interrupted after the first loader batch (``max_batches=1``), then
    resumed: only the unfinished clips are searched, and every clip has
    the bits of an uninterrupted run, on each search path; one more resume
    restores everything and launches nothing."""
    mask = PATHS[path]
    base = _port_run(tmp_path, state_dict, "base", **mask)
    part = _port_run(tmp_path, state_dict, "part", kwargs=dict(max_batches=1), **mask)
    assert len(part[0]) == 4 and os.path.exists(_journal_path(tmp_path, "part"))
    tm, gc, st = _port_run(tmp_path, state_dict, "part", kwargs=dict(resume=True), **mask)
    assert (st["resumed_clips"], st["resumed_skipped"], st["searched_rows"]) == (4, 0, 4), st
    assert [r["video_id"] for r in tm[:4]] == [r["video_id"] for r in part[0]]  # restored first
    _assert_same_bits(base[:2], (tm, gc))
    tm2, gc2, st2 = _port_run(tmp_path, state_dict, "part", kwargs=dict(resume=True), **mask)
    assert (st2["searched_rows"], st2["score_launches"], st2["search_launches"]) == (0, 0, 0), st2
    assert st2["resumed_clips"] == 8
    _assert_same_bits(base[:2], (tm2, gc2))


def test_resume_truncated_journal_tail(state_dict, tmp_path):
    """A crash mid-append leaves a torn last record: the intact prefix
    restores, the rest runs again, and every clip has the bits of the
    uninterrupted run."""
    tm0, gc0, _ = _port_run(tmp_path, state_dict, **SEARCH)
    jp = _journal_path(tmp_path, "fm")
    with open(jp, "rb") as f:
        whole = f.read()
    with open(jp, "wb") as f:
        f.write(whole[: len(whole) - 7])
        f.write(b"\x80\x04garbage")
    restored = tapi._EmissionJournal.load(jp)
    assert 0 < len(restored) < 8
    tm1, gc1, st = _port_run(tmp_path, state_dict, kwargs=dict(resume=True), **SEARCH)
    assert st["resumed_clips"] == len(restored)
    assert st["searched_rows"] == 8 - st["resumed_clips"]
    _assert_same_bits((tm0, gc0), (tm1, gc1))


def test_resume_skips_min_score_probes(state_dict, tmp_path):
    """Clips the probe rejected are journaled as skips: a resumed run
    probes nothing and searches nothing again."""
    tm0, gc0, st0 = _port_run(tmp_path, state_dict, min_score=0.5, **SEARCH)
    assert 0 < len(tm0) < 8, len(tm0)
    assert st0["score_launches"] == 2  # the probe's two full batches, no staging forward
    skips = [r for r in _journal_records(_journal_path(tmp_path, "fm")) if r.get("skip")]
    assert len(skips) == 8 - len(tm0) and set(skips[0]) == {"video_id", "skip"}
    tm1, gc1, st = _port_run(tmp_path, state_dict, min_score=0.5, kwargs=dict(resume=True), **SEARCH)
    assert st["score_launches"] == 0 and st["searched_rows"] == 0
    assert (st["resumed_skipped"], st["resumed_clips"]) == (8 - len(tm0), len(tm0)), st
    _assert_same_bits((tm0, gc0), (tm1, gc1))


def test_fresh_run_clears_stale_journal(state_dict, tmp_path):
    """Without ``resume`` a rerun starts clean: the old journal is removed
    first, so two runs' records never mix."""
    _port_run(tmp_path, state_dict, n_clips=4, kwargs=dict(do_gradcam=False), **SEARCH)
    tm, _, _ = _port_run(tmp_path, state_dict, n_clips=4, kwargs=dict(do_gradcam=False), **SEARCH)
    assert len(tm) == 4
    recs = _journal_records(_journal_path(tmp_path, "fm"))
    assert len(recs) == 4, len(recs)
    assert all(r["cam"] is None and r["mask"]["video_id"] == r["video_id"] for r in recs)


def test_resume_random_init_composition_independent(state_dict, tmp_path):
    """Random inits are drawn per clip id, not per flush position, so an
    interrupted and resumed random-init run has the uninterrupted run's
    bits."""
    base = _port_run(tmp_path, state_dict, "base", mask_init_type="random", **SEARCH)
    _port_run(tmp_path, state_dict, "part", mask_init_type="random", kwargs=dict(max_batches=1), **SEARCH)
    tm, gc, st = _port_run(tmp_path, state_dict, "part", mask_init_type="random",
                           kwargs=dict(resume=True), **SEARCH)
    assert st["resumed_clips"] == 4
    _assert_same_bits(base[:2], (tm, gc))
    central = _port_run(tmp_path, state_dict, "central", **SEARCH)
    assert not all(np.array_equal(a["time_mask"], b["time_mask"]) for a, b in zip(base[0], central[0]))


def test_resume_config_widening_reruns_incomplete(state_dict, tmp_path):
    """A journal written without Grad-CAM does not serve a resumed run that
    needs it: those clips run again in full."""
    _port_run(tmp_path, state_dict, n_clips=4, kwargs=dict(do_gradcam=False), **SEARCH)
    tm, gc, st = _port_run(tmp_path, state_dict, n_clips=4, kwargs=dict(resume=True), **SEARCH)
    assert st["resumed_clips"] == 0 and st["searched_rows"] == 4
    assert len(tm) == 4 and len(gc) == 4


def test_resume_matches_jax(jax_resume_run, state_dict, tmp_path, monkeypatch):
    """The port against ``ivf_tpu.api.find_masks``, each interrupted after
    one loader batch and resumed, with the ``min_score`` probe and random
    init (the port fed the inits JAX drew): the same counters in both
    runs, the same kept and skipped ids, and the records within masks
    1e-4, scores 1e-5, CAMs 1e-4."""
    jax_inits = _jax_inits(0, [f"clip{i}" for i in range(8)])
    monkeypatch.setattr(tapi, "draw_mask_random", lambda seed, cid, t: torch.from_numpy(jax_inits[cid]))
    _, _, partial = _port_run(tmp_path, state_dict, kwargs=dict(max_batches=1), **JAX_RUN)
    tm, gc, resumed = _port_run(tmp_path, state_dict, kwargs=dict(resume=True), **JAX_RUN)
    want = jax_resume_run
    assert {k: partial[k] for k in COUNTERS} == {k: want["partial"][k] for k in COUNTERS}
    assert {k: resumed[k] for k in COUNTERS} == {k: want["resumed"][k] for k in COUNTERS}
    assert resumed["resumed_clips"] > 0 and resumed["resumed_skipped"] > 0, resumed
    assert [r["video_id"] for r in tm] == [r["video_id"] for r in want["tm"]]
    skipped = lambda path: sorted(r["video_id"] for r in _journal_records(path) if r.get("skip"))  # noqa: E731
    assert skipped(_journal_path(tmp_path, "fm")) == skipped(want["journal"])
    for got, ref in zip(tm, want["tm"]):
        assert set(got) == set(ref)
        for key in ("true_class", "pred_class", "video_id"):
            assert got[key] == ref[key]
        for key in SCORES:
            np.testing.assert_allclose(got[key], ref[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], ref["time_mask"], atol=1e-4)
    for got, ref in zip(gc, want["gc"]):
        assert got["video_id"] == ref["video_id"]
        np.testing.assert_allclose(got["GCHeatMap"], ref["GCHeatMap"], atol=1e-4)


def test_journals_read_across_packages(jax_resume_run, jax_variables, state_dict, tmp_path, monkeypatch):
    """Each package's ``_EmissionJournal.load`` reads the journal the other
    wrote: the same ids, skips and record keys, and numpy arrays inside."""
    jax_inits = _jax_inits(0, [f"clip{i}" for i in range(8)])
    monkeypatch.setattr(tapi, "draw_mask_random", lambda seed, cid, t: torch.from_numpy(jax_inits[cid]))
    _port_run(tmp_path, state_dict, **JAX_RUN)
    port_path, jax_path = _journal_path(tmp_path, "fm"), jax_resume_run["journal"]
    for load in (japi._EmissionJournal.load, tapi._EmissionJournal.load):
        port, ref = load(port_path), load(jax_path)
        assert sorted(port) == sorted(ref) == [f"clip{i}" for i in range(8)]
        for vid, rec in port.items():
            assert set(rec) == set(ref[vid])
            if rec.get("skip"):
                continue
            assert set(rec["mask"]) == set(ref[vid]["mask"]) and set(rec["cam"]) == set(ref[vid]["cam"])
            for got, want in ((rec["mask"]["time_mask"], ref[vid]["mask"]["time_mask"]),
                              (rec["cam"]["GCHeatMap"], ref[vid]["cam"]["GCHeatMap"])):
                assert type(got) is np.ndarray and got.dtype == want.dtype == np.float32
                np.testing.assert_allclose(got, want, atol=1e-4)
    # the JAX package's resume restores from the port's journal
    cfg = _configure(JConfig(), tmp_path, "fm", **JAX_RUN)
    cfg.data.num_workers = 1
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        tm, _ = japi.find_masks(cfg, jax_variables, dataset=JSyntheticClips(8, t=8, hw=32, num_classes=2, lazy=False),
                                save_viz=False, resume=True, stats=stats)
    assert stats["searched_rows"] == 0 and stats["score_launches"] == 0
    assert stats["resumed_clips"] + stats["resumed_skipped"] == 8 and len(tm) == stats["resumed_clips"]


def test_async_and_inline_journaling_give_equal_bits(state_dict, tmp_path):
    """``mask.async_viz`` on (the writer thread) and off (inline): equal
    records, CAMs and journal records."""
    runs, journals = [], []
    for flag in (True, False):
        name = f"async_{flag}"
        runs.append(_port_run(tmp_path, state_dict, name, n_clips=6, async_viz=flag, min_score=0.5, **SEARCH))
        journals.append(tapi._EmissionJournal.load(_journal_path(tmp_path, name)))
    _assert_same_bits(runs[0][:2], runs[1][:2])
    assert list(journals[0]) == list(journals[1]) and len(journals[0]) == 6
    for vid, rec in journals[0].items():
        other = journals[1][vid]
        if rec.get("skip"):
            assert other == rec
            continue
        for part, key in (("mask", "time_mask"), ("cam", "GCHeatMap")):
            assert np.array_equal(rec[part][key], other[part][key]), (vid, part)


def test_async_writer_propagates_worker_errors():
    """A failing job surfaces at ``close``; ``close(raise_errors=False)``
    (the body already failed) swallows it but still waits; inline, the
    job raises at once."""
    def boom():
        raise RuntimeError("journal write failed")

    w = tapi._AsyncWriter(enabled=True, max_pending=1)
    w.submit(boom)
    with pytest.raises(RuntimeError, match="journal write failed"):
        w.close()
    w2 = tapi._AsyncWriter(enabled=True, max_pending=1)
    w2.submit(boom)
    w2.close(raise_errors=False)
    w3 = tapi._AsyncWriter(enabled=True, max_pending=1)
    w3.submit(boom)
    with pytest.raises(RuntimeError, match="journal write failed"):
        w3.submit(lambda: None)  # the next submit waits for the failed job
    w3.close(raise_errors=False)
    with pytest.raises(RuntimeError, match="journal write failed"):
        tapi._AsyncWriter(enabled=False).submit(boom)


def test_find_masks_error_closes_the_writer_and_keeps_the_error(state_dict, tmp_path, monkeypatch):
    """An error in the body reaches the caller as it was, after the writer
    drained: the journal holds the flushes before it."""
    calls = []

    def failing_cam(*args, **kwargs):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("second flush fails")
        return cam(*args, **kwargs)

    cam = tapi.convlstm_grad_cam
    monkeypatch.setattr(tapi, "convlstm_grad_cam", failing_cam)
    with pytest.raises(ValueError, match="second flush fails"):
        _port_run(tmp_path, state_dict, **SEARCH)
    assert len(_journal_records(_journal_path(tmp_path, "fm"))) == 4


def _constant_keys(t, n=2):
    """Keys whose JAX draw gives a constant mask at length ``t`` (every
    uniform on one side of 0.7), for the nudge case."""
    out = []
    for seed in range(2000):
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, (t,), jnp.float32))
        if (u > 0.7).all() or (u <= 0.7).all():
            out.append(seed)
            if len(out) == n:
                return out
    raise AssertionError(f"no constant draw at t={t}")


@pytest.mark.parametrize("t", [1, 2, 3, 8, 9, 16])
def test_init_mask_random_matches_jax(t):
    """The transform from uniforms to logits equals JAX's
    ``init_mask_random`` on the uniforms its key draws, bit for bit,
    for ordinary draws and for constant masks (the +0.1 nudge at frame
    min(8, T-1))."""
    seeds = list(range(6)) + (_constant_keys(t) if t <= 3 else [])
    nudged = 0
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(key, (t,), jnp.float32))
        want = np.asarray(jax_init_mask_random(key, t))
        got = init_mask_random(torch.from_numpy(u)).numpy()
        assert got.dtype == np.float32 and np.array_equal(got, want), (seed, got, want)
        nudged += int(np.isin(np.abs(got), np.float32([2.4, 2.6])).any())
    if t <= 3:
        assert nudged >= 2
    # batched: one row per draw, the same rows
    u = torch.rand(5, t, generator=torch.Generator().manual_seed(t))
    assert torch.equal(init_mask_random(u), torch.stack([init_mask_random(r) for r in u]))


@pytest.mark.parametrize("t", [4, 16])
def test_init_mask_random_nudges_constant_masks(t):
    all_off = init_mask_random(torch.zeros(t))
    all_on = init_mask_random(torch.full((t,), 0.99))
    idx = min(8, t - 1)
    want_off, want_on = torch.full((t,), -2.5), torch.full((t,), 2.5)
    want_off[idx], want_on[idx] = -2.5 + 0.1, 2.5 + 0.1
    assert torch.equal(all_off, want_off) and torch.equal(all_on, want_on)
    mixed = init_mask_random(torch.tensor([0.9] + [0.1] * (t - 1)))
    assert torch.equal(mixed, torch.tensor([2.5] + [-2.5] * (t - 1)))


def test_random_draws_are_about_30_percent_ones():
    """The port's own draws: P(u > 0.7) = 0.3 per frame. Over 2000 ids x 16
    frames (32000 draws) the share of on-frames has standard deviation
    sqrt(0.3 * 0.7 / 32000) = 0.00256; held within 5 of them, 0.3 +- 0.0128."""
    draws = torch.stack([draw_mask_random(0, f"clip{i}", 16) for i in range(2000)])
    share = (draws > 0).float().mean().item()
    assert abs(share - 0.3) <= 5 * np.sqrt(0.3 * 0.7 / 32000), share
    values = {float(np.float32(v)) for v in (2.4, 2.5, 2.6)}
    assert draws.dtype == torch.float32 and set(draws.abs().unique().tolist()) <= values
    assert len({tuple(r.tolist()) for r in draws}) > 1500  # ids give distinct draws


def test_random_draws_do_not_depend_on_flush_position():
    """A clip's draw depends on the seed and its id only: the same in any
    order and beside any other ids, another for another seed or id."""
    ids = [f"clip{i}" for i in range(12)]
    forward = {cid: draw_mask_random(7, cid, 16) for cid in ids}
    for cid in reversed(ids):
        assert torch.equal(draw_mask_random(7, cid, 16), forward[cid])
    torch.manual_seed(123)  # the global generator plays no part
    torch.rand(10)
    assert torch.equal(draw_mask_random(7, "clip3", 16), forward["clip3"])
    assert not torch.equal(draw_mask_random(8, "clip3", 16), forward["clip3"])
    assert not torch.equal(forward["clip3"], forward["clip4"])
