"""The port's chunked search (``interpret/mask_opt.py::search_segment``),
its early-stop segment skip, convergence refill and last-batch padding
(``api.find_masks``), on the CPU, against the port's own monolithic search
and against the JAX package's ``find_masks``.

The runs follow ``tests/test_refill.py``: the tiny ConvLSTM (1 layer x 4
hidden, 2 classes, 8x32x32 clips, batches of 4, 8 steps in segments of 2,
``early_stop`` at eta=3e-3, where the stop steps differ across and within
batches), with the JAX model's seeded init carried across by
``utils.convert``. Within the port the paths are held to equal bits: a
row's search does not depend on its batch-mates or its place in the batch
at a fixed batch shape, which refill needs. Against JAX: masks atol 1e-4,
scores 1e-5, CAMs 1e-4, the tolerances of ``tests/test_torch_api.py``
(measured here: masks <= 8.4e-9, scores <= 1.2e-7, CAMs <= 1.9e-6), and
the same stop steps, counters and emission order.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.interpret import mask_opt
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict

MODEL = dict(
    conv_model="clstm", num_classes=2, clstm_hidden=4, clstm_layers=1, conv_stride=1,
    effective_steps=(3, 7),
)
REFILL = dict(opt_iter=8, chunk_steps=2, early_stop=True, eta=3e-3)
SCORES = ("original_score_guess", "original_score_true", "freeze_score", "reverse_score")
COUNTERS = ("search_launches", "searched_rows", "padded_rows", "segments_launched",
            "refill_flushes", "refill_requeued_rows")


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


def _port_run(out_dir, sd, n_clips=8, name="fm", **mask):
    cfg = _configure(TConfig(), out_dir, name, **mask)
    stats = {}
    tm, gc = tapi.find_masks(
        cfg, sd, SyntheticClips(n_clips, t=8, hw=32, num_classes=2, lazy=False), stats=stats,
        device="cpu", save_viz=False,
    )
    return tm, gc, stats


def _jax_run(out_dir, variables, n_clips=8, **mask):
    cfg = _configure(JConfig(), out_dir, "fm", **mask)
    cfg.data.num_workers = 1
    stats = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the loose-eta warning
        tm, gc = japi.find_masks(
            cfg, variables,
            dataset=JSyntheticClips(n_clips, t=8, hw=32, num_classes=2, lazy=False),
            save_viz=False, stats=stats,
        )
    return tm, gc, stats


def _assert_same_bits(a, b):
    """Per-clip records and CAMs of two port runs, keyed by clip id."""
    (tm0, gc0), (tm1, gc1) = a, b
    by_id = lambda recs: {r["video_id"]: r for r in recs}  # noqa: E731
    tm0, tm1, gc0, gc1 = by_id(tm0), by_id(tm1), by_id(gc0), by_id(gc1)
    assert set(tm0) == set(tm1) == set(gc0) == set(gc1)
    for vid in tm0:
        for key, value in tm0[vid].items():
            if isinstance(value, np.ndarray):
                assert np.array_equal(value, tm1[vid][key]), (vid, key)
            else:
                assert value == tm1[vid][key], (vid, key)
        assert np.array_equal(gc0[vid]["GCHeatMap"], gc1[vid]["GCHeatMap"]), vid


@pytest.fixture(scope="module")
def refill_runs(state_dict, tmp_path_factory):
    out = tmp_path_factory.mktemp("refill")
    return {
        name: _port_run(out, state_dict, name=name, **dict(REFILL, **extra))
        for name, extra in (
            ("refill", dict(refill=True)),
            ("no_refill", dict(refill=False)),
            ("monolithic", dict(chunk_steps=None)),
        )
    }


def test_refill_matches_nonrefill_bitexact(refill_runs):
    """Refill on against off (``tests/test_refill.py:64``): equal bits per
    clip, the mechanism engaged, no more segments than without refill,
    the same stop steps; and the chunked search without refill has the
    bits of the monolithic one."""
    on, off, mono = refill_runs["refill"], refill_runs["no_refill"], refill_runs["monolithic"]
    st1, st0 = on[2], off[2]
    assert st1["refill_requeued_rows"] > 0 and st1["refill_flushes"] > 0, st1
    assert st0["refill_requeued_rows"] == 0 and st0["refill_flushes"] == 0
    assert st1["segments_launched"] <= st0["segments_launched"], (st0, st1)
    assert sorted(st0["n_steps_run"]) == sorted(st1["n_steps_run"])
    assert len(set(st0["n_steps_run"])) > 1, "homogeneous stop steps: re-tune eta"
    assert [r["video_id"] for r in off[0]] == [f"clip{i}" for i in range(8)]  # staging order
    _assert_same_bits(on[:2], off[:2])
    _assert_same_bits(off[:2], mono[:2])
    assert mono[2]["segments_launched"] == 0 and mono[2]["n_steps_run"] == st0["n_steps_run"]


@pytest.mark.parametrize(
    "n_clips,mask",
    [(8, dict(REFILL, refill=True)), (6, dict(opt_iter=4)), (6, dict(REFILL, refill=True))],
    ids=["refill", "padded_monolithic", "padded_refill"],
)
def test_find_masks_matches_jax(jax_variables, state_dict, refill_runs, tmp_path, n_clips, mask):
    """The port against ``ivf_tpu.api.find_masks`` with the same settings:
    the 8-clip refill run, and 6 clips in batches of 4 (the last batch
    padded by 2 repeated rows, monolithic and with refill). Records in the
    same order (staging order, or retirement order under refill), the same
    counters, ``padded_rows`` included, and the same stop steps."""
    if n_clips == 8:
        tm, gc, st = refill_runs["refill"]
    else:
        tm, gc, st = _port_run(tmp_path / "port", state_dict, n_clips=n_clips, **mask)
    jtm, jgc, jst = _jax_run(tmp_path / "jax", jax_variables, n_clips=n_clips, **mask)
    assert [r["video_id"] for r in tm] == [r["video_id"] for r in jtm]
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    assert st["padded_rows"] == (2 if n_clips == 6 else 0) + (st["refill_flushes"] * 4 - st["refill_requeued_rows"])
    assert st["n_steps_run"] == jst["n_steps_run"]
    for got, want in zip(tm, jtm):
        assert set(got) == set(want)
        for key in ("true_class", "pred_class", "video_id"):
            assert got[key] == want[key]
        for key in SCORES:
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=1e-4)
    for got, want in zip(gc, jgc):
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)


def test_refill_gating(state_dict, tmp_path):
    """Refill engages only on the chunked path under early_stop
    (``tests/test_refill.py``): not without early_stop, where every segment
    runs, and not on a monolithic search."""
    _, _, st = _port_run(tmp_path, state_dict, n_clips=4, name="a", opt_iter=4, chunk_steps=2, refill=True)
    assert (st["refill_flushes"], st["refill_requeued_rows"], st["segments_launched"]) == (0, 0, 2)
    _, _, st = _port_run(tmp_path, state_dict, n_clips=4, name="b", **dict(REFILL, chunk_steps=8))
    assert (st["refill_flushes"], st["refill_requeued_rows"], st["segments_launched"]) == (0, 0, 0)


@pytest.mark.parametrize("chunk_steps", [0, -2])
def test_chunk_steps_must_be_positive(state_dict, tmp_path, chunk_steps):
    with pytest.raises(ValueError, match="chunk_steps"):
        _port_run(tmp_path, state_dict, n_clips=1, chunk_steps=chunk_steps)


def _search_case(state_dict):
    cfg = _configure(TConfig(), "", "case")
    model = tapi.build_model(cfg, softmax_override=True, device="cpu")
    model.load_state_dict(state_dict)
    model.requires_grad_(False)
    ds = SyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False)
    clips = torch.from_numpy(np.stack([ds[i][0] for i in range(4)])).float()
    score = lambda x: model(x).float()  # noqa: E731
    targets = torch.tensor([0, 1, 0, 1])
    inits = mask_opt.init_mask_central(score, clips, targets)
    return score, clips, targets, mask_opt.make_search_carry(inits)


@pytest.mark.parametrize("early_stop", [False, True], ids=["fixed", "early_stop"])
@pytest.mark.parametrize("segments", [(3, 3, 2), (2, 2, 2, 2), (5, 3), (1, 7)])
def test_chained_segments_equal_the_monolithic_search(state_dict, segments, early_stop):
    """``search_segment`` chained over ``segments`` (a remainder segment
    where the lengths are unequal), then finalize, against
    ``find_mask_from_carry``'s single loop of 8 steps: equal bits in every
    field of the result, with and without early stop (eta 3e-3: the rows
    stop at different steps, and the single loop stops once all froze)."""
    score, clips, targets, carry = _search_case(state_dict)
    kw = dict(early_stop=early_stop, eta=3e-3)
    want = mask_opt.find_mask_from_carry(score, clips, targets, carry, n_steps=8, **kw)
    for n in segments:
        carry = mask_opt.search_segment(score, clips, targets, carry, n_steps=n, **kw)
    got = mask_opt.finalize_search(score, clips, targets, carry)
    for field in got._fields:
        assert torch.equal(getattr(got, field), getattr(want, field)), field
    if early_stop:
        assert len(set(want.n_steps_run.tolist())) > 1
