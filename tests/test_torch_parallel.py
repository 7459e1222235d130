"""The port's data parallelism (``ivf_tpu_torch/parallel/``) against the JAX
package's meshes, on the CPU: ranks are gloo processes started by
``tests/_torch_dist_worker.py::run_world`` (``file://`` rendezvous under the
module's directory, one torch thread each, every join under a timeout that
kills the ranks); each JAX reference runs once in this process and reaches
the ranks through an ``.npz``.

  * one Adam step of the tiny ConvLSTM on 4 ranks against JAX's 8-device
    ``get_mesh(8)`` step (``tests/test_train.py:291-329``), and on a 2x2
    (slice, data) mesh against ``get_multislice_mesh(2, 4)`` (``:332-375``):
    loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6;
  * I3D with training BatchNorm, 2 ranks x 2 rows, against JAX's
    single-device step at batch 4 (``tests/test_torch_train.py``'s limits)
    and against the port's one-process step within ``BN_ONE_PROCESS``; the
    same step with the BN group unset (per-rank statistics) misses that
    bound: the test sees the statistics the ranks share;
  * ``find_masks(mesh=...)`` on 2 ranks (monolithic, and chunked with
    refill) against the port's one-process run and JAX's
    ``find_masks(mesh=get_mesh(2))``; rank 0 alone writes;
  * the independent-driver layout (``tests/test_multihost_real.py:114-173``);
  * ``api.train`` on two nodes of one rank against JAX's one-process
    ``train(cfg, mesh=get_mesh(2))`` (``tests/test_multihost_real.py:38-111``);
  * the cases of ``tests/test_multihost.py``, and ``train -dp 2`` under
    ``torch.distributed.run``.
"""

import json
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ivf_tpu import api as japi
from ivf_tpu.models import ConvLSTMClassifier as JClassifier
from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.parallel import get_mesh as j_get_mesh
from ivf_tpu.parallel import get_multislice_mesh as j_get_multislice_mesh
from ivf_tpu.parallel import multislice_sharding as j_multislice_sharding
from ivf_tpu.parallel import replicate as j_replicate
from ivf_tpu.parallel import shard_batch as j_shard_batch
from ivf_tpu.parallel.multihost import ShardedDataset as JShardedDataset
from ivf_tpu.parallel.multihost import process_shard as j_process_shard
from ivf_tpu.train import build_optimizer as j_build_optimizer
from ivf_tpu.train import create_train_state as j_create_train_state
from ivf_tpu.train import make_train_step as j_make_train_step
from ivf_tpu_torch import api as tapi
from ivf_tpu_torch.models import i3d_smth
from ivf_tpu_torch.parallel import ShardedDataset, initialize_multihost, process_shard
from ivf_tpu_torch.train import build_optimizer
from ivf_tpu_torch.utils.checkpoint import Checkpointer
from ivf_tpu_torch.utils.convert import variables_to_state_dict
from tests import _torch_dist_worker as worker
from tests.test_torch_train import I3D_KW, check_float32_step, grad_gap, i3d_reference, port_sgd1_step, statistics

# the 2-rank I3D step against the port's one-process step: the ranks' BN
# means are a mean of two means, a sum in another order, which training
# BN through the deep trunk amplifies as it does float32 rounding (the
# one-process step is 0.66% from float64, tests/test_torch_train.py)
BN_ONE_PROCESS = {"grad": 0.002, "loss": 2e-5, "stats": 1e-5}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's steps many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("dist")


def _npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _sd_arrays(sd) -> dict:
    return {f"sd/{k}": v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def _synthetic_clips(n, t=4, hw=16, c=3, classes=3, seed=0):
    """``tests/test_train.py::_synthetic_clips``: class k has brightness ~ k."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, n)
    clips = rng.randn(n, t, hw, hw, c).astype(np.float32) * 0.1
    clips += labels[:, None, None, None, None].astype(np.float32)
    return clips, labels.astype(np.int32)


# ---------------------------------------------------------------- data parallel


@pytest.fixture(scope="module")
def dp_runs(work):
    """JAX's step on its 8-device mesh and on its 2x4 multi-slice mesh (the
    model of ``tests/test_train.py:291``, dropout 0); the port's on 4
    ranks."""
    kw = {k: v for k, v in worker.DP_CLSTM.items() if k not in ("input_size", "clip_len")}
    model = JClassifier(**kw)
    clips, labels = _synthetic_clips(16)
    state = j_create_train_state(model, jax.random.PRNGKey(0), jnp.asarray(clips[:2]), j_build_optimizer("adam", 0.01))
    step = j_make_train_step(donate=False)
    want = {}
    mesh = j_get_mesh(8)
    c, l = j_shard_batch((jnp.asarray(clips), jnp.asarray(labels)), mesh)
    want["data"] = step(j_replicate(state, mesh), c, l, jax.random.PRNGKey(1))
    mesh = j_get_multislice_mesh(2, 4)
    sh = j_multislice_sharding(mesh)
    want["multislice"] = step(j_replicate(state, mesh), jax.device_put(jnp.asarray(clips), sh),
                              jax.device_put(jnp.asarray(labels), sh), jax.random.PRNGKey(1))
    init = variables_to_state_dict({"params": state.params, "batch_stats": {}})
    np.savez(work / "dp_in.npz", clips=clips, labels=labels, **_sd_arrays(init))
    worker.run_world("dp", 4, work)
    return {name: (float(m["loss"]), variables_to_state_dict({"params": new.params, "batch_stats": {}}),
                   _npz(work / f"dp_{name}_out.npz")) for name, (new, m) in want.items()}


@pytest.mark.parametrize("mesh", ["data", "multislice"])
def test_data_parallel_step_matches_jax_mesh(dp_runs, mesh):
    """4 ranks of 4 rows (1-D data mesh; 2x2 slice x data) against JAX's
    sharded step: loss rtol 1e-5, every parameter rtol 1e-4 / atol 1e-6,
    the same parameters on every rank."""
    want_loss, want, got = dp_runs[mesh]
    np.testing.assert_allclose(float(got["loss"]), want_loss, rtol=1e-5)
    assert bool(got["same_on_every_rank"])
    names = [k[3:] for k in got if k.startswith("sd/")]
    assert names and set(names) <= set(want)
    for n in names:
        np.testing.assert_allclose(got[f"sd/{n}"], want[n].numpy(), rtol=1e-4, atol=1e-6, err_msg=n)


# ---------------------------------------------------------------- synchronised BatchNorm


@pytest.fixture(scope="module")
def bn_runs(work):
    ref = i3d_reference({"plain": (dict(), "float32")})
    sd = variables_to_state_dict(ref["variables"])
    np.savez(work / "bn_in.npz", x=ref["x"], y=ref["y"], **_sd_arrays(sd))
    worker.run_world("bn", 2, work)
    model = i3d_smth(**I3D_KW, dropout_rate=0.0)
    one = port_sgd1_step(model, ref["variables"], ref["x"], ref["y"])
    runs = {}
    for name in ("sync", "control"):
        arrays = _npz(work / f"bn_{name}_out.npz")
        runs[name] = (float(arrays["loss"]), {k[3:]: v for k, v in arrays.items() if k.startswith("sd/")},
                      bool(arrays["same_on_every_rank"]))
    return {"jax": ref["plain"], "one": one, "model": model, **runs}


def test_synchronised_bn_step_matches_jax_single_device(bn_runs):
    """2 ranks x 2 rows against JAX's step at batch 4 on one device, at the
    limits of ``test_i3d_train_step_matches_jax_float32``: loss 5e-5,
    gradients 2%, BN statistics 1e-4; every rank holds the same state."""
    loss, got, same = bn_runs["sync"]
    want_loss, want = bn_runs["jax"]
    assert same
    check_float32_step(bn_runs["model"], got, want, loss, want_loss, 0.02, 5e-5, 1e-4)


def _one_process_gap(bn_runs, name) -> dict:
    loss, got, _ = bn_runs[name]
    one_loss, one = bn_runs["one"]
    model = bn_runs["model"]
    params = [n for n, _ in model.named_parameters()]
    return {
        "grad": grad_gap(got, one, params),
        "loss": abs(loss - one_loss),
        "stats": max(float(np.abs(got[n] - one[n]).max()) for n in statistics(model)),
    }


def test_synchronised_bn_step_matches_one_process(bn_runs):
    """Against the port's one-process step at batch 4 (``BN_ONE_PROCESS``):
    gradients within 0.2% as one vector, loss 2e-5, BN statistics 1e-5
    (read: 0.023%, 3.0e-6, 1.2e-6)."""
    gap = _one_process_gap(bn_runs, "sync")
    assert all(gap[k] < BN_ONE_PROCESS[k] for k in gap), gap


def test_per_rank_bn_statistics_miss_the_bound(bn_runs):
    """The control: the same 2-rank step with the BN group unset (each rank
    normalizes its 2 rows by their own statistics, gradients still summed)
    misses ``BN_ONE_PROCESS`` on the gradients and the statistics (read:
    gradients 986% off, statistics 0.12)."""
    gap = _one_process_gap(bn_runs, "control")
    assert gap["grad"] > BN_ONE_PROCESS["grad"] and gap["stats"] > BN_ONE_PROCESS["stats"], gap


# ---------------------------------------------------------------- find_masks


def _by_id(recs) -> dict:
    return {r["video_id"]: r for r in recs}


@pytest.fixture(scope="module")
def fm_runs(work, tmp_path_factory):
    """JAX's ``find_masks(mesh=get_mesh(2))``, the port's one-process run
    and its 2-rank run, for each of ``worker.FM_RUNS``."""
    from ivf_tpu.config import Config as JConfig
    from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips

    base = tmp_path_factory.mktemp("fm")
    jcfg = JConfig()
    jcfg.output_dir, jcfg.model_name = str(base / "init"), "init"
    for key, value in worker.FM_MODEL.items():
        setattr(jcfg.model, key, value)
    jcfg.model.dropout = 0.0
    jcfg.data.batch_size, jcfg.data.clip_size, jcfg.data.input_spatial_size = 4, 8, 32
    jcfg.data.num_workers = 1
    variables = jax.jit(japi.build_model(jcfg, softmax_override=True).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 32, 32, 3)))
    sd = variables_to_state_dict(variables)
    np.savez(work / "fm_in.npz", **_sd_arrays(sd))
    worker.run_world("find_masks", 2, work)
    ranks = []
    for r in range(2):
        with open(work / f"fm_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    out = {}
    for run, mask in worker.FM_RUNS.items():
        stats = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            one = tapi.find_masks(worker.fm_config(base / "one", run, **mask), sd, worker.fm_dataset(),
                                  stats=stats, device="cpu", save_viz=False) + (stats,)
            cfg = jcfg
            cfg.output_dir, cfg.model_name = str(base / "jax"), run
            for key, value in mask.items():
                setattr(cfg.mask, key, value)
            jax_run = japi.find_masks(cfg, variables, dataset=JSyntheticClips(worker.FM_CLIPS, t=8, hw=32,
                                                                              num_classes=2, lazy=False),
                                      save_viz=False, mesh=j_get_mesh(2))
        out[run] = {"ranks": [rk[run] for rk in ranks], "one": one, "jax": jax_run}
    return out


@pytest.mark.parametrize("run", list(worker.FM_RUNS))
def test_find_masks_on_a_mesh_matches_one_process(fm_runs, run):
    """Every rank returns every clip, the same values on both ranks; per
    clip the one-process run's masks within 1e-5, scores 1e-5, CAMs 1e-5,
    its counters and stop steps equal."""
    r0, r1 = fm_runs[run]["ranks"]
    tm1, gc1, st1 = fm_runs[run]["one"]
    for tm, gc, st in (r0, r1):
        assert len(tm) == len(gc) == worker.FM_CLIPS
        for key in ("search_launches", "searched_rows", "padded_rows", "segments_launched", "refill_flushes",
                    "refill_requeued_rows"):
            assert st[key] == st1[key], key
        assert sorted(st["n_steps_run"]) == sorted(st1["n_steps_run"])
        want_tm, want_gc = _by_id(tm1), _by_id(gc1)
        for vid, rec in _by_id(tm).items():
            np.testing.assert_allclose(rec["time_mask"], want_tm[vid]["time_mask"], atol=1e-5)
            for key in ("freeze_score", "reverse_score", "original_score_true"):
                np.testing.assert_allclose(rec[key], want_tm[vid][key], atol=1e-5)
        for vid, rec in _by_id(gc).items():
            np.testing.assert_allclose(rec["GCHeatMap"], want_gc[vid]["GCHeatMap"], atol=1e-5)
    for a, b in zip(r0[0], r1[0]):
        assert a["video_id"] == b["video_id"] and np.array_equal(a["time_mask"], b["time_mask"])


@pytest.mark.parametrize("run", list(worker.FM_RUNS))
def test_find_masks_on_a_mesh_matches_jax_mesh(fm_runs, run):
    """Rank 0's records against JAX's ``find_masks(mesh=get_mesh(2))``:
    masks atol 1e-4, scores 1e-5, CAMs 1e-4 (``tests/test_torch_refill.py``'s
    limits), the same clips."""
    tm, gc, _ = fm_runs[run]["ranks"][0]
    jtm, jgc = (_by_id(x) for x in fm_runs[run]["jax"])
    assert set(_by_id(tm)) == set(jtm)
    for vid, rec in _by_id(tm).items():
        np.testing.assert_allclose(rec["time_mask"], jtm[vid]["time_mask"], atol=1e-4)
        for key in ("freeze_score", "reverse_score", "original_score_guess"):
            np.testing.assert_allclose(rec[key], jtm[vid][key], atol=1e-5)
    for vid, rec in _by_id(gc).items():
        np.testing.assert_allclose(rec["GCHeatMap"], jgc[vid]["GCHeatMap"], atol=1e-4)


def test_find_masks_on_a_mesh_writes_on_rank_0_only(fm_runs, work):
    """Rank 0's output directory holds the pickles, the stats and the
    journal of both runs; rank 1 wrote nothing."""
    for run in worker.FM_RUNS:
        results = work / "fm_rank0" / run / "results"
        assert {p.name for p in results.iterdir()} >= {
            f"allTimeMaskResults_{run}_None_.p", f"allGradCamResults_{run}_None_.p", "search_stats.json",
            "emission_journal.p"}
        with open(results / f"allTimeMaskResults_{run}_None_.p", "rb") as f:
            assert len(pickle.load(f)) == worker.FM_CLIPS
    assert not (work / "fm_rank1").exists()


def test_independent_drivers_cover_the_dataset(fm_runs, work, tmp_path):
    """Two processes with no process group, each over its
    ``ShardedDataset(even=False)`` shard of 5 clips (3 and 2): the shards
    are disjoint, their union is the one-process run's set, and per clip
    masks and freeze scores within rtol 1e-5 / atol 1e-6."""
    worker.run_world("drivers", 2, work)
    shards = []
    for r in range(2):
        with open(work / f"drv_proc{r}.pkl", "rb") as f:
            shards.append(_by_id(pickle.load(f)[0]))
    assert [len(s) for s in shards] == [3, 2] and not set(shards[0]) & set(shards[1])
    cfg = worker.fm_config(tmp_path, "drv", opt_iter=4)
    cfg.data.batch_size = 2
    sd = {k[3:]: torch.from_numpy(v) for k, v in _npz(work / "fm_in.npz").items()}
    single = _by_id(tapi.find_masks(cfg, sd, worker.fm_dataset(5), device="cpu", save_viz=False)[0])
    assert set(shards[0]) | set(shards[1]) == set(single)
    for shard in shards:
        for vid, rec in shard.items():
            np.testing.assert_allclose(rec["time_mask"], single[vid]["time_mask"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(rec["freeze_score"], single[vid]["freeze_score"], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- training across nodes


@pytest.fixture(scope="module")
def t2_init(work):
    """JAX's initial weights of ``tests/_mh_worker.py``'s config (its
    ``train`` draws them from ``cfg.seed``) as a directory of the port's
    checkpoints, the ``pretrained_model_path`` of every port run."""
    from tests._mh_worker import make_cfg

    _, jstate = japi.init_eval_state(make_cfg(work / "t2_jax_init", batch_size=4))
    init = variables_to_state_dict({"params": jstate.params, "batch_stats": jstate.batch_stats})
    seed_state = tapi._train_state(worker.t2_config(work / "unused", 4), "cpu")
    seed_state.model.load_state_dict(init)
    Checkpointer(str(work / "t2_init")).save(seed_state, epoch=0)
    return str(work / "t2_init")


# the two-node run against JAX's (parameters atol, validation losses rtol):
# with Adam at lr 0.01 the first updates are lr * g / (|g| + eps), so an
# element whose gradient is mostly cancellation carries its rounding into
# the update; the port's own one-process run reads 7.3e-5 from JAX there
# and 7.9e-5 (relative) on the second validation loss (JAX's own two
# layouts, mesh(2) against one device: 1.6e-5 on the parameters). SGD
# holds rtol 1e-5 / atol 1e-6 throughout.
T2_JAX_TOL = {"SGD": (1e-6, 1e-5), "ADAM": (2e-4, 2e-4)}


@pytest.mark.parametrize("optimizer", ["SGD", "ADAM"])
def test_two_nodes_train_matches_jax_one_process(work, t2_init, optimizer, tmp_path):
    """``api.train`` on two nodes of one rank each (``LOCAL_WORLD_SIZE=1``,
    node batch 2, each node reading its half of 4 clips) against JAX's
    one-process ``train(cfg, mesh=get_mesh(2))`` at batch 4, from the same
    initial weights: 2 epochs of a ConvLSTM with BatchNorm. The
    parameters and the validation losses rtol 1e-5 / atol 1e-6 against
    the port's one-process ``api.train`` at batch 4 (what the ranks add)
    and against JAX's within ``T2_JAX_TOL``; every rank holds
    the same state; only rank 0 wrote the history, the plots and the
    checkpoints."""
    from tests._mh_worker import make_cfg, make_dataset

    jcfg = make_cfg(tmp_path / "jax", batch_size=4)
    jcfg.optim.optimizer = optimizer
    state, history = japi.train(jcfg, mesh=j_get_mesh(2), train_dataset=make_dataset(), val_dataset=make_dataset())
    want = variables_to_state_dict({"params": state.params, "batch_stats": state.batch_stats})
    one, one_history = tapi.train(worker.t2_config(tmp_path / "one", 4, t2_init, optimizer),
                                  train_dataset=worker._TrainView(), val_dataset=worker._TrainView(), device="cpu")
    worker.run_world("train2", 2, work, env={"LOCAL_WORLD_SIZE": "1", "T2_OPTIMIZER": optimizer})
    outs = [_npz(work / f"t2_{optimizer}_rank{r}_out.npz") for r in range(2)]
    assert all(bool(o["same_on_every_rank"]) for o in outs)
    atol, loss_rtol = T2_JAX_TOL[optimizer]
    np.testing.assert_allclose(outs[0]["val_losses"], [h["val"]["loss"] for h in one_history], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0]["val_losses"], [float(h["val"]["loss"]) for h in history], rtol=loss_rtol,
                               atol=1e-6)
    names = [k[3:] for k in outs[0] if k.startswith("sd/")]
    assert names
    for n in names:
        got = outs[0][f"sd/{n}"]
        np.testing.assert_allclose(got, one.model.state_dict()[n].numpy(), rtol=1e-5, atol=1e-6, err_msg=n)
        np.testing.assert_allclose(got, want[n].numpy(), rtol=1e-5, atol=atol, err_msg=n)
    run0, run1 = work / f"t2_{optimizer}_rank0" / "mh_real", work / f"t2_{optimizer}_rank1" / "mh_real"
    assert (run0 / "history.json").exists() and (run0 / "plots").is_dir() and (run0 / "checkpoint").exists()
    assert not run1.exists()


# ---------------------------------------------------------------- units


def test_process_shard_matches_jax():
    """``tests/test_multihost.py:24-46``: the cover and even shards of every
    count, equal to the JAX package's."""
    for n in (0, 1, 7, 8, 25, 1000):
        for count in (1, 2, 3, 8):
            for even in (False, True):
                got = [list(process_shard(n, i, count, even=even)) for i in range(count)]
                assert got == [list(j_process_shard(n, i, count, even=even)) for i in range(count)]
    with pytest.raises(ValueError):
        process_shard(10, 3, 3)
    assert list(process_shard(5)) == [0, 1, 2, 3, 4]  # no process group: one node holds everything


class _Toy:
    def __init__(self, n):
        self.n, self.catalog = n, "sentinel"

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 4, 4, 3), i, np.uint8), i % 3

    def get_payloads(self, i):
        return [b"payload%d" % i], i % 3


def test_sharded_dataset_views_match_jax():
    """``tests/test_multihost.py:73-98``: even and cover views, the decode
    hook on shard-local indices, attributes passing through."""
    ds = _Toy(10)
    for even in (True, False):
        for i in range(3):
            got, want = ShardedDataset(ds, i, 3, even=even), JShardedDataset(ds, i, 3, even=even)
            assert len(got) == len(want)
            assert [int(got[j][0][0, 0, 0, 0]) for j in range(len(got))] == [
                int(want[j][0][0, 0, 0, 0]) for j in range(len(want))]
    assert ShardedDataset(ds, 1, 3, even=False).get_payloads(0) == ([b"payload4"], 1)
    assert ShardedDataset(ds, 0, 3).catalog == "sentinel"
    assert not hasattr(ShardedDataset(worker._Toy(4), 0, 2), "get_payloads")


def test_initialize_without_a_coordinator_is_a_no_op(monkeypatch):
    """No ``torchrun`` variables and no JAX coordinator: no process group,
    ``False``, nothing touched."""
    for name in ("MASTER_ADDR", "MASTER_PORT", "JAX_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_multihost() is False
    assert not torch.distributed.is_initialized()


def test_importing_parallel_starts_nothing():
    """A fresh interpreter that imports ``ivf_tpu_torch.parallel`` has no
    process group and has not initialized CUDA, and has no JAX."""
    code = (
        "import sys, torch, torch.distributed as dist\n"
        "import ivf_tpu_torch.parallel\n"
        "assert not dist.is_initialized() and not torch.cuda.is_initialized()\n"
        "assert not any(m.split('.')[0] in ('jax', 'ivf_tpu') for m in sys.modules)\n"
        "print('clean')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=worker.REPO,
                          timeout=120, env={**os.environ, "PYTHONPATH": str(worker.REPO)})
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def unit_checks(work):
    worker.run_world("units", 2, work)
    return [json.loads((work / f"units_rank{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("check", worker.UNIT_CHECKS)
def test_multi_rank_units(unit_checks, check):
    """The multi-rank cases of ``tests/test_multihost.py`` on 2 ranks
    (``worker.scenario_units``): each named check holds on both ranks."""
    assert all(checks[check] for checks in unit_checks), [checks[check] for checks in unit_checks]


# ---------------------------------------------------------------- the command line


def _frame_tree(root, clips: int, hw: int = 16, frames: int = 4):
    from PIL import Image

    rng = np.random.RandomState(5)
    for split in ("train", "validation"):
        for i in range(clips):
            d = root / split / str(i % 2) / f"{split}{i}"
            d.mkdir(parents=True)
            for t in range(frames):
                Image.fromarray(rng.randint(0, 256, (hw, hw, 3)).astype(np.uint8)).save(d / f"frame{t + 1:02d}.jpg")


def test_cli_train_under_torchrun_writes_history_once(tmp_path):
    """``python -m torch.distributed.run --nproc-per-node 2 -m
    ivf_tpu_torch.cli train -dp 2 --device cpu`` on a frame tree: both
    ranks finish, rank 0 writes ``history.json`` (two epochs), the
    checkpoints and the plots."""
    _frame_tree(tmp_path / "tree", 4)
    cfg = {**worker.T2_FIELDS, "output_dir": str(tmp_path / "out"), "data_folder": str(tmp_path / "tree"),
           "batch_size": 4, "model_name": "cli_dp"}
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "ivf_tpu_torch.cli", "train", "-c", str(tmp_path / "cfg.json"), "-dp", "2", "--device", "cpu"],
        capture_output=True, text=True, cwd=worker.REPO, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(worker.REPO)},
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    run = tmp_path / "out" / "cli_dp"
    history = json.loads((run / "history.json").read_text())
    assert [h["epoch"] for h in history] == [0, 1]
    assert (run / "checkpoint").exists() and (run / "plots" / "loss_plot.png").exists()
    assert proc.stdout.count("> epoch 1:") == 2  # both ranks trained both epochs
