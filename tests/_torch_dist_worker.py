"""Multi-process bodies of ``tests/test_torch_parallel.py`` and
``tests/test_torch_pipeline.py``, and the launcher that runs them.

Not collected by pytest (leading underscore), and free of JAX: the
children must not import it (the container registers a TPU backend for
JAX at interpreter start) nor run the conftest. ``run_world`` starts one
process per rank with ``subprocess``, rendezvous by a ``file://`` path under
the test's ``tmp_path`` (no port, no ``env://``), one torch thread each,
the process group's timeout below the join's; on expiry every child is
killed, so a deadlock fails its test within ``timeout`` seconds. The JAX
references are computed once per module in the pytest process and reach
the ranks through ``.npz`` files in the same directory; each scenario
writes what it got beside them.

    python tests/_torch_dist_worker.py <scenario> <rank> <world> <init> <dir>
"""

from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
import time
import uuid
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
GROUP_TIMEOUT_S = 90.0


def run_world(scenario: str, world: int, out_dir, timeout: float = 120.0, env: dict = None) -> list:
    """Run ``scenario`` on ``world`` ranks; returns each rank's output.
    Fails (after killing every rank) on a timeout or a non-zero exit."""
    out_dir = Path(out_dir)
    init = f"file://{out_dir / f'rdzv_{scenario}_{uuid.uuid4().hex}'}"
    child_env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO), **(env or {})}
    logs = [out_dir / f"{scenario}_rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, scenario, str(r), str(world), init, str(out_dir)],
                stdout=log, stderr=subprocess.STDOUT, env=child_env, cwd=REPO,
            ))
    deadline = time.monotonic() + timeout
    timed_out = False
    for p in procs:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
            break
    if timed_out:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
    outs = [log.read_text() for log in logs]
    if timed_out or any(p.returncode for p in procs):
        detail = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{outs[r][-3000:]}" for r, p in enumerate(procs))
        raise AssertionError(f"{scenario}: {'timed out after %.0f s' % timeout if timed_out else 'a rank failed'}\n"
                             f"{detail}")
    return outs


# ---------------------------------------------------------------- helpers


def _npz(path) -> dict:
    import numpy as np

    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _state_dict(arrays: dict, prefix: str = "sd/") -> dict:
    import torch

    return {k[len(prefix):]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith(prefix)}


def _save(path, tensors: dict) -> None:
    import numpy as np

    np.savez(path, **{k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
                      for k, v in tensors.items()})


def _same_on_every_rank(t) -> bool:
    """Every rank of the world holds ``t``'s bits."""
    import torch
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t.contiguous())
    return all(torch.equal(p, parts[0]) for p in parts)


# ---------------------------------------------------------------- data parallel

DP_CLSTM = dict(num_classes=3, nb_lstm_units=4, lstm_layers=1, conv_kernel_size=3, effective_steps=(3,),
                batch_norm=False, dropout_rate=0.0, input_size=(16, 16), clip_len=4)


def scenario_dp(rank: int, world: int, out: Path) -> None:
    """One Adam step of the tiny ConvLSTM over a 1-D data mesh and over a
    2x2 (slice, data) mesh, each rank on its rows of the 16-clip batch."""
    import torch

    from ivf_tpu_torch.models import ConvLSTMClassifier
    from ivf_tpu_torch.parallel import get_mesh, get_multislice_mesh, shard_batch
    from ivf_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    data = _npz(out / "dp_in.npz")
    for name, mesh in (("data", get_mesh()), ("multislice", get_multislice_mesh(2, world // 2))):
        model = ConvLSTMClassifier(**DP_CLSTM)
        model.load_state_dict(_state_dict(data))
        state = create_train_state(model, build_optimizer("adam", 0.01))
        clips, labels = shard_batch((data["clips"], data["labels"]), mesh)
        assert clips.shape[0] == 16 // world
        state, metrics = make_train_step(mesh=mesh)(state, clips, labels)
        same = all(_same_on_every_rank(p.detach()) for p in state.model.parameters())
        if rank == 0:
            _save(out / f"dp_{name}_out.npz", {"loss": metrics["loss"], "same_on_every_rank": same,
                                               **{f"sd/{n}": p for n, p in state.params().items()}})


def scenario_bn(rank: int, world: int, out: Path) -> None:
    """One SGD(lr 1) step of I3D with training BN, 2 ranks x 2 rows, with
    the BN statistics synchronised and (the control) left per rank."""
    import torch

    from ivf_tpu_torch.models import i3d_smth
    from ivf_tpu_torch.parallel import get_mesh, shard_batch
    from ivf_tpu_torch.train import build_optimizer, create_train_state, loop, make_train_step

    data = _npz(out / "bn_in.npz")
    mesh = get_mesh()
    sync = loop.set_batch_stats_group
    for name in ("sync", "control"):
        if name == "control":
            loop.set_batch_stats_group = lambda model, group: sync(model, None)
        model = i3d_smth(num_classes=5, pool_shape=(1, 1, 1), dropout_rate=0.0)
        model.load_state_dict(_state_dict(data))
        state = create_train_state(model, build_optimizer("sgd", 1.0, momentum=0.0))
        before = {n: p.detach().clone() for n, p in state.params().items()}
        clips, labels = shard_batch((data["x"], data["y"]), mesh)
        state, metrics = make_train_step(mesh=mesh)(state, clips, labels)
        got = {f"sd/{n}": before[n] - p.detach() for n, p in state.params().items()}
        got.update({f"sd/{n}": b for n, b in state.batch_stats().items()})
        same = all(_same_on_every_rank(t) for t in state.model.state_dict().values())
        if rank == 0:
            _save(out / f"bn_{name}_out.npz", {"loss": metrics["loss"], "same_on_every_rank": same, **got})
    loop.set_batch_stats_group = sync


# ---------------------------------------------------------------- find_masks

FM_MODEL = dict(conv_model="clstm", num_classes=2, clstm_hidden=4, clstm_layers=1, conv_stride=1,
                effective_steps=(3, 7))
FM_RUNS = {"monolithic": dict(opt_iter=4), "refill": dict(opt_iter=8, chunk_steps=2, early_stop=True, eta=3e-3,
                                                           refill=True)}
FM_CLIPS = 6  # batches of 4: the last one padded


def fm_config(out_dir, name: str, **mask):
    """The tiny ConvLSTM search of ``tests/test_torch_refill.py``
    (8x32x32 clips, batches of 4)."""
    from ivf_tpu_torch.config import Config

    cfg = Config()
    cfg.output_dir, cfg.model_name = str(out_dir), name
    for key, value in FM_MODEL.items():
        setattr(cfg.model, key, value)
    cfg.model.dropout = 0.0
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, 8, 32
    cfg.data.num_workers = 1
    for key, value in mask.items():
        setattr(cfg.mask, key, value)
    return cfg


def fm_dataset(n: int = FM_CLIPS):
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    return SyntheticClips(n, t=8, hw=32, num_classes=2, lazy=False)


def scenario_find_masks(rank: int, world: int, out: Path) -> None:
    """``find_masks(mesh=get_mesh())`` on both runs, each rank with its own
    output directory; every rank keeps what it returned."""
    import warnings

    from ivf_tpu_torch import api
    from ivf_tpu_torch.parallel import get_mesh

    weights = _state_dict(_npz(out / "fm_in.npz"))
    mesh = get_mesh()
    got = {}
    for run, mask in FM_RUNS.items():
        stats = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            got[run] = api.find_masks(fm_config(out / f"fm_rank{rank}", run, **mask), weights, fm_dataset(),
                                      stats=stats, save_viz=False, mesh=mesh) + (stats,)
    with open(out / f"fm_rank{rank}.pkl", "wb") as f:
        pickle.dump(got, f)


def scenario_drivers(rank: int, world: int, out: Path) -> None:
    """The independent-driver layout: no process group; this process's
    ``ShardedDataset(even=False)`` shard of 5 clips."""
    from ivf_tpu_torch import api
    from ivf_tpu_torch.parallel import ShardedDataset

    weights = _state_dict(_npz(out / "fm_in.npz"))
    ds = ShardedDataset(fm_dataset(5), process_index=rank, process_count=world, even=False)
    cfg = fm_config(out / f"drv_proc{rank}", "drv", opt_iter=4)
    cfg.data.batch_size = 2
    tm, gc = api.find_masks(cfg, weights, ds, device="cpu", save_viz=False)
    assert len(tm) == len(gc) == len(ds)
    with open(out / f"drv_proc{rank}.pkl", "wb") as f:
        pickle.dump((tm, gc), f)


# ---------------------------------------------------------------- units

class _Toy:
    """``tests/test_multihost.py``'s toy dataset: clip i is filled with i."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        import numpy as np

        return np.full((2, 4, 4, 3), i, np.uint8), i % 3


UNIT_CHECKS = (
    "global_device_batch_rows", "shard_batch_rows", "global_sum", "clip_loader_rows",
    "clip_loader_batch_not_divisible_raises", "clip_loader_other_device_raises", "get_mesh_other_size_raises",
    "get_2d_mesh_other_size_raises", "spatial_sharding_points_at_13b", "initialize_twice",
    "train_without_mesh_raises", "infer_without_mesh_raises", "find_masks_device_other_than_mesh_raises",
)


def scenario_units(rank: int, world: int, out: Path) -> None:
    """The multi-rank cases of ``tests/test_multihost.py``: named checks."""
    import numpy as np
    import torch

    from ivf_tpu_torch import api
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.loaders import ClipLoader
    from ivf_tpu_torch.parallel import (
        ShardedDataset, get_2d_mesh, get_mesh, global_device_batch, initialize_multihost, shard_batch,
        spatial_sharding,
    )

    checks = {}

    def raises(fn, exc, text=""):
        try:
            fn()
        except exc as e:
            return text in str(e)
        return False

    mesh = get_mesh()
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    clips = np.arange(8 * 2 * 4, dtype=np.float32).reshape(8, 2, 4)
    labels = np.arange(8, dtype=np.int32)
    ids = ["a", "b"]
    g_clips, g_labels, g_ids = global_device_batch((clips, labels, ids), mesh)
    checks["global_device_batch_rows"] = (
        type(g_clips) is torch.Tensor and np.array_equal(g_clips.numpy(), clips[rows])
        and np.array_equal(g_labels.numpy(), labels[rows]) and g_ids is ids
    )
    s_clips, s_labels = shard_batch((clips, labels), mesh)
    checks["shard_batch_rows"] = np.array_equal(s_clips.numpy(), clips[rows])
    total = g_clips.sum()
    torch.distributed.all_reduce(total)
    checks["global_sum"] = float(total) == float(clips.sum())

    loader = ClipLoader(ShardedDataset(_Toy(16)), batch_size=8, mesh=mesh, use_native=False, num_workers=1)
    batches = list(loader)
    checks["clip_loader_rows"] = (
        len(batches) == 2 and tuple(batches[0][0].shape) == (8 // world, 2, 4, 4, 3)
        and np.array_equal(batches[0][1].numpy(), (np.arange(8, dtype=np.int32) % 3)[rows])
        and np.array_equal(batches[1][0][:, 0, 0, 0, 0].numpy(), np.arange(8, 16)[rows])
    )
    checks["clip_loader_batch_not_divisible_raises"] = raises(
        lambda: ClipLoader(_Toy(6), batch_size=3, mesh=mesh), ValueError, "does not split")
    checks["clip_loader_other_device_raises"] = raises(
        lambda: ClipLoader(_Toy(6), batch_size=2, mesh=mesh, device="cuda"), ValueError, "mesh")
    checks["get_mesh_other_size_raises"] = raises(lambda: get_mesh(world + 1), ValueError, "world")
    checks["get_2d_mesh_other_size_raises"] = raises(lambda: get_2d_mesh(world, 2), ValueError, "every rank")
    checks["spatial_sharding_points_at_13b"] = raises(lambda: spatial_sharding(mesh), NotImplementedError, "13b")
    checks["initialize_twice"] = initialize_multihost() is True

    cfg = Config()
    cfg.output_dir = str(out / f"units_rank{rank}")
    checks["train_without_mesh_raises"] = raises(
        lambda: api.train(cfg, train_dataset=_Toy(8), val_dataset=_Toy(8), device="cpu"), ValueError,
        "multi-host training")
    checks["infer_without_mesh_raises"] = raises(
        lambda: api.infer(cfg, state=object(), dataset=_Toy(8), device="cpu"), ValueError, "multi-host inference")
    checks["find_masks_device_other_than_mesh_raises"] = raises(
        lambda: api.find_masks(cfg, None, _Toy(8), device="cuda", mesh=mesh), ValueError, "mesh")
    assert set(checks) == set(UNIT_CHECKS)
    with open(out / f"units_rank{rank}.json", "w") as f:
        json.dump(checks, f)


# ---------------------------------------------------------------- training across nodes

T2_FIELDS = {
    "model_name": "mh_real", "data_folder": "", "conv_model": "clstm", "num_classes": 2, "clip_size": 4,
    "input_spatial_size": 16, "clstm_hidden": 4, "clstm_layers": 1, "conv_stride": 1, "batch_norm": True,
    "dropout": 0.0, "optimizer": "ADAM", "lr": 0.01, "num_epochs": 2, "num_workers": 1, "shuffle": 0,
    "print_freq": 0,
}


def t2_config(out_dir, batch_size: int, pretrained: str = "no_ckpt", optimizer: str = "ADAM"):
    """``tests/_mh_worker.py``'s config: ``batch_size`` is the node's."""
    from ivf_tpu_torch.config import Config

    cfg = Config.from_dict({**T2_FIELDS, "output_dir": str(out_dir), "batch_size": batch_size,
                            "optimizer": optimizer})
    cfg.model.pretrained_model_path = pretrained
    return cfg


class _TrainView:
    """(clip, label) pairs of 4 synthetic clips: one global batch."""

    def __init__(self):
        from ivf_tpu_torch.data.synthetic import SyntheticClips

        self.ds = SyntheticClips(4, t=4, hw=16, num_classes=2, seed=3, lazy=False)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        clip, label, _ = self.ds[i]
        return clip, label


def scenario_train2(rank: int, world: int, out: Path) -> None:
    """``api.train`` on two nodes of one rank (``LOCAL_WORLD_SIZE=1``), the
    node batch 2, each rank with its own output directory; the optimizer
    ``T2_OPTIMIZER``."""
    from ivf_tpu_torch import api
    from ivf_tpu_torch.parallel import get_mesh

    opt = os.environ["T2_OPTIMIZER"]
    cfg = t2_config(out / f"t2_{opt}_rank{rank}", 2, str(out / "t2_init"), opt)
    state, history = api.train(cfg, mesh=get_mesh(), train_dataset=_TrainView(), val_dataset=_TrainView())
    same = all(_same_on_every_rank(t) for t in state.model.state_dict().values())
    _save(out / f"t2_{opt}_rank{rank}_out.npz", {
        "val_losses": [float(h["val"]["loss"]) for h in history], "same_on_every_rank": same,
        **{f"sd/{n}": p for n, p in state.params().items()},
    })


# ---------------------------------------------------------------- pipeline and tensor parallel


def harness_stages(w: dict):
    """``tests/test_train.py:470-507``'s four stages of other widths and
    ranks, on the given weights."""
    import torch

    w1, w2, w3 = (torch.from_numpy(w[k]) for k in ("w1", "w2", "w3"))
    return [
        lambda x: torch.tanh(x @ w1),
        lambda x: torch.cat([x @ w2, x[:, :1]], -1),
        lambda x: (x[:, None, :] * x[:, :, None]).reshape(x.shape[0], -1)[:, :12],
        lambda x: torch.softmax(x @ w3, -1),
    ]


def scenario_pipeline(rank: int, world: int, out: Path) -> None:
    """The GPipe harness for n_micro 4 and 8, its gradients, and I3D in 4
    stages, over a 4-rank 'stage' mesh."""
    import torch

    from ivf_tpu_torch.models import i3d_smth
    from ivf_tpu_torch.parallel import get_mesh, i3d_stage_fns, pipeline_apply, stage_io_shapes

    mesh = get_mesh(world, axis_name="stage")
    data = _npz(out / "pp_in.npz")
    got = {}
    stages = harness_stages(data)
    x = torch.from_numpy(data["x"])
    got["shapes"] = [list(s.shape) for s in stage_io_shapes(stages, (1, 6))]
    for n_micro in (4, 8):
        with torch.no_grad():
            y = pipeline_apply(stages, x, mesh, n_micro=n_micro)
        got[f"harness_{n_micro}"] = y
        got[f"harness_{n_micro}_same_on_every_rank"] = _same_on_every_rank(y)
    # gradients of input and the first stage's weight
    ws = [torch.from_numpy(data[f"g_w{i}"]) for i in range(4)]
    gx = torch.from_numpy(data["g_x"]).requires_grad_(True)
    w0 = ws[0].clone().requires_grad_(True)
    st = [lambda a: torch.tanh(a @ w0)] + [lambda a, w=w: torch.tanh(a @ w) for w in ws[1:]]
    loss = (pipeline_apply(st, gx, mesh, n_micro=4) ** 2).sum()
    loss.backward()
    if rank == 0:
        got["grad_x"], got["grad_w0"] = gx.grad, w0.grad
    # I3D in four stages
    model = i3d_smth(num_classes=8, pool_shape=(2, 2, 2), dropout_rate=0.0)
    model.load_state_dict(_state_dict(data))
    model.requires_grad_(False)
    with torch.no_grad():
        got["i3d"] = pipeline_apply(i3d_stage_fns(model, 4), torch.from_numpy(data["clips"]), mesh, n_micro=8)
    if rank == 0:
        with open(out / "pp_out.pkl", "wb") as f:
            pickle.dump({k: v.numpy() if hasattr(v, "numpy") else v for k, v in got.items()}, f)


TP_ROUTES = {"plain": dict(fuse_1x1=False), "kernels_fused_1x1": dict(use_pallas=True, fuse_1x1=True),
             "fused_branch3": dict(use_pallas=True, fuse_pool_conv=True), "fuse_3x3": dict(fuse_3x3=True)}


def scenario_tp(rank: int, world: int, out: Path) -> None:
    """I3D on a 2x2 (data, model) mesh: each rank its data rows and its
    slice of every divisible layer, on each route."""
    import torch

    from ivf_tpu_torch.models import i3d_smth
    from ivf_tpu_torch.parallel import all_gather_along, batch_group, get_2d_mesh, shard_batch, tensor_parallel

    data = _npz(out / "pp_in.npz")
    mesh = get_2d_mesh(2, world // 2)
    clips = shard_batch(data["clips"][:4], mesh)
    got = {}
    for route, flags in TP_ROUTES.items():
        model = i3d_smth(num_classes=8, pool_shape=(2, 2, 2), dropout_rate=0.0, **flags)
        model.load_state_dict(_state_dict(data))
        model.requires_grad_(False)
        tensor_parallel(model, mesh)
        sliced = sum(1 for m in model.modules() if getattr(m, "tp_group", None) is not None)
        with torch.no_grad():
            y = all_gather_along(model(clips), 0, batch_group(mesh))
        got[route] = y.numpy()
        got[f"{route}_sliced_units"] = sliced
        got[f"{route}_same_on_every_rank"] = _same_on_every_rank(y)
    if rank == 0:
        with open(out / "tp_out.pkl", "wb") as f:
            pickle.dump(got, f)


SCENARIOS = {
    "dp": scenario_dp, "bn": scenario_bn, "find_masks": scenario_find_masks, "units": scenario_units,
    "train2": scenario_train2, "pipeline": scenario_pipeline, "tp": scenario_tp, "drivers": scenario_drivers,
}
NO_GROUP = ("drivers",)


def main() -> None:
    scenario, rank, world, init, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    sys.path.insert(0, str(REPO))
    import torch

    torch.set_num_threads(1)
    if scenario in NO_GROUP:
        SCENARIOS[scenario](rank, world, Path(out))
    else:
        import torch.distributed as dist

        from ivf_tpu_torch.parallel import initialize_multihost

        assert initialize_multihost(init, world, rank, device="cpu", timeout_s=GROUP_TIMEOUT_S) == (world > 1)
        SCENARIOS[scenario](rank, world, Path(out))
        dist.barrier()
        dist.destroy_process_group()
    assert "jax" not in sys.modules and "ivf_tpu" not in sys.modules
    print(f"WORKER_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
