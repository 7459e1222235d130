"""The port's optimizers, schedules, metrics, epoch loop, checkpoints,
inference files and training driver against the JAX package's, on the
CPU.

Each optimizer is held to its optax chain over 5 steps with a learning
rate change between them; both schedulers and the top-k metric to their
JAX copies; a three-epoch ``fit`` of a small torch-family ConvLSTM (dropout
0) to JAX's history; ``infer``'s files and top-k rule to JAX's. The rest
is the port alone: a mid-epoch resume (with dropout drawn per step) gives
the bits of an uninterrupted run, through ``fit`` and through
``api.train``; the checkpoint round trip, its async writer, the best copy
and the logits-skipping restore; ``PlotLearning``; the settings that
raise.
"""

import json
import os
import pickle

import numpy as np
import optax
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from ivf_tpu import api as japi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.models import ConvLSTMClassifier as JClassifier
from ivf_tpu.train import PatienceHalving as JPatienceHalving
from ivf_tpu.train import ReduceLROnPlateau as JReduceLROnPlateau
from ivf_tpu.train import build_optimizer as j_build_optimizer
from ivf_tpu.train import create_train_state as j_create_train_state
from ivf_tpu.train import fit as j_fit
from ivf_tpu.train import topk_accuracy as j_topk_accuracy
from ivf_tpu.train.optim import set_learning_rate as j_set_learning_rate
from ivf_tpu.utils import results as j_results
from ivf_tpu_torch import api as tapi
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.models import ConvLSTMClassifier
from ivf_tpu_torch.train import (
    AverageMeter,
    PatienceHalving,
    ReduceLROnPlateau,
    build_optimizer,
    create_train_state,
    fit,
    get_learning_rate,
    set_learning_rate,
    topk_accuracy,
)
from ivf_tpu_torch.utils import results as t_results
from ivf_tpu_torch.utils.checkpoint import Checkpointer
from ivf_tpu_torch.utils.convert import variables_to_state_dict
from ivf_tpu_torch.viz import PlotLearning
from tests.test_torch_train import fill_variables

CLSTM = dict(num_classes=3, nb_lstm_units=4, lstm_layers=1, conv_stride=1, effective_steps=(1, 3))
T, HW = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's steps many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


OPTIMIZERS = [
    ("sgd", 0.9, 1e-2),
    ("sgd", 0.0, 0.0),
    ("adam", 0.9, 1e-2),
    ("adadelta", 0.9, 0.0),
    ("momentum", 0.9, 1e-2),
    ("momentum_decoupled", 0.2, 1e-2),
]


@pytest.mark.parametrize("name,momentum,wd", OPTIMIZERS)
def test_optimizer_matches_optax(name, momentum, wd):
    """5 steps of seeded gradients on two tensors, the learning rate set
    from 0.1 to 0.03 after the second: parameters within 2e-6 of their
    largest value after every step (read: 1.2e-7, Adam's bias correction
    in another float32 pow than XLA's), the rate in the state equal."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()} for _ in range(5)]
    tx = j_build_optimizer(name, 0.1, momentum=momentum, weight_decay=wd)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = tx.init(jp)
    opt = build_optimizer(name, 0.1, momentum=momentum, weight_decay=wd)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = opt.init(tp)
    for step, g in enumerate(grads):
        if step == 2:
            js = j_set_learning_rate(js, 0.03)
            ts = set_learning_rate(ts, 0.03)
        updates, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        ts = opt.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
        for k in params:
            want = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    assert get_learning_rate(ts) == float(js.hyperparams["learning_rate"])


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError):
        build_optimizer("rmsprop", 0.1)


def test_schedulers_match_jax():
    """The same metric sequences give the same learning rates, step by step."""
    losses = [2.0, 1.9, 1.9, 1.95, 1.9, 1.899999, 1.5, 1.6, 1.7, 1.8, 1.9]
    accs = [0.1, 0.2, 0.2, 0.19, 0.2, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3]
    pairs = [
        (ReduceLROnPlateau(0.1, factor=0.5, patience=2), JReduceLROnPlateau(0.1, factor=0.5, patience=2), losses),
        (PatienceHalving(0.1, patience=2, lr_end=0.02), JPatienceHalving(0.1, patience=2, lr_end=0.02), accs),
    ]
    for ours, theirs, metrics in pairs:
        got = [ours.step(m) for m in metrics]
        assert got == [theirs.step(m) for m in metrics]
        assert len(set(got)) > 1 and ours.monitor == theirs.monitor


def test_topk_accuracy_and_meter_match_jax():
    """Ties rank by class index as ``lax.top_k``; k beyond the class count
    is clamped."""
    logits = np.array([[0.1, 0.9, 0.9, 0.0], [0.8, 0.1, 0.05, 0.05], [0.3, 0.3, 0.3, 0.7]], np.float32)
    labels = np.array([2, 2, 1], np.int32)
    for ks in ((1, 2), (1, 5), (3,)):
        got = topk_accuracy(torch.from_numpy(logits), torch.from_numpy(labels), ks)
        want = j_topk_accuracy(jnp.asarray(logits), jnp.asarray(labels), ks)
        assert [float(g) for g in got] == [float(w) for w in want]
    meter = AverageMeter()
    for v, n in ((1.0, 2), (4.0, 1)):
        meter.update(v, n)
    assert meter.avg == 2.0 and meter.count == 3


def _clstm_data(n_batches, seed=0):
    rng = np.random.RandomState(seed)
    return [
        (rng.rand(4, T, HW, HW, 3).astype(np.float32), rng.randint(0, 3, 4).astype(np.int32))
        for _ in range(n_batches)
    ]


def _port_model(variables=None, **kw):
    model = ConvLSTMClassifier(**{**CLSTM, **kw}, input_size=(HW, HW), clip_len=T)
    if variables is not None:
        model.load_state_dict(variables_to_state_dict(variables))
    else:
        model.reset_parameters(torch.Generator().manual_seed(0))
    return model


@pytest.fixture(scope="module")
def clstm_variables():
    return fill_variables(JClassifier(**CLSTM, dropout_rate=0.0), (1, T, HW, HW, 3), seed=1, logit_scale=0.3)


def test_fit_history_matches_jax(clstm_variables):
    """Three epochs of two batches (SGD with momentum and coupled decay, the
    TF patience halving on val accuracy with a threshold no later epoch
    meets, so the rate halves after the second): every epoch's lr equal,
    the train and val losses within 1e-5 and the accuracies equal."""
    data, val = _clstm_data(2), _clstm_data(1, seed=1)
    jstate = j_create_train_state(
        JClassifier(**CLSTM, dropout_rate=0.0), jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)),
        j_build_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3), clstm_variables,
    )
    jbatches = [(jnp.asarray(x), jnp.asarray(y)) for x, y in data]
    jval = [(jnp.asarray(x), jnp.asarray(y)) for x, y in val]
    _, want = j_fit(jstate, lambda: jbatches, lambda: jval, num_epochs=3,
                    scheduler=JPatienceHalving(0.05, patience=1, threshold=2.0), rng=jax.random.PRNGKey(0))
    state = create_train_state(_port_model(clstm_variables), build_optimizer("sgd", 0.05, momentum=0.9, weight_decay=1e-3))
    tbatches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in data]
    tval = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in val]
    _, got = fit(state, lambda: tbatches, lambda: tval, num_epochs=3,
                 scheduler=PatienceHalving(0.05, patience=1, threshold=2.0))
    assert [h["lr"] for h in got] == [h["lr"] for h in want]
    assert len({h["lr"] for h in got}) == 2
    for g, w in zip(got, want):
        for part in ("train", "val"):
            assert abs(g[part]["loss"] - w[part]["loss"]) < 1e-4 * abs(w[part]["loss"]), (g, w)
            assert (g[part]["top1"], g[part]["top5"]) == (w[part]["top1"], w[part]["top5"])


def _bits(state):
    return {n: t.detach().clone() for n, t in state.model.state_dict().items()}


def test_mid_epoch_resume_gives_the_bits_of_an_uninterrupted_run(tmp_path):
    """Dropout 0.5 (drawn per step from the state's seed and step), Adam:
    a run cut after two of four batches of its first epoch, restored from
    its async mid-epoch checkpoint into a fresh state and fitted on, ends
    with the uninterrupted run's parameters, BN statistics, optimizer
    slots and step, bit for bit."""
    data, val = _clstm_data(4), _clstm_data(1, seed=1)
    batches = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in data]
    vals = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in val]

    def fresh():
        return create_train_state(_port_model(dropout_rate=0.5), build_optimizer("adam", 1e-2), seed=7)

    state_a, _ = fit(fresh(), lambda: batches, lambda: vals, num_epochs=2)
    ckpt = Checkpointer(str(tmp_path / "run"), async_save=True)
    calls = {"n": 0}

    def interrupted():
        calls["n"] += 1
        if calls["n"] > 1:
            return batches

        def gen():
            yield from batches[:2]
            raise KeyboardInterrupt("preempted")

        return gen()

    with pytest.raises(KeyboardInterrupt):
        fit(fresh(), interrupted, lambda: vals, num_epochs=2, checkpointer=ckpt, checkpoint_every_steps=2)
    restored, start_epoch, best, offset = ckpt.restore(fresh())
    assert (start_epoch, offset, restored.step) == (0, 2, 2)
    state_b, history = fit(restored, lambda: batches, lambda: vals, num_epochs=2, checkpointer=ckpt,
                           checkpoint_every_steps=2, start_epoch=start_epoch, best_loss=best,
                           start_batch_offset=offset)
    assert len(history) == 2 and state_a.step == state_b.step == 8
    a, b = _bits(state_a), _bits(state_b)
    assert all(torch.equal(a[n], b[n]) for n in a)
    for slot in ("mu", "nu"):
        assert all(torch.equal(state_a.opt_state.slots[slot][n], state_b.opt_state.slots[slot][n])
                   for n in state_a.opt_state.slots[slot])


def test_checkpoint_round_trip_async_best_and_logits_skip(tmp_path):
    """Save and restore: parameters, statistics, optimizer slots, lr, step
    and seed come back; an epoch-end checkpoint resumes the next epoch; an
    async save lands at the next barrier with its best copy; nothing is
    left under a temporary name; ``skip_logits`` restores across class
    counts and keeps the fresh head and a fresh optimizer."""
    data = _clstm_data(1)
    x, y = torch.from_numpy(data[0][0]), torch.from_numpy(data[0][1])
    state = create_train_state(_port_model(), build_optimizer("momentum", 0.1, momentum=0.9), seed=3)
    from ivf_tpu_torch.train import make_train_step

    state, _ = make_train_step()(state, x, y)
    state.opt_state = set_learning_rate(state.opt_state, 0.05)
    ckpt = Checkpointer(str(tmp_path), async_save=True)
    ckpt.save(state, epoch=4, is_best=True, best_loss=0.5)
    assert ckpt.exists("model_best") and ckpt.exists()
    fresh = create_train_state(_port_model(), build_optimizer("momentum", 0.1, momentum=0.9), seed=0)
    fresh.model.reset_parameters(torch.Generator().manual_seed(9))
    got, epoch, best, offset = ckpt.restore(fresh, "model_best")
    assert (epoch, best, offset, got.step, got.seed) == (5, 0.5, 0, 1, 3)
    assert get_learning_rate(got.opt_state) == np.float32(0.05)
    a, b = _bits(state), _bits(got)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(state.opt_state.slots["trace"][n], got.opt_state.slots["trace"][n])
               for n in a if n in got.opt_state.slots["trace"])
    assert sorted(os.listdir(tmp_path)) == ["checkpoint", "model_best"]
    assert set(ckpt.load_variables()) == set(a)

    other = create_train_state(_port_model(num_classes=5), build_optimizer("adam", 1e-3))
    head = other.model.end_fc.weight.detach().clone()
    with pytest.raises(Exception):
        ckpt.restore(other)
    other, epoch, _, offset = ckpt.restore(other, skip_logits=True)
    assert (epoch, offset, other.step) == (5, 0, 0)
    assert torch.equal(other.model.end_fc.weight, head)
    assert torch.equal(other.model.clstm.cells[0].wx, state.model.clstm.cells[0].wx)
    assert all(float(t.abs().sum()) == 0 for t in other.opt_state.slots["mu"].values())


def _tiny_cfg(tmp_path, name="run", **model):
    cfg = TConfig()
    cfg.output_dir, cfg.model_name = str(tmp_path), name
    cfg.model.conv_model = "clstm"
    for key, value in {**CLSTM, **model}.items():
        key = {"nb_lstm_units": "clstm_hidden", "lstm_layers": "clstm_layers"}.get(key, key)
        setattr(cfg.model, key, value)
    cfg.data.batch_size, cfg.data.clip_size, cfg.data.input_spatial_size = 4, T, HW
    cfg.data.num_workers = 2
    return cfg


class _Pairs:
    """(clip, label) items, as the JAX package's ``evaluate`` unpacks them."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return self.ds[i][:2]


def test_infer_files_and_top_k_match_jax(tmp_path):
    """A KTH run (k = 3) of a 6-class model over 8 synthetic clips:
    ``y_true``, ``y_hat`` and the top-3 matrix equal to JAX's ``infer`` on
    the same weights, as ``.npy`` files of the same names, the loss within
    1e-5; ``ModelConfig.top_k`` overrides k, and a run of another family
    takes 5."""
    kw = dict(CLSTM, num_classes=6)
    variables = fill_variables(JClassifier(**kw, dropout_rate=0.0), (1, T, HW, HW, 3), seed=1, logit_scale=0.3)
    cfg_j = JConfig()
    cfg_t = _tiny_cfg(tmp_path / "port", name="clstm_kth_run", num_classes=6)
    for section in ("model", "data"):
        for key, value in vars(getattr(cfg_t, section)).items():
            if hasattr(getattr(cfg_j, section), key):
                setattr(getattr(cfg_j, section), key, value)
    cfg_j.output_dir, cfg_j.model_name = str(tmp_path / "jax"), "clstm_kth_run"
    data = _Pairs(SyntheticClips(8, t=T, hw=HW, num_classes=6, seed=2, lazy=False))
    jstate = j_create_train_state(
        JClassifier(**kw, dropout_rate=0.0), jax.random.PRNGKey(0), jnp.zeros((1, T, HW, HW, 3)),
        j_build_optimizer("adam", 1e-3), variables,
    )
    want = japi.infer(cfg_j, jstate, dataset=data)
    _, state = tapi.init_eval_state(cfg_t, device="cpu")
    state.model.load_state_dict(variables_to_state_dict(variables))
    got = tapi.infer(cfg_t, state, dataset=data)
    for name in ("y_true", "y_hat", "y_hat_top5"):
        np.testing.assert_array_equal(got[name], want[name])
        f_t = np.load(tmp_path / "port" / "clstm_kth_run" / f"{name}.npy")
        f_j = np.load(tmp_path / "jax" / "clstm_kth_run" / f"{name}.npy")
        np.testing.assert_array_equal(f_t, f_j)
    assert f_t.shape == (8, 3)
    assert abs(got["loss"] - want["loss"]) < 1e-5
    cfg_t.model.top_k = 2
    tapi.infer(cfg_t, state, dataset=data)
    assert np.load(tmp_path / "port" / "clstm_kth_run" / "y_hat_top5.npy").shape == (8, 2)
    cfg_t.model.top_k, cfg_t.model_name = None, "clstm_smth_run"
    cfg_t.model.conv_model = "clstm"
    tapi.infer(cfg_t, state, dataset=data)
    assert np.load(tmp_path / "port" / "clstm_smth_run" / "y_hat_top5.npy").shape == (8, 5)


def test_bf16_eval_step_runs_the_search_model(tmp_path):
    """In bfloat16 the eval step runs the model ``build_model`` makes for
    the search (both through ``precision.inference_model``): the logits of
    a float32 master's eval step equal, bit for bit, those of
    ``build_model`` on the same seeded weights; the master stays float32;
    the copy is made once per state step, and a train step makes the next
    one."""
    from ivf_tpu_torch.train import make_eval_step, make_train_step

    cfg = _tiny_cfg(tmp_path, compute_dtype="bfloat16")
    state = tapi._train_state(cfg, "cpu")
    clips = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (4, T, HW, HW, 3)).astype(np.uint8))
    labels = torch.tensor([0, 1, 2, 1])
    eval_step = make_eval_step(compute_dtype="bfloat16")
    got = eval_step(state, clips, labels)["logits"]
    with torch.no_grad():
        want = tapi.build_model(cfg, device="cpu")(clips.float()).float()
    assert torch.equal(got, want)
    assert all(t.dtype == torch.float32 for t in state.model.state_dict().values())
    assert torch.equal(eval_step(state, clips, labels)["logits"], got)
    state, _ = make_train_step(compute_dtype="bfloat16")(state, clips, labels)
    assert not torch.equal(eval_step(state, clips, labels)["logits"], got)


def test_train_driver_runs_resumes_and_writes_its_files(tmp_path):
    """``api.train`` on the CPU: two epochs of a torch-family ConvLSTM with
    dropout on 12 synthetic clips (batches of 4, shuffled by the loader's
    (seed, epoch)), checkpoints every 2 batches: ``history.json``, the
    checkpoint and its best copy, the three plots. A run cut in its second
    epoch by a failing clip and resumed (``resume=True``) ends with the
    uninterrupted run's bits; ``eval_only`` returns predictions."""
    class Flaky(SyntheticClips):
        """Fails on ``fail_at`` when it is read the second time (epoch 1)."""

        fail, seen = False, set()

        def __getitem__(self, i):
            if Flaky.fail and i == self.fail_at and i in Flaky.seen:
                raise OSError("disk went away")
            Flaky.seen.add(i)
            return super().__getitem__(i)

    def cfg_for(name):
        cfg = _tiny_cfg(tmp_path, name=name, dropout=0.5)
        cfg.optim.num_epochs, cfg.optim.checkpoint_steps, cfg.optim.print_freq = 2, 2, 0
        cfg.async_checkpoint = True
        return cfg

    train = Flaky(12, t=T, hw=HW, num_classes=3, seed=4, lazy=False)
    val = SyntheticClips(4, t=T, hw=HW, num_classes=3, seed=5, lazy=False)
    state_a, history = tapi.train(cfg_for("a"), train_dataset=train, val_dataset=val, device="cpu")
    run_a = tmp_path / "a"
    assert len(history) == 2 and json.loads((run_a / "history.json").read_text())[1]["epoch"] == 1
    assert {"checkpoint", "model_best"} <= set(os.listdir(run_a))
    for plot in ("loss_plot.png", "accu_plot.png", "lr_plot.png"):
        assert Image.open(run_a / "plots" / plot).size == (600, 400)

    order = np.arange(12)
    np.random.RandomState(cfg_for("b").seed + 1).shuffle(order)  # epoch 1's order
    train.fail_at = int(order[8])  # the third batch of epoch 1
    Flaky.fail, Flaky.seen = True, set()
    with pytest.raises(OSError):
        tapi.train(cfg_for("b"), train_dataset=train, val_dataset=val, device="cpu")
    Flaky.fail = False
    state_b, history_b = tapi.train(cfg_for("b"), resume=True, train_dataset=train, val_dataset=val, device="cpu")
    assert [h["epoch"] for h in history_b] == [1] and state_b.step == state_a.step == 6
    a, b = _bits(state_a), _bits(state_b)
    assert all(torch.equal(a[n], b[n]) for n in a)

    _, res = tapi.train(cfg_for("b"), eval_only=True, resume=True, train_dataset=train, val_dataset=val,
                        device="cpu")
    assert res["y_hat_top5"].shape == (4, 3)  # top 5 of 3 classes


def test_entry_points_raise_on_what_is_not_ported(monkeypatch, tmp_path):
    """No card and no device: ``train``, ``init_eval_state`` and ``infer``
    raise rather than run on the CPU. ``mesh`` and a pretrained checkpoint
    raise ``NotImplementedError`` naming their Queue 1 item."""
    cfg = _tiny_cfg(tmp_path)
    data = SyntheticClips(4, t=T, hw=HW, num_classes=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tapi.train(cfg, train_dataset=data, val_dataset=data),
                 lambda: tapi.init_eval_state(cfg), lambda: tapi.infer(cfg, dataset=data)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    with pytest.raises(NotImplementedError, match="item 13"):
        tapi.train(cfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        tapi.infer(cfg, mesh=object(), device="cpu")
    cfg.model.pretrained_model_path = str(tmp_path / "model.pth.tar")
    with pytest.raises(NotImplementedError, match="item 11"):
        tapi.init_eval_state(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="item 11"):
        tapi.train(cfg, train_dataset=data, val_dataset=data, device="cpu")


def test_plot_learning_writes_the_three_curves(tmp_path):
    """The reference's three file names, 600x400, with matplotlib's C0 / C1
    line colours drawn."""
    plotter = PlotLearning(str(tmp_path), num_classes=6)
    for epoch in range(3):
        plotter.plot({"loss": 1.5 - 0.2 * epoch, "val_loss": 1.6 - 0.1 * epoch, "acc": 0.2 + 0.1 * epoch,
                      "val_acc": 0.25, "learning_rate": 0.01 / (epoch + 1)})
    for name in ("loss_plot.png", "accu_plot.png", "lr_plot.png"):
        img = np.asarray(Image.open(tmp_path / name).convert("RGB"))
        assert img.shape == (400, 600, 3)
        colours = {tuple(p) for p in img.reshape(-1, 3)}
        assert (31, 119, 180) in colours
        if name != "lr_plot.png":
            assert (255, 127, 14) in colours


def test_results_files_match_jax(tmp_path):
    """``save_results``, ``get_submission`` and ``save_images_for_debug``
    write what the JAX package's copies write, byte for byte."""
    logits = np.random.RandomState(0).randn(3, 7).astype(np.float32)
    ids, class_to_idx = ["a", "b", "c"], {"x": 0}
    for mod, sub in ((t_results, "t"), (j_results, "j")):
        mod.save_results(logits, logits[:, :2], [1, 2, 3], ids, class_to_idx, str(tmp_path / sub), "m")
        mod.get_submission(logits, ids, str(tmp_path / sub), "m")
    assert (tmp_path / "t/m/test_submission.csv").read_text() == (tmp_path / "j/m/test_submission.csv").read_text()
    with open(tmp_path / "t/m/test_results.pkl", "rb") as f_t, open(tmp_path / "j/m/test_results.pkl", "rb") as f_j:
        got, want = pickle.load(f_t), pickle.load(f_j)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2:] == want[2:]
    clips = np.random.RandomState(1).rand(2, 3, 8, 8, 3).astype(np.float32)
    t_results.save_images_for_debug(str(tmp_path / "t_img"), clips)
    j_results.save_images_for_debug(str(tmp_path / "j_img"), clips)
    files = sorted(p.relative_to(tmp_path / "t_img") for p in (tmp_path / "t_img").rglob("*.png"))
    assert len(files) == 6
    assert all((tmp_path / "t_img" / f).read_bytes() == (tmp_path / "j_img" / f).read_bytes() for f in files)
