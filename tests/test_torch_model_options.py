"""The I3D options ``fuse_3x3`` and ``remat`` against the JAX package's, on
the CPU.

``fuse_3x3``: each block's two 3x3x3 convs as one block-diagonal conv
(``layers.InceptionModule``), True everywhere or ``'auto'`` where the block
input's H is at most 14: the whole I3D with True against JAX's
``I3D(fuse_3x3=True)`` at the I3D tolerances of ``tests/test_torch_model.py``
(logits rtol 1e-3 / atol 1e-4; input gradients divided by the reference's
largest magnitude, rtol 1e-3 / atol 1e-4), ``'auto'`` on one block on each
side of its rule against JAX's block; each against the port without it
(the zero blocks add exact zeros; only the conv's summation order
changes: rtol 1e-4 / atol 1e-6 of the largest value).

``remat``: each block under ``torch.utils.checkpoint`` (``layers.
checkpointed``). The recompute repeats the forward's ops on the same
inputs, so the port with remat gives the bits of the port without it, in
eval mode and in a training step, where BatchNorm's running statistics
must move once (flax's ``nn.remat`` commits them once); against JAX's
``remat=True`` at the tolerances of ``tests/test_torch_train.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from ivf_tpu.models import i3d_smth as j_i3d_smth
from ivf_tpu.models.layers import InceptionModule as JInception
from ivf_tpu_torch.models import i3d_smth
from ivf_tpu_torch.models import layers
from ivf_tpu_torch.models.layers import TorchBatchNorm, set_batch_stats_group
from ivf_tpu_torch.utils.convert import i3d_variables_to_state_dict, variables_to_state_dict
from tests.test_torch_model import make_jax_variables
from tests.test_torch_train import (
    I3D_KW,
    I3D_SHAPE,
    check_float32_step,
    fill_variables,
    jax_sgd1_step,
    port_sgd1_step,
    statistics,
)

SMALL = dict(num_classes=5, pool_shape=(1, 1, 1), dropout_rate=0.0)
SHAPE = (1, 8, 32, 32, 3)  # every block's H is at most 4 here: 'auto' fuses all
# Mixed_3b's widths on each side of 'auto''s rule (H at most 14)
BLOCK_OC = (64, 96, 128, 16, 32, 32)
BLOCK_CASES = {"auto_h14": ("auto", 14, True), "auto_h16": ("auto", 16, False), "true_h16": (True, 16, True)}
BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f", "Mixed_5b", "Mixed_5c")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: where test workers share the cores, threads
    that wait on each other make the port's runs many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_logits_and_grad(flags, variables, x, r):
    model = j_i3d_smth(**SMALL, **flags)

    def score(a):
        logits = model.apply(variables, a)
        return (logits[0] * r).sum(), logits

    (_, logits), grad = jax.jit(jax.value_and_grad(score, has_aux=True))(jnp.asarray(x))
    return np.asarray(logits), np.asarray(grad)


@pytest.fixture(scope="module")
def ref():
    """Weights; JAX logits and input gradients with ``fuse_3x3=True`` and
    with ``remat=True``, in eval mode."""
    variables = make_jax_variables(j_i3d_smth(**SMALL), SHAPE)
    x = np.random.RandomState(1).uniform(0, 255, SHAPE).astype(np.float32)
    r = np.random.RandomState(2).randn(5).astype(np.float32)
    out = {"variables": variables, "x": x, "r": r, "sd": i3d_variables_to_state_dict(variables)}
    for name, flags in (("fuse_3x3", dict(fuse_3x3=True)), ("remat", dict(remat=True))):
        out[name] = _jax_logits_and_grad(flags, variables, x, r)
    return out


def _port(sd, **kw):
    model = i3d_smth(**SMALL, **kw)
    model.load_state_dict(sd)
    return model.eval()


def _port_logits_and_grad(model, x, r):
    xt = torch.from_numpy(x).requires_grad_(True)
    logits = model(xt)
    (grad,) = torch.autograd.grad(logits, xt, torch.from_numpy(r)[None])
    return logits.detach().numpy(), grad.numpy()


def _recording_fused(monkeypatch) -> list:
    fused = []
    fused_3x3 = layers.InceptionModule._fused_3x3

    def recorded(block, b1, b2):
        fused.append(block)
        return fused_3x3(block, b1, b2)

    monkeypatch.setattr(layers.InceptionModule, "_fused_3x3", recorded)
    return fused


def test_fuse_3x3_matches_jax(ref, monkeypatch):
    """I3D with ``fuse_3x3=True``: every block fuses."""
    fused = _recording_fused(monkeypatch)
    model = _port(ref["sd"], fuse_3x3=True)
    logits, grad = _port_logits_and_grad(model, ref["x"], ref["r"])
    assert [name for name in BLOCKS if getattr(model, name) in fused] == list(BLOCKS)
    want_logits, want_grad = ref["fuse_3x3"]
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=1e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(grad / scale, want_grad / scale, rtol=1e-3, atol=1e-4)
    off_logits, off_grad = _port_logits_and_grad(_port(ref["sd"]), ref["x"], ref["r"])
    np.testing.assert_allclose(logits, off_logits, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(grad / scale, off_grad / scale, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fuse_3x3_block_matches_jax(case, monkeypatch):
    """One eval-mode block (Mixed_3b's widths, input (1, 2, H, H, 192)):
    ``'auto'`` fuses at H 14 and not at 16, True at 16; output and input
    gradient against JAX's block within rtol 1e-4 / atol 1e-5 of the
    largest value (one block's float32 sums in two libraries' orders)."""
    fuse, h, fuses = BLOCK_CASES[case]
    shape = (1, 2, h, h, 192)
    jmod = JInception(BLOCK_OC, fuse_3x3=fuse)
    variables = fill_variables(jmod, shape, seed=5)
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    r = rng.randn(*shape[:-1], 256).astype(np.float32)
    jy, vjp = jax.vjp(lambda b: jmod.apply(variables, b), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(r))
    fused = _recording_fused(monkeypatch)
    outs = {}
    for flag in (fuse, False):
        block = layers.InceptionModule(192, BLOCK_OC, fuse_3x3=flag)
        block.load_state_dict(variables_to_state_dict(variables))
        xt = torch.from_numpy(x).requires_grad_(True)
        y = block(xt)
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(r))
        outs[flag] = (y.detach().numpy(), dx.numpy())
    assert len(fused) == int(fuses)
    for got, want in zip(outs[fuse], (np.asarray(jy), np.asarray(jdx))):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4, atol=1e-5)
    for got, off in zip(outs[fuse], outs[False]):
        scale = np.abs(off).max()
        np.testing.assert_allclose(got / scale, off / scale, rtol=1e-4, atol=1e-6)


def test_fuse_3x3_runs_in_eval_mode_only(ref, monkeypatch):
    """Training keeps the two convs apart (BN unfolded), as JAX does."""
    monkeypatch.setattr(layers.InceptionModule, "_fused_3x3", lambda *a: pytest.fail("fused in training"))
    model = _port(ref["sd"], fuse_3x3=True).train()
    model(torch.from_numpy(np.repeat(ref["x"], 2, axis=0)))


def test_remat_eval_matches_jax_and_the_port_without_it(ref):
    """Equal bits to the port without remat; JAX ``remat=True`` within the
    I3D tolerances. Each block runs twice (forward, then the recompute in
    the backward) under grad, and once under ``no_grad``."""
    d = ref
    model = _port(d["sd"], remat=True)
    runs = []
    model.Mixed_4c.register_forward_pre_hook(lambda *_: runs.append(1))
    logits, grad = _port_logits_and_grad(model, d["x"], d["r"])
    assert len(runs) == 2
    with torch.no_grad():
        model(torch.from_numpy(d["x"]))
    assert len(runs) == 3
    off_logits, off_grad = _port_logits_and_grad(_port(d["sd"]), d["x"], d["r"])
    np.testing.assert_array_equal(logits, off_logits)
    np.testing.assert_array_equal(grad, off_grad)
    want_logits, want_grad = ref["remat"]
    np.testing.assert_allclose(logits, want_logits, rtol=1e-3, atol=1e-4)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(grad / scale, want_grad / scale, rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def train_ref():
    """One JAX SGD(lr 1) train step of I3D with ``remat=True``."""
    variables = fill_variables(j_i3d_smth(**I3D_KW, dropout_rate=0.0), I3D_SHAPE, logit_scale=0.05)
    x = np.random.RandomState(1).randn(*I3D_SHAPE).astype(np.float32)
    y = np.array([1, 3, 0, 4], np.int32)
    step = jax_sgd1_step(j_i3d_smth(**I3D_KW, dropout_rate=0.0, remat=True), variables, x, y)
    return {"variables": variables, "x": x, "y": y, "step": step}


def _port_step(train_ref, **kw):
    model = i3d_smth(**I3D_KW, dropout_rate=0.0, **kw)
    return model, port_sgd1_step(model, train_ref["variables"], train_ref["x"], train_ref["y"])


def test_remat_train_step_moves_the_statistics_once(train_ref, monkeypatch):
    """A remat train step: loss, every gradient and the BN running
    statistics with the bits of the step without remat, each BN's
    ``num_batches_tracked`` 1; against JAX's remat step within the float32
    step tolerances of ``tests/test_torch_train.py`` (gradients 2%, loss
    5e-5, statistics 1e-4). Control: a plain ``torch.utils.checkpoint``
    re-runs training BN in the recompute, and its statistics move twice."""
    model, (loss, got) = _port_step(train_ref, remat=True)
    _, (off_loss, off) = _port_step(train_ref)
    assert loss == off_loss
    for name in got:
        np.testing.assert_array_equal(got[name], off[name], err_msg=name)
    assert {int(m.num_batches_tracked) for m in model.modules() if isinstance(m, TorchBatchNorm)} == {1}
    want_loss, want = train_ref["step"]
    check_float32_step(model, got, want, loss, want_loss, 0.02, 5e-5, 1e-4)

    monkeypatch.setattr("ivf_tpu_torch.models.i3d.checkpointed", lambda block, x: torch.utils.checkpoint.checkpoint(
        block, x, use_reentrant=False))
    naive, (_, twice) = _port_step(train_ref, remat=True)
    assert int(naive.Mixed_4c.b0.bn.num_batches_tracked) == 2
    assert max(np.abs(twice[n] - off[n]).max() for n in statistics(naive)) > 1e-4


def test_remat_synchronised_statistics_sum_once(train_ref, tmp_path):
    """Under a data mesh (here a world of one gloo rank) the synchronised
    BN's sums run once per forward: the recompute replays them. The remat
    step issues as many all-reduces as the step without it, with equal
    bits."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1, rank=0)
    counts = []
    all_reduce = dist.all_reduce

    def counted(*args, **kw):
        counts[-1] += 1
        return all_reduce(*args, **kw)

    try:
        dist.all_reduce = counted
        grads = []
        for remat in (False, True):
            model = i3d_smth(**I3D_KW, dropout_rate=0.0, remat=remat)
            model.load_state_dict(i3d_variables_to_state_dict(train_ref["variables"]))
            set_batch_stats_group(model.train(), dist.group.WORLD)
            counts.append(0)
            x = torch.from_numpy(train_ref["x"]).requires_grad_(True)
            (g,) = torch.autograd.grad(model(x).square().sum(), x)
            grads.append((g, [b.clone() for b in model.buffers()]))
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    assert counts[0] == counts[1] == 57 * 4  # 57 BNs: 2 sums forward, 2 backward
    torch.testing.assert_close(grads[1][0], grads[0][0], rtol=0, atol=0)
    for a, b in zip(grads[1][1], grads[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_registry_passes_the_options_through():
    """``get_model`` hands the options to I3D: the guided ReLU reaches the
    stem, ``Conv3d_2b_1x1``, ``Conv3d_2c_3x3`` and every unit of the nine
    blocks, not the logits head (``last_relu``'s activation)."""
    from ivf_tpu_torch.interpret import guided_relu
    from ivf_tpu_torch.models.registry import get_model

    model = get_model("i3d", guided_relu=True, remat=True, fuse_3x3="auto", last_relu="relu")
    assert model.remat and all(getattr(model, name).fuse_3x3 == "auto" for name in BLOCKS)
    units = [m for m in model.modules() if isinstance(m, layers.Unit3D) and m is not model.logits]
    assert len(units) == 3 + 9 * 6 and all(m.activation is guided_relu for m in units)
    assert model.logits.activation is torch.nn.functional.relu
    assert not any(getattr(model, name).fusing for name in BLOCKS)
