"""ivf_tpu_torch's ConvLSTM slice vs the JAX package, on the CPU.

The same numpy-drawn inputs and weights (carried across by
``utils.convert.convlstm_variables_to_state_dict``, BN statistics and
affine parameters random so BN is exercised) go through the JAX function
and its port: the gate block (against the Pallas kernel in interpret mode
too), the 2D conv/pool ops, the cell step, the classifier in both
families and both heads, the Grad-CAM and ``find_masks`` end to end. On
CPU tensors the fused-gates wrapper runs its plain versions; the CUDA
kernel is held against them by tests/test_torch_gpu.py and
``chip_smoke.py``. The JAX models run at T <= 8 to keep this file fast.
"""

import functools
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ivf_tpu.api as japi
import ivf_tpu_torch.api as tapi
from ivf_tpu.config import Config as JConfig
from ivf_tpu.data.synthetic import SyntheticClips as JSyntheticClips
from ivf_tpu.interpret.gradcam import convlstm_grad_cam as j_convlstm_grad_cam
from ivf_tpu.models.convlstm import ConvLSTMClassifier as JClassifier
from ivf_tpu.ops import conv as jconv
from ivf_tpu.ops import convlstm_cell as jcell
from ivf_tpu.ops.pallas.fused_gates import pallas_gate_math
from ivf_tpu_torch.config import Config as TConfig
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.interpret.gradcam import convlstm_grad_cam
from ivf_tpu_torch.models import ConvLSTMClassifier as TClassifier
from ivf_tpu_torch.models import get_model
from ivf_tpu_torch.ops import conv as tconv
from ivf_tpu_torch.ops import convlstm_cell as tcell
from ivf_tpu_torch.ops.kernels import fused_gates as tgates
from ivf_tpu_torch.utils.convert import convlstm_variables_to_state_dict


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gate_inputs(shape=(2, 8, 8), ch=4, seed=0):
    rng = np.random.RandomState(seed)
    gx = rng.randn(*shape, 4 * ch).astype(np.float32)
    gh = rng.randn(*shape, 4 * ch).astype(np.float32)
    c = rng.randn(*shape, ch).astype(np.float32)
    cot_h = rng.randn(*shape, ch).astype(np.float32)
    cot_c = rng.randn(*shape, ch).astype(np.float32)
    return gx, gh, c, cot_h, cot_c


# -- the gate block ----------------------------------------------------------


@pytest.mark.parametrize("with_gh", [True, False], ids=["split", "merged"])
def test_gate_math_and_vjp_match_pallas_and_jnp(with_gh):
    """The port's gate block (plain versions on the CPU) against the Pallas
    kernel in interpret mode and the jnp ``fused_gate_math``: (h', c') and
    the VJP (dgx, dgh, dc) for random cotangents. Tolerance rtol 1e-5 /
    atol 1e-6: float32 transcendentals of two libraries."""
    gx, gh, c, cot_h, cot_c = _gate_inputs()

    def run_jax(fn):
        def f(gx_, gh_, c_):
            return fn(gx_, gh_ if with_gh else None, c_)

        out, vjp = jax.vjp(f, jnp.asarray(gx), jnp.asarray(gh), jnp.asarray(c))
        return out, vjp((jnp.asarray(cot_h), jnp.asarray(cot_c)))

    refs = [
        run_jax(lambda a, b, c_: pallas_gate_math(a, b, c_, interpret=True)),
        run_jax(jcell.fused_gate_math),
    ]
    gx_t, c_t = _t(gx).requires_grad_(True), _t(c).requires_grad_(True)
    gh_t = _t(gh).requires_grad_(True) if with_gh else None
    h_new, c_new = tgates.gate_math(gx_t, gh_t, c_t)
    inputs = [gx_t, c_t] + ([gh_t] if with_gh else [])
    grads = torch.autograd.grad((h_new, c_new), inputs, (_t(cot_h), _t(cot_c)))
    dgx, dc = grads[0], grads[1]
    for (jh, jc), (jdgx, jdgh, jdc) in refs:
        np.testing.assert_allclose(_np(h_new), np.asarray(jh), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(c_new), np.asarray(jc), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(dgx), np.asarray(jdgx), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(_np(dc), np.asarray(jdc), rtol=1e-5, atol=1e-6)
        if with_gh:
            np.testing.assert_allclose(_np(grads[2]), np.asarray(jdgh), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("with_gh", [True, False], ids=["split", "merged"])
def test_gate_math_bwd_plain_equals_autograd_of_the_forward(with_gh):
    """The hand-written backward formulas against torch autograd through
    ``gate_math_plain``, at 1e-6."""
    gx, gh, c, cot_h, cot_c = _gate_inputs(shape=(3, 7, 9), ch=5, seed=1)
    gx_t, c_t = _t(gx).requires_grad_(True), _t(c).requires_grad_(True)
    gh_t = _t(gh) if with_gh else None
    h_new, c_new = tgates.gate_math_plain(gx_t, gh_t, c_t)
    want_dz, want_dc = torch.autograd.grad((h_new, c_new), (gx_t, c_t), (_t(cot_h), _t(cot_c)))
    dz, dc = tgates.gate_math_bwd_plain(_t(gx), gh_t, _t(c), _t(cot_h), _t(cot_c))
    assert dz.shape == gx.shape and dc.shape == c.shape
    np.testing.assert_allclose(dz.numpy(), want_dz.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dc.numpy(), want_dc.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_fused_gate_math_matches_jax(act):
    """Both recurrent activations of the plain gate block, at 1e-6; the
    Keras hard sigmoid has slope 0.2, not ``F.hardsigmoid``'s 1/6."""
    gx, gh, c, _, _ = _gate_inputs(seed=2)
    gx = gx * 4  # reach both clip ends of the hard sigmoid
    jh, jc = jcell.fused_gate_math(jnp.asarray(gx), jnp.asarray(gh), jnp.asarray(c), act)
    th, tc = tcell.fused_gate_math(_t(gx), _t(gh), _t(c), act)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    x = torch.linspace(-4, 4, 17)
    np.testing.assert_allclose(
        tcell.keras_hard_sigmoid(x).numpy(), np.asarray(jcell.keras_hard_sigmoid(jnp.asarray(x.numpy()))),
        atol=1e-7,
    )


def test_gate_wrapper_takes_no_other_route_than_kernel_or_plain():
    """A tensor on neither the CPU nor a CUDA device is refused: the plain
    versions serve CPU tensors only."""
    c = torch.zeros(2, 4, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        tgates.gate_math(torch.zeros(2, 16, device="meta"), None, c)


# -- 2D ops ------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,kernel,stride,padding",
    [
        ((2, 11, 13, 3), (5, 5), 1, None),
        ((2, 11, 13, 3), (5, 5), 2, None),  # torch padding at stride 2 != TF SAME
        ((1, 12, 15, 4), (3, 5), 1, None),
        ((1, 12, 15, 4), (3, 5), 2, (0, 0)),  # Keras 'valid'
        ((2, 9, 10, 4), (5, 5), 1, (0, 0)),
    ],
)
def test_conv2d_same_torch_matches_jax(shape, kernel, stride, padding):
    rng = np.random.RandomState(3)
    x = rng.randn(*shape).astype(np.float32)
    k = (rng.randn(*kernel, shape[-1], 8) * 0.2).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    ref = jconv.conv2d_same_torch(jnp.asarray(x), jnp.asarray(k), stride, jnp.asarray(b), padding)
    out = tconv.conv2d_same_torch(_t(x), _t(k.transpose(3, 2, 0, 1)), stride, _t(b), padding)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,window", [((2, 7, 9, 3), (2, 2)), ((1, 11, 10, 4), (3, 2))])
def test_2d_pools_match_jax(shape, window):
    x = np.random.RandomState(4).randn(*shape).astype(np.float32)
    for jfn, tfn in (
        (jconv.max_pool2d_valid, tconv.max_pool2d_valid),
        (jconv.avg_pool2d_valid, tconv.avg_pool2d_valid),
    ):
        ref = jfn(jnp.asarray(x), window)
        out = tfn(_t(x), window)
        assert out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# -- the cell step -----------------------------------------------------------


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_route"])
@pytest.mark.parametrize(
    "stride,padding,act",
    [(1, "torch", "sigmoid"), (2, "torch", "sigmoid"), (1, "valid", "hard_sigmoid")],
    ids=["merged", "split_stride2", "split_valid"],
)
def test_convlstm_cell_step_matches_jax(stride, padding, act, use_pallas):
    """Merged [x; h] and split routes against the JAX step (its default
    path), with the port's kernel route on and off; rtol 1e-5."""
    rng = np.random.RandomState(5)
    cin, ch, k = 3, 4, (3, 5)
    x = rng.randn(2, 12, 14, cin).astype(np.float32)
    pad = (0, 0) if padding == "valid" else (1, 2)
    hh = (12 + 2 * pad[0] - k[0]) // stride + 1
    ww = (14 + 2 * pad[1] - k[1]) // stride + 1
    h = rng.randn(2, hh, ww, ch).astype(np.float32) * 0.5
    c = rng.randn(2, hh, ww, ch).astype(np.float32)
    wx = (rng.randn(*k, cin, 4 * ch) * 0.3).astype(np.float32)
    wh = (rng.randn(*k, ch, 4 * ch) * 0.3).astype(np.float32)
    bx = rng.randn(4 * ch).astype(np.float32) * 0.1
    jh, jc = jcell.convlstm_cell_step(
        *(jnp.asarray(a) for a in (x, h, c, wx, bx, wh)), stride, False, act, padding
    )
    th, tc = tcell.convlstm_cell_step(
        _t(x), _t(h), _t(c), _t(wx.transpose(3, 2, 0, 1)), _t(bx), _t(wh.transpose(3, 2, 0, 1)),
        stride, use_pallas, act, padding,
    )
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


# -- the classifier ----------------------------------------------------------

T, HW = 8, (32, 48)
# the clstm_kth geometry (2 layers x 4 hidden, kernel 5, stride 2, shared
# BN, torch order, max pool) cut to 8 frames of 32x48; step 9 is out of range
TORCH_FAMILY = dict(
    num_classes=6, nb_lstm_units=4, lstm_layers=2, conv_kernel_size=5, conv_stride=2,
    effective_steps=(9, 3, 7, 3), shared_bn=True,
)
TF_FAMILY = dict(
    num_classes=5, hidden_channels_override=(4, 6), conv_kernel_size=(3, 5), conv_stride=1,
    effective_steps=(2, 5, 7), shared_bn=False, block_order="tf", pooling="avg",
    recurrent_activation="hard_sigmoid", unit_forget_bias=True, x_padding="valid",
)
CASES = {
    "torch_family": TORCH_FAMILY,
    "tf_family": TF_FAMILY,
    "gap_head": dict(TORCH_FAMILY, conv_stride=1, head="gap", add_softmax=True),
    "entire_seq": dict(TORCH_FAMILY, use_entire_seq=True, add_softmax=True),
}


def jax_clstm_variables(model, shape, seed=0, input_scale=1.0):
    """Numpy-drawn variables for a JAX ConvLSTMClassifier: unit-fan-in cell
    kernels (the first layer's divided by ``input_scale``), random biases,
    BN affine parameters and statistics."""
    rng = np.random.RandomState(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros(shape))

    def fill(path, leaf):
        names = [getattr(p, "key", None) for p in path]
        name = names[-1]
        if name in ("wx", "wh", "kernel"):
            fan_in = int(np.prod(leaf.shape[:-1]))
            k = rng.randn(*leaf.shape) / np.sqrt(fan_in)
            if name == "wx" and "cells_0" in names:
                k = k / input_scale
            return k.astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return (0.1 * rng.randn(*leaf.shape)).astype(np.float32)  # biases, mean

    return jax.tree_util.tree_map_with_path(fill, tree)


def _pair_models(kw, use_pallas=False):
    jmodel = JClassifier(dropout_rate=0.0, **kw)
    variables = jax_clstm_variables(jmodel, (1, T, *HW, 3))
    tmodel = TClassifier(**kw, use_pallas=use_pallas, input_size=HW, clip_len=T)
    tmodel.load_state_dict(convlstm_variables_to_state_dict(variables))
    return jmodel, variables, tmodel.eval()


@functools.lru_cache(maxsize=None)
def _jax_logits_and_input_grad(case):
    """JAX logits and the input gradient of ``sum(logits * r)`` (one jitted
    program per case, shared by the port's two routes)."""
    jmodel, variables, _ = _pair_models(CASES[case])
    rng = np.random.RandomState(6)
    clip = rng.rand(2, T, *HW, 3).astype(np.float32)
    r = rng.randn(2, jmodel.num_classes).astype(np.float32)

    def loss(x):
        logits = jmodel.apply(variables, x)
        return jnp.sum(logits * r), logits

    (_, logits), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(clip))
    return clip, r, np.asarray(logits), np.asarray(grad)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_route"])
@pytest.mark.parametrize("case", list(CASES))
def test_classifier_logits_and_input_grad_match_jax(case, use_pallas):
    """Logits rtol 1e-4 / atol 1e-5 and the input gradient (of random
    weights on the logits) atol 1e-4 after dividing both by the reference's
    largest magnitude: 8 recurrent steps of float32 convs."""
    _, _, tmodel = _pair_models(CASES[case], use_pallas)
    clip, r, jlogits, jgrad = _jax_logits_and_input_grad(case)
    x = _t(clip).requires_grad_(True)
    logits = tmodel(x)
    (grad,) = torch.autograd.grad(logits, x, _t(r))
    assert logits.shape == jlogits.shape
    np.testing.assert_allclose(_np(logits), jlogits, rtol=1e-4, atol=1e-5)
    scale = np.abs(jgrad).max()
    assert scale > 0
    np.testing.assert_allclose(grad.numpy() / scale, jgrad / scale, rtol=0, atol=1e-4)


def test_features_and_feature_offset_match_jax():
    """``features`` and a nonzero ``feature_offset`` at 1e-5; the offset is
    added after the recurrence reads ``h``, so it changes the scores but
    not the features the next steps see."""
    jmodel, variables, tmodel = _pair_models(TORCH_FAMILY)
    rng = np.random.RandomState(7)
    clip = rng.rand(2, T, *HW, 3).astype(np.float32)
    jfeats = jmodel.apply(variables, jnp.asarray(clip), method=jmodel.features)
    feats = tmodel.features(_t(clip))
    assert tuple(feats.shape) == jfeats.shape == tmodel.clstm_output_shape(_t(clip))
    np.testing.assert_allclose(_np(feats), np.asarray(jfeats), rtol=1e-5, atol=1e-5)
    off = rng.randn(*jfeats.shape).astype(np.float32)
    jout = jmodel.apply(variables, jnp.asarray(clip), feature_offset=jnp.asarray(off))
    scores, feats_off = tmodel.scores_and_features(_t(clip), _t(off))
    np.testing.assert_allclose(_np(scores), np.asarray(jout), rtol=1e-5, atol=1e-5)
    # the sequence carries h + offset, the recurrence h alone
    np.testing.assert_allclose(_np(feats_off), _np(feats) + off, rtol=1e-5, atol=1e-5)
    assert not np.allclose(_np(scores), _np(tmodel(_t(clip))), atol=1e-3)


@pytest.mark.parametrize(
    "case,weight_mode,per_frame",
    [("torch_family", "global", True), ("tf_family", "per_frame", False)],
)
def test_convlstm_grad_cam_matches_jax(case, weight_mode, per_frame):
    """The batched Grad-CAM against JAX's per-clip one under ``vmap``, at
    1e-4 (CAMs are normalized to [0, 1])."""
    kw = dict(CASES[case], add_softmax=True)
    jmodel, variables, tmodel = _pair_models(kw)
    clip = np.random.RandomState(8).rand(3, T, *HW, 3).astype(np.float32)
    targets = np.array([1, 0, 2])
    jcams, jscores = jax.jit(
        jax.vmap(
            lambda x, tgt: j_convlstm_grad_cam(
                jmodel, variables, x, tgt, normalize_per_frame=per_frame, weight_mode=weight_mode
            )
        )
    )(jnp.asarray(clip), jnp.asarray(targets))
    cams, scores = convlstm_grad_cam(
        tmodel, _t(clip), torch.as_tensor(targets), normalize_per_frame=per_frame,
        weight_mode=weight_mode,
    )
    assert cams.shape == (3, T, *HW)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cams.numpy(), np.asarray(jcams), rtol=0, atol=1e-4)


def test_build_model_clstm_kth_preset_matches_jax_tree():
    """The clstm_kth preset (configs/config_clstm_kth.py), at full width,
    routes by substring to the ConvLSTM and has the JAX model's variables:
    the converted JAX tree loads strictly, with end_fc (6, 280)."""
    jcfg, tcfg = JConfig(), TConfig()
    for cfg in (jcfg, tcfg):
        cfg.model.conv_model = "clstm_kth"
        cfg.model.num_classes = 6
        cfg.model.clstm_hidden = 4
        cfg.model.clstm_layers = 2
        cfg.model.conv_stride = 2
        cfg.model.effective_steps = (7, 15, 23, 31)
        cfg.data.clip_size = 32
        cfg.data.input_spatial_size = (120, 160)
    tmodel = tapi.build_model(tcfg, device="cpu")
    assert isinstance(tmodel, TClassifier) and not tmodel.training
    jmodel = japi.build_model(jcfg)
    # the parameter shapes do not depend on T: one frame traces fast
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 1, 120, 160, 3)))
    sd = convlstm_variables_to_state_dict(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), tree)
    )
    tmodel.load_state_dict(sd, strict=True)
    assert tuple(tmodel.end_fc.weight.shape) == (6, 280)
    assert tmodel.clstm.effective_steps == (7, 15, 23, 31)
    assert tmodel.clstm.bn.eps == 1e-5 and tmodel.clstm.cells[0].x_padding == "torch"
    assert tapi.default_effective_steps(32) == japi.default_effective_steps(32) == (7, 15, 23, 31)
    assert tapi.default_effective_steps(16) == japi.default_effective_steps(16)
    tcfg.model.block_order = "tf"
    tf_model = tapi.build_model(tcfg, device="cpu")
    assert tf_model.clstm.bns[0].eps == 1e-3
    assert tf_model.clstm.cells[0].bx[4:8].eq(1.0).all()  # Keras unit forget bias


@pytest.mark.parametrize("name", ["convlstm", "clstm", "models.CLSTM_4", "clstm_gap"])
def test_registry_names(name):
    model = get_model(name, num_classes=3, nb_lstm_units=2, lstm_layers=1, input_size=(8, 8),
                      clip_len=4, effective_steps=(3,))
    assert isinstance(model, TClassifier)
    assert model.head == ("gap" if name == "clstm_gap" else "fc")


# -- find_masks end to end ---------------------------------------------------

RECORD_KEYS = {
    "true_class", "pred_class", "video_id", "time_mask", "original_score_guess",
    "original_score_true", "freeze_score", "reverse_score",
}


def _set_small(cfg, out_dir):
    cfg.output_dir = str(out_dir)
    cfg.model_name = "fm"
    cfg.model.conv_model = "clstm"
    cfg.model.num_classes = 2
    cfg.model.clstm_hidden = 4
    cfg.model.clstm_layers = 2
    cfg.model.conv_stride = 2
    cfg.model.effective_steps = (3, 7)
    cfg.data.batch_size = 4
    cfg.data.clip_size = 8
    cfg.data.input_spatial_size = 32
    cfg.mask.opt_iter = 8
    return cfg


@pytest.fixture(scope="module")
def jax_clstm_run(tmp_path_factory):
    """JAX find_masks with its default flags on 4 SyntheticClips (8x32x32,
    uint8 values fed raw, so the first layer's kernels are scaled down to
    keep the gates off saturation)."""
    out = tmp_path_factory.mktemp("jax_clstm")
    cfg = _set_small(JConfig(), out)
    cfg.data.num_workers = 1
    cfg.model.dropout = 0.0
    model = japi.build_model(cfg, softmax_override=True)
    variables = jax_clstm_variables(model, (1, 8, 32, 32, 3), seed=1, input_scale=128.0)
    tm, gc = japi.find_masks(
        cfg, variables, dataset=JSyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False),
        save_viz=False,
    )
    return dict(out=out, tm=tm, gc=gc, sd=convlstm_variables_to_state_dict(variables))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_route"])
def test_find_masks_clstm_matches_jax(jax_clstm_run, tmp_path, use_pallas):
    """Per-clip records, CAMs and pickle names against JAX's find_masks:
    masks atol 1e-4 after 8 Adam steps (as for I3D), scores atol 1e-5,
    CAMs atol 1e-4."""
    cfg = _set_small(TConfig(), tmp_path)
    cfg.model.use_pallas = use_pallas
    stats = {}
    tm, gc = tapi.find_masks(
        cfg, jax_clstm_run["sd"], SyntheticClips(4, t=8, hw=32, num_classes=2, lazy=False),
        stats=stats, device="cpu",
    )
    res, want_res = tmp_path / "fm" / "results", Path(jax_clstm_run["out"]) / "fm" / "results"
    names = sorted(p.name for p in res.glob("all*Results_*.p"))
    assert names == sorted(p.name for p in want_res.glob("all*Results_*.p"))
    assert len(names) == 2
    pickled_tm = pickle.loads((res / "allTimeMaskResults_fm_None_.p").read_bytes())
    assert stats["searched_rows"] == 4 and stats["n_steps_run"] == [8] * 4
    masks = np.stack([r["time_mask"] for r in tm])
    assert masks.std() > 1e-3  # the search moved the masks apart
    for got, want, pickled in zip(tm, jax_clstm_run["tm"], pickled_tm):
        assert set(got) == set(want) == set(pickled) == RECORD_KEYS
        for key in ("true_class", "pred_class", "video_id"):
            assert got[key] == want[key]
        for key in ("original_score_guess", "original_score_true", "freeze_score", "reverse_score"):
            np.testing.assert_allclose(got[key], want[key], atol=1e-5)
        np.testing.assert_allclose(got["time_mask"], want["time_mask"], atol=1e-4)
    for got, want in zip(gc, jax_clstm_run["gc"]):
        assert set(got) == set(want)
        assert got["GCHeatMap"].shape == (8, 32, 32)
        np.testing.assert_allclose(got["GCHeatMap"], want["GCHeatMap"], atol=1e-4)
