"""ivf_tpu_torch's ConvLSTM slice vs the JAX package, on the CPU, in float32
and in bfloat16 (bf16 weights and gates, float32 state).

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
        stats=stats, device="cpu", save_viz=False,
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


# -- bfloat16: bf16 weights and gates, float32 state -------------------------
#
# The JAX package's bf16 search casts every float32 variable to bfloat16
# (ivf_tpu/api.py:669-675). The cell's convs then run in bf16 (they cast
# their input to the kernel's dtype) while the carry keeps the clip's
# float32, so the gate block sees bf16 gates and a float32 c and returns
# float32 h' and c'; BN and the head compute in float32 over bf16
# parameters.


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _tbf16(a):
    return _t(np.asarray(a, np.float32)).bfloat16()


def _rel(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("with_gh", [True, False], ids=["split", "merged"])
def test_bf16_gate_math_and_vjp_match_pallas(with_gh):
    """bf16 gates (z ~ 3 N(0, 1)) and a float32 c through the port's gate
    wrapper (its plain versions) against ``pallas_gate_math(interpret=True)``
    and its VJP, 4096 rows. The plain versions round where XLA rounds (see
    ``ops/kernels/fused_gates.py``), so what is left is float32
    transcendentals of two libraries: measured h' 1.25e-7, c' 8.3e-8, dc
    1.3e-7 of the largest value, held at 2.6e-7; dz (bf16) measured 2.8e-4
    of its largest value (a few elements one bf16 rounding apart), held at
    6e-4. Outputs are float32 and dz bfloat16, as in JAX."""
    rng = np.random.RandomState(0)
    shape, ch = (4, 32, 32), 4
    gx, gh = rng.randn(*shape, 4 * ch) * 3, rng.randn(*shape, 4 * ch) * 2
    c, cot_h, cot_c = (rng.randn(*shape, ch).astype(np.float32) for _ in range(3))

    def f(a, b, c_):
        return pallas_gate_math(a, b if with_gh else None, c_, interpret=True)

    (jh, jc), vjp = jax.vjp(f, _jbf16(gx), _jbf16(gh), jnp.asarray(c))
    jdgx, jdgh, jdc = vjp((jnp.asarray(cot_h), jnp.asarray(cot_c)))
    gx_t, c_t = _tbf16(gx).requires_grad_(True), _t(c).requires_grad_(True)
    gh_t = _tbf16(gh).requires_grad_(True) if with_gh else None
    h_new, c_new = tgates.gate_math(gx_t, gh_t, c_t)
    inputs = [gx_t, c_t] + ([gh_t] if with_gh else [])
    grads = torch.autograd.grad((h_new, c_new), inputs, (_t(cot_h), _t(cot_c)))
    assert h_new.dtype == c_new.dtype == grads[1].dtype == torch.float32
    assert grads[0].dtype == torch.bfloat16
    for got, want in ((h_new, jh), (c_new, jc), (grads[1], jdc)):
        assert _rel(got, want) <= 2.6e-7
    assert _rel(grads[0], jdgx) <= 6e-4
    if with_gh:
        assert torch.equal(grads[2], grads[0])
        assert _rel(grads[2], jdgh) <= 6e-4


@pytest.mark.parametrize(
    "gx_dtype,gh_dtype,c_dtype",
    [
        (torch.bfloat16, torch.bfloat16, torch.bfloat16),
        (torch.float32, None, torch.bfloat16),
        (torch.bfloat16, torch.float32, torch.float32),
    ],
    ids=["all_bf16", "bf16_state", "mixed_gates"],
)
def test_gate_math_refuses_dtypes_no_jax_path_gives(gx_dtype, gh_dtype, c_dtype):
    """float32 gates with a float32 c, or bf16 gates with a float32 c, and
    nothing else: the all-bf16 call is on no JAX path."""
    gx = torch.zeros(2, 3, 16, dtype=gx_dtype)
    gh = None if gh_dtype is None else torch.zeros(2, 3, 16, dtype=gh_dtype)
    with pytest.raises(TypeError, match="fused_gates"):
        tgates.gate_math(gx, gh, torch.zeros(2, 3, 4, dtype=c_dtype))


@pytest.mark.parametrize("act", ["sigmoid", "hard_sigmoid"])
def test_bf16_fused_gate_math_matches_jax(act):
    """The plain gate block (hard-sigmoid gates, or ``use_pallas`` off) on
    bf16 gates and a float32 c against the JAX package's jnp gate block as
    XLA compiles it (jit): measured 1.23e-7 of the largest value for both
    activations (torch's own bf16 sigmoid, rounded once, was 6.5e-3 off),
    held at 2.5e-7."""
    gx, gh, c, _, _ = _gate_inputs(seed=2)
    gx = gx * 4  # reach both clip ends of the hard sigmoid
    jh, jc = jax.jit(lambda a, b, c_: jcell.fused_gate_math(a, b, c_, act))(
        _jbf16(gx), _jbf16(gh), jnp.asarray(c)
    )
    th, tc = tcell.fused_gate_math(_tbf16(gx), _tbf16(gh), _t(c), act)
    assert th.dtype == tc.dtype == torch.float32
    assert _rel(th, jh) <= 2.5e-7 and _rel(tc, jc) <= 2.5e-7


def _to_jbf16(variables):
    return jax.tree.map(_jbf16, variables)


BF16_CASES = [("torch_family", False), ("torch_family", True), ("tf_family", False)]


@pytest.mark.parametrize(
    "case,use_pallas", BF16_CASES, ids=["torch_plain", "torch_kernel_route", "tf_plain"]
)
def test_bf16_classifier_logits_and_input_grad_match_jax(case, use_pallas):
    """The classifier with every parameter and buffer in bf16 against the
    JAX model on its bf16 variables (same route): logits within 5e-3 of
    the largest logit (measured 2.3e-3 torch family, 2.6e-3 TF family;
    JAX's own bf16 vs float32: 5.5e-3 and 2.0e-3) and the float32 input
    gradient within 0.016 in relative L2 (measured 0.0081 and 0.0075).
    The logits are float32: the state, BN and head run in float32."""
    kw = CASES[case]
    jmodel, variables, tmodel = _pair_models(kw, use_pallas)
    if use_pallas:
        jmodel = JClassifier(dropout_rate=0.0, use_pallas=True, **kw)
    rng = np.random.RandomState(6)
    clip = rng.rand(2, T, *HW, 3).astype(np.float32)
    r = rng.randn(2, jmodel.num_classes).astype(np.float32)

    def loss(x):
        logits = jmodel.apply(_to_jbf16(variables), x)
        return jnp.sum(logits * r), logits

    (_, jlogits), jgrad = jax.jit(jax.value_and_grad(loss, has_aux=True))(jnp.asarray(clip))
    tmodel = tmodel.to(torch.bfloat16)
    x = _t(clip).requires_grad_(True)
    logits = tmodel(x)
    (grad,) = torch.autograd.grad(logits, x, _t(r))
    assert logits.dtype == grad.dtype == torch.float32
    assert _rel(logits, jlogits) <= 5e-3
    jgrad = np.asarray(jgrad)
    assert np.linalg.norm(grad.numpy() - jgrad) / np.linalg.norm(jgrad) <= 0.016


class _Clips:
    """Seeded uint8 clips (n, t, h, w, 3) with labels i % classes, the items
    both packages' find_masks read."""

    def __init__(self, n, t, h, w, num_classes, seed=0):
        self.clips = np.random.RandomState(seed).randint(0, 255, (n, t, h, w, 3)).astype(np.uint8)
        self.num_classes = num_classes

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i], i % self.num_classes, f"clip{i}"


PINNED_INIT = np.where((np.arange(8) >= 2) & (np.arange(8) < 6), 5.0, -5.0).astype(np.float32)


def _set_bf16(cfg, out_dir, family):
    cfg = _set_small(cfg, out_dir)
    cfg.model.compute_dtype = "bfloat16"
    cfg.data.input_spatial_size = (32, 40)
    if family == "tf":
        cfg.model.block_order, cfg.model.pooling = "tf", "avg"
        cfg.model.padding_clstm, cfg.model.recurrent_activation = "valid", "hard_sigmoid"
        cfg.model.conv_stride = 1
    return cfg


@pytest.fixture(scope="module")
def jax_bf16_runs(tmp_path_factory):
    """The JAX package's bf16 find_masks per family (computed once each),
    the central init pinned, and the port's state dict of its weights."""
    import ivf_tpu.interpret.mask_opt as j_mask_opt

    runs = {}

    def run(family):
        if family not in runs:
            cfg = _set_bf16(JConfig(), tmp_path_factory.mktemp(f"jax_bf16_{family}"), family)
            cfg.data.num_workers = 1
            cfg.model.dropout = 0.0
            model = japi.build_model(cfg, softmax_override=True)
            variables = jax_clstm_variables(model, (1, 8, 32, 40, 3), seed=1, input_scale=128.0)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(j_mask_opt, "init_mask_central", lambda *a, **k: jnp.asarray(PINNED_INIT))
                tm, gc = japi.find_masks(
                    cfg, variables, dataset=_Clips(4, 8, 32, 40, 2), save_viz=False
                )
            runs[family] = (tm, gc, convlstm_variables_to_state_dict(variables))
        return runs[family]

    return run


@pytest.mark.parametrize(
    "family,use_pallas", [("torch", False), ("torch", True), ("tf", False)],
    ids=["torch_plain", "torch_kernel_route", "tf_plain"],
)
def test_find_masks_clstm_bf16_matches_jax(jax_bf16_runs, tmp_path, family, use_pallas):
    """find_masks in bf16 on the ConvLSTM (2 layers x 4 hidden, 8 frames of
    32x40), the central init pinned in both packages, 8 steps, against the
    JAX package's bf16 run: masks atol 1.2e-4 (measured 5.9e-5), scores
    atol 6e-4 (3.0e-4), CAMs atol 0.02 (0.0095), predictions equal."""
    jtm, jgc, sd = jax_bf16_runs(family)
    cfg = _set_bf16(TConfig(), tmp_path, family)
    cfg.model.use_pallas = use_pallas
    built = []
    orig = tapi.build_model

    def spy_model(cfg, softmax_override=None, device=None):
        model = orig(cfg, softmax_override, device)
        built.append(next(model.parameters()).dtype)
        return model

    def pinned_init(score_fn, seqs, targets, **kw):
        return torch.from_numpy(PINNED_INIT).expand(seqs.shape[0], -1).clone()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "build_model", spy_model)
        mp.setattr(tapi, "init_mask_central", pinned_init)
        tm, gc = tapi.find_masks(cfg, sd, _Clips(4, 8, 32, 40, 2), device="cpu", save_viz=False)
    assert built == [torch.bfloat16]
    assert np.std([r["time_mask"] for r in tm]) > 1e-3
    for got, want in zip(tm, jtm):
        assert got["pred_class"] == want["pred_class"]
        for key in ("original_score_guess", "freeze_score", "reverse_score"):
            np.testing.assert_allclose(got[key], float(want[key]), atol=6e-4)
        np.testing.assert_allclose(got["time_mask"], np.asarray(want["time_mask"], np.float32), atol=1.2e-4)
    for got, want in zip(gc, jgc):
        assert got["GCHeatMap"].shape == (8, 32, 40) and got["GCHeatMap"].dtype == np.float32
        np.testing.assert_allclose(got["GCHeatMap"], np.asarray(want["GCHeatMap"], np.float32), atol=0.02)
