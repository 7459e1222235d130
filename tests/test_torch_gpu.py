"""ivf_tpu_torch's CUDA kernels on the card (``gpu`` marker).

Each kernel against its plain PyTorch version (float32 and the bfloat16
entries, the argmax-index pool), the I3D kernel paths of ``find_masks``
(the pool kernels, the fused branch 3, both bfloat16 routes) at full
width and the ConvLSTM's at a small size, float32 results that do not
depend on the global TF32 flags, and two runs with equal bits. Skips
without a CUDA device. This file
imports torch and ivf_tpu_torch only, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from ivf_tpu_torch import api
from ivf_tpu_torch.config import Config
from ivf_tpu_torch.data.synthetic import SyntheticClips
from ivf_tpu_torch.ops.kernels import argmax_pool as tap
from ivf_tpu_torch.ops.kernels import fused_branch3 as tfb
from ivf_tpu_torch.ops.kernels import fused_gates as tgates
from ivf_tpu_torch.ops.kernels import maxpool3d as tpool
from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _ties(shape, seed):
    """Post-ReLU values rounded to halves: exact zeros and tied maxima."""
    x = torch.round(torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 2) / 2
    return torch.relu(x)


@pytest.mark.parametrize(
    "n,cin,cout,relu,use_bias",
    [
        (150, 112, 48, True, True),
        (150, 112, 48, False, False),
        (1, 1024, 174, False, True),
        (8 * 28 * 28, 192, 176, True, True),
    ],
)
def test_pointwise_kernel_matches_plain(cuda_device, n, cin, cout, relu, use_bias):
    """Tolerance: max error <= 1e-5 of the largest output (float32 sums
    of up to 1024 terms in another order than cuBLAS)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, cin, generator=gen).to(cuda_device)
    w = (torch.randn(cin, cout, generator=gen) * 0.1).to(cuda_device)
    b = torch.randn(cout, generator=gen).to(cuda_device) if use_bias else None
    before = tpw.pointwise_conv_cuda.launches
    y = tpw.pointwise_conv_cuda(x, w, b, relu)
    torch.cuda.synchronize()
    assert tpw.pointwise_conv_cuda.launches == before + 1
    ref = tpw.pointwise_conv_plain(x, w, b, relu)
    assert (y - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (4, 2, 7, 7, 832)])
def test_maxpool_kernels_match_plain(cuda_device, shape):
    """Forward bit-exact; backward within 1e-6."""
    x = _ties(shape, 6).to(cuda_device)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    y = tpool.maxpool3d_s1_fwd_cuda(x)
    dx = tpool.maxpool3d_s1_bwd_cuda(x, y, g)
    torch.cuda.synchronize()
    assert torch.equal(y, tpool.maxpool3d_s1_fwd_plain(x))
    assert (dx - tpool.maxpool3d_s1_bwd_plain(x, y, g)).abs().max().item() <= 1e-6


FUSED = {
    "frame": (tfb.fused_pool_conv_fwd_cuda, tfb.fused_pool_conv_bwd_cuda),
    "tblock": (tfb.fused_pool_conv_tblock_fwd_cuda, tfb.fused_pool_conv_tblock_bwd_cuda),
}


@pytest.mark.parametrize("shape,cout", [((2, 8, 28, 28, 192), 32), ((2, 2, 7, 7, 832), 128)],
                         ids=["Mixed_3b", "Mixed_5b"])
@pytest.mark.parametrize("variant", sorted(FUSED))
def test_fused_branch3_kernels_match_plain(cuda_device, variant, shape, cout):
    """Forward within 1e-5 of the largest |y|, dx within 1e-5 of
    max(1, largest |dx|): the pool and the gather are exact, the GEMMs sum
    in another order than the plain matmul. Post-ReLU tie data with the
    ReLU, signed data without."""
    fwd, bwd = FUSED[variant]
    gen = torch.Generator().manual_seed(3)
    for relu in (True, False):
        x = _ties(shape, 4) if relu else torch.randn(shape, generator=gen)
        x = x.to(cuda_device)
        w = (torch.randn(shape[-1], cout, generator=gen) / shape[-1] ** 0.5).to(cuda_device)
        b = (torch.randn(cout, generator=gen) * 0.1).to(cuda_device)
        g = torch.randn(*shape[:-1], cout, generator=gen).to(cuda_device)
        before = (fwd.launches, bwd.launches)
        y = fwd(x, w, b, relu)
        dx = bwd(x, y, g, w, relu)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
        y_ref = tfb.fused_pool_conv_plain(x, w, b, relu)
        dx_ref = tfb.fused_pool_conv_bwd_plain(x, y, g, w, relu)
        assert (y - y_ref).abs().max().item() <= 1e-5 * y_ref.abs().max().item()
        assert (dx - dx_ref).abs().max().item() <= 1e-5 * max(1.0, dx_ref.abs().max().item())


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(8, 4, device=cuda_device)
    w = torch.randn(4, 3, device=cuda_device)
    with pytest.raises(TypeError):
        tpw.pointwise_conv_cuda(x.double(), w.double(), None, True)
    with pytest.raises(ValueError):
        tpw.pointwise_conv_cuda(x.t(), w, None, True)  # not contiguous
    with pytest.raises(TypeError):
        tpool.maxpool3d_s1_fwd_cuda(torch.ones(1, 2, 3, 3, 4, device=cuda_device).half())
    c = torch.zeros(2, 5, 4, device=cuda_device)
    with pytest.raises(ValueError):
        tgates.lstm_gates_fwd_cuda(torch.zeros(2, 5, 12, device=cuda_device), None, c)
    with pytest.raises(ValueError):
        tgates.lstm_gates_fwd_cuda(torch.zeros(2, 16, 5, device=cuda_device).transpose(1, 2), None, c)
    with pytest.raises(ValueError):
        tgates.lstm_gates_fwd_cuda(torch.zeros(2, 5, 16), None, c)  # gates on the CPU


@pytest.mark.parametrize("with_gh", [True, False], ids=["split", "merged"])
@pytest.mark.parametrize("shape,ch", [((3, 7, 9), 5), ((16, 15, 20), 4)])
def test_gate_kernels_match_plain(cuda_device, shape, ch, with_gh):
    """Forward: h' within 1e-6, c' within 1e-6 of max|c'|; backward: dz and
    dc within 1e-6 of max(1, their largest magnitude) (accurate expf/tanhf
    and FMA contraction against PyTorch's separately rounded ops)."""
    gen = torch.Generator().manual_seed(2)
    gx, gh = (torch.randn(*shape, 4 * ch, generator=gen).to(cuda_device) for _ in range(2))
    c, dh, dc_out = (torch.randn(*shape, ch, generator=gen).to(cuda_device) for _ in range(3))
    gh = gh if with_gh else None
    before = (tgates.lstm_gates_fwd_cuda.launches, tgates.lstm_gates_bwd_cuda.launches)
    h_new, c_new = tgates.lstm_gates_fwd_cuda(gx, gh, c)
    dz, dc = tgates.lstm_gates_bwd_cuda(gx, gh, c, dh, dc_out)
    torch.cuda.synchronize()
    assert (tgates.lstm_gates_fwd_cuda.launches, tgates.lstm_gates_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1
    )
    h_ref, c_ref = tgates.gate_math_plain(gx, gh, c)
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
    assert (h_new - h_ref).abs().max().item() <= 1e-6
    assert (c_new - c_ref).abs().max().item() <= 1e-6 * c_ref.abs().max().item()
    for got, ref in ((dz, dz_ref), (dc, dc_ref)):
        assert (got - ref).abs().max().item() <= 1e-6 * max(1.0, ref.abs().max().item())


def test_clstm_find_masks_on_the_card_goes_through_the_gate_kernels(cuda_device, tmp_path):
    cfg = Config()
    cfg.output_dir = str(tmp_path)
    cfg.model.conv_model = "clstm_kth"
    cfg.model.num_classes = 6
    cfg.model.clstm_hidden, cfg.model.clstm_layers, cfg.model.conv_stride = 4, 2, 2
    cfg.model.use_pallas = True
    cfg.data.clip_size, cfg.data.input_spatial_size, cfg.data.batch_size = 8, (32, 48), 2
    cfg.mask.opt_iter = 2
    for fn in (tgates.lstm_gates_fwd_cuda, tgates.lstm_gates_bwd_cuda):
        fn.launches = 0
    rng = np.random.RandomState(0)
    clips = [(rng.randint(0, 255, (8, 32, 48, 3)).astype(np.uint8), i, f"c{i}") for i in range(2)]
    tm, gc = api.find_masks(cfg, None, clips)
    assert tgates.lstm_gates_fwd_cuda.launches > 0 and tgates.lstm_gates_bwd_cuda.launches > 0
    assert all(np.isfinite(r["time_mask"]).all() for r in tm)
    assert gc[0]["GCHeatMap"].shape == (8, 32, 48)


@pytest.mark.parametrize("variant", [True, "tblock"], ids=["frame", "tblock"])
def test_find_masks_on_the_card_goes_through_the_fused_kernels(cuda_device, tmp_path, variant):
    cfg = Config()
    cfg.output_dir = str(tmp_path)
    cfg.model.num_classes = 5
    cfg.model.use_pallas, cfg.model.fuse_pool_conv = True, variant
    cfg.mask.opt_iter = 2
    cfg.data.batch_size = 2
    fused = FUSED["tblock" if variant == "tblock" else "frame"]
    pools = (tpool.maxpool3d_s1_fwd_cuda, tpool.maxpool3d_s1_bwd_cuda)
    for fn in (*fused, *pools):
        fn.launches = 0
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5))
    assert all(fn.launches > 0 for fn in fused)
    assert all(fn.launches == 0 for fn in pools)
    assert all(np.isfinite(r["time_mask"]).all() for r in tm)
    assert gc[0]["GCHeatMap"].shape == (16, 224, 224)


def test_find_masks_on_the_card_goes_through_the_kernels(cuda_device, tmp_path):
    cfg = Config()
    cfg.output_dir = str(tmp_path)
    cfg.model.num_classes = 5
    cfg.model.use_pallas = cfg.model.pallas_pool = True
    cfg.mask.opt_iter = 2
    cfg.data.batch_size = 2
    counters = (tpw.pointwise_conv_cuda, tpool.maxpool3d_s1_fwd_cuda, tpool.maxpool3d_s1_bwd_cuda)
    for fn in counters:
        fn.launches = 0
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5))
    assert all(fn.launches > 0 for fn in counters)
    assert all(np.isfinite(r["time_mask"]).all() for r in tm)
    assert gc[0]["GCHeatMap"].shape == (16, 224, 224)


BF16_ULP = 2.0**-7  # one bfloat16 ulp relative to a value's leading power of two


@pytest.mark.parametrize(
    "n,cin,cout,relu,use_bias",
    [
        (150, 112, 48, True, True),
        (150, 112, 48, False, False),
        (4, 1024, 174, False, True),
        (8 * 28 * 28, 192, 176, True, True),
    ],
    ids=["ragged", "ragged_linear", "logits_head", "Mixed_3b_trio"],
)
def test_bf16_pointwise_kernel_matches_plain(cuda_device, n, cin, cout, relu, use_bias):
    """Tensor-core sums in another order than the plain float32 matmul,
    then one rounding each: within one bfloat16 ulp of the largest
    output."""
    gen = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(n, cin, generator=gen)).bfloat16().to(cuda_device)
    w = (torch.randn(cin, cout, generator=gen) * 0.1).bfloat16().to(cuda_device)
    b = torch.randn(cout, generator=gen).bfloat16().to(cuda_device) if use_bias else None
    before = tpw.pointwise_conv_bf16_cuda.launches
    y = tpw.pointwise_conv_bf16_cuda(x, w, b, relu)
    torch.cuda.synchronize()
    assert tpw.pointwise_conv_bf16_cuda.launches == before + 1 and y.dtype == torch.bfloat16
    ref = tpw.pointwise_conv_plain(x, w, b, relu).float()
    assert (y.float() - ref).abs().max().item() <= BF16_ULP * ref.abs().max().item()


@pytest.mark.parametrize("shape", [(2, 3, 4, 5, 6), (4, 8, 28, 28, 192)])
def test_bf16_maxpool_kernels_match_plain_bits(cuda_device, shape):
    """bfloat16 forward and backward (the Pallas kernel's order and
    rounding): equal bits, the sign of zero included."""
    x = _ties(shape, 6).bfloat16().to(cuda_device)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).bfloat16().to(cuda_device)
    y = tpool.maxpool3d_s1_fwd_bf16_cuda(x)
    dx = tpool.maxpool3d_s1_bwd_bf16_cuda(x, y, g)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int16), tpool.maxpool3d_s1_fwd_plain(x).view(torch.int16))
    assert torch.equal(dx.view(torch.int16), tpool.maxpool3d_s1_bwd_bf16_plain(x, y, g).view(torch.int16))


@pytest.mark.parametrize("shape", [(1, 3, 5, 7, 3), (4, 8, 28, 28, 192)])
def test_argmax_pool_kernels_match_plain_bits(cuda_device, shape):
    """Forward (y and the index plane) and backward: equal bits, on tied
    halves with a negative plateau where the zero pad wins."""
    gen = torch.Generator().manual_seed(2)
    x = torch.round(torch.randn(shape, generator=gen) * 2).clamp(-4, 4) / 2
    x[..., 1] = -1.5
    x = x.bfloat16().to(cuda_device)
    g = torch.randn(shape, generator=gen).bfloat16().to(cuda_device)
    y, idx = tap.argmax_pool_fwd_cuda(x)
    dx = tap.argmax_pool_bwd_cuda(idx, g)
    torch.cuda.synchronize()
    y_ref, idx_ref = tap.argmax_pool_fwd_plain(x)
    assert torch.equal(y.view(torch.int16), y_ref.view(torch.int16))
    assert torch.equal(idx, idx_ref)
    assert torch.equal(dx.view(torch.int16), tap.argmax_pool_bwd_plain(idx_ref, g).view(torch.int16))


def test_bf16_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 2, 3, 3, 4, device=cuda_device)
    with pytest.raises(TypeError):
        tap.argmax_pool_fwd_cuda(x)  # float32
    with pytest.raises(TypeError):
        tpool.maxpool3d_s1_fwd_bf16_cuda(x)
    with pytest.raises(TypeError):
        tpw.pointwise_conv_bf16_cuda(x.view(-1, 4), torch.zeros(4, 3, device=cuda_device), None, True)
    with pytest.raises(TypeError):
        tfb.fused_pool_conv_fwd_cuda(x.bfloat16(), torch.zeros(4, 3, device=cuda_device).bfloat16(),
                                     None, True)


def _small_find_masks(tmp_path, name, **model):
    cfg = Config()
    cfg.output_dir, cfg.model_name = str(tmp_path), name
    cfg.model.num_classes = 5
    for key, value in model.items():
        setattr(cfg.model, key, value)
    cfg.mask.opt_iter = 3
    cfg.data.batch_size = 2
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5))
    return np.stack([r["time_mask"] for r in tm]), np.stack([r["GCHeatMap"] for r in gc])


def test_float32_find_masks_does_not_depend_on_the_global_tf32_flags(cuda_device, tmp_path):
    """With cuDNN's and cuBLAS's global TF32 flags on, and off, the same
    float32 run gives the same bits, and the flags read as set after it."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    runs = []
    try:
        for flag in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            runs.append(_small_find_masks(tmp_path, f"tf32_{flag}"))
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert np.array_equal(runs[0][0], runs[1][0]) and np.array_equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize(
    "model",
    [dict(use_pallas=True, pallas_pool=True), dict(compute_dtype="bfloat16"),
     dict(compute_dtype="bfloat16", use_pallas=True, pallas_pool=True)],
    ids=["f32_kernels", "bf16_default", "bf16_kernels"],
)
def test_find_masks_twice_gives_equal_bits(cuda_device, tmp_path, model):
    """The same route run twice in one process: equal masks and CAMs."""
    first = _small_find_masks(tmp_path, "first", **model)
    second = _small_find_masks(tmp_path, "second", **model)
    assert np.array_equal(first[0], second[0]) and np.array_equal(first[1], second[1])


def test_bf16_find_masks_routes_go_through_their_kernels(cuda_device, tmp_path):
    """The bfloat16 default route runs the argmax pair on the nine branch-3
    pools and no other kernel; the kernel route runs the bfloat16 pointwise
    and pool kernels and no argmax kernel."""
    argmax = (tap.argmax_pool_fwd_cuda, tap.argmax_pool_bwd_cuda)
    bf16 = (tpw.pointwise_conv_bf16_cuda, tpool.maxpool3d_s1_fwd_bf16_cuda, tpool.maxpool3d_s1_bwd_bf16_cuda)
    f32 = (tpw.pointwise_conv_cuda, tpool.maxpool3d_s1_fwd_cuda, tpool.maxpool3d_s1_bwd_cuda)
    for flags, on, off in (
        ({}, argmax, bf16 + f32),
        (dict(use_pallas=True, pallas_pool=True), bf16, argmax + f32),
    ):
        for fn in on + off:
            fn.launches = 0
        masks, cams = _small_find_masks(tmp_path, "route", compute_dtype="bfloat16", **flags)
        assert all(fn.launches > 0 for fn in on) and not any(fn.launches for fn in off)
        assert np.isfinite(masks).all() and cams.shape == (2, 16, 224, 224)
