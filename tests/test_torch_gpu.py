"""ivf_tpu_torch's CUDA kernels on the card (``gpu`` marker).

Each kernel against its plain PyTorch version (float32 and the bfloat16
entries, the argmax-index pool), the I3D kernel paths of ``find_masks``
(the pool kernels, the fused branch 3, the bfloat16 routes, the fused
ones included) at full width and the ConvLSTM's (float32 and bfloat16) at
a small size, float32 results that do not
depend on the global TF32 flags, and two runs with equal bits; the
space-to-depth stem against the plain stem, the all-bf16 gate pair of
the bf16 train step (with every bf16 pattern in every operand slot, and
its activation tables against their plain twin), reference checkpoints loaded back on the card,
convergence refill against the search without it (``chip_smoke.py``'s refill phase at a
small size, so run from the repository's root), and a resumed run against
an uninterrupted one; artifacts exported on the card (``serve.py``)
against the live model, bit for bit, with their kernels' launches. Skips
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
    """Forward and backward bit-exact: the backward adds its 27 terms in
    the plain version's (dt, dh, dw) order."""
    x = _ties(shape, 6).to(cuda_device)
    g = torch.randn(shape, generator=torch.Generator().manual_seed(1)).to(cuda_device)
    y = tpool.maxpool3d_s1_fwd_cuda(x)
    dx = tpool.maxpool3d_s1_bwd_cuda(x, y, g)
    torch.cuda.synchronize()
    assert torch.equal(y.view(torch.int32), tpool.maxpool3d_s1_fwd_plain(x).view(torch.int32))
    assert torch.equal(dx.view(torch.int32), tpool.maxpool3d_s1_bwd_plain(x, y, g).view(torch.int32))


FUSED = {
    "frame": (tfb.fused_pool_conv_fwd_cuda, tfb.fused_pool_conv_bwd_cuda),
    "tblock": (tfb.fused_pool_conv_tblock_fwd_cuda, tfb.fused_pool_conv_tblock_bwd_cuda),
}


# the nine branch-3 sites of i3d_smth at 16x224x224 (batch 2), and ragged
# shapes: odd H and W that are no tile's multiple, T = 1 and T = 2, Cin 20
# (no 16-byte bf16 copies), Cout 24
FUSED_CASES = {
    "Mixed_3b": ((2, 8, 28, 28, 192), 32), "Mixed_3c": ((2, 8, 28, 28, 256), 64),
    "Mixed_4b": ((2, 4, 14, 14, 480), 64), "Mixed_4c": ((2, 4, 14, 14, 512), 64),
    "Mixed_4d": ((2, 4, 14, 14, 512), 64), "Mixed_4e": ((2, 4, 14, 14, 512), 64),
    "Mixed_4f": ((2, 4, 14, 14, 528), 128), "Mixed_5b": ((2, 2, 7, 7, 832), 128),
    "Mixed_5c": ((2, 2, 7, 7, 832), 128),
    "T1_odd_Cin20": ((2, 1, 9, 11, 20), 24), "T2_odd_Cin20": ((1, 2, 13, 5, 20), 24),
    "ragged_Cout24": ((2, 3, 17, 15, 48), 24),
}


def _fused_inputs(shape, cout, relu, seed, dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    x = _ties(shape, seed + 1) if relu else torch.randn(shape, generator=gen)
    w = torch.randn(shape[-1], cout, generator=gen) / shape[-1] ** 0.5
    b = torch.randn(cout, generator=gen) * 0.1
    g = torch.randn(*shape[:-1], cout, generator=gen)
    return (t.to(dtype).to("cuda") for t in (x, w, b, g))


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("variant", sorted(FUSED))
def test_fused_branch3_kernels_match_plain(cuda_device, variant, case):
    """Forward within 1e-5 of the largest |y|, dx within 1e-5 of
    max(1, largest |dx|): the pool and the gather are exact, the GEMMs sum
    in another order than the plain matmul. Post-ReLU tie data with the
    ReLU, signed data without."""
    fwd, bwd = FUSED[variant]
    shape, cout = FUSED_CASES[case]
    for relu in (True, False):
        x, w, b, g = _fused_inputs(shape, cout, relu, 3)
        before = (fwd.launches, bwd.launches)
        y = fwd(x, w, b, relu)
        dx = bwd(x, y, g, w, relu)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
        y_ref = tfb.fused_pool_conv_plain(x, w, b, relu)
        dx_ref = tfb.fused_pool_conv_bwd_plain(x, y, g, w, relu)
        assert (y - y_ref).abs().max().item() <= 1e-5 * y_ref.abs().max().item()
        assert (dx - dx_ref).abs().max().item() <= 1e-5 * max(1.0, dx_ref.abs().max().item())


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("variant", sorted(FUSED))
def test_fused_branch3_kernels_give_the_unfused_pairs_bits(cuda_device, variant, case):
    """float32: y and dx equal, bit for bit, what the unfused kernel pair
    (maxpool3d_s1 + pointwise_conv, the ReLU mask between them) gives on
    the same inputs: both add each output's terms in the same order."""
    fwd, bwd = FUSED[variant]
    shape, cout = FUSED_CASES[case]
    n, cin = int(np.prod(shape[:-1])), shape[-1]
    for relu in (True, False):
        x, w, b, g = _fused_inputs(shape, cout, relu, 11)
        y = fwd(x, w, b, relu)
        dx = bwd(x, y, g, w, relu)
        pooled = tpool.maxpool3d_s1_fwd_cuda(x)
        y_pair = tpw.pointwise_conv_cuda(pooled.view(n, cin), w, b, relu).view(y.shape)
        m = torch.where(y_pair != 0, g, 0.0) if relu else g
        gc = tpw.pointwise_conv_cuda(m.reshape(n, cout), w.t().contiguous(), None, False)
        dx_pair = tpool.maxpool3d_s1_bwd_cuda(x, pooled, gc.view(shape))
        torch.cuda.synchronize()
        assert torch.equal(y, y_pair)
        assert torch.equal(dx, dx_pair)


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


F32_GATE_SHAPES = {  # (leading shape, Ch, gates_h, element offset of every operand)
    "ch4": ((16, 15, 20), 4, True, 0),  # 2 channels a thread (Ch even, 8-byte-aligned bases)
    "ch4_merged": ((16, 15, 20), 4, False, 0),  # gates_h None
    "ch8": ((3, 7, 9), 8, True, 0),
    "ch6": ((3, 7, 9), 6, True, 0),
    "ch5": ((3, 7, 9), 5, True, 0),  # 1 channel a thread: Ch odd, an odd row count
    "ch5_merged": ((3, 7, 9), 5, False, 0),
    "odd_rows": ((3, 7), 4, True, 0),
    "misaligned": ((4, 6, 8), 4, True, 1),  # every base 4 bytes off 8-byte alignment: 1 channel a thread
    "walk_ch5": ((16, 60, 80), 5, True, 0),  # more elements than one pass of the grid: the walk wraps channels
    "walk_ch10": ((16, 60, 80), 10, False, 0),
}


@pytest.mark.parametrize("case", list(F32_GATE_SHAPES))
def test_gate_kernels_match_plain(cuda_device, case):
    """One launch each way, at every layout the float32 kernels pick (2 or
    1 channels a thread). Forward: h' within 1e-6, c' within 1e-6 of
    max|c'|; backward: dz and dc within 1e-6 of max(1, their largest
    magnitude) (accurate expf/tanhf and FMA contraction against PyTorch's
    separately rounded ops)."""
    lead, ch, with_gh, off = F32_GATE_SHAPES[case]
    gen = torch.Generator().manual_seed(2)

    def operand(width):
        n = int(np.prod(lead)) * width
        return torch.randn(n + off, generator=gen).to(cuda_device)[off:].view(*lead, width)

    gx, gh = operand(4 * ch), operand(4 * ch)
    c, dh, dc_out = operand(ch), operand(ch), operand(ch)
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


@pytest.mark.parametrize("off", [0, 1], ids=["two_channels", "one_channel"])
def test_gate_kernels_64bit_index(cuda_device, off):
    """The float32 pair past 2^31 gate elements, where it indexes in 64
    bits: merged gates of (2^27 + 1000, 16), ~30 GB on the card in all,
    with every base aligned (2 channels a thread) or one float off (1). The
    rows at both ends and a random sample of the rest against the plain
    version, with test_gate_kernels_match_plain's limits."""
    ch, rows = 4, (1 << 31) // 16 + 1000
    if torch.cuda.get_device_properties(cuda_device).total_memory < (48 << 30):
        pytest.skip("needs a card with 48 GB or more")
    gen = torch.Generator(device=cuda_device).manual_seed(3)

    def operand(width):
        return torch.randn(rows * width + off, generator=gen, device=cuda_device)[off:].view(rows, width)

    gx, c, dh, dc_out = operand(4 * ch), operand(ch), operand(ch), operand(ch)
    before = (tgates.lstm_gates_fwd_cuda.launches, tgates.lstm_gates_bwd_cuda.launches)
    outs = (*tgates.lstm_gates_fwd_cuda(gx, None, c), *tgates.lstm_gates_bwd_cuda(gx, None, c, dh, dc_out))
    torch.cuda.synchronize()
    assert (tgates.lstm_gates_fwd_cuda.launches, tgates.lstm_gates_bwd_cuda.launches) == (
        before[0] + 1, before[1] + 1
    )
    picked = torch.cat([
        torch.arange(2048, device=cuda_device),
        torch.randint(rows, (4096,), generator=gen, device=cuda_device),
        torch.arange(rows - 2048, rows, device=cuda_device),
    ])
    gx_s, c_s, dh_s, dco_s = (t.index_select(0, picked) for t in (gx, c, dh, dc_out))
    h_new, c_new, dz, dc = (t.index_select(0, picked) for t in outs)
    del gx, c, dh, dc_out, outs
    torch.cuda.empty_cache()
    h_ref, c_ref = tgates.gate_math_plain(gx_s, None, c_s)
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(gx_s, None, c_s, dh_s, dco_s)
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
    tm, gc = api.find_masks(cfg, None, clips, save_viz=False)
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
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5), save_viz=False)
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
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5), save_viz=False)
    assert all(fn.launches > 0 for fn in counters)
    assert all(np.isfinite(r["time_mask"]).all() for r in tm)
    assert gc[0]["GCHeatMap"].shape == (16, 224, 224)


BF16_ULP = 2.0**-7  # one bfloat16 ulp relative to a value's leading power of two


# I3D's bf16 pointwise GEMMs at batch 4 (site, N, Cin, Cout): the forward
# takes W as the layers pass it, the column-major view of the (Cout, Cin)
# weight, with bias and ReLU; dx is (N, Cout) @ that view's transpose, a
# row-major (Cout, Cin) array, without either.
PW_MAIN_PATH = [
    ("Conv3d_2b", 100352, 64, 64), ("Mixed_3b_trio", 25088, 192, 176), ("Mixed_3b_b3b", 25088, 192, 32),
    ("Mixed_3c_trio", 25088, 256, 288), ("Mixed_3c_b3b", 25088, 256, 64),
    ("Mixed_4b_trio", 3136, 480, 304), ("Mixed_4b_b3b", 3136, 480, 64), ("Mixed_4c_trio", 3136, 512, 296),
    ("Mixed_4d_trio", 3136, 512, 280), ("Mixed_4e_trio", 3136, 512, 288), ("Mixed_4cde_b3b", 3136, 512, 64),
    ("Mixed_4f_trio", 3136, 528, 448), ("Mixed_4f_b3b", 3136, 528, 128), ("Mixed_5b_trio", 392, 832, 448),
    ("Mixed_5c_trio", 392, 832, 624), ("Mixed_5bc_b3b", 392, 832, 128), ("logits", 4, 1024, 174),
]
F32_TOL = 1e-5  # of the largest output: float32 sums of up to 1024 terms in another order than cuBLAS


def _f32_pw_operands(n, cin, cout, relu, use_bias, w_layout, x_offset, seed, dev):
    """X (n, cin) at ``x_offset`` elements into a larger buffer (post-ReLU
    tie data with the ReLU, signed without), W (cin, cout) row-major
    ("row") or the column-major view of a (cout, cin) weight ("col"), bias."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, generator=gen)
    x = torch.relu(torch.round(x * 2) / 2) if relu else x
    buf = torch.empty(n * cin + x_offset, device=dev)
    xd = buf[x_offset:].view(n, cin)
    xd.copy_(x.to(dev))
    wk = torch.randn(cout, cin, generator=gen) / cin**0.5
    w = wk.t().to(dev) if w_layout == "col" else wk.t().contiguous().to(dev)
    b = torch.randn(cout, generator=gen).to(dev) if use_bias else None
    return xd, w, b


def _check_f32_pw(xd, w, b, relu, tile=None):
    before = tpw.pointwise_conv_cuda.launches
    y = tpw.pointwise_conv_cuda(xd, w, b, relu, tile=tile)
    torch.cuda.synchronize()
    assert tpw.pointwise_conv_cuda.launches == before + 1 and y.dtype == torch.float32
    ref = tpw.pointwise_conv_plain(xd, w, b, relu)
    assert (y - ref).abs().max().item() <= F32_TOL * ref.abs().max().item()
    return y


@pytest.mark.parametrize("layout", ["main", "other"])
@pytest.mark.parametrize("direction", ["fwd", "dx"])
@pytest.mark.parametrize("site,n,cin,cout", PW_MAIN_PATH, ids=[r[0] for r in PW_MAIN_PATH])
def test_f32_pointwise_kernel_at_every_main_path_shape(cuda_device, site, n, cin, cout, direction, layout):
    """The float32 GEMM at I3D's 1x1x1 convs (batch 4): the forward with W
    as the layers pass it (the column-major view of the (Cout, Cin)
    weight; bias; ReLU but at the logits), dx on its transpose (row-major,
    neither); each also with W in the other layout. Within 1e-5 of the
    largest output, and both layouts give equal bits."""
    if direction == "fwd":
        args = (n, cin, cout, site != "logits", True, "col")
    else:
        args = (n, cout, cin, False, False, "row")
    relu = args[3]
    xd, w, b = _f32_pw_operands(*args, 0, 5, cuda_device)
    w_other = w.contiguous() if w.stride(0) == 1 else w.t().contiguous().t()
    y = _check_f32_pw(xd, w if layout == "main" else w_other, b, relu)
    y2 = tpw.pointwise_conv_cuda(xd, w_other if layout == "main" else w, b, relu)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)


# ragged: n below every tile, Cin and Cout not multiples of 4, rows leaving
# one partial tile of every instance (129 = 128 + 1 = 2 * 64 + 1 = ...), an
# unaligned X base (4-byte copies), the few-rows kernel at n = 1 and 16
F32_PW_RAGGED = {
    "n20": (20, 112, 48, True, True),
    "cin174_cout61": (1001, 174, 61, True, True),
    "cin61_cout174": (1001, 61, 174, False, False),
    "n129": (129, 64, 40, True, True),
    "n129_cout130": (129, 36, 130, False, True),
    "n1_logits": (1, 1024, 174, False, True),
    "n16": (16, 100, 37, True, False),
}


@pytest.mark.parametrize("x_offset", [0, 1], ids=["x_aligned", "x_offset1"])
@pytest.mark.parametrize("w_layout", ["col", "row"])
@pytest.mark.parametrize("case", sorted(F32_PW_RAGGED))
def test_f32_pointwise_kernel_at_ragged_shapes(cuda_device, case, w_layout, x_offset):
    """Ragged edges masked, no padded copies: within 1e-5 of the largest
    output, W in either layout, X aligned or not."""
    n, cin, cout, relu, use_bias = F32_PW_RAGGED[case]
    _check_f32_pw(*_f32_pw_operands(n, cin, cout, relu, use_bias, w_layout, x_offset, 6, cuda_device)[:3], relu)


@pytest.mark.parametrize("w_layout", ["col", "row"])
@pytest.mark.parametrize("shape", [(129, 174, 61), (1001, 192, 176)], ids=["ragged", "Mixed_3b_1001"])
def test_f32_every_tile_gives_the_same_bits(cuda_device, shape, w_layout):
    """Every instance (and the few-rows kernel), forced through the
    planner: within 1e-5 of the largest output and equal bits, since each
    output is one fmaf chain in K order whichever kernel computes it."""
    n, cin, cout = shape
    xd, w, b = _f32_pw_operands(n, cin, cout, True, True, w_layout, 0, 7, cuda_device)
    outs = [_check_f32_pw(xd, w, b, True, tile) for tile in ["rows", *tpw.F32_TILES]]
    assert all(torch.equal(outs[0], y) for y in outs[1:])


@pytest.mark.parametrize("n,cin,cout,relu", [(4, 1024, 174, False), (25088, 192, 176, True), (392, 832, 624, True)],
                         ids=["logits_head", "Mixed_3b_trio", "Mixed_5c_trio"])
def test_f32_pointwise_kernel_repeats_its_bits(cuda_device, n, cin, cout, relu):
    """One owner per output, no atomics: two launches give equal bits."""
    xd, w, b = _f32_pw_operands(n, cin, cout, relu, True, "col", 0, 8, cuda_device)
    y1 = tpw.pointwise_conv_cuda(xd, w, b, relu)
    y2 = tpw.pointwise_conv_cuda(xd, w, b, relu)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


# (n, cin, cout, relu, use_bias, w_layout, x_offset): w_layout "row" is a
# contiguous (Cin, Cout) W, "col" the column-major view of a (Cout, Cin)
# one; x_offset moves X's base by that many elements into a larger buffer.
BF16_PW_CASES = {
    "ragged": (150, 112, 48, True, True, "row", 0),
    "ragged_linear": (150, 112, 48, False, False, "row", 0),
    "logits_head": (4, 1024, 174, False, True, "row", 0),
    "Mixed_3b_trio": (8 * 28 * 28, 192, 176, True, True, "row", 0),
    **{f"{site}_fwd": (n, cin, cout, site != "logits", True, "col", 0) for site, n, cin, cout in PW_MAIN_PATH},
    **{f"{site}_dx": (n, cout, cin, False, False, "row", 0) for site, n, cin, cout in PW_MAIN_PATH},
    "n1": (1, 192, 176, True, True, "col", 0),
    "n63": (63, 192, 176, True, True, "col", 0),
    "n200": (200, 192, 176, True, True, "col", 0),
    "n25000_ragged": (25000, 64, 40, True, True, "row", 0),
    "cin174": (1000, 174, 64, True, True, "col", 0),
    "cout174": (1000, 64, 174, True, True, "row", 0),
    "x_unaligned": (3000, 192, 176, True, True, "col", 1),
    "x_unaligned_row_w": (3000, 192, 176, False, False, "row", 3),
    "w_col_major_k32": (3000, 32, 64, True, True, "col", 0),
}


@pytest.mark.parametrize("n,cin,cout,relu,use_bias,w_layout,x_offset", list(BF16_PW_CASES.values()),
                         ids=list(BF16_PW_CASES))
def test_bf16_pointwise_kernel_matches_plain(cuda_device, n, cin, cout, relu, use_bias, w_layout, x_offset):
    """Tensor-core (or split-K) sums in another order than the plain float32
    matmul, then one rounding each: within one bfloat16 ulp of the largest
    output, on the TMA path and the split-K path, W in either layout, X
    aligned or not."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(n, cin, generator=gen)
    x = (torch.relu(x) if relu else x).bfloat16()
    buf = torch.empty(n * cin + x_offset, dtype=torch.bfloat16, device=cuda_device)
    xd = buf[x_offset:].view(n, cin)
    xd.copy_(x.to(cuda_device))
    wk = (torch.randn(cout, cin, generator=gen) * 0.1).bfloat16()
    w = wk.t().to(cuda_device) if w_layout == "col" else wk.t().contiguous().to(cuda_device)
    b = torch.randn(cout, generator=gen).bfloat16().to(cuda_device) if use_bias else None
    assert (xd.data_ptr() % 16 == 0) == (x_offset % 8 == 0)
    before = tpw.pointwise_conv_bf16_cuda.launches
    y = tpw.pointwise_conv_bf16_cuda(xd, w, b, relu)
    torch.cuda.synchronize()
    assert tpw.pointwise_conv_bf16_cuda.launches == before + 1 and y.dtype == torch.bfloat16
    ref = tpw.pointwise_conv_plain(xd, w, b, relu).float()
    assert (y.float() - ref).abs().max().item() <= BF16_ULP * ref.abs().max().item()


@pytest.mark.parametrize("n,cin,cout,relu", [(4, 1024, 174, False), (25088, 192, 176, True)],
                         ids=["logits_head", "Mixed_3b_trio"])
def test_bf16_pointwise_kernel_repeats_its_bits(cuda_device, n, cin, cout, relu):
    """Split K sums its chunks in a fixed order and the TMA path has one
    owner per output: two launches on the same inputs give equal bits."""
    gen = torch.Generator().manual_seed(3)
    x = torch.relu(torch.randn(n, cin, generator=gen)).bfloat16().to(cuda_device)
    w = (torch.randn(cout, cin, generator=gen) * 0.1).bfloat16().to(cuda_device).t()
    b = torch.randn(cout, generator=gen).bfloat16().to(cuda_device)
    y1 = tpw.pointwise_conv_bf16_cuda(x, w, b, relu)
    y2 = tpw.pointwise_conv_bf16_cuda(x, w, b, relu)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16))


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


# the pool pair's shapes: the nine branch-3 sites at batch 2, ragged
# channels (6, 130), and T, H or W of 1 and 2
POOL_SHAPES = {
    "Mixed_3b": (2, 8, 28, 28, 192), "Mixed_3c": (2, 8, 28, 28, 256), "Mixed_4b": (2, 4, 14, 14, 480),
    "Mixed_4c": (2, 4, 14, 14, 512), "Mixed_4d": (2, 4, 14, 14, 512), "Mixed_4e": (2, 4, 14, 14, 512),
    "Mixed_4f": (2, 4, 14, 14, 528), "Mixed_5b": (2, 2, 7, 7, 832), "Mixed_5c": (2, 2, 7, 7, 832),
    "c6": (2, 3, 5, 7, 6), "c130": (1, 2, 3, 3, 130),
    "t1": (2, 1, 6, 7, 16), "t2": (2, 2, 6, 7, 16), "h1": (2, 4, 1, 9, 16), "h2": (2, 4, 2, 9, 8),
    "w1": (2, 4, 9, 1, 16), "w2": (2, 4, 9, 2, 8), "thw1": (3, 1, 1, 1, 24), "thw2_c3": (2, 2, 2, 2, 3),
}
POOL = {  # dtype -> (forward, backward, plain backward, integer view)
    "f32": (tpool.maxpool3d_s1_fwd_cuda, tpool.maxpool3d_s1_bwd_cuda, tpool.maxpool3d_s1_bwd_plain, torch.int32),
    "bf16": (tpool.maxpool3d_s1_fwd_bf16_cuda, tpool.maxpool3d_s1_bwd_bf16_cuda,
             tpool.maxpool3d_s1_bwd_bf16_plain, torch.int16),
}


def _pool_data(shape, seed, dtype, dev):
    """Tied halves in [-2, 2], a third of them post-ReLU zeros; channel 1 a
    negative plateau (the zero pad wins its border windows); -0.0
    scattered; a cotangent with tied magnitudes."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(shape, generator=gen) * 2).clamp(-4, 4) / 2
    x = torch.where(torch.rand(shape, generator=gen) < 0.3, torch.relu(x), x)
    if shape[-1] > 1:
        x[..., 1] = -1.5
    x[torch.rand(shape, generator=gen) < 0.05] = -0.0
    g = torch.round(torch.randn(shape, generator=gen) * 8) / 4
    return x.to(dtype).to(dev), g.to(dtype).to(dev)


def _check_pool(dt, x, g, tile=None):
    """Both kernels against the plain versions, bit for bit (int views:
    NaN payloads and the sign of zero included); each launches once."""
    fwd, bwd, plain_bwd, iview = POOL[dt]
    before = (fwd.launches, bwd.launches)
    y = fwd(x, tile)
    dx = bwd(x, y, g, tile)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    y_ref = tpool.maxpool3d_s1_fwd_plain(x)
    assert torch.equal(y.view(iview), y_ref.view(iview))
    assert torch.equal(dx.view(iview), plain_bwd(x, y_ref, g).view(iview))
    return y, dx


def _dtype(dt):
    return torch.bfloat16 if dt == "bf16" else torch.float32


@pytest.mark.parametrize("case", list(POOL_SHAPES))
@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_kernels_give_the_plain_bits(cuda_device, dt, case):
    """The planned instance (16-byte vectors where C allows, else the
    ragged one) at the nine branch-3 sites and ragged shapes."""
    x, g = _pool_data(POOL_SHAPES[case], 2, _dtype(dt), cuda_device)
    _check_pool(dt, x, g)


POOL_TILES = {  # forced plans: (shape, (vw, v, th, tw)), vw 0 the dtype's vector width
    "vec_v1": ((2, 5, 9, 10, 16), (0, 1, 4, 3)),
    "vec_v2_t7": ((1, 7, 9, 10, 16), (0, 2, 2, 5)),
    "vec_wide_strip": ((2, 4, 3, 30, 64), (0, 4, 1, 30)),
    "vec_one_position": ((2, 4, 5, 6, 64), (0, 8, 1, 1)),
    "vec_Mixed_5b_tile_past_edge": ((2, 2, 7, 7, 832), (0, 4, 4, 8)),
    "ragged_on_aligned_Mixed_4b": ((2, 4, 14, 14, 480), (1, 16, 2, 4)),
    "ragged_3x3": ((2, 5, 9, 10, 16), (1, 16, 3, 3)),
}


@pytest.mark.parametrize("case", sorted(POOL_TILES))
@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_every_instance_gives_the_plain_bits(cuda_device, dt, case):
    """Each instance (a 16-byte vector a thread, the ragged 1 channel)
    under tiles the planner would not pick: one-vector chunks, strips, one
    position, tiles past the volume's edge, the ragged instance on aligned
    data."""
    shape, (vw, v, th, tw) = POOL_TILES[case]
    x, g = _pool_data(shape, 3, _dtype(dt), cuda_device)
    _check_pool(dt, x, g, tap.tile_plan(vw or (8 if dt == "bf16" else 4), v, th, tw))


@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_misaligned_operands_take_the_ragged_instance(cuda_device, dt):
    """Bases one element past a 16-byte boundary: the plan falls back to 1
    channel a thread (no fallback to the plain version), same bits."""
    shape = (2, 4, 9, 10, 16)
    x, g = _pool_data(shape, 4, _dtype(dt), cuda_device)
    xs, gs = (torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)[1:].view(shape) for t in (x, g))
    xs.copy_(x)
    gs.copy_(g)
    assert xs.data_ptr() % 16 != 0 and xs.is_contiguous()
    _check_pool(dt, xs, gs)


@pytest.mark.parametrize("tile", [None, (1, 8, 4, 5)], ids=["planned", "ragged_instance"])
@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_kernels_keep_nan_inf_and_signed_zero_bits(cuda_device, dt, tile):
    """+-0, NaN and +-inf in x, inf and NaN in g: the forward selects the
    plain version's element (the last NaN, else the first maximum, the
    sign of zero included), and an unselected inf or NaN cotangent adds
    +0 (a select, not a multiply); bits compared as int views."""
    shape = (2, 3, 5, 7, 8)
    x, g = _pool_data(shape, 5, torch.float32, "cpu")
    xf, gf = x.view(-1), g.view(-1)
    n = xf.numel()
    xf[n // 5] = xf[n // 3] = float("nan")
    xf[n // 2], xf[2 * n // 3] = float("inf"), float("-inf")
    gf[n // 7], gf[n // 4], gf[3 * n // 4] = float("inf"), float("nan"), float("-inf")
    gf[torch.rand(n, generator=torch.Generator().manual_seed(9)) < 0.05] = -0.0
    x, g = x.to(_dtype(dt)).to(cuda_device), g.to(_dtype(dt)).to(cuda_device)
    y, dx = _check_pool(dt, x, g, tile and tap.tile_plan(*tile))
    assert torch.isnan(y.float()).any() and not torch.isfinite(dx.float()).all()


@pytest.mark.parametrize("tile", [None, (1, 8, 4, 5)], ids=["planned", "ragged_instance"])
@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_backward_keeps_subnormals(cuda_device, dt, tile):
    """A subnormal cotangent (+-1e-39) is added, not flushed to zero."""
    shape = (1, 3, 4, 5, 8)
    x, _ = _pool_data(shape, 6, _dtype(dt), cuda_device)
    sign = torch.sign(torch.randn(shape, generator=torch.Generator().manual_seed(7)))
    g = (sign * 1e-39).to(_dtype(dt)).to(cuda_device)
    _, dx = _check_pool(dt, x, g, tile and tap.tile_plan(*tile))
    assert dx.float().abs().max().item() > 0


@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_kernels_compare_subnormal_values_exactly(cuda_device, dt):
    """x drawn from +-1e-39, 2e-39 (subnormal in both dtypes), +-0 and -1:
    window maxima are subnormals or zeros, which the kernels' compares keep
    apart (no flush to zero), as the plain version's do."""
    shape = (2, 3, 6, 7, 16)
    gen = torch.Generator().manual_seed(10)
    values = torch.tensor([-1e-39, 1e-39, 2e-39, -0.0, 0.0, -1.0])
    x = values[torch.randint(0, len(values), shape, generator=gen)]
    g = torch.round(torch.randn(shape, generator=gen) * 8) / 4
    _check_pool(dt, x.to(_dtype(dt)).to(cuda_device), g.to(_dtype(dt)).to(cuda_device))


@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_kernels_repeat_their_bits(cuda_device, dt):
    """Two runs of each kernel on the same inputs: equal bits (no atomics)."""
    fwd, bwd, _, iview = POOL[dt]
    x, g = _pool_data(POOL_SHAPES["Mixed_3b"], 7, _dtype(dt), cuda_device)
    y1, y2 = fwd(x), fwd(x)
    d1, d2 = bwd(x, y1, g), bwd(x, y1, g)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(iview), y2.view(iview)) and torch.equal(d1.view(iview), d2.view(iview))


@pytest.mark.parametrize("dt", sorted(POOL))
def test_maxpool_wrappers_raise_on_tiles_the_kernels_refuse(cuda_device, dt):
    """A tile or an alignment that no instance takes raises; it is never
    handed to the plain version."""
    fwd, bwd, _, _ = POOL[dt]
    vec = 8 if dt == "bf16" else 4
    x, g = _pool_data((1, 2, 3, 3, 16), 8, _dtype(dt), cuda_device)
    with pytest.raises(RuntimeError):  # C % vec != 0 with a vector a thread
        fwd(x[..., : vec // 2 * 3].contiguous(), tap.Plan(vec, 1, 3, 3, 32))
    with pytest.raises(RuntimeError):  # too few threads for the tile
        bwd(x, x, g, tap.Plan(1, 16, 3, 3, 32))
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)[1:].view(x.shape)
    xs.copy_(x)
    with pytest.raises(RuntimeError):  # a misaligned base under a vector tile
        fwd(xs, tap.Plan(vec, 1, 3, 3, 32))


# the argmax pair's shapes: the nine branch-3 sites at batch 4, Mixed_3b at
# 128 clips, ragged channels, and T, H or W of 1 and 2
ARGMAX_SHAPES = {
    "Mixed_3b": (4, 8, 28, 28, 192), "Mixed_3c": (4, 8, 28, 28, 256), "Mixed_4b": (4, 4, 14, 14, 480),
    "Mixed_4c": (4, 4, 14, 14, 512), "Mixed_4d": (4, 4, 14, 14, 512), "Mixed_4e": (4, 4, 14, 14, 512),
    "Mixed_4f": (4, 4, 14, 14, 528), "Mixed_5b": (4, 2, 7, 7, 832), "Mixed_5c": (4, 2, 7, 7, 832),
    "Mixed_3b_b128": (128, 8, 28, 28, 192),
    "c1": (2, 3, 5, 7, 1), "c3": (1, 3, 5, 7, 3), "c9": (2, 4, 6, 5, 9), "c17": (1, 3, 9, 10, 17),
    "t1": (2, 1, 6, 7, 16), "t2": (2, 2, 6, 7, 16), "h1": (2, 4, 1, 9, 16), "h2": (2, 4, 2, 9, 8),
    "w1": (2, 4, 9, 1, 16), "w2": (2, 4, 9, 2, 8), "thw1": (3, 1, 1, 1, 24), "thw2_c3": (2, 2, 2, 2, 3),
}


def _argmax_data(shape, seed, dev):
    """Tied halves in [-2, 2]; channel 1 a negative plateau (the zero pad
    wins its border windows); -0.0 scattered (it loses to the pad's +0.0);
    a cotangent with tied magnitudes."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.round(torch.randn(shape, generator=gen) * 2).clamp(-4, 4) / 2
    if shape[-1] > 1:
        x[..., 1] = -1.5
    x = x.bfloat16()
    x.view(torch.int16)[torch.rand(shape, generator=gen) < 0.05] = -32768  # -0.0
    g = (torch.randn(shape, generator=gen) * 3.3).bfloat16()
    return x.to(dev), g.to(dev)


def _nan_aware_equal(a, b):
    """Equal bits where neither is NaN, and NaN at the same elements."""
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    return bool(torch.equal(na, nb)) and bool(torch.equal(a.view(torch.int16)[~na], b.view(torch.int16)[~nb]))


def _check_argmax(x, g, tile=None):
    y, idx = tap.argmax_pool_fwd_cuda(x, tile)
    dx = tap.argmax_pool_bwd_cuda(idx, g, tile)
    torch.cuda.synchronize()
    y_ref, idx_ref = tap.argmax_pool_fwd_plain(x)
    assert torch.equal(y.view(torch.int16), y_ref.view(torch.int16))
    assert torch.equal(idx, idx_ref)
    assert _nan_aware_equal(dx, tap.argmax_pool_bwd_plain(idx_ref, g))
    return y, idx, dx


@pytest.mark.parametrize("shape", list(ARGMAX_SHAPES.values()), ids=list(ARGMAX_SHAPES))
def test_argmax_pool_kernels_match_plain_bits(cuda_device, shape):
    """Forward (y and the index plane) and backward: equal bits, on tied
    halves with a negative plateau where the zero pad wins and -0.0 that
    loses to it, at the planned instance."""
    x, g = _argmax_data(shape, 2, cuda_device)
    _check_argmax(x, g)


ARGMAX_TILES = {  # forced plans: (shape, (vw, v, th, tw)); the ragged instance on aligned data too
    "vw1_Mixed_4b": ((2, 4, 14, 14, 480), (1, 16, 2, 4)),
    "vw1_3x3": ((2, 5, 9, 10, 16), (1, 16, 3, 3)),
    "vw8_v1": ((2, 5, 9, 10, 16), (8, 1, 4, 3)),
    "vw8_v2_t7": ((1, 7, 9, 10, 16), (8, 2, 2, 5)),
    "vw8_wide_strip": ((2, 4, 3, 30, 64), (8, 4, 1, 30)),
    "vw8_one_position": ((2, 4, 5, 6, 64), (8, 8, 1, 1)),
    "vw8_Mixed_3b_4x7": ((2, 8, 28, 28, 192), (8, 8, 4, 7)),
    "vw8_Mixed_5b_tile_past_edge": ((2, 2, 7, 7, 832), (8, 4, 4, 8)),
}


@pytest.mark.parametrize("case", sorted(ARGMAX_TILES))
def test_argmax_pool_every_instance_gives_the_plain_bits(cuda_device, case):
    """Each instance (8 channels a thread, the ragged 1) under tiles the
    planner would not pick: one-vector chunks, one-position and strip
    tiles, tiles past the volume's edge."""
    shape, tile = ARGMAX_TILES[case]
    x, g = _argmax_data(shape, 3, cuda_device)
    _check_argmax(x, g, tap.tile_plan(*tile))


def test_argmax_pool_misaligned_operands_take_the_ragged_instance(cuda_device):
    """A base one element past a 16-byte boundary: the plan falls back to 1
    channel a thread (no fallback to the plain version), same bits."""
    shape = (2, 4, 9, 10, 16)
    x, g = _argmax_data(shape, 4, cuda_device)
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)[1:].view(shape)
    gs = torch.empty(g.numel() + 1, dtype=g.dtype, device=cuda_device)[1:].view(shape)
    xs.copy_(x)
    gs.copy_(g)
    assert xs.data_ptr() % 16 != 0 and xs.is_contiguous()
    before = (tap.argmax_pool_fwd_cuda.launches, tap.argmax_pool_bwd_cuda.launches)
    _check_argmax(xs, gs)
    assert (tap.argmax_pool_fwd_cuda.launches, tap.argmax_pool_bwd_cuda.launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("shape", [(1, 3, 4, 5, 8), (2, 4, 14, 14, 480), (1, 3, 4, 5, 3)],
                         ids=["small", "Mixed_4b", "ragged"])
def test_argmax_pool_backward_nan_and_inf_cotangents(cuda_device, shape):
    """inf and NaN in g: an unselected inf or NaN still gives NaN (g times
    a 0.0 mask), as the plain version does; compared NaN-aware."""
    x, g = _argmax_data(shape, 5, cuda_device)
    g = g.clone()
    g[0, 1, 2, 3, 0] = float("inf")
    g[0, 0, 1, 1, -1] = float("nan")
    g[-1, -1, -1, 0, 0] = float("-inf")
    _, _, dx = _check_argmax(x, g)
    assert torch.isnan(dx.float()).sum().item() > 0


@pytest.mark.parametrize("tile", [None, (1, 8, 4, 5)], ids=["planned", "ragged_instance"])
def test_argmax_pool_backward_keeps_subnormals(cuda_device, tile):
    """A subnormal cotangent (1e-39) is added, not flushed to zero: the
    kernel is held to the port's plain version (XLA's CPU backend flushes
    it, see tests/test_torch_bf16.py)."""
    shape = (1, 3, 4, 5, 8)
    x, _ = _argmax_data(shape, 6, cuda_device)
    g = torch.full(shape, 1e-39, dtype=torch.bfloat16, device=cuda_device)
    _, _, dx = _check_argmax(x, g, tile and tap.tile_plan(*tile))
    assert dx.float().abs().max().item() > 0


@pytest.mark.parametrize("shape", [ARGMAX_SHAPES["Mixed_3b"], ARGMAX_SHAPES["c17"]], ids=["Mixed_3b", "c17"])
def test_argmax_pool_kernels_repeat_their_bits(cuda_device, shape):
    """Two runs of each kernel on the same inputs: equal bits (no atomics)."""
    x, g = _argmax_data(shape, 7, cuda_device)
    y1, i1 = tap.argmax_pool_fwd_cuda(x)
    y2, i2 = tap.argmax_pool_fwd_cuda(x)
    d1 = tap.argmax_pool_bwd_cuda(i1, g)
    d2 = tap.argmax_pool_bwd_cuda(i1, g)
    torch.cuda.synchronize()
    assert torch.equal(y1.view(torch.int16), y2.view(torch.int16)) and torch.equal(i1, i2)
    assert torch.equal(d1.view(torch.int16), d2.view(torch.int16))


def test_bf16_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.zeros(1, 2, 3, 3, 4, device=cuda_device)
    with pytest.raises(TypeError):
        tap.argmax_pool_fwd_cuda(x)  # float32
    with pytest.raises(RuntimeError):  # a tile the kernel refuses: raised, not run on the plain version
        tap.argmax_pool_fwd_cuda(x.bfloat16(), (8, 1, 3, 3, 32))  # C % 8 != 0 with 8 channels a thread
    with pytest.raises(RuntimeError):
        tap.argmax_pool_bwd_cuda(torch.zeros(x.shape, dtype=torch.uint8, device=cuda_device), x.bfloat16(),
                                 (1, 4, 3, 3, 32))  # too few threads for the tile
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
    tm, gc = api.find_masks(cfg, None, SyntheticClips(2, t=16, hw=224, num_classes=5), save_viz=False)
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


@pytest.mark.parametrize("with_gh", [True, False], ids=["split", "merged"])
@pytest.mark.parametrize("shape,ch", [((3, 7, 9), 5), ((16, 60, 80), 4)], ids=["ragged", "clstm_kth_layer1"])
def test_bf16_gate_kernels_match_plain(cuda_device, shape, ch, with_gh):
    """bfloat16 gates, float32 state. The kernels round where the plain
    versions do and use the same float32 operations in the same order,
    so h', c' and dc are held within 1e-6 of max(1, their largest
    magnitude) and dz (bf16) within one bfloat16 ulp of its largest."""
    gen = torch.Generator().manual_seed(4)
    gx, gh = ((torch.randn(*shape, 4 * ch, generator=gen) * 3).bfloat16().to(cuda_device) for _ in range(2))
    c, dh, dc_out = (torch.randn(*shape, ch, generator=gen).to(cuda_device) for _ in range(3))
    gh = gh if with_gh else None
    fwd, bwd = tgates.lstm_gates_fwd_bf16_cuda, tgates.lstm_gates_bwd_bf16_cuda
    before = (fwd.launches, bwd.launches, tgates.lstm_gates_fwd_cuda.launches)
    h_new, c_new = fwd(gx, gh, c)
    dz, dc = bwd(gx, gh, c, dh, dc_out)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches, tgates.lstm_gates_fwd_cuda.launches) == (
        before[0] + 1, before[1] + 1, before[2]
    )
    assert h_new.dtype == c_new.dtype == dc.dtype == torch.float32 and dz.dtype == torch.bfloat16
    h_ref, c_ref = tgates.gate_math_plain(gx, gh, c)
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
    for got, ref in ((h_new, h_ref), (c_new, c_ref), (dc, dc_ref)):
        assert (got - ref).abs().max().item() <= 1e-6 * max(1.0, ref.abs().max().item())
    assert (dz.float() - dz_ref.float()).abs().max().item() <= BF16_ULP * dz_ref.float().abs().max().item()


FUSED_BF16 = {
    "frame": (tfb.fused_pool_conv_fwd_bf16_cuda, tfb.fused_pool_conv_bwd_bf16_cuda),
    "tblock": (tfb.fused_pool_conv_tblock_fwd_bf16_cuda, tfb.fused_pool_conv_tblock_bwd_bf16_cuda),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
@pytest.mark.parametrize("variant", sorted(FUSED_BF16))
def test_bf16_fused_branch3_kernels_match_plain(cuda_device, variant, case):
    """bf16 x, w, b: float32 sums in another order than the plain matmul,
    one rounding each, so y and dx are held within one bfloat16 ulp of
    their largest magnitude; a second launch gives equal bits; the
    float32 entries' counters do not move."""
    fwd, bwd = FUSED_BF16[variant]
    shape, cout = FUSED_CASES[case]
    for relu in (True, False):
        x, w, b, g = _fused_inputs(shape, cout, relu, 5, torch.bfloat16)
        f32 = FUSED[variant]
        before = (fwd.launches, bwd.launches, f32[0].launches, f32[1].launches)
        y = fwd(x, w, b, relu)
        dx = bwd(x, y, g, w, relu)
        torch.cuda.synchronize()
        assert (fwd.launches, bwd.launches, f32[0].launches, f32[1].launches) == (
            before[0] + 1, before[1] + 1, before[2], before[3]
        )
        assert y.dtype == dx.dtype == torch.bfloat16
        y_ref = tfb.fused_pool_conv_plain(x, w, b, relu).float()
        dx_ref = tfb.fused_pool_conv_bwd_plain(x, y, g, w, relu).float()
        assert (y.float() - y_ref).abs().max().item() <= BF16_ULP * y_ref.abs().max().item()
        assert (dx.float() - dx_ref).abs().max().item() <= BF16_ULP * dx_ref.abs().max().item()
        y2, dx2 = fwd(x, w, b, relu), bwd(x, y, g, w, relu)
        assert torch.equal(y2.view(torch.int16), y.view(torch.int16))
        assert torch.equal(dx2.view(torch.int16), dx.view(torch.int16))


def test_bf16_entries_raise_on_what_they_do_not_take(cuda_device):
    c = torch.zeros(2, 5, 4, device=cuda_device)
    gx = torch.zeros(2, 5, 16, device=cuda_device)
    with pytest.raises(TypeError):
        tgates.lstm_gates_fwd_bf16_cuda(gx, None, c)  # float32 gates
    with pytest.raises(TypeError):
        tgates.lstm_gates_fwd_bf16_cuda(gx.bfloat16(), None, c.bfloat16())  # bf16 state
    with pytest.raises(TypeError):
        tgates.gate_math(gx.bfloat16(), None, c.half())  # no JAX path gives a float16 state
    with pytest.raises(TypeError):
        tgates.lstm_gates_fwd_bf16s_cuda(gx.bfloat16(), None, c)  # float32 state
    x = torch.zeros(1, 2, 3, 3, 4, device=cuda_device)
    w, b = torch.zeros(4, 3, device=cuda_device), torch.zeros(3, device=cuda_device)
    with pytest.raises(TypeError):
        tfb.fused_pool_conv_tblock_fwd_bf16_cuda(x, w, b, True)  # float32
    with pytest.raises(TypeError):
        tfb.fused_pool_conv_fwd_bf16_cuda(x.bfloat16(), w, b, True)  # mixed dtypes


@pytest.mark.parametrize("variant", [True, "tblock"], ids=["frame", "tblock"])
def test_bf16_fused_find_masks_goes_through_its_kernels_and_repeats_its_bits(
    cuda_device, tmp_path, variant
):
    """bfloat16 with the fused branch 3: the bf16 fused entries and the bf16
    pointwise GEMM run, no argmax, pool or float32 kernel; two runs give
    equal bits."""
    name = "tblock" if variant == "tblock" else "frame"
    on = (*FUSED_BF16[name], tpw.pointwise_conv_bf16_cuda)
    off = (
        tap.argmax_pool_fwd_cuda, tap.argmax_pool_bwd_cuda, tpool.maxpool3d_s1_fwd_bf16_cuda,
        tpool.maxpool3d_s1_bwd_bf16_cuda, tpool.maxpool3d_s1_fwd_cuda, tpw.pointwise_conv_cuda,
        *FUSED["frame"], *FUSED["tblock"],
    )
    for fn in on + off:
        fn.launches = 0
    flags = dict(compute_dtype="bfloat16", use_pallas=True, fuse_pool_conv=variant)
    first = _small_find_masks(tmp_path, "first", **flags)
    assert all(fn.launches > 0 for fn in on) and not any(fn.launches for fn in off)
    second = _small_find_masks(tmp_path, "second", **flags)
    assert np.isfinite(first[0]).all() and first[1].shape == (2, 16, 224, 224)
    assert np.array_equal(first[0], second[0]) and np.array_equal(first[1], second[1])


def test_bf16_clstm_find_masks_goes_through_the_bf16_gate_kernels(cuda_device, tmp_path):
    """bfloat16 clstm_kth with the gate kernel: the bf16 entries run and the
    float32 ones do not; two runs give equal bits."""
    cfg = Config()
    cfg.output_dir = str(tmp_path)
    cfg.model.conv_model = "clstm_kth"
    cfg.model.num_classes = 6
    cfg.model.clstm_hidden, cfg.model.clstm_layers, cfg.model.conv_stride = 4, 2, 2
    cfg.model.use_pallas, cfg.model.compute_dtype = True, "bfloat16"
    cfg.data.clip_size, cfg.data.input_spatial_size, cfg.data.batch_size = 8, (32, 48), 2
    cfg.mask.opt_iter = 2
    bf16 = (tgates.lstm_gates_fwd_bf16_cuda, tgates.lstm_gates_bwd_bf16_cuda)
    f32 = (tgates.lstm_gates_fwd_cuda, tgates.lstm_gates_bwd_cuda)
    for fn in bf16 + f32:
        fn.launches = 0
    rng = np.random.RandomState(0)
    clips = [(rng.randint(0, 255, (8, 32, 48, 3)).astype(np.uint8), i, f"c{i}") for i in range(2)]
    runs = [api.find_masks(cfg, None, clips, save_viz=False) for _ in range(2)]
    assert all(fn.launches > 0 for fn in bf16) and not any(fn.launches for fn in f32)
    masks = [np.stack([r["time_mask"] for r in tm]) for tm, _ in runs]
    cams = [np.stack([r["GCHeatMap"] for r in gc]) for _, gc in runs]
    assert np.isfinite(masks[0]).all() and cams[0].shape == (2, 8, 32, 48)
    assert np.array_equal(masks[0], masks[1]) and np.array_equal(cams[0], cams[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_s2d_stem_matches_the_plain_stem_and_repeats_its_bits(cuda_device, dtype):
    """The space-to-depth stem against the plain stem (7x7x7 stride 2,
    polyphase input gradient) at the stem's full shape, batch 2, inside the
    entry points' numerics pin: forward and input gradient within the CPU
    tests' tolerances (float32 1e-5, bfloat16 2**-7 of the largest
    magnitude, tests/test_torch_stem.py), and equal bits from two runs."""
    from ivf_tpu_torch import precision
    from ivf_tpu_torch.ops import conv

    gen = torch.Generator().manual_seed(4)
    w = (torch.randn(64, 3, 7, 7, 7, generator=gen) * 0.03).to(cuda_device, dtype)
    b = (torch.randn(64, generator=gen) * 0.1).to(cuda_device, dtype)
    x = torch.randint(0, 256, (2, 16, 224, 224, 3), generator=gen).float().to(cuda_device)
    g = torch.randn(2, 8, 112, 112, 64, generator=gen).to(cuda_device, dtype)
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}[dtype]

    def run(fn):
        xr = x.clone().requires_grad_(True)
        with precision.reference_numerics():
            y = fn(xr)
            (dx,) = torch.autograd.grad(y, xr, g)
        return y.detach(), dx

    s2d = lambda a: conv.conv3d_stem_s2d(a, w, b)  # noqa: E731
    first, second = run(s2d), run(s2d)
    plain = run(lambda a: conv.conv3d_same(a, w, (2, 2, 2), b))
    for p, q, ref in zip(first, second, plain):
        assert torch.equal(p, q)
        assert ((p.float() - ref.float()).abs().max() / ref.float().abs().max()).item() <= tol


def test_refill_on_equals_off_at_a_small_size(cuda_device):
    """``chip_smoke.py``'s refill phase at 4 clips in batches of 2 and 6
    steps (segments of 2) on the bfloat16 kernel route: refill on and off
    give equal bits per clip, the chunked search without refill those of
    the monolithic one, refill re-stages rows, and the stop steps agree."""
    import chip_smoke as cs

    failures = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cs, "REFILL_CLIPS", 4)
        mp.setattr(cs, "REFILL_BATCH", 2)
        mp.setattr(cs, "REFILL_STEPS", 6)
        weights = cs._scaled_weights(Config(), api)
        cs.phase_refill(api, cs.launch_counters(), failures, "test", weights)
    assert not failures, failures


@pytest.mark.parametrize("init", ["central", "random"])
def test_resumed_find_masks_gives_the_uninterrupted_bits(cuda_device, tmp_path, init):
    """``find_masks`` on the bfloat16 kernel route (5 classes, 16x224x224,
    6 clips in batches of 2, 3 steps, central or random init), interrupted
    after one loader batch and resumed: each clip the
    bits of the uninterrupted run, only the rest searched, and the kernels
    launched on the resumed run."""
    kernels = (tpw.pointwise_conv_bf16_cuda, tpool.maxpool3d_s1_fwd_bf16_cuda, tpool.maxpool3d_s1_bwd_bf16_cuda)
    dataset = SyntheticClips(6, t=16, hw=224, num_classes=5)
    runs = {}
    for name, kwargs in (("base", {}), ("part", dict(max_batches=1)), ("part", dict(resume=True))):
        cfg = Config()
        cfg.output_dir, cfg.model_name = str(tmp_path), name
        cfg.model.num_classes = 5
        cfg.model.compute_dtype, cfg.model.use_pallas, cfg.model.pallas_pool = "bfloat16", True, True
        cfg.mask.opt_iter, cfg.mask.mask_init_type = 3, init
        cfg.data.batch_size = 2
        for fn in kernels:
            fn.launches = 0
        stats = {}
        tm, gc = api.find_masks(cfg, None, dataset, stats=stats, save_viz=False, **kwargs)
        runs[name] = ({r["video_id"]: r for r in tm}, {r["video_id"]: r for r in gc}, stats)
    (tm0, gc0, _), (tm1, gc1, st) = runs["base"], runs["part"]
    assert (st["resumed_clips"], st["searched_rows"], st["score_launches"]) == (2, 4, 2), st
    assert all(fn.launches > 0 for fn in kernels)
    assert set(tm0) == set(tm1) == set(gc0) == set(gc1) and len(tm0) == 6
    for vid in tm0:
        for key, value in tm0[vid].items():
            assert np.array_equal(value, tm1[vid][key]) if isinstance(value, np.ndarray) else value == tm1[vid][key]
        assert np.array_equal(gc0[vid]["GCHeatMap"], gc1[vid]["GCHeatMap"]), vid


# the training path's 1x1x1 convs at batch 16 (site, N, Cin, Cout): BN
# unfolded, so the kernel runs with no bias and no ReLU (the trunk), the
# logits head with its bias
PW_TRAIN = [
    ("Conv3d_2b", 401408, 64, 64, False), ("Mixed_3b_b1a", 100352, 192, 96, False),
    ("Mixed_4b_b0", 12544, 480, 192, False), ("Mixed_5c_b0", 1568, 832, 384, False),
    ("logits", 16, 1024, 174, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("site,n,cin,cout,use_bias", PW_TRAIN, ids=[r[0] for r in PW_TRAIN])
def test_training_pointwise_conv_matches_plain(cuda_device, site, n, cin, cout, use_bias, dtype):
    """The pointwise conv as a training step calls it (``pointwise_conv`` on
    the column-major view of a (Cout, Cin) weight, ``relu=False``):
    forward and ``dx`` through the kernel (one launch each), ``dW`` (and
    ``db``) as plain products. y and dx within 1e-5 (f32) / one bf16 ulp
    of their largest value of the plain version; dW and db within 1e-4 of
    their largest value of a float64 product (float32 sums over up to
    401,408 rows)."""
    from ivf_tpu_torch.precision import reference_numerics

    gen = torch.Generator().manual_seed(7)
    x = torch.randn(n, cin, generator=gen).to(dtype).to(cuda_device)
    weight = (torch.randn(cout, cin, generator=gen) / cin**0.5).to(dtype).to(cuda_device).requires_grad_(True)
    bias = torch.randn(cout, generator=gen).to(dtype).to(cuda_device).requires_grad_(True) if use_bias else None
    g = torch.randn(n, cout, generator=gen).to(dtype).to(cuda_device)
    xr = x.clone().requires_grad_(True)
    counter = tpw.pointwise_conv_bf16_cuda if dtype == torch.bfloat16 else tpw.pointwise_conv_cuda
    before = counter.launches
    with reference_numerics():
        y = tpw.pointwise_conv(xr, weight.t(), bias, relu=False)
        grads = torch.autograd.grad(y, [xr, weight] + ([bias] if use_bias else []), g)
        torch.cuda.synchronize()
        assert counter.launches == before + 2
        y_ref = tpw.pointwise_conv_plain(x, weight.detach().t().contiguous(), bias, False)
        dx_ref = tpw.pointwise_conv_plain(g, weight.detach(), None, False)
    tol = 1e-5 if dtype == torch.float32 else BF16_ULP
    for got, ref in ((y, y_ref), (grads[0], dx_ref)):
        assert (got.float() - ref.float()).abs().max().item() <= tol * ref.float().abs().max().item()
    tol_w = 1e-4 if dtype == torch.float32 else BF16_ULP
    dw_ref = (g.double().t() @ x.double())
    assert (grads[1].double() - dw_ref).abs().max().item() <= tol_w * dw_ref.abs().max().item()
    if use_bias:
        db_ref = g.double().sum(0)
        assert (grads[2].double() - db_ref).abs().max().item() <= tol_w * db_ref.abs().max().item()


@pytest.mark.parametrize("gates", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 60, 80), (16, 15, 20)], ids=["layer1", "layer2"])
def test_training_gate_vjp_matches_plain(cuda_device, shape, gates):
    """The gate block as ``config_clstm_kth``'s training step calls it
    (``gate_math`` under autograd, the x- and h-gates merged, 16 clips,
    4 hidden units a layer): one forward and one backward launch; h', c'
    and the gradients of the gates and of c against the plain versions,
    within 1e-6 of max(1, their largest magnitude), bf16 dz within one
    bf16 ulp of its largest."""
    gen = torch.Generator().manual_seed(9)
    z = (torch.randn(*shape, 16, generator=gen) * 3).to(gates).to(cuda_device).requires_grad_(True)
    c = torch.randn(*shape, 4, generator=gen).to(cuda_device).requires_grad_(True)
    dh, dc_out = (torch.randn(*shape, 4, generator=gen).to(cuda_device) for _ in range(2))
    fwd, bwd = ((tgates.lstm_gates_fwd_bf16_cuda, tgates.lstm_gates_bwd_bf16_cuda) if gates == torch.bfloat16
                else (tgates.lstm_gates_fwd_cuda, tgates.lstm_gates_bwd_cuda))
    before = (fwd.launches, bwd.launches)
    h_new, c_new = tgates.gate_math(z, None, c)
    dz, dc = torch.autograd.grad((h_new, c_new), (z, c), (dh, dc_out))
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    h_ref, c_ref = tgates.gate_math_plain(z.detach(), None, c.detach())
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(z.detach(), None, c.detach(), dh, dc_out)
    for got, ref in ((h_new, h_ref), (c_new, c_ref), (dc, dc_ref)):
        assert (got.detach() - ref).abs().max().item() <= 1e-6 * max(1.0, ref.abs().max().item())
    tol = BF16_ULP if gates == torch.bfloat16 else 1e-6
    assert (dz.float() - dz_ref.float()).abs().max().item() <= tol * max(1.0, dz_ref.float().abs().max().item())


ALL_BF16_GATE_SHAPES = {  # (leading shape, Ch, gates_h, element offset of every operand)
    "layer1": ((16, 60, 80), 4, True, 0),  # clstm_kth training, stride 2: x- and h-gates apart
    "layer2": ((16, 15, 20), 4, True, 0),
    "layer1_merged": ((16, 60, 80), 4, False, 0),
    "ch8": ((3, 7, 9), 8, True, 0),
    "ragged_ch": ((3, 7, 9), 5, True, 0),
    "odd_rows": ((3, 7), 4, True, 0),
    "misaligned": ((4, 6, 8), 4, True, 1),  # every base one element off 4-byte alignment
}


@pytest.mark.parametrize("case", list(ALL_BF16_GATE_SHAPES))
def test_all_bf16_gate_kernels_match_plain(cuda_device, case):
    """The all-bfloat16 pair (the bf16 train step's state is bf16) under
    autograd, as ``gate_math`` runs it in training: one launch each way,
    no other gate entry; h', c', dz and dc against the plain versions,
    which round every op as XLA does. Both sides run the same float32
    operations (the same CUDA ``expf`` / ``tanhf``) rounded at the same
    points, so every output is held bit for bit, and a second launch
    repeats the bits."""
    lead, ch, with_gh, off = ALL_BF16_GATE_SHAPES[case]
    gen = torch.Generator().manual_seed(13)

    def operand(width, scale):
        n = int(np.prod(lead)) * width
        flat = (torch.randn(n + off, generator=gen) * scale).bfloat16().to(cuda_device)
        return flat[off:].view(*lead, width)

    gx = operand(4 * ch, 3).requires_grad_(True)
    gh = operand(4 * ch, 2).requires_grad_(True) if with_gh else None
    c = operand(ch, 2).requires_grad_(True)
    dh, dc_out = operand(ch, 1), operand(ch, 1)
    fwd, bwd = tgates.lstm_gates_fwd_bf16s_cuda, tgates.lstm_gates_bwd_bf16s_cuda
    others = (tgates.lstm_gates_fwd_cuda, tgates.lstm_gates_bwd_cuda, tgates.lstm_gates_fwd_bf16_cuda,
              tgates.lstm_gates_bwd_bf16_cuda)
    before = [fn.launches for fn in (fwd, bwd, *others)]
    h_new, c_new = tgates.gate_math(gx, gh, c)
    inputs = [gx, c] + ([gh] if with_gh else [])
    grads = torch.autograd.grad((h_new, c_new), inputs, (dh, dc_out))
    torch.cuda.synchronize()
    assert [fn.launches for fn in (fwd, bwd, *others)] == [before[0] + 1, before[1] + 1, *before[2:]]
    assert all(t.dtype == torch.bfloat16 for t in (h_new, c_new, *grads))
    h_ref, c_ref = tgates.gate_math_plain(gx.detach(), None if gh is None else gh.detach(), c.detach())
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(gx.detach(), None if gh is None else gh.detach(), c.detach(),
                                                dh, dc_out)
    for got, ref in ((h_new, h_ref), (c_new, c_ref), (grads[0], dz_ref), (grads[1], dc_ref)):
        assert torch.equal(got.detach().view(torch.int16), ref.view(torch.int16))
    if with_gh:
        assert torch.equal(grads[2], grads[0])
    again = fwd(gx.detach(), None if gh is None else gh.detach(), c.detach())
    assert torch.equal(again[0].view(torch.int16), h_new.view(torch.int16))


@pytest.mark.parametrize("with_gh", [False, True], ids=["merged", "gates_h"])
def test_all_bf16_gate_kernels_every_bf16_pattern(cuda_device, with_gh):
    """Every one of the 65,536 bf16 patterns in each operand slot in turn
    (the four gates, c, dh, dc'; ``exhaustive_operands``, the others
    seeded), without and with ``gates_h``: h', c', dz and dc bit for bit
    against the plain versions on the card, NaNs included; a failure names
    the first unequal input. Then the tables released: the next launch
    builds them once more and gives the same bits."""
    gx, gh, c, dh, dc_out = tgates.exhaustive_operands(with_gh, ch=4, seed=29, device=cuda_device)
    h, cn = tgates.lstm_gates_fwd_bf16s_cuda(gx, gh, c)
    dz, dc = tgates.lstm_gates_bwd_bf16s_cuda(gx, gh, c, dh, dc_out)
    h_ref, c_ref = tgates.gate_math_plain(gx, gh, c)
    dz_ref, dc_ref = tgates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
    bad = tgates.first_unequal({"h": h, "c": cn, "dz": dz, "dc": dc},
                               {"h": h_ref, "c": c_ref, "dz": dz_ref, "dc": dc_ref}, 4)
    assert bad is None, bad
    tgates.release_gate_tables()
    builds = tgates.lstm_gate_tables_cuda.launches
    again = tgates.lstm_gates_bwd_bf16s_cuda(gx, gh, c, dh, dc_out)
    torch.cuda.synchronize()
    assert tgates.lstm_gate_tables_cuda.launches == builds + 1
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(again, (dz, dc)))


def test_gate_tables_match_their_twin(cuda_device):
    """The card's activation tables against ``gate_table_twin`` run on the
    card (the plain block's activations with the same CUDA ``expf`` /
    ``tanhf``, the same derivation): equal ranges, and every packed entry
    of the S (sigmoid) and T (tanh) regions bit for bit."""
    tgates._ensure_tables(cuda_device)
    info = tgates.gate_tables_info(cuda_device)
    twin = tgates.gate_table_twin(cuda_device)
    assert {k: info[k] for k in ("slo", "sspan", "tlo", "tspan")} == {
        k: twin[k] for k in ("slo", "sspan", "tlo", "tspan")}
    for name, bits in tgates.packed_gate_tables(cuda_device).items():
        assert torch.equal(bits, twin[name]), name


@pytest.mark.parametrize("flags", [dict(pool_impl="argmax"), dict(use_pallas=True, pallas_pool=True)],
                         ids=["bf16_default", "bf16_kernels"])
def test_bf16_train_step_clip_cast_keeps_i3d_bits(cuda_device, flags):
    """The bf16 train step casts the clips to bf16 (as the JAX package's):
    I3D's first conv rounded a float32 clip to bf16 before, so one bf16
    training forward and backward at 16x224x224 (5 classes, 2 clips) gives
    equal logits, gradients and BN statistics from either dtype."""
    clips = torch.from_numpy(np.random.RandomState(1).randint(0, 256, (2, 16, 224, 224, 3)).astype(np.uint8))
    clips = clips.to(cuda_device)
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        cfg = Config()
        cfg.model.num_classes, cfg.model.dropout = 5, 0.0
        for key, value in flags.items():
            setattr(cfg.model, key, value)
        model = api._construct_model(cfg, False).to(cuda_device).train()
        params = dict(model.named_parameters())
        compute = {n: p.to(torch.bfloat16) for n, p in params.items()}
        logits = torch.func.functional_call(model, compute, (clips.to(dtype),), strict=False)
        grads = torch.autograd.grad(logits.float().logsumexp(-1).sum(), list(params.values()))
        runs.append([logits.detach(), *grads, *(b.clone() for b in model.buffers())])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_reference_checkpoints_round_trip_on_the_card(cuda_device, tmp_path):
    """The clstm_kth preset and the default I3D (174 classes) on the card:
    seeded weights exported as reference ``.pth.tar`` files load back
    through ``pretrained_model_path`` (``init_eval_state`` on the card) with
    equal state dicts and equal logits."""
    from ivf_tpu_torch.utils import export_torch

    for name in ("clstm", "i3d"):
        cfg = Config.load("configs/config_clstm_kth.py") if name == "clstm" else Config()
        model = api._construct_model(cfg, False).to(cuda_device).eval()
        sd = model.state_dict()
        m = cfg.model
        ref = (export_torch.i3d_state_dict_to_reference(sd) if name == "i3d" else
               export_torch.convlstm_state_dict_to_reference(
                   sd, image_size=api._clip_hw(cfg), conv_stride=m.conv_stride, pool_kernel=tuple(m.pool_kernel),
                   lstm_layers=m.clstm_layers, nb_lstm_units=m.clstm_hidden))
        path = str(tmp_path / f"{name}.pth.tar")
        export_torch.save_checkpoint_file(path, ref, arch=m.conv_model)
        cfg.model.pretrained_model_path = path
        loaded, _ = api.init_eval_state(cfg)
        assert next(loaded.parameters()).is_cuda
        assert sorted(loaded.state_dict()) == sorted(sd)
        assert all(torch.equal(loaded.state_dict()[k], t) for k, t in sd.items())
        hw = api._clip_hw(cfg)
        clip = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, cfg.data.clip_size, *hw, 3))
                                .astype(np.float32)).to(cuda_device)
        with torch.no_grad():
            assert torch.equal(loaded(clip), model(clip))


def test_i3d_train_step_on_the_card_repeats_its_bits_and_launches_its_kernels(cuda_device):
    """Two runs of three train steps of the f32 kernel route (5 classes,
    16x224x224, 2 clips, Adam, dropout 0.5 from the step seed) give equal
    bits and launch the pointwise and pool kernels every step."""
    from ivf_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    clips = torch.from_numpy(np.random.RandomState(0).randint(0, 255, (2, 16, 224, 224, 3)).astype(np.uint8))
    labels = torch.tensor([1, 3])
    runs = []
    for _ in range(2):
        cfg = Config()
        cfg.model.num_classes, cfg.model.use_pallas, cfg.model.pallas_pool = 5, True, True
        model = api._construct_model(cfg, False).to(cuda_device)
        state = create_train_state(model, build_optimizer("adam", 1e-3), seed=1)
        step = make_train_step()
        tpw.pointwise_conv_cuda.launches = tpool.maxpool3d_s1_fwd_cuda.launches = 0
        for _ in range(3):
            state, _ = step(state, clips, labels)
        torch.cuda.synchronize()
        # 38 1x1x1 convs (the trio unfused in training), forward and dx
        assert tpw.pointwise_conv_cuda.launches == 3 * 2 * 38 and tpool.maxpool3d_s1_fwd_cuda.launches == 27
        runs.append({n: t.detach().clone() for n, t in state.model.state_dict().items()})
    assert all(torch.equal(runs[0][n], runs[1][n]) for n in runs[0])


# serving: one route's model, its forward kernels' counters and launches per
# forward (the custom ops of the exported graph), at a small size
SERVE_ROUTES = {
    "i3d_kernels": ({"use_pallas": True, "pallas_pool": True},
                    {tpw.pointwise_conv_cuda: 20, tpool.maxpool3d_s1_fwd_cuda: 9}),
    "i3d_frame": ({"use_pallas": True, "fuse_pool_conv": True},
                  {tpw.pointwise_conv_cuda: 11, tfb.fused_pool_conv_fwd_cuda: 9}),
    "i3d_tblock": ({"use_pallas": True, "fuse_pool_conv": "tblock"},
                   {tpw.pointwise_conv_cuda: 11, tfb.fused_pool_conv_tblock_fwd_cuda: 9}),
    "i3d_stock": ({}, {}),
    "clstm_gates": ({"use_pallas": True}, {tgates.lstm_gates_fwd_cuda: 2 * 8}),
    "clstm_stock": ({"use_pallas": False}, {}),
}
SERVE_COUNTERS = (tpw.pointwise_conv_cuda, tpool.maxpool3d_s1_fwd_cuda, tfb.fused_pool_conv_fwd_cuda,
                  tfb.fused_pool_conv_tblock_fwd_cuda, tgates.lstm_gates_fwd_cuda)


@pytest.mark.parametrize("route", list(SERVE_ROUTES))
def test_artifact_exported_on_the_card_gives_the_live_bits_and_launches_its_kernels(cuda_device, route, tmp_path):
    """A model exported on the card (``serve.export_forward``), saved and
    loaded: at batches 1, 3 and 8 the artifact gives the live model's
    bits, and each call launches every forward kernel of its route as
    often as the live forward (the stock routes none). I3D at 8x64x64 (5
    classes, logits pool 1x1x1), the clstm_kth geometry at 8x32x48."""
    from ivf_tpu_torch import serve
    from ivf_tpu_torch.models import I3D, ConvLSTMClassifier

    flags, want = SERVE_ROUTES[route]
    gen = torch.Generator().manual_seed(3)
    if route.startswith("i3d"):
        model, shape = I3D(num_classes=5, pool_shape=(1, 1, 1), **flags), (8, 64, 64, 3)
    else:
        model = ConvLSTMClassifier(num_classes=6, nb_lstm_units=4, lstm_layers=2, conv_kernel_size=5, conv_stride=2,
                                   effective_steps=(3, 7), add_softmax=True, input_size=(32, 48), clip_len=8,
                                   **flags)
        shape = (8, 32, 48, 3)
    model.reset_parameters(gen)
    model = model.to(cuda_device).eval().requires_grad_(False)
    path = str(tmp_path / f"{route}.ivfptx")
    serve.save_artifact(serve.export_forward(model, shape), path)
    call, meta = serve.load_artifact(path)
    assert meta["device"] == "cuda:0" and call.device == torch.device("cuda:0")
    live = serve.live_forward(model)
    for b in (1, 3, 8):
        x = torch.rand((b, *shape), generator=gen).to(cuda_device)
        for fn in SERVE_COUNTERS:
            fn.launches = 0
        got = call(x)
        torch.cuda.synchronize()
        assert {fn: fn.launches for fn in SERVE_COUNTERS if fn.launches} == want
        assert torch.equal(got, live(x))


def _small_i3d(device, **flags):
    """A seeded 5-class I3D for 8x64x64 clips (the logits pool takes
    Mixed_5c's (1, 2, 2)), in eval mode on ``device``."""
    from ivf_tpu_torch.models import I3D

    model = I3D(num_classes=5, pool_shape=(1, 2, 2), **flags)
    model.reset_parameters(torch.Generator().manual_seed(4))
    return model.to(device).eval()


def _small_clip(device, b=1):
    return torch.rand((b, 8, 64, 64, 3), generator=torch.Generator().manual_seed(5)).mul(255).to(device)


def test_guided_backprop_kernel_route_matches_its_plain_versions(cuda_device):
    """Guided backprop on the f32 kernel route (``use_pallas`` +
    ``pallas_pool``): 38 pointwise convs forward and 38 dx, the pool pair
    9 / 9, against the same route with the wrappers patched to their plain
    versions on the card (``chip_smoke._f32_kernels_plain``) within
    ``chip_smoke.GUIDED_PLAIN_TOL`` (relative L2, its reason there). With
    ``fuse_pool_conv`` True or ``'tblock'`` no fused kernel launches."""
    import chip_smoke as cs
    from ivf_tpu_torch.interpret import guided_backprop_i3d

    model = _small_i3d(cuda_device, guided_relu=True, use_pallas=True, pallas_pool=True)
    clip = _small_clip(cuda_device)[0]
    counters = cs.launch_counters()
    sal, launched = cs._launched(counters, lambda: guided_backprop_i3d(model, clip, 2))
    assert launched == {"pointwise_conv": 76, "maxpool3d_s1_fwd": 9, "maxpool3d_s1_bwd": 9}
    with cs._f32_kernels_plain():
        plain, none = cs._launched(counters, lambda: guided_backprop_i3d(model, clip, 2))
    assert not none and torch.isfinite(sal).all() and sal.abs().max() > 0
    assert cs._rel_l2(sal, plain) <= cs.GUIDED_PLAIN_TOL
    for variant in (True, "tblock"):
        fused = _small_i3d(cuda_device, guided_relu=True, use_pallas=True, fuse_pool_conv=variant)
        _, launched = cs._launched(counters, lambda: guided_backprop_i3d(fused, clip, 2))
        assert launched == {"pointwise_conv": 76}


def test_remat_gives_equal_bits_and_launches_the_block_kernels_twice(cuda_device):
    """``remat`` on the f32 kernel route: in eval mode (logits and input
    gradient, as the search) and in one train step (loss, parameters, BN
    statistics, each ``num_batches_tracked`` 1) the bits of the model
    without it; the blocks' forward kernels launch twice: eval 40 -> 58
    pointwise launches (20 forward, 20 dx, 18 forwards again), pool 9 ->
    18 forwards; a train step 76 -> 112 (the trio unfused), pool 9 -> 18."""
    import chip_smoke as cs
    from ivf_tpu_torch.train import build_optimizer, create_train_state, make_train_step

    counters = cs.launch_counters()
    x = _small_clip(cuda_device, b=2)
    evals, trains = {}, {}
    for remat in (False, True):
        model = _small_i3d(cuda_device, remat=remat, use_pallas=True, pallas_pool=True)

        def saliency():
            xg = x.clone().requires_grad_(True)
            logits = model(xg)
            return logits.detach(), torch.autograd.grad(logits.sum(), xg)[0]

        evals[remat] = cs._launched(counters, saliency)
        model = _small_i3d(cuda_device, remat=remat, use_pallas=True, pallas_pool=True, dropout_rate=0.0)
        state = create_train_state(model, build_optimizer("sgd", 1.0, momentum=0.0))
        (state, metrics), launched = cs._launched(counters, lambda: make_train_step()(state, x, torch.tensor([1, 3])))
        trains[remat] = (float(metrics["loss"]), {n: t.detach().clone() for n, t in state.model.state_dict().items()},
                         launched)
    (off, off_launched), (on, on_launched) = evals[False], evals[True]
    assert all(torch.equal(a, b) for a, b in zip(on, off))
    assert off_launched == {"pointwise_conv": 40, "maxpool3d_s1_fwd": 9, "maxpool3d_s1_bwd": 9}
    assert on_launched == {"pointwise_conv": 58, "maxpool3d_s1_fwd": 18, "maxpool3d_s1_bwd": 9}
    (off_loss, off_sd, off_train), (on_loss, on_sd, on_train) = trains[False], trains[True]
    assert on_loss == off_loss and all(torch.equal(on_sd[n], off_sd[n]) for n in off_sd)
    assert {int(t) for n, t in on_sd.items() if n.endswith("num_batches_tracked")} == {1}
    assert off_train == {"pointwise_conv": 76, "maxpool3d_s1_fwd": 9, "maxpool3d_s1_bwd": 9}
    assert on_train == {"pointwise_conv": 112, "maxpool3d_s1_fwd": 18, "maxpool3d_s1_bwd": 9}
