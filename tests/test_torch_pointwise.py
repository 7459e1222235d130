"""The float32 pointwise GEMM's planner and wrapper, on the CPU.

``pointwise_conv.f32_plan`` picks the kernel of ``pointwise_conv_cuda``
(a tile instance of ``pw_gemm_f32``, or ``pw_gemm_f32_rows`` for a
handful of rows) from shapes, strides and addresses alone, so it is
tested here; the kernels themselves are held against the plain version
by tests/test_torch_gpu.py on the card and by ``chip_smoke.py``.
"""

import pytest
import torch

from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw

# I3D's 1x1x1 convs at batch 4 (site, N, Cin, Cout), as chip_smoke.pw_main_path
PW_MAIN_PATH = [
    ("Conv3d_2b", 100352, 64, 64), ("Mixed_3b_trio", 25088, 192, 176), ("Mixed_3b_b3b", 25088, 192, 32),
    ("Mixed_3c_trio", 25088, 256, 288), ("Mixed_3c_b3b", 25088, 256, 64),
    ("Mixed_4b_trio", 3136, 480, 304), ("Mixed_4b_b3b", 3136, 480, 64), ("Mixed_4c_trio", 3136, 512, 296),
    ("Mixed_4d_trio", 3136, 512, 280), ("Mixed_4e_trio", 3136, 512, 288), ("Mixed_4cde_b3b", 3136, 512, 64),
    ("Mixed_4f_trio", 3136, 528, 448), ("Mixed_4f_b3b", 3136, 528, 128), ("Mixed_5b_trio", 392, 832, 448),
    ("Mixed_5c_trio", 392, 832, 624), ("Mixed_5bc_b3b", 392, 832, 128), ("logits", 4, 1024, 174),
]
_BASE = 1 << 20  # a 16-byte-aligned address


def _valid(plan, n, cin, cout, x_stride, x_ptr, w_stride, w_ptr):
    """A plan the C entry point accepts: a known kernel, and 16-byte
    copies and stores only where strides and addresses allow them."""
    assert plan["path"] in ("rows", "tile")
    assert plan["tile"] == "rows" if plan["path"] == "rows" else plan["tile"] in tpw.F32_TILES
    k_major = plan["w_k_major"]
    lead, unit = (w_stride[1], w_stride[0]) if k_major else (w_stride[0], w_stride[1])
    assert set(plan["vec"]) <= {"x", "w", "y"}
    assert ("x" in plan["vec"]) == (x_stride[1] == 1 and x_stride[0] % 4 == 0 and x_ptr % 16 == 0)
    assert ("w" in plan["vec"]) == (unit == 1 and lead % 4 == 0 and w_ptr % 16 == 0)
    assert ("y" in plan["vec"]) == (cout % 4 == 0)


@pytest.mark.parametrize("site,n,cin,cout", PW_MAIN_PATH, ids=[r[0] for r in PW_MAIN_PATH])
def test_f32_plan_at_every_main_path_shape(site, n, cin, cout):
    """Forward: W is the column-major view of the (Cout, Cin) weight,
    staged K-major with 16-byte copies; dx: W^T, row-major, staged
    MN-major. The trunk takes the cheapest tile of the cost model, the
    logits head (N = batch) the few-rows kernel."""
    fwd = tpw.f32_plan(n, cin, cout, (cin, 1), _BASE, (1, cin), _BASE)
    dx = tpw.f32_plan(n, cout, cin, (cout, 1), _BASE, (cin, 1), _BASE)
    _valid(fwd, n, cin, cout, (cin, 1), _BASE, (1, cin), _BASE)
    _valid(dx, n, cout, cin, (cout, 1), _BASE, (cin, 1), _BASE)
    assert fwd["w_k_major"] and not dx["w_k_major"]
    assert "w" in fwd["vec"] and "w" in dx["vec"]
    for plan, k, c in ((fwd, cin, cout), (dx, cout, cin)):
        if site == "logits":
            assert plan["path"] == "rows"
        else:
            assert plan["path"] == "tile"
            costs = {t: tpw.f32_tile_cost(t, n, k, c) for t in tpw.F32_TILES}
            assert costs[plan["tile"]] == min(costs.values())


@pytest.mark.parametrize(
    "n,cin,cout,x_stride,x_ptr,w_stride,w_ptr,path,k_major,vec",
    [
        (20, 112, 48, (112, 1), _BASE, (1, 112), _BASE, "tile", True, {"x", "w", "y"}),  # n below every tile
        (16, 112, 48, (112, 1), _BASE, (1, 112), _BASE, "rows", True, {"x", "w", "y"}),
        (1, 1024, 174, (1024, 1), _BASE, (1, 1024), _BASE, "rows", True, {"x", "w"}),  # one clip's logits
        (1001, 174, 61, (174, 1), _BASE, (1, 174), _BASE, "tile", True, set()),  # Cin, Cout not multiples of 4
        (1001, 61, 174, (61, 1), _BASE, (174, 1), _BASE, "tile", False, set()),
        (129, 64, 40, (64, 1), _BASE + 4, (1, 64), _BASE, "tile", True, {"w", "y"}),  # X base not 16-byte aligned
        (129, 64, 40, (64, 1), _BASE, (40, 1), _BASE + 8, "tile", False, {"x", "y"}),  # W base not aligned
        (129, 64, 40, (64, 1), _BASE, (1, 72), _BASE, "tile", True, {"x", "w", "y"}),  # a padded weight's view
        (129, 64, 40, (64, 1), _BASE, (80, 2), _BASE, "tile", False, {"x", "y"}),  # neither stride 1
    ],
    ids=["n20", "n16", "n1_logits", "cin174_cout61", "cin61_cout174", "x_unaligned", "w_unaligned",
         "w_padded_view", "w_strided"],
)
def test_f32_plan_at_ragged_and_unaligned_shapes(n, cin, cout, x_stride, x_ptr, w_stride, w_ptr, path, k_major,
                                                  vec):
    plan = tpw.f32_plan(n, cin, cout, x_stride, x_ptr, w_stride, w_ptr)
    _valid(plan, n, cin, cout, x_stride, x_ptr, w_stride, w_ptr)
    assert (plan["path"], plan["w_k_major"], set(plan["vec"])) == (path, k_major, vec)


@pytest.mark.parametrize("tile", ["rows", *tpw.F32_TILES])
def test_f32_plan_takes_a_forced_tile(tile):
    plan = tpw.f32_plan(25088, 192, 176, (192, 1), _BASE, (1, 192), _BASE, tile=tile)
    assert plan["tile"] == tile and plan["path"] == ("rows" if tile == "rows" else "tile")
    with pytest.raises(ValueError):
        tpw.f32_plan(25088, 192, 176, (192, 1), _BASE, (1, 192), _BASE, tile="96x96/8x8")


def test_f32_tiles_fit_the_kernel_template():
    """The instances of csrc/pointwise_conv.cu's F32Tile: float4 column
    runs (TN a multiple of 4), warps of 4 x 8 threads, at most 1024
    threads a block."""
    for bm, bn, tm, tn in tpw.F32_TILES.values():
        assert tn % 4 == 0 and bm % tm == 0 and bn % tn == 0
        assert (bn // tn) % 8 == 0 and (bm // tm) % 4 == 0 and (bm // tm) * (bn // tn) <= 1024
    assert set(tpw.F32_COST) == set(tpw.F32_TILES)


@pytest.mark.parametrize("direction", ["fwd", "dx"])
def test_f32_wrapper_passes_the_weight_as_stored(monkeypatch, direction):
    """The layers pass W as the column-major view of the (Cout, Cin) conv
    weight and ``dx`` launches on its transpose: the wrapper hands the
    kernel the weight's own storage and strides, no copy. The launch is
    recorded by a stand-in for the library, on CPU tensors."""
    calls = []

    class FakeLib:
        @staticmethod
        def pw_conv_f32(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(tpw, "_lib", lambda: FakeLib)
    monkeypatch.setattr(tpw, "_check_cuda_operands", lambda *a, **k: None)
    monkeypatch.setattr(tpw, "_stream", lambda t: 0)
    monkeypatch.setattr(tpw, "_sm_count", lambda i: tpw.H100_SMS)
    wk = torch.randn(176, 192)  # (Cout, Cin), as a conv weight
    n = 25088
    if direction == "fwd":
        x, w, b = torch.randn(n, 192), wk.t(), torch.randn(176)
    else:
        x, w, b = torch.randn(n, 176), wk, None
    before = tpw.pointwise_conv_cuda.launches
    y = tpw.pointwise_conv_cuda(x, w, b, direction == "fwd")
    assert tpw.pointwise_conv_cuda.launches == before + 1
    (args,) = calls
    xp, ldx, wp, swk, swc, bp, yp, n_, cin, cout, tile, k_major, vec, relu, _ = args
    assert (xp, ldx, wp, swk, swc) == (x.data_ptr(), x.stride(0), wk.data_ptr(), *w.stride())
    assert (n_, cin, cout, yp) == (n, *w.shape, y.data_ptr()) and y.shape == (n, w.shape[1])
    assert bp == (b.data_ptr() if b is not None else None) and relu == int(direction == "fwd")
    plan = tpw.f32_plan(n, *w.shape, x.stride(), x.data_ptr(), w.stride(), w.data_ptr())
    assert tile == list(tpw.F32_TILES).index(plan["tile"]) and k_major == int(direction == "fwd")
    assert vec == sum(tpw._F32_VEC_BITS[v] for v in plan["vec"])
