"""ivf_tpu_torch's CUDA kernels on the card (``gpu`` marker).

Each kernel against its plain PyTorch version, and the kernel path of
``find_masks`` at full width. Skips without a CUDA device. This file
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
from ivf_tpu_torch.ops.kernels import maxpool3d as tpool
from ivf_tpu_torch.ops.kernels import pointwise_conv as tpw

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    x = torch.randn(8, 4, device=cuda_device)
    w = torch.randn(4, 3, device=cuda_device)
    with pytest.raises(TypeError):
        tpw.pointwise_conv_cuda(x.double(), w.double(), None, True)
    with pytest.raises(ValueError):
        tpw.pointwise_conv_cuda(x.t(), w, None, True)  # not contiguous
    with pytest.raises(TypeError):
        tpool.maxpool3d_s1_fwd_cuda(torch.ones(1, 2, 3, 3, 4, device=cuda_device).half())


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
