"""2-D Grad-CAM and guided backprop in the port
(``ivf_tpu_torch/interpret/gradcam2d.py``) against the JAX package's
``ivf_tpu/interpret/gradcam2d.py`` and the torch replicas of the vendored
library in ``tests/test_interpret.py:542-700``, on the CPU.

A tiny CNN (conv-relu-conv-relu, a linear head on the flattened
activation; the model ``GradCam`` assumes) runs in torch for the port,
channels-last, and as the JAX replica of ``tests/test_interpret.py`` for
the JAX functions, with the same weights. Tolerances: CAMs rtol 1e-3 /
atol 1e-5 (the test_interpret pin against the torch hooks: after the
min-max normalization a float32 rounding of the smallest value moves the
rest); scores and saliency rtol 1e-4 / atol 1e-5; the resize alone rtol
1e-5 / atol 1e-6 (the same weights, summed in another order); the
product, the preprocessing and the blend with equal bits or within one
float32 rounding.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from ivf_tpu.interpret import gradcam2d as jg
from ivf_tpu.interpret.guided_backprop import guided_relu as j_guided_relu
from ivf_tpu_torch.interpret import gradcam2d as tg
from ivf_tpu_torch.interpret import guided_relu
from tests.test_interpret import _jax_fns_from_torch, _tiny_torch_cnn


class GBReLU(torch.autograd.Function):
    """The reference's GuidedBackpropReLU (grad-cam.py:147-163), as
    ``tests/test_interpret.py`` restates it."""

    @staticmethod
    def forward(ctx, inp):
        ctx.save_for_backward(inp)
        return inp.clamp(min=0)

    @staticmethod
    def backward(ctx, grad_output):
        (inp,) = ctx.saved_tensors
        return grad_output * (inp > 0).type_as(inp) * (grad_output > 0).type_as(inp)


def _port_fns(feat, head, act=torch.relu):
    """features_fn / head_fn over channels-last (H, W, C) torch tensors."""

    def features_fn(img):
        x = img.permute(2, 0, 1)[None]
        x = act(F.conv2d(x, feat[0].weight, feat[0].bias, padding=1))
        x = act(F.conv2d(x, feat[2].weight, feat[2].bias, padding=1))
        return x[0].permute(1, 2, 0)

    def head_fn(a):
        return F.linear(a.permute(2, 0, 1).reshape(-1), head.weight, head.bias)

    return features_fn, head_fn


def _img(seed=3):
    return np.random.RandomState(seed).randn(6, 6, 3).astype(np.float32)


@pytest.mark.parametrize(
    "src,dst",
    [((6, 6), (6, 6)), ((6, 6), (12, 9)), ((6, 6), (4, 4)), ((7, 5), (3, 8)), ((5, 9), (2, 3)), ((1, 1), (5, 4))],
    ids=["same", "up", "down", "mixed", "down_odd", "one_pixel"],
)
def test_resize_matches_jax_image_resize(src, dst):
    """``jax.image.resize(..., 'bilinear')`` both ways: half-pixel bilinear
    growing, the antialiasing triangle filter shrinking (which plain
    bilinear interpolation is not: the control), a 1x1 map to an exact
    constant."""
    x = np.random.RandomState(0).rand(*src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), dst, "bilinear"))
    got = tg.resize_bilinear(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if src == (1, 1):
        np.testing.assert_array_equal(got, np.full(dst, x[0, 0]))
    if dst[0] < src[0] and dst[1] < src[1]:
        plain = F.interpolate(torch.from_numpy(x)[None, None], size=dst, mode="bilinear", align_corners=False)
        assert np.abs(plain[0, 0].numpy() - want).max() > 1e-3


@pytest.mark.parametrize("output_size", [None, (12, 12), (4, 4), (3, 8)], ids=["same", "up", "down", "mixed"])
def test_grad_cam_image_matches_jax(output_size):
    """The CAM, its scores and the predicted-class default, at the input's
    size and resized up, down and both ways, against JAX's."""
    feat, head = _tiny_torch_cnn()
    img = _img()
    jf, jh = _jax_fns_from_torch(feat, head)
    want, want_scores = jg.grad_cam_image(jf, jh, jnp.asarray(img), output_size=output_size)
    with torch.no_grad():
        cam, scores = tg.grad_cam_image(*_port_fns(feat, head), torch.from_numpy(img), output_size=output_size)
    assert cam.shape == (output_size or img.shape[:2])
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(cam.numpy(), np.asarray(want), rtol=1e-3, atol=1e-5)
    assert cam.max() == 1.0 and cam.min() == 0.0


def test_grad_cam_image_matches_the_torch_hooks():
    """Full GradCam.__call__ (grad-cam.py:109-145) by hooks on the torch
    CNN, at the input's size, for the predicted class and a chosen one."""
    feat, head = _tiny_torch_cnn()
    img = _img()
    x = torch.from_numpy(img.transpose(2, 0, 1)[None])
    act = feat(x)
    act.retain_grad()
    out = head(act.view(1, -1))
    index = int(out.detach().numpy().argmax())
    out[0, index].backward()
    weights = act.grad.numpy()[0].mean(axis=(1, 2))
    cam_ref = np.maximum((weights[:, None, None] * act.detach().numpy()[0]).sum(0), 0)
    cam_ref = (cam_ref - cam_ref.min()) / (cam_ref - cam_ref.min()).max()
    cam, _ = tg.grad_cam_image(*_port_fns(feat, head), torch.from_numpy(img))
    np.testing.assert_allclose(cam.numpy(), cam_ref, rtol=1e-3, atol=1e-5)
    cam_other, _ = tg.grad_cam_image(*_port_fns(feat, head), torch.from_numpy(img), target_index=(index + 1) % 6)
    assert not np.allclose(cam_other.numpy(), cam.numpy())


def test_grad_cam_image_of_an_all_zero_map_is_zero():
    """A zero activation gives an all-zero CAM: zeros, where the reference
    divides by 0."""
    feat, head = _tiny_torch_cnn()
    features_fn, head_fn = _port_fns(feat, head)
    cam, _ = tg.grad_cam_image(lambda img: features_fn(img) * 0, head_fn, torch.from_numpy(_img()))
    np.testing.assert_array_equal(cam.numpy(), 0.0)


@pytest.mark.parametrize("target", [2, None], ids=["chosen", "predicted"])
def test_guided_backprop_image_matches_jax_and_the_torch_replica(target):
    """The input-space saliency through ``guided_relu`` against JAX's through
    its custom VJP and against GBReLU hooked into the torch CNN
    (grad-cam.py:181-205)."""
    feat, head = _tiny_torch_cnn(seed=11)
    img = _img(4)
    features_fn, head_fn = _port_fns(feat, head, act=guided_relu)
    got = tg.guided_backprop_image(lambda a: head_fn(features_fn(a)), torch.from_numpy(img), target)
    _, jh = _jax_fns_from_torch(feat, head)
    k1 = jnp.asarray(feat[0].weight.detach().numpy().transpose(2, 3, 1, 0))
    b1 = jnp.asarray(feat[0].bias.detach().numpy())
    k2 = jnp.asarray(feat[2].weight.detach().numpy().transpose(2, 3, 1, 0))
    b2 = jnp.asarray(feat[2].bias.detach().numpy())
    from ivf_tpu.ops.conv import conv2d_same_torch

    def j_score(a):
        x = j_guided_relu(conv2d_same_torch(a[None], k1, bias=b1))
        x = j_guided_relu(conv2d_same_torch(x, k2, bias=b2))
        return jh(x[0])

    want = np.asarray(jg.guided_backprop_image(j_score, jnp.asarray(img), target))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    x = torch.from_numpy(img.transpose(2, 0, 1)[None]).requires_grad_(True)
    h = GBReLU.apply(feat[0](x))
    h = GBReLU.apply(feat[2](h))
    out = head(h.view(1, -1))
    out[0, 2 if target is not None else int(out.detach().argmax())].backward()
    np.testing.assert_allclose(got.numpy(), x.grad.numpy()[0].transpose(1, 2, 0), rtol=1e-4, atol=1e-5)


def test_combine_preprocess_and_show_cam_match_jax(tmp_path):
    """``combine_cam_gb`` and ``preprocess_image`` (BGR flip, ImageNet mean
    and std, grad-cam.py:74-87, both ``bgr`` settings) within one float32
    rounding of JAX's; ``show_cam_on_image`` (grad-cam.py:89-94) writes the
    JAX function's pixels, from arrays and from tensors."""
    rng = np.random.RandomState(5)
    cam = rng.rand(6, 6).astype(np.float32)
    gb = rng.randn(6, 6, 3).astype(np.float32)
    got = tg.combine_cam_gb(torch.from_numpy(cam), torch.from_numpy(gb)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jg.combine_cam_gb(jnp.asarray(cam), jnp.asarray(gb))))
    img = rng.rand(6, 6, 3).astype(np.float32)
    for bgr in (True, False):
        pre = tg.preprocess_image(img, bgr=bgr)
        assert pre.dtype == torch.float32 and pre.shape == (6, 6, 3)
        np.testing.assert_allclose(pre.numpy(), np.asarray(jg.preprocess_image(img, bgr=bgr)), rtol=1e-6, atol=1e-6)
    assert tg.IMAGENET_MEANS == jg.IMAGENET_MEANS and tg.IMAGENET_STDS == jg.IMAGENET_STDS
    want = jg.show_cam_on_image(img, cam, str(tmp_path / "jax.jpg"))
    for name, args in (("np.jpg", (img, cam)), ("t.jpg", (torch.from_numpy(img), torch.from_numpy(cam)))):
        out = tg.show_cam_on_image(*args, str(tmp_path / name))
        assert out.dtype == np.uint8
        np.testing.assert_array_equal(out, want)
        assert (tmp_path / name).read_bytes() == (tmp_path / "jax.jpg").read_bytes()
