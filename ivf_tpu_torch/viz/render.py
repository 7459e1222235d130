"""Result rendering (port of ``ivf_tpu/viz/render.py``): the same file
names, arrays and folder layout, with numpy and Pillow in place of cv2 and
matplotlib.

  * ``visualize_results``: per-frame perturbed PNGs with a mask-intensity
    marker square in the top-left corner;
  * ``find_temp_mask_dots`` / ``visualize_results_on_gradcam``: the
    red/green per-frame mask indicator strip over the perturbed panel;
  * ``create_image_arrays``: the triptych ``orig | CAM blend | perturbed``
    per frame as ``img%02d.jpg``, and an animated GIF.

What cv2 did, and what stands in for it:

  * ``cv2.applyColorMap(..., COLORMAP_JET)``: ``JET_BGR``, cv2's 256-entry
    table as integer ramps (equal to cv2's at every level);
  * ``cv2.imwrite`` of a JPEG: Pillow at cv2's default quality, 95, with
    4:2:0 chroma, as cv2 writes it;
  * ``cv2.resize`` (``INTER_LINEAR``) under ``resize_to``:
    ``resize_bilinear``, half-pixel centres with the edges clamped.

``PlotLearning``: the training curves (accuracy, loss, learning rate) as
``accu_plot.png``, ``loss_plot.png`` and ``lr_plot.png``, drawn with
Pillow on matplotlib's 600x400 canvas with its axis limits, titles and
line colours (``_line_plot``); the pixels are not matplotlib's. Inputs are
channels-last numpy arrays; clips are (T, H, W, C) RGB 0..255.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

JPEG_QUALITY = 95  # cv2.imwrite's default IMWRITE_JPEG_QUALITY


def _jet_table() -> np.ndarray:
    """cv2's COLORMAP_JET as a (256, 3) uint8 BGR table: each channel
    rises and falls by 4 levels a step, the three 64 levels apart."""
    i = np.arange(256)
    blue = np.minimum(128 + 4 * i, 638 - 4 * i)
    green = np.minimum(4 * i - 128, 892 - 4 * i)
    red = np.minimum(4 * i - 382, 1148 - 4 * i)
    table = np.clip(np.stack([blue, green, red], axis=1), 0, 255)
    table[159, 0] = 1  # cv2 rounds its interpolated table to 1 there, not 2
    return table.astype(np.uint8)


JET_BGR = _jet_table()


def _apply_jet(x01: np.ndarray) -> np.ndarray:
    """JET heatmap of an (H, W) map in [0, 1]: (H, W, 3) uint8 BGR, as
    ``cv2.applyColorMap(np.uint8(255 * x01), cv2.COLORMAP_JET)``."""
    return JET_BGR[np.uint8(255 * x01)]


def resize_bilinear(img: np.ndarray, size: Sequence[int]) -> np.ndarray:
    """``cv2.resize(img, size)`` with ``INTER_LINEAR`` for an (H, W) or
    (H, W, C) array; ``size`` is (width, height), as cv2 takes it. Source
    coordinates ``(d + 0.5) * in / out - 0.5``, clamped to the image, in
    float32; a uint8 image is rounded back to uint8. cv2 sums uint8 images
    in 11-bit fixed point, so a uint8 result may be one level off cv2's
    (tests/test_torch_viz.py holds it to that)."""
    w_out, h_out = int(size[0]), int(size[1])
    h_in, w_in = img.shape[:2]

    def taps(n_in, n_out):
        src = (np.arange(n_out, dtype=np.float32) + 0.5) * np.float32(n_in / n_out) - 0.5
        src = np.clip(src, 0, n_in - 1)
        lo = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
        hi = np.minimum(lo + 1, n_in - 1)
        return lo, hi, (src - lo).astype(np.float32)

    y0, y1, fy = taps(h_in, h_out)
    x0, x1, fx = taps(w_in, w_out)
    f = img.astype(np.float32)
    if f.ndim == 3:
        fy, fx = fy[:, None], fx[:, None]
    rows = f[y0] * (1 - fy[:, None]) + f[y1] * fy[:, None]
    out = rows[:, x0] * (1 - fx) + rows[:, x1] * fx
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def visualize_results(
    orig_seq: np.ndarray,
    pert_seq: np.ndarray,
    mask: np.ndarray,
    root_dir: str,
    case: str = "0",
    mark_imgs: bool = True,
):
    """Write per-frame perturbed PNGs to ``root_dir/PerturbImgs``; the
    top-left 10x10 square's red channel encodes mask[i]."""
    out = os.path.join(root_dir, "PerturbImgs")
    os.makedirs(out, exist_ok=True)
    pert = np.array(pert_seq, dtype=np.float32, copy=True)
    for i in range(pert.shape[0]):
        if mark_imgs:
            pert[i, :10, :10, :] = 0
            pert[i, :10, :10, 0] = float(mask[i]) * 255
        Image.fromarray(pert[i].astype(np.uint8)).save(os.path.join(out, f"case{case}pert{i}.png"))
    with open(os.path.join(out, f"case{case}.txt"), "w") as f:
        f.write(str(np.asarray(mask)))


def find_temp_mask_dots(
    image_width: int, image_height: int, mask: np.ndarray, round_up: bool = True
) -> List[dict]:
    """Dot geometry of the mask indicator strip: channel 1 (green) where
    the frame is unmasked, channel 0 (red) where it is masked (RGB
    panels)."""
    mask = np.asarray(mask, np.float32).copy()
    n = len(mask)
    dot_width = int(image_width // (n + 4))
    dot_padding = int((image_width - dot_width * n) // n)
    dot_height = int(image_height // 20)
    dots = []
    for i in range(n):
        if round_up:
            mask[i] = 1.0 if mask[i] > 0.5 else 0.0
        dots.append(
            {
                "yStart": image_height - dot_height,
                "yEnd": image_height,
                "xStart": i * (dot_width + dot_padding),
                "xEnd": i * (dot_width + dot_padding) + dot_width,
                "channel": 1 if mask[i] == 0 else 0,
            }
        )
    return dots


def visualize_results_on_gradcam(
    panel_frames: np.ndarray,  # (T, H, W_panel, 3)
    mask: np.ndarray,
    root_dir: str,
    case: str = "0",
    image_width: int = 224,
    image_height: int = 224,
    dot_offset: Optional[int] = None,
):
    """Overlay the mask dot strip on the third (perturbed) panel column and
    save per-frame PNGs ``case<case>_<i>.png`` and ``MASKVALScase<case>.txt``."""
    os.makedirs(root_dir, exist_ok=True)
    frames = np.array(panel_frames, dtype=np.float32, copy=True)
    dots = find_temp_mask_dots(image_width, image_height, mask)
    off = dot_offset if dot_offset is not None else image_width * 2
    for i in range(frames.shape[0]):
        for j, dot in enumerate(dots):
            intensity = 255 if i == j else 150
            ys = dot["yStart"]
            frames[i, ys:, off + dot["xStart"] : off + dot["xEnd"], :] = 0
            frames[i, ys:, off + dot["xStart"] : off + dot["xEnd"], dot["channel"]] = intensity
        Image.fromarray(frames[i].astype(np.uint8)).save(os.path.join(root_dir, f"case{case}_{i}.png"))
    with open(os.path.join(root_dir, f"MASKVALScase{case}.txt"), "w") as f:
        f.write(str(np.asarray(mask)))
    return frames


def image_panels(
    input_clip: np.ndarray,  # (T, H, W, 3) RGB 0..255
    gradcam_mask: np.ndarray,  # (T, H, W) in [0, 1]
    perturbed_clip: np.ndarray,  # (T, H, W, 3)
    resize_to: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """The (T, H, 3W, 3) uint8 triptychs ``orig | cam blend | perturbed``
    of ``create_image_arrays``, written nowhere."""
    panels = []
    for i in range(input_clip.shape[0]):
        img = input_clip[i].astype(np.float32)
        heatmap = _apply_jet(gradcam_mask[i])[:, :, ::-1]  # BGR -> RGB
        perturbed = perturbed_clip[i].astype(np.float32)
        if resize_to is not None:
            # all three panels (the JAX package fixed the reference, which
            # forgot the perturbed one)
            img = resize_bilinear(img, resize_to)
            heatmap = resize_bilinear(heatmap, resize_to)
            perturbed = resize_bilinear(perturbed, resize_to)
        cam = heatmap.astype(np.float32) + img
        cam = cam / cam.max()
        panels.append(np.concatenate(
            [img.astype(np.uint8), (255 * cam).astype(np.uint8), perturbed.astype(np.uint8)], axis=1
        ))
    return np.stack(panels)


def create_image_arrays(
    input_clip: np.ndarray,  # (T, H, W, 3) RGB 0..255
    gradcam_mask: np.ndarray,  # (T, H, W) in [0, 1]
    time_mask: np.ndarray,  # (T,)
    perturbed_clip: np.ndarray,  # (T, H, W, 3) snapped-mask perturbation
    output_folder: str,
    case_tag: str = "freeze",
    resize_to: Optional[Sequence[int]] = None,
) -> np.ndarray:
    """Per-frame triptych ``orig | cam blend | perturbed`` (``image_panels``)
    as ``img%02d.jpg``, the animated ``mygif.gif``, and the dot-strip PNGs
    of ``visualize_results_on_gradcam``. Returns the (T, H, 3W, 3) panels."""
    os.makedirs(output_folder, exist_ok=True)
    panel_arr = image_panels(input_clip, gradcam_mask, perturbed_clip, resize_to)
    for i, panel in enumerate(panel_arr):
        Image.fromarray(panel).save(
            os.path.join(output_folder, "img%02d.jpg" % (i + 1)), "JPEG", quality=JPEG_QUALITY, subsampling=2
        )
    ims = [Image.fromarray(p) for p in panel_arr]
    ims[0].save(
        os.path.join(output_folder, "mygif.gif"),
        save_all=True,
        append_images=ims[1:],
        duration=100,
        loop=0,
    )
    visualize_results_on_gradcam(
        panel_arr,
        time_mask,
        root_dir=output_folder,
        case=case_tag,
        image_width=panel_arr.shape[2] // 3,
        image_height=panel_arr.shape[1],
    )
    return panel_arr


_SERIES_RGB = ((31, 119, 180), (255, 127, 14))  # matplotlib's C0, C1
_PLOT_BOX = (70, 40, 580, 360)  # the axes on a 600x400 canvas: left, top, right, bottom


def _line_plot(path: str, series, title: str, ylim=None) -> None:
    """A line chart as a PNG: ``series`` is ``[(values, label), ...]`` over
    x = 0, 1, ...; ``ylim`` (lo, hi), or the data's range. Points beyond
    ``ylim`` are held at the axes' edge, as a clipped line leaves it."""
    img = Image.new("RGB", (600, 400), "white")
    draw = ImageDraw.Draw(img)
    font = ImageFont.load_default()
    left, top, right, bottom = _PLOT_BOX
    values = [float(v) for vals, _ in series for v in vals]
    lo, hi = ylim if ylim is not None else (min(values), max(values))
    if hi <= lo:
        lo, hi = lo - 0.5, hi + 0.5
    n = max(len(vals) for vals, _ in series)
    draw.rectangle(_PLOT_BOX, outline="black")
    for k in range(5):
        v = lo + (hi - lo) * k / 4
        y = bottom - (bottom - top) * k / 4
        draw.line([(left - 4, y), (left, y)], fill="black")
        draw.text((4, y - 6), f"{v:.4g}", fill="black", font=font)
    for k in range(n):
        x = left + (right - left) * (k / max(n - 1, 1))
        draw.line([(x, bottom), (x, bottom + 4)], fill="black")
        draw.text((x - 3, bottom + 6), str(k), fill="black", font=font)
    draw.text(((left + right) / 2 - 3 * len(title), 14), title, fill="black", font=font)

    def point(k, v):
        x = left + (right - left) * (k / max(n - 1, 1))
        y = bottom - (bottom - top) * (min(max(float(v), lo), hi) - lo) / (hi - lo)
        return (x, y)

    for j, (vals, label) in enumerate(series):
        rgb = _SERIES_RGB[j % len(_SERIES_RGB)]
        pts = [point(k, v) for k, v in enumerate(vals)]
        if len(pts) > 1:
            draw.line(pts, fill=rgb, width=2)
        for x, y in pts:
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=rgb)
        if label:
            draw.line([(right - 90, top + 14 + 16 * j), (right - 70, top + 14 + 16 * j)], fill=rgb, width=2)
            draw.text((right - 64, top + 8 + 16 * j), label, fill="black", font=font)
    img.save(path)


class PlotLearning:
    """Loss / accuracy / learning-rate curve PNGs after each epoch
    (reference ``visualisation.py:133-190``): ``accu_plot.png`` (train and
    valid accuracy on 0..1, titled with the best valid epoch),
    ``loss_plot.png`` (train and valid loss on 0..ln(num_classes)) and
    ``lr_plot.png``, under ``save_path``."""

    def __init__(self, save_path: str, num_classes: int):
        os.makedirs(save_path, exist_ok=True)
        self.accuracy: List[float] = []
        self.val_accuracy: List[float] = []
        self.losses: List[float] = []
        self.val_losses: List[float] = []
        self.learning_rates: List[float] = []
        self.save_path_loss = os.path.join(save_path, "loss_plot.png")
        self.save_path_accu = os.path.join(save_path, "accu_plot.png")
        self.save_path_lr = os.path.join(save_path, "lr_plot.png")
        self.init_loss = -np.log(1.0 / num_classes)

    def plot(self, logs: dict) -> None:
        self.accuracy.append(logs.get("acc"))
        self.val_accuracy.append(logs.get("val_acc"))
        self.losses.append(logs.get("loss"))
        self.val_losses.append(logs.get("val_loss"))
        self.learning_rates.append(logs.get("learning_rate"))
        bva = max(self.val_accuracy)
        _line_plot(
            self.save_path_accu, [(self.accuracy, "train"), (self.val_accuracy, "valid")],
            f"best_val@{self.val_accuracy.index(bva)}-{bva:.2f}", ylim=(0.0, 1.0),
        )
        bvl = min(self.val_losses)
        _line_plot(
            self.save_path_loss, [(self.losses, "train"), (self.val_losses, "valid")],
            f"best_val@{self.val_losses.index(bvl)}-{bvl:.2f}", ylim=(0.0, float(self.init_loss)),
        )
        _line_plot(
            self.save_path_lr, [(self.learning_rates, "")],
            f"lr max {max(self.learning_rates):.6f} min {min(self.learning_rates):.6f}",
        )
