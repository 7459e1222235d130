"""End-to-end quickstart on synthetic data, no dataset needed (port of
``examples/quickstart.py``).

Builds a tiny two-class frame-tree dataset, trains the ConvLSTM classifier
for two epochs, runs inference, then the temporal-mask search + Grad-CAM
with visualization artifacts: the reference workflow (train_*.py ->
inference_*.py -> FindMasksComparison_*.py) through the public API.

Run:  python -m ivf_tpu_torch.quickstart [output_dir] [--cpu]

It runs on the card (``cuda``); ``--cpu`` runs it on the CPU instead.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def make_synthetic_dataset(root: str, n_classes=2, clips_per_class=4, t=8, hw=32):
    """Frame-dir layout: root/<split>/<class>/<clip>/frameNN.jpg, the smth
    JPEG layout the reference's ImLoader reads."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for split in ("train", "validation"):
        for c in range(n_classes):
            for k in range(clips_per_class):
                d = os.path.join(root, split, str(c), f"clip{c}_{k}")
                os.makedirs(d, exist_ok=True)
                for i in range(t):
                    # class-dependent brightness so the model can learn
                    arr = rng.randint(0, 100, (hw, hw, 3)) + c * 120
                    Image.fromarray(arr.astype(np.uint8)).save(os.path.join(d, f"frame{i + 1:02d}.jpg"), "JPEG")


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    device = "cpu" if "--cpu" in argv else None
    argv = [a for a in argv if a != "--cpu"]
    out_dir = argv[0] if argv else tempfile.mkdtemp(prefix="ivf_quickstart_")
    data_dir = os.path.join(out_dir, "data")
    make_synthetic_dataset(data_dir)

    from ivf_tpu_torch.api import find_masks, infer, train
    from ivf_tpu_torch.config import Config

    cfg = Config.from_dict(
        {
            "model_name": "quickstart",
            "output_dir": os.path.join(out_dir, "runs"),
            "data_folder": data_dir,
            "conv_model": "clstm",
            "num_classes": 2,
            "batch_size": 4,
            "clip_size": 8,
            "input_spatial_size": 32,
            "clstm_hidden": 4,
            "clstm_layers": 1,
            "conv_stride": 1,
            "dropout": 0.0,
            "optimizer": "ADAM",
            "lr": 0.005,
            "num_epochs": 2,
            "num_workers": 2,
        }
    )
    cfg.model.effective_steps = (3, 7)

    print("== train ==")
    state, history = train(cfg, device=device)
    print(f"val loss: {history[0]['val']['loss']:.3f} -> {history[-1]['val']['loss']:.3f}")

    print("== infer ==")
    res = infer(cfg, state=state)
    print(f"top1 {res['top1']:.1f}%  (y_true/y_hat npys saved)")

    print("== find-masks + grad-cam ==")
    cfg.mask.opt_iter = 10
    tm, gc = find_masks(cfg, state.model.state_dict(), device=device, max_batches=1, save_viz=True)
    print(f"{len(tm)} temporal masks, {len(gc)} CAM volumes")
    print(f"first mask: {np.round(tm[0]['time_mask'], 2)}")

    run_dir = os.path.join(cfg.output_dir, cfg.model_name)
    files = {}
    print(f"\nArtifacts under {run_dir}:")
    for sub in ("results", "plots", "cam_saved_images"):
        p = os.path.join(run_dir, sub)
        if os.path.isdir(p):
            files[sub] = sum(len(fs) for _, _, fs in os.walk(p))
            print(f"  {sub}/: {files[sub]} files")
    return {"history": history, "infer": res, "masks": tm, "cams": gc, "files": files}


if __name__ == "__main__":
    main()
