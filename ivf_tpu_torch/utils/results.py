"""Result persistence (copy of ``ivf_tpu/utils/results.py``).

Mirrors ``video_features_pytorch/utils.py``:
  * ``save_results``   (151-162): pickle [logits, features, targets, ids,
    class_to_idx] to ``test_results.pkl``;
  * ``get_submission`` (185-203): top-5 submission CSV
    ``id;c1;c2;c3;c4;c5`` to ``test_submission.csv``;
  * ``save_images_for_debug`` (165-183): per-batch frame PNG dumps;
  * ``ExperimentalRunCleaner`` (222-237): SIGINT handler deleting empty
    experiment dirs.
"""

from __future__ import annotations

import glob
import os
import pickle
import shutil
import sys

import numpy as np


def _run_dir(output_dir: str, model_name: str) -> str:
    path = os.path.join(output_dir, model_name)
    os.makedirs(path, exist_ok=True)
    return path


def save_results(
    logits_matrix,
    features_matrix,
    targets_list,
    item_id_list,
    class_to_idx,
    output_dir: str,
    model_name: str,
):
    path = os.path.join(_run_dir(output_dir, model_name), "test_results.pkl")
    with open(path, "wb") as f:
        pickle.dump(
            [logits_matrix, features_matrix, targets_list, item_id_list, class_to_idx],
            f,
        )
    return path


def get_submission(logits_matrix, item_id_list, output_dir: str, model_name: str):
    """Write the smth-smth-style top-5 submission CSV; returns its path."""
    logits_matrix = np.asarray(logits_matrix)
    path = os.path.join(_run_dir(output_dir, model_name), "test_submission.csv")
    with open(path, "w") as fw:
        for i, item_id in enumerate(item_id_list):
            top5 = logits_matrix[i].argsort()[-5:][::-1]
            fw.write(str(item_id))
            for elem in top5:
                fw.write(f";{elem}")
            fw.write("\n")
    return path


def save_images_for_debug(dir_img: str, clips):
    """clips: (B, T, H, W, C) float 0..1 — dump as PNGs per batch element."""
    from PIL import Image

    clips = np.asarray(clips)
    os.makedirs(dir_img, exist_ok=True)
    for b, batch in enumerate(clips):
        bdir = os.path.join(dir_img, f"batch{b + 1}")
        os.makedirs(bdir, exist_ok=True)
        for j, img in enumerate(batch):
            Image.fromarray((img * 255).astype("uint8")).save(
                os.path.join(bdir, "frame%04d.png" % (j + 1))
            )


class ExperimentalRunCleaner:
    """SIGINT handler: remove the run dir if it holds <1 file."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir

    def __call__(self, signal_num, frame):
        if len(glob.glob(self.save_dir + "/*")) < 1:
            print(f"Removing: {self.save_dir}")
            shutil.rmtree(self.save_dir)
        print("You pressed Ctrl+C!")
        sys.exit(0)
