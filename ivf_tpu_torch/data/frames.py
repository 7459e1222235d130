"""Offline frame extraction with ffmpeg, L0 data prep (copy of
``ivf_tpu/data/frames.py``).

Mirrors ``video_features_tf/create_folders_and_extract_frames.py``: probe
each video's duration with ffprobe, compute the output rate
``fps = nb_frames / duration`` so every clip yields a fixed frame count,
and extract scaled JPEGs named ``frame%02d.jpg`` into
``<out_root>/<class>/<video_id>/``.
"""

from __future__ import annotations

import os
import subprocess
from typing import Optional


def probe_duration(video_path: str) -> float:
    out = subprocess.check_output(
        [
            "ffprobe",
            "-v",
            "error",
            "-show_entries",
            "format=duration",
            "-of",
            "default=noprint_wrappers=1:nokey=1",
            video_path,
        ]
    )
    return float(out.strip())


def extract_frames(
    video_path: str,
    out_dir: str,
    nb_frames: int = 16,
    width: int = 256,
    height: Optional[int] = None,
) -> int:
    """Extract ``nb_frames`` JPEGs (frame01.jpg..) resampled over the full
    duration. Returns the number of frames written."""
    os.makedirs(out_dir, exist_ok=True)
    duration = probe_duration(video_path)
    fps = nb_frames / max(duration, 1e-6)
    scale = f"scale={width}:{height if height else -1}"
    subprocess.check_call(
        [
            "ffmpeg",
            "-y",
            "-v",
            "error",
            "-i",
            video_path,
            "-vf",
            scale,
            "-r",
            f"{fps}",
            "-frames:v",
            str(nb_frames),
            os.path.join(out_dir, "frame%02d.jpg"),
        ]
    )
    return len([f for f in os.listdir(out_dir) if f.endswith(".jpg")])


def extract_dataset(
    catalog_items,
    out_root: str,
    nb_frames: int = 16,
    width: int = 256,
):
    """Extract frames for every (id, label, path) item into
    ``out_root/<label>/<id>/`` (create_folders_and_extract_frames.py)."""
    for item in catalog_items:
        out_dir = os.path.join(out_root, str(item.label), str(item.id))
        extract_frames(item.path, out_dir, nb_frames, width)
