"""KTH-specific data prep: per-subject record shards + subject splits
(copy of ``ivf_tpu/data/kth.py``).

Mirrors the TF half's KTH pipeline:
  * ``write_kth_subject_records`` <- tfrecords/script_generate_tfrecords_kth.py:
    one shard per subject; each CSV row is a clip with up to 4 action
    repetitions delimited by ``{rep}_start``/``{rep}_end`` columns; each
    valid repetition becomes one record, sampled by mode
    all | sample | sample_cohesive_crop.
  * ``subject_split_paths`` <- train_kth.py:13-34: resolve
    ``kth_subject_<s>.ivfrecords`` shard lists + sample counts for given
    train/val subject lists via ``subjects_clips.csv``.

The original-paper KTH split (the torch half's ``splitType: original``) is
subjects 1-16 train / 17-25 val, exposed as ``ORIGINAL_SPLIT``.
"""

from __future__ import annotations

import csv
import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

ORIGINAL_SPLIT = {
    "train": tuple(range(1, 17)),
    "val": tuple(range(17, 26)),
}


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _num(row: Dict[str, str], col: str) -> Optional[int]:
    v = row.get(col, "")
    if v is None or v == "" or (isinstance(v, str) and v.lower() == "nan"):
        return None
    fv = float(v)
    if math.isnan(fv):
        return None
    return int(fv)


def write_kth_subject_records(
    labels_csv: str,
    frames_root: str,
    output_folder: str,
    mode: str = "sample",
    nb_frames: int = 32,
    subjects: Sequence[int] = tuple(range(1, 26)),
    seed: int = 0,
) -> List[str]:
    """Build ``kth_subject_<s>.ivfrecords`` shards.

    frames_root layout: ``<frames_root>/<subject>/<clip_name>/frameNN.jpg``
    (frames_per_subject in the reference). Returns shard paths.
    """
    from ivf_tpu_torch.data.loaders import _load_frame
    from ivf_tpu_torch.data.records import RecordWriter
    from ivf_tpu_torch.data.samplers import (
        sample_all,
        sample_cohesive_crop,
        sample_fixed_count,
    )

    os.makedirs(output_folder, exist_ok=True)
    rows = read_csv_rows(labels_csv)
    rng = np.random.RandomState(seed)
    out_paths = []
    for s in subjects:
        srows = [r for r in rows if int(r["subject"]) == s]
        if not srows:
            continue
        path = os.path.join(output_folder, f"kth_subject_{s}.ivfrecords")
        with RecordWriter(path) as w:
            for row in srows:
                video_id = str(row["clip_name"])
                label = int(row["label"])
                clip_dir = os.path.join(frames_root, str(s), video_id)
                for rep in range(1, 5):
                    start = _num(row, f"{rep}_start")
                    end = _num(row, f"{rep}_end")
                    if start is None or end is None:
                        continue
                    if end <= start:
                        # Degenerate repetition (end == start): the samplers
                        # assert 'empty clip' — repeat the single frame
                        # instead of aborting the whole multi-subject build
                        # (same guard as cli make-records on 1-frame clips).
                        idxs = [start] if mode == "all" else [start] * nb_frames
                    elif mode == "all":
                        idxs = sample_all(start, end)
                    elif mode == "sample":
                        idxs = sample_fixed_count(start, end, nb_frames)
                    elif mode == "sample_cohesive_crop":
                        idxs = sample_cohesive_crop(start, end, nb_frames, rng)
                    else:
                        raise ValueError(mode)
                    frames = np.stack(
                        [
                            _load_frame(
                                os.path.join(clip_dir, f"frame{i:02d}.jpg")
                            )
                            for i in idxs
                        ]
                    )
                    w.write(
                        frames,
                        label=label,
                        video_id=video_id,
                        extra={"subject": s, "repetition": rep},
                    )
        out_paths.append(path)
    return out_paths


def subject_split_paths(
    records_folder: str,
    train_subjects: Sequence[int],
    val_subjects: Sequence[int],
    subjects_clips_csv: Optional[str] = None,
) -> Tuple[List[str], List[str], int, int]:
    """(train_paths, val_paths, nb_train, nb_val) — train_kth.py:13-34.

    Sample counts come from subjects_clips.csv when given (column
    ``nb_clips``, subject s at row s-1), else 0.
    """
    counts = {}
    if subjects_clips_csv:
        rows = read_csv_rows(subjects_clips_csv)
        for i, row in enumerate(rows):
            counts[i + 1] = int(row["nb_clips"])
    mk = lambda s: os.path.join(records_folder, f"kth_subject_{s}.ivfrecords")
    train_paths = [mk(s) for s in train_subjects]
    val_paths = [mk(s) for s in val_subjects]
    nb_train = sum(counts.get(s, 0) for s in train_subjects)
    nb_val = sum(counts.get(s, 0) for s in val_subjects)
    return train_paths, val_paths, nb_train, nb_val
