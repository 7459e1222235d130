"""Frame samplers, the three offline temporal-reduction modes (copy of
``ivf_tpu/data/samplers.py``).

Mirror of ``video_features_tf/tfrecords/generate_tfrecords.py``:
  * ``sample_all`` — every frame in [start, end] (get_video_buffer, :56-73)
  * ``sample_fixed_count`` — uniform index sampling
    ``frames[ceil(i * L / n)]`` with last-frame padding when the clip is
    short (get_fixed_number_of_frames_video_buffer, :125-165 +
    get_list_of_sampled_frames, :168-175)
  * ``sample_cohesive_crop`` — a contiguous window of n frames (the file's
    get_list_of_cohesive_frames is truncated/buggy — returns all frames and
    would fail its own length assert; we implement the documented intent:
    a random contiguous crop, seeded for reproducibility)

All samplers return frame *indices*; IO is the caller's concern.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def sample_all(start_frame: int, end_frame: int) -> List[int]:
    return list(range(start_frame, end_frame + 1))


def _uniform_indices(start: int, end: int, n: int) -> List[int]:
    frames = list(range(start, end + 1))
    length = float(len(frames))
    return [frames[int(math.ceil(i * length / n))] for i in range(n)]


def sample_fixed_count(start_frame: int, end_frame: int, nb_frames: int) -> List[int]:
    total = end_frame - start_frame
    if total < nb_frames:
        assert total > 0, "empty clip"
        sampled = _uniform_indices(start_frame, end_frame, total)
        sampled += [sampled[-1]] * (nb_frames - total)
        return sampled
    return _uniform_indices(start_frame, end_frame, nb_frames)


def sample_cohesive_crop(
    start_frame: int,
    end_frame: int,
    nb_frames: int,
    rng: Optional[np.random.RandomState] = None,
) -> List[int]:
    total = end_frame - start_frame
    if total < nb_frames:
        assert total > 0, "empty clip"
        sampled = _uniform_indices(start_frame, end_frame, total)
        sampled += [sampled[-1]] * (nb_frames - total)
        return sampled
    rng = rng or np.random.RandomState(0)
    lo = int(rng.randint(start_frame, end_frame + 1 - nb_frames + 1))
    return list(range(lo, lo + nb_frames))
