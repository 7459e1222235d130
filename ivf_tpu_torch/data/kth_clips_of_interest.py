"""KTH evaluation clip whitelists for the mask drivers (copy of
``ivf_tpu/data/kth_clips_of_interest.py``).

The reference's KTH mask driver hardcodes per-split lists of
(person, action, scenario, repetition) clips to interpret
(``FindMasksComparison_I3D_KTH.py:154-205``); a clip qualifies when its tag
(e.g. ``person17_boxing_d1_1``) contains all four parts. Reproduced as data
plus a matcher, the filter of ``MaskConfig.kth_clips_filter``.
"""

from __future__ import annotations

from typing import List, Sequence

_ACTIONS = ("boxing", "handclapping", "handwaving", "jogging", "running", "walking")


def _block(p1: str, p2: str, actions: Sequence[str]) -> List[List[str]]:
    out = []
    for action in actions:
        out.append([p1, action, "d1", "_1"])
        out.append([p1, action, "d2", "_1"])
        out.append([p2, action, "d3", "_1"])
        out.append([p2, action, "d4", "_1"])
    return out


# splitType == 'original' (paper split: val subjects 17-25)
CLIPS_OF_INTEREST_ORIGINAL = _block(
    "person17", "person18", _ACTIONS[:3]
) + _block("person24", "person25", _ACTIONS[3:])

# any other splitType
CLIPS_OF_INTEREST_ALTERNATE = _block(
    "person07", "person08", _ACTIONS[:3]
) + _block("person09", "person10", _ACTIONS[3:])


def clips_of_interest(split_type: str = "original") -> List[List[str]]:
    if split_type == "original":
        return CLIPS_OF_INTEREST_ORIGINAL
    return CLIPS_OF_INTEREST_ALTERNATE


def tag_matches(tag: str, split_type: str = "original") -> bool:
    """True when a KTH clip tag (person17_boxing_d1_1) is in the whitelist —
    the reference's substring-conjunction test."""
    return any(
        all(part in tag for part in parts)
        for parts in clips_of_interest(split_type)
    )
