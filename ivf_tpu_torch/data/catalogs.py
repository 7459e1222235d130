"""Dataset catalogs, what clips exist and what their labels are (copy of
``ivf_tpu/data/catalogs.py``).

Mirrors ``video_features_pytorch/data_parser.py``:
  * ``SmthSmthCatalog`` <- DatasetBase (lines 9-75): Something-Something
    JSON lists of {id, template}, labels JSON, two-way class dict, the
    ``[something]`` -> ``something`` template cleanup.
  * ``FrameDirCatalog`` <- PicDatabase (lines 102-160): walks
    ``root/<class>/<clip_id>/`` directories of pre-extracted frames.
  * ``KTHDirCatalog`` — the KTH loader's layout (data_loader_kth.py):
    numbered clip dirs ``root/<idx>/`` each holding frames + class.txt
    (label int) + label.txt (video tag like ``person17_boxing_d1_1``).
"""

from __future__ import annotations

import json
import os
from collections import namedtuple
from typing import Dict, List

ListData = namedtuple("ListData", ["id", "label", "path"])


def clean_template(template: str) -> str:
    """``[something]`` -> ``something`` (data_parser.py:71-75)."""
    return template.replace("[", "").replace("]", "")


class SmthSmthCatalog:
    """Something-Something JSON catalog (data_parser.py:9-75)."""

    def __init__(
        self,
        json_path_input: str,
        json_path_labels: str,
        data_root: str,
        extension: str = "",
        is_test: bool = False,
    ):
        self.data_root = data_root
        self.is_test = is_test
        with open(json_path_labels) as f:
            self.classes = sorted(json.load(f))
        self.classes_dict = self._two_way(self.classes)
        with open(json_path_input) as f:
            raw = json.load(f)
        self.items: List[ListData] = []
        for elem in raw:
            if is_test:
                label = self.classes[0]
            else:
                label = clean_template(elem["template"])
                if label not in self.classes_dict:
                    raise ValueError(f"Label mismatch: {label!r}")
            self.items.append(
                ListData(
                    elem["id"],
                    label,
                    os.path.join(data_root, str(elem["id"]) + extension),
                )
            )

    @staticmethod
    def _two_way(classes) -> Dict:
        d = {}
        for i, c in enumerate(classes):
            d[c] = i
            d[i] = c
        return d

    def label_index(self, item: ListData) -> int:
        return self.classes_dict[item.label]

    def __len__(self):
        return len(self.items)


class FrameDirCatalog:
    """Walk ``root/<class>/<clip_id>/`` frame dirs (PicDatabase)."""

    def __init__(self, data_root: str):
        self.data_root = data_root
        self.items: List[ListData] = []
        self.classes: List[int] = []
        for class_dir in sorted(next(os.walk(data_root))[1]):
            self.classes.append(int(class_dir))
            class_path = os.path.join(data_root, class_dir)
            for clip_dir in sorted(next(os.walk(class_path))[1]):
                self.items.append(
                    ListData(clip_dir, class_dir, os.path.join(class_path, clip_dir))
                )

    def __len__(self):
        return len(self.items)


class KTHDirCatalog:
    """Numbered clip dirs with class.txt / label.txt (data_loader_kth.py)."""

    def __init__(self, data_root: str):
        self.data_root = data_root
        self.items: List[ListData] = []
        # Numeric clip dirs only — KTH roots commonly carry stray dirs
        # ('plots/', '.ipynb_checkpoints/') that have no class.txt; same
        # filter as KTHFrameDataset (loaders.py).
        for idx in sorted((d for d in os.listdir(data_root) if d.isdigit()), key=int):
            path = os.path.join(data_root, idx)
            if not os.path.isdir(path):
                continue
            with open(os.path.join(path, "class.txt")) as f:
                label = f.readline().strip()
            tag_file = os.path.join(path, "label.txt")
            clip_id = idx
            if os.path.exists(tag_file):
                with open(tag_file) as f:
                    clip_id = f.readline().strip()
            self.items.append(ListData(clip_id, label, path))

    def __len__(self):
        return len(self.items)
