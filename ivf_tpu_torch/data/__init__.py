"""The data layer of the port (copy of ``ivf_tpu/data/``, with the JAX
package's exports): catalogs, samplers, the ``.ivfrecords`` and
``.tfrecords`` readers, the frame-tree / KTH / record datasets and the
prefetching ``ClipLoader``; besides, the synthetic clip dataset
(``synthetic.py``), the KTH clip whitelist (``kth_clips_of_interest.py``),
KTH shard prep (``kth.py``) and ffmpeg frame extraction (``frames.py``)."""

from ivf_tpu_torch.data.catalogs import (
    ListData,
    SmthSmthCatalog,
    FrameDirCatalog,
    KTHDirCatalog,
)
from ivf_tpu_torch.data.samplers import (
    sample_all,
    sample_fixed_count,
    sample_cohesive_crop,
)
from ivf_tpu_torch.data.records import RecordWriter, RecordReader
from ivf_tpu_torch.data.loaders import FrameDirDataset, KTHFrameDataset, ClipLoader

__all__ = [
    "ListData",
    "SmthSmthCatalog",
    "FrameDirCatalog",
    "KTHDirCatalog",
    "sample_all",
    "sample_fixed_count",
    "sample_cohesive_crop",
    "RecordWriter",
    "RecordReader",
    "FrameDirDataset",
    "KTHFrameDataset",
    "ClipLoader",
]
