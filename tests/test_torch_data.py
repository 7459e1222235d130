"""The port's data layer (``ivf_tpu_torch/data/``, ``ivf_tpu_torch/native``)
against the JAX package's (``ivf_tpu/data/``, ``ivf_tpu/native``), and
mirrors of ``tests/test_data.py``, ``tests/test_tfrecords.py`` and
``tests/test_frames.py`` on the port.

Catalogs and samplers give the JAX package's items and indices. The
frame-tree, KTH and record datasets give the JAX package's arrays, labels
and ids exactly (the same decoder on the same bytes): over one frame tree
drawn from a numpy seed, over ``.ivfrecords`` shards written by one
package and read by the other (the writers' bytes are equal), and over a
handcrafted ``.tfrecords`` file. ``ClipLoader`` batches equal the JAX
``ClipLoader``'s (``to_device=False``) with shuffle, ``set_epoch`` and
skip. Every comparison is exact: uint8 arrays, ints and strings.
"""

import io
import os
import shutil
import subprocess
import threading
from collections import namedtuple

import numpy as np
import pytest
import torch

import ivf_tpu.data as jdata
import ivf_tpu_torch.data as tdata
from ivf_tpu import native as jnative
from ivf_tpu.data import frames as jframes
from ivf_tpu.data import kth as jkth
from ivf_tpu.data import loaders as jloaders
from ivf_tpu.data import tfrecords as jtf
from ivf_tpu_torch import native as tnative
from ivf_tpu_torch.data import frames as tframes
from ivf_tpu_torch.data import kth as tkth
from ivf_tpu_torch.data import loaders as tloaders
from ivf_tpu_torch.data import tfrecords as ttf
from ivf_tpu_torch.data.records import decode_jpeg

Item = namedtuple("Item", "id label path")


def _jpeg(arr) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.asarray(arr, np.uint8)).save(buf, "JPEG", quality=95)
    return buf.getvalue()


def _make_frame_tree(root, n_classes=2, clips_per_class=2, t=4, hw=16, seed=0):
    rng = np.random.RandomState(seed)
    for c in range(n_classes):
        for k in range(clips_per_class):
            d = os.path.join(str(root), str(c), f"clip{c}_{k}")
            os.makedirs(d)
            for i in range(t):
                with open(os.path.join(d, f"frame{i + 1:02d}.jpg"), "wb") as f:
                    f.write(_jpeg(rng.randint(0, 255, (hw, hw, 3))))


def _make_kth_tree(root, n=3, t=4, h=12, w=10, seed=0):
    rng = np.random.RandomState(seed)
    for idx in range(n):
        d = root / str(idx)
        d.mkdir(parents=True)
        for i in range(t):
            (d / f"frame{i + 1:02d}.jpg").write_bytes(_jpeg(rng.randint(0, 255, (h, w, 3))))
        (d / "class.txt").write_text(f"{idx % 2}\n")
        (d / "label.txt").write_text(f"person{idx:02d}_boxing_d1_1\n")
    # stray non-clip dirs (no class.txt) are skipped by dataset and catalog
    (root / "plots").mkdir()
    (root / ".ipynb_checkpoints").mkdir()


def _smooth_clips(n=3, t=4, h=12, w=10):
    yy, xx = np.mgrid[0:h, 0:w]
    base = ((yy * 10 + xx * 5) % 256).astype(np.uint8)
    return [np.stack([np.stack([base + 3 * i + k] * 3, axis=-1) for i in range(t)]) for k in range(n)]


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert len(a) == len(b)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype == np.uint8
        assert tuple(a[1:]) == tuple(b[1:])


# -- catalogs and samplers --------------------------------------------------


def test_smth_catalog_is_the_jax_packages(tmp_path):
    labels = ["Holding something", "Opening something"]
    (tmp_path / "labels.json").write_text(__import__("json").dumps(labels))
    items = [{"id": "42", "template": "Holding [something]"}, {"id": "43", "template": "Opening [something]"}]
    (tmp_path / "train.json").write_text(__import__("json").dumps(items))
    args = (str(tmp_path / "train.json"), str(tmp_path / "labels.json"), "/data", ".webm")
    for is_test in (False, True):
        got = tdata.SmthSmthCatalog(*args, is_test=is_test)
        want = jdata.SmthSmthCatalog(*args, is_test=is_test)
        assert [tuple(i) for i in got.items] == [tuple(i) for i in want.items]
        assert got.classes_dict == want.classes_dict
        assert [got.label_index(i) for i in got.items] == [want.label_index(i) for i in want.items]
    assert got.items[1].path == "/data/43.webm"
    bad = [{"id": "44", "template": "Pushing [something]"}]
    (tmp_path / "bad.json").write_text(__import__("json").dumps(bad))
    with pytest.raises(ValueError, match="Label mismatch"):
        tdata.SmthSmthCatalog(str(tmp_path / "bad.json"), str(tmp_path / "labels.json"), "/data")


def test_dir_catalogs_are_the_jax_packages(tmp_path):
    _make_frame_tree(tmp_path / "frames")
    _make_kth_tree(tmp_path / "kth")
    got, want = tdata.FrameDirCatalog(str(tmp_path / "frames")), jdata.FrameDirCatalog(str(tmp_path / "frames"))
    assert [tuple(i) for i in got.items] == [tuple(i) for i in want.items] and got.classes == want.classes
    got, want = tdata.KTHDirCatalog(str(tmp_path / "kth")), jdata.KTHDirCatalog(str(tmp_path / "kth"))
    assert [tuple(i) for i in got.items] == [tuple(i) for i in want.items]
    assert len(got) == 3 and got.items[2].id == "person02_boxing_d1_1"


@pytest.mark.parametrize("start,end,n", [(1, 4, 6), (1, 20, 5), (3, 40, 16), (0, 31, 32), (5, 6, 4)])
def test_samplers_are_the_jax_packages(start, end, n):
    assert tdata.sample_all(start, end) == jdata.sample_all(start, end)
    assert tdata.sample_fixed_count(start, end, n) == jdata.sample_fixed_count(start, end, n)
    got = tdata.sample_cohesive_crop(start, end, n, np.random.RandomState(3))
    assert got == jdata.sample_cohesive_crop(start, end, n, np.random.RandomState(3))
    assert len(got) == n


# -- datasets ---------------------------------------------------------------


@pytest.mark.parametrize("get_item_id", [False, True])
def test_frame_dir_dataset_is_the_jax_packages(tmp_path, get_item_id):
    _make_frame_tree(tmp_path, t=6)
    for step in (1, 2):
        got = tloaders.FrameDirDataset(str(tmp_path), clip_size=3, step_size=step, get_item_id=get_item_id)
        want = jloaders.FrameDirDataset(str(tmp_path), clip_size=3, step_size=step, get_item_id=get_item_id)
        _assert_items_equal(got, want)
        for i in range(len(want)):
            a, b = got.get_payloads(i), want.get_payloads(i)
            assert a == b
    assert got[0][0].shape == (3, 16, 16, 3)


def test_kth_dataset_is_the_jax_packages(tmp_path):
    _make_kth_tree(tmp_path)
    got = tloaders.KTHFrameDataset(str(tmp_path), clip_size=4, get_item_id=True)
    want = jloaders.KTHFrameDataset(str(tmp_path), clip_size=4, get_item_id=True)
    _assert_items_equal(got, want)
    assert [got.get_payloads(i) for i in range(3)] == [want.get_payloads(i) for i in range(3)]
    clip, label, tag = got[1]
    assert clip.shape == (4, 12, 10, 3) and label == 1 and tag == "person01_boxing_d1_1"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_records_cross_read(tmp_path, writer):
    """Shards written by one package read in the other as in itself, and
    both writers give the same bytes."""
    clips = _smooth_clips()
    paths = {}
    for name, mod in (("port", tdata), ("jax", jdata)):
        paths[name] = str(tmp_path / f"{name}.ivfrecords")
        with mod.RecordWriter(paths[name]) as w:
            for i, c in enumerate(clips):
                w.write(c, label=i, video_id=f"vid{i}", extra={"subject": 7})
    with open(paths["port"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    path = paths[writer]
    r_t, r_j = tdata.RecordReader(path), jdata.RecordReader(path)
    assert len(r_t) == len(r_j) == 3
    for i in range(3):
        (mt, ft), (mj, fj) = r_t.read(i), r_j.read(i)
        assert mt == mj and mt["subject"] == 7 and r_t.read_meta(i) == r_j.read_meta(i)
        np.testing.assert_array_equal(ft, fj)
        assert r_t.read(i, decode=False) == r_j.read(i, decode=False)
    # JPEG is lossy: close to what was written
    assert np.mean(np.abs(r_t.read(1)[1].astype(int) - clips[1].astype(int))) < 20
    r_t.close()
    r_j.close()
    for clip_size in (None, 2, 6):
        got = tloaders.RecordDataset(path, clip_size=clip_size, get_item_id=True)
        want = jloaders.RecordDataset(path, clip_size=clip_size, get_item_id=True)
        _assert_items_equal(got, want)
        assert [got.get_payloads(i) for i in range(3)] == [want.get_payloads(i) for i in range(3)]
    assert got[2][0].shape == (6, 12, 10, 3)  # padded with the last frame


def test_record_writer_no_partial_shard_on_error(tmp_path):
    path = str(tmp_path / "partial.ivfrecords")
    frame = np.zeros((4, 8, 8, 3), np.uint8)
    with pytest.raises(RuntimeError):
        with tdata.RecordWriter(path) as w:
            w.write(frame, label=0, video_id="a")
            raise RuntimeError("corrupt input mid-build")
    assert not os.path.exists(path)
    with tdata.RecordWriter(path) as w:
        w.write([_jpeg(f) for f in frame], label=0, video_id="a")  # pre-encoded frames
    r = tdata.RecordReader(path)
    assert len(r) == 1 and r.read_meta(0)["nb_frames"] == 4
    r.close()


def test_record_reader_thread_safety(tmp_path):
    path = str(tmp_path / "c.ivfrecords")
    with tdata.RecordWriter(path) as w:
        for k, clip in enumerate(_smooth_clips(n=20, t=3)):
            w.write(clip, label=k, video_id=f"v{k}")
    r = tdata.RecordReader(path)
    errors = []

    def worker(seed):
        rng = np.random.RandomState(seed)
        for _ in range(50):
            i = int(rng.randint(0, 20))
            try:
                meta, frames = r.read(i)
                assert meta["label"] == i and frames.shape == (3, 12, 10, 3)
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(8)]
    [t.start() for t in threads]
    [t.join(timeout=60) for t in threads]
    assert not any(t.is_alive() for t in threads) and not errors, errors[:3]
    r.close()


def test_kth_subject_records_are_the_jax_packages(tmp_path):
    """Per-subject shards from a labels CSV (every sampling mode) and the
    subject split: the same shards, bytes and paths as the JAX package."""
    rng = np.random.RandomState(1)
    for s in (17, 18):
        for clip in ("a", "b"):
            d = tmp_path / "frames" / str(s) / f"person{s}_{clip}"
            d.mkdir(parents=True)
            for i in range(1, 13):
                (d / f"frame{i:02d}.jpg").write_bytes(_jpeg(rng.randint(0, 255, (8, 10, 3))))
    csv = tmp_path / "labels.csv"
    csv.write_text(
        "subject,clip_name,label,1_start,1_end,2_start,2_end\n"
        "17,person17_a,0,1,9,10,12\n17,person17_b,3,2,2,,\n18,person18_a,1,1,12,nan,nan\n"
        "18,person18_b,5,4,11,1,3\n"
    )
    counts = tmp_path / "subjects_clips.csv"
    counts.write_text("nb_clips\n" + "".join(f"{s}\n" for s in range(1, 26)))
    for mode in ("all", "sample", "sample_cohesive_crop"):
        out = {}
        for name, mod in (("port", tkth), ("jax", jkth)):
            out[name] = mod.write_kth_subject_records(
                str(csv), str(tmp_path / "frames"), str(tmp_path / f"{name}_{mode}"), mode=mode, nb_frames=6,
                subjects=(17, 18), seed=3,
            )
        assert [os.path.basename(p) for p in out["port"]] == [os.path.basename(p) for p in out["jax"]]
        for a, b in zip(out["port"], out["jax"]):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
    split = (str(tmp_path), (1, 17), (18, 25), str(counts))
    assert tkth.subject_split_paths(*split) == jkth.subject_split_paths(*split)
    assert tkth.subject_split_paths(*split[:3]) == jkth.subject_split_paths(*split[:3])


# -- tfrecords --------------------------------------------------------------


def test_crc32c_known_vectors():
    assert ttf.crc32c(b"") == 0
    assert ttf.crc32c(b"123456789") == 0xE3069283
    assert ttf.crc32c(b"\x00" * 32) == 0x8A9136AA
    for data in (b"", b"abc", bytes(range(256))):
        assert ttf.masked_crc32c(data) == jtf.masked_crc32c(data)


def test_masked_crc_framing(tmp_path):
    path = str(tmp_path / "t.tfrecords")
    payloads = [b"hello", b"", b"x" * 1000]
    ttf.write_tfrecord(path, payloads)
    assert [p for _, p in ttf.iter_tfrecord_offsets(path, verify_crc=True)] == payloads
    assert list(ttf.iter_tfrecord_offsets(path)) == list(jtf.iter_tfrecord_offsets(path))
    data = bytearray(open(path, "rb").read())
    data[12] ^= 0xFF
    bad = tmp_path / "bad.tfrecords"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="bad data crc"):
        list(ttf.iter_tfrecord_offsets(str(bad), verify_crc=True))
    junk = tmp_path / "junk.tfrecords"
    junk.write_bytes(b"not a tfrecord file at all....")
    with pytest.raises(ValueError, match="bad length crc"):
        list(ttf.iter_tfrecord_offsets(str(junk)))


def _varint(v):
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        out += bytes([b | (0x80 if v else 0)])
        if not v:
            return out


def _ld(field, payload):
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _handcrafted_example(video_id: bytes, label: int, frames, h: int, w: int, packed_label=False):
    """An Example with the reference's six features, byte by byte from the
    proto wire format (not through either package's writer)."""
    def int64_feature(v):
        return _ld(3, _ld(1, _varint(v)) if packed_label else _varint(1 << 3) + _varint(v))

    feats = b""
    for k, fv in (
        (b"nb_frames", _ld(3, _varint(1 << 3) + _varint(len(frames)))),
        (b"height", _ld(3, _varint(1 << 3) + _varint(h))),
        (b"width", _ld(3, _varint(1 << 3) + _varint(w))),
        (b"label", int64_feature(label)),
        (b"video_id", _ld(1, _ld(1, video_id))),
        (b"frames", _ld(1, b"".join(_ld(1, f) for f in frames))),
    ):
        feats += _ld(1, _ld(1, k) + _ld(2, fv))
    return _ld(1, feats)


def test_parse_example_handcrafted_golden():
    ex = _handcrafted_example(b"vid42", 3, [b"JPEG1", b"JPEG22"], 4, 6)
    parsed = ttf.parse_example(ex)
    assert parsed == jtf.parse_example(ex)
    assert parsed["label"] == [3] and parsed["video_id"] == [b"vid42"]
    assert parsed["frames"] == [b"JPEG1", b"JPEG22"]
    assert ttf.build_example("vid42", 3, [b"JPEG1", b"JPEG22"], height=4, width=6) == ex
    packed = _handcrafted_example(b"v", 300, [b"J"], 1, 1, packed_label=True)
    assert ttf.parse_example(packed)["label"] == jtf.parse_example(packed)["label"] == [300]


def test_tfrecords_dataset_is_the_jax_packages(tmp_path):
    """A handcrafted ``.tfrecords`` file (JPEG frames): both readers and both
    RecordDatasets give the same meta, arrays, labels and ids."""
    yy, xx = np.mgrid[0:16, 0:20]
    frames = [np.stack([(yy * 8 + k * 30) % 256, (xx * 8) % 256, np.full_like(yy, k * 40)], -1) for k in range(3)]
    jpegs = [_jpeg(f) for f in frames]
    path = str(tmp_path / "shard.tfrecords")
    jtf.write_tfrecord(path, [_handcrafted_example(b"clip_a", 5, jpegs, 16, 20),
                              _handcrafted_example(b"clip_b", 1, jpegs[:2], 16, 20)])
    r_t, r_j = ttf.TFRecordReader(path, verify_crc=True), jtf.TFRecordReader(path, verify_crc=True)
    assert len(r_t) == len(r_j) == 2
    for i in range(2):
        assert r_t.read_meta(i) == r_j.read_meta(i)
        (mt, ft), (mj, fj) = r_t.read(i), r_j.read(i)
        assert mt == mj
        np.testing.assert_array_equal(ft, fj)
    assert r_t.read(1, decode=False) == (r_t.read_meta(1), jpegs[:2])
    assert np.mean(np.abs(r_t.read(0)[1].astype(int) - np.stack(frames).astype(int))) < 8
    r_t.close()
    r_j.close()
    for clip_size in (None, 4):
        _assert_items_equal(tloaders.RecordDataset(path, clip_size=clip_size, get_item_id=True),
                            jloaders.RecordDataset(path, clip_size=clip_size, get_item_id=True))
    ivf = str(tmp_path / "x.ivfrecords")
    with tdata.RecordWriter(ivf) as w:
        w.write(np.stack(frames).astype(np.uint8), label=0, video_id="x")
    with pytest.raises(ValueError, match="cannot mix"):
        tloaders.RecordDataset([path, ivf])


# -- the native decoder and the loader ---------------------------------------


def test_native_decode_matches_pil(tmp_path):
    """The port's native decoder gives PIL's uint8, and the JAX package's
    native decode of the same bytes."""
    if not tnative.available():
        pytest.skip("native decoder unavailable (no g++ or libjpeg headers)")
    _make_frame_tree(tmp_path)
    ds = tloaders.FrameDirDataset(str(tmp_path), clip_size=4, get_item_id=True)
    native_loader = tdata.ClipLoader(ds, batch_size=4, shuffle=False, to_device=False)
    pil_loader = tdata.ClipLoader(ds, batch_size=4, shuffle=False, to_device=False, use_native=False)
    nb, pb = next(iter(native_loader)), next(iter(pil_loader))
    assert native_loader._use_native() and not pil_loader._use_native()
    np.testing.assert_array_equal(nb[0], pb[0])
    np.testing.assert_array_equal(nb[1], pb[1])
    assert nb[2] == pb[2] and nb[0].dtype == np.uint8
    payloads = [p for i in range(len(ds)) for p in ds.get_payloads(i)[0]]
    got = tnative.decode_batch(payloads, n_threads=3)
    np.testing.assert_array_equal(got, np.stack([decode_jpeg(p) for p in payloads]))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.decode_batch(payloads, n_threads=3))
    assert tnative.jpeg_dims(payloads[0]) == (16, 16)
    with pytest.raises(ValueError, match="mismatched"):
        tnative.decode_batch(payloads[:1] + [_jpeg(np.zeros((8, 8, 3)))])
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.decode_batch(payloads[:2], out=np.empty((2, 16, 16, 4), np.uint8))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "pil"])
def test_clip_loader_batches_are_the_jax_packages(tmp_path, use_native):
    """Shuffled batches of every epoch, ``set_epoch`` with an index-level
    skip, and ``drop_last`` both ways: the JAX ClipLoader's batches."""
    _make_frame_tree(tmp_path, n_classes=3, clips_per_class=3)
    t_ds = tloaders.FrameDirDataset(str(tmp_path), clip_size=4, get_item_id=True)
    j_ds = jloaders.FrameDirDataset(str(tmp_path), clip_size=4, get_item_id=True)

    def pair(**kw):
        common = dict(batch_size=2, num_workers=2, to_device=False, use_native=use_native, seed=5, **kw)
        return tdata.ClipLoader(t_ds, **common), jdata.ClipLoader(j_ds, **common)

    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0])
            np.testing.assert_array_equal(x[1], y[1])
            assert x[1].dtype == y[1].dtype == np.int32 and x[2] == y[2]

    for drop_last in (True, False):
        t_l, j_l = pair(shuffle=True, drop_last=drop_last)
        assert len(t_l) == len(j_l) == (4 if drop_last else 5)
        epochs = [list(t_l), list(t_l)]
        same(epochs[0], list(j_l))
        same(epochs[1], list(j_l))
        assert [b[2] for b in epochs[0]] != [b[2] for b in epochs[1]]  # reshuffled
        t_l.set_epoch(1, skip_batches=2)
        j_l.set_epoch(1, skip_batches=2)
        skipped = list(t_l)
        same(skipped, list(j_l))
        assert [b[2] for b in skipped] == [b[2] for b in epochs[0]][2:]
    t_l, j_l = pair(shuffle=False, drop_last=False)
    same(list(t_l), list(j_l))


def test_clip_loader_keeps_lists_and_missing_ids():
    """In-memory lists of items load as batches; items of (clip, label)
    give 2-tuples and ids of None stay None."""
    clips = np.random.RandomState(0).randint(0, 255, (5, 2, 4, 4, 3)).astype(np.uint8)
    with_none = [(clips[i], i, None if i % 2 else f"c{i}") for i in range(5)]
    batches = list(tdata.ClipLoader(with_none, batch_size=2, drop_last=False, num_workers=2, to_device=False))
    assert [b[2] for b in batches] == [["c0", None], ["c2", None], ["c4"]]
    np.testing.assert_array_equal(np.concatenate([b[0] for b in batches]), clips)
    pairs = [(clips[i], i) for i in range(5)]
    batches = list(tdata.ClipLoader(pairs, batch_size=4, drop_last=False, num_workers=2, to_device=False))
    assert [len(b) for b in batches] == [2, 2] and batches[1][1].tolist() == [4]


def test_clip_loader_early_exit_no_leak(tmp_path):
    _make_frame_tree(tmp_path, n_classes=2, clips_per_class=8)
    ds = tloaders.FrameDirDataset(str(tmp_path), clip_size=4)
    loader = tdata.ClipLoader(ds, batch_size=2, prefetch=1, num_workers=2, to_device=False)
    before = threading.active_count()
    for _ in range(5):
        it = iter(loader)
        next(it)  # consume one batch, then abandon the iterator
        it.close()
    # producers were cancelled, not stranded on q.put
    assert threading.active_count() <= before + 1


def test_clip_loader_surfaces_a_dataset_error():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 3:
                raise KeyError("missing frame")
            return np.zeros((2, 4, 4, 3), np.uint8), 0

    with pytest.raises(KeyError, match="missing frame"):
        list(tdata.ClipLoader(Broken(), batch_size=2, num_workers=2, to_device=False))


# -- placement --------------------------------------------------------------


def test_place_keeps_uint8_on_the_given_device(tmp_path):
    _make_frame_tree(tmp_path)
    ds = tloaders.FrameDirDataset(str(tmp_path), clip_size=4, get_item_id=True)
    loader = tdata.ClipLoader(ds, batch_size=3, num_workers=2, device="cpu", drop_last=False)
    host = list(tdata.ClipLoader(ds, batch_size=3, num_workers=2, to_device=False, drop_last=False))
    placed = list(loader)
    assert loader.device == torch.device("cpu") and len(placed) == 2
    for (clips, labels, ids), (h_clips, h_labels, h_ids) in zip(placed, host):
        assert isinstance(clips, torch.Tensor) and clips.dtype == torch.uint8 and clips.device.type == "cpu"
        assert labels.dtype == torch.int32
        np.testing.assert_array_equal(clips.numpy(), h_clips)
        np.testing.assert_array_equal(labels.numpy(), h_labels)
        assert ids == h_ids  # non-array entries pass as they are


def test_place_raises_without_a_card_and_on_a_mesh(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.ClipLoader([], batch_size=2)
    tdata.ClipLoader([], batch_size=2, to_device=False)  # host batches need no device
    with pytest.raises(RuntimeError, match="process group"):  # a mesh needs the ranks' process group
        tdata.ClipLoader([], batch_size=2, mesh=object(), device="cpu")


# -- ffmpeg frame extraction --------------------------------------------------


def _fake_ffmpeg(calls, monkeypatch):
    """ffprobe reports 2.0 s; ffmpeg writes the JPEGs it was asked for."""

    def fake_check_output(cmd, **kw):
        assert cmd[0] == "ffprobe"
        calls.append(cmd)
        return b"2.0\n"

    def fake_check_call(cmd, **kw):
        assert cmd[0] == "ffmpeg"
        calls.append(cmd)
        n = int(cmd[cmd.index("-frames:v") + 1])
        for i in range(1, n + 1):
            with open(cmd[-1] % i, "wb") as f:
                f.write(_jpeg(np.full((4, 6, 3), i * 10)))
        return 0

    monkeypatch.setattr(subprocess, "check_output", fake_check_output)
    monkeypatch.setattr(subprocess, "check_call", fake_check_call)


def test_extract_frames_mocked_as_the_jax_package(tmp_path, monkeypatch):
    calls = {"port": [], "jax": []}
    for name, mod in (("port", tframes), ("jax", jframes)):
        _fake_ffmpeg(calls[name], monkeypatch)
        n = mod.extract_frames("/fake/video.webm", str(tmp_path / name), nb_frames=5, width=64)
        assert n == 5
    assert sorted(os.listdir(tmp_path / "port")) == [f"frame{i:02d}.jpg" for i in range(1, 6)]
    ffmpeg_cmd = calls["port"][1]
    assert ffmpeg_cmd[ffmpeg_cmd.index("-r") + 1] == "2.5" and "scale=64:-1" in ffmpeg_cmd
    strip = lambda cmds: [[a.replace(str(tmp_path / n), "OUT") for a in c] for c, n in cmds]  # noqa: E731
    assert strip((c, "port") for c in calls["port"]) == strip((c, "jax") for c in calls["jax"])
    assert tframes.probe_duration("/fake/video.webm") == 2.0


def test_extract_dataset_layout(tmp_path, monkeypatch):
    _fake_ffmpeg([], monkeypatch)
    items = [Item("101", "waving", "/fake/a.webm"), Item("102", "boxing", "/fake/b.webm")]
    tframes.extract_dataset(items, str(tmp_path), nb_frames=3, width=32)
    for item in items:
        assert sorted(os.listdir(tmp_path / item.label / item.id)) == ["frame01.jpg", "frame02.jpg", "frame03.jpg"]


def test_extract_frames_real_ffmpeg(tmp_path):
    if shutil.which("ffmpeg") is None or shutil.which("ffprobe") is None:
        pytest.skip("ffmpeg not installed")
    video = str(tmp_path / "clip.mp4")
    subprocess.check_call(["ffmpeg", "-y", "-v", "error", "-f", "lavfi", "-i",
                           "testsrc=duration=1:size=64x48:rate=8", video])
    assert tframes.extract_frames(video, str(tmp_path / "out"), nb_frames=4, width=32) == 4
