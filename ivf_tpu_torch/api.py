"""Public entry points of the port (port of ``ivf_tpu/api.py``):
``build_model`` (I3D and the ConvLSTM family) and ``find_masks`` (the
host-side staging loop of a validation pass: class / subset / KTH filters
and compaction across loader batches, the ``min_score`` probe, central or
random mask init, the search in one loop or in segments with the
early-stop segment skip and convergence refill, Grad-CAM, and the emission
journal under ``resume``). ``build_model`` passes the I3D kernel routes on
from the config: ``use_pallas``, ``pallas_pool`` and ``fuse_pool_conv``
(True or ``'tblock'``), each running hand-written CUDA kernels on the card.

Both run on ``cuda`` unless the caller passes ``device="cpu"`` (as the
tests do); with no GPU and no explicit device they raise rather than run
on the CPU. Float32 runs are exact float32 whatever the caller's TF32
flags (``precision.reference_numerics``). ``compute_dtype="bfloat16"`` runs
I3D (every kernel route, the fused branch 3 included) and the ConvLSTM
family in bfloat16 as the JAX package does: I3D with the argmax-index
pool on the branch-3 pools unless ``pool_impl`` was set or the branch is
fused (``_bf16_argmax_upgrade``); the ConvLSTM with bfloat16 weights and
gates and a float32 state and head.

``build_dataset`` / ``build_loader`` read the dataset a config names
(frame trees, KTH trees, ``.ivfrecords`` / ``.tfrecords`` shards) through
the prefetching ``data.loaders.ClipLoader``; ``find_masks`` walks that
loader, over ``split`` of the config's data when no dataset is given.
``grad_cam_run`` is the standalone per-clip Grad-CAM. With ``save_viz``
(the default, as in the JAX package) ``find_masks`` also writes the
reference's per-clip artifacts on its writer thread: the ClassScore txt
files, the Grad-CAM triptych JPEGs, GIFs and mask-strip PNGs, and the KTH
perturbed-sequence PNGs (``viz/render.py``, numpy and Pillow). I3D takes
every ``pool_impl`` of the JAX package (``ops/conv.py::max_pool3d_same``).

``train`` is the training driver (epochs of ``train/loop.py::fit`` with the
plateau or patience-halving schedule, best-on-val-loss and mid-epoch
checkpoints, ``resume``, the learning-curve plots and ``history.json``),
``infer`` the validation pass with its prediction files, and
``init_eval_state`` the state they start from; they build I3D, the
ConvLSTM family and ``cnn_3d`` (``find_masks`` explains the first two, as
in the JAX package). Training keeps float32 master parameters and BN
statistics in every ``compute_dtype`` and runs the kernel routes of the
config: with ``use_pallas`` the I3D's 1x1x1 convs (no bias, no ReLU, then
BN) and the ConvLSTM's sigmoid gates, with ``pallas_pool`` the branch-3
pools, in bfloat16 the argmax pool (``_bf16_argmax_upgrade``).

Not ported yet (ROADMAP.md): ``mesh`` (Queue 1 item 13) and
``pretrained_model_path`` (item 11); both raise.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import os
import pickle
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Mapping, Optional

import numpy as np
import torch

from ivf_tpu_torch.config import COMPUTE_DTYPES, POOL_IMPLS, Config
from ivf_tpu_torch.data.kth_clips_of_interest import tag_matches
from ivf_tpu_torch.data.kth import subject_split_paths
from ivf_tpu_torch.data.loaders import (
    ClipLoader,
    FrameDirDataset,
    KTHFrameDataset,
    RecordDataset,
    resolve_device,
)
from ivf_tpu_torch.interpret.gradcam import (
    convlstm_grad_cam,
    grad_cam,
    grad_cam_batched,
    i3d_grad_cam_fns,
)
from ivf_tpu_torch.interpret.perturb import perturb_sequence
from ivf_tpu_torch.interpret.mask_opt import (
    SearchCarry,
    draw_mask_random,
    finalize_search,
    find_mask_from_carry,
    init_mask_central,
    make_search_carry,
    search_segment,
)
from ivf_tpu_torch.models.convlstm import ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D
from ivf_tpu_torch.models.registry import get_model
from ivf_tpu_torch.precision import inference_model, reference_numerics_fn
from ivf_tpu_torch.viz.render import (
    PlotLearning,
    create_image_arrays,
    image_panels,
    visualize_results,
    visualize_results_on_gradcam,
)


def default_effective_steps(clip_size: int) -> tuple:
    """Reference defaults: CLSTM_4.py hardcodes [4, 8, 12, 15] for 16-frame
    clips, the KTH training script passes [7, 15, 23, 31] for 32; quarters
    minus one otherwise."""
    if clip_size == 16:
        return (4, 8, 12, 15)
    q = clip_size // 4
    return tuple(q * k - 1 for k in range(1, 5))


def _clip_hw(cfg: Config) -> tuple:
    s = cfg.data.input_spatial_size
    return tuple(s) if isinstance(s, (tuple, list)) else (s, s)


def _build_convlstm(cfg: Config, softmax: bool) -> ConvLSTMClassifier:
    """The JAX package's ConvLSTM branch of ``build_model``: the kernel from
    ``conv_kernel_size(_2)``, the padding from ``padding_clstm``, and the TF
    family's Keras forget bias and per-layer BN from ``block_order``."""
    m = cfg.model
    ksize = (
        (m.conv_kernel_size, m.conv_kernel_size_2) if m.conv_kernel_size_2 else m.conv_kernel_size
    )
    return ConvLSTMClassifier(
        head="gap" if "gap" in m.conv_model.lower() else "fc",
        num_classes=m.num_classes,
        nb_lstm_units=m.clstm_hidden,
        lstm_layers=m.clstm_layers,
        conv_kernel_size=ksize,
        conv_stride=m.conv_stride,
        pool_kernel=tuple(m.pool_kernel),
        effective_steps=tuple(m.effective_steps) or default_effective_steps(cfg.data.clip_size),
        batch_norm=m.batch_norm,
        dropout_rate=m.dropout,
        use_entire_seq=m.use_entire_seq,
        add_softmax=softmax,
        block_order=m.block_order,
        pooling=m.pooling,
        recurrent_activation=m.recurrent_activation,
        unit_forget_bias=m.block_order == "tf",
        x_padding="valid" if m.padding_clstm == "valid" else "torch",
        shared_bn=m.block_order != "tf",
        use_pallas=m.use_pallas,
        input_size=_clip_hw(cfg),
        clip_len=cfg.data.clip_size,
    )


def _is_kth_run(cfg: Config) -> bool:
    """A KTH-family run, as the JAX package's ``_is_kth_run`` decides it
    (``ivf_tpu/api.py:478-486``): 'kth' in the model or run name, or the
    KTH-only per-subject record shards. ``find_masks`` then also renders
    the perturbed sequence itself."""
    return (
        "kth" in cfg.model.conv_model.lower()
        or "kth" in cfg.model_name.lower()
        or bool(cfg.data.train_subjects or cfg.data.val_subjects)
    )


def _bf16_argmax_upgrade(cfg: Config) -> Config:
    """The argmax-index pool on the bfloat16 path, as the JAX package's
    ``_bf16_argmax_upgrade``: engaged only where the caller left
    ``pool_impl`` at its default, on a copy, so the caller's config is
    untouched. Float32 runs never change."""
    if cfg.model.compute_dtype == "bfloat16" and cfg.model.pool_impl == "reduce_window":
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pool_impl="argmax"))
    return cfg


def _model_dtype(cfg: Config) -> torch.dtype:
    m = cfg.model
    if m.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={m.compute_dtype!r}: one of {COMPUTE_DTYPES}")
    if m.pool_impl not in POOL_IMPLS:
        raise NotImplementedError(f"pool_impl={m.pool_impl!r}: one of {POOL_IMPLS}")
    return torch.float32 if m.compute_dtype == "float32" else torch.bfloat16


def _construct_model(cfg: Config, softmax: bool):
    """The configured model in float32 on the CPU (eval mode), its weights
    drawn from ``cfg.seed``."""
    m = cfg.model
    name = m.conv_model.lower()
    if "i3d" in name:
        kwargs = dict(
            num_classes=m.num_classes,
            dropout_rate=m.dropout,
            softmax=softmax,
            last_relu=m.last_relu,
            last_stride=m.last_stride,
            stride_mod_layers=tuple(m.stride_mod_layers),
            use_pallas=m.use_pallas,
            pallas_pool=m.pallas_pool,
            fuse_pool_conv=m.fuse_pool_conv,
            pool_impl=m.pool_impl,
        )
        if "kth" in name:
            kwargs["final_time_length"] = m.final_temp_time
        model = get_model(m.conv_model, **kwargs)
    elif "clstm" in name or "convlstm" in name:
        model = _build_convlstm(cfg, softmax)
    else:
        # cnn_3d: the JAX package passes the class count alone (its dropout
        # keeps the model's default); nn.Linear needs the clip geometry
        model = get_model(
            m.conv_model, num_classes=m.num_classes, input_size=_clip_hw(cfg), clip_len=cfg.data.clip_size
        )
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    return model


def build_model(cfg: Config, softmax_override: Optional[bool] = None, device=None):
    """The configured model in eval mode on ``device``, its weights drawn
    from ``cfg.seed``. Routed by substring of ``conv_model`` as in the JAX
    package: 'i3d' builds an I3D, 'clstm' or 'convlstm' (e.g. the
    ``clstm_kth`` preset, which is no registry key) a ConvLSTMClassifier,
    anything else the registry's model (``cnn_3d``).
    With ``compute_dtype='bfloat16'`` the float32 init is cast to
    bfloat16, every parameter and buffer, BN statistics included (the
    search's model; ``train`` keeps a float32 master instead); the I3D
    takes ``pool_impl`` as given (``find_masks`` upgrades it first)."""
    dtype = _model_dtype(cfg)
    softmax = cfg.model.soft_max if softmax_override is None else softmax_override
    return inference_model(_construct_model(cfg, softmax), dtype, resolve_device(device))


def build_dataset(cfg: Config, split: str = "train", get_item_id: bool = False):
    """The dataset of ``split`` as the config names it (``ivf_tpu/api.py::
    build_dataset``): record shards for ``input_mode`` 'records' or
    'tfrecords' (the split's ``record_paths_*``, else ``record_paths``,
    else the KTH per-subject shards of ``records_folder``), a KTH tree of
    numbered clip dirs when ``conv_model`` names KTH (the eval split falls
    back from ``validation`` to ``test``, then to the flat root), else a
    ``<data_folder>/<split>/<class>/<clip_id>/`` frame tree read at the
    split's step size."""
    d = cfg.data
    if d.input_mode in ("records", "tfrecords"):
        paths = list(d.record_paths_train if split == "train" else d.record_paths_val) or list(d.record_paths)
        if not paths and d.records_folder and (d.train_subjects or d.val_subjects):
            tr, va, _, _ = subject_split_paths(
                d.records_folder, d.train_subjects, d.val_subjects, d.subjects_clips_csv or None
            )
            paths = tr if split == "train" else va
        return RecordDataset(paths, clip_size=d.clip_size, get_item_id=get_item_id)
    root = os.path.join(d.data_folder, split)
    if "kth" in cfg.model.conv_model.lower():
        if split == "validation" and not os.path.isdir(root):
            # the reference's KTH layout names the eval split 'test'
            alt = os.path.join(d.data_folder, "test")
            if os.path.isdir(alt):
                root = alt
        if not os.path.isdir(root):
            root = d.data_folder  # a flat numbered-dir layout has no splits
        return KTHFrameDataset(root, clip_size=d.clip_size, get_item_id=get_item_id)
    return FrameDirDataset(
        root,
        clip_size=d.clip_size,
        step_size=d.step_size_train if split == "train" else d.step_size_val,
        get_item_id=get_item_id,
    )


def build_loader(
    cfg: Config, dataset, shuffle: bool, mesh=None, drop_last: bool = True, to_device: bool = True,
    device=None,
) -> ClipLoader:
    """A ``ClipLoader`` of ``cfg.data.batch_size`` over ``dataset`` with the
    config's decode threads and seed; with ``to_device`` its batches go to
    ``device`` (``cuda`` unless given). ``mesh`` raises (not ported)."""
    return ClipLoader(
        dataset,
        batch_size=cfg.data.batch_size,
        shuffle=shuffle,
        drop_last=drop_last,
        num_workers=cfg.data.num_workers,
        mesh=mesh,
        to_device=to_device,
        seed=cfg.seed,
        device=device,
    )


MASK_INITS = ("central", "random")


def _check_supported(cfg: Config) -> None:
    name = cfg.model.conv_model.lower()
    if not any(k in name for k in ("i3d", "clstm", "convlstm")):
        # the JAX package's find_masks has Grad-CAM for these two families only
        raise NotImplementedError(f"find_masks explains I3D and the ConvLSTM family, not {cfg.model.conv_model!r}")
    mk = cfg.mask
    if mk.mask_init_type not in MASK_INITS:
        raise ValueError(f"mask_init_type={mk.mask_init_type!r}: one of {MASK_INITS}")
    if mk.chunk_steps is not None and mk.chunk_steps < 1:
        raise ValueError(f"chunk_steps={mk.chunk_steps}: a positive step count, or None")


class _AsyncWriter:
    """One background thread for the host writes of ``find_masks`` (the
    viz artifacts and the emission journal), so that they overlap the next
    flush's device work (``ivf_tpu/api.py:53-100``). Device work and the
    result lists stay on the calling thread. At most ``max_pending`` jobs
    are in flight; a worker's error re-raises on a later ``submit`` or at
    ``close``.
    ``enabled=False`` runs each job inline."""

    def __init__(self, enabled: bool, max_pending: int = 2):
        self._ex = None
        self._pending: list = []
        self._max_pending = max_pending
        if enabled:
            self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ivf-torch-writer")

    def submit(self, fn) -> None:
        if self._ex is None:
            fn()
            return
        while len(self._pending) >= self._max_pending:
            self._pending.pop(0).result()  # re-raises a worker's error
        self._pending.append(self._ex.submit(fn))

    def close(self, raise_errors: bool = True) -> None:
        """Wait for every job and stop the worker. ``raise_errors=False``
        (the body already failed) still waits, but swallows the worker's
        error so that it does not hide the body's."""
        err = None
        for f in self._pending:
            try:
                f.result()
            except Exception as e:  # noqa: BLE001 (re-raised below)
                err = err or e
        self._pending.clear()
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None
        if err is not None and raise_errors:
            raise err


class _EmissionJournal:
    """Append-only pickle stream of per-clip emission records under
    ``find_masks(..., resume=True)`` (``ivf_tpu/api.py:102-150``), at
    ``results/emission_journal.p``: ``{"video_id", "mask": dict | None,
    "cam": dict | None}`` per emitted clip, ``{"video_id", "skip": True}``
    per ``min_score`` reject, numpy arrays inside. It is the JAX package's
    format, so either package reads the other's journal. One
    ``append_many`` per flush, fsync'd; ``load`` keeps the last record per
    id and stops at a torn tail (the intact prefix restores, the rest runs
    again)."""

    def __init__(self, path: str, fresh: bool):
        self._path = path
        self._lock = threading.Lock()
        if fresh and os.path.exists(path):
            os.remove(path)  # never mix two runs' records

    def append_many(self, records) -> None:
        with self._lock, open(self._path, "ab") as f:
            for rec in records:
                pickle.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())

    @staticmethod
    def load(path: str) -> dict:
        """id -> record, the last write winning; robust to a torn tail."""
        out: dict = {}
        if not os.path.exists(path):
            return out
        with open(path, "rb") as f:
            while True:
                try:
                    rec = pickle.load(f)
                except EOFError:
                    break
                except Exception:
                    break  # a record torn by a crash mid-append
                out[str(rec["video_id"])] = rec
        return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pad_rows(rows: list, b: int) -> list:
    """``rows`` padded to ``b`` by repeating its first row, as the JAX
    package's ``_pad_np`` (``ivf_tpu/api.py:1010-1015``)."""
    return rows + [rows[0]] * (b - len(rows))


def _carry_map(fn, *carries: SearchCarry) -> SearchCarry:
    """``fn`` applied field by field (``aux`` part by part) across carries."""
    out = {}
    for f in dataclasses.fields(SearchCarry):
        parts = [getattr(c, f.name) for c in carries]
        out[f.name] = tuple(fn(*p) for p in zip(*parts)) if f.name == "aux" else fn(*parts)
    return SearchCarry(**out)


@reference_numerics_fn
def find_masks(
    cfg: Config,
    weights: Optional[Mapping[str, torch.Tensor]],
    dataset=None,
    stats: Optional[dict] = None,
    device=None,
    *,
    split: str = "validation",
    do_gradcam: bool = True,
    run_temp_mask: bool = True,
    max_batches: Optional[int] = None,
    resume: bool = False,
    save_viz: bool = True,
):
    """Temporal-mask search + Grad-CAM over ``dataset`` (items
    ``(clip_uint8 (T, H, W, 3), label, clip_id)``, or ``(clip, label)``:
    the id is then ``b{loader batch}_{row}``, as it is for an id of None),
    read through ``build_loader`` (``cfg.data.num_workers`` threads,
    batches prefetched) in loader batches of ``cfg.data.batch_size``
    consecutive items (``max_batches`` of them at most), as
    ``ivf_tpu/api.py::find_masks`` (``:940-1596``) runs them. With
    ``dataset=None`` it is ``build_dataset(cfg, split, get_item_id=True)``:
    the config's frame tree, KTH tree or record shards.

    Filters, per loader batch: ``mask.class_oi`` (the label),
    ``mask.subset_file`` (a CSV whose first column lists the ids to keep),
    ``mask.kth_clips_filter`` (the KTH whitelist of ``cfg.split_type``) and,
    on resume, the journaled ids. Kept clips (each copied) collect across
    loader batches, and a flush launches only on a full batch, but for
    one final flush padded to the batch size by repeating its first row
    (the padded rows are dropped before emission), so every launch has one
    batch shape. With ``mask.min_score > 0`` kept clips first go through
    a probe of their class scores, in full batches too; a clip survives
    when its true-class probability is ``>= min_score`` and carries the
    probe's scores, so its flush skips its own class-score forward; a
    rejected clip is journaled as a skip.

    Per flush: the class-score forward, targets (argmax for 'guessed',
    labels for 'true'), the mask init (central, or with
    ``mask_init_type='random'`` drawn per clip id on the CPU:
    ``mask_opt.draw_mask_random``), the ``opt_iter``-step search (with
    ``early_stop``/``eta_patience``), finalize, Grad-CAM (I3D: at
    ``cfg.mask.top_layer``; ConvLSTM: on the last layer's hidden sequence).
    The search runs as one loop, or with ``mask.chunk_steps`` as segments
    (``interpret/mask_opt.py::search_segment``) that stop launching once
    every row froze; with ``mask.refill`` (on by default when chunked under
    ``early_stop``) frozen rows retire at each segment boundary and the
    survivors re-stage, with their exact carry rows, into queues that flush
    again as full batches (``ivf_tpu/api.py:1323-1445``).
    ``run_temp_mask=False`` runs no search (Grad-CAM alone);
    ``do_gradcam=False`` emits no CAMs.

    With ``save_viz`` (and a search run) each emitted clip gets a folder
    ``<output_dir>/<model_name>/cam_saved_images/<label>/<id>g_<pred>_gs<guess
    score:5.4f>_cs<true-class score:5.4f>/combined`` holding
    ``ClassScore{Freeze,Reverse}case<id>.txt`` (its two scores), with
    ``do_gradcam`` the ``create_image_arrays`` files of the snapped
    freeze and reverse perturbations (the JAX package's tree: the reverse
    pass's ``img*.jpg`` and ``mygif.gif``, which overwrite the freeze
    pass's there, so the port does not write the freeze pass's), and in a
    KTH run (``_is_kth_run``) the ``visualize_results`` PNGs of
    the unsnapped ``mask_perturb_type`` perturbation (``ivf_tpu/api.py:
    1172-1288``). The perturbations run batched on the device; the
    rendering runs on the writer thread.

    Each emitted clip is journaled to ``results/emission_journal.p``
    (``_EmissionJournal``; on the writer thread unless
    ``mask.async_viz=False``; under ``save_viz`` after the clip's
    artifacts, so a journaled clip has its files). A fresh run removes an
    old journal; ``resume=True`` restores its records (a record that lacks a part this
    run needs runs again in full), probes no journaled skip again, and runs
    only the rest. Per clip the bits do not depend on which clips share a
    flush (every op is row-independent at a fixed batch shape), so a
    resumed, compacted or refilled run gives each clip the bits of an
    uninterrupted, unfiltered one; results come in staging order, or
    retirement order under refill, restored records first. ``weights`` is
    a state dict for the model (e.g. from ``utils.convert``); None keeps
    the seeded init. With ``compute_dtype='bfloat16'`` the weights are
    rounded to bfloat16 as they load, the clips stay float32 up to the
    first conv, the class scores are upcast to float32, and the mask logits
    and Adam state are float32, as in the JAX package; I3D's CAMs are
    bfloat16 values returned as float32, the ConvLSTM's are float32.

    Returns (time_mask_results, grad_cam_results), lists of per-clip dicts
    with the reference's key names, also pickled to
    ``<output_dir>/<model_name>/results/all{TimeMask,GradCam}Results_
    <model_name>_<class_oi>_.p``. ``stats`` (a dict) receives the
    reference's counters (``score_launches``, ``search_launches``,
    ``searched_rows``, ``padded_rows``, ``n_steps_run`` per clip,
    ``segments_launched``, ``segment_seconds``, ``refill_flushes``,
    ``refill_requeued_rows``, ``resumed_clips``, ``resumed_skipped``; under
    ``early_stop`` the ``early_stop_summary``, also printed) and the host
    seconds of the mask init and of the search, finalize included
    (``init_seconds``, ``search_seconds``; device-synchronized); all but
    ``n_steps_run`` also go to ``results/search_stats.json`` when a search
    or Grad-CAM ran.

    Not ported yet (ROADMAP.md, Queue 1): ``mesh`` (one device).
    """
    _check_supported(cfg)
    cfg = _bf16_argmax_upgrade(cfg)
    mk = cfg.mask
    dev = resolve_device(device)
    if dataset is None:
        dataset = build_dataset(cfg, split, get_item_id=True)
    # clips stay on the host until a full compacted batch is ready
    loader = build_loader(cfg, dataset, False, drop_last=False, to_device=False)
    model = build_model(cfg, softmax_override=True, device=dev)
    if weights is not None:
        model.load_state_dict(weights)  # copy_ rounds to the model's dtype
    model.requires_grad_(False)

    def score_fn(clips):  # float32 class probabilities, (B, num_classes)
        return model(clips).float()

    norm_frame = mk.normalization_mode == "frame"
    if isinstance(model, I3D):
        ffn, hfn = i3d_grad_cam_fns(model, mk.top_layer)
        cam_fn = lambda clips, targets: grad_cam_batched(  # noqa: E731
            ffn, hfn, clips, targets, normalize_per_frame=norm_frame
        )
    else:
        # the torch family's Grad-CAM weighs channels by the mean gradient
        # over (T, H, W) ('global'); the TF family's per frame
        wmode = "per_frame" if cfg.model.block_order == "tf" else "global"
        cam_fn = lambda clips, targets: convlstm_grad_cam(  # noqa: E731
            model, clips, targets, normalize_per_frame=norm_frame, weight_mode=wmode
        )
    search_kwargs = dict(
        lam1=mk.lam1,
        lam2=mk.lam2,
        lr=mk.opt_lr,
        perturbation_type=mk.mask_perturb_type,
        early_stop=mk.early_stop,
        eta=mk.eta,
        closed_form=mk.closed_form,
        eta_patience=mk.eta_patience,
    )
    bsz = cfg.data.batch_size
    chunk = mk.chunk_steps or mk.opt_iter
    chunked = chunk < mk.opt_iter
    n_full, rem = divmod(mk.opt_iter, chunk) if chunked else (0, 0)
    refill_on = (
        run_temp_mask and chunked and mk.early_stop
        and (mk.refill if mk.refill is not None else True)
    )
    subset_ids = None
    if mk.subset_file:
        with open(mk.subset_file) as f:
            subset_ids = {row[0] for row in csv.reader(f) if row}
    time_mask_results, grad_cam_results = [], []
    save_dir = os.path.join(cfg.output_dir, cfg.model_name)
    is_kth = _is_kth_run(cfg)
    results_path = os.path.join(save_dir, "results")
    os.makedirs(results_path, exist_ok=True)

    # the emission journal: restore what an interrupted run finished
    journal_path = os.path.join(results_path, "emission_journal.p")
    done_ids: set = set()
    resumed_clips = resumed_skipped = 0
    if resume:
        for vid, rec in _EmissionJournal.load(journal_path).items():
            if rec.get("skip"):
                done_ids.add(vid)
                resumed_skipped += 1
                continue
            # a record serves this run only with every part the run needs
            if (run_temp_mask and rec.get("mask") is None) or (do_gradcam and rec.get("cam") is None):
                continue
            if run_temp_mask:
                time_mask_results.append(rec["mask"])
            if do_gradcam:
                grad_cam_results.append(rec["cam"])
            done_ids.add(vid)
            resumed_clips += 1
        if resumed_clips or resumed_skipped:
            print(
                f"[find-masks] resume: {resumed_clips} clips restored from "
                f"the emission journal ({resumed_skipped} journaled "
                f"min_score skips) — re-running the rest",
                flush=True,
            )
    journal = _EmissionJournal(journal_path, fresh=not resume)
    writer = _AsyncWriter(enabled=mk.async_viz)

    run_stats = {
        "score_launches": 0,
        "search_launches": 0,
        "searched_rows": 0,
        "padded_rows": 0,
        "n_steps_run": [],
        "segments_launched": 0,
        "segment_seconds": [],
        "refill_flushes": 0,
        "refill_requeued_rows": 0,
        "resumed_clips": resumed_clips,
        "resumed_skipped": resumed_skipped,
        "init_seconds": 0.0,
        "search_seconds": 0.0,
    }

    def upload(clips_u8: list) -> torch.Tensor:
        # uint8 crosses to the device (4x fewer bytes), one cast there; no
        # normalization, as in ivf_tpu's find_masks
        host = torch.from_numpy(np.ascontiguousarray(np.stack(_pad_rows(clips_u8, bsz))))
        return host.to(dev).float()

    def stage(take: list):
        """A fresh flush (rows ``(clip, label, id, probe scores or None)``):
        clips on the device, class scores (the probe's where it ran, else a
        forward), targets, and the mask init's carry when the search runs."""
        clips = upload([r[0] for r in take])
        if take[0][3] is not None:
            outputs = torch.from_numpy(np.stack(_pad_rows([r[3] for r in take], bsz))).to(dev)
        else:
            with torch.no_grad():
                outputs = score_fn(clips)
            run_stats["score_launches"] += 1
        if mk.grad_cam_type == "guessed":
            targets = outputs.argmax(dim=-1)
        else:
            targets = torch.as_tensor(_pad_rows([r[1] for r in take], bsz), device=dev)
        outputs_np = outputs[: len(take)].cpu().numpy()
        carry = None
        if run_temp_mask:
            _sync(dev)
            t0 = time.perf_counter()
            if mk.mask_init_type == "central":
                inits = init_mask_central(score_fn, clips, targets, mask_type=mk.mask_perturb_type)
            else:
                # per clip id, not per flush position: a clip's init does not
                # depend on which clips share its flush
                draws = [draw_mask_random(cfg.seed, r[2], clips.shape[1]) for r in take]
                inits = torch.stack(_pad_rows(draws, bsz)).to(dev)
            _sync(dev)
            run_stats["init_seconds"] += time.perf_counter() - t0
            carry = make_search_carry(inits)
        return clips, targets, outputs_np, carry

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(dev)
        seconds = time.perf_counter() - t0
        run_stats["search_seconds"] += seconds
        return out, seconds

    def segment(clips, targets, carry, n_steps: int) -> SearchCarry:
        carry, seconds = timed(
            search_segment, score_fn, clips, targets, carry, n_steps=n_steps, **search_kwargs
        )
        run_stats["segment_seconds"].append(seconds)
        run_stats["segments_launched"] += 1
        return carry

    def emit(sel: list, take: list, outputs_np, clips, targets, res) -> None:
        """Records for rows ``sel`` of the flush ``take`` (``res`` None when
        no search ran); their CAMs come from the whole (padded) batch and
        are gathered on the device. The flush's journal records go to the
        writer thread."""
        rows = torch.as_tensor(sel, device=dev)
        jrecs = {j: {"video_id": str(take[j][2]), "mask": None, "cam": None} for j in sel}
        heads = {
            j: {"true_class": int(take[j][1]), "pred_class": int(outputs_np[j].argmax()),
                "video_id": str(take[j][2])}
            for j in sel
        }
        masks = freeze = reverse = cams = None
        if res is not None:
            masks = res.mask[rows].cpu().numpy()
            freeze = res.freeze_score[rows].cpu().numpy()
            reverse = res.reverse_score[rows].cpu().numpy()
            run_stats["n_steps_run"].extend(res.n_steps_run[rows].cpu().tolist())
            for k, j in enumerate(sel):
                label, scores = int(take[j][1]), outputs_np[j]
                rec = {
                    **heads[j],
                    "time_mask": masks[k],
                    "original_score_guess": float(scores.max()),
                    "original_score_true": float(scores[label]),
                    "freeze_score": float(freeze[k]),
                    "reverse_score": float(reverse[k]),
                }
                time_mask_results.append(rec)
                jrecs[j]["mask"] = rec
        if do_gradcam:
            cams = cam_fn(clips, targets)[0][rows].float().cpu().numpy()
            for k, j in enumerate(sel):
                rec = {**heads[j], "GCHeatMap": cams[k]}
                grad_cam_results.append(rec)
                jrecs[j]["cam"] = rec
        recs = list(jrecs.values())
        if not (save_viz and res is not None):
            writer.submit(lambda: journal.append_many(recs))
            return
        # the viz perturbations of the selected rows, batched on the device;
        # the clip pixels only where an image needs them
        sel_clips, sel_masks = clips[rows], res.mask[rows]
        perts = None
        if do_gradcam:
            perts = {
                p: perturb_sequence(sel_clips, sel_masks, p, snap_values=True).cpu().numpy()
                for p in ("freeze", "reverse")
            }
        kth_pert = (
            perturb_sequence(sel_clips, sel_masks, mk.mask_perturb_type).cpu().numpy() if is_kth else None
        )
        clips_np = sel_clips.cpu().numpy() if (do_gradcam or is_kth) else None

        def viz_job() -> None:
            for k, j in enumerate(sel):
                tag, label, scores = heads[j]["video_id"], int(take[j][1]), outputs_np[j]
                gs, cs = float(scores.max()), float(scores[label])
                out_folder = os.path.join(
                    save_dir, "cam_saved_images", str(label),
                    f"{tag}g_{heads[j]['pred_class']}_gs{gs:5.4f}_cs{cs:5.4f}", "combined",
                )
                os.makedirs(out_folder, exist_ok=True)
                for name, val in (("Freeze", freeze[k]), ("Reverse", reverse[k])):
                    with open(os.path.join(out_folder, f"ClassScore{name}case{tag}.txt"), "w") as f:
                        f.write(str(float(val)))
                if perts is not None:
                    # the reverse pass overwrites the freeze pass's img*.jpg and
                    # mygif.gif (one folder, as in the JAX package), so the
                    # freeze pass writes only its strips: the same files, one
                    # GIF's palette quantization (most of the render) fewer
                    frozen = image_panels(clips_np[k], cams[k], perts["freeze"][k])
                    visualize_results_on_gradcam(
                        frozen, masks[k], out_folder, case="freeze" + tag,
                        image_width=frozen.shape[2] // 3, image_height=frozen.shape[1],
                    )
                    create_image_arrays(
                        clips_np[k], cams[k], masks[k], perts["reverse"][k], out_folder, case_tag="reverse" + tag
                    )
                if is_kth:
                    visualize_results(clips_np[k], kth_pert[k], masks[k], root_dir=out_folder, case=tag)
            # journaled last: a journaled clip has its artifacts on disk, so
            # resume never skips a half-written clip
            journal.append_many(recs)

        writer.submit(viz_job)

    def run_batch(take: list) -> None:
        n = len(take)
        clips, targets, outputs_np, carry = stage(take)
        res = None
        if run_temp_mask:
            if not chunked:
                res, _ = timed(
                    find_mask_from_carry, score_fn, clips, targets, carry,
                    n_steps=mk.opt_iter, **search_kwargs,
                )
            else:
                for _ in range(n_full):
                    carry = segment(clips, targets, carry, chunk)
                    # once every row froze, further segments change nothing
                    if mk.early_stop and not bool(carry.active.any()):
                        break
                else:
                    if rem:
                        carry = segment(clips, targets, carry, rem)
                res, _ = timed(finalize_search, score_fn, clips, targets, carry)
            run_stats["search_launches"] += 1
            run_stats["searched_rows"] += n
            run_stats["padded_rows"] += bsz - n
        if run_temp_mask or do_gradcam:
            emit(list(range(n)), take, outputs_np, clips, targets, res)

    requeues: dict = {}  # segments done -> survivor rows awaiting a flush

    def run_refill_flush(take: list, segs_done: int) -> None:
        """One flush of the refill path (``ivf_tpu/api.py:1323``): fresh
        rows (``segs_done`` 0) or re-staged survivors, each carrying its
        clip, label, id, class scores, target and exact carry row."""
        n = len(take)
        if segs_done == 0:
            clips, targets, outputs_np, carry = stage(take)
            run_stats["search_launches"] += 1
            run_stats["searched_rows"] += n
        else:
            clips = upload([r[0] for r in take])
            outputs_np = np.stack([r[3] for r in take])
            targets = torch.as_tensor(_pad_rows([r[4] for r in take], bsz), device=dev)
            carry = _carry_map(lambda *rows: torch.cat(rows), *_pad_rows([r[5] for r in take], bsz))
            run_stats["refill_flushes"] += 1
        run_stats["padded_rows"] += bsz - n
        targets_np = targets.cpu().numpy()
        rem_done = rem == 0
        harvested = np.zeros(n, bool)
        while True:
            sched_done = segs_done >= n_full and rem_done
            active = carry.active[:n].cpu().numpy()  # one read per boundary
            if sched_done:
                active[:] = False
            retiring = [j for j in range(n) if not (active[j] or harvested[j])]
            if retiring:
                res, _ = timed(finalize_search, score_fn, clips, targets, carry)
                emit(retiring, take, outputs_np, clips, targets, res)
                harvested[retiring] = True
            if sched_done or not active.any():
                return
            if retiring:
                # a mixed boundary: the survivors re-stage to run in full batches
                survivors = np.nonzero(active)[0]
                queue = requeues.setdefault(segs_done, [])
                for j in survivors:
                    row = _carry_map(lambda a: a[j : j + 1], carry)
                    queue.append((*take[j][:3], outputs_np[j], int(targets_np[j]), row))
                run_stats["refill_requeued_rows"] += len(survivors)
                return
            if segs_done < n_full:
                carry = segment(clips, targets, carry, chunk)
                segs_done += 1
            else:
                carry = segment(clips, targets, carry, rem)
                rem_done = True

    def pump_requeues(final: bool) -> None:
        # ascending rounds, again while flushes cascade survivors into later
        # rounds; rounds are bounded by the segment schedule
        progressed = True
        while progressed:
            progressed = False
            for r in sorted(requeues):
                queue = requeues[r]
                while len(queue) >= bsz or (final and queue):
                    take = queue[:bsz]
                    del queue[:bsz]
                    run_refill_flush(take, r)
                    progressed = True

    pending: list = []  # rows awaiting the min_score probe: (clip, label, id)
    ready: list = []  # rows ready to stage: (clip, label, id, probe scores or None)

    def flush_ready(final: bool = False) -> None:
        while len(ready) >= bsz or (final and ready):
            take = ready[:bsz]
            del ready[:bsz]
            if refill_on:
                run_refill_flush(take, 0)
            else:
                run_batch(take)
        if refill_on:
            pump_requeues(final)

    def flush_pending(final: bool = False) -> None:
        # the TF drivers skip clips whose true-class probability is below
        # the threshold (find_mask_smth.py:364-366); the probe runs on full
        # batches too, at the staging batch shape, so its scores have the
        # bits of the staging forward
        while len(pending) >= bsz or (final and pending):
            take = pending[:bsz]
            del pending[:bsz]
            with torch.no_grad():
                outs = score_fn(upload([r[0] for r in take]))[: len(take)].cpu().numpy()
            run_stats["score_launches"] += 1
            skips = []
            for j, (clip, label, cid) in enumerate(take):
                if outs[j][label] >= mk.min_score:
                    ready.append((clip, label, cid, outs[j]))
                else:
                    skips.append({"video_id": cid, "skip": True})
            if skips:
                journal.append_many(skips)
            flush_ready()

    def kept(cid: str, label: int) -> bool:
        return (
            (mk.class_oi is None or label == mk.class_oi)
            and (subset_ids is None or cid in subset_ids)
            and (not mk.kth_clips_filter or tag_matches(cid, cfg.split_type))
            and cid not in done_ids
        )

    probe = mk.min_score > 0.0
    body_ok = False
    try:
        for bidx, batch in enumerate(loader):
            if max_batches is not None and bidx >= max_batches:
                break
            clips_np, labels_np = batch[0], batch[1]
            ids = batch[2] if len(batch) == 3 else [None] * len(labels_np)
            for i in range(len(labels_np)):
                label = int(labels_np[i])
                cid = str(ids[i]) if ids[i] is not None else f"b{bidx}_{i}"
                if kept(cid, label):
                    # a copy: a view would pin the whole loader batch behind it
                    row = (clips_np[i].copy(), label, cid)
                    if probe:
                        pending.append(row)
                    else:
                        ready.append((*row, None))
            if probe:
                flush_pending()
            else:
                flush_ready()
        # the final flushes, the only padded launches of the staging path
        if probe:
            flush_pending(final=True)
        flush_ready(final=True)
        body_ok = True
    finally:
        # on the error path wait too, but let the body's error stand
        writer.close(raise_errors=body_ok)

    if run_temp_mask and mk.early_stop and run_stats["n_steps_run"]:
        sr = np.asarray(run_stats["n_steps_run"])
        summary = {
            "clips": int(sr.size),
            "step_budget": int(mk.opt_iter),
            "steps_run_p50": int(np.percentile(sr, 50)),
            "steps_run_p90": int(np.percentile(sr, 90)),
            "steps_run_max": int(sr.max()),
            "steps_run_mean": round(float(sr.mean()), 1),
            "frozen_frac": round(float((sr < mk.opt_iter).mean()), 4),
        }
        seg_note = ""
        if chunked:
            fixed_segments = run_stats["search_launches"] * -(-mk.opt_iter // chunk)
            summary.update(
                segments_launched=run_stats["segments_launched"],
                segments_fixed_schedule=fixed_segments,
                refill_flushes=run_stats["refill_flushes"],
                refill_requeued_rows=run_stats["refill_requeued_rows"],
            )
            seg_note = (
                f"; segments {run_stats['segments_launched']}/{fixed_segments} fixed-schedule"
                f" (refill: {run_stats['refill_flushes']} flushes,"
                f" {run_stats['refill_requeued_rows']} re-staged rows)"
            )
        run_stats["early_stop_summary"] = summary
        print(
            f"[find-masks] early-stop over {summary['clips']} clips: "
            f"steps/clip p50 {summary['steps_run_p50']} "
            f"p90 {summary['steps_run_p90']} max {summary['steps_run_max']} "
            f"(budget {mk.opt_iter}, frozen {summary['frozen_frac']:.0%}){seg_note}",
            flush=True,
        )
    if run_temp_mask or do_gradcam:
        with open(os.path.join(results_path, "search_stats.json"), "w") as f:
            json.dump({k: v for k, v in run_stats.items() if k != "n_steps_run"}, f, indent=1)
    if stats is not None:
        stats.update(run_stats)
    for kind, results in (("TimeMask", time_mask_results), ("GradCam", grad_cam_results)):
        path = os.path.join(results_path, f"all{kind}Results_{cfg.model_name}_{mk.class_oi}_.p")
        with open(path, "wb") as f:
            pickle.dump(results, f)
    return time_mask_results, grad_cam_results


@reference_numerics_fn
def grad_cam_run(cfg: Config, weights: Optional[Mapping[str, torch.Tensor]], clips, targets=None, device=None):
    """Standalone Grad-CAM over an array of clips (``ivf_tpu/api.py::
    grad_cam_run``, the reference's ``grad_cam_videos.py``), one clip at a
    time on ``device``: ``clips`` (N, T, H, W, 3), uint8 (cast to float32)
    or float; ``targets`` a class per clip, None (or None entries) for the
    predicted class. I3D explains ``cfg.mask.top_layer``, the ConvLSTM the
    last layer's hidden sequence (channel weights per frame for the TF
    family, over the clip for the torch one). Returns the CAMs (N, T, H,
    W) in [0, 1] as a float32 numpy array."""
    dev = resolve_device(device)
    model = build_model(cfg, softmax_override=True, device=dev)
    if weights is not None:
        model.load_state_dict(weights)
    model.requires_grad_(False)
    clips = torch.as_tensor(np.asarray(clips)).to(dev)
    if clips.dtype == torch.uint8:
        clips = clips.float()
    n = clips.shape[0]
    targets = [None] * n if targets is None else targets
    norm_frame = cfg.mask.normalization_mode == "frame"
    cams = []
    if isinstance(model, I3D):
        ffn, hfn = i3d_grad_cam_fns(model, cfg.mask.top_layer)
        for j in range(n):
            cam, _ = grad_cam(ffn, hfn, clips[j], targets[j], normalize_per_frame=norm_frame)
            cams.append(cam)
    else:
        wmode = "per_frame" if cfg.model.block_order == "tf" else "global"
        for j in range(n):
            target = None if targets[j] is None else torch.as_tensor([int(targets[j])], device=dev)
            cam, _ = convlstm_grad_cam(
                model, clips[j : j + 1], target, normalize_per_frame=norm_frame, weight_mode=wmode
            )
            cams.append(cam[0])
    return torch.stack(cams).float().cpu().numpy()


def _save_dir(cfg: Config) -> str:
    path = os.path.join(cfg.output_dir, cfg.model_name)
    os.makedirs(path, exist_ok=True)
    return path


def _loss_type(cfg: Config) -> str:
    return "nll_on_probs" if cfg.model.soft_max else "cross_entropy"


def _check_no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("mesh: data-parallel placement is not ported yet (ROADMAP.md, Queue 1 item 13)")


def _check_no_pretrained(cfg: Config) -> None:
    if cfg.model.pretrained_model_path not in ("", "no_ckpt", None):
        raise NotImplementedError(
            "pretrained_model_path: loading reference .pth.tar, TF bundles and orbax "
            "directories is not ported yet (ROADMAP.md, Queue 1 item 11)"
        )


def _train_state(cfg: Config, device, tx=None):
    """The float32 master model (seeded init) on ``device`` and its train
    state, with ``tx`` or the config's optimizer; dropout draws from
    ``cfg.seed + 1``, the seed of the JAX package's ``rng``."""
    from ivf_tpu_torch.train import build_optimizer, create_train_state

    _model_dtype(cfg)  # validates compute_dtype and pool_impl
    model = _construct_model(cfg, cfg.model.soft_max).to(resolve_device(device))
    if tx is None:
        o = cfg.optim
        tx = build_optimizer(o.optimizer.lower(), o.lr, momentum=o.momentum, weight_decay=o.weight_decay)
    return create_train_state(model, tx, seed=cfg.seed + 1)


@reference_numerics_fn
def train(
    cfg: Config,
    eval_only: bool = False,
    resume: bool = False,
    mesh=None,
    train_dataset=None,
    val_dataset=None,
    device=None,
):
    """The training driver (``ivf_tpu/api.py:321-444``, the reference's
    ``train_i3d_smth.main``) on ``device`` (``cuda`` unless given): the
    configured model with float32 master weights from ``cfg.seed``, the
    ``cfg.optim`` optimizer, ``fit`` over ``cfg.optim.num_epochs`` epochs
    of ``build_loader`` batches (train shuffled by (seed, epoch), both
    dropping the last partial batch) with the plateau or patience-halving
    scheduler, checkpoints under ``<output_dir>/<model_name>`` (best on
    val loss, every ``checkpoint_steps`` batches too, written on a thread
    under ``async_checkpoint``), learning curves in ``plots/`` and
    ``history.json``. ``compute_dtype='bfloat16'`` trains in mixed
    precision with the argmax pool (``_bf16_argmax_upgrade``, as the JAX
    package does). ``resume`` continues from the checkpoint, mid-epoch
    included, with its learning rate and best loss; ``test_run`` cuts each
    epoch to 5 batches. ``eval_only`` runs one validation pass with
    predictions instead (float32, as in the JAX package). Returns (state,
    history), or (state, evaluate's dict) for ``eval_only``. ``mesh`` and a
    ``pretrained_model_path`` raise ``NotImplementedError``."""
    from ivf_tpu_torch.train import PatienceHalving, ReduceLROnPlateau, evaluate, fit, make_eval_step
    from ivf_tpu_torch.train.optim import get_learning_rate
    from ivf_tpu_torch.utils.checkpoint import Checkpointer

    _check_no_mesh(mesh)
    dev = resolve_device(device)
    save_dir = _save_dir(cfg)
    cfg = _bf16_argmax_upgrade(cfg)
    loss_type = _loss_type(cfg)
    train_dataset = train_dataset or build_dataset(cfg, "train")
    val_dataset = val_dataset or build_dataset(cfg, "validation")
    state = _train_state(cfg, dev)

    ckpt = Checkpointer(save_dir, async_save=cfg.async_checkpoint)
    start_epoch, best_loss, batch_offset = 0, float("inf"), 0
    if resume and ckpt.exists():
        state, start_epoch, best_loss, batch_offset = ckpt.restore(state)
        at = f" batch {batch_offset}" if batch_offset else ""
        print(f" > resumed from epoch {start_epoch}{at} (best loss {best_loss:.4f})")
    else:
        _check_no_pretrained(cfg)

    if eval_only:
        res = evaluate(
            state, build_loader(cfg, val_dataset, False, device=dev), make_eval_step(loss_type),
            collect_predictions=True,
        )
        return state, res

    o = cfg.optim
    if o.lr_schedule == "patience_halving":
        scheduler = PatienceHalving(o.lr, patience=o.lr_patience, lr_end=o.last_lr)
    else:
        scheduler = ReduceLROnPlateau(o.lr, factor=o.lr_factor, patience=o.lr_patience)
    if start_epoch > 0:
        # a resume continues from the restored (maybe decayed) lr and best
        # loss, where the reference rebuilt a fresh scheduler
        scheduler.lr = get_learning_rate(state.opt_state)
        if o.lr_schedule != "patience_halving":
            scheduler.best = best_loss
    plotter = PlotLearning(os.path.join(save_dir, "plots"), cfg.model.num_classes)
    # one loader each, reused across epochs: fit pins each epoch's order
    train_loader = build_loader(cfg, train_dataset, cfg.data.shuffle, device=dev)
    val_loader = build_loader(cfg, val_dataset, False, device=dev)
    state, history = fit(
        state,
        lambda: train_loader,
        lambda: val_loader,
        num_epochs=o.num_epochs,
        loss_type=loss_type,
        scheduler=scheduler,
        checkpointer=ckpt,
        print_freq=o.print_freq,
        last_lr=o.last_lr,
        max_steps_per_epoch=5 if cfg.test_run else None,
        plotter=plotter,
        kernel_l2=cfg.model.kernel_l2,
        start_epoch=start_epoch,
        best_loss=best_loss,
        checkpoint_every_steps=o.checkpoint_steps,
        start_batch_offset=batch_offset,
        compute_dtype=cfg.model.compute_dtype,
    )
    if history:
        with open(os.path.join(save_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=1, default=float)
    return state, history


def init_eval_state(cfg: Config, softmax_override: Optional[bool] = None, device=None):
    """(model, state) for inference consumers (``ivf_tpu/api.py:538``): the
    configured model (float32, seeded) with an Adam(1e-3) state on
    ``device``. A ``pretrained_model_path`` raises (Queue 1 item 11)."""
    from ivf_tpu_torch.train import build_optimizer

    _check_no_pretrained(cfg)
    if softmax_override is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, soft_max=softmax_override))
    state = _train_state(cfg, device, tx=build_optimizer("adam", 1e-3))
    return state.model.eval(), state


def infer(cfg: Config, state=None, mesh=None, dataset=None, save_npy: bool = True, device=None):
    """Validation inference with prediction dumps (``ivf_tpu/api.py:556-608``,
    the reference's ``inference_kth.py``) on the state's device (or
    ``device`` for a fresh ``init_eval_state``): ``evaluate`` over
    ``dataset`` (the config's validation split by default) in the config's
    ``compute_dtype``, 5 batches under ``test_run``. The top-k width is
    ``cfg.model.top_k``, else 3 for a KTH-family run and 5 otherwise
    (``inference_kth.py:10``); the collected matrix is at least 5 wide.
    Writes ``y_true.npy``, ``y_hat.npy`` and ``y_hat_top5.npy`` (k columns,
    the reference's file name whatever k) to ``<output_dir>/<model_name>``.
    ``mesh`` raises (Queue 1 item 13)."""
    from ivf_tpu_torch.train import evaluate, make_eval_step

    _check_no_mesh(mesh)
    if state is None:
        _, state = init_eval_state(cfg, device=device)
    dev = next(state.model.parameters()).device
    dataset = dataset or build_dataset(cfg, "validation")
    k = cfg.model.top_k if cfg.model.top_k else (3 if _is_kth_run(cfg) else 5)
    res = evaluate(
        state,
        build_loader(cfg, dataset, False, device=dev),
        make_eval_step(_loss_type(cfg), compute_dtype=cfg.model.compute_dtype),
        max_steps=5 if cfg.test_run else None,
        collect_predictions=True,
        top_k=max(5, k),
    )
    if save_npy:
        save_dir = _save_dir(cfg)
        np.save(os.path.join(save_dir, "y_true.npy"), res["y_true"])
        np.save(os.path.join(save_dir, "y_hat.npy"), res["y_hat"])
        np.save(os.path.join(save_dir, "y_hat_top5.npy"), res["y_hat_top5"][:, :k])
    return res
