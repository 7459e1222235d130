"""Public entry points of the port (port of ``ivf_tpu/api.py``):
``build_model`` (I3D and the ConvLSTM family) and ``find_masks`` (the
search in one loop or in segments, with the early-stop segment skip and
convergence refill). ``build_model`` passes the I3D kernel routes on from
the config: ``use_pallas``, ``pallas_pool`` and ``fuse_pool_conv`` (True
or ``'tblock'``), each running hand-written CUDA kernels on the card.

Both run on ``cuda`` unless the caller passes ``device="cpu"`` (as the
tests do); with no GPU and no explicit device they raise rather than run
on the CPU. Float32 runs are exact float32 whatever the caller's TF32
flags (``precision.reference_numerics``). ``compute_dtype="bfloat16"`` runs
I3D (every kernel route, the fused branch 3 included) and the ConvLSTM
family in bfloat16 as the JAX package does: I3D with the argmax-index
pool on the branch-3 pools unless ``pool_impl`` was set or the branch is
fused (``_bf16_argmax_upgrade``); the ConvLSTM with bfloat16 weights and
gates and a float32 state and head.

Not ported yet (ROADMAP.md): ``cnn_3d``, the emission journal and resume,
class-of-interest / subset / min_score filtering and its compaction,
random mask init, viz artifacts and the async writer,
``search_stats.json``, ``grad_cam_run``, the pool impls ``shift``,
``eqbwd``, ``argmax_full`` and ``argmax_shift``, dataset loading from the
config, and the ``do_gradcam`` / ``run_temp_mask`` / ``max_batches``
switches of ``ivf_tpu``'s ``find_masks`` (every batch runs the search and
Grad-CAM).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Mapping, Optional, Union

import numpy as np
import torch

from ivf_tpu_torch.config import COMPUTE_DTYPES, POOL_IMPLS, Config
from ivf_tpu_torch.interpret.gradcam import (
    convlstm_grad_cam,
    grad_cam_batched,
    i3d_grad_cam_fns,
)
from ivf_tpu_torch.interpret.mask_opt import (
    SearchCarry,
    finalize_search,
    find_mask_from_carry,
    init_mask_central,
    make_search_carry,
    search_segment,
)
from ivf_tpu_torch.models.convlstm import ConvLSTMClassifier
from ivf_tpu_torch.models.i3d import I3D
from ivf_tpu_torch.models.registry import get_model
from ivf_tpu_torch.precision import reference_numerics_fn


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``; raises when CUDA is absent and no
    device was asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ivf_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


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
        raise NotImplementedError(
            f"pool_impl={m.pool_impl!r}: the port has {POOL_IMPLS} (ROADMAP.md, Queue 1)"
        )
    return torch.float32 if m.compute_dtype == "float32" else torch.bfloat16


def build_model(
    cfg: Config, softmax_override: Optional[bool] = None, device=None
) -> Union[I3D, ConvLSTMClassifier]:
    """The configured model in eval mode on ``device``, its weights drawn
    from ``cfg.seed``. Routed by substring of ``conv_model`` as in the JAX
    package: 'i3d' builds an I3D, 'clstm' or 'convlstm' (e.g. the
    ``clstm_kth`` preset, which is no registry key) a ConvLSTMClassifier.
    With ``compute_dtype='bfloat16'`` the float32 init is cast to
    bfloat16, every parameter and buffer, BN statistics included; the
    I3D takes ``pool_impl`` as given (``find_masks`` upgrades it first)."""
    m = cfg.model
    dtype = _model_dtype(cfg)
    softmax = m.soft_max if softmax_override is None else softmax_override
    name = m.conv_model.lower()
    if "i3d" in name:
        kwargs = dict(
            num_classes=m.num_classes,
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
        model = get_model(m.conv_model, num_classes=m.num_classes)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    return model.to(resolve_device(device), dtype).eval()


def _check_supported(cfg: Config) -> None:
    mk = cfg.mask
    if mk.mask_init_type != "central":
        raise NotImplementedError("only central mask init is ported")
    if mk.class_oi is not None:
        raise NotImplementedError("class-of-interest filtering is not ported")
    if mk.chunk_steps is not None and mk.chunk_steps < 1:
        raise ValueError(f"chunk_steps={mk.chunk_steps}: a positive step count, or None")


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
    dataset,
    stats: Optional[dict] = None,
    device=None,
):
    """Temporal-mask search + Grad-CAM over ``dataset`` (items
    ``(clip_uint8 (T, H, W, 3), label, clip_id)``), in batches of
    ``cfg.data.batch_size``; a short last batch is padded to the batch size
    by repeating its first row, and the padded rows are dropped before
    emission, so every launch has one batch shape.

    Per batch: the class-score forward, targets (argmax for 'guessed',
    labels for 'true'), central mask init, the ``opt_iter``-step search
    (with ``early_stop``/``eta_patience``), finalize, Grad-CAM (I3D: at
    ``cfg.mask.top_layer``; ConvLSTM: on the last layer's hidden sequence).
    The search runs as one loop, or with ``mask.chunk_steps`` as segments
    (``interpret/mask_opt.py::search_segment``) that stop launching once
    every row froze; with ``mask.refill`` (on by default when chunked under
    ``early_stop``) frozen rows retire at each segment boundary and the
    survivors re-stage, with their exact carry rows, into queues that flush
    again as full batches (``ivf_tpu/api.py:1323-1445``). Results keep the
    staging order, or the retirement order under refill; per clip, the
    bits are the same either way. ``weights`` is a state dict for the model
    (e.g. from ``utils.convert``); None keeps the seeded init. With
    ``compute_dtype='bfloat16'`` the weights are rounded to bfloat16 as they
    load, the clips stay float32 up to the first conv, the class scores are
    upcast to float32, and the mask logits and Adam state are float32, as
    in the JAX package; I3D's CAMs are bfloat16 values returned as float32,
    the ConvLSTM's are float32 (its state and features are).

    Returns (time_mask_results, grad_cam_results), lists of per-clip dicts
    with the reference's key names, also pickled to
    ``<output_dir>/<model_name>/results/all{TimeMask,GradCam}Results_
    <model_name>_<class_oi>_.p``. ``stats`` (a dict) receives the
    reference's counters (``search_launches``, ``searched_rows``,
    ``padded_rows``, ``n_steps_run`` per clip, ``segments_launched``,
    ``segment_seconds``, ``refill_flushes``, ``refill_requeued_rows``) and
    the host seconds of the mask init and of the search, finalize included
    (``init_seconds``, ``search_seconds``; device-synchronized).
    """
    _check_supported(cfg)
    cfg = _bf16_argmax_upgrade(cfg)
    mk = cfg.mask
    dev = resolve_device(device)
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
    refill_on = chunked and mk.early_stop and (mk.refill if mk.refill is not None else True)
    results_path = os.path.join(cfg.output_dir, cfg.model_name, "results")
    os.makedirs(results_path, exist_ok=True)
    run_stats = {
        "search_launches": 0,
        "searched_rows": 0,
        "padded_rows": 0,
        "n_steps_run": [],
        "segments_launched": 0,
        "segment_seconds": [],
        "refill_flushes": 0,
        "refill_requeued_rows": 0,
        "init_seconds": 0.0,
        "search_seconds": 0.0,
    }
    time_mask_results, grad_cam_results = [], []

    def upload(clips_u8: list) -> torch.Tensor:
        # uint8 crosses to the device (4x fewer bytes), one cast there; no
        # normalization, as in ivf_tpu's find_masks
        host = torch.from_numpy(np.ascontiguousarray(np.stack(_pad_rows(clips_u8, bsz))))
        return host.to(dev).float()

    def stage(take: list):
        """A fresh batch: clips on the device, class scores, targets and
        the central init's carry."""
        clips = upload([r[0] for r in take])
        with torch.no_grad():
            outputs = score_fn(clips)
        if mk.grad_cam_type == "guessed":
            targets = outputs.argmax(dim=-1)
        else:
            targets = torch.as_tensor(_pad_rows([r[1] for r in take], bsz), device=dev)
        outputs_np = outputs[: len(take)].cpu().numpy()
        _sync(dev)
        t0 = time.perf_counter()
        inits = init_mask_central(score_fn, clips, targets, mask_type=mk.mask_perturb_type)
        _sync(dev)
        run_stats["init_seconds"] += time.perf_counter() - t0
        run_stats["search_launches"] += 1
        run_stats["searched_rows"] += len(take)
        return clips, targets, outputs_np, make_search_carry(inits)

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
        """Records for rows ``sel`` of the flush ``take``; their CAMs come
        from the whole (padded) batch and are gathered on the device."""
        rows = torch.as_tensor(sel, device=dev)
        masks = res.mask[rows].cpu().numpy()
        freeze = res.freeze_score[rows].cpu().numpy()
        reverse = res.reverse_score[rows].cpu().numpy()
        run_stats["n_steps_run"].extend(res.n_steps_run[rows].cpu().tolist())
        cams = cam_fn(clips, targets)[0][rows].float().cpu().numpy()
        for k, j in enumerate(sel):
            label, scores = int(take[j][1]), outputs_np[j]
            head = {"true_class": label, "pred_class": int(scores.argmax()), "video_id": str(take[j][2])}
            time_mask_results.append(
                {
                    **head,
                    "time_mask": masks[k],
                    "original_score_guess": float(scores.max()),
                    "original_score_true": float(scores[label]),
                    "freeze_score": float(freeze[k]),
                    "reverse_score": float(reverse[k]),
                }
            )
            grad_cam_results.append({**head, "GCHeatMap": cams[k]})

    def run_batch(take: list) -> None:
        clips, targets, outputs_np, carry = stage(take)
        run_stats["padded_rows"] += bsz - len(take)
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
        emit(list(range(len(take))), take, outputs_np, clips, targets, res)

    requeues: dict = {}  # segments done -> survivor rows awaiting a flush

    def run_refill_flush(take: list, segs_done: int) -> None:
        """One flush of the refill path (``ivf_tpu/api.py:1323``): fresh
        rows (``segs_done`` 0) or re-staged survivors, each carrying its
        clip, label, id, class scores, target and exact carry row."""
        n = len(take)
        if segs_done == 0:
            clips, targets, outputs_np, carry = stage(take)
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

    ready: list = []

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

    for start in range(0, len(dataset), bsz):
        for i in range(start, min(start + bsz, len(dataset))):
            clip, label, clip_id = dataset[i]
            ready.append((clip, int(label), str(clip_id)))
        flush_ready()
    flush_ready(final=True)

    if stats is not None:
        stats.update(run_stats)
    for kind, results in (("TimeMask", time_mask_results), ("GradCam", grad_cam_results)):
        path = os.path.join(results_path, f"all{kind}Results_{cfg.model_name}_{mk.class_oi}_.p")
        with open(path, "wb") as f:
            pickle.dump(results, f)
    return time_mask_results, grad_cam_results
