#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ivf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase"``); any failure exits
non-zero without the final line:

1. build: compile the CUDA kernels from ``ivf_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and report the compiler's register/spill
   summary and the card's ``nvidia-smi`` name and power limit.
2. kernel_check: each CUDA kernel against its plain PyTorch version on
   the card, at the main paths' shapes and ragged ones, TF32 off; with
   the kernel's time, the plain version's, one PyTorch library call's
   (a yardstick only) and the card's lower bound for the same work. The
   float32 pointwise GEMM at every 1x1x1 conv of the I3D search step,
   forward and dx, W in both layouts, with its plan and the sum over a
   step's 40 launches (and the fused routes' 22). The gate pair in
   float32 and all in bf16 (the bf16 train step's) at both clstm_kth
   layers, beside ``_thnn_fused_lstm_cell``. The
   four fused branch-3 kernels at all nine branch-3 sites, per-frame
   against whole-sample too, timed beside the unfused kernel pair, whose
   bits the float32 entries must give; a summary row per entry sums the
   nine sites. The pool pair (``pool_rows``) at all nine sites (batch 4)
   and at Mixed_3b and Mixed_3c at 128 clips, cold: equal bits, nine-site
   sums.
3. small_reference: I3D at (1, 8, 32, 32, 3) on the card vs the same
   model on the CPU (plain versions), for the pool-kernel route and both
   fused routes: logits and input gradient.
4. main_path: ``find_masks`` on i3d_smth at full width (174 classes,
   16x224x224 clips, float32, seeded weights) over 4 clips, 10 search
   steps, Grad-CAM on -- without kernels, with the pool kernels
   (``use_pallas`` and ``pallas_pool``), without again, then with the
   fused branch 3 (``use_pallas`` and ``fuse_pool_conv`` True, then
   ``'tblock'``); every launch counter reset just before each run and read
   just after; outputs checked and compared.
5. step_timing: steady wall time of one search step on each of the four
   routes, and on the pool-kernel route with the plain stem (the 7x7x7
   stride-2 conv in place of the default space-to-depth one), in turns,
   and a profiled step of each (device time by kernel group, top
   kernels).
6. clstm_small_reference: the ConvLSTM (torch family with the gate
   kernel; TF family with hard-sigmoid gates, 'valid' padding, per-layer
   BN) on the card vs the same model on the CPU: logits, input gradient.
7. clstm_main_path: ``find_masks`` on the clstm_kth preset at full width
   (6 classes, 32x120x160 clips, 2 layers x 4 hidden, stride 2) over 16
   clips, 10 search steps, Grad-CAM on -- a warm-up run, then one with the
   gate kernel (counters reset just before, read just after) and one
   without; outputs checked and compared.
8. clstm_bf16_main_path: the same in bfloat16 (bf16 weights and gates,
   float32 state), with the gate kernel's bf16 entries and without, each
   twice: launches, equal bits run to run, against each other and against
   the float32 kernel run, and the search from one carry.
9. clstm_step_timing: as step_timing, for the ConvLSTM search step in
   float32 and bfloat16, kernel on and off, plus 12 pairs of float32
   single steps (on and off back to back) and the host's launch rate
   before and after them.
10. determinism: in a child process with ``CUBLAS_WORKSPACE_CONFIG`` set
   before CUDA starts, the float32 pool-kernel route under
   ``torch.use_deterministic_algorithms``: the ops PyTorch flags with the
   port's repairs switched off and on (warn mode), then two runs with the
   repairs in raise mode, and the bfloat16 default route twice; equal bits
   required, and one train step of each I3D route of train_i3d (the op
   that raises, if one does). In this process: each repair switched off
   in turn, two runs each (do they still give equal bits?) and its cost
   per search step.
11. bf16_kernel_check: the bfloat16 kernels (pointwise GEMM at every
   1x1x1 conv of the I3D main path, forward and dx, with the sum over a
   search step's 40 launches and the host time per call; the bf16 pool
   pair and the argmax pair at all nine branch-3 sites and at Mixed_3b
   and Mixed_3c at 128 clips, inputs cold, with their nine-site sums; the
   four bf16 fused branch-3 entries at all nine sites, beside the bf16
   unfused pair; the bf16 gate entries
   at both ConvLSTM layers, beside the float32 gate kernel) against their
   plain versions, timed beside ``torch.matmul`` / ``F.max_pool3d`` in
   bfloat16.
12. bf16_main_path: ``find_masks`` at full width in bfloat16 on the default
   route (argmax pool), the kernel route (``use_pallas`` +
   ``pallas_pool``) and both fused routes (``use_pallas`` +
   ``fuse_pool_conv`` True / ``'tblock'``), each twice; launches, peak
   memory, equal bits run to run, each route against the float32
   pool-kernel route and the others against the kernel route.
13. bf16_step_timing: device time by group per step on the four bf16
   routes beside the float32 ones at batch 4, then the bf16 default route
   at batch 32, and at 128 the default and kernel routes in turns; each
   with its peak memory; at 4 and 128 also the default route with the
   plain stem (7x7x7 stride 2, polyphase input gradient) beside the
   default space-to-depth stem, as step_timing does for the float32
   kernel route.
14. stem_s2d_check (after the kernel checks): the space-to-depth stem
   against the plain stem at the stem's full shape (16x224x224x3 -> 64),
   float32 and bfloat16, forward and input gradient within the CPU
   tests' tolerances, two runs with equal bits, device ms of each form
   at batch 4 (both dtypes) and 128 (bfloat16), peak memory, the kernels
   the profiler names; a third form takes the s2d conv's input gradient
   from cuDNN's backward-data conv.
15. refill: ``find_masks`` at full width on the bfloat16 kernel route, 8
   clips in batches of 4, 10 steps, ``early_stop`` at an eta chosen from
   this run's own loss trajectories (``refill_eta``) so that stop steps
   differ within each batch: monolithic, in segments of 2 without refill
   and with it. Equal bits per clip across the three, refill re-staged
   rows, no more segments with refill, the same stop steps.
16. driver: the long-run driver of ``find_masks`` at full width on the
   bfloat16 kernel route, 12 clips with ids in loader batches of 4, 10
   steps, a subset file keeping 9 and a ``min_score`` from this run's own
   probe scores that skips 2-3 of them: the reference run (compaction
   across loader batches, only the final flush padded, the probe's scores
   kept), a run interrupted after one loader batch and resumed, a resume
   from a torn journal, random init uninterrupted and resumed, and the
   ``run_temp_mask`` / ``do_gradcam`` switches; equal bits per clip where
   the runs must agree, and the launch counters.
17. data_path: ``find_masks`` from the presets in ``configs/`` over data
   on disk, through ``build_dataset`` and the ``ClipLoader``: a smth frame
   tree of 16 clips of 16x224x224 (the preset's batch) on the preset as
   loaded (float32), the bf16 kernel route and the bf16 default route, and
   a KTH tree of 16 clips of 32x120x160 on the ConvLSTM preset with the
   gate kernel and the whitelist filter; each run against the same decoded
   clips handed over in memory (equal bits per clip), launches, the kept
   ids, the decoder used, its decode rate in clips/s, mask-steps/s and the
   device busy share.
18. artifacts: ``find_masks(..., save_viz=True)`` at full width on the
   bfloat16 kernel route, 4 clips in loader batches of 2 (the first
   flush's rendering overlaps the second's search), 10 steps, Grad-CAM
   on, then the clstm_kth ConvLSTM with the gate kernel on 2 clips (a KTH
   run: the PerturbImgs too); each beside the same run without viz:
   equal bits, every clip's folder, ClassScore files equal to its scores,
   images, GIF and mask files, every journaled id's folder, the files'
   count and bytes, wall time and the writer's wait with and without viz.
19. pool_impls: every ``pool_impl`` of the JAX package at full width (4
   clips, 10 steps, ``use_pallas`` on, ``pallas_pool`` off), in float32
   and bfloat16, each twice: equal bits run to run, masks within the
   tie-rule tolerance of ``reduce_window``'s, float32 ``argmax_full`` /
   ``argmax_shift`` bit-equal to ``reduce_window`` / ``shift``, launches;
   device ms per search step of each bf16 impl at batch 4 with peak
   memory.
20. train_kernel_check, then train_i3d. The first holds the training
   path's kernel calls against their plain versions at its shapes, f32
   and bf16: the pointwise conv as ``Unit3D`` calls it in training (y,
   dx, dW, db) and the gate VJP at both clstm_kth layers (float32, bf16
   gates with a float32 state, all bf16). train_i3d:
   training of i3d_smth from ``configs/config_i3d_smth.py``
   as loaded (batch 16, Adam, dropout 0.5) on four routes (f32 plain, f32
   kernels, bf16 default, bf16 kernels): one step of each kernel route
   against the plain route with the same tie rule (loss, every gradient,
   BN statistics; a control with one block's cotangent 10% off must
   exceed the gradient limit), the bf16 default route against the argmax
   pair's plain versions (equal bits), each bf16 route on float32 and on
   bf16 clips (equal bits), two runs with equal bits, the loss falling over 20
   steps on one batch, float32 masters in bf16, launches per step, steady
   clips/s and device ms per step by kernel group, peak memory, busy
   share; ``api.train`` over a generated JPEG tree uninterrupted and cut
   mid-epoch then resumed (equal bits), ``infer``'s files and the plain
   route's ``y_hat`` on the same weights.
21. train_clstm: the same for the clstm_kth ConvLSTM (16 clips of
   32x120x160, ``kernel_l2``) with the gate kernel and without, f32 and
   bf16, the resume through ``fit`` and its checkpoints.
22. cnn_3d: a train step and an eval of ``cnn_3d`` at 32x120x160, batch
   16, f32 and bf16, each twice: equal bits.
23. records_search: ``find_masks`` from ``configs/config_clstm_kth_records.py``
   on generated per-subject record shards, 10 steps, twice: equal bits.
24. checkpoint_cli: checkpoint I/O and ``python -m ivf_tpu_torch.cli`` at
   full width, each run against the API with the weights in memory
   (equal bits): I3D ``find-masks`` from a reference ``.pth.tar`` written
   by the port's exporter (f32 with the pointwise kernel, bf16 default
   with the argmax pair; then one ``python -m`` process: the same
   pickles); a bf16 ConvLSTM ``train`` with the gate kernel (the
   all-bf16 entries launch), resumed (equal bits), exported and loaded
   back ``strict=True``; the TF family's ``find-masks`` from a TF bundle
   the port wrote.
25. serve, in a process of its own (``--serve-child``), as a server
   runs: ``ivf_tpu_torch/serve.py`` at full width, float32: i3d_smth
   on the kernel route (``use_pallas`` + ``pallas_pool``), the fused
   ``tblock`` route and the stock route, clstm_kth with the gate kernel and
   without; each model from ``init_eval_state`` with the main path's
   seeded weights, exported on the card, saved, loaded, and called at
   every bucket 1-128 against the live model (equal bits, else rtol 1e-6
   / atol 1e-7), the launch counters around each artifact call (the
   forward's kernels exactly, 0 on the stock routes), clips/s of the
   artifact and of the live model per bucket in ``SERVE_PAIRS``
   alternating pairs (medians, the pairs' median ratio), device ms by
   group at 128; then ``cli serve --artifact --smoke`` and a burst of 512
   requests through the batcher (occupancy, p50 / p95 latency) with
   ``/stats``.
26. parallel, in a process of its own (``--parallel-child``): a world of
   one rank over NCCL and its data mesh, i3d_smth at full width; train
   steps (f32 kernel route, bf16 default), ``find_masks`` and ``infer``
   with the mesh and without: equal bits, equal launches, device ms and
   the NCCL kernels' share (``parallel_child``).
27. whole_search: ``find_masks`` at bench.py's setting (128 clips,
   bf16, targets arange(128) % 174) at fewer steps than its 120
   (``WHOLE_ROUTE_STEPS``) on the default route (60), the kernel route
   (30) and the default route with the plain stem (30), each after a
   2-step warm-up: mask-steps/s, the device busy share of the run, peak
   memory, the emission journal's bytes and the wait for its writer.

Every line ``main`` prints carries ``t_s``, the seconds since it started.

The float32 phases set no global TF32 flag: the port's entry points pin
exact float32 themselves (``ivf_tpu_torch/precision.py``); direct autograd
through a model (``small_reference``) runs inside the same pin. Then the
``kernels`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --bf16-width-sweep

times the bf16 TMA GEMM at each column-tile width instead (see
``bf16_width_sweep``), and

    python3 chip_smoke.py --fused-sweep

the fused branch-3 kernels under every candidate plan (``fused_sweep``),
and

    python3 chip_smoke.py --f32-tile-sweep

the float32 GEMM under every tile instance (``f32_tile_sweep``), and

    python3 chip_smoke.py --f32-compare DIR

the float32 GEMM of the checkout in DIR against this one's, in turns
(``f32_compare``), and

    python3 chip_smoke.py --argmax-compare DIR

the argmax pair's rows of ``bf16_kernel_check`` likewise
(``argmax_compare``), and

    python3 chip_smoke.py --pool-compare DIR

the ``maxpool3d_s1`` pair's rows of both kernel checks, in float32 and
bfloat16, likewise (``pool_compare``), and

    python3 chip_smoke.py --pool-sweep

the ``maxpool3d_s1`` pair under every candidate tile and register cap
(``pool_sweep``), and

    python3 chip_smoke.py --whole-compare DIR

the whole search on the bf16 default route with the port of the checkout
in DIR and with this one, in turns (``whole_compare``).
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from contextlib import contextmanager
from pathlib import Path

import torch

# H100 SXM published peaks (float32 on the CUDA cores, dense bf16 on the
# tensor cores, HBM3)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

BATCH, CLIP_T, CLIP_HW, CLASSES, STEPS = 4, 16, 224, 174, 10
# flags-on vs flags-off masks after STEPS steps: the pool kernel's every-tie
# backward gives another mask gradient (see MASK_TOL_REASON)
MASK_TOL = 0.05
MASK_TOL_REASON = (
    "the branch-3 pool kernel credits every tied maximum; the window-3 "
    "stride-2 trunk pools duplicate maxima into neighbouring outputs, so "
    "the kernel path's mask gradient differs from F.max_pool3d's and the "
    "masks drift apart over the steps (0.031 after 8 steps at 8x32x32 on "
    "the CPU, tests/test_torch_api.py)"
)

# fused branch 3 vs the pool-kernel route, and per-frame vs whole-sample:
# the same tie rule, and the fused kernels give the unfused pair's bits
# (kernel_check, route_step_bits). Since the port repaired its run-to-run
# nondeterminism (the determinism phase), the same route run twice gives
# equal bits ("kernels_again" must equal "kernels"), so the fused routes
# are held to the bound registered for them before that noise was found
FUSED_MASK_TOL = 1e-4
FUSED_MASK_TOL_REASON = (
    "the fused kernels keep the pool kernel's every-tie rule and give the "
    "unfused kernel pair's bits, and two runs of one route give equal bits "
    "(kernels_again vs kernels): exactly 0 expected; equal bits on the CPU "
    "(tests/test_torch_api.py)"
)
# bfloat16 against the float32 pool-kernel route. The central init picks
# the first candidate whose score-drop ratio is below 0.9; on these seeded
# clips the unperturbed and the frozen class scores are close, so rounding
# moves ratios across the threshold (1 to 3 of the 4 clips picked another
# candidate in bfloat16 in five runs on an H100), and another init moves
# the mask by ~1. So find_masks's masks are held on the clips whose init
# (read back from find_masks, _find_masks_run) chose the same candidate,
# at least one, and the search itself is held from one central carry for
# every clip (bf16_search_from_carry). Measured on an NVIDIA H100 80GB
# HBM3 at 700 W: masks <= 0.044, scores <= 0.0050, CAMs <= 0.040
BF16_MASK_TOL, BF16_SCORE_TOL, BF16_CAM_TOL = 0.1, 0.01, 0.06
BF16_TOL_REASON = (
    "bfloat16 activations and gradients: the search follows another "
    "gradient (input gradients 25% apart in L2 at 8x32x32 against JAX at "
    "bfloat16, whose own bfloat16 gradient is 34-38% from its float32 "
    "one, tests/test_torch_bf16.py); scores are bfloat16 probabilities "
    "(ulp 2**-9 to 2**-8 near 0.5); CAMs are normalized bfloat16 maps; "
    "each limit about twice the largest reading on the card"
)
# the two bfloat16 routes against each other: their forwards differ only in
# the summation order of the branch-3 1x1x1 convs (cuDNN or the bf16 GEMM),
# so scores and CAMs may differ by one bfloat16 rounding (both came out
# equal in five runs); the masks by the backward's tie rule, as BF16_MASK_TOL
BF16_ROUTES_TOL = 2.0**-8
# the fused bf16 routes against the bf16 kernel route: b3b's 1x1x1 conv
# sums on the tensor cores on both routes, but in another order (the fused
# kernel's mma.sync k16 steps against the TMA GEMM's wgmma), so a branch-3
# output may round to the neighbouring bf16 value, which the later blocks
# carry to Mixed_5c. On an H100 at 700 W the CAMs moved by 0.027 while the
# fused kernels summed on the CUDA cores, and by 0 since they use tensor
# cores; the CAMs stay held at BF16_CAM_TOL
BF16_FUSED_CAM_REASON = (
    "b3b's conv sums in another order (the fused kernel's mma.sync against "
    "the TMA GEMM's wgmma), so a branch-3 output may round to the "
    "neighbouring bf16 value and the later blocks carry that to Mixed_5c; "
    "measured 0.027 with CUDA-core sums, 0 with tensor-core sums, on an H100"
)
# the nine branch-3 sites of i3d_smth at 16x224x224: (T, H, W, Cin), Cout
FUSED_SITES = (
    ("Mixed_3b", (8, 28, 28, 192), 32), ("Mixed_3c", (8, 28, 28, 256), 64),
    ("Mixed_4b", (4, 14, 14, 480), 64), ("Mixed_4c", (4, 14, 14, 512), 64),
    ("Mixed_4d", (4, 14, 14, 512), 64), ("Mixed_4e", (4, 14, 14, 512), 64),
    ("Mixed_4f", (4, 14, 14, 528), 128), ("Mixed_5b", (2, 7, 7, 832), 128),
    ("Mixed_5c", (2, 7, 7, 832), 128),
)
FUSED_ROUTES = {  # the four find_masks routes of the I3D main path
    "plain": {},
    "kernels": dict(use_pallas=True, pallas_pool=True),
    "fused": dict(use_pallas=True, fuse_pool_conv=True),
    "fused_tblock": dict(use_pallas=True, fuse_pool_conv="tblock"),
}

# the ConvLSTM main path: the clstm_kth preset (configs/config_clstm_kth.py)
CLSTM_BATCH, CLSTM_T, CLSTM_HW, CLSTM_CLASSES = 16, 32, (120, 160), 6
# kernels on vs off: the gate kernel and the plain block differ by float32
# rounding only (~1e-7 relative), so the scores agree to rounding; Adam
# divides each mask gradient by its running RMS, which can turn a
# rounding-level change of a near-zero component into a visible step
CLSTM_MASK_TOL = 1e-3
CLSTM_MASK_TOL_REASON = (
    "gate kernel vs plain gate block differ by float32 rounding; Adam's "
    "update is scale-free, so a near-zero mask-gradient component can move "
    "by a rounding-level change; 8 steps on the CPU agree to 1e-4 with JAX "
    "on both routes (tests/test_torch_convlstm.py)"
)
# bfloat16 ConvLSTM against float32, and with the gate kernel against
# without: the limits of the I3D bfloat16 comparisons (BF16_*), registered
# before the first run on the card
CLSTM_BF16_TOL_REASON = (
    "bf16 weights and gates with a float32 state: gate pre-activations "
    "rounded to bf16 (logits 2.3e-3 and input gradients 0.8% from JAX's "
    "bf16 model at 8x32x48, JAX's own bf16 vs float32 logits 5.5e-3, "
    "tests/test_torch_convlstm.py); kernel vs plain: the same forward "
    "roundings, another backward (per-op bf16 rounding against autograd "
    "through the plain version's casts)"
)
# operations counted per (row, channel) of the gate block: the gate sums,
# three sigmoids, two tanh and the state update (forward); the recompute
# plus the five gradient formulas (backward)
GATE_OPS_FWD, GATE_OPS_BWD = 20, 40
# operations per bf16 input of the all-bf16 pair's table build: exp, add,
# divide, subtract and multiply of the sigmoid and its factor, and tanh
GATE_TABLE_OPS = 6


_T0 = None  # main()'s start: its lines carry the seconds since then


def emit(obj: dict) -> None:
    if _T0 is not None:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 20, warmup: int = 3, cold: bool = False) -> float:
    """Device time of ``fn`` per call: the kernels' own durations from
    ``torch.profiler`` (CUPTI), summed over ``reps`` calls. Unlike
    ``cuda_ms`` it leaves out the host's dispatch gaps between launches,
    which bound back-to-back calls of a kernel of a few microseconds.
    ``cold``: overwrite a 256 MB buffer before each call so the inputs come
    from device memory, not the 50 MB L2; the overwrite's own kernels are
    left out of the sum by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def kernel_us(prof, skip=frozenset()):
        return {
            ev.key: getattr(ev, "self_device_time_total", 0) or 0
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA and ev.key not in skip
        }

    flush, skip = (lambda: None), frozenset()
    if cold:
        buf = torch.empty(64 * 2**20, device="cuda")
        flush = buf.zero_
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            flush()
            torch.cuda.synchronize()
        skip = frozenset(kernel_us(prof))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(3):  # the profiler now and then drops every event of a window: measure again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        total = sum(kernel_us(prof, skip).values())
        if total > 0:
            break
    return total / reps / 1e3


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32_FLOPS):
    """Least time (ms) the card could take: bytes over HBM bandwidth vs
    operations over the peak for their type (float32 on the CUDA cores by
    default), the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    reports = build.build(["pointwise_conv", "maxpool3d", "fused_gates", "fused_branch3", "argmax_pool"])
    seconds = time.perf_counter() - t0
    ptxas = {
        name: [ln.strip() for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
        for name, rep in reports.items()
    }
    smi = nvidia_smi()
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return {"smi": smi}


def _ties(shape, gen, dev):
    """Post-ReLU values rounded to halves: exact zeros and tied maxima."""
    x = torch.round(torch.randn(shape, generator=gen) * 2) / 2
    return torch.relu(x).to(dev)


def _f32_pw_case(pw, x, w, b, relu):
    """One float32 pointwise case on the card: the kernel's output, the
    plain version's, and the error of the kernel with W in the other
    layout (the same values made contiguous along the other dimension)."""
    w_other = w.t().contiguous().t() if w.stride(1) == 1 else w.contiguous()
    y = pw.pointwise_conv_cuda(x, w, b, relu)
    y_other = pw.pointwise_conv_cuda(x, w_other, b, relu)
    ref = pw.pointwise_conv_plain(x, w, b, relu)
    torch.cuda.synchronize()
    err = max((y - ref).abs().max().item(), (y_other - ref).abs().max().item())
    return err, 1e-5 * ref.abs().max().item(), w_other


def phase_kernel_check(pw, pool, failures) -> dict:
    """The float32 kernels against their plain versions. The pointwise GEMM
    at every 1x1x1 conv of the I3D main path (batch 4), forward (W the
    layers' column-major view of the (Cout, Cin) weight, bias, ReLU but at
    the logits) and dx (W^T, row-major), each also with W in the other
    layout, within 1e-5 of the largest output; device time per launch (W
    as the main path passes it; inputs warm in L2), the other layout's,
    the plain version's, ``torch.matmul``'s with TF32 off, the bound
    (operations at 67 TFLOP/s against bytes at 3.35 TB/s), the launches
    per search step and the plan; then the sum over a step's 40 launches
    and over the 22 that the fused routes still make (no b3b). Then one
    clip's batch and ragged shapes, with and without bias and ReLU. The
    pool pair as ``pool_rows`` gives it, with its nine-site sums."""
    from ivf_tpu_torch.precision import reference_numerics

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {"pointwise_conv": []}
    b = BATCH
    keys = ("ms", "library_ms", "plain_ms", "bound_ms")
    step = {k: 0.0 for k in keys} | {"launches": 0}
    fused_step = {k: 0.0 for k in keys} | {"launches": 0}
    for site, n, cin, cout, per_step in pw_main_path():
        wk = (torch.randn(cout, cin, generator=gen) / cin**0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        relu = site != "logits"
        for direction in ("fwd", "dx"):
            if direction == "fwd":
                x, w, bb, act, k, c = _ties((n, cin), gen, dev), wk.t(), bias, relu, cin, cout
            else:  # m @ W^T: the forward's column-major view transposed is row-major
                x, w, bb, act, k, c = torch.randn(n, cout, generator=gen).to(dev), wk, None, False, cout, cin
            err, tol, w_other = _f32_pw_case(pw, x, w, bb, act)
            bms, by = bound(4 * (n * k + k * c + (c if bb is not None else 0) + n * c), 2 * n * k * c)
            with reference_numerics():
                lib = device_ms(lambda: torch.matmul(x, w))
            row = {
                "site": site, "direction": direction, "shape": [n, k, c], "relu": act, "bias": bb is not None,
                "max_abs_err": err, "tol": tol,
                "ms": device_ms(lambda: pw.pointwise_conv_cuda(x, w, bb, act)),
                "other_layout_ms": device_ms(lambda: pw.pointwise_conv_cuda(x, w_other, bb, act)),
                "plain_ms": device_ms(lambda: pw.pointwise_conv_plain(x, w, bb, act), reps=3),
                "library_ms": lib, "bound_ms": bms, "bound_by": by, "launches_per_step": per_step,
                "plan": pw.f32_plan(n, k, c, x.stride(), x.data_ptr(), w.stride(), w.data_ptr()),
            }
            cases["pointwise_conv"].append(row)
            sums = (step, fused_step) if "b3b" not in site else (step,)
            for s in sums:
                for key in keys:
                    s[key] += per_step * row[key]
                s["launches"] += per_step
            if not err <= tol:
                failures.append(f"pointwise_conv {site} {direction}: err {err} > {tol}")
    emit({"phase": "kernel_check", "kernel": "pointwise_conv", "summary": "per search step", "batch": b,
          **step, "fused_routes": fused_step})
    extra = [  # one clip's batch, then ragged: n below every tile, Cin and Cout not multiples of 4
        ("Conv3d_2b/clip", 8 * 56 * 56, 64, 64),
        ("Mixed_3b_trio/clip", 8 * 28 * 28, 192, 176),
        ("logits/clip", 1, 1024, 174),
        ("ragged", 150, 112, 48),
        ("ragged_odd", 1001, 174, 61),
    ]
    for site, n, cin, cout in extra:
        x = _ties((n, cin), gen, dev)
        wk = (torch.randn(cout, cin, generator=gen) / cin**0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        for relu, use_bias in ((True, True), (False, False)):
            bb = bias if use_bias else None
            err, tol, _ = _f32_pw_case(pw, x, wk.t(), bb, relu)
            cases["pointwise_conv"].append({
                "site": site, "direction": "fwd", "shape": [n, cin, cout], "relu": relu, "bias": use_bias,
                "max_abs_err": err, "tol": tol,
                "plan": pw.f32_plan(n, cin, cout, x.stride(), x.data_ptr(), wk.t().stride(), wk.data_ptr()),
            })
            if not err <= tol:
                failures.append(f"pointwise_conv {site} relu={relu} bias={use_bias}: err {err} > {tol}")

    cases.update(pool_rows(pool, failures, torch.float32))
    for name, rows in cases.items():
        for row in rows:
            emit({"phase": "kernel_check", "kernel": name, **row})
    _nine_site_sums("kernel_check", cases, ("maxpool3d_s1_fwd", "maxpool3d_s1_bwd"))
    return cases


def phase_gate_check(gates, failures) -> dict:
    """The fused-gates kernels against their plain versions at both
    layers of the clstm_kth main path (batch 16), the merged-conv route
    (no ``gates_h``) and a ragged size; ``_thnn_fused_lstm_cell`` (and its
    backward) on the same inputs as the yardstick, checked to agree.
    Tolerances: ``_f32_gate_errs``."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    cases = {"lstm_gates_fwd": [], "lstm_gates_bwd": []}
    for site, lead, ch, with_gh in F32_GATE_SITES:
        gx, gh, c, dh, dc_out = _f32_gate_operands(gen, lead, ch, with_gh, dev)
        h_new, c_new = gates.lstm_gates_fwd_cuda(gx, gh, c)
        dz, dc = gates.lstm_gates_bwd_cuda(gx, gh, c, dh, dc_out)
        h_ref, c_ref = gates.gate_math_plain(gx, gh, c)
        dz_ref, dc_ref = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
        lib_fwd, lib_bwd, lib_out = _gate_library((gx, gh, c, dh, dc_out))
        torch.cuda.synchronize()
        refs = (h_ref, c_ref, dz_ref, dc_ref)
        errs = _f32_gate_errs((h_new, c_new, dz, dc), refs)
        fwd_errs, bwd_errs = {k: errs[k] for k in ("h", "c")}, {k: errs[k] for k in ("dz", "dc")}
        lib_errs = _f32_gate_errs(lib_out, (h_new, c_new, dz, dc), limits_of=refs)
        numel, znumel = c.numel(), gx.numel()
        z_in = znumel * (2 if with_gh else 1)
        for name, errs, fn, plain, lib, nbytes, ops, lib_keys in (
            ("lstm_gates_fwd", fwd_errs,
             lambda: gates.lstm_gates_fwd_cuda(gx, gh, c), lambda: gates.gate_math_plain(gx, gh, c),
             lib_fwd, 4 * (z_in + 3 * numel), GATE_OPS_FWD * numel, ("h", "c")),
            ("lstm_gates_bwd", bwd_errs,
             lambda: gates.lstm_gates_bwd_cuda(gx, gh, c, dh, dc_out),
             lambda: gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out),
             lib_bwd, 4 * (z_in + znumel + 4 * numel), GATE_OPS_BWD * numel, ("dz", "dc")),
        ):
            bms, by = bound(nbytes, ops)
            lib_err = {k: lib_errs[k][0] for k in lib_keys}
            cases[name].append({
                "site": site, "shape": [*lead, 4 * ch], "gates_h": with_gh,
                "max_abs_err": max(e for e, _ in errs.values()),
                "errs": {k: {"err": e, "tol": t} for k, (e, t) in errs.items()},
                "library_errs": lib_err,
                # device time per call, inputs warm in L2 as the main path
                # leaves them (the conv has just written the gates); cold_ms:
                # from device memory; call_ms: back-to-back calls timed with
                # events, which the host's dispatch bounds at these sizes
                "ms": device_ms(fn), "plain_ms": device_ms(plain), "library_ms": device_ms(lib),
                "cold_ms": {"kernel": device_ms(fn, cold=True), "plain": device_ms(plain, cold=True),
                            "library": device_ms(lib, cold=True)},
                "call_ms": {"kernel": cuda_ms(fn, reps=50), "plain": cuda_ms(plain),
                            "library": cuda_ms(lib, reps=50)},
                "bound_ms": bms, "bound_by": by,
            })
            for k, (e, t) in errs.items():
                if not e <= t:
                    failures.append(f"{name} {site}: {k} err {e} > {t}")
            for k in lib_keys:
                if not lib_errs[k][0] <= lib_errs[k][1]:
                    failures.append(f"{name} {site}: _thnn_fused_lstm_cell disagrees on {k}: {lib_errs[k]}")
    cases.update(_all_bf16_gate_rows(gates, failures))
    for name, rows_ in cases.items():
        for row in rows_:
            emit({"phase": "kernel_check", "kernel": name, **row})
    return cases


ALL_BF16_GATE_TOL_REASON = (
    "h', c', dz, dc bit for bit (no unequal element of the int16 views): the kernel and the plain "
    "version round every op to bf16 at the same points (XLA's CPU rounding of the JAX package's "
    "all-bf16 gate block, which the plain version has bit for bit on the CPU) with float32 "
    "operations in the same order and the same CUDA expf / tanhf"
)


# the sites of the all-bf16 pair's rows: (site, leading shape, Ch, with
# gates_h); clstm_kth's layers at batch 16 as training calls them
ALL_BF16_GATE_SITES = (
    ("layer1", (CLSTM_BATCH, CLSTM_HW[0] // 2, CLSTM_HW[1] // 2), 4, True),
    ("layer2", (CLSTM_BATCH, CLSTM_HW[0] // 8, CLSTM_HW[1] // 8), 4, True),
    ("layer1_merged", (CLSTM_BATCH, CLSTM_HW[0] // 2, CLSTM_HW[1] // 2), 4, False),
    ("ragged", (3, 7, 9), 5, True),
)


# the sites of the float32 pair's rows: the all-bf16 pair's and a ragged
# size without gates_h
F32_GATE_SITES = ALL_BF16_GATE_SITES + (("ragged_merged", (3, 7, 9), 5, False),)


def _f32_gate_operands(gen, lead, ch, with_gh, dev, off: int = 0):
    """Seeded float32 gate operands: (gates_x, gates_h or None, c, dh,
    dc_out), each a view ``off`` elements into its storage."""

    def operand(width):
        n = torch.Size(lead).numel() * width
        return torch.randn(n + off, generator=gen).to(dev)[off:].view(*lead, width)

    gx = operand(4 * ch)
    gh = operand(4 * ch) if with_gh else None
    c, dh, dc_out = (operand(ch) for _ in range(3))
    return gx, gh, c, dh, dc_out


def _gate_library(ops):
    """``_thnn_fused_lstm_cell`` and its backward on one site's float32
    operands as (rows, 4 Ch) views (zeros for a null gates_h), the same
    function as the gate pair: (forward call, backward call, their outputs
    h', c', dz, dc shaped as the pair's)."""
    aten = torch.ops.aten
    gx, gh, c, dh, dc_out = ops
    ch = c.shape[-1]
    rows = c.numel() // ch
    lib_in = (gx.view(rows, 4 * ch), (gh if gh is not None else torch.zeros_like(gx)).view(rows, 4 * ch),
              c.view(rows, ch))
    hy, cy, ws = aten._thnn_fused_lstm_cell(*lib_in)

    def fwd():
        return aten._thnn_fused_lstm_cell(*lib_in)

    def bwd():
        return aten._thnn_fused_lstm_cell_backward_impl(dh.view(rows, ch), dc_out.view(rows, ch), lib_in[2], cy, ws,
                                                         False)

    dgates, dcx, _ = bwd()
    return fwd, bwd, (hy.view_as(c), cy.view_as(c), dgates.view_as(gx), dcx.view_as(c))


def _f32_gate_errs(got, want, limits_of=None) -> dict:
    """h', c', dz and dc against ``want``: {name: (largest error, limit)}.
    Limits (of ``limits_of``, else of ``want``): h' in (-1, 1) within 1e-6
    absolute; c', dz and dc within 1e-6 of max(1, their largest magnitude):
    accurate expf/tanhf in both, but the kernel contracts products into
    FMAs where PyTorch rounds each elementwise op, a few ulps apart."""
    out = {}
    for name, a, b, lim in zip(("h", "c", "dz", "dc"), got, want, limits_of or want):
        tol = 1e-6 if name == "h" else 1e-6 * max(1.0, lim.abs().max().item())
        out[name] = ((a - b).abs().max().item(), tol)
    return out


def _all_bf16_operands(gen, lead, ch, with_gh, dev):
    """Seeded all-bf16 gate operands: (gates_x, gates_h or None, c, dh,
    dc_out)."""
    gx = (torch.randn(*lead, 4 * ch, generator=gen) * 3).bfloat16().to(dev)
    gh = (torch.randn(*lead, 4 * ch, generator=gen) * 2).bfloat16().to(dev) if with_gh else None
    c = (torch.randn(*lead, ch, generator=gen) * 2).bfloat16().to(dev)
    dh, dc_out = (torch.randn(*lead, ch, generator=gen).bfloat16().to(dev) for _ in range(2))
    return gx, gh, c, dh, dc_out


def _all_bf16_gate_rows(gates, failures) -> dict:
    """The all-bfloat16 gate pair (``lstm_gates_{fwd,bwd}_bf16s``: the bf16
    train step's bf16 gates and bf16 state) against its plain version on
    the card at both clstm_kth layers as training calls them (16 clips,
    the x- and h-gates apart at stride 2), the merged route and a ragged
    size. Timed beside the plain version and the library's
    ``_thnn_fused_lstm_cell`` pair in bf16 on the same values (the
    yardstick; it takes bf16 gates and a bf16 state). Bounds: bytes at
    3.35 TB/s (22 B forward, 32 B backward per (row, channel) split)
    against float32 operations on the CUDA cores. Then the pair's tables
    (``_gate_table_row``) and every bf16 pattern in every operand slot
    (``_all_bf16_exhaustive``)."""
    aten = torch.ops.aten
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(17)
    cases = {n: [] for n in BF16S_GATE_COUNTERS}
    for site, lead, ch, with_gh in ALL_BF16_GATE_SITES:
        gx, gh, c, dh, dc_out = _all_bf16_operands(gen, lead, ch, with_gh, dev)
        h_new, c_new = gates.lstm_gates_fwd_bf16s_cuda(gx, gh, c)
        dz, dc = gates.lstm_gates_bwd_bf16s_cuda(gx, gh, c, dh, dc_out)
        h_ref, c_ref = gates.gate_math_plain(gx, gh, c)
        dz_ref, dc_ref = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
        rows = c.numel() // ch
        lib_in = (gx.view(rows, 4 * ch), (gh if with_gh else torch.zeros_like(gx)).view(rows, 4 * ch),
                  c.view(rows, ch))
        try:
            hy, cy, ws = aten._thnn_fused_lstm_cell(*lib_in)
            lib_fwd = lambda: aten._thnn_fused_lstm_cell(*lib_in)  # noqa: E731
            lib_bwd = lambda: aten._thnn_fused_lstm_cell_backward_impl(  # noqa: E731
                dh.view(rows, ch), dc_out.view(rows, ch), lib_in[2], cy, ws, False)
            lib_bwd()
        except RuntimeError as exc:
            lib_fwd = lib_bwd = None
            emit({"phase": "kernel_check", "note": f"_thnn_fused_lstm_cell in bf16: {exc}"})
        torch.cuda.synchronize()
        numel, znumel = c.numel(), gx.numel()
        z_in = znumel * (2 if with_gh else 1)
        for name, outs, fn, plain, lib, nbytes, ops in (
            ("lstm_gates_fwd_bf16s", {"h": (h_new, h_ref), "c": (c_new, c_ref)},
             lambda: gates.lstm_gates_fwd_bf16s_cuda(gx, gh, c), lambda: gates.gate_math_plain(gx, gh, c),
             lib_fwd, 2 * (z_in + 3 * numel), GATE_OPS_FWD * numel),
            ("lstm_gates_bwd_bf16s", {"dz": (dz, dz_ref), "dc": (dc, dc_ref)},
             lambda: gates.lstm_gates_bwd_bf16s_cuda(gx, gh, c, dh, dc_out),
             lambda: gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out),
             lib_bwd, 2 * (z_in + znumel + 4 * numel), GATE_OPS_BWD * numel),
        ):
            errs = {k: (a.float() - r.float()).abs().max().item() for k, (a, r) in outs.items()}
            unequal = {k: int((a.view(torch.int16) != r.view(torch.int16)).sum().item())
                       for k, (a, r) in outs.items()}
            bms, by = bound(nbytes, ops)
            cases[name].append({
                "site": site, "shape": [*lead, 4 * ch], "gates_h": with_gh,
                "max_abs_err": max(errs.values()),
                "errs": {k: {"err": e, "unequal": unequal[k]} for k, e in errs.items()},
                "tol_reason": ALL_BF16_GATE_TOL_REASON,
                "ms": device_ms(fn), "plain_ms": device_ms(plain),
                "library_ms": device_ms(lib) if lib is not None else None,
                "library_note": "aten._thnn_fused_lstm_cell (and its backward) in bf16 on the same values",
                "cold_ms": {"kernel": device_ms(fn, cold=True),
                            "library": device_ms(lib, cold=True) if lib is not None else None},
                "bound_ms": bms, "bound_by": by,
            })
            for k, n_bad in unequal.items():
                if n_bad:
                    failures.append(f"{name} {site}: {k} has {n_bad} elements unequal to the plain version's")
    cases["lstm_gate_tables"] = [_gate_table_row(gates, failures)]
    _all_bf16_exhaustive(gates, failures)
    return cases


def _gate_ptxas(report: str) -> dict:
    """The ptxas lines (registers, spills) of the float32 and all-bf16 gate
    kernels in an nvcc report, by kernel (its mangled name from
    ``lstm_gates_`` to its parameters)."""
    ptxas, kernel = {}, None
    for line in report.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(lstm_gates_(?:fwd|bwd)\w*?)(?=EvP|EP)", line)
            kernel = m[1] if m and "_bf16_kernel" not in m[1] else None
        elif kernel and ("registers" in line or "spill" in line):
            ptxas.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
    return ptxas


def _build_gate_lib(gates, src: Path):
    """``src`` (a checkout's ``csrc/fused_gates.cu``, its headers beside
    it) compiled into ``_build/fused_gates_other.so``: (bound library,
    its gate kernels' ptxas lines)."""
    import ctypes

    from ivf_tpu_torch.ops.kernels import build

    build.BUILD_DIR.mkdir(exist_ok=True)
    so = build.BUILD_DIR / "fused_gates_other.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(src.parent), "-o", str(so), str(src)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}")
    return gates.bind(ctypes.CDLL(str(so))), _gate_ptxas(proc.stdout)


@contextmanager
def _gate_lib(gates, lib):
    """The gate wrappers on another build of ``csrc/fused_gates.cu``: a
    build with activation tables gets its own at its first all-bf16 call
    (dropped on exit); a build without them ignores this build's, which
    stay registered."""
    saved_lib, saved_tables = gates._lib, dict(gates._tables)
    gates._lib = lambda: lib
    if hasattr(lib, "lstm_gate_tables_build"):
        gates._tables.clear()
    try:
        yield
    finally:
        torch.cuda.synchronize()
        gates._tables.clear()
        gates._tables.update(saved_tables)
        gates._lib = saved_lib


def _pair_site(fwd_fn, bwd_fn, ops, timed: bool = True) -> dict:
    """One gate pair's outputs (h', c', dz, dc) on one site's operands
    through its wrappers; ``timed``: with its device ms each way, warm and
    cold (inputs from device memory), each the larger of two readings."""
    gx, gh, c, dh, dc_out = ops

    def fwd():
        return fwd_fn(gx, gh, c)

    def bwd():
        return bwd_fn(gx, gh, c, dh, dc_out)

    row = {"outputs": (*fwd(), *bwd())}
    if timed:  # the larger of two readings: the profiler now and then drops a kernel's events
        for key, fn, cold in (("fwd_ms", fwd, False), ("bwd_ms", bwd, False), ("fwd_cold_ms", fwd, True),
                              ("bwd_cold_ms", bwd, True)):
            row[key] = max(device_ms(fn, cold=cold), device_ms(fn, cold=cold))
    return row


def _same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8)) for x, y in zip(a, b))


def _clstm_step(api, cfg, clips, labels):
    """One ConvLSTM train step (the preset's optimizer and dtype) from the
    seeded state after two warm steps: (profile of the step, as
    ``_train_profile``, its wall ms)."""
    from ivf_tpu_torch.train import make_train_step

    state = _train_state(api, cfg)
    step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype)
    for _ in range(2):
        state, _ = step(state, clips, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(state, clips, labels)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return _train_profile(lambda: step(state, clips, labels)), wall


TURNS = ("other", "this", "this", "other")
TURN_KEYS = ("fwd_ms", "bwd_ms", "fwd_cold_ms", "bwd_cold_ms")

# float32 sites for --gates-compare beside F32_GATE_SITES, one for each
# layout the kernels pick: (site, leading shape, Ch, with gates_h, offset of
# every operand in elements)
F32_LAYOUT_SITES = (
    ("ch6", (16, 15, 20), 6, True, 0),
    ("ch8", (3, 7, 9), 8, True, 0),
    ("odd_rows", (3, 7), 4, True, 0),
    ("misaligned", (4, 6, 8), 4, True, 1),
)


def _compare_f32_sites(gates, other_lib, dev) -> bool:
    """The float32 pair of both builds in turns at every site of
    ``F32_GATE_SITES`` (timed, ``_thnn_fused_lstm_cell`` timed beside) and
    ``F32_LAYOUT_SITES``; the bf16-gate / float32-state pair of both on the
    same values. True when every output has equal bits in both builds and
    the float32 pair is within ``_f32_gate_errs``'s limits of plain."""
    ok = True
    gen = torch.Generator().manual_seed(4)  # phase_gate_check's operands
    sites = [(*site, 0, True) for site in F32_GATE_SITES] + [(*site, False) for site in F32_LAYOUT_SITES]
    for site, lead, ch, with_gh, off, timed in sites:
        ops = _f32_gate_operands(gen, lead, ch, with_gh, dev, off)
        want = (*gates.gate_math_plain(*ops[:3]), *gates.gate_math_bwd_plain(*ops))
        bf16_ops = (ops[0].bfloat16(), None if ops[1] is None else ops[1].bfloat16(), *ops[2:])
        turns, bf16_out = {"other": [], "this": []}, {}
        for side in TURNS:
            with _gate_lib(gates, other_lib) if side == "other" else contextlib.nullcontext():
                turns[side].append(_pair_site(gates.lstm_gates_fwd_cuda, gates.lstm_gates_bwd_cuda, ops, timed))
                if side not in bf16_out:
                    bf16_out[side] = _pair_site(gates.lstm_gates_fwd_bf16_cuda, gates.lstm_gates_bwd_bf16_cuda,
                                                bf16_ops, timed=False)["outputs"]
        errs = {side: _f32_gate_errs(ts[0]["outputs"], want) for side, ts in turns.items()}
        row = {"phase": "gates_compare", "pair": "f32", "site": site, "shape": [*lead, 4 * ch], "gates_h": with_gh,
               "offset": off,
               "equal_bits_other_this": _same_bits(turns["other"][0]["outputs"], turns["this"][0]["outputs"]),
               "bf16_gates_equal_bits_other_this": _same_bits(bf16_out["other"], bf16_out["this"]),
               "within_plain_limits": all(e <= t for es in errs.values() for e, t in es.values()),
               "errs": {side: {k: {"err": e, "tol": t} for k, (e, t) in es.items()} for side, es in errs.items()}}
        if timed:
            row.update({f"{side}_{k}": [t[k] for t in ts] for side, ts in turns.items() for k in TURN_KEYS})
            lib_fwd, lib_bwd, _ = _gate_library(ops)
            row["library_ms"] = {key: max(device_ms(fn, cold=cold), device_ms(fn, cold=cold)) for key, fn, cold in (
                ("fwd_ms", lib_fwd, False), ("bwd_ms", lib_bwd, False), ("fwd_cold_ms", lib_fwd, True),
                ("bwd_cold_ms", lib_bwd, True))}
        emit(row)
        ok = (ok and row["equal_bits_other_this"] and row["bf16_gates_equal_bits_other_this"]
              and row["within_plain_limits"])
    return ok


def gates_compare(other: str) -> int:
    """``python3 chip_smoke.py --gates-compare DIR``: the gate pairs of the
    checkout in DIR (its ``csrc/fused_gates.cu`` built beside this one's;
    the C entries take the same arguments) against this one's in one
    process, in turns (other, this, this, other). The float32 pair
    (``_compare_f32_sites``): device ms forward and backward, warm and
    cold, beside ``_thnn_fused_lstm_cell``'s; equal bits, also of the
    bf16-gate / float32-state pair. The all-bf16 pair at every site of
    ``ALL_BF16_GATE_SITES``: device ms, equal bits between the two and to
    the plain version. Then one float32 and one bf16 ConvLSTM train step
    (``train_clstm``'s gate-kernel routes, SGD lr 1, one seeded batch)
    with each: equal loss, gradients and BN statistics; and the device ms
    of a step of the preset's optimizer with each, in turns (~2 min)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ivf_tpu_torch import api
    from ivf_tpu_torch.ops.kernels import build
    from ivf_tpu_torch.ops.kernels import fused_gates as gates

    src = Path(other).resolve() / "ivf_tpu_torch" / "csrc" / "fused_gates.cu"
    this_ptxas = _gate_ptxas(build.build(["fused_gates"])["fused_gates"])
    other_lib, ptxas = _build_gate_lib(gates, src)
    emit({"phase": "gates_compare", "other": str(src), "nvidia_smi": nvidia_smi(), "other_ptxas": ptxas,
          "this_ptxas": this_ptxas})
    dev = torch.device("cuda")
    ok = _compare_f32_sites(gates, other_lib, dev)
    gates._ensure_tables(dev)
    for site, lead, ch, with_gh in ALL_BF16_GATE_SITES:
        ops = _all_bf16_operands(torch.Generator().manual_seed(17), lead, ch, with_gh, dev)
        want = (*gates.gate_math_plain(*ops[:3]), *gates.gate_math_bwd_plain(*ops))
        turns = {"other": [], "this": []}
        for side in TURNS:
            with _gate_lib(gates, other_lib) if side == "other" else contextlib.nullcontext():
                turns[side].append(_pair_site(gates.lstm_gates_fwd_bf16s_cuda, gates.lstm_gates_bwd_bf16s_cuda, ops))
        same = _same_bits(turns["other"][0]["outputs"], turns["this"][0]["outputs"])
        plain = all(_same_bits(t["outputs"], want) for ts in turns.values() for t in ts)
        row = {f"{side}_{k}": [t[k] for t in ts] for side, ts in turns.items() for k in TURN_KEYS}
        emit({"phase": "gates_compare", "pair": "bf16s", "site": site, "shape": [*lead, 4 * ch],
              "gates_h": with_gh, "equal_bits_other_this": same, "equal_bits_plain": plain, **row})
        ok = ok and same and plain
    with tempfile.TemporaryDirectory() as tmp:
        (clips, labels), = _clstm_train_batches(1, 31)
        for route in ("f32_gate_kernel", "bf16_gate_kernel"):
            cfg = _train_preset(api, "config_clstm_kth.py", tmp, route, kernel_l2=CLSTM_KERNEL_L2,
                                **TRAIN_CLSTM_ROUTES[route])
            this = _sgd1_step(api, cfg, clips, labels)
            with _gate_lib(gates, other_lib):
                that = _sgd1_step(api, cfg, clips, labels)
            same = (this["loss"] == that["loss"] and _same_state(this["grads"], that["grads"])
                    and _same_state(this["stats"], that["stats"]))
            steps = {"other": [], "this": []}
            for side in TURNS:
                with _gate_lib(gates, other_lib) if side == "other" else contextlib.nullcontext():
                    prof, wall = _clstm_step(api, cfg, clips, labels)
                steps[side].append({"device_ms": prof["device_ms"], "wall_ms": wall,
                                    "gate_kernels_ms": prof["groups_ms"].get("fused_gates kernels")})
            emit({"phase": "gates_compare", "check": f"{route.split('_')[0]} ConvLSTM train step",
                  "equal_bits_other_this": same, "loss": this["loss"], "steps": steps})
            ok = ok and same
    return 0 if ok else 1


def _gate_table_row(gates, failures) -> dict:
    """The all-bf16 pair's activation tables (``lstm_gate_tables_build``:
    three kernels, once per device and process) against their plain twin
    on the card (``gate_table_twin``: the plain block's activations, with
    the same CUDA ``expf`` / ``tanhf``, and the same derivation): equal
    ranges and every packed entry bit for bit. Timed as a release and a
    rebuild (device time of its kernels and its two small copies) beside
    the twin on the card; the bound is the packed bytes written against
    ``GATE_TABLE_OPS`` float32 operations per input."""
    dev = torch.device("cuda")
    gates._ensure_tables(dev)
    info = gates.gate_tables_info(dev)
    twin = gates.gate_table_twin(dev)
    regions = gates.packed_gate_tables(dev)
    same_ranges = all(info[k] == twin[k] for k in ("slo", "sspan", "tlo", "tspan"))
    unequal = {k: int((v != twin[k]).sum()) if same_ranges else None for k, v in regions.items()}
    if not same_ranges or any(unequal.values()):
        failures.append(f"lstm_gate_tables: ranges {info} against the twin's, unequal entries {unequal}")

    def rebuild():
        gates.release_gate_tables()
        gates._ensure_tables(dev)

    bms, by = bound(twin["bytes"], GATE_TABLE_OPS * 65536)
    return {
        "site": "all_bf16", "shape": [65536], "ranges": info, "packed_bytes": twin["bytes"],
        "max_abs_err": 0.0 if same_ranges and not any(unequal.values()) else float("inf"),
        "unequal": unequal, "tol_reason": "every entry bit for bit: the same functions on the same inputs",
        "ms": device_ms(rebuild, reps=5, warmup=1), "plain_ms": device_ms(lambda: gates.gate_table_twin(dev), reps=5),
        "library_ms": None, "library_note": "none: no PyTorch call builds the tables",
        "bound_ms": bms, "bound_by": by,
    }


def _all_bf16_exhaustive(gates, failures) -> None:
    """The all-bf16 pair with every one of the 65,536 bf16 patterns in each
    operand slot in turn (the four gates, c, dh, dc'; ``exhaustive_operands``,
    7 x 65,536 elements of Ch 4, the others seeded), without and with
    ``gates_h``: h', c', dz and dc against the plain versions on the card,
    bit for bit, NaNs included; a failure names the first unequal input."""
    dev = torch.device("cuda")
    for with_gh in (False, True):
        t0 = time.perf_counter()
        gx, gh, c, dh, dc_out = gates.exhaustive_operands(with_gh, ch=4, seed=23, device=dev)
        h, cn = gates.lstm_gates_fwd_bf16s_cuda(gx, gh, c)
        dz, dc = gates.lstm_gates_bwd_bf16s_cuda(gx, gh, c, dh, dc_out)
        h_ref, c_ref = gates.gate_math_plain(gx, gh, c)
        dz_ref, dc_ref = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
        bad = gates.first_unequal({"h": h, "c": cn, "dz": dz, "dc": dc},
                                  {"h": h_ref, "c": c_ref, "dz": dz_ref, "dc": dc_ref}, 4)
        torch.cuda.synchronize()
        emit({"phase": "kernel_check", "check": "all_bf16_exhaustive", "gates_h": with_gh,
              "slots": list(gates.EXHAUSTIVE_SLOTS), "elements": c.numel(), "first_unequal": bad,
              "nan_outputs": int(torch.isnan(dz.float()).sum()), "seconds": time.perf_counter() - t0,
              "required": "first_unequal null"})
        if bad is not None:
            failures.append(f"all-bf16 gates, every bf16 pattern (gates_h={with_gh}): {bad}")


def phase_fused_check(fb, pool, pw, failures) -> dict:
    """The four fused branch-3 kernels against their plain versions at the
    nine branch-3 sites of the main path (batch 4): post-ReLU tie data
    with the ReLU, signed data without; per-frame against whole-sample.
    Forward within 1e-5 of the largest |y|, dx within 1e-5 of max(1,
    largest |dx|). With the ReLU (the main path's setting) also the device
    time of each kernel (inputs warm in L2, and flushed), of the plain
    version, of the unfused kernel pair (``maxpool3d_s1`` +
    ``pointwise_conv``, with the ReLU mask between them in the backward)
    and, for the forward, of ``F.max_pool3d`` + ``torch.matmul``: no one
    PyTorch call computes the fused function, so that pair is the
    library yardstick; the backward has none (the every-tie gather)."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(8)
    kernels = {
        "fused_pool_conv": (fb.fused_pool_conv_fwd_cuda, fb.fused_pool_conv_bwd_cuda),
        "fused_pool_conv_tblock": (fb.fused_pool_conv_tblock_fwd_cuda, fb.fused_pool_conv_tblock_bwd_cuda),
    }
    cases = {f"{k}_{d}": [] for k in kernels for d in ("fwd", "bwd")}

    def err(a, b_):
        return (a - b_).abs().max().item()

    for site, (t, h, w, cin), cout in FUSED_SITES:
        shape = (BATCH, t, h, w, cin)
        n, numel, ynumel = BATCH * t * h * w, BATCH * t * h * w * cin, BATCH * t * h * w * cout
        fwd_bound = bound(4 * (numel + cin * cout + cout + ynumel), 2 * n * cin * cout + 26 * numel + 2 * ynumel)
        bwd_bound = bound(4 * (2 * numel + 2 * ynumel + cin * cout), 2 * n * cout * cin + ynumel + 80 * numel)
        for relu in (True, False):
            x = _ties(shape, gen, dev) if relu else torch.randn(shape, generator=gen).to(dev)
            wt = (torch.randn(cin, cout, generator=gen) / cin**0.5).to(dev)
            b = (torch.randn(cout, generator=gen) * 0.1).to(dev)
            g = torch.randn(*shape[:-1], cout, generator=gen).to(dev)
            outs = {}
            for name, (fwd, bwd) in kernels.items():
                y = fwd(x, wt, b, relu)
                outs[name] = (y, bwd(x, y, g, wt, relu))
            y_ref = fb.fused_pool_conv_plain(x, wt, b, relu)
            torch.cuda.synchronize()
            y_tol = 1e-5 * y_ref.abs().max().item()
            (yf, dxf), (yt, dxt) = outs["fused_pool_conv"], outs["fused_pool_conv_tblock"]
            between = {"fwd_err": err(yf, yt), "bwd_err": err(dxf, dxt),
                       "bits_equal": bool(torch.equal(yf, yt) and torch.equal(dxf, dxt))}
            if relu:
                # the unfused kernel pair on the same inputs: the fused
                # kernels add in its order, so the bits should agree
                pooled = pool.maxpool3d_s1_fwd_cuda(x)
                wT = wt.t().contiguous()
                y_pair = pw.pointwise_conv_cuda(pooled.view(n, cin), wt, b, True).view(yf.shape)
                gc_pair = pw.pointwise_conv_cuda(torch.where(y_pair > 0, g, 0.0).view(n, cout), wT, None, False)
                dx_pair = pool.maxpool3d_s1_bwd_cuda(x, pooled, gc_pair.view(shape))
                xc = x.permute(0, 4, 1, 2, 3)

                def pair_fwd():
                    pw.pointwise_conv_cuda(pool.maxpool3d_s1_fwd_cuda(x).view(n, cin), wt, b, True)

                def pair_bwd():
                    m = torch.where(y_pair > 0, g, 0.0).view(n, cout)
                    gc = pw.pointwise_conv_cuda(m, wT, None, False)
                    pool.maxpool3d_s1_bwd_cuda(x, pooled, gc.view(shape))

                def lib_fwd():
                    torch.matmul(F.max_pool3d(xc, 3, 1, 1).permute(0, 2, 3, 4, 1).reshape(n, cin), wt)

                shared = {
                    "fwd": {"pair_ms": device_ms(pair_fwd), "library_ms": device_ms(lib_fwd),
                            "plain_ms": device_ms(lambda: fb.fused_pool_conv_plain(x, wt, b, True), reps=5)},
                    "bwd": {"pair_ms": device_ms(pair_bwd), "library_ms": None,
                            "plain_ms": device_ms(lambda: fb.fused_pool_conv_bwd_plain(x, yf, g, wt, True), reps=5)},
                }
            for name, (fwd, bwd) in kernels.items():
                y, dx = outs[name]
                dx_ref = fb.fused_pool_conv_bwd_plain(x, y, g, wt, relu)
                torch.cuda.synchronize()
                dx_tol = 1e-5 * max(1.0, dx_ref.abs().max().item())
                rows = {
                    "fwd": {"max_abs_err": err(y, y_ref), "tol": y_tol, "bound": fwd_bound},
                    "bwd": {"max_abs_err": err(dx, dx_ref), "tol": dx_tol, "bound": bwd_bound},
                }
                if relu:
                    rows["fwd"]["pair_bits_equal"] = bool(torch.equal(y, y_pair))
                    rows["bwd"]["pair_bits_equal"] = bool(torch.equal(dx, dx_pair))
                    for d in ("fwd", "bwd"):
                        if not rows[d]["pair_bits_equal"]:
                            failures.append(f"{name}_{d} {site}: not the unfused kernel pair's bits")
                    timed = {"fwd": lambda: fwd(x, wt, b, True), "bwd": lambda: bwd(x, y, g, wt, True)}
                    for d, fn in timed.items():
                        rows[d].update({"ms": device_ms(fn), "cold_ms": device_ms(fn, cold=True), **shared[d]})
                for d, row in rows.items():
                    bms, by = row.pop("bound")
                    cases[f"{name}_{d}"].append({
                        "site": site, "shape": list(shape), "cout": cout, "relu": relu, **row,
                        "bound_ms": bms, "bound_by": by, "frame_vs_tblock": between,
                        "plan": fb.plan(torch.float32, name.endswith("tblock"), shape, cout)[d],
                    })
                    if not row["max_abs_err"] <= row["tol"]:
                        failures.append(f"{name}_{d} {site} relu={relu}: err {row['max_abs_err']} > {row['tol']}")
            if not (between["fwd_err"] <= y_tol and between["bwd_err"] <= 1e-5 * max(1.0, dxf.abs().max().item())):
                failures.append(f"fused per-frame vs tblock {site} relu={relu}: {between}")
    for name, rows_ in cases.items():
        for row in rows_:
            emit({"phase": "kernel_check", "kernel": name, **row})
    _fused_summary("kernel_check", cases)
    return cases


def _fused_summary(phase: str, cases: dict) -> None:
    """One line per fused entry: its timed rows (ReLU on) summed over the
    nine branch-3 sites, beside the same sums of the library pair, the
    unfused kernel pair and the bound."""
    for name, rows in cases.items():
        on = [r for r in rows if r.get("relu") and "ms" in r and "pair_ms" in r]
        if not on:
            continue
        sums = {k: (None if any(r[k] is None for r in on) else sum(r[k] for r in on))
                for k in ("ms", "cold_ms", "plain_ms", "library_ms", "pair_ms", "bound_ms")}
        emit({"phase": phase, "kernel": name, "summary": f"sum over {len(on)} branch-3 sites, ReLU on", **sums})


def phase_small_reference(failures) -> None:
    """Each kernel route inside the whole model, on a small input, against
    the same model on the CPU (plain versions, CPU conv). The gradient is
    taken inside the port's pin of exact float32, as its own entry points
    do."""
    from ivf_tpu_torch.models import i3d_smth
    from ivf_tpu_torch.precision import reference_numerics

    x = torch.rand(1, 8, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 255
    r = torch.randn(1, 5, generator=torch.Generator().manual_seed(3))
    for route in ("kernels", "fused", "fused_tblock"):
        model = i3d_smth(num_classes=5, pool_shape=(1, 1, 1), **FUSED_ROUTES[route])
        model.reset_parameters(torch.Generator().manual_seed(1))
        with torch.no_grad():
            model.logits.conv3d.weight.mul_(0.005)
        model.eval().requires_grad_(False)
        out = {}
        for dev in ("cpu", "cuda"):
            m = model.to(dev)
            xd = x.to(dev).requires_grad_(True)
            with reference_numerics():
                logits = m(xd)
                (grad,) = torch.autograd.grad(logits, xd, r.to(dev))
            out[dev] = (logits.detach().cpu(), grad.cpu())
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        logit_err = ((lg - lc).abs().max() / lc.abs().max()).item()
        grad_err = ((gg - gc).abs().max() / gc.abs().max()).item()
        emit({"phase": "small_reference", "route": route, "logits_rel_err": logit_err, "logits_tol": 1e-4,
              "input_grad_rel_err": grad_err, "input_grad_tol": 1e-3})
        if not (logit_err <= 1e-4 and grad_err <= 1e-3):
            failures.append(f"small_reference {route}: logits {logit_err}, grad {grad_err}")


def _scaled_weights(cfg, api):
    """Seeded weights with the logits layer scaled so the class scores
    over the 174 classes have std 2 on the first clip: the softmax is not
    saturated, so the class score and its gradient steer the masks."""
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    model = api.build_model(cfg, softmax_override=False, device="cuda").requires_grad_(False)
    clip = torch.from_numpy(SyntheticClips(1, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)[0][0])
    with torch.no_grad():
        logits = model(clip[None].cuda().float())
        model.logits.conv3d.weight.mul_(2.0 / logits.std())
        model.logits.conv3d.bias.zero_()
    return model.state_dict()


def _diffs(a: dict, b: dict, score_keys=("original_score_guess", "freeze_score", "reverse_score")) -> dict:
    import numpy as np

    return {
        "max_mask_diff": float(np.abs(a["masks"] - b["masks"]).max()),
        "max_cam_diff": float(np.abs(a["cams"] - b["cams"]).max()),
        "max_score_diff": max(abs(r[k] - q[k]) for r, q in zip(a["tm"], b["tm"]) for k in score_keys),
        "score_keys": list(score_keys),
    }


# the counters of each fused route's two kernels
FUSED_COUNTERS = {"fused": ("fused_pool_conv_fwd", "fused_pool_conv_bwd"),
                  "fused_tblock": ("fused_pool_conv_tblock_fwd", "fused_pool_conv_tblock_bwd")}
# the bfloat16 kernels: the kernel route's three, the default route's two
BF16_KERNEL_COUNTERS = ("pointwise_conv_bf16", "maxpool3d_s1_fwd_bf16", "maxpool3d_s1_bwd_bf16")
ARGMAX_COUNTERS = ("argmax_pool_fwd", "argmax_pool_bwd")
BF16_COUNTERS = BF16_KERNEL_COUNTERS + ARGMAX_COUNTERS
# the bfloat16 entries of the fused branch 3 (per route) and of the gates
BF16_FUSED_COUNTERS = {
    "bf16_fused": ("fused_pool_conv_fwd_bf16", "fused_pool_conv_bwd_bf16"),
    "bf16_fused_tblock": ("fused_pool_conv_tblock_fwd_bf16", "fused_pool_conv_tblock_bwd_bf16"),
}
BF16_GATE_COUNTERS = ("lstm_gates_fwd_bf16", "lstm_gates_bwd_bf16")
# the all-bfloat16 pair: the bf16 train step's state is bf16 (it casts the clips)
BF16S_GATE_COUNTERS = ("lstm_gates_fwd_bf16s", "lstm_gates_bwd_bf16s")
ALL_BF16_COUNTERS = (BF16_COUNTERS + BF16_GATE_COUNTERS
                     + tuple(n for names in BF16_FUSED_COUNTERS.values() for n in names))


def _check_route_launches(route: str, launches: dict, runs: dict, failures) -> None:
    """Which kernels each route must launch: none without kernels; the
    pointwise and pool kernels on the pool-kernel route; on a fused route
    its two kernels exactly as often as the pool kernels launched there,
    the pointwise kernel that many times fewer (b3b's convs), the pool
    kernels and the other fused variant never."""
    pool = ("maxpool3d_s1_fwd", "maxpool3d_s1_bwd")
    fused = FUSED_COUNTERS
    if any(launches[n] for n in ALL_BF16_COUNTERS):
        failures.append(f"main path {route}: a bfloat16 kernel launched in float32 {launches}")
    if route == "plain":
        ok = not any(launches.values())
    elif route == "kernels":
        ok = all(launches[n] > 0 for n in ("pointwise_conv", *pool))
        ok = ok and not any(launches[n] for names in fused.values() for n in names)
    else:
        ref = runs["kernels"]["launches"]
        want = {n: ref[p] for n, p in zip(fused[route], pool)}
        want["pointwise_conv"] = ref["pointwise_conv"] - ref[pool[0]] - ref[pool[1]]
        others = [n for r, names in fused.items() if r != route for n in names] + list(pool)
        ok = all(launches[n] == v > 0 for n, v in want.items()) and not any(launches[n] for n in others)
    if not ok:
        failures.append(f"main path {route}: launches {launches}")


def _find_masks_run(api, counters, out_dir: str, name: str, flags: dict, weights, dataset,
                    batch: int = BATCH, steps: int = STEPS, cfg=None, **find_kwargs) -> dict:
    """One ``find_masks`` run of i3d_smth at full width with the model
    flags ``flags`` (or of ``cfg`` as given, whose ``opt_iter`` must be
    ``steps``; ``find_kwargs`` go to ``find_masks``), every launch counter
    set to 0 just before it and read just after; its records, masks, CAMs,
    central-init logits (read back from find_masks's own call; None when
    it made none), launches, rate and peak memory."""
    from unittest import mock

    import numpy as np

    from ivf_tpu_torch.config import Config

    if cfg is None:
        cfg = Config()
        cfg.output_dir, cfg.model_name = out_dir, name
        cfg.data.batch_size = batch
        cfg.mask.opt_iter = steps
        for key, value in flags.items():
            setattr(cfg.model, key, value)
    res = Path(cfg.output_dir) / cfg.model_name / "results"
    if "save_viz" in inspect.signature(api.find_masks).parameters:
        # no artifacts unless asked: the timings stay those of the runs
        # before find_masks wrote them (a parent checkout has no save_viz)
        find_kwargs.setdefault("save_viz", False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    for fn in counters.values():
        fn.launches = 0
    inits, init_fn = [], api.init_mask_central

    def read_init(*args, **kwargs):
        out = init_fn(*args, **kwargs)
        inits.append(out.cpu())
        return out

    t0 = time.perf_counter()
    with mock.patch.object(api, "init_mask_central", read_init):
        tm, gc = api.find_masks(cfg, weights, dataset, stats=stats, **find_kwargs)
    wall = time.perf_counter() - t0
    launches = {key: fn.launches for key, fn in counters.items()}
    return dict(
        tm=tm, gc=gc, masks=np.stack([r["time_mask"] for r in tm]) if tm else np.zeros((0, CLIP_T), np.float32),
        cams=np.stack([r["GCHeatMap"] for r in gc]) if gc else np.zeros((0, CLIP_T, CLIP_HW, CLIP_HW), np.float32),
        inits=torch.cat(inits).numpy() if inits else None, launches=launches, wall=wall, stats=stats,
        rate=stats["searched_rows"] * steps / stats["search_seconds"] if stats["search_seconds"] else None,
        peak_gib=torch.cuda.max_memory_allocated() / 2**30,
        pickles=sorted(p.name for p in res.glob("all*Results_*.p")),
    )


def _check_outputs(label: str, run: dict, failures, batch: int = BATCH) -> None:
    import numpy as np

    masks, cams = run["masks"], run["cams"]
    if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
        failures.append(f"{label}: masks not finite in [0, 1]")
    if cams.shape != (batch, CLIP_T, CLIP_HW, CLIP_HW) or not np.isfinite(cams).all():
        failures.append(f"{label}: CAMs {cams.shape} not finite (B, 16, 224, 224)")
    if len(run["pickles"]) != 2:
        failures.append(f"{label}: pickles missing: {run['pickles']}")


def phase_main_path(api, counters, failures, card: str) -> dict:
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        # the first run in the process pays cuDNN's per-shape algorithm
        # choice and module loading: a run without the kernels goes first,
        # then the runs that are compared; the pool-kernel route runs again
        # last, which must give the same bits
        order = ("plain", "kernels", "plain", "fused", "fused_tblock", "kernels_again")
        for run, label in enumerate(order):
            route = label.replace("_again", "")
            cfg = Config()
            for name, value in FUSED_ROUTES[route].items():
                setattr(cfg.model, name, value)
            weights = _scaled_weights(cfg, api)
            r = _find_masks_run(api, counters, out_dir, f"chip_smoke_{run}_{label}",
                                FUSED_ROUTES[route], weights, dataset)
            r["weights"] = weights
            runs[label] = r
            emit({
                "phase": "main_path", "run": run, "route": label, "flags": FUSED_ROUTES[route],
                "kernels": route != "plain", "card": card, "model": "i3d_smth",
                "clips": BATCH, "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3],
                "steps": STEPS, "mask_steps_per_s": r["rate"],
                "search_seconds": r["stats"]["search_seconds"], "init_seconds": r["stats"]["init_seconds"],
                "wall_seconds": r["wall"], "launches": r["launches"], "peak_mem_gib": r["peak_gib"],
                "masks": r["masks"].round(4).tolist(), "pickles": r["pickles"],
            })
            _check_route_launches(route, r["launches"], runs, failures)
            _check_outputs(label, r, failures)
    # the masks differ here (the pool's tie rule), so the freeze and reverse
    # scores do too: only the original scores are held
    d = _diffs(runs["kernels"], runs["plain"], ("original_score_guess",))
    emit({"phase": "main_path_compare", "routes": ["kernels", "plain"], **d, "mask_tol": MASK_TOL,
          "mask_tol_reason": MASK_TOL_REASON, "cam_tol": 1e-3, "score_tol": 1e-4})
    if not (d["max_mask_diff"] <= MASK_TOL and d["max_cam_diff"] <= 1e-3 and d["max_score_diff"] <= 1e-4):
        failures.append(f"kernels on vs off: {d}")
    again = _equal_bits(runs["kernels_again"], runs["kernels"])
    emit({"phase": "main_path_compare", "routes": ["kernels_again", "kernels"],
          **_diffs(runs["kernels_again"], runs["kernels"]), "equal_bits": again, "required": "equal bits"})
    if not again:
        failures.append("kernels_again vs kernels: the same route run twice gave other bits")
    for a, b in (("fused", "kernels"), ("fused_tblock", "kernels"), ("fused", "fused_tblock")):
        d = _diffs(runs[a], runs[b])
        emit({"phase": "main_path_compare", "routes": [a, b], **d, "equal_bits": _equal_bits(runs[a], runs[b]),
              "mask_tol": FUSED_MASK_TOL, "mask_tol_reason": FUSED_MASK_TOL_REASON,
              "cam_tol": 1e-3, "score_tol": 1e-4})
        if not (d["max_mask_diff"] <= FUSED_MASK_TOL and d["max_cam_diff"] <= 1e-3
                and d["max_score_diff"] <= 1e-4):
            failures.append(f"{a} vs {b}: {d}")
    launches = dict(runs["kernels"]["launches"])
    for route, names in FUSED_COUNTERS.items():
        launches.update({n: runs[route]["launches"][n] for n in names})
    return launches, runs["kernels"]


def _equal_bits(a: dict, b: dict) -> bool:
    import numpy as np

    scores = ("original_score_guess", "freeze_score", "reverse_score")
    return bool(np.array_equal(a["masks"], b["masks"]) and np.array_equal(a["cams"], b["cams"])
                and all(r[k] == q[k] for r, q in zip(a["tm"], b["tm"]) for k in scores))


def _clstm_cfg(kernels: bool, out_dir: str = "", run_name: str = "", dtype: str = "float32"):
    """The clstm_kth preset (configs/config_clstm_kth.py) as the port's
    config, with 10 search steps, in ``dtype``."""
    from ivf_tpu_torch.config import Config

    cfg = Config()
    cfg.output_dir, cfg.model_name = out_dir, run_name
    m = cfg.model
    m.conv_model, m.num_classes = "clstm_kth", CLSTM_CLASSES
    m.clstm_hidden, m.clstm_layers, m.conv_stride, m.conv_kernel_size = 4, 2, 2, 5
    m.batch_norm, m.dropout, m.effective_steps = True, 0.5, (7, 15, 23, 31)
    m.use_pallas, m.compute_dtype = kernels, dtype
    cfg.data.batch_size, cfg.data.clip_size = CLSTM_BATCH, CLSTM_T
    cfg.data.input_spatial_size = CLSTM_HW
    cfg.mask.opt_iter = STEPS
    return cfg


def _clstm_clips():
    """16 seeded uint8 clips of 32x120x160x3, as (clip, label, id) rows."""
    import numpy as np

    rng = np.random.RandomState(7)
    return [
        (rng.randint(0, 256, (CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8), i % CLSTM_CLASSES, f"kth{i}")
        for i in range(CLSTM_BATCH)
    ]


def _clstm_scaled_weights(api, clip, cfg=None) -> dict:
    """Seeded weights (of ``cfg``, by default the clstm_kth preset's) with
    each layer's ``wx`` scaled so its gate pre-activations have unit std on
    one clip (raw 0-255 frames would otherwise saturate every sigmoid) and
    the fc head scaled so the class scores have std 2, as
    ``_scaled_weights`` does for I3D."""
    from ivf_tpu_torch.ops.conv import conv2d_same_torch

    model = api.build_model(cfg or _clstm_cfg(True), softmax_override=False, device="cuda")
    model.requires_grad_(False)
    x = torch.from_numpy(clip)[None].cuda().float()
    with torch.no_grad():
        for cell in model.clstm.cells:
            seen = []
            hook = cell.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
            model(x)
            hook.remove()
            px = (0, 0) if cell.x_padding == "valid" else None
            gx = conv2d_same_torch(torch.cat(seen), cell.wx, cell.conv_stride, None, px)
            cell.wx.div_(gx.std())
        logits = model(x)
        model.end_fc.weight.mul_(2.0 / logits.std())
        model.end_fc.bias.zero_()
    return model.state_dict()


def phase_clstm_small_reference(failures) -> None:
    """The ConvLSTM on the card (gate kernel where the gates are sigmoids)
    against the same model on the CPU, at (2, 8, 32, 48, 3): logits and
    input gradient, relative to the CPU's largest magnitude."""
    from ivf_tpu_torch.models import ConvLSTMClassifier
    from ivf_tpu_torch.precision import reference_numerics

    families = {
        "torch": dict(num_classes=6, nb_lstm_units=4, lstm_layers=2, conv_stride=2,
                      effective_steps=(3, 7)),
        "tf": dict(num_classes=5, hidden_channels_override=(4, 6), conv_kernel_size=(3, 5),
                   effective_steps=(2, 5, 7), shared_bn=False, block_order="tf", pooling="avg",
                   recurrent_activation="hard_sigmoid", unit_forget_bias=True, x_padding="valid"),
    }
    x = torch.rand(2, 8, 32, 48, 3, generator=torch.Generator().manual_seed(5))
    for family, kw in families.items():
        model = ConvLSTMClassifier(**kw, use_pallas=True, input_size=(32, 48), clip_len=8)
        model.reset_parameters(torch.Generator().manual_seed(6))
        model.eval().requires_grad_(False)
        r = torch.randn(2, kw["num_classes"], generator=torch.Generator().manual_seed(7))
        out = {}
        for dev in ("cpu", "cuda"):
            m = model.to(dev)
            xd = x.to(dev).requires_grad_(True)
            with reference_numerics():
                logits = m(xd)
                (grad,) = torch.autograd.grad(logits, xd, r.to(dev))
            out[dev] = (logits.detach().cpu(), grad.cpu())
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        logit_err = ((lg - lc).abs().max() / lc.abs().max()).item()
        grad_err = ((gg - gc).abs().max() / gc.abs().max()).item()
        emit({"phase": "clstm_small_reference", "family": family, "logits_rel_err": logit_err,
              "logits_tol": 1e-4, "input_grad_rel_err": grad_err, "input_grad_tol": 1e-3})
        if not (logit_err <= 1e-4 and grad_err <= 1e-3):
            failures.append(f"clstm_small_reference {family}: logits {logit_err}, grad {grad_err}")


def _check_clstm_outputs(label: str, r: dict, failures) -> None:
    import numpy as np

    masks, cams = r["masks"], r["cams"]
    if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
        failures.append(f"{label}: masks not finite in [0, 1]")
    want = (CLSTM_BATCH, CLSTM_T, *CLSTM_HW)
    if cams.shape != want or not np.isfinite(cams).all():
        failures.append(f"{label}: CAMs {cams.shape} not finite {want}")
    if len(r["pickles"]) != 2:
        failures.append(f"{label}: pickles missing: {r['pickles']}")


def _emit_clstm_run(phase: str, run: int, label: str, kernels: bool, r: dict, card: str) -> None:
    emit({
        "phase": phase, "run": run, "route": label, "kernels": kernels, "card": card,
        "model": "clstm_kth", "clips": CLSTM_BATCH, "clip_shape": [CLSTM_T, *CLSTM_HW, 3], "steps": STEPS,
        "mask_steps_per_s": r["rate"], "search_seconds": r["stats"]["search_seconds"],
        "init_seconds": r["stats"]["init_seconds"], "wall_seconds": r["wall"], "launches": r["launches"],
        "peak_mem_gib": r["peak_gib"], "mask_std_over_clips": float(r["masks"].std(axis=0).mean()),
        "masks": r["masks"].round(4).tolist()[:4], "pickles": r["pickles"],
    })


def phase_clstm_main_path(api, counters, failures, card: str, weights: dict) -> dict:
    import numpy as np

    dataset = _clstm_clips()
    gate_names = ("lstm_gates_fwd", "lstm_gates_bwd")
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        # a run without the kernel first pays cuDNN's algorithm choice
        for run, kernels in enumerate((False, True, False)):
            cfg = _clstm_cfg(kernels, out_dir, f"chip_smoke_clstm_{run}")
            r = _find_masks_run(api, counters, out_dir, "", {}, weights, dataset, cfg=cfg)
            runs[kernels] = r
            _emit_clstm_run("clstm_main_path", run, "kernels" if kernels else "plain", kernels, r, card)
            launches = r["launches"]
            if kernels and not (all(launches[n] > 0 for n in gate_names)
                                and not any(launches[n] for n in launches if n not in gate_names)):
                failures.append(f"clstm main path with the kernel: launches {launches}")
            if not kernels and any(launches.values()):
                failures.append(f"clstm main path without kernels launched one {launches}")
            _check_clstm_outputs("clstm", r, failures)
    on, off = runs[True], runs[False]
    mask_diff = float(np.abs(on["masks"] - off["masks"]).max())
    cam_diff = float(np.abs(on["cams"] - off["cams"]).max())
    score_diff = max(
        abs(a["original_score_guess"] - b["original_score_guess"]) for a, b in zip(on["tm"], off["tm"])
    )
    emit({"phase": "clstm_main_path_compare", "max_mask_diff": mask_diff, "mask_tol": CLSTM_MASK_TOL,
          "mask_tol_reason": CLSTM_MASK_TOL_REASON, "max_cam_diff": cam_diff, "cam_tol": 1e-3,
          "max_orig_score_diff": score_diff, "orig_score_tol": 1e-5,
          "cam_score_tol_reason": "the forward differs by the gate block's float32 rounding "
          "(~1e-7 relative) carried through 32 steps; scores are softmax "
          "probabilities, CAMs are normalized to [0, 1]"})
    if not (mask_diff <= CLSTM_MASK_TOL and cam_diff <= 1e-3 and score_diff <= 1e-5):
        failures.append(f"clstm kernels on vs off: mask {mask_diff}, cam {cam_diff}, score {score_diff}")
    return on


def phase_clstm_bf16_main_path(api, counters, failures, card: str, weights: dict, f32_run: dict) -> dict:
    """``find_masks`` on clstm_kth at full width in bfloat16 (bf16 weights
    and gates, float32 state), with the gate kernel and without, each
    twice: launches, equal bits run to run, the two routes against each
    other and against the float32 kernel run (on the clips whose central
    init chose the same candidate, at least one), and the search from one
    carry on every clip."""
    from ivf_tpu_torch.interpret import mask_opt

    dataset = _clstm_clips()
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for run, label in enumerate(("bf16_kernels", "bf16_plain", "bf16_kernels_again", "bf16_plain_again")):
            kernels = label.startswith("bf16_kernels")
            cfg = _clstm_cfg(kernels, out_dir, f"chip_smoke_clstm_{label}", "bfloat16")
            r = _find_masks_run(api, counters, out_dir, "", {}, weights, dataset, cfg=cfg)
            runs[label] = r
            _emit_clstm_run("clstm_bf16_main_path", run, label, kernels, r, card)
            launches = r["launches"]
            mine = BF16_GATE_COUNTERS if kernels else ()
            if not (all(launches[n] > 0 for n in mine) and not any(launches[n] for n in launches if n not in mine)):
                failures.append(f"clstm bf16 main path {label}: launches {launches}")
            if kernels and any(launches[b] != f32_run["launches"][f] for b, f in
                               zip(BF16_GATE_COUNTERS, ("lstm_gates_fwd", "lstm_gates_bwd"))):
                failures.append(f"clstm bf16 {label}: gate launches {launches} differ from float32's")
            _check_clstm_outputs(f"clstm {label}", r, failures)
    for a, b in (("bf16_kernels_again", "bf16_kernels"), ("bf16_plain_again", "bf16_plain")):
        bits = _equal_bits(runs[a], runs[b])
        emit({"phase": "clstm_bf16_main_path_compare", "routes": [a, b], **_diffs(runs[a], runs[b]),
              "equal_bits": bits, "required": "equal bits"})
        if not bits:
            failures.append(f"clstm {a} vs {b}: the same route run twice gave other bits")
    for a, b, score_tol, cam_tol in (
            ("bf16_kernels", "float32_kernels", BF16_SCORE_TOL, BF16_CAM_TOL),
            ("bf16_plain", "float32_kernels", BF16_SCORE_TOL, BF16_CAM_TOL),
            ("bf16_kernels", "bf16_plain", BF16_ROUTES_TOL, BF16_ROUTES_TOL)):
        d = _bf16_vs(runs[a], f32_run if b == "float32_kernels" else runs[b])
        emit({"phase": "clstm_bf16_main_path_compare", "routes": [a, b], **d,
              "mask_tol_same_init": BF16_MASK_TOL, "score_tol": score_tol, "cam_tol": cam_tol,
              "tol_reason": CLSTM_BF16_TOL_REASON})
        m = d["max_mask_diff_same_init"]
        if m is None:
            failures.append(f"clstm {a} vs {b}: the central init chose another candidate on every clip")
        elif m > BF16_MASK_TOL or d["max_score_diff"] > score_tol or d["max_cam_diff"] > cam_tol:
            failures.append(f"clstm {a} vs {b}: {d}")
    # the search from one central carry, the same targets, on every clip
    import numpy as np

    clips = torch.from_numpy(np.stack([c for c, _, _ in dataset])).cuda().float()
    results, targets = {}, None
    for label, kernels, dtype in (("float32_kernels", True, "float32"), ("bf16_kernels", True, "bfloat16"),
                                  ("bf16_plain", False, "bfloat16")):
        model = api.build_model(_clstm_cfg(kernels, dtype=dtype), softmax_override=True)
        model.load_state_dict(weights)
        model.requires_grad_(False)

        def score(x, m=model):
            return m(x).float()

        if targets is None:
            with torch.no_grad():
                targets = score(clips).argmax(dim=-1)
        results[label] = mask_opt.find_mask_from_carry(
            score, clips, targets, _central_carry(CLSTM_BATCH, CLSTM_T), n_steps=STEPS)
    ref = results["float32_kernels"]
    for label in ("bf16_kernels", "bf16_plain"):
        r = results[label]
        d = {"max_mask_diff": (r.mask - ref.mask).abs().max().item(),
             "max_score_diff": max((getattr(r, k) - getattr(ref, k)).abs().max().item()
                                   for k in ("freeze_score", "reverse_score", "orig_score"))}
        emit({"phase": "clstm_bf16_search_from_carry", "routes": [label, "float32_kernels"], "steps": STEPS,
              **d, "mask_tol": BF16_MASK_TOL, "score_tol": BF16_SCORE_TOL})
        if not (d["max_mask_diff"] <= BF16_MASK_TOL and d["max_score_diff"] <= BF16_SCORE_TOL):
            failures.append(f"clstm bf16 search from one carry, {label} vs float32: {d}")
    return {n: runs["bf16_kernels"]["launches"][n] for n in BF16_GATE_COUNTERS}


def _group(name: str) -> str:
    if "nccl" in name.lower():
        return "NCCL collectives"
    if "fpc_fwd" in name or "fpc_bwd" in name:
        return "fused_branch3 kernels"
    if "lstm_gates" in name:
        return "fused_gates kernels"
    if "argmax_fwd" in name or "argmax_bwd" in name:
        return "argmax_pool kernels"
    if "pw_gemm" in name:
        return "pointwise_conv kernel"
    if "pool_fwd" in name or "pool_bwd" in name:
        return "maxpool3d_s1 kernels"
    low = name.lower()
    # cuDNN's implicit-GEMM convs carry "xmma" too, as cuBLAS's sm80_xmma_gemm
    # does: tell them apart by "implicit_gemm"
    if "conv" in low or "implicit_gemm" in low or "cudnn" in low or "dgrad" in low:
        return "cuDNN convolution"
    if "gemm" in low or "gemv" in low:
        return "cuBLAS matmul"
    if "max_pool" in low:
        return "torch max pool"
    if "avg_pool" in low:
        return "torch avg pool"
    return "elementwise and other"


def phase_step_timing(api, card: str, failures) -> None:
    """Steady per-step wall time of the I3D search on each route."""
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    ds = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    clips = torch.stack([torch.from_numpy(ds[i][0]) for i in range(BATCH)]).cuda().float()
    # the main path's weights (logits scaled): with the raw seeded weights
    # the softmax saturates and the step's gradient is NaN
    weights = _scaled_weights(Config(), api)
    models = {}
    for route in ("kernels", "plain", "fused", "fused_tblock", "kernels_plain_stem"):
        cfg = Config()
        for name, value in FUSED_ROUTES[route.replace("_plain_stem", "")].items():
            setattr(cfg.model, name, value)
        model = api.build_model(cfg, softmax_override=True)
        model.load_state_dict(weights)
        models[route] = _stem(model.requires_grad_(False), not route.endswith("_plain_stem"))
    # one search step from the same carry on the three kernel routes (same
    # seeded weights): the fused kernels should leave every bit as it was
    from ivf_tpu_torch.interpret import mask_opt

    targets = torch.zeros(BATCH, dtype=torch.long, device="cuda")
    carry0 = _central_carry(BATCH, CLIP_T)
    after = {
        route: mask_opt.search_step(lambda x, m=models[route]: m(x).float(), clips, targets, carry0)
        for route in ("kernels", "fused", "fused_tblock")
    }
    emit({"phase": "route_step_bits", "card": card, "batch": BATCH, **{
        route: {"logits_equal_bits": bool(torch.equal(after[route].logits, after["kernels"].logits)),
                "max_logit_diff": (after[route].logits - after["kernels"].logits).abs().max().item(),
                "max_score_diff": (after[route].aux[2] - after["kernels"].aux[2]).abs().max().item()}
        for route in ("fused", "fused_tblock")}})
    if not all(torch.isfinite(c.logits).all() for c in after.values()):
        failures.append("route_step_bits: a search step gave non-finite logits")
    turns = ("kernels", "plain", "fused", "fused_tblock", "kernels_plain_stem")
    _step_timing("step_timing", models, clips, card, turns=turns + turns[::-1])


def _stem(model, s2d: bool):
    """``model`` with its stem as the space-to-depth conv or the plain one
    (``I3D(stem_s2d=...)``; the config has no such field)."""
    model.Conv3d_1a_7x7.s2d = s2d
    return model


def phase_clstm_step_timing(api, card: str, weights: dict) -> None:
    """Steady per-step wall time of the ConvLSTM search (kernel on / off),
    in float32 and in bfloat16."""
    import numpy as np

    clips = torch.from_numpy(np.stack([c for c, _, _ in _clstm_clips()])).cuda().float()
    models = {}
    for route in ("kernels", "plain", "bf16_kernels", "bf16_plain"):
        dtype = "bfloat16" if route.startswith("bf16") else "float32"
        model = api.build_model(_clstm_cfg(route.endswith("kernels"), dtype=dtype), softmax_override=True)
        model.load_state_dict(weights)
        models[route] = model.requires_grad_(False)
    # the host bounds this step and shares its cores: twice the turns
    _step_timing("clstm_step_timing", models, clips, card,
                 turns=("kernels", "plain", "bf16_kernels", "bf16_plain",
                        "bf16_plain", "bf16_kernels", "plain", "kernels") * 2, pairs=12)


def _central_carry(b: int, t: int):
    """A search carry shaped like the central init (logits +5 on the middle
    half of the frames, -5 outside). Not a constant mask: the TV norm's
    gradient is NaN where every neighbouring mask value is equal."""
    from ivf_tpu_torch.interpret import mask_opt

    pos = torch.arange(t, device="cuda")
    logits = torch.where((pos >= t // 4) & (pos < t - t // 4), 5.0, -5.0)
    return mask_opt.make_search_carry(logits.expand(b, t).contiguous())


def _host_us_per_launch(n: int = 2000) -> float:
    """Host microseconds per eager launch of a one-element add: how fast
    this host dispatches at the moment (the card needs ~2 us per launch)."""
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _step_timing(phase: str, models: dict, clips, card: str, turns, pairs: int = 0, steps: int = 5,
                 contexts: dict = None) -> None:
    """Steady per-step wall time of the search for each route of ``models``
    (route name -> model), ``steps`` steps after a warm-up of two in each of
    ``turns``, then one profiled step of each: device time by kernel group,
    the device-busy share, the top kernels and the step's peak device
    memory. ``contexts``: route ->
    ``_repairs_off`` arguments the route's steps run under. With ``pairs``, also that many
    single steps of the first two routes (kernels on, then off), back to
    back with the first of each pair alternating, and the host's launch
    rate before and after: a host-bound step drifts with the host's speed,
    which pairs of neighbouring steps cancel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch.interpret import mask_opt

    b, t = clips.shape[:2]
    targets = torch.zeros(b, dtype=torch.long, device="cuda")
    contexts = contexts or {}
    step_fns = {}
    for route, model in models.items():
        score = lambda x, m=model: m(x).float()  # noqa: E731

        def step(c, score=score, off=contexts.get(route, {})):
            with _repairs_off(**off):
                return mask_opt.search_step(score, clips, targets, c)

        step_fns[route] = step
    carry0 = _central_carry(b, t)
    wall = {route: [] for route in models}
    for route in turns:
        carry = step_fns[route](step_fns[route](carry0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            carry = step_fns[route](carry)
        torch.cuda.synchronize()
        wall[route].append((time.perf_counter() - t0) / steps * 1e3)
    if pairs:
        on_route, off_route = list(models)[:2]
        host_us = [_host_us_per_launch()]
        single = {on_route: [], off_route: []}
        for k in range(pairs):
            for route in ((on_route, off_route) if k % 2 == 0 else (off_route, on_route)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry = step_fns[route](carry)
                torch.cuda.synchronize()
                single[route].append((time.perf_counter() - t0) * 1e3)
        host_us.append(_host_us_per_launch())
        on, off = single[on_route], single[off_route]
        emit({"phase": phase + "_pairs", "card": card, "batch": b, "pairs": pairs,
              "on_ms": on, "off_ms": off,
              "median_on_ms": sorted(on)[len(on) // 2], "median_off_ms": sorted(off)[len(off) // 2],
              "pairs_on_faster": sum(a < c for a, c in zip(on, off)),
              "host_us_per_launch_before_after": host_us})
    for route in models:
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step_fns[route](carry0)
            torch.cuda.synchronize()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        groups, top, n_kernels = {}, [], 0
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0) or 0
            if dev_us <= 0 or ev.device_type != DeviceType.CUDA:
                continue  # CPU-side ops carry their kernels' time too
            groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + dev_us / 1e3
            top.append((dev_us / 1e3, ev.count, ev.key[:110]))
            n_kernels += ev.count
        device_ms = sum(groups.values())
        wall_ms = sum(wall[route]) / len(wall[route])
        emit({"phase": phase, "route": route, "kernels": route != "plain", "card": card, "batch": b,
              "wall_ms_per_step": wall[route], "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / wall_ms, "kernels_per_step": n_kernels,
              "peak_mem_gib": peak_gib, "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              "top_kernels": [list(t) for t in sorted(top, reverse=True)[:12]]})


@contextmanager
def _repairs_off(pool: bool = False, cudnn: bool = False):
    """Switch off the port's determinism repairs for a measurement: ``pool``
    puts back ``F.max_pool3d``'s and ``F.avg_pool3d``'s own (atomic)
    backwards, ``cudnn`` drops ``cudnn.deterministic`` from the entry
    points' pin (its last switch). The third repair, the plain stem's
    polyphase input gradient, is off the main path since the s2d stem."""
    from contextlib import ExitStack
    from unittest import mock

    import torch.nn.functional as F

    from ivf_tpu_torch import precision
    from ivf_tpu_torch.models import i3d
    from ivf_tpu_torch.ops import conv

    with ExitStack() as stack:
        if pool:
            stack.enter_context(mock.patch.object(
                conv._MaxPool3dFixedOrder, "apply",
                staticmethod(lambda xp, window, strides: F.max_pool3d(xp, window, strides))))
            stack.enter_context(mock.patch.object(
                i3d, "avg_pool3d_valid", lambda x, window, strides=(1, 1, 1): conv._ndhwc(
                    F.avg_pool3d(conv._ncdhw(x), tuple(window), tuple(strides)))))
        if cudnn:
            switches = precision._switches
            stack.enter_context(mock.patch.object(precision, "_switches", lambda: switches()[:-1]))
            with precision.reference_numerics():
                assert not torch.backends.cudnn.deterministic, "the cuDNN pin is not the last switch"
        yield


REPAIR_VARIANTS = {  # name -> _repairs_off arguments
    "repaired": {}, "no_cudnn_pin": dict(cudnn=True), "no_pool_repair": dict(pool=True),
    "none": dict(pool=True, cudnn=True),
}


def determinism_child() -> int:
    """The float32 pool-kernel route under ``torch.use_deterministic_algorithms``
    (``CUBLAS_WORKSPACE_CONFIG`` set by the parent before CUDA started).
    Warn mode lists the ops PyTorch flags, with the repairs off and on;
    raise mode then runs the repaired route twice, and the bfloat16
    default route twice, each pair to equal bits. One JSON line per step."""
    from ivf_tpu_torch import api
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    cfg = Config()
    for name, value in FUSED_ROUTES["kernels"].items():
        setattr(cfg.model, name, value)
    weights = _scaled_weights(cfg, api)
    with tempfile.TemporaryDirectory() as out_dir:
        for variant in ("none", "repaired"):
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught, _repairs_off(**REPAIR_VARIANTS[variant]):
                warnings.simplefilter("always")
                _find_masks_run(api, {}, out_dir, f"warn_{variant}", FUSED_ROUTES["kernels"], weights, dataset,
                                steps=2)
            flagged = sorted({str(w.message).split(" does not have")[0] for w in caught
                              if "deterministic" in str(w.message)})
            emit({"phase": "determinism", "mode": "warn_only", "variant": variant, "flagged_ops": flagged})
        torch.use_deterministic_algorithms(True)
        for label, flags in (("float32 kernels", FUSED_ROUTES["kernels"]), ("bf16 default", {"compute_dtype": "bfloat16"})):
            runs = [_find_masks_run(api, {}, out_dir, f"raise_{k}", flags, weights, dataset) for k in range(2)]
            emit({"phase": "determinism", "mode": "raise", "route": label, "raised": False,
                  "equal_bits": _equal_bits(*runs), **_diffs(*runs)})
            if not _equal_bits(*runs):
                return 1
        # one train step of each I3D route (the config_i3d_smth preset, the
        # main path's clips), raise mode: the op that raises, if one does
        from ivf_tpu_torch.train import make_train_step

        clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in range(BATCH)]).cuda()
        labels = torch.arange(BATCH, device="cuda")
        raised_any = False
        for route, flags in TRAIN_I3D_ROUTES.items():
            cfg = _train_preset(api, "config_i3d_smth.py", out_dir, route, **flags)
            try:
                make_train_step(compute_dtype=cfg.model.compute_dtype)(_train_state(api, cfg), clips, labels)
                torch.cuda.synchronize()
                raised = None
            except RuntimeError as exc:
                raised = str(exc).splitlines()[0]
            emit({"phase": "determinism", "mode": "raise", "train_route": route, "raised": raised})
            raised_any = raised_any or raised is not None
    return 1 if raised_any else 0


def phase_determinism(api, counters, failures, card: str, weights: dict) -> dict:
    """The child process's checks, then in this process each repair
    switched off in turn: two float32 pool-kernel runs each (equal bits?)
    and the cost of the repairs per search step."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--determinism-child"],
                          capture_output=True, text=True, env=env, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            emit(json.loads(line))
    if proc.returncode != 0:
        failures.append(f"determinism child exited {proc.returncode}: {proc.stderr[-3000:]}")
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    out = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for variant, off in REPAIR_VARIANTS.items():
            with _repairs_off(**off):
                runs = [_find_masks_run(api, counters, out_dir, f"det_{variant}_{k}", FUSED_ROUTES["kernels"],
                                        weights, dataset) for k in range(2)]
            out[variant] = _equal_bits(*runs)
            emit({"phase": "determinism", "mode": "default", "variant": variant, "card": card,
                  "equal_bits": out[variant], **_diffs(*runs),
                  "mask_steps_per_s": [r["rate"] for r in runs]})
    if not out["repaired"]:
        failures.append("determinism: two repaired float32 runs gave other bits")
    # cost of each repair per search step, in turns on the pool-kernel route
    from ivf_tpu_torch.config import Config

    cfg = Config()
    for name, value in FUSED_ROUTES["kernels"].items():
        setattr(cfg.model, name, value)
    model = api.build_model(cfg, softmax_override=True)
    model.load_state_dict(weights)
    model.requires_grad_(False)
    clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in range(BATCH)]).cuda().float()
    _step_timing("repair_cost", {v: model for v in REPAIR_VARIANTS}, clips, card,
                 turns=tuple(REPAIR_VARIANTS) + tuple(reversed(REPAIR_VARIANTS)), contexts=REPAIR_VARIANTS)
    return out


def _bf16_site_inputs(shape, gen, dev):
    """Post-ReLU tie data and a cotangent, bfloat16, on the card."""
    x = _ties(shape, gen, dev).bfloat16()
    g = torch.randn(shape, generator=gen).bfloat16().to(dev)
    return x, g


# I3D's 1x1x1 convs at batch b: (site, N, Cin, Cout, launches of the
# forward per search step); each forward has a dx launch too: 40 a step
def pw_main_path(b: int = BATCH):
    s3, s4, s5 = b * 8 * 28 * 28, b * 4 * 14 * 14, b * 2 * 7 * 7
    return [
        ("Conv3d_2b", b * 8 * 56 * 56, 64, 64, 1), ("Mixed_3b_trio", s3, 192, 176, 1),
        ("Mixed_3b_b3b", s3, 192, 32, 1), ("Mixed_3c_trio", s3, 256, 288, 1), ("Mixed_3c_b3b", s3, 256, 64, 1),
        ("Mixed_4b_trio", s4, 480, 304, 1), ("Mixed_4b_b3b", s4, 480, 64, 1), ("Mixed_4c_trio", s4, 512, 296, 1),
        ("Mixed_4d_trio", s4, 512, 280, 1), ("Mixed_4e_trio", s4, 512, 288, 1), ("Mixed_4cde_b3b", s4, 512, 64, 3),
        ("Mixed_4f_trio", s4, 528, 448, 1), ("Mixed_4f_b3b", s4, 528, 128, 1), ("Mixed_5b_trio", s5, 832, 448, 1),
        ("Mixed_5c_trio", s5, 832, 624, 1), ("Mixed_5bc_b3b", s5, 832, 128, 2), ("logits", b, 1024, 174, 1),
    ]


def host_us_per_call(pw, n: int, cin: int, cout: int, relu: bool, copy_w: bool = False,
                     calls: int = 300) -> float:
    """Host microseconds per ``pointwise_conv_bf16_cuda`` call (argument
    checks, plan, tensor maps, allocation, ctypes, launch), the device left
    to run behind: enqueue time, synchronized only at the end. W is the
    column-major view of a (Cout, Cin) weight, as the layers pass it;
    ``copy_w``: made contiguous before each call, as the layers did before
    the kernels read W as stored."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    x = torch.rand(n, cin, generator=gen, device="cuda").bfloat16()
    w = torch.rand(cout, cin, generator=gen, device="cuda").bfloat16().t()
    b = torch.rand(cout, generator=gen, device="cuda").bfloat16()

    def call():
        return pw.pointwise_conv_bf16_cuda(x, w.contiguous() if copy_w else w, b, relu)

    for _ in range(10):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def bf16_width_sweep() -> int:
    """``python3 chip_smoke.py --bf16-width-sweep``: the bf16 TMA GEMM at
    every trunk shape of the main path (batch 4), forward and dx, at each
    column-tile width the kernel has, launched directly: device ms and the
    error in bf16 ulps of the largest output at each width, beside the
    width ``tma_width`` picks. The data behind ``TMA_SLAB_COST_COLS``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ivf_tpu_torch.ops.kernels import pointwise_conv as pw

    lib, dev, bad = pw._lib(), torch.device("cuda"), []
    gen = torch.Generator().manual_seed(0)
    emit({"phase": "bf16_width_sweep", "nvidia_smi": nvidia_smi()})
    for site, n, cin, cout, per_step in pw_main_path():
        if site == "logits":
            continue
        wk = (torch.randn(cout, cin, generator=gen) / cin**0.5).bfloat16().to(dev)
        bias = torch.randn(cout, generator=gen).bfloat16().to(dev)
        for direction in ("fwd", "dx"):
            if direction == "fwd":
                x, w, b, relu, k, c = _ties((n, cin), gen, dev).bfloat16(), wk.t(), bias, True, cin, cout
            else:
                x, w, b, relu, k, c = torch.randn(n, cout, generator=gen).bfloat16().to(dev), wk, None, False, cout, cin
            mn = int(w.stride(1) == 1)
            ref = pw.pointwise_conv_plain(x, w, b, relu).float()
            y = torch.empty(n, c, device=dev, dtype=torch.bfloat16)
            widths = {}
            for bn in pw.TMA_WIDTHS:
                def call(bn=bn):
                    rc = lib.pw_conv_bf16_tma(x.data_ptr(), x.stride(0), w.data_ptr(), w.stride(1 - mn), mn,
                                              b.data_ptr() if b is not None else None, y.data_ptr(), n, k, c, bn,
                                              int(relu), torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"pw_conv_bf16_tma failed with CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                ulps = (y.float() - ref).abs().max().item() / (2.0**-7 * ref.abs().max().item())
                widths[bn] = {"ms": device_ms(call), "err_ulps": ulps}
                if not ulps <= 1.0:
                    bad.append(f"{site} {direction} bn={bn}: {ulps} ulps")
            chosen = pw.tma_width(n, k, c)
            emit({"phase": "bf16_width_sweep", "site": site, "direction": direction, "shape": [n, k, c],
                  "launches_per_step": per_step, "widths": widths, "chosen": chosen,
                  "chosen_ms": widths[chosen]["ms"], "best": min(widths, key=lambda bn: widths[bn]["ms"])})
    for f in bad:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if bad else 0


def f32_tile_sweep() -> int:
    """``python3 chip_smoke.py --f32-tile-sweep``: the float32 GEMM at every
    1x1x1 conv of the main path (batch 4), forward (W the layers'
    column-major view) and dx (W^T, row-major), under every tile of
    ``pointwise_conv.F32_TILES`` and, at few rows, the rows kernel, each
    forced through ``pointwise_conv_cuda(..., tile=)``: device ms (the
    larger of two readings: the profiler now and then drops a kernel's
    events), the error against the plain version within 1e-5 of the
    largest output, and equal bits across tiles (each output is one fmaf
    chain in K order whichever tile computes it); beside the planner's
    pick. Then ``f32_fit``: per tile, the least-squares constants of
    ``pointwise_conv.F32_COST`` (weighted to relative error; M the best of
    1-4) and how close the refitted planner's picks come to the fastest
    tile. The data behind ``F32_COST``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ivf_tpu_torch.ops.kernels import pointwise_conv as pw

    dev, bad, samples = torch.device("cuda"), [], []
    gen = torch.Generator().manual_seed(23)
    emit({"phase": "f32_tile_sweep", "nvidia_smi": nvidia_smi()})
    for site, n, cin, cout, per_step in pw_main_path():
        wk = (torch.randn(cout, cin, generator=gen) / cin**0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        relu = site != "logits"
        for direction in ("fwd", "dx"):
            if direction == "fwd":
                x, w, b, act, k, c = _ties((n, cin), gen, dev), wk.t(), bias, relu, cin, cout
            else:
                x, w, b, act, k, c = torch.randn(n, cout, generator=gen).to(dev), wk, None, False, cout, cin
            ref = pw.pointwise_conv_plain(x, w, b, act)
            tol = 1e-5 * ref.abs().max().item()
            tiles = (["rows"] if n <= pw.F32_ROWS_MAX else []) + list(pw.F32_TILES)
            times, first = {}, None
            for tile in tiles:
                def call(tile=tile):
                    return pw.pointwise_conv_cuda(x, w, b, act, tile=tile)

                y = call()
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                first = y if first is None else first
                same = bool(torch.equal(y, first))
                times[tile] = {"ms": max(device_ms(call, reps=10), device_ms(call, reps=10)), "err": err,
                               "bits_equal": same}
                if not (err <= tol and same):
                    bad.append(f"{site} {direction} tile {tile}: err {err} > {tol} or bits {same}")
                if tile != "rows":
                    samples.append((n, k, c, tile, times[tile]["ms"]))
            chosen = pw.f32_plan(n, k, c, x.stride(), x.data_ptr(), w.stride(), w.data_ptr())["tile"]
            best = min(times, key=lambda t: times[t]["ms"])
            emit({"phase": "f32_tile_sweep", "site": site, "direction": direction, "shape": [n, k, c],
                  "launches_per_step": per_step, "tiles": times, "chosen": chosen,
                  "chosen_ms": times[chosen]["ms"], "best": best, "best_ms": times[best]["ms"]})
    _fit_f32_costs(pw, samples)
    for f in bad:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if bad else 0


def _fit_f32_costs(pw, samples) -> None:
    """Per tile, the constants of ``pointwise_conv.F32_COST``: time (us) =
    C0 + slabs * (C1 * b + C2 * ceil(b / R)), b the blocks of the busiest
    SM, fitted non-negative and weighted to relative error, R the best of
    1-6; then, over the swept shapes of more than ``F32_ROWS_MAX`` rows,
    the refitted model's pick against the fastest tile."""
    import numpy as np
    from scipy.optimize import nnls

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cdiv = pw._cdiv
    fitted = {}
    for tile, (bm, bn, _, _) in pw.F32_TILES.items():
        rows = [(n, k, c, ms) for n, k, c, t, ms in samples if t == tile and ms > 0 and n > pw.F32_ROWS_MAX]
        y = np.array([ms * 1e3 for *_, ms in rows])
        best = None
        for r in range(1, 7):
            x = []
            for n, k, c, _ in rows:
                slabs, busiest = cdiv(k, pw.F32_SLAB), cdiv(cdiv(n, bm) * cdiv(c, bn), sms)
                x.append([1.0, slabs * busiest, slabs * cdiv(busiest, r)])
            coef, res = nnls(np.array(x) / y[:, None], np.ones_like(y))
            if best is None or res < best[0]:
                best = (res, [round(v, 4) for v in coef], r)
        fitted[tile] = (*best[1], best[2])
    saved = dict(pw.F32_COST)
    pw.F32_COST.update(fitted)
    try:
        shapes = {(n, k, c) for n, k, c, *_ in samples if n > pw.F32_ROWS_MAX}
        ratios, picked, fastest = {}, 0.0, 0.0
        for n, k, c in sorted(shapes):
            ms = {t: v for n_, k_, c_, t, v in samples if (n_, k_, c_) == (n, k, c)}
            pick = pw.f32_plan(n, k, c, (k, 1), 0, (1, k), 0, sms)["tile"]
            ratios[f"{n}x{k}x{c}"] = ms[pick] / min(ms.values())
            picked += ms[pick]
            fastest += min(ms.values())
    finally:
        pw.F32_COST.clear()
        pw.F32_COST.update(saved)
    emit({"phase": "f32_fit", "F32_COST": fitted, "pick_over_best": ratios,
          "pick_over_best_mean": sum(ratios.values()) / len(ratios), "picked_ms": picked, "fastest_ms": fastest})


def _turns(other: str, child_flag: str, keep):
    """``chip_smoke.py <child_flag> ROOT`` on the checkout in ``other`` (say,
    the parent commit's, unpacked) and on this one, in turns (other, this,
    this, other), each in a child process that imports its own
    ``ivf_tpu_torch`` and builds its kernels. Returns side -> one
    {key: row} per turn of the JSON rows for which ``keep(row)`` gives a
    key, or None if a child failed."""
    here = str(Path(__file__).resolve().parent)
    sides = {"other": [], "this": []}
    for side, root in (("other", other), ("this", here), ("this", here), ("other", other)):
        out = subprocess.run([sys.executable, __file__, child_flag, root], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(f"chip_smoke FAILED: {child_flag} {root}\n{out.stdout[-2000:]}{out.stderr[-2000:]}",
                  file=sys.stderr)
            return None
        lines = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
        sides[side].append({key: r for r in lines if (key := keep(r)) is not None})
    return sides


def _turn_mean(runs, key, field):
    return sum(r[key][field] for r in runs) / len(runs)


def f32_compare(other: str) -> int:
    """``python3 chip_smoke.py --f32-compare DIR``: the float32 GEMM's rows
    of ``phase_kernel_check`` on the checkout in DIR and on this one, in
    turns (``_turns``): per site and direction the mean device ms of each
    side's two turns, ``torch.matmul``'s and the bound, then the sums over
    a search step."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    emit({"phase": "f32_compare", "other": str(Path(other).resolve()), "nvidia_smi": nvidia_smi()})
    sides = _turns(other, "--f32-rows", lambda r: (r["site"], r["direction"]) if (
        r.get("kernel") == "pointwise_conv" and "ms" in r and "summary" not in r) else None)
    if sides is None:
        return 1
    sums = {"other_ms": 0.0, "this_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    for key, row in sides["this"][0].items():
        cmp_row = {"other_ms": _turn_mean(sides["other"], key, "ms"),
                   "this_ms": _turn_mean(sides["this"], key, "ms"),
                   "library_ms": _turn_mean(sides["this"], key, "library_ms"), "bound_ms": row["bound_ms"]}
        for k, v in cmp_row.items():
            sums[k] += row["launches_per_step"] * v
        sums["launches"] += row["launches_per_step"]
        emit({"phase": "f32_compare", "site": key[0], "direction": key[1], "shape": row["shape"],
              "launches_per_step": row["launches_per_step"], "plan": row["plan"], **cmp_row,
              "this_turns_ms": [r[key]["ms"] for r in sides["this"]]})
    emit({"phase": "f32_compare", "summary": "per search step", **sums})
    return 0


def _compare_rows(other: str, phase: str, child_flag: str, row_phase: str) -> int:
    """The rows a ``child_flag`` child prints as ``row_phase`` on the
    checkout in ``other`` and on this one, in turns (``_turns``): per row
    (kernel, site, batch) the mean device ms of each side's two turns,
    the library's (this side) and the bound, and whether every turn gave
    the plain version's bits; then the nine-site sums at batch 4."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    emit({"phase": phase, "other": str(Path(other).resolve()), "nvidia_smi": nvidia_smi()})
    sides = _turns(other, child_flag, lambda r: (r["kernel"], r["site"], r["shape"][0]) if (
        r.get("phase") == row_phase and "ms" in r) else None)
    if sides is None:
        return 1
    sums = {}
    for key, row in sides["this"][0].items():
        name, site, batch = key
        cmp_row = {"other_ms": _turn_mean(sides["other"], key, "ms"),
                   "this_ms": _turn_mean(sides["this"], key, "ms"),
                   "library_ms": row["library_ms"] and _turn_mean(sides["this"], key, "library_ms"),
                   "bound_ms": row["bound_ms"],
                   "equal_bits": all(r[key]["equal_bits"] for side in sides.values() for r in side)}
        if "events_ms" in row:  # the rows' second timer (pool_rows)
            cmp_row.update({
                "other_events_ms": _turn_mean(sides["other"], key, "events_ms"),
                "this_events_ms": _turn_mean(sides["this"], key, "events_ms"),
                "library_events_ms": row["library_events_ms"] and _turn_mean(sides["this"], key,
                                                                             "library_events_ms")})
        emit({"phase": phase, "kernel": name, "site": site, "shape": row["shape"], "cold": row["cold"],
              "plan": row["plan"], **cmp_row, "this_turns_ms": [r[key]["ms"] for r in sides["this"]],
              "other_turns_ms": [r[key]["ms"] for r in sides["other"]]})
        if batch == BATCH:
            sums.setdefault(name, []).append(cmp_row)
    for name, rows in sums.items():
        emit({"phase": phase, "kernel": name, "summary": f"nine sites, batch {BATCH}",
              **{k: _sum_or_null(r[k] for r in rows) for k in rows[0] if k.endswith("_ms")}})
    return 0


def argmax_compare(other: str) -> int:
    """``python3 chip_smoke.py --argmax-compare DIR``: the argmax pair's rows
    of ``phase_bf16_kernel_check`` (``argmax_rows``: the nine branch-3 sites
    at batch 4, Mixed_3b and Mixed_3c at 128) on the checkout in DIR and on
    this one (``_compare_rows``)."""
    return _compare_rows(other, "argmax_compare", "--argmax-rows", "argmax_rows")


def pool_compare(other: str) -> int:
    """``python3 chip_smoke.py --pool-compare DIR``: the ``maxpool3d_s1``
    pair's rows of ``phase_kernel_check`` and ``phase_bf16_kernel_check``
    (``pool_rows`` in float32 and bfloat16: the nine branch-3 sites at
    batch 4, Mixed_3b and Mixed_3c at 128) on the checkout in DIR and on
    this one (``_compare_rows``)."""
    return _compare_rows(other, "pool_compare", "--pool-rows", "pool_rows")


# (forward, backward) blocks an SM of the variant builds --pool-sweep times
POOL_SWEEP_CAPS = ((2, 3), (3, 3), (4, 3), (5, 3), (6, 3), (5, 2), (5, 4))
_POOL_CAPS_LINE = re.compile(r"constexpr int kFwdMinBlocks = \d+, kBwdMinBlocks = \d+;")


def _pool_cap_builds(pool) -> dict:
    """``csrc/maxpool3d.cu`` built once per cap pair of
    ``POOL_SWEEP_CAPS`` (its ``kFwdMinBlocks`` / ``kBwdMinBlocks`` line
    rewritten) into ``_build/``, all in parallel: {caps: (bound library,
    ptxas lines of each kernel: registers and spills)}."""
    import ctypes

    from ivf_tpu_torch.ops.kernels import build

    src = (build.CSRC_DIR / "maxpool3d.cu").read_text()
    if len(_POOL_CAPS_LINE.findall(src)) != 1:
        raise RuntimeError("csrc/maxpool3d.cu: no single kFwdMinBlocks / kBwdMinBlocks line to rewrite")
    build.BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for fwd, bwd in POOL_SWEEP_CAPS:
        stem = build.BUILD_DIR / f"maxpool3d_caps{fwd}{bwd}"
        Path(f"{stem}.cu").write_text(_POOL_CAPS_LINE.sub(
            f"constexpr int kFwdMinBlocks = {fwd}, kBwdMinBlocks = {bwd};", src))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR), "-o", f"{stem}.so", f"{stem}.cu"]
        procs[(fwd, bwd)] = (stem, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                    text=True))
    libs = {}
    for caps, (stem, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {stem}.cu:\n{out}")
        ptxas, kernel = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '\w*?(pool_(?:fwd|bwd)I\w+?)E", line)
            if m:
                kernel = m[1]
            elif kernel and ("registers" in line or "spill" in line):
                ptxas.setdefault(kernel, []).append(line.split(":", 1)[-1].strip())
        libs[caps] = (pool.bind(ctypes.CDLL(f"{stem}.so")), ptxas)
    return libs


def pool_sweep() -> int:
    """``python3 chip_smoke.py --pool-sweep``: the ``maxpool3d_s1`` pair in
    both dtypes, launched directly: under every candidate tile on the
    checkout's build at Mixed_3b, 4b, 4c and 5b at batch ``BATCH`` (warm)
    and Mixed_3b at 128 clips (cold), and under each register cap of
    ``POOL_SWEEP_CAPS`` (variant builds, ``_pool_cap_builds``) with the
    planned tile at Mixed_3b at 4 and 128 clips and Mixed_4c at 4. Device
    ms per call (the larger of two readings) and equal bits to the plain
    version for every tile and build. Candidate tiles: the plan, and
    chunks of 1, 2, 3, 4, 6 or 8 vectors that divide C, each with the
    ``argmax_pool.best_tile`` of 224, 112 or 64 positions over the chunk.
    The data behind ``maxpool3d.plan`` and the caps of
    ``csrc/maxpool3d.cu`` (~1 min)."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ivf_tpu_torch.ops.kernels import argmax_pool as ap, maxpool3d as pool

    dev, failures = torch.device("cuda"), []
    gen = torch.Generator().manual_seed(14)
    emit({"phase": "pool_sweep", "nvidia_smi": nvidia_smi()})
    builds = _pool_cap_builds(pool)
    for caps, (_, ptxas) in builds.items():
        emit({"phase": "pool_sweep", "caps": list(caps), "ptxas": ptxas})
    site_shapes = {site: shape for site, shape, _ in FUSED_SITES}
    cases = [(site, BATCH, False) for site in ("Mixed_3b", "Mixed_4b", "Mixed_4c", "Mixed_5b")]
    cases.append(("Mixed_3b", BIG_BATCH, True))
    for site, batch, cold in cases:
        t, h, w_, cin = site_shapes[site]
        shape = (batch, t, h, w_, cin)
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            dt, iview = ("bf16", torch.int16) if bf16 else ("f32", torch.int32)
            x = _ties(shape, gen, dev).to(dtype)
            g = torch.randn(shape, generator=gen).to(dtype).to(dev)
            y_ref = pool.maxpool3d_s1_fwd_plain(x)
            dx_ref = (pool.maxpool3d_s1_bwd_bf16_plain if bf16 else pool.maxpool3d_s1_bwd_plain)(x, y_ref, g)
            y, dx = torch.empty_like(x), torch.empty_like(x)
            stream = torch.cuda.current_stream().cuda_stream

            def timed(lib, tile, label):
                def fwd():
                    if getattr(lib, f"maxpool3d_s1_fwd_{dt}")(x.data_ptr(), y.data_ptr(), *shape, *tile, stream):
                        raise RuntimeError(f"maxpool3d_s1_fwd_{dt} refused {tile}")

                def bwd():
                    if getattr(lib, f"maxpool3d_s1_bwd_{dt}")(x.data_ptr(), y_ref.data_ptr(), g.data_ptr(),
                                                              dx.data_ptr(), *shape, *tile, stream):
                        raise RuntimeError(f"maxpool3d_s1_bwd_{dt} refused {tile}")

                fwd()
                bwd()
                torch.cuda.synchronize()
                bits = bool(torch.equal(y.view(iview), y_ref.view(iview))) and bool(
                    torch.equal(dx.view(iview), dx_ref.view(iview)))
                if not bits:
                    failures.append(f"{label}: not bit-equal to the plain version")
                return {"fwd_ms": _ms2(fwd, cold, failures, label), "bwd_ms": _ms2(bwd, cold, failures, label),
                        "equal_bits": bits}

            planned = pool.plan(h, w_, cin, bf16)
            nv = cin // planned.vw
            tiles = {planned}
            for v in (1, 2, 3, 4, 6, 8):
                if nv % v == 0:
                    tiles |= {ap.tile_plan(planned.vw, v, *ap.best_tile(h, w_, v, p // v))
                              for p in (224, 112, 64) if p >= v}
            rows = {tile: {"plan": list(tile), **timed(pool._lib(), tile, f"{site} b{batch} {dt} {tile}")}
                    for tile in sorted(tiles)}
            for tile, row in rows.items():
                emit({"phase": "pool_sweep", "site": site, "batch": batch, "dtype": dt, "planned": tile == planned,
                      **row})
            emit({"phase": "pool_sweep", "site": site, "batch": batch, "dtype": dt, "summary": "tiles",
                  "planned": rows[planned],
                  **{f"best_{d}": min(rows.values(), key=lambda r, d=d: r[f"{d}_ms"]) for d in ("fwd", "bwd")}})
            if site in ("Mixed_3b", "Mixed_4c"):
                for caps, (lib, _) in builds.items():
                    emit({"phase": "pool_sweep", "site": site, "batch": batch, "dtype": dt, "caps": list(caps),
                          "plan": list(planned), **timed(lib, planned, f"{site} b{batch} {dt} caps {caps}")})
            del x, g, y_ref, dx_ref, y, dx
    for f in failures:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def _rows_child(root: str, module: str, phase: str, rows) -> int:
    """A child of ``_compare_rows``: builds ``csrc/<module>.cu`` of the
    checkout at ``root``, imports its ``ivf_tpu_torch.ops.kernels.<module>``
    and prints as ``phase`` every row of the case dicts that
    ``rows(kernels, failures)`` yields."""
    import importlib

    sys.path.insert(0, str(Path(root).resolve()))
    from ivf_tpu_torch.ops.kernels import build

    build.build([module])
    kernels = importlib.import_module(f"ivf_tpu_torch.ops.kernels.{module}")
    failures: list = []
    for cases in rows(kernels, failures):
        for name, case_rows in cases.items():
            for row in case_rows:
                emit({"phase": phase, "kernel": name, **row})
    for f in failures:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


def f32_rows(root: str) -> int:
    """The child of ``f32_compare``: ``phase_kernel_check`` on the
    ``ivf_tpu_torch`` of the checkout at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    from ivf_tpu_torch.ops.kernels import build, maxpool3d as pool, pointwise_conv as pw

    build.build(["pointwise_conv", "maxpool3d"])
    if not hasattr(pw, "f32_plan"):  # a checkout from before the float32 planner
        pw.f32_plan = lambda *args, **kwargs: None
    failures: list = []
    phase_kernel_check(pw, pool, failures)
    return 1 if failures else 0


def fused_sweep() -> int:
    """``python3 chip_smoke.py --fused-sweep``: the fused branch-3 kernels
    at every distinct branch-3 shape of the main path (batch 4, ReLU on),
    in both dtypes, under every plan the launches choose from
    (``fused_branch3.candidates``, forced through
    ``fused_branch3_force_plan``): device ms, and the error against the
    plain version (float32: also equal bits to the default plan, since
    every plan adds each output's terms in one order). The whole-sample
    entries are swept, and the per-frame backward for plans of 1 frame (a
    per-frame forward is the forward with boxes of 1 frame). The data
    behind the cost constants of ``csrc/fused_branch3.cu``."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ivf_tpu_torch.ops.kernels import fused_branch3 as fb

    lib, dev, bad, samples = fb._lib(), torch.device("cuda"), [], []
    gen = torch.Generator().manual_seed(21)
    emit({"phase": "fused_sweep", "nvidia_smi": nvidia_smi()})
    shapes = list(dict.fromkeys((shape, cout) for _, shape, cout in FUSED_SITES))
    for (t, h, w, cin), cout in shapes:
        shape = (BATCH, t, h, w, cin)
        for dtype in (torch.float32, torch.bfloat16):
            sfx = "" if dtype == torch.float32 else "_bf16"
            fwd = getattr(fb, f"fused_pool_conv_tblock_fwd{sfx}_cuda")
            bwd = getattr(fb, f"fused_pool_conv_tblock_bwd{sfx}_cuda")
            bwd_frame = getattr(fb, f"fused_pool_conv_bwd{sfx}_cuda")  # the instance of 1 frame
            x = _ties(shape, gen, dev).to(dtype)
            wt = (torch.randn(cin, cout, generator=gen) / cin**0.5).to(dtype).to(dev)
            b = (torch.randn(cout, generator=gen) * 0.1).to(dtype).to(dev)
            g = torch.randn(*shape[:-1], cout, generator=gen).to(dtype).to(dev)
            y0 = fwd(x, wt, b, True)
            dx0 = bwd(x, y0, g, wt, True)
            y_ref = fb.fused_pool_conv_plain(x, wt, b, True).float()
            dx_ref = fb.fused_pool_conv_bwd_plain(x, y0, g, wt, True).float()
            rel = 1e-5 if dtype == torch.float32 else 2.0**-7
            tol = {"fwd": rel * y_ref.abs().max().item(), "bwd": rel * max(1.0, dx_ref.abs().max().item())}
            runs = {
                "fwd": [((inst, box, (0, 0, 0)), lambda: fwd(x, wt, b, True), y0, y_ref)
                        for inst, box in fb.candidates(dtype, "fwd", shape, cout)],
                "bwd": [((-1, (0, 0, 0), (*tile, chunk)),
                         lambda fn=bwd_frame if chunk == 1 else bwd: fn(x, y0, g, wt, True), dx0, dx_ref)
                        for tile, chunk in fb.candidates(dtype, "bwd", shape, cout)],
            }
            entries = {k: (getattr(fb, f"fused_pool_conv_{v}fwd{sfx}_cuda"), getattr(fb, f"fused_pool_conv_{v}bwd{sfx}_cuda"))
                       for k, v in (("frame", ""), ("tblock", "tblock_"))}
            default_ms = {k: {"fwd": device_ms(lambda: f(x, wt, b, True), reps=10),
                              "bwd": device_ms(lambda: bw_(x, y0, g, wt, True), reps=10)}
                          for k, (f, bw_) in entries.items()}
            for d, cands in runs.items():
                rows = []
                for (inst, box, bplan), fn, default_out, ref in cands:
                    lib.fused_branch3_force_plan(inst, *box, *bplan)
                    try:
                        out = fn()
                        torch.cuda.synchronize()
                        # the profiler now and then drops a kernel's events: the larger of two
                        ms = max(device_ms(fn, reps=10), device_ms(fn, reps=10))
                    except RuntimeError as exc:
                        rows.append({"plan": [inst, *box] if d == "fwd" else list(bplan), "refused": str(exc)})
                        continue
                    finally:
                        lib.fused_branch3_force_plan(-1, 0, 0, 0, 0, 0, 0)
                    err = (out.float() - ref).abs().max().item()
                    same = bool(torch.equal(out, default_out))
                    rows.append({"plan": [inst, *box] if d == "fwd" else list(bplan), "ms": ms, "err": err,
                                 "bits_equal_default": same})
                    plan = (inst, tuple(box)) if d == "fwd" else (tuple(bplan[:2]), bplan[2])
                    samples.append((d, dtype, shape, cout, plan, ms))
                    if not err <= tol[d] or (dtype == torch.float32 and not same):
                        bad.append(f"{shape} {cout} {dtype} {d} plan {rows[-1]['plan']}: err {err}, bits {same}")
                timed = sorted((r for r in rows if "ms" in r), key=lambda r: r["ms"])
                frame = [r for r in timed if (r["plan"][1] if d == "fwd" else r["plan"][2]) == 1]
                emit({"phase": "fused_sweep", "shape": list(shape), "cout": cout, "dtype": str(dtype),
                      "direction": d, "default": {k: fb.plan(dtype, k == "tblock", shape, cout)[d]
                                                  for k in ("frame", "tblock")},
                      "default_ms": {k: v[d] for k, v in default_ms.items()},
                      "best": timed[0] if timed else None, "best_frame": frame[0] if frame else None,
                      "rows": rows})
    _fit_fused_costs(fb, samples)
    for f in bad:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if bad else 0


def _fit_fused_costs(fb, samples) -> None:
    """The constants of the fused branch 3's cost models (``kFwdCost*``,
    ``kBwdCost*`` in ``csrc/fused_branch3.cu``): per direction and dtype, a
    non-negative least-squares fit of the swept times (microseconds) on the
    planner's cost terms, weighted to relative error; and, per shape and
    instance (per-frame: the plans of 1 frame), the time of the plan the
    fitted model picks over the fastest swept plan's."""
    import numpy as np
    from scipy.optimize import nnls

    for d in ("fwd", "bwd"):
        for dtype in (torch.float32, torch.bfloat16):
            rows = [(shape, cout, plan, ms) for d_, dt, shape, cout, plan, ms in samples
                    if d_ == d and dt == dtype and ms > 0]
            terms = [fb.cost_terms(dtype, d, shape, cout, plan) for shape, cout, plan, _ in rows]
            keep = [(r, t) for r, t in zip(rows, terms) if t]
            if not keep:
                continue
            x = np.array([t for _, t in keep])
            y = np.array([r[3] * 1e3 for r, _ in keep])
            coef, _ = nnls(x / y[:, None], np.ones_like(y))
            picks = {}
            for (shape, cout, plan, ms), pred in zip([r for r, _ in keep], x @ coef):
                one = (plan[1][0] if d == "fwd" else plan[1]) == 1
                for inst in ("frame", "tblock") if one else ("tblock",):
                    picks.setdefault((tuple(shape), cout, inst), []).append((pred, ms))
            ratios = {f"{k[0][1:]} {k[2]}": min(v)[1] / min(ms for _, ms in v) for k, v in picks.items()}
            emit({"phase": "fused_fit", "direction": d, "dtype": str(dtype), "samples": len(keep),
                  "coef": coef.tolist(), "pick_over_best": ratios,
                  "pick_over_best_mean": sum(ratios.values()) / len(ratios)})


def phase_bf16_kernel_check(pw, pool, ap, failures) -> dict:
    """The bfloat16 kernels against their plain versions on the card: the
    GEMM at every 1x1x1 conv of the I3D main path, forward (W the layers'
    column-major view of the (Cout, Cin) weight, bias, ReLU) and dx (its
    transpose, row-major), within one bf16 ulp of the largest output, with
    the sum over a search step's 40 launches and the host time per call;
    the bf16 pool pair (``pool_rows``) and the argmax pair
    (``argmax_rows``) at all nine branch-3 sites and at Mixed_3b and
    Mixed_3c at 128 clips, cold, with equal bits and nine-site sums.
    Device time per call (inputs warm in L2), the plain
    version's, one PyTorch call's in bfloat16 (``torch.matmul``,
    ``F.max_pool3d``; none for the two backwards), and the bound: bytes at
    3.35 TB/s against bf16 operations at 989 TFLOP/s."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(10)
    cases = {n: [] for n in BF16_COUNTERS}
    step = {"ms": 0.0, "library_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "launches": 0}
    for site, n, cin, cout, per_step in pw_main_path():
        wk = (torch.randn(cout, cin, generator=gen) / cin**0.5).bfloat16().to(dev)
        bias = torch.randn(cout, generator=gen).bfloat16().to(dev)
        relu = site != "logits"
        for direction in ("fwd", "dx"):
            if direction == "fwd":
                x, w, b, act, k, c = _ties((n, cin), gen, dev).bfloat16(), wk.t(), bias, relu, cin, cout
            else:  # m @ W^T: the forward's column-major view transposed is row-major
                x, w, b, act, k, c = torch.randn(n, cout, generator=gen).bfloat16().to(dev), wk, None, False, cout, cin
            y = pw.pointwise_conv_bf16_cuda(x, w, b, act)
            ref = pw.pointwise_conv_plain(x, w, b, act)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2.0**-7 * ref.float().abs().max().item()
            bms, by = bound(2 * (n * k + k * c + (c if b is not None else 0) + n * c), 2 * n * k * c,
                            PEAK_BF16_FLOPS)
            plan = pw.bf16_plan(n, k, c, x.stride(), x.data_ptr(), w.stride(), w.data_ptr())
            row = {
                "site": site, "direction": direction, "shape": [n, k, c], "relu": act, "path": plan["path"],
                "bn": plan.get("bn"),
                "max_abs_err": err, "tol": tol,
                "tol_reason": "one bf16 ulp of the largest output: float32 sums in another order, one rounding",
                "ms": device_ms(lambda: pw.pointwise_conv_bf16_cuda(x, w, b, act)),
                "plain_ms": device_ms(lambda: pw.pointwise_conv_plain(x, w, b, act), reps=3),
                "library_ms": device_ms(lambda: torch.matmul(x, w)), "bound_ms": bms, "bound_by": by,
                "launches_per_step": per_step,
            }
            cases["pointwise_conv_bf16"].append(row)
            for key in ("ms", "library_ms", "plain_ms", "bound_ms"):
                step[key] += per_step * row[key]
            step["launches"] += per_step
            if not err <= tol:
                failures.append(f"pointwise_conv_bf16 {site} {direction}: err {err} > {tol}")
    step["host_us_per_call"] = {
        "Mixed_3b_trio": host_us_per_call(pw, BATCH * 8 * 28 * 28, 192, 176, True),
        "logits": host_us_per_call(pw, BATCH, 1024, 174, False),
        "Mixed_3b_trio_with_w_copy": host_us_per_call(pw, BATCH * 8 * 28 * 28, 192, 176, True, copy_w=True),
    }
    emit({"phase": "bf16_kernel_check", "kernel": "pointwise_conv_bf16", "summary": "per search step",
          "batch": BATCH, **step})
    cases.update(pool_rows(pool, failures, torch.bfloat16))
    cases.update(argmax_rows(ap, failures))
    for name, rows in cases.items():
        for row in rows:
            emit({"phase": "bf16_kernel_check", "kernel": name, **row})
    _nine_site_sums("bf16_kernel_check", cases, ("maxpool3d_s1_fwd_bf16", "maxpool3d_s1_bwd_bf16",
                                                  "argmax_pool_fwd", "argmax_pool_bwd"))
    return cases


def _nine_site_sums(phase: str, cases: dict, names) -> None:
    """One summary line per kernel: its rows at batch ``BATCH`` (the nine
    branch-3 sites) summed; ``library_ms`` null where a row has none."""
    for name in names:
        rows = [r for r in cases[name] if r["shape"][0] == BATCH]
        emit({"phase": phase, "kernel": name, "summary": f"nine sites, batch {BATCH}",
              **{k: _sum_or_null(r[k] for r in rows) for k in rows[0] if k == "ms" or k.endswith("_ms")}})


# the pool pairs' rows (argmax, maxpool3d) at bench.py's 128 clips (inputs
# cold, from HBM)
BIG_BATCH = 128
BIG_SITES = (("Mixed_3b", (8, 28, 28, 192)), ("Mixed_3c", (8, 28, 28, 256)))


def _ms2(fn, cold, failures, label):
    """The larger of two ``device_ms`` readings (the profiler now and then
    drops a kernel's events); a reading of 0 fails."""
    ms = max(device_ms(fn, cold=cold) for _ in range(2))
    if ms <= 0:
        failures.append(f"{label}: the profiler recorded no kernel time")
    return ms


def _sum_or_null(values):
    """The sum of readings, or None where any reading is None (nothing to
    time)."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def argmax_rows(ap, failures) -> dict:
    """The argmax pair against its plain versions on the card: at all nine
    branch-3 sites at batch ``BATCH`` (inputs warm in L2) and at Mixed_3b
    and Mixed_3c at 128 clips (cold: a 256 MB overwrite before each call).
    Equal bits (y and the index plane; dx), device ms per call, the plain
    version's, ``F.max_pool3d``'s in bfloat16 for the forward (none for the
    backward) and the bound: 5 bytes per element each way at 3.35 TB/s.
    The kernel's and the library's ms are the larger of two readings (the
    profiler now and then drops a kernel's events); a reading of 0 fails."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(11)
    cases = {"argmax_pool_fwd": [], "argmax_pool_bwd": []}
    sites = [(site, BATCH, shape, False) for site, shape, _ in FUSED_SITES]
    sites += [(site, BIG_BATCH, shape, True) for site, shape in BIG_SITES]
    for site, batch, (t, h, w_, cin), cold in sites:
        shape = (batch, t, h, w_, cin)
        x, g = _bf16_site_inputs(shape, gen, dev)
        numel = x.numel()
        ya, idx = ap.argmax_pool_fwd_cuda(x)
        dxa = ap.argmax_pool_bwd_cuda(idx, g)
        ya_ref, idx_ref = ap.argmax_pool_fwd_plain(x)
        dx_ref = ap.argmax_pool_bwd_plain(idx_ref, g)
        torch.cuda.synchronize()
        xc = x.permute(0, 4, 1, 2, 3)
        plan = list(ap.plan(h, w_, cin)) if hasattr(ap, "plan") else None
        checks = (
            ("argmax_pool_fwd", (ya, ya_ref), torch.equal(idx, idx_ref), lambda: ap.argmax_pool_fwd_cuda(x),
             lambda: ap.argmax_pool_fwd_plain(x), lambda: F.max_pool3d(xc, 3, 1, 1)),
            ("argmax_pool_bwd", (dxa, dx_ref), True, lambda: ap.argmax_pool_bwd_cuda(idx, g),
             lambda: ap.argmax_pool_bwd_plain(idx_ref, g), None),
        )
        for name, (got, want), extra_equal, fn, plain, lib in checks:
            bits = bool(torch.equal(got.view(torch.int16), want.view(torch.int16))) and bool(extra_equal)
            bms, by = bound(5 * numel, 27 * 3 * numel, PEAK_BF16_FLOPS)
            cases[name].append({
                "site": site, "shape": list(shape), "cold": cold, "plan": plan, "equal_bits": bits,
                "max_abs_err": (got.float() - want.float()).abs().max().item(), "tol": 0.0,
                "ms": _ms2(fn, cold, failures, name), "plain_ms": device_ms(plain, reps=3),
                "library_ms": _ms2(lib, cold, failures, name) if lib is not None else None,
                "bound_ms": bms, "bound_by": by,
            })
            if not bits:
                failures.append(f"{name} {site} batch {batch}: not bit-equal to the plain version")
        del x, g, ya, idx, dxa, ya_ref, idx_ref, dx_ref, xc
    return cases


def pool_rows(pool, failures, dtype) -> dict:
    """The ``maxpool3d_s1`` pair in ``dtype`` against its plain versions on
    the card: at all nine branch-3 sites at batch ``BATCH`` (inputs warm in
    L2) and at Mixed_3b and Mixed_3c at 128 clips (cold: a 256 MB overwrite
    before each call). Equal bits (y and dx as int views), device ms per
    call, the plain version's, ``F.max_pool3d``'s in ``dtype`` for the
    forward (none for the every-tie backward), the plan, and the bound:
    2 (forward) or 4 (backward) tensors of ``dtype`` at 3.35 TB/s against
    26 compares or 27 compares and adds an element. The kernel's and the
    library's ms are the larger of two readings (the profiler now and then
    drops a kernel's events); a reading of 0 fails. ``events_ms`` and
    ``library_events_ms``: the same calls under ``cuda_ms`` (CUDA events
    around 20 back-to-back calls, the host's dispatch gaps included), the
    timer of these rows before the staged kernels; at 128 clips the
    inputs (0.3-0.8 GB) do not fit in L2 without an overwrite."""
    import torch.nn.functional as F

    bf16 = dtype == torch.bfloat16
    sfx, es, iview = ("_bf16", 2, torch.int16) if bf16 else ("", 4, torch.int32)
    peak = PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS
    fwd, bwd = getattr(pool, f"maxpool3d_s1_fwd{sfx}_cuda"), getattr(pool, f"maxpool3d_s1_bwd{sfx}_cuda")
    plain_bwd = pool.maxpool3d_s1_bwd_bf16_plain if bf16 else pool.maxpool3d_s1_bwd_plain
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(12)
    cases = {f"maxpool3d_s1_fwd{sfx}": [], f"maxpool3d_s1_bwd{sfx}": []}
    sites = [(site, BATCH, shape, False) for site, shape, _ in FUSED_SITES]
    sites += [(site, BIG_BATCH, shape, True) for site, shape in BIG_SITES]
    for site, batch, (t, h, w_, cin), cold in sites:
        shape = (batch, t, h, w_, cin)
        x = _ties(shape, gen, dev).to(dtype)
        g = torch.randn(shape, generator=gen).to(dtype).to(dev)
        numel = x.numel()
        y = fwd(x)
        dx = bwd(x, y, g)
        y_ref = pool.maxpool3d_s1_fwd_plain(x)
        dx_ref = plain_bwd(x, y_ref, g)
        torch.cuda.synchronize()
        xc = x.permute(0, 4, 1, 2, 3)
        # a checkout from before the staged kernels has no plan (--pool-compare
        # against it); the shim goes when no such comparison is wanted
        plan = list(pool.plan(h, w_, cin, bf16)) if hasattr(pool, "plan") else None
        checks = (
            (f"maxpool3d_s1_fwd{sfx}", (y, y_ref), lambda: fwd(x), lambda: pool.maxpool3d_s1_fwd_plain(x),
             lambda: F.max_pool3d(xc, 3, 1, 1), 2 * es * numel, 26 * numel),
            (f"maxpool3d_s1_bwd{sfx}", (dx, dx_ref), lambda: bwd(x, y, g), lambda: plain_bwd(x, y, g), None,
             4 * es * numel, 54 * numel),
        )
        for name, (got, want), fn, plain, lib, nbytes, ops in checks:
            bits = bool(torch.equal(got.view(iview), want.view(iview)))
            bms, by = bound(nbytes, ops, peak)
            cases[name].append({
                "site": site, "shape": list(shape), "cold": cold, "plan": plan, "equal_bits": bits,
                "max_abs_err": (got.float() - want.float()).abs().max().item(), "tol": 0.0,
                "ms": _ms2(fn, cold, failures, name), "plain_ms": device_ms(plain, reps=3),
                "library_ms": _ms2(lib, cold, failures, name) if lib is not None else None,
                "events_ms": cuda_ms(fn), "library_events_ms": cuda_ms(lib) if lib is not None else None,
                "bound_ms": bms, "bound_by": by,
            })
            if not bits:
                failures.append(f"{name} {site} batch {batch}: not bit-equal to the plain version")
        del x, g, y, dx, y_ref, dx_ref, xc
    return cases


def phase_bf16_fused_gate_check(fb, gates, pool, pw, failures) -> dict:
    """The bfloat16 entries of the fused branch 3 and of the gate block
    against their plain versions on the card.

    Fused branch 3: all four entries at the nine branch-3 sites (batch 4),
    post-ReLU tie data with the ReLU, signed data without; y and dx within
    one bf16 ulp of their largest magnitude (float32 sums in another order
    than the plain matmul, one rounding each); per-frame against
    whole-sample. With the ReLU also the device time of each entry (warm
    and flushed), of its plain version, of the bf16 unfused kernel pair
    (``maxpool3d_s1`` + ``pointwise_conv`` bf16 entries) and, forward, of
    ``F.max_pool3d`` + ``torch.matmul`` in bf16 (the library yardstick;
    the backward has none).

    Gates: bf16 gates and a float32 state at both layers of the clstm_kth
    main path (batch 16), the merged route and a ragged size; h', c' and
    dc within 1e-6 of max(1, their largest magnitude), dz within one bf16
    ulp of its largest (the kernels repeat the plain versions' roundings
    and float32 operations); timed beside the float32 gate kernel on the
    same values in float32. No PyTorch call takes bf16 gates with a
    float32 state, so ``library_ms`` is null.

    Bounds: bytes at 3.35 TB/s against bf16 operations at 989 TFLOP/s."""
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(13)
    kernels = {
        "fused_pool_conv": (fb.fused_pool_conv_fwd_bf16_cuda, fb.fused_pool_conv_bwd_bf16_cuda),
        "fused_pool_conv_tblock": (fb.fused_pool_conv_tblock_fwd_bf16_cuda,
                                   fb.fused_pool_conv_tblock_bwd_bf16_cuda),
    }
    cases = {f"{k}_{d}_bf16": [] for k in kernels for d in ("fwd", "bwd")}
    cases.update({n: [] for n in BF16_GATE_COUNTERS})

    def err(a, b_):
        return (a.float() - b_.float()).abs().max().item()

    def ulp_tol(ref):
        return 2.0**-7 * ref.float().abs().max().item()

    for site, (t, h, w, cin), cout in FUSED_SITES:
        shape = (BATCH, t, h, w, cin)
        n, numel, ynumel = BATCH * t * h * w, BATCH * t * h * w * cin, BATCH * t * h * w * cout
        fwd_bound = bound(2 * (numel + cin * cout + cout + ynumel),
                          2 * n * cin * cout + 26 * numel + 2 * ynumel, PEAK_BF16_FLOPS)
        bwd_bound = bound(2 * (2 * numel + 2 * ynumel + cin * cout),
                          2 * n * cout * cin + ynumel + 80 * numel, PEAK_BF16_FLOPS)
        for relu in (True, False):
            x = _ties(shape, gen, dev) if relu else torch.randn(shape, generator=gen).to(dev)
            x = x.bfloat16()
            wt = (torch.randn(cin, cout, generator=gen) / cin**0.5).bfloat16().to(dev)
            b = (torch.randn(cout, generator=gen) * 0.1).bfloat16().to(dev)
            g = torch.randn(*shape[:-1], cout, generator=gen).bfloat16().to(dev)
            outs = {name: None for name in kernels}
            for name, (fwd, bwd) in kernels.items():
                y = fwd(x, wt, b, relu)
                outs[name] = (y, bwd(x, y, g, wt, relu))
            y_ref = fb.fused_pool_conv_plain(x, wt, b, relu)
            torch.cuda.synchronize()
            (yf, dxf), (yt, dxt) = outs["fused_pool_conv"], outs["fused_pool_conv_tblock"]
            between = {"fwd_err": err(yf, yt), "bwd_err": err(dxf, dxt),
                       "bits_equal": bool(torch.equal(yf.view(torch.int16), yt.view(torch.int16))
                                          and torch.equal(dxf.view(torch.int16), dxt.view(torch.int16)))}
            if relu:
                xc = x.permute(0, 4, 1, 2, 3)
                pooled = pool.maxpool3d_s1_fwd_bf16_cuda(x)
                wT = wt.t().contiguous()
                y_pair = pw.pointwise_conv_bf16_cuda(pooled.view(n, cin), wt, b, True)

                def pair_fwd():
                    pw.pointwise_conv_bf16_cuda(pool.maxpool3d_s1_fwd_bf16_cuda(x).view(n, cin), wt, b, True)

                def pair_bwd():
                    m = torch.where(y_pair > 0, g.view(n, cout), 0.0)
                    gc = pw.pointwise_conv_bf16_cuda(m, wT, None, False)
                    pool.maxpool3d_s1_bwd_bf16_cuda(x, pooled, gc.view(shape))

                def lib_fwd():
                    torch.matmul(F.max_pool3d(xc, 3, 1, 1).permute(0, 2, 3, 4, 1).reshape(n, cin), wt)

                shared = {
                    "fwd": {"pair_ms": device_ms(pair_fwd), "library_ms": device_ms(lib_fwd),
                            "plain_ms": device_ms(lambda: fb.fused_pool_conv_plain(x, wt, b, True), reps=5)},
                    "bwd": {"pair_ms": device_ms(pair_bwd), "library_ms": None,
                            "plain_ms": device_ms(lambda: fb.fused_pool_conv_bwd_plain(x, yf, g, wt, True),
                                                  reps=5)},
                }
            for name, (fwd, bwd) in kernels.items():
                y, dx = outs[name]
                dx_ref = fb.fused_pool_conv_bwd_plain(x, y, g, wt, relu)
                torch.cuda.synchronize()
                rows = {
                    "fwd": {"max_abs_err": err(y, y_ref), "tol": ulp_tol(y_ref), "bound": fwd_bound},
                    "bwd": {"max_abs_err": err(dx, dx_ref), "tol": ulp_tol(dx_ref), "bound": bwd_bound},
                }
                if relu:
                    timed = {"fwd": lambda: fwd(x, wt, b, True), "bwd": lambda: bwd(x, y, g, wt, True)}
                    for d, fn in timed.items():
                        rows[d].update({"ms": device_ms(fn), "cold_ms": device_ms(fn, cold=True), **shared[d]})
                for d, row in rows.items():
                    bms, by = row.pop("bound")
                    cases[f"{name}_{d}_bf16"].append({
                        "site": site, "shape": list(shape), "cout": cout, "relu": relu, **row,
                        "tol_reason": "one bf16 ulp of the largest magnitude",
                        "bound_ms": bms, "bound_by": by, "frame_vs_tblock": between,
                        "plan": fb.plan(torch.bfloat16, name.endswith("tblock"), shape, cout)[d],
                    })
                    if not row["max_abs_err"] <= row["tol"]:
                        failures.append(f"{name}_{d}_bf16 {site} relu={relu}: err {row['max_abs_err']} > {row['tol']}")
            if not (between["fwd_err"] <= ulp_tol(yf) and between["bwd_err"] <= ulp_tol(dxf)):
                failures.append(f"bf16 fused per-frame vs tblock {site} relu={relu}: {between}")

    b_, (h1, w1) = CLSTM_BATCH, (CLSTM_HW[0] // 2, CLSTM_HW[1] // 2)
    for site, lead, ch, with_gh in (("layer1", (b_, h1, w1), 4, True), ("layer2", (b_, h1 // 4, w1 // 4), 4, True),
                                    ("layer1_merged", (b_, h1, w1), 4, False), ("ragged", (3, 7, 9), 5, True)):
        gx = (torch.randn(*lead, 4 * ch, generator=gen) * 3).bfloat16().to(dev)
        gh = (torch.randn(*lead, 4 * ch, generator=gen) * 2).bfloat16().to(dev) if with_gh else None
        c, dh, dc_out = (torch.randn(*lead, ch, generator=gen).to(dev) for _ in range(3))
        h_new, c_new = gates.lstm_gates_fwd_bf16_cuda(gx, gh, c)
        dz, dc = gates.lstm_gates_bwd_bf16_cuda(gx, gh, c, dh, dc_out)
        h_ref, c_ref = gates.gate_math_plain(gx, gh, c)
        dz_ref, dc_ref = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
        torch.cuda.synchronize()

        def rel_tol(ref):
            return 1e-6 * max(1.0, ref.abs().max().item())

        errs = {
            "lstm_gates_fwd_bf16": {"h": (err(h_new, h_ref), rel_tol(h_ref)), "c": (err(c_new, c_ref), rel_tol(c_ref))},
            "lstm_gates_bwd_bf16": {"dz": (err(dz, dz_ref), ulp_tol(dz_ref)), "dc": (err(dc, dc_ref), rel_tol(dc_ref))},
        }
        gxf, ghf = gx.float(), (gh.float() if with_gh else None)
        numel = c.numel()
        z_in = gx.numel() * (2 if with_gh else 1)
        timed = {
            "lstm_gates_fwd_bf16": (lambda: gates.lstm_gates_fwd_bf16_cuda(gx, gh, c),
                                    lambda: gates.gate_math_plain(gx, gh, c),
                                    lambda: gates.lstm_gates_fwd_cuda(gxf, ghf, c),
                                    2 * z_in + 12 * numel, GATE_OPS_FWD * numel),
            "lstm_gates_bwd_bf16": (lambda: gates.lstm_gates_bwd_bf16_cuda(gx, gh, c, dh, dc_out),
                                    lambda: gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out),
                                    lambda: gates.lstm_gates_bwd_cuda(gxf, ghf, c, dh, dc_out),
                                    2 * (z_in + gx.numel()) + 16 * numel, GATE_OPS_BWD * numel),
        }
        for name, (fn, plain, f32_fn, nbytes, ops) in timed.items():
            bms, by = bound(nbytes, ops, PEAK_BF16_FLOPS)
            cases[name].append({
                "site": site, "shape": [*lead, 4 * ch], "gates_h": with_gh,
                "max_abs_err": max(e for e, _ in errs[name].values()),
                "errs": {k: {"err": e, "tol": tl} for k, (e, tl) in errs[name].items()},
                "tol_reason": "float32 outputs 1e-6 of max(1, largest); dz one bf16 ulp of its largest",
                "ms": device_ms(fn), "plain_ms": device_ms(plain), "library_ms": None,
                "library_note": "no PyTorch call takes bf16 gates with a float32 state",
                "f32_kernel_ms": device_ms(f32_fn), "cold_ms": device_ms(fn, cold=True),
                "bound_ms": bms, "bound_by": by,
            })
            for k, (e, tl) in errs[name].items():
                if not e <= tl:
                    failures.append(f"{name} {site}: {k} err {e} > {tl}")
    for name, rows_ in cases.items():
        for row in rows_:
            emit({"phase": "bf16_kernel_check", "kernel": name, **row})
    _fused_summary("bf16_kernel_check", cases)
    return cases


BF16_ROUTES = {"bf16_default": {"compute_dtype": "bfloat16"},
               "bf16_kernels": {"compute_dtype": "bfloat16", "use_pallas": True, "pallas_pool": True},
               "bf16_fused": {"compute_dtype": "bfloat16", "use_pallas": True, "fuse_pool_conv": True},
               "bf16_fused_tblock": {"compute_dtype": "bfloat16", "use_pallas": True,
                                     "fuse_pool_conv": "tblock"}}
# the kernels each bf16 route must launch (and no other)
BF16_ROUTE_KERNELS = {
    "bf16_default": ARGMAX_COUNTERS,
    "bf16_kernels": BF16_KERNEL_COUNTERS,
    **{route: (*names, "pointwise_conv_bf16") for route, names in BF16_FUSED_COUNTERS.items()},
}


def _bf16_vs(a: dict, b: dict) -> dict:
    """bfloat16 against float32 (or another bf16 route): the masks on the
    clips whose central init chose the same candidate in both runs."""
    import numpy as np

    same = [bool(np.array_equal(p, q)) for p, q in zip(a["inits"], b["inits"])]
    d = _diffs(a, b, ("original_score_guess",))
    d["max_mask_diff_same_init"] = max(
        (float(np.abs(p - q).max()) for p, q, k in zip(a["masks"], b["masks"], same) if k), default=None)
    d["init_agrees"] = same
    return d


def _bf16_search_from_carry(api, weights: dict, dataset, failures) -> None:
    """STEPS search steps and finalize from one central carry, the same
    targets, on the float32 pool-kernel route and both bfloat16 routes:
    the search compared without the init's choice."""
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.interpret import mask_opt

    clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in range(BATCH)]).cuda().float()
    results = {}
    for route, flags in (("float32_kernels", FUSED_ROUTES["kernels"]), *BF16_ROUTES.items()):
        cfg = Config()
        for name, value in flags.items():
            setattr(cfg.model, name, value)
        model = api.build_model(api._bf16_argmax_upgrade(cfg), softmax_override=True)
        model.load_state_dict(weights)
        model.requires_grad_(False)

        def score(x, m=model):
            return m(x).float()

        if route == "float32_kernels":
            with torch.no_grad():
                targets = score(clips).argmax(dim=-1)
        results[route] = mask_opt.find_mask_from_carry(
            score, clips, targets, _central_carry(BATCH, CLIP_T), n_steps=STEPS)
    ref = results["float32_kernels"]
    for route in BF16_ROUTES:
        r = results[route]
        d = {"max_mask_diff": (r.mask - ref.mask).abs().max().item(),
             "max_score_diff": max((getattr(r, k) - getattr(ref, k)).abs().max().item()
                                   for k in ("freeze_score", "reverse_score", "orig_score"))}
        emit({"phase": "bf16_search_from_carry", "routes": [route, "float32_kernels"], "steps": STEPS, **d,
              "mask_tol": BF16_MASK_TOL, "score_tol": BF16_SCORE_TOL})
        if not (d["max_mask_diff"] <= BF16_MASK_TOL and d["max_score_diff"] <= BF16_SCORE_TOL):
            failures.append(f"bf16 search from one carry, {route} vs float32: {d}")


def phase_bf16_main_path(api, counters, failures, card: str, f32_run: dict) -> dict:
    """``find_masks`` at full width in bfloat16, all four routes, each
    twice."""
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        order = tuple(BF16_ROUTES) + tuple(f"{r}_again" for r in BF16_ROUTES)
        for run, label in enumerate(order):
            route = label.replace("_again", "")
            r = _find_masks_run(api, counters, out_dir, f"chip_smoke_{label}", BF16_ROUTES[route],
                                f32_run["weights"], dataset)
            runs[label] = r
            emit({
                "phase": "bf16_main_path", "run": run, "route": label, "flags": BF16_ROUTES[route],
                "card": card, "model": "i3d_smth", "clips": BATCH, "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3],
                "steps": STEPS, "mask_steps_per_s": r["rate"], "search_seconds": r["stats"]["search_seconds"],
                "init_seconds": r["stats"]["init_seconds"], "wall_seconds": r["wall"],
                "launches": r["launches"], "peak_mem_gib": r["peak_gib"],
                "masks": r["masks"].round(4).tolist(), "pickles": r["pickles"],
            })
            _check_outputs(label, r, failures)
            launches, mine = r["launches"], BF16_ROUTE_KERNELS[route]
            others = [n for n in launches if n not in mine]
            if not (all(launches[n] > 0 for n in mine) and not any(launches[n] for n in others)):
                failures.append(f"bf16 main path {label}: launches {launches}")
            if route in BF16_FUSED_COUNTERS:
                # the fused pair launches where the kernel route's bf16 pool
                # pair did, and b3b's GEMMs leave the pointwise count
                ref = runs["bf16_kernels"]["launches"]
                fwd, bwd = BF16_FUSED_COUNTERS[route]
                want = {fwd: ref["maxpool3d_s1_fwd_bf16"], bwd: ref["maxpool3d_s1_bwd_bf16"],
                        "pointwise_conv_bf16": ref["pointwise_conv_bf16"] - ref["maxpool3d_s1_fwd_bf16"]
                        - ref["maxpool3d_s1_bwd_bf16"]}
                if any(launches[k] != v for k, v in want.items()):
                    failures.append(f"bf16 main path {label}: launches {launches}, want {want}")
        if runs["bf16_default"]["launches"]["argmax_pool_fwd"] != f32_run["launches"]["maxpool3d_s1_fwd"]:
            failures.append("bf16 default: argmax launches differ from the nine branch-3 pools per forward")
    for route in BF16_ROUTES:
        a, b = f"{route}_again", route
        bits = _equal_bits(runs[a], runs[b])
        emit({"phase": "bf16_main_path_compare", "routes": [a, b], **_diffs(runs[a], runs[b]),
              "equal_bits": bits, "required": "equal bits"})
        if not bits:
            failures.append(f"{a} vs {b}: the same route run twice gave other bits")
    for a, b, score_tol, cam_tol, mask_tol in (
            *((r, "float32_kernels", BF16_SCORE_TOL, BF16_CAM_TOL, BF16_MASK_TOL) for r in BF16_ROUTES),
            ("bf16_default", "bf16_kernels", BF16_ROUTES_TOL, BF16_ROUTES_TOL, BF16_MASK_TOL),
            ("bf16_fused", "bf16_kernels", BF16_ROUTES_TOL, BF16_CAM_TOL, BF16_MASK_TOL),
            ("bf16_fused_tblock", "bf16_kernels", BF16_ROUTES_TOL, BF16_CAM_TOL, BF16_MASK_TOL),
            ("bf16_fused", "bf16_fused_tblock", BF16_ROUTES_TOL, BF16_ROUTES_TOL, FUSED_MASK_TOL)):
        d = _bf16_vs(runs[a], f32_run if b == "float32_kernels" else runs[b])
        d["equal_bits"] = _equal_bits(runs[a], f32_run if b == "float32_kernels" else runs[b])
        reason = BF16_FUSED_CAM_REASON if b == "bf16_kernels" and a != "bf16_default" else BF16_TOL_REASON
        emit({"phase": "bf16_main_path_compare", "routes": [a, b], **d, "mask_tol_same_init": mask_tol,
              "score_tol": score_tol, "cam_tol": cam_tol, "tol_reason": reason})
        m = d["max_mask_diff_same_init"]
        if m is None:
            failures.append(f"{a} vs {b}: the central init chose another candidate on every clip")
        elif m > mask_tol or d["max_score_diff"] > score_tol or d["max_cam_diff"] > cam_tol:
            failures.append(f"{a} vs {b}: {d}")
    _bf16_search_from_carry(api, f32_run["weights"], dataset, failures)
    launches = {n: runs["bf16_kernels"]["launches"][n] for n in BF16_KERNEL_COUNTERS}
    launches.update({n: runs["bf16_default"]["launches"][n] for n in ARGMAX_COUNTERS})
    for route, names in BF16_FUSED_COUNTERS.items():
        launches.update({n: runs[route]["launches"][n] for n in names})
    return launches


def phase_bf16_step_timing(api, card: str, weights: dict) -> None:
    """Device time by group per search step on the bfloat16 routes beside
    the float32 ones at batch 4, in turns; then the bfloat16 default route
    at batch 32 and, at 128, the default and kernel routes in turns (a few
    steps each). At 4 and 128 also the default route with the plain stem
    (``bf16_default_plain_stem``: the 7x7x7 stride-2 conv and its
    polyphase input gradient) beside the s2d stem."""
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    ds = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    clips = torch.stack([torch.from_numpy(ds[i][0]) for i in range(BATCH)]).cuda().float()
    routes = {"f32_kernels": FUSED_ROUTES["kernels"], "f32_plain": {}, **BF16_ROUTES,
              "bf16_default_plain_stem": BF16_ROUTES["bf16_default"]}
    models = {}
    for route, flags in routes.items():
        cfg = Config()
        for name, value in flags.items():
            setattr(cfg.model, name, value)
        # find_masks's own upgrade: the default bf16 route's argmax pool
        model = api.build_model(api._bf16_argmax_upgrade(cfg), softmax_override=True)
        model.load_state_dict(weights)
        models[route] = _stem(model.requires_grad_(False), not route.endswith("_plain_stem"))
    _step_timing("bf16_step_timing", models, clips, card,
                 turns=("bf16_default", "bf16_kernels", "bf16_fused", "bf16_fused_tblock", "f32_kernels",
                        "f32_plain", "bf16_default_plain_stem") * 2)
    gen = torch.Generator(device="cuda").manual_seed(12)
    for batch in (32, 128):
        big = torch.randint(0, 256, (batch, CLIP_T, CLIP_HW, CLIP_HW, 3), generator=gen,
                            device="cuda", dtype=torch.uint8).float()
        # at 128 the kernel route beside the default one, in turns
        routes = ("bf16_default",) if batch == 32 else ("bf16_default", "bf16_kernels")
        _step_timing("bf16_step_timing", {r: models[r] for r in routes}, big, card,
                     turns=routes + routes[::-1], steps=3)
        if batch == 128:
            pair = ("bf16_default", "bf16_default_plain_stem")
            _step_timing("bf16_stem_timing", {r: models[r] for r in pair}, big, card,
                         turns=pair + pair[::-1], steps=3)
        del big


# the stem at its full shape: (T, H, W, Cin) -> 64 channels; batches timed
STEM_SHAPE, STEM_OUT = (CLIP_T, CLIP_HW, CLIP_HW, 3), 64
STEM_BATCHES = {torch.float32: (4,), torch.bfloat16: (4, 128)}
# s2d stem against the plain stem, as a share of the plain stem's largest
# magnitude: the tolerances of tests/test_torch_stem.py (float32 sums in
# another order; bfloat16 two ulps at the top binade)
STEM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}


def phase_stem_s2d_check(failures, card: str) -> None:
    """The space-to-depth stem (``ops/conv.py::conv3d_stem_s2d``) against
    the plain stem (``conv3d_same`` at stride 2, polyphase input gradient)
    at the stem's full shape, inside the entry points' numerics pin: the
    forward and the input gradient within ``STEM_TOL``, equal bits from two
    runs of each form, device ms of both directions of each form (float32
    at batch 4, bfloat16 at 4 and 128), peak memory, and the kernels the
    profiler names for each. A third form, ``s2d_cudnn_dgrad``, takes the
    s2d conv's input gradient from cuDNN's backward-data conv instead of
    the forward conv the port uses (``_Stride1Conv3dFwdGrad``)."""
    from unittest import mock

    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch import precision
    from ivf_tpu_torch.ops import conv

    gen = torch.Generator(device="cuda").manual_seed(21)
    w32 = torch.randn(STEM_OUT, 3, 7, 7, 7, generator=gen, device="cuda") * (2.0 / (3 * 343)) ** 0.5
    b32 = torch.randn(STEM_OUT, generator=gen, device="cuda") * 0.1
    for dtype, batches in STEM_BATCHES.items():
        w, b = w32.to(dtype), b32.to(dtype)
        s2d = lambda a: conv.conv3d_stem_s2d(a, w, b)  # noqa: E731
        cudnn_dgrad = mock.patch.object(conv._Stride1Conv3dFwdGrad, "apply", staticmethod(
            lambda xb, k, bias, pad: F.conv3d(xb, k, bias, padding=pad)))
        forms = {"s2d": (s2d, contextlib.nullcontext()), "s2d_cudnn_dgrad": (s2d, cudnn_dgrad),
                 "plain": (lambda a: conv.conv3d_same(a, w, (2, 2, 2), b), contextlib.nullcontext())}
        for batch in batches:
            x = torch.randint(0, 256, (batch, *STEM_SHAPE), generator=gen, device="cuda",
                              dtype=torch.uint8).float().requires_grad_(True)
            g = torch.randn(batch, *(d // 2 for d in STEM_SHAPE[:3]), STEM_OUT, generator=gen,
                            device="cuda").to(dtype)
            row = {"phase": "stem_s2d_check", "card": card, "dtype": str(dtype).split(".")[-1],
                   "batch": batch, "tol": STEM_TOL[dtype]}
            out = {}
            with precision.reference_numerics():
                for name, (fn, context) in forms.items():
                    with context:
                        runs = []
                        for _ in range(2):
                            y = fn(x)
                            (dx,) = torch.autograd.grad(y, x, g)
                            runs.append((y.detach(), dx))
                        out[name] = runs[0]
                        row[f"{name}_equal_bits"] = all(torch.equal(p, q) for p, q in zip(*runs))
                        if not row[f"{name}_equal_bits"]:
                            failures.append(f"stem {name} {dtype} b{batch}: two runs gave other bits")
                        del runs
                        torch.cuda.synchronize()
                        torch.cuda.reset_peak_memory_stats()
                        y = fn(x)
                        row[f"{name}_fwd_ms"] = device_ms(lambda: fn(x), reps=5, warmup=1)
                        row[f"{name}_dx_ms"] = device_ms(
                            lambda: torch.autograd.grad(y, x, g, retain_graph=True), reps=5, warmup=1)
                        row[f"{name}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                            torch.autograd.grad(fn(x), x, g)
                            torch.cuda.synchronize()
                        row[f"{name}_kernels"] = sorted(
                            ([round((getattr(ev, "self_device_time_total", 0) or 0) / 1e3, 3), ev.count, ev.key[:100]]
                             for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA), reverse=True)[:6]
                        del y
                for form in ("s2d", "s2d_cudnn_dgrad"):
                    for k, (p, q) in enumerate(zip(out[form], out["plain"])):
                        err = ((p.float() - q.float()).abs().max() / q.float().abs().max()).item()
                        row[f"{form}_vs_plain_max_rel_err_" + ("fwd" if k == 0 else "dx")] = err
                        if not err <= STEM_TOL[dtype]:
                            failures.append(f"stem {form} vs plain {dtype} b{batch}: {err} > {STEM_TOL[dtype]}")
            emit(row)
            del x, g, out
            torch.cuda.empty_cache()


# the refill phase: 8 clips in batches of 4, REFILL_STEPS steps in segments
# of REFILL_CHUNK, on the bfloat16 kernel route
REFILL_CLIPS, REFILL_BATCH, REFILL_STEPS, REFILL_CHUNK = 8, 4, 10, 2


def refill_eta(deltas, batch: int, chunk: int):
    """An early-stop ``eta`` under which the rows stop at different steps
    within every batch, with a segment boundary in each batch that some
    rows have stopped by and others have not (refill re-stages rows
    there). ``deltas[r, t - 1]`` is |loss_(t-1) - loss_t| of row r at step
    t, as ``search_step`` forms it. The candidates are geometric midpoints
    between neighbouring deltas (as far from each as the data allow).
    Returns (eta, the stop step of each row, steps + 1 for none) or
    (None, None)."""
    import numpy as np

    n, steps = deltas.shape
    vals = np.unique(deltas[np.isfinite(deltas) & (deltas > 0)])
    best, best_key = (None, None), None
    for eta in np.sqrt(vals[:-1] * vals[1:]):
        below = deltas < eta
        stop = np.where(below.any(axis=1), below.argmax(axis=1) + 1, steps + 1)
        groups = [stop[i : i + batch] for i in range(0, n, batch)]
        mixed = all(any((rows <= bd).any() and (rows > bd).any() for bd in range(chunk, steps, chunk))
                    for rows in groups)
        key = (mixed, min(len(set(rows)) for rows in groups), len(set(stop)))
        if mixed and (best_key is None or key > best_key):
            best, best_key = (float(eta), stop), key
    return best


def _refill_deltas(api, cfg, weights, dataset):
    """Each row's per-step loss change over REFILL_STEPS steps without early
    stop, batch by batch, as ``find_masks`` would form it (its model, its
    targets and central init, the entry points' numerics pin)."""
    import numpy as np

    from ivf_tpu_torch import precision
    from ivf_tpu_torch.interpret import mask_opt

    model = api.build_model(api._bf16_argmax_upgrade(cfg), softmax_override=True)
    model.load_state_dict(weights)
    model.requires_grad_(False)
    score = lambda x: model(x).float()  # noqa: E731
    out = []
    with precision.reference_numerics():
        for start in range(0, len(dataset), cfg.data.batch_size):
            rows = range(start, start + cfg.data.batch_size)
            clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in rows]).cuda().float()
            with torch.no_grad():
                targets = score(clips).argmax(dim=-1)
            carry = mask_opt.make_search_carry(mask_opt.init_mask_central(score, clips, targets))
            deltas = []
            for _ in range(cfg.mask.opt_iter):
                before = carry.loss
                carry = mask_opt.search_step(score, clips, targets, carry)
                deltas.append(torch.abs(before - carry.loss))
            out.append(torch.stack(deltas, dim=1).cpu().numpy())
    return np.concatenate(out)


def _by_id(run: dict) -> dict:
    """A run's records, masks and CAMs in clip-id order (refill emits in
    retirement order)."""
    import numpy as np

    order = np.argsort([r["video_id"] for r in run["tm"]], kind="stable")
    return dict(run, tm=[run["tm"][i] for i in order], masks=run["masks"][order], cams=run["cams"][order])


def phase_refill(api, counters, failures, card: str, weights: dict) -> None:
    """Convergence refill at full width on the bfloat16 kernel route: an eta
    tuned from this run's own loss trajectories (``refill_eta``), then the
    monolithic search, the chunked one without refill and with it
    (counters set to 0 before each run, read after). Required: refill on
    and off give equal bits per clip, and the chunked search without
    refill those of the monolithic one; refill re-staged rows, launched
    no more segments than without it, and the stop steps agree."""
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(REFILL_CLIPS, CLIP_T, CLIP_HW, CLASSES, seed=3, lazy=False)
    flags = BF16_ROUTES["bf16_kernels"]

    def config(out_dir="", name="", **mask):
        cfg = Config()
        cfg.output_dir, cfg.model_name = out_dir, name
        cfg.data.batch_size = REFILL_BATCH
        cfg.mask.opt_iter = REFILL_STEPS
        for key, value in flags.items():
            setattr(cfg.model, key, value)
        for key, value in mask.items():
            setattr(cfg.mask, key, value)
        return cfg

    deltas = _refill_deltas(api, config(), weights, dataset)
    eta, stop = refill_eta(deltas, REFILL_BATCH, REFILL_CHUNK)
    emit({"phase": "refill_eta", "card": card, "eta": eta, "predicted_stop_steps": None if stop is None else
          stop.tolist(), "loss_deltas": deltas.tolist()})
    if eta is None:
        failures.append("refill: no eta makes the stop steps differ within every batch")
        return
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        for label, mask in (("monolithic", {}), ("no_refill", dict(chunk_steps=REFILL_CHUNK, refill=False)),
                            ("refill", dict(chunk_steps=REFILL_CHUNK))):
            cfg = config(out_dir, f"refill_{label}", early_stop=True, eta=eta, **mask)
            r = _find_masks_run(api, counters, out_dir, "", {}, weights, dataset, batch=REFILL_BATCH,
                                steps=REFILL_STEPS, cfg=cfg)
            runs[label] = r
            st = r["stats"]
            keys = ("search_launches", "segments_launched", "refill_flushes", "refill_requeued_rows",
                    "padded_rows", "n_steps_run", "search_seconds")
            emit({"phase": "refill", "run": label, "card": card, "clips": REFILL_CLIPS, "batch": REFILL_BATCH,
                  "steps": REFILL_STEPS, "chunk_steps": mask.get("chunk_steps"), "eta": eta,
                  "order": [t["video_id"] for t in r["tm"]], "launches": r["launches"],
                  "peak_mem_gib": r["peak_gib"], **{k: st[k] for k in keys}})
            _check_outputs(f"refill {label}", r, failures, batch=REFILL_CLIPS)
            launches = r["launches"]
            mine = BF16_ROUTE_KERNELS["bf16_kernels"]
            if not (all(launches[n] > 0 for n in mine) and not any(launches[n] for n in launches if n not in mine)):
                failures.append(f"refill {label}: launches {launches}")
    on, off, mono = (_by_id(runs[k]) for k in ("refill", "no_refill", "monolithic"))
    son, soff = runs["refill"]["stats"], runs["no_refill"]["stats"]
    steps_run = {k: sorted(r["stats"]["n_steps_run"]) for k, r in runs.items()}
    staged = runs["no_refill"]["stats"]["n_steps_run"]
    checks = {
        "refill_vs_no_refill_equal_bits": _equal_bits(on, off),
        "no_refill_vs_monolithic_equal_bits": _equal_bits(off, mono),
        "requeued_rows": son["refill_requeued_rows"] > 0 and son["refill_flushes"] > 0,
        "segments_no_more": son["segments_launched"] <= soff["segments_launched"],
        "stop_steps_agree": steps_run["refill"] == steps_run["no_refill"] == steps_run["monolithic"],
        "stop_steps_differ_in_each_batch": all(
            len(set(staged[i : i + REFILL_BATCH])) > 1 for i in range(0, REFILL_CLIPS, REFILL_BATCH)),
    }
    emit({"phase": "refill_compare", "card": card, **checks,
          "predicted_n_steps_run": [min(int(s) - 1, REFILL_STEPS) for s in stop],
          "n_steps_run_staged": staged, "segments": [son["segments_launched"], soff["segments_launched"]],
          "refill_vs_no_refill": _diffs(on, off), "required": "equal bits; every check true"})
    failures.extend(f"refill: {name} failed" for name, ok in checks.items() if not ok)


# the driver phase: 12 clips with ids, loader batches of 4, DRIVER_STEPS
# steps, on the bfloat16 kernel route; the subset file keeps 9 of the 12
DRIVER_CLIPS, DRIVER_BATCH, DRIVER_STEPS = 12, 4, 10
DRIVER_DROPPED = ("clip1", "clip6", "clip10")


def _driver_probe_scores(api, cfg, weights, dataset, ids) -> dict:
    """The true-class probability of each clip of ``ids`` as the probe of
    ``find_masks`` forms it: the kept clips in order, in batches of
    ``cfg.data.batch_size`` (the last padded with its first clip), its
    model, the entry points' numerics pin."""
    from ivf_tpu_torch import precision

    model = api.build_model(api._bf16_argmax_upgrade(cfg), softmax_override=True)
    model.load_state_dict(weights)
    model.requires_grad_(False)
    rows = [i for i in range(len(dataset)) if dataset[i][2] in ids]
    b, out = cfg.data.batch_size, {}
    with precision.reference_numerics(), torch.no_grad():
        for k in range(0, len(rows), b):
            take = rows[k : k + b]
            padded = take + [take[0]] * (b - len(take))
            clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in padded]).cuda().float()
            probs = model(clips).float()[: len(take)].cpu()
            out.update({dataset[i][2]: float(probs[j, dataset[i][1]]) for j, i in enumerate(take)})
    return out


def driver_min_score(scores: dict, first_batch: set):
    """A ``min_score`` halfway between two neighbouring probe scores that
    skips 3 or 2 of the clips, preferring one under which the first loader
    batch holds a skipped clip and a kept one (so an interrupted run
    journals both). Returns (min_score, skipped ids) or (None, None)."""
    ranked = sorted(scores.items(), key=lambda kv: kv[1])
    best, best_mixed = (None, None), False
    for k in (3, 2):
        lo, hi = ranked[k - 1][1], ranked[k][1]
        if not lo < hi:
            continue
        skipped = {cid for cid, _ in ranked[:k]}
        mixed = bool(skipped & first_batch) and bool(first_batch - skipped)
        if best[0] is None or (mixed and not best_mixed):
            best, best_mixed = ((lo + hi) / 2, skipped), mixed
    return best


def _same_bits_by_id(a: dict, b: dict, ids=None) -> bool:
    """Records (masks, scores) and CAMs of two runs equal bit for bit per
    clip id, over ``ids`` (default: every id of either run)."""
    import numpy as np

    tm_a, tm_b = ({r["video_id"]: r for r in run["tm"]} for run in (a, b))
    gc_a, gc_b = ({r["video_id"]: r for r in run["gc"]} for run in (a, b))
    if ids is None:
        if set(tm_a) != set(tm_b) or set(gc_a) != set(gc_b):
            return False
        ids = set(tm_a) | set(gc_a)
    for vid in ids:
        for x, y in ((tm_a.get(vid), tm_b.get(vid)), (gc_a.get(vid), gc_b.get(vid))):
            if (x is None) != (y is None):
                return False
            if x is None:
                continue
            if set(x) != set(y) or not all(
                    np.array_equal(v, y[k]) if isinstance(v, np.ndarray) else v == y[k] for k, v in x.items()):
                return False
    return True


def phase_driver(api, counters, failures, card: str, weights: dict) -> None:
    """The long-run driver of ``find_masks`` at full width on the bfloat16
    kernel route: 12 clips with ids in loader batches of 4, 10 steps, a
    subset file keeping 9 and a ``min_score`` from this run's own probe
    scores (``driver_min_score``) that skips 2-3 of them; every launch
    counter set to 0 before each run and read after.

    (a) the reference run: the kept clips compact across loader batches
    (``ceil(kept / 4)`` searches, only the final flush padded), the probe
    runs in full batches and its scores stand in for the staging forward;
    (b) interrupted after one loader batch, then resumed: each clip the
    bits of (a), the journaled records and skips restored, no journaled
    skip probed again, only the rest searched; (c) a journal torn by a few
    bytes, resumed: the intact prefix restores, the rest runs again, the
    bits of (a); (d) random init, uninterrupted and interrupted + resumed:
    equal bits; (e) ``run_temp_mask=False`` (Grad-CAM alone: the CAMs of
    (a), no search, no pool backward) and ``do_gradcam=False`` (the masks
    of (a), no CAM)."""
    import math

    import numpy as np

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    t_phase = time.perf_counter()
    dataset = SyntheticClips(DRIVER_CLIPS, CLIP_T, CLIP_HW, CLASSES, seed=7, lazy=False)  # labels = index
    flags = BF16_ROUTES["bf16_kernels"]
    mine = BF16_ROUTE_KERNELS["bf16_kernels"]
    subset = [f"clip{i}" for i in range(DRIVER_CLIPS) if f"clip{i}" not in DRIVER_DROPPED]

    def config(out_dir="", name="", **mask):
        cfg = Config()
        cfg.output_dir, cfg.model_name = out_dir, name
        cfg.data.batch_size = DRIVER_BATCH
        cfg.mask.opt_iter = DRIVER_STEPS
        for key, value in flags.items():
            setattr(cfg.model, key, value)
        for key, value in mask.items():
            setattr(cfg.mask, key, value)
        return cfg

    first_batch = {f"clip{i}" for i in range(DRIVER_BATCH)} & set(subset)
    scores = _driver_probe_scores(api, config(), weights, dataset, set(subset))
    min_score, predicted_skips = driver_min_score(scores, first_batch)
    emit({"phase": "driver_min_score", "card": card, "probe_scores": scores, "min_score": min_score,
          "predicted_skips": sorted(predicted_skips or ())})
    if min_score is None:
        failures.append("driver: no min_score skips 2-3 of the kept clips")
        return
    kept = len(subset) - len(predicted_skips)
    with tempfile.TemporaryDirectory() as out_dir:
        subset_file = Path(out_dir) / "subset.csv"
        subset_file.write_text("".join(f"{cid},keep\n" for cid in subset))
        filters = dict(subset_file=str(subset_file), min_score=min_score)

        def journal(name):
            return api._EmissionJournal.load(str(Path(out_dir) / name / "results" / "emission_journal.p"))

        def run(label, name, mask=None, **kwargs):
            cfg = config(out_dir, name, **filters, **(mask or {}))
            r = _find_masks_run(api, counters, out_dir, "", {}, weights, dataset, DRIVER_BATCH, DRIVER_STEPS,
                                cfg=cfg, **kwargs)
            st = r["stats"]
            keys = ("score_launches", "search_launches", "searched_rows", "padded_rows", "resumed_clips",
                    "resumed_skipped", "search_seconds", "init_seconds")
            emit({"phase": "driver", "run": label, "card": card, "clips": DRIVER_CLIPS, "batch": DRIVER_BATCH,
                  "steps": DRIVER_STEPS, "flags": flags, "mask": mask or {}, "find_masks": kwargs,
                  "kept_ids": [t["video_id"] for t in r["tm"]], "cam_ids": [g["video_id"] for g in r["gc"]],
                  "launches": r["launches"], "wall_seconds": r["wall"], "peak_mem_gib": r["peak_gib"],
                  **{k: st[k] for k in keys}})
            masks, cams = r["masks"], r["cams"]
            if not (np.isfinite(masks).all() and masks.min(initial=0) >= 0 and masks.max(initial=1) <= 1):
                failures.append(f"driver {label}: masks not finite in [0, 1]")
            if cams.shape[1:] != (CLIP_T, CLIP_HW, CLIP_HW) or not np.isfinite(cams).all():
                failures.append(f"driver {label}: CAMs {cams.shape} not finite (n, 16, 224, 224)")
            if len(r["pickles"]) != 2:
                failures.append(f"driver {label}: pickles missing: {r['pickles']}")
            return r

        def require(label, ok, detail):
            if not ok:
                failures.append(f"driver {label}: {detail}")
            return bool(ok)

        def kernels_ran(label, r, off=()):
            launches = r["launches"]
            ok = (all(launches[n] > 0 for n in mine if n not in off) and not any(launches[n] for n in off)
                  and not any(launches[n] for n in launches if n not in mine))
            return require(label, ok, f"launches {launches}")

        checks = {}
        # (a) every filter on
        a = run("reference", "a")
        st = a["stats"]
        skipped = sorted(v for v, rec in journal("a").items() if rec.get("skip"))
        checks["a_skips_as_predicted"] = require("reference", skipped == sorted(predicted_skips),
                                                 f"skips {skipped}, predicted {sorted(predicted_skips)}")
        checks["a_kept"] = require("reference", sorted(t["video_id"] for t in a["tm"]) == sorted(
            set(subset) - predicted_skips), [t["video_id"] for t in a["tm"]])
        checks["a_compacted"] = require("reference", (st["search_launches"], st["padded_rows"]) == (
            math.ceil(kept / DRIVER_BATCH), -kept % DRIVER_BATCH), st)
        checks["a_probe_only_scores"] = require("reference", st["score_launches"] == math.ceil(
            len(subset) / DRIVER_BATCH), st["score_launches"])
        checks["a_probe_scores_kept"] = require("reference", all(
            t["original_score_true"] == scores[t["video_id"]] for t in a["tm"]), "probe scores")
        checks["a_kernels"] = kernels_ran("reference", a)

        # (b) interrupted after one loader batch, then resumed
        run("interrupted", "b", max_batches=1)
        journaled = journal("b")
        n_skip = sum(1 for rec in journaled.values() if rec.get("skip"))
        b = run("resumed", "b", resume=True)
        st = b["stats"]
        checks["b_equal_bits"] = require("resumed", _same_bits_by_id(b, a), "bits differ from the reference")
        checks["b_restored"] = require("resumed", (st["resumed_clips"], st["resumed_skipped"]) == (
            len(journaled) - n_skip, n_skip), (st["resumed_clips"], st["resumed_skipped"], len(journaled)))
        checks["b_no_probe_of_journaled"] = require("resumed", st["score_launches"] == math.ceil(
            (len(subset) - len(journaled)) / DRIVER_BATCH), st["score_launches"])
        checks["b_searched_rest"] = require("resumed", st["searched_rows"] == kept - st["resumed_clips"], st)
        checks["b_journal_mixed"] = n_skip > 0 and len(journaled) > n_skip
        checks["b_kernels"] = kernels_ran("resumed", b)

        # (c) a torn journal: (a)'s journal cut by a few bytes, then resumed
        path = Path(out_dir) / "c" / "results" / "emission_journal.p"
        path.parent.mkdir(parents=True)
        path.write_bytes((Path(out_dir) / "a" / "results" / "emission_journal.p").read_bytes()[:-5])
        intact = journal("c")
        c = run("torn_resumed", "c", resume=True)
        st = c["stats"]
        checks["c_prefix_restored"] = require("torn_resumed", (
            st["resumed_clips"] + st["resumed_skipped"] == len(intact) == len(subset) - 1), (
            st["resumed_clips"], st["resumed_skipped"], len(intact)))
        checks["c_searched_rest"] = require("torn_resumed", st["searched_rows"] == kept - st["resumed_clips"], st)
        checks["c_equal_bits"] = require("torn_resumed", _same_bits_by_id(c, a), "bits differ from the reference")

        # (d) random init, uninterrupted and interrupted + resumed
        d0 = run("random", "d0", dict(mask_init_type="random"))
        run("random_interrupted", "d1", dict(mask_init_type="random"), max_batches=1)
        d1 = run("random_resumed", "d1", dict(mask_init_type="random"), resume=True)
        checks["d_equal_bits"] = require("random_resumed", _same_bits_by_id(d1, d0), "bits differ")
        checks["d_resumed"] = require("random_resumed", d1["stats"]["resumed_clips"] > 0, d1["stats"])
        checks["d_init_is_random"] = require("random", not _same_bits_by_id(d0, a), "random init gave (a)'s bits")
        checks["d_kernels"] = kernels_ran("random", d0)

        # (e) the switches
        e0 = run("gradcam_only", "e0", run_temp_mask=False)
        st = e0["stats"]
        checks["e_gradcam_only"] = require("gradcam_only", not e0["tm"] and (
            st["search_launches"], st["searched_rows"], st["padded_rows"]) == (0, 0, 0) and all(
            rec.get("mask") is None and rec.get("cam") is not None
            for rec in journal("e0").values() if not rec.get("skip")), st)
        checks["e_gradcam_only_cams"] = require("gradcam_only", _same_bits_by_id(
            dict(e0, tm=[]), dict(a, tm=[])), "CAMs differ from the reference")
        checks["e_gradcam_only_kernels"] = kernels_ran("gradcam_only", e0, off=("maxpool3d_s1_bwd_bf16",))
        e1 = run("no_gradcam", "e1", do_gradcam=False)
        checks["e_no_gradcam"] = require("no_gradcam", not e1["gc"] and all(
            rec.get("cam") is None and rec.get("mask") is not None
            for rec in journal("e1").values() if not rec.get("skip")), "CAMs emitted")
        checks["e_no_gradcam_masks"] = require("no_gradcam", _same_bits_by_id(
            dict(e1, gc=[]), dict(a, gc=[])), "masks differ from the reference")
        checks["e_no_gradcam_kernels"] = kernels_ran("no_gradcam", e1)
    emit({"phase": "driver_compare", "card": card, **checks, "kept": kept, "skipped": sorted(predicted_skips),
          "phase_seconds": time.perf_counter() - t_phase,
          "required": "equal bits per clip; every check true but b_journal_mixed (reported)"})


# the data_path phase: the smth preset's batch of clips in a frame tree, a
# KTH tree of as many numbered clip dirs; the routes the preset runs on
DATA_CLIPS, DATA_STEPS, DATA_SEED, DATA_DECODE_EPOCHS = 16, 10, 11, 3
DATA_ROUTES = {"preset": {}, "bf16_kernels": BF16_ROUTES["bf16_kernels"],
               "bf16_default": BF16_ROUTES["bf16_default"]}
DATA_ROUTE_KERNELS = {"preset": (), **{r: BF16_ROUTE_KERNELS[r] for r in ("bf16_kernels", "bf16_default")}}


def _write_jpegs(frames_by_dir: dict) -> None:
    """Each (T, H, W, 3) uint8 array of ``frames_by_dir`` as
    ``<dir>/frameNN.jpg`` (1-based, the loaders' names), JPEG quality 95,
    encoded on 8 threads (PIL releases the interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(job):
        path, frame = job
        Image.fromarray(frame).save(path, "JPEG", quality=95)

    jobs = []
    for d, frames in frames_by_dir.items():
        Path(d).mkdir(parents=True, exist_ok=True)
        jobs += [(str(Path(d) / f"frame{i + 1:02d}.jpg"), f) for i, f in enumerate(frames)]
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(one, jobs))


def data_kth_tags(n: int) -> list:
    """``n`` KTH clip tags, alternately on the ``original`` whitelist
    (subjects 17-18, 24-25) and off it (subjects 1-16)."""
    from ivf_tpu_torch.data.kth_clips_of_interest import clips_of_interest

    on = ["_".join(parts[:3]) + parts[3] for parts in clips_of_interest("original")]
    off = [f"person{1 + i:02d}_boxing_d1_1" for i in range(n)]
    return [on[i // 2] if i % 2 == 0 else off[i // 2] for i in range(n)]


def phase_data_path(api, counters, failures, card: str, weights: dict, clstm_weights: dict) -> None:
    """``find_masks`` from the presets in ``configs/`` over data on disk,
    through ``build_dataset`` and the ``ClipLoader``.

    I3D: a smth frame tree ``validation/<class>/<clip_id>/frameNN.jpg`` of
    16 clips (the preset's batch size) of 16 frames of 224x224, seeded,
    labels spread over the 174 classes; ``configs/config_i3d_smth.py``
    loaded with the port's ``Config.load``, only ``data_folder``,
    ``output_dir``, ``model_name`` and ``opt_iter`` (300 -> 10) changed,
    then ``find_masks(cfg, weights, split="validation")`` on three routes:
    the preset as loaded (float32, cuDNN and torch pools), the bf16 kernel
    route and the bf16 default route (argmax pool). Each run is held
    against a run of the same decoded clips and ids handed over as an
    in-memory list (which runs first and pays the route's first-run
    set-up): equal bits per clip (masks, scores, CAMs). Every run runs
    under a CUDA-only profiler (the device busy share) with its launch
    counters set to 0 just before and read just after.

    ConvLSTM: a KTH tree of 16 numbered clip dirs of 32 frames of 120x160
    with ``class.txt`` and ``label.txt``, half of the tags on the
    ``original`` whitelist; ``configs/config_clstm_kth.py`` with
    ``use_pallas`` and ``kth_clips_filter`` on: the kept ids are the
    whitelist's, the gate kernel launched, and the bits are those of the
    in-memory list.

    Also the decoder the loader used (native libjpeg or PIL) and its
    decode rate in clips/s at the preset's ``num_workers`` over the smth
    tree (files just written: a warm read), to host memory and on to the
    card."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.kth_clips_of_interest import tag_matches

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rng = np.random.RandomState(DATA_SEED)
    checks = {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"data_path {label}: {detail}")
        return bool(ok)

    with tempfile.TemporaryDirectory() as tmp:
        smth, kth, out_dir = Path(tmp) / "smth", Path(tmp) / "kth", Path(tmp) / "out"
        t0 = time.perf_counter()
        _write_jpegs({
            smth / "validation" / str(i * 11 % CLASSES) / f"smth{i:02d}":
                rng.randint(0, 256, (CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8)
            for i in range(DATA_CLIPS)
        })
        tags = data_kth_tags(CLSTM_BATCH)
        _write_jpegs({
            kth / str(i): rng.randint(0, 256, (CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8)
            for i in range(CLSTM_BATCH)
        })
        for i, tag in enumerate(tags):
            (kth / str(i) / "class.txt").write_text(f"{i % CLSTM_CLASSES}\n")
            (kth / str(i) / "label.txt").write_text(f"{tag}\n")
        write_seconds = time.perf_counter() - t0

        def preset(name, run_name, **fields):
            cfg = Config.load(str(root / "configs" / name))
            cfg.output_dir, cfg.model_name = str(out_dir), run_name
            cfg.mask.opt_iter = DATA_STEPS
            for key, value in fields.items():
                setattr(cfg.model if hasattr(cfg.model, key) else cfg.mask, key, value)
            return cfg

        # the loader alone: which decoder, and how fast
        cfg = preset("config_i3d_smth.py", "decode")
        cfg.data.data_folder = str(smth)
        dataset = api.build_dataset(cfg, "validation", get_item_id=True)
        rates = {}
        for placed in (False, True):
            loader = api.build_loader(cfg, dataset, False, drop_last=False, to_device=placed,
                                      device="cuda" if placed else None)
            n = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DATA_DECODE_EPOCHS):
                for batch in loader:
                    n += len(batch[1])
            torch.cuda.synchronize()
            rates["to_card" if placed else "to_host"] = n / (time.perf_counter() - t0)
            if placed:
                checks["loader_uint8_on_card"] = require(
                    "loader", batch[0].dtype == torch.uint8 and batch[0].is_cuda, (batch[0].dtype, batch[0].device))
        decoder = "native libjpeg" if loader._use_native() else "PIL"
        items = [dataset[i] for i in range(len(dataset))]  # per-item PIL decode
        emit({"phase": "data_path_decode", "card": card, "decoder": decoder,
              "num_workers": cfg.data.num_workers, "clips": DATA_CLIPS * DATA_DECODE_EPOCHS,
              "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3], "decode_clips_per_s": rates["to_host"],
              "decode_to_card_clips_per_s": rates["to_card"], "read": "warm (files just written)",
              "tree_write_seconds": write_seconds})

        runs = {}
        for route, flags in DATA_ROUTES.items():
            changed = {"data.data_folder": str(smth), "output_dir": str(out_dir), "mask.opt_iter": DATA_STEPS,
                       **{f"model.{k}": v for k, v in flags.items()}}
            pair = {}
            # the in-memory run first: it pays the route's first-run set-up
            # (cuDNN's per-shape choice), so the tree run's rate is a warm one
            for source in ("list", "tree"):
                cfg = preset("config_i3d_smth.py", f"{route}_{source}", **flags)
                cfg.data.data_folder = str(smth)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    pair[source] = _find_masks_run(
                        api, counters, str(out_dir), "", {}, weights, None if source == "tree" else items,
                        DATA_CLIPS, DATA_STEPS, cfg=cfg, split="validation")
                r = pair[source]
                r["device_ms"] = sum((getattr(ev, "self_device_time_total", 0) or 0) / 1e3
                                     for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
                mine, launches = DATA_ROUTE_KERNELS[route], r["launches"]
                checks[f"{route}_{source}_kernels"] = require(f"{route} {source}", all(
                    launches[n] > 0 for n in mine) and not any(launches[n] for n in launches if n not in mine),
                    f"launches {launches}")
                _check_outputs(f"data_path {route} {source}", r, failures, batch=DATA_CLIPS)
            tree, listed = pair["tree"], pair["list"]
            checks[f"{route}_ids"] = require(route, sorted(t["video_id"] for t in tree["tm"]) == sorted(
                it[2] for it in items), [t["video_id"] for t in tree["tm"]])
            checks[f"{route}_equal_bits"] = require(route, _same_bits_by_id(tree, listed),
                                                    "tree and in-memory list differ")
            runs[route] = tree
            emit({"phase": "data_path", "model": "i3d_smth", "preset": "configs/config_i3d_smth.py",
                  "route": route, "changed": changed, "card": card, "clips": DATA_CLIPS,
                  "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3], "steps": DATA_STEPS,
                  "mask_steps_per_s": tree["rate"], "list_mask_steps_per_s": listed["rate"],
                  "search_seconds": tree["stats"]["search_seconds"], "wall_seconds": tree["wall"],
                  "list_wall_seconds": listed["wall"], "device_ms_run": tree["device_ms"],
                  "device_busy_share": tree["device_ms"] / 1e3 / tree["wall"],
                  "list_device_busy_share": listed["device_ms"] / 1e3 / listed["wall"],
                  "profiled": "CUDA activity only, both runs", "launches": tree["launches"],
                  "peak_mem_gib": tree["peak_gib"], "equal_bits_vs_list": checks[f"{route}_equal_bits"]})

        # the ConvLSTM on the KTH tree, the whitelist filter on
        pair = {}
        clstm_items = None
        for source in ("tree", "list"):
            cfg = preset("config_clstm_kth.py", f"kth_{source}", use_pallas=True, kth_clips_filter=True)
            cfg.data.data_folder = str(kth)
            if clstm_items is None:
                ds = api.build_dataset(cfg, "validation", get_item_id=True)
                clstm_items = [ds[i] for i in range(len(ds))]
            pair[source] = _find_masks_run(api, counters, str(out_dir), "", {}, clstm_weights,
                                           None if source == "tree" else clstm_items, CLSTM_BATCH, DATA_STEPS,
                                           cfg=cfg, split="validation")
        tree = pair["tree"]
        want = sorted(t for t in tags if tag_matches(t, "original"))
        kept = sorted(t["video_id"] for t in tree["tm"])
        gates = ("lstm_gates_fwd", "lstm_gates_bwd")
        launches = tree["launches"]
        checks["kth_kept_whitelist"] = require("kth", kept == want and len(want) == CLSTM_BATCH // 2,
                                               f"kept {kept}, whitelist {want}")
        checks["kth_gate_kernel"] = require("kth", all(launches[n] > 0 for n in gates) and not any(
            launches[n] for n in launches if n not in gates), f"launches {launches}")
        checks["kth_equal_bits"] = require("kth", _same_bits_by_id(tree, pair["list"]),
                                           "tree and in-memory list differ")
        masks, cams = tree["masks"], tree["cams"]
        checks["kth_outputs"] = require("kth", np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1
                                        and cams.shape == (len(want), CLSTM_T, *CLSTM_HW) and np.isfinite(cams).all(),
                                        f"masks / CAMs {cams.shape}")
        emit({"phase": "data_path", "model": "clstm_kth", "preset": "configs/config_clstm_kth.py",
              "route": "gate_kernel", "changed": {"data.data_folder": str(kth), "output_dir": str(out_dir),
                                                  "mask.opt_iter": DATA_STEPS, "model.use_pallas": True,
                                                  "mask.kth_clips_filter": True},
              "card": card, "clips": CLSTM_BATCH, "kept": kept, "clip_shape": [CLSTM_T, *CLSTM_HW, 3],
              "steps": DATA_STEPS, "mask_steps_per_s": tree["rate"], "wall_seconds": tree["wall"],
              "launches": launches})
    emit({"phase": "data_path_compare", "card": card, **checks, "phase_seconds": time.perf_counter() - t_phase,
          "required": "every check true"})


# the artifacts phase: i3d_smth clips in two flushes, so that the second
# flush's search overlaps the first one's rendering; the ConvLSTM's KTH run
# (4 and 2 clips, down from 8 and 4, for the smoke's time limit)
ART_CLIPS, ART_BATCH, ART_CLSTM_CLIPS = 4, 2, 2


@contextmanager
def _writer_waits(api):
    """The seconds each ``find_masks`` spent in its writer's ``close`` (the
    wait for the journal and viz jobs still in flight), appended to the
    yielded list; an empty list on a checkout without the writer."""
    from unittest import mock

    waits: list = []
    writer = getattr(api, "_AsyncWriter", None)
    if writer is None:
        yield waits
        return
    close = writer.close

    def timed_close(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return close(self, *args, **kwargs)
        finally:
            waits.append(time.perf_counter() - t0)

    with mock.patch.object(writer, "close", timed_close):
        yield waits


def _clip_folder(save_dir: Path, rec: dict) -> Path:
    """The folder ``find_masks(save_viz=True)`` writes a clip's artifacts
    to, from its record (``ivf_tpu/api.py:1240-1246``)."""
    vid = rec["video_id"]
    name = f"{vid}g_{rec['pred_class']}_gs{rec['original_score_guess']:5.4f}_cs{rec['original_score_true']:5.4f}"
    return save_dir / "cam_saved_images" / str(rec["true_class"]) / name / "combined"


def _clip_artifacts_ok(folder: Path, rec: dict, frames: int, gradcam: bool, kth: bool) -> dict:
    """Which of a clip's artifacts are as the JAX package writes them: the
    folder; both ClassScore files, parsed back to the record's scores;
    with ``gradcam`` the ``frames`` JPEGs and the GIF of as many frames (the
    reverse pass overwrote the freeze pass's) and, per perturbation,
    ``frames`` strip PNGs and the MASKVALS file; with ``kth`` the
    PerturbImgs PNGs and their mask file."""
    from PIL import Image

    vid = rec["video_id"]
    ok = {"folder": folder.is_dir()}
    ok["class_scores"] = ok["folder"] and all(
        (folder / f"ClassScore{n}case{vid}.txt").is_file()
        and float((folder / f"ClassScore{n}case{vid}.txt").read_text()) == rec[k]
        for n, k in (("Freeze", "freeze_score"), ("Reverse", "reverse_score")))
    if gradcam:
        ok["jpegs"] = sorted(p.name for p in folder.glob("img*.jpg")) == [
            "img%02d.jpg" % (i + 1) for i in range(frames)]
        gif = folder / "mygif.gif"
        ok["gif"] = gif.is_file() and Image.open(gif).n_frames == frames
        ok["strips"] = all(
            all((folder / f"case{p}{vid}_{i}.png").is_file() for i in range(frames))
            and (folder / f"MASKVALScase{p}{vid}.txt").is_file() for p in ("freeze", "reverse"))
    if kth:
        pert = folder / "PerturbImgs"
        ok["perturb_imgs"] = all((pert / f"case{vid}pert{i}.png").is_file() for i in range(frames)) and (
            pert / f"case{vid}.txt").is_file()
    return ok


def _tree_size(root: Path) -> tuple:
    files = [p for p in root.rglob("*") if p.is_file()]
    return len(files), sum(p.stat().st_size for p in files)


def phase_artifacts(api, counters, failures, card: str, weights: dict, clstm_weights: dict) -> None:
    """``find_masks(..., save_viz=True)``: i3d_smth at full width on the
    bf16 kernel route, ``ART_CLIPS`` clips in loader batches of
    ``ART_BATCH`` (two flushes: the first flush's rendering overlaps the
    second's search), 10 steps, Grad-CAM on; then the clstm_kth ConvLSTM
    with the gate kernel on ``ART_CLSTM_CLIPS`` clips (a KTH run: the
    PerturbImgs too). Each run beside the same run with ``save_viz=False``
    (its bits must be equal), every launch counter set to 0 before a run
    and read after; per clip the artifacts of ``_clip_artifacts_ok``; every
    journaled id has its folder; wall time and the writer's wait with and
    without viz."""
    import numpy as np

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    t_phase = time.perf_counter()
    checks = {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"artifacts {label}: {detail}")
        return bool(ok)

    def i3d_config(out_dir, name):
        cfg = Config()
        cfg.output_dir, cfg.model_name = out_dir, name
        cfg.data.batch_size, cfg.mask.opt_iter = ART_BATCH, STEPS
        for key, value in BF16_ROUTES["bf16_kernels"].items():
            setattr(cfg.model, key, value)
        return cfg

    def clstm_config(out_dir, name):
        cfg = _clstm_cfg(True, out_dir, name)
        cfg.data.batch_size = ART_CLSTM_CLIPS
        return cfg

    models = (
        ("i3d", i3d_config, SyntheticClips(ART_CLIPS, CLIP_T, CLIP_HW, CLASSES, seed=9, lazy=False), weights,
         CLIP_T, BF16_ROUTE_KERNELS["bf16_kernels"], False),
        ("clstm_kth", clstm_config, _clstm_clips()[:ART_CLSTM_CLIPS], clstm_weights, CLSTM_T,
         ("lstm_gates_fwd", "lstm_gates_bwd"), True),
    )
    with tempfile.TemporaryDirectory() as out_dir, _writer_waits(api) as waits:
        for model, config, dataset, w, frames, mine, kth in models:
            runs = {}
            for viz in (True, False):
                name = f"{model}_viz{int(viz)}"
                waits.clear()
                r = _find_masks_run(api, counters, out_dir, "", {}, w, dataset, cfg=config(out_dir, name),
                                    save_viz=viz)
                r["writer_wait"] = sum(waits)
                runs[viz] = r
            on, off = runs[True], runs[False]
            save_dir = Path(out_dir) / f"{model}_viz1"
            per_clip = {rec["video_id"]: _clip_artifacts_ok(_clip_folder(save_dir, rec), rec, frames, True, kth)
                        for rec in on["tm"]}
            journaled = api._EmissionJournal.load(str(save_dir / "results" / "emission_journal.p"))
            by_id = {rec["video_id"]: rec for rec in on["tm"]}
            n_files, n_bytes = _tree_size(save_dir / "cam_saved_images")
            launches = on["launches"]
            checks[f"{model}_clips"] = require(model, len(on["tm"]) == len(dataset), len(on["tm"]))
            checks[f"{model}_artifacts"] = require(
                model, all(all(ok.values()) for ok in per_clip.values()),
                {vid: ok for vid, ok in per_clip.items() if not all(ok.values())})
            checks[f"{model}_journaled_have_folders"] = require(
                model, set(journaled) == set(by_id) and all(
                    _clip_folder(save_dir, by_id[vid]).is_dir() for vid in journaled), sorted(journaled))
            checks[f"{model}_no_viz_tree"] = require(
                model, not (Path(out_dir) / f"{model}_viz0" / "cam_saved_images").exists(), "save_viz=False wrote")
            checks[f"{model}_equal_bits"] = require(model, _same_bits_by_id(on, off), "save_viz changed the bits")
            checks[f"{model}_kernels"] = require(model, all(launches[n] > 0 for n in mine) and not any(
                launches[n] for n in launches if n not in mine), launches)
            emit({"phase": "artifacts", "model": model, "card": card, "clips": len(dataset),
                  "batch": config("", "").data.batch_size, "steps": STEPS, "frames": frames,
                  "files": n_files, "bytes": n_bytes, "launches": launches,
                  "wall_seconds_viz_on_off": [on["wall"], off["wall"]],
                  "writer_close_wait_seconds_viz_on_off": [on["writer_wait"], off["writer_wait"]],
                  "search_seconds_viz_on_off": [on["stats"]["search_seconds"], off["stats"]["search_seconds"]],
                  "mask_steps_per_s_viz_on_off": [on["rate"], off["rate"]]})
            masks = on["masks"]
            if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1
                    and np.isfinite(on["cams"]).all()):
                failures.append(f"artifacts {model}: masks not finite in [0, 1] or CAMs not finite")
    emit({"phase": "artifacts_compare", "card": card, **checks, "phase_seconds": time.perf_counter() - t_phase,
          "required": "every check true"})


# the pool_impls phase: every pool impl of the JAX package (ivf_tpu/config.py:84-89)
POOL_IMPL_NAMES = ("reduce_window", "argmax", "shift", "eqbwd", "argmax_full", "argmax_shift")
POOL_IMPL_FLAGS = {"use_pallas": True, "pallas_pool": False}  # pool_impl reaches the branch-3 pools
POOL_IMPL_STEP_BATCHES = (BATCH,)  # 128 clips too before the smoke's time ran short


def phase_pool_impls(api, counters, failures, card: str, weights: dict) -> None:
    """Every ``pool_impl`` at full width (i3d_smth, 4 clips, 10 steps,
    ``use_pallas`` on and ``pallas_pool`` off, so the pool impl reaches the
    branch-3 pools too), in float32 and in bfloat16, each ``find_masks`` run
    twice (every launch counter set to 0 before a run and read after):
    masks finite in [0, 1], equal bits run to run, masks within
    ``MASK_TOL`` of ``reduce_window``'s in the same dtype (another tie rule
    only), and in float32 ``argmax_full`` bit-equal to ``reduce_window``
    and ``argmax_shift`` to ``shift`` (the argmax routes act in 16 bits
    only). A bf16 ``reduce_window`` run bypasses ``_bf16_argmax_upgrade``,
    which would make it ``argmax``. Then device ms per search step of every
    bf16 impl at batch 4 and at bench.py's 128, with peak memory."""
    from unittest import mock

    import numpy as np

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    t_phase = time.perf_counter()
    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    runs, checks = {}, {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"pool_impls {label}: {detail}")
        return bool(ok)

    with tempfile.TemporaryDirectory() as out_dir:
        for dtype in ("float32", "bfloat16"):
            pw = "pointwise_conv" if dtype == "float32" else "pointwise_conv_bf16"
            for impl in POOL_IMPL_NAMES:
                label = f"{dtype}_{impl}"
                flags = dict(POOL_IMPL_FLAGS, compute_dtype=dtype, pool_impl=impl)
                keep = impl == "reduce_window" and dtype == "bfloat16"
                pair = []
                for rep in range(2):
                    with mock.patch.object(api, "_bf16_argmax_upgrade", lambda cfg: cfg) if keep \
                            else contextlib.nullcontext():
                        r = _find_masks_run(api, counters, out_dir, f"pool_{label}_{rep}", flags, weights, dataset)
                    _check_outputs(f"pool_impls {label}", r, failures)
                    pair.append(r)
                runs[label] = a = pair[0]
                launches = a["launches"]
                argmax = dtype == "bfloat16" and impl.startswith("argmax")
                mine = (pw, *ARGMAX_COUNTERS) if argmax else (pw,)
                checks[f"{label}_repeats"] = require(label, _equal_bits(*pair), "two runs differ")
                checks[f"{label}_kernels"] = require(label, all(launches[n] > 0 for n in mine) and not any(
                    launches[n] for n in launches if n not in mine), launches)
                emit({"phase": "pool_impls", "impl": impl, "dtype": dtype, "flags": flags, "card": card,
                      "clips": BATCH, "steps": STEPS, "launches": launches,
                      "mask_steps_per_s": [r["rate"] for r in pair], "wall_seconds": [r["wall"] for r in pair],
                      "peak_mem_gib": a["peak_gib"], "bf16_argmax_upgrade": "bypassed" if keep else "as find_masks"})
        diffs = {}
        for dtype in ("float32", "bfloat16"):
            ref = runs[f"{dtype}_reduce_window"]
            for impl in POOL_IMPL_NAMES[1:]:
                d = _diffs(runs[f"{dtype}_{impl}"], ref)
                diffs[f"{dtype}_{impl}"] = d
                checks[f"{dtype}_{impl}_within_mask_tol"] = require(
                    f"{dtype}_{impl}", d["max_mask_diff"] <= MASK_TOL, d)
        for impl, same in (("argmax_full", "reduce_window"), ("argmax_shift", "shift")):
            checks[f"float32_{impl}_bits_of_{same}"] = require(
                impl, _equal_bits(runs[f"float32_{impl}"], runs[f"float32_{same}"]), f"float32 bits of {same}")
    emit({"phase": "pool_impls_compare", "card": card, **checks, "vs_reduce_window": diffs, "mask_tol": MASK_TOL,
          "mask_tol_reason": "another tie rule in the pool backward (" + MASK_TOL_REASON + ")",
          "required": "every check true"})
    del runs
    # device time per search step of each bf16 impl at POOL_IMPL_STEP_BATCHES
    models = {}
    for impl in POOL_IMPL_NAMES:
        cfg = Config()
        for key, value in dict(POOL_IMPL_FLAGS, compute_dtype="bfloat16", pool_impl=impl).items():
            setattr(cfg.model, key, value)
        model = api.build_model(cfg, softmax_override=True)  # no upgrade: reduce_window stays
        model.load_state_dict(weights)
        models[impl] = model.requires_grad_(False)
    clips = torch.stack([torch.from_numpy(dataset[i][0]) for i in range(BATCH)]).cuda().float()
    _step_timing("pool_impls_step_timing", models, clips, card, turns=POOL_IMPL_NAMES)
    del models
    torch.cuda.empty_cache()
    emit({"phase": "pool_impls_seconds", "card": card, "phase_seconds": time.perf_counter() - t_phase})


# bench.py's setting (bench.py:44-64, 150-157): 128 clips, 120 steps, bf16,
# s2d stem, folded BN, fused 1x1 trio, targets arange(128) % 174
WHOLE_CLIPS, WHOLE_STEPS, WHOLE_WARMUP_STEPS = 128, 120, 2
# every route at fewer steps (the rates are per step; the default route at
# 60 since the parallel phase: the smoke took 1160 s of its 1200 on a slow
# host with all 120)
WHOLE_ROUTE_STEPS = {"bf16_default": 60, "bf16_default_plain_stem": 30, "bf16_kernels": 30}
WHOLE_ROUTES = {"bf16_default": BF16_ROUTES["bf16_default"], "bf16_kernels": BF16_ROUTES["bf16_kernels"],
                "bf16_default_plain_stem": BF16_ROUTES["bf16_default"]}


def phase_whole_search(api, counters, failures, card: str, weights: dict, routes=tuple(WHOLE_ROUTES)) -> dict:
    """``find_masks`` at bench.py's setting on the default and the kernel
    route, and the default route with the plain stem (or on ``routes``):
    per route a short warm-up run of the same shapes, then the timed run
    (counters set to 0 before it, read after) under a profiler that
    records the card's kernels only. mask-steps/s = clips x steps / search
    seconds (the search and finalize, device synchronized at both ends, as
    ``find_masks`` counts them); device busy share = kernel time over the
    run's wall time (init, Grad-CAM and the wait for the journal's writer
    included); peak memory; the emission journal's bytes and the seconds
    ``find_masks`` waited in the writer's ``close`` (None on a checkout
    without the journal)."""
    import shutil
    from unittest import mock

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(WHOLE_CLIPS, CLIP_T, CLIP_HW, CLASSES, seed=5)  # labels i % 174
    build, masks = api.build_model, {}
    writer = getattr(api, "_AsyncWriter", None)
    with tempfile.TemporaryDirectory() as out_dir, _writer_waits(api) as waits:
        for route in routes:
            flags, steps = WHOLE_ROUTES[route], WHOLE_ROUTE_STEPS.get(route, WHOLE_STEPS)

            def config(steps, name):
                cfg = Config()
                cfg.output_dir, cfg.model_name = out_dir, name
                cfg.data.batch_size, cfg.mask.opt_iter = WHOLE_CLIPS, steps
                cfg.mask.grad_cam_type = "true"  # targets: the labels, arange(128) % 174
                for key, value in flags.items():
                    setattr(cfg.model, key, value)
                return cfg

            s2d = not route.endswith("_plain_stem")
            with mock.patch.object(api, "build_model", lambda *a, **k: _stem(build(*a, **k), s2d)):
                _find_masks_run(api, {}, out_dir, "", {}, weights, dataset, WHOLE_CLIPS, WHOLE_WARMUP_STEPS,
                                cfg=config(WHOLE_WARMUP_STEPS, f"warm_{route}"))
                waits.clear()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    r = _find_masks_run(api, counters, out_dir, "", {}, weights, dataset, WHOLE_CLIPS,
                                        steps, cfg=config(steps, f"whole_{route}"))
            journal = Path(out_dir) / f"whole_{route}" / "results" / "emission_journal.p"
            journal_bytes = journal.stat().st_size if writer is not None else None
            for name in (f"warm_{route}", f"whole_{route}"):
                shutil.rmtree(Path(out_dir) / name)
            t0 = time.perf_counter()
            device_ms_run = sum((getattr(ev, "self_device_time_total", 0) or 0) / 1e3
                                for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)
            st = r["stats"]
            emit({"phase": "whole_search", "route": route, "stem_s2d": s2d, "flags": flags, "card": card,
                  "clips": WHOLE_CLIPS, "steps": steps, "mask_steps_per_s": r["rate"],
                  "search_seconds": st["search_seconds"], "init_seconds": st["init_seconds"],
                  "wall_seconds": r["wall"], "device_ms_run": device_ms_run,
                  "device_busy_share": device_ms_run / 1e3 / r["wall"], "peak_mem_gib": r["peak_gib"],
                  "launches": r["launches"], "profile_read_seconds": time.perf_counter() - t0,
                  "journal_bytes": journal_bytes, "writer_close_wait_seconds": sum(waits) if writer else None,
                  "profiled": "CUDA activity only"})
            _check_outputs(f"whole_search {route}", r, failures, batch=WHOLE_CLIPS)
            if st["n_steps_run"] != [steps] * WHOLE_CLIPS:
                failures.append(f"whole_search {route}: steps run {sorted(set(st['n_steps_run']))}")
            mine = BF16_ROUTE_KERNELS[route.replace("_plain_stem", "")]
            launches = r["launches"]
            if not (all(launches[n] > 0 for n in mine) and not any(launches[n] for n in launches if n not in mine)):
                failures.append(f"whole_search {route}: launches {launches}")
            masks[route] = r["masks"]
            del r, prof
            torch.cuda.empty_cache()
    emit({"phase": "whole_search_compare", "card": card, **{
        f"max_mask_diff_{a}_vs_{b}": float(np.abs(masks[a] - masks[b]).max())
        for a, b in (("bf16_kernels", "bf16_default"), ("bf16_default_plain_stem", "bf16_default"))
        if a in masks and b in masks}})


def whole_compare(other: str) -> int:
    """``python3 chip_smoke.py --whole-compare DIR``: ``phase_whole_search``
    on the bf16 default route with the ``ivf_tpu_torch`` of the checkout in
    DIR (say, the parent commit's) and of this one, in turns (``_turns``):
    each turn's mask-steps/s, wall, device busy share, journal bytes and
    writer wait, and each side's mean."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    emit({"phase": "whole_compare", "other": str(Path(other).resolve()), "nvidia_smi": nvidia_smi()})
    sides = _turns(other, "--whole-rows", lambda r: r["route"] if r.get("phase") == "whole_search" else None)
    if sides is None:
        return 1
    fields = ("mask_steps_per_s", "search_seconds", "wall_seconds", "device_busy_share", "peak_mem_gib",
              "journal_bytes", "writer_close_wait_seconds")
    for side, turns in sides.items():
        rows = [t["bf16_default"] for t in turns]
        emit({"phase": "whole_compare", "side": side, "route": "bf16_default",
              **{f: [r[f] for r in rows] for f in fields},
              **{f"mean_{f}": sum(r[f] for r in rows) / len(rows) for f in fields if rows[0][f] is not None}})
    return 0


def whole_rows(root: str) -> int:
    """The child of ``whole_compare``: ``phase_whole_search`` on the bf16
    default route with the ``ivf_tpu_torch`` of the checkout at ``root``."""
    sys.path.insert(0, str(Path(root).resolve()))
    from ivf_tpu_torch import api
    from ivf_tpu_torch.config import Config

    failures: list = []
    phase_whole_search(api, launch_counters(), failures, nvidia_smi(), _scaled_weights(Config(), api),
                       routes=("bf16_default",))
    for f in failures:
        print(f"chip_smoke FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


# the training phases: the presets' batch of clips at full width, the
# steps of each check, and the I3D routes (the search's f32 and bf16
# routes; bf16 runs take the argmax pool where the kernels do not)
TRAIN_BATCH, TRAIN_BITS_STEPS, TRAIN_FALL_STEPS, TRAIN_TIMED_FROM = 16, 3, 20, 10
TRAIN_TREE = {"train": 48, "validation": 16}  # generated smth clips: 3 / 1 batches
TRAIN_DEVICE = "cuda"
TRAIN_I3D_ROUTES = {
    "f32_plain": {}, "f32_kernels": dict(use_pallas=True, pallas_pool=True),
    "bf16_default": dict(compute_dtype="bfloat16"),
    "bf16_kernels": dict(compute_dtype="bfloat16", use_pallas=True, pallas_pool=True),
}
TRAIN_I3D_KERNELS = {
    "f32_plain": (), "f32_kernels": ("pointwise_conv", "maxpool3d_s1_fwd", "maxpool3d_s1_bwd"),
    "bf16_default": ARGMAX_COUNTERS, "bf16_kernels": BF16_KERNEL_COUNTERS,
}
# kernel route against the plain route with the pool kernels' every-tie
# rule (pool_impl 'eqbwd', the same rule in PyTorch): one step from one
# state, gradients read as p - p_new of SGD with lr 1
TRAIN_TIE_PAIRS = {"f32": ("f32_kernels", dict(pool_impl="eqbwd")),
                   "bf16": ("bf16_kernels", dict(compute_dtype="bfloat16", pool_impl="eqbwd"))}
TRAIN_F32_TOL = {"loss_rel": 1e-5, "grad_gap": 1e-3, "stats": 1e-4}
TRAIN_BF16_TOL = {"loss_rel": 1e-3, "grad_gap": 0.03, "stats": 1e-3}
TRAIN_TOL_REASON = (
    "float32: the same sums in another order (the pointwise GEMM against cuDNN's 1x1x1 convs, the "
    "pool kernel's every-tie sums against eqbwd's), through training BN (read on this card: 1.2e-6; "
    "CPU against JAX at 8x32x32, where BN sees 4 values: 5.4e-4 on the kernel route, "
    "tests/test_torch_train_kernels.py); bfloat16: both routes round every activation and gradient to "
    "bf16 at other points (the pool kernel sums centre first and rounds once, eqbwd rounds each add; "
    "the GEMM rounds once per output): read 1.8% on this card at batch 16, loss and BN statistics "
    "equal. The control below (TRAIN_CONTROL: one block's cotangent 10% off) must read above the "
    "limit, so the limit sees a 10% error in one block's dx"
)
# the control of each kernel-vs-plain gap: the plain step again with one
# module's output cotangent scaled by TRAIN_CONTROL_SCALE (a 10% error in
# the dx that reaches everything before it); it must read above the limit
TRAIN_CONTROL = {"i3d": "Mixed_4b", "clstm": "clstm.cells.0"}
TRAIN_CONTROL_SCALE = 0.9
# the bf16 default route against the same route with the argmax pair's
# plain versions swapped in: the pair is bit-equal to them (bf16_kernel_check),
# and nothing else differs, so the step's bits must be equal
TRAIN_EQUAL_TOL = {"loss_rel": 0.0, "grad_gap": 0.0, "stats": 0.0}
TRAIN_BF16_LOSS_TOL = 0.02  # relative, bf16 first loss against f32's from one state and batch
TRAIN_BF16_LOSS_REASON = (
    "one bf16 forward of I3D at batch 16: the loss of 174-way logits from bf16 activations "
    "(CPU, the preset's seeded weights at 4x16x224x224: 1.4e-4; JAX's own bf16 loss 0.8% from "
    "float32 at 8x32x32, where training BN sees few values, tests/test_torch_train.py)"
)
TRAIN_CLSTM_ROUTES = {
    "f32_gate_kernel": dict(use_pallas=True), "f32_plain": {},
    "bf16_gate_kernel": dict(use_pallas=True, compute_dtype="bfloat16"),
    "bf16_plain": dict(compute_dtype="bfloat16"),
}
# the gate entries a train step launches: in bf16 the all-bf16 pair (the
# step casts the clips, so the state is bf16)
CLSTM_GATES = {"float32": ("lstm_gates_fwd", "lstm_gates_bwd"), "bfloat16": BF16S_GATE_COUNTERS}
CLSTM_KERNEL_L2 = 0.01  # the TF presets' Keras l2 (config_clstm_kth_records.py)
TRAIN_CLSTM_F32_TOL = {"loss_rel": 1e-6, "grad_gap": 1e-4, "stats": 1e-6}
TRAIN_CLSTM_BF16_TOL = {"loss_rel": 1e-3, "grad_gap": 0.02, "stats": 1e-3}
TRAIN_CLSTM_TOL_REASON = (
    "float32: the gate kernel and the plain gate block differ by rounding only (read on this card: "
    "2.8e-7; CPU against JAX's Pallas gate route: gradients 1.3e-6, tests/test_torch_train_kernels.py); "
    "bfloat16: the same forward roundings, another backward (per-op bf16 rounding in the kernel "
    "against autograd through the plain version's casts): read 0.97% on this card, loss and BN "
    "statistics equal; the control (layer 1's h cotangent 10% off) must read above the limit"
)
RECORDS_SUBJECTS, RECORDS_PER_SUBJECT, RECORDS_STEPS = tuple(range(17, 26)), 2, 10


@contextmanager
def _argmax_plain():
    """The argmax pair's plain versions in place of its CUDA wrappers, on
    CUDA tensors: the bf16 default route's step with nothing else changed."""
    from unittest import mock

    from ivf_tpu_torch.ops.kernels import argmax_pool as ap

    with mock.patch.object(ap, "argmax_pool_fwd_cuda", lambda x, tile=None: ap.argmax_pool_fwd_plain(x)), \
            mock.patch.object(ap, "argmax_pool_bwd_cuda", lambda idx, g, tile=None: ap.argmax_pool_bwd_plain(idx, g)):
        yield


# the training path's 1x1x1 convs at batch 16 (site, N, Cin, Cout, bias):
# BN unfolded, so the kernel runs with no bias and no ReLU (the trunk),
# the logits head with its bias; and the gate block at config_clstm_kth's
# two layers (16 clips, 4 hidden units, the x- and h-gates merged)
PW_TRAIN = (
    ("Conv3d_2b", 401408, 64, 64, False), ("Mixed_3b_b1a", 100352, 192, 96, False),
    ("Mixed_4b_b0", 12544, 480, 192, False), ("Mixed_5c_b0", 1568, 832, 384, False),
    ("logits", 16, 1024, 174, True),
)
GATES_TRAIN = (("layer1", (CLSTM_BATCH, 60, 80)), ("layer2", (CLSTM_BATCH, 15, 20)))
TRAIN_KERNEL_TOL_REASON = (
    "y and dx: the kernel against its plain version on the same inputs, float32 within 1e-5 and "
    "bfloat16 within one bf16 ulp (2**-7) of the largest value (the GEMM and the plain product "
    "round once per output, summing in another order); dW and db: plain float32 sums rounded once "
    "to the weight's dtype, against a float64 product, within 1e-4 (f32) or one bf16 ulp (bf16) of "
    "the largest value; the gates: h', c', dc within 1e-6 of max(1, largest) with a float32 state "
    "and dz within 1e-6 (f32) or one bf16 ulp (bf16 gates) of max(1, largest); with a bf16 state "
    "(the bf16 train step's) h', c', dc and dz bit for bit"
)


def phase_train_kernel_check(pw, gates, failures, card: str) -> None:
    """The kernel calls of the training path, wrapper against plain on the
    card at the shapes the train steps give them, in both dtypes:
    ``pointwise_conv`` as ``Unit3D`` calls it in training (the column-major
    view of a (Cout, Cin) weight, ``relu=False``, no bias in the trunk)
    under autograd, y and dx through the kernel (two launches) and dW / db
    as plain products; ``gate_math`` under autograd at both clstm_kth
    layers (one launch each way), float32, bf16 gates with a float32
    state (the search's), and all bf16 (the bf16 train step's).
    Tolerances: ``TRAIN_KERNEL_TOL_REASON``.
    These launches are outside the main path's counting."""
    from ivf_tpu_torch.precision import reference_numerics

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(7)
    rows, ok = [], True
    for dtype in (torch.float32, torch.bfloat16):
        ulp = 1e-5 if dtype == torch.float32 else 2.0**-7
        ulp_w = 1e-4 if dtype == torch.float32 else 2.0**-7
        counter = pw.pointwise_conv_bf16_cuda if dtype == torch.bfloat16 else pw.pointwise_conv_cuda
        for site, n, cin, cout, use_bias in PW_TRAIN:
            x = torch.randn(n, cin, generator=gen).to(dtype).to(dev)
            weight = (torch.randn(cout, cin, generator=gen) / cin**0.5).to(dtype).to(dev).requires_grad_(True)
            bias = torch.randn(cout, generator=gen).to(dtype).to(dev).requires_grad_(True) if use_bias else None
            g = torch.randn(n, cout, generator=gen).to(dtype).to(dev)
            xr = x.clone().requires_grad_(True)
            before = counter.launches
            with reference_numerics():
                y = pw.pointwise_conv(xr, weight.t(), bias, relu=False)
                grads = torch.autograd.grad(y, [xr, weight] + ([bias] if use_bias else []), g)
                torch.cuda.synchronize()
                launches = counter.launches - before
                y_ref = pw.pointwise_conv_plain(x, weight.detach().t().contiguous(), bias, False)
                dx_ref = pw.pointwise_conv_plain(g, weight.detach(), None, False)
            dw_ref = g.double().t() @ x.double()

            def rel(a, ref):
                return (a.double() - ref.double()).abs().max().item() / ref.double().abs().max().item()

            errs = {"y": (rel(y, y_ref), ulp), "dx": (rel(grads[0], dx_ref), ulp), "dW": (rel(grads[1], dw_ref), ulp_w)}
            if use_bias:
                errs["db"] = (rel(grads[2], g.double().sum(0)), ulp_w)
            good = launches == 2 and all(e <= t for e, t in errs.values())
            ok &= good
            rows.append({"kernel": "pointwise_conv", "site": site, "dtype": str(dtype).split(".")[-1],
                         "shape": [n, cin, cout], "bias": use_bias, "launches": launches,
                         "err_over_max": {k: e for k, (e, _) in errs.items()},
                         "tol": {k: t for k, (_, t) in errs.items()}, "ok": good})
    gate_entries = {
        (torch.float32, torch.float32): (gates.lstm_gates_fwd_cuda, gates.lstm_gates_bwd_cuda),
        (torch.bfloat16, torch.float32): (gates.lstm_gates_fwd_bf16_cuda, gates.lstm_gates_bwd_bf16_cuda),
        (torch.bfloat16, torch.bfloat16): (gates.lstm_gates_fwd_bf16s_cuda, gates.lstm_gates_bwd_bf16s_cuda),
    }
    for (gate_dtype, state_dtype), (fwd, bwd) in gate_entries.items():
        for site, lead in GATES_TRAIN:
            z = (torch.randn(*lead, 16, generator=gen) * 3).to(gate_dtype).to(dev).requires_grad_(True)
            c = torch.randn(*lead, 4, generator=gen).to(state_dtype).to(dev).requires_grad_(True)
            dh, dc_out = (torch.randn(*lead, 4, generator=gen).to(state_dtype).to(dev) for _ in range(2))
            before = (fwd.launches, bwd.launches)
            h_new, c_new = gates.gate_math(z, None, c)
            dz, dc = torch.autograd.grad((h_new, c_new), (z, c), (dh, dc_out))
            torch.cuda.synchronize()
            launches = (fwd.launches - before[0], bwd.launches - before[1])
            h_ref, c_ref = gates.gate_math_plain(z.detach(), None, c.detach())
            dz_ref, dc_ref = gates.gate_math_bwd_plain(z.detach(), None, c.detach(), dh, dc_out)

            def err(a, ref):
                return (a.detach().float() - ref.float()).abs().max().item() / max(1.0, ref.float().abs().max().item())

            all_bf16 = state_dtype == torch.bfloat16  # bit for bit: every op rounded at the same points
            tol_z = 0.0 if all_bf16 else 2.0**-7 if gate_dtype == torch.bfloat16 else 1e-6
            tol_s = 0.0 if all_bf16 else 1e-6
            errs = {"h": (err(h_new, h_ref), tol_s), "c": (err(c_new, c_ref), tol_s),
                    "dc": (err(dc, dc_ref), tol_s), "dz": (err(dz, dz_ref), tol_z)}
            good = launches == (1, 1) and all(e <= t for e, t in errs.values())
            if all_bf16:
                good &= all(torch.equal(a.detach().view(torch.int16), r.view(torch.int16))
                            for a, r in ((h_new, h_ref), (c_new, c_ref), (dc, dc_ref), (dz, dz_ref)))
            ok &= good
            rows.append({"kernel": "gate_math", "site": site, "gates": str(gate_dtype).split(".")[-1],
                         "state": str(state_dtype).split(".")[-1],
                         "shape": [*lead, 16], "launches": list(launches),
                         "err_over_max": {k: e for k, (e, _) in errs.items()},
                         "tol": {k: t for k, (_, t) in errs.items()}, "ok": good})
    emit({"phase": "train_kernel_check", "card": card, "rows": rows, "tol_reason": TRAIN_KERNEL_TOL_REASON})
    if not ok:
        failures.append(f"train_kernel_check: {[r for r in rows if not r['ok']]}")


def _train_preset(api, name: str, out_dir: str, run_name: str, **fields):
    """A preset of ``configs/`` as loaded, its run named, ``fields`` set on
    the model (or optimizer) config, and the bf16 argmax upgrade applied
    as ``api.train`` applies it."""
    from ivf_tpu_torch.config import Config

    cfg = Config.load(str(Path(__file__).resolve().parent / "configs" / name))
    cfg.output_dir, cfg.model_name = out_dir, run_name
    for key, value in fields.items():
        setattr(cfg.model if hasattr(cfg.model, key) else cfg.optim, key, value)
    return api._bf16_argmax_upgrade(cfg)


def _train_state(api, cfg, sgd1: bool = False):
    """The preset's seeded float32 master model on the card with its
    optimizer, or plain SGD with lr 1 (its update is minus the gradient)."""
    from ivf_tpu_torch.train import build_optimizer

    tx = build_optimizer("sgd", 1.0, momentum=0.0) if sgd1 else None
    return api._train_state(cfg, TRAIN_DEVICE, tx=tx)


def _state_bits(state) -> dict:
    return {n: t.detach().clone() for n, t in state.model.state_dict().items()}


def _same_state(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[n], b[n]) for n in a)


def _scale_cotangent(module: torch.nn.Module, scale: float) -> None:
    """Scale the cotangent of ``module``'s output (the first tensor of a
    tuple) by ``scale`` at every call: the control's fault."""

    def hook(mod, args, out):
        (out[0] if isinstance(out, tuple) else out).register_hook(lambda g: g * scale)

    module.register_forward_hook(hook)


def _sgd1_step(api, cfg, clips, labels, control: str = None) -> dict:
    """One step with SGD lr 1: the loss, every parameter's gradient (p -
    p_new) and the BN statistics after it. ``control`` names a module
    whose output cotangent is scaled by ``TRAIN_CONTROL_SCALE``."""
    from ivf_tpu_torch.train import make_train_step

    state = _train_state(api, cfg, sgd1=True)
    if control:
        _scale_cotangent(state.model.get_submodule(control), TRAIN_CONTROL_SCALE)
    before = {n: p.detach().clone() for n, p in state.params().items()}
    step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype)
    state, metrics = step(state, clips, labels)
    grads = {n: before[n] - p.detach() for n, p in state.params().items()}
    return {"loss": float(metrics["loss"]), "grads": grads, "stats": _state_bits(state)}


def _clip_cast_keeps_bits(api, cfg, clips) -> bool:
    """One bf16 training forward and backward of the preset's seeded model
    on uint8 clips as float32 (what the train step fed the model before
    it cast the clips) and as bf16 (what it feeds it now), dropout drawn
    from one step's generator: equal logits, gradients and BN
    statistics."""
    from ivf_tpu_torch.models.layers import set_dropout_generator
    from ivf_tpu_torch.train.state import step_generator

    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        model = _train_state(api, cfg).model.train()
        set_dropout_generator(model, step_generator(0, 0, clips.device))
        params = dict(model.named_parameters())
        compute = {n: p.to(torch.bfloat16) for n, p in params.items()}
        logits = torch.func.functional_call(model, compute, (clips.to(dtype),), strict=False)
        grads = torch.autograd.grad(logits.float().logsumexp(-1).sum(), list(params.values()))
        runs.append([logits.detach(), *grads, *(b.clone() for b in model.buffers())])
        del model, params, compute, logits, grads
    return all(torch.equal(a, b) for a, b in zip(*runs))


def _step_gap(a: dict, b: dict, names=None) -> dict:
    """Loss, gradient (relative L2 as one vector, and the largest error
    over the largest gradient) and BN-statistic distances of two steps."""
    names = names or list(a["grads"])
    num = sum(float(((a["grads"][n].double() - b["grads"][n].double()) ** 2).sum()) for n in names)
    den = sum(float((b["grads"][n].double() ** 2).sum()) for n in names)
    scale = max(float(b["grads"][n].abs().max()) for n in names)
    stat_names = [n for n in a["stats"] if n.endswith(("running_mean", "running_var"))]
    return {
        "loss_rel_diff": abs(a["loss"] - b["loss"]) / abs(b["loss"]),
        "grad_gap": (num / den) ** 0.5 if den else 0.0,
        "grad_max_err_over_max": max(float((a["grads"][n] - b["grads"][n]).abs().max()) for n in names) / scale,
        "stats_max_diff": max((float((a["stats"][n] - b["stats"][n]).abs().max()) for n in stat_names),
                              default=0.0),
    }


def _within(gap: dict, tol: dict) -> bool:
    return (gap["loss_rel_diff"] <= tol["loss_rel"] and gap["grad_gap"] <= tol["grad_gap"]
            and gap["stats_max_diff"] <= tol["stats"])


def _train_profile(step_fn) -> dict:
    """One profiled train step (CUDA activity): device ms by kernel group,
    kernels and the step's peak device memory."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    groups, top, n_kernels = {}, [], 0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us <= 0 or ev.device_type != DeviceType.CUDA:
            continue
        groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + dev_us / 1e3
        top.append((dev_us / 1e3, ev.count, ev.key[:110]))
        n_kernels += ev.count
    return {"device_ms": sum(groups.values()), "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
            "kernels_per_step": n_kernels, "top_kernels": [list(t) for t in sorted(top, reverse=True)[:8]],
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def _route_run(api, counters, cfg, clips, labels) -> dict:
    """``TRAIN_FALL_STEPS`` steps of the preset's optimizer on one fixed
    batch (the state after ``TRAIN_BITS_STEPS`` kept, the steps from
    ``TRAIN_TIMED_FROM`` timed), then a profiled step with the launch
    counters set to 0 just before it and read just after: the losses,
    the wall ms per step, the launches and the profile of one step."""
    from ivf_tpu_torch.train import make_train_step

    state = _train_state(api, cfg)
    step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype)
    losses, snapshot = [], None
    torch.cuda.synchronize()
    t0 = None
    for k in range(TRAIN_FALL_STEPS):
        if k == TRAIN_TIMED_FROM:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, metrics = step(state, clips, labels)
        losses.append(metrics["loss"])
        if k + 1 == TRAIN_BITS_STEPS:
            snapshot = (_state_bits(state), [float(x) for x in losses])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / (TRAIN_FALL_STEPS - TRAIN_TIMED_FROM) * 1e3
    for fn in counters.values():
        fn.launches = 0
    prof = _train_profile(lambda: step(state, clips, labels))
    launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
    return {"losses": [float(x) for x in losses], "snapshot": snapshot, "wall_ms": wall_ms,
            "launches_per_step": launches, "state": state, **prof}


def _bits_run(api, cfg, clips, labels) -> tuple:
    """A second run of ``TRAIN_BITS_STEPS`` steps from a fresh state."""
    from ivf_tpu_torch.train import make_train_step

    state = _train_state(api, cfg)
    step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype)
    losses = []
    for _ in range(TRAIN_BITS_STEPS):
        state, metrics = step(state, clips, labels)
        losses.append(metrics["loss"])
    return _state_bits(state), [float(x) for x in losses]


def _emit_route(phase: str, route: str, r: dict, card: str, clips: int, extra: dict) -> dict:
    losses = r["losses"]
    falls = min(losses[-5:]) < losses[0]
    row = {"phase": phase, "route": route, "card": card, "batch": clips,
           "first_loss": losses[0], "last_losses": losses[-5:], "loss_falls": falls,
           "wall_ms_per_step": r["wall_ms"], "train_clips_per_s": clips / r["wall_ms"] * 1e3,
           "device_ms_per_step": r["device_ms"], "device_busy_share": r["device_ms"] / r["wall_ms"],
           "kernels_per_step": r["kernels_per_step"], "launches_per_step": r["launches_per_step"],
           "peak_mem_gib": r["peak_mem_gib"], "groups_ms": r["groups_ms"], "top_kernels": r["top_kernels"],
           **extra}
    emit(row)
    return row


class _FailOnce:
    """A dataset that raises ``OSError`` when item ``fail_at`` is read while
    ``armed``: the interruption of the resume check."""

    def __init__(self, base, fail_at: int):
        self.base, self.fail_at, self.armed = base, fail_at, True

    def __len__(self):
        return len(self.base)

    def _check(self, i):
        if self.armed and i == self.fail_at:
            raise OSError("chip_smoke: the interruption of the resume check")

    def __getitem__(self, i):
        self._check(i)
        return self.base[i]

    def get_payloads(self, i):
        self._check(i)
        return self.base.get_payloads(i)


def phase_train_i3d(api, counters, failures, card: str) -> None:
    """Training of i3d_smth through the port, at full width.

    ``configs/config_i3d_smth.py`` as loaded (174 classes, 16x224x224,
    batch 16, Adam lr 0.008 with decay 1e-5, dropout 0.5), seeded weights,
    synthetic clips; four routes: f32 plain, f32 kernels (``use_pallas`` +
    ``pallas_pool``), bf16 default (argmax pool), bf16 kernels.

    1. One step from one state, each kernel route against the plain route
       with the kernels' every-tie pool rule (``pool_impl='eqbwd'``):
       loss, every gradient, BN statistics within ``TRAIN_*_TOL``, and a
       control (``TRAIN_CONTROL``: one block's cotangent 10% off) above
       the gradient limit. Against the default tie rule the gap is
       reported, not held (the known divergence: the kernels credit every
       tied maximum). The bf16 default route (the argmax pair) against
       the same step with the pair's plain versions: equal bits. Each
       bf16 route's forward and backward on the clips as float32 and as
       bf16 (the train step casts them): equal bits.
    2. Each route run twice for ``TRAIN_BITS_STEPS`` steps: equal bits
       (parameters, BN statistics) and losses.
    3. ``api.train`` on a generated JPEG tree (3 train batches, 1
       validation batch) on the f32 kernel route, its launch counters set
       to 0 just before and read just after: uninterrupted, and cut at its
       third batch (a read that fails) then resumed from its mid-epoch
       checkpoint: equal bits. Then ``infer`` writes its three files, and
       the plain route on the same weights gives the same ``y_hat``.
    4. On one fixed batch the loss falls over ``TRAIN_FALL_STEPS`` steps,
       every route.
    5. bf16 keeps float32 masters and BN statistics; its first loss within
       ``TRAIN_BF16_LOSS_TOL`` of float32's.
    6. Launches per step, steady wall ms and clips/s, device ms by kernel
       group (profiler), peak memory and device busy share per route."""
    import numpy as np

    t_phase = time.perf_counter()
    checks = {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"train_i3d {label}: {detail}")
        checks[label] = bool(ok)

    rng = np.random.RandomState(21)
    clips = torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8))
    clips = clips.to(TRAIN_DEVICE)
    labels = torch.from_numpy((np.arange(TRAIN_BATCH) * 11 % CLASSES).astype(np.int32)).to(TRAIN_DEVICE)
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "out")
        cfg_of = {r: _train_preset(api, "config_i3d_smth.py", out, r, **f) for r, f in TRAIN_I3D_ROUTES.items()}
        # 1. kernel route against plain, one step from one state
        steps = {r: _sgd1_step(api, cfg_of[r], clips, labels) for r in TRAIN_I3D_ROUTES}
        for dt, (route, plain_flags) in TRAIN_TIE_PAIRS.items():
            tie_cfg = _train_preset(api, "config_i3d_smth.py", out, "tie", **plain_flags)
            tie = _sgd1_step(api, tie_cfg, clips, labels)
            gap = _step_gap(steps[route], tie)
            control = _step_gap(_sgd1_step(api, tie_cfg, clips, labels, TRAIN_CONTROL["i3d"]), tie)
            default = "f32_plain" if dt == "f32" else "bf16_default"
            default_gap = _step_gap(steps[route], steps[default])
            tol = TRAIN_F32_TOL if dt == "f32" else TRAIN_BF16_TOL
            emit({"phase": "train_i3d_kernel_vs_plain", "card": card, "dtype": dt, "kernel_route": route,
                  "plain_route": {**plain_flags}, **gap, "tol": tol, "tol_reason": TRAIN_TOL_REASON,
                  "control": {"module": TRAIN_CONTROL["i3d"], "cotangent_scale": TRAIN_CONTROL_SCALE, **control},
                  "vs_default_tie_rule": {"route": default, **default_gap, "held": False}})
            require(f"{dt}_kernel_vs_plain", _within(gap, tol), gap)
            require(f"{dt}_control_above_limit", control["grad_gap"] > tol["grad_gap"], control)
        # the bf16 default route (argmax pair) against its plain versions
        with _argmax_plain():
            plain_argmax = _sgd1_step(api, cfg_of["bf16_default"], clips, labels)
        gap = _step_gap(steps["bf16_default"], plain_argmax)
        emit({"phase": "train_i3d_argmax_vs_plain", "card": card, "route": "bf16_default", **gap,
              "tol": TRAIN_EQUAL_TOL, "tol_reason": "the argmax pair is bit-equal to its plain versions"})
        require("bf16_default_argmax_vs_plain", _within(gap, TRAIN_EQUAL_TOL), gap)
        del steps
        # the bf16 step casts the clips to bf16 (as the JAX package's does):
        # I3D's first conv rounded them to bf16 before, so the bits stay
        for route in ("bf16_default", "bf16_kernels"):
            same = _clip_cast_keeps_bits(api, cfg_of[route], clips)
            emit({"phase": "train_i3d_clip_cast", "card": card, "route": route, "equal_bits": same})
            require(f"{route}_clip_cast_keeps_bits", same, "float32 and bf16 clips gave other bits")
        # 2, 4, 5, 6: per route, a run on one fixed batch and a second short run
        rows = {}
        for route, cfg in cfg_of.items():
            r = _route_run(api, counters, cfg, clips, labels)
            bits, losses = _bits_run(api, cfg, clips, labels)
            equal = _same_state(bits, r["snapshot"][0]) and losses == r["snapshot"][1]
            masters = all(t.dtype == (torch.float32 if t.is_floating_point() else torch.long)
                          for t in r["state"].model.state_dict().values())
            mine = TRAIN_I3D_KERNELS[route]
            launched = r["launches_per_step"]
            rows[route] = _emit_route("train_i3d", route, r, card, TRAIN_BATCH, {
                "flags": TRAIN_I3D_ROUTES[route], "equal_bits_two_runs": equal,
                "float32_masters_and_stats": masters})
            require(f"{route}_equal_bits", equal, "two runs gave other bits")
            require(f"{route}_loss_falls", rows[route]["loss_falls"] and np.isfinite(r["losses"]).all(), r["losses"])
            require(f"{route}_float32_state", masters, "a master or a BN statistic is not float32")
            require(f"{route}_kernels", all(launched.get(n, 0) > 0 for n in mine)
                    and not any(n not in mine for n in launched), launched)
            del r
        f32_first, bf16_first = rows["f32_plain"]["first_loss"], rows["bf16_default"]["first_loss"]
        rel = abs(bf16_first - f32_first) / abs(f32_first)
        emit({"phase": "train_i3d_bf16_vs_f32", "card": card, "f32_first_loss": f32_first,
              "bf16_first_loss": bf16_first, "rel_diff": rel, "tol": TRAIN_BF16_LOSS_TOL,
              "tol_reason": TRAIN_BF16_LOSS_REASON})
        require("bf16_first_loss", rel <= TRAIN_BF16_LOSS_TOL, rel)

        # 3. api.train over a JPEG tree: uninterrupted, cut and resumed; infer
        tree = Path(tmp) / "smth"
        frames = {}
        for split, n in TRAIN_TREE.items():
            for i in range(n):
                frames[tree / split / str(i * 7 % CLASSES) / f"{split}{i:02d}"] = rng.randint(
                    0, 256, (CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8)
        _write_jpegs(frames)

        def tree_cfg(name):
            cfg = _train_preset(api, "config_i3d_smth.py", out, name, **TRAIN_I3D_ROUTES["f32_kernels"])
            cfg.data.data_folder = str(tree)
            cfg.optim.checkpoint_steps, cfg.optim.print_freq = 2, 0
            cfg.async_checkpoint = True
            return cfg

        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state_a, hist_a = api.train(tree_cfg("uninterrupted"))
        torch.cuda.synchronize()
        wall_a = time.perf_counter() - t0
        launches_a = {k: fn.launches for k, fn in counters.items() if fn.launches}
        require("api_train_kernels", all(launches_a.get(n, 0) > 0 for n in TRAIN_I3D_KERNELS["f32_kernels"]),
                launches_a)
        cfg_b = tree_cfg("resumed")
        base = api.build_dataset(cfg_b, "train")
        order = np.arange(len(base))
        np.random.RandomState(cfg_b.seed + 0).shuffle(order)  # epoch 0's order
        flaky = _FailOnce(base, int(order[2 * TRAIN_BATCH]))  # the third batch
        try:
            api.train(cfg_b, train_dataset=flaky)
            interrupted = False
        except OSError:
            interrupted = True
        flaky.armed = False
        state_b, hist_b = api.train(cfg_b, resume=True, train_dataset=flaky)
        bits_equal = _same_state(_state_bits(state_a), _state_bits(state_b))
        require("resume_equal_bits", interrupted and bits_equal and state_a.step == state_b.step,
                (interrupted, bits_equal, state_a.step, state_b.step))
        # infer on the validation tree, the kernel route and the plain one
        res_k = api.infer(tree_cfg("uninterrupted"), state_a)
        files = sorted(p.name for p in (Path(out) / "uninterrupted").glob("y_*.npy"))
        plain_cfg = _train_preset(api, "config_i3d_smth.py", out, "plain_infer")
        plain_cfg.data.data_folder = str(tree)
        _, plain_state = api.init_eval_state(plain_cfg, device=TRAIN_DEVICE)
        plain_state.model.load_state_dict(state_a.model.state_dict())
        res_p = api.infer(plain_cfg, plain_state)
        same = np.array_equal(res_k["y_hat"], res_p["y_hat"]) and np.array_equal(res_k["y_true"], res_p["y_true"])
        require("infer_files", files == ["y_hat.npy", "y_hat_top5.npy", "y_true.npy"], files)
        require("infer_kernel_vs_plain_y_hat", same, (res_k["y_hat"], res_p["y_hat"]))
        emit({"phase": "train_i3d_api", "card": card, "preset": "configs/config_i3d_smth.py",
              "route": "f32_kernels", "tree_clips": TRAIN_TREE, "epochs": len(hist_a),
              "history": hist_a, "wall_seconds": wall_a, "launches_run": launches_a,
              "interrupted": interrupted, "resumed_epochs": [h["epoch"] for h in hist_b],
              "resume_equal_bits": bits_equal, "steps": state_a.step, "infer_files": files,
              "infer_top1": res_k["top1"], "infer_y_hat_equal_plain": same,
              "plain_infer_max_loss_diff": abs(res_k["loss"] - res_p["loss"])})
    emit({"phase": "train_i3d_compare", "card": card, **checks, "phase_seconds": time.perf_counter() - t_phase,
          "required": "every check true"})


def _clstm_train_batches(n: int, seed: int) -> list:
    """``n`` batches of ``CLSTM_BATCH`` seeded uint8 clips of 32x120x160 on
    the card, with labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [
        (torch.from_numpy(rng.randint(0, 256, (CLSTM_BATCH, CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8)).to(TRAIN_DEVICE),
         torch.from_numpy((np.arange(CLSTM_BATCH) % CLSTM_CLASSES).astype(np.int32)).to(TRAIN_DEVICE))
        for _ in range(n)
    ]


def phase_train_clstm(api, counters, failures, card: str) -> None:
    """Training of the clstm_kth ConvLSTM through the port, at full width:
    ``configs/config_clstm_kth.py`` as loaded (2 layers x 4 hidden, stride
    2, shared BN, dropout 0.5, Adam lr 0.008) with ``kernel_l2`` 0.01 on
    the input kernels, 16 seeded clips of 32x120x160; f32 and bf16, with
    the gate kernel and without. Checks: one step from one state, kernel
    against plain; two runs with equal bits; a ``fit`` cut after two of
    three batches and resumed from its mid-epoch checkpoint with the bits
    of an uninterrupted one; the loss falls on one fixed batch; the gate
    kernel's launches per step (64 each way: 2 layers x 32 steps); the
    timings of ``train_i3d``."""
    import numpy as np

    from ivf_tpu_torch.train import fit
    from ivf_tpu_torch.utils.checkpoint import Checkpointer

    t_phase = time.perf_counter()
    checks = {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"train_clstm {label}: {detail}")
        checks[label] = bool(ok)

    (clips, labels), = _clstm_train_batches(1, 31)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_of = {r: _train_preset(api, "config_clstm_kth.py", tmp, r, kernel_l2=CLSTM_KERNEL_L2, **f)
                  for r, f in TRAIN_CLSTM_ROUTES.items()}
        for dt, tol in (("f32", TRAIN_CLSTM_F32_TOL), ("bf16", TRAIN_CLSTM_BF16_TOL)):
            on = _sgd1_step(api, cfg_of[f"{dt}_gate_kernel"], clips, labels)
            off = _sgd1_step(api, cfg_of[f"{dt}_plain"], clips, labels)
            gap = _step_gap(on, off)
            control = _step_gap(_sgd1_step(api, cfg_of[f"{dt}_plain"], clips, labels, TRAIN_CONTROL["clstm"]), off)
            emit({"phase": "train_clstm_kernel_vs_plain", "card": card, "dtype": dt, **gap, "tol": tol,
                  "tol_reason": TRAIN_CLSTM_TOL_REASON,
                  "control": {"module": TRAIN_CONTROL["clstm"], "cotangent_scale": TRAIN_CONTROL_SCALE, **control}})
            require(f"{dt}_kernel_vs_plain", _within(gap, tol), gap)
            require(f"{dt}_control_above_limit", control["grad_gap"] > tol["grad_gap"], control)
        for route, cfg in cfg_of.items():
            r = _route_run(api, counters, cfg, clips, labels)
            bits, losses = _bits_run(api, cfg, clips, labels)
            equal = _same_state(bits, r["snapshot"][0]) and losses == r["snapshot"][1]
            launched = r["launches_per_step"]
            gates = CLSTM_GATES[cfg.model.compute_dtype] if cfg.model.use_pallas else ()
            row = _emit_route("train_clstm", route, r, card, CLSTM_BATCH, {
                "flags": TRAIN_CLSTM_ROUTES[route], "kernel_l2": CLSTM_KERNEL_L2, "equal_bits_two_runs": equal})
            require(f"{route}_equal_bits", equal, "two runs gave other bits")
            require(f"{route}_loss_falls", row["loss_falls"] and np.isfinite(r["losses"]).all(), r["losses"])
            require(f"{route}_gate_launches", all(launched.get(n, 0) == 2 * CLSTM_T for n in gates)
                    and not any(n not in gates for n in launched), launched)
            del r
        # a fit cut mid-epoch and resumed, on the gate-kernel route
        batches, val = _clstm_train_batches(3, 32), _clstm_train_batches(1, 33)
        cfg = cfg_of["f32_gate_kernel"]

        def run_fit(state, loader_fn, ckpt=None, **kw):
            return fit(state, loader_fn, lambda: val, num_epochs=1, kernel_l2=cfg.model.kernel_l2,
                       checkpointer=ckpt, checkpoint_every_steps=2 if ckpt else 0, **kw)

        state_a, _ = run_fit(_train_state(api, cfg), lambda: batches)

        def cut():
            yield from batches[:2]
            raise KeyboardInterrupt("chip_smoke: the interruption of the resume check")

        ckpt = Checkpointer(str(Path(tmp) / "ckpt"), async_save=True)
        try:
            run_fit(_train_state(api, cfg), cut, ckpt)
            interrupted = False
        except KeyboardInterrupt:
            interrupted = True
        state_b, start_epoch, best, offset = ckpt.restore(_train_state(api, cfg))
        state_b, _ = run_fit(state_b, lambda: batches, ckpt, start_epoch=start_epoch, best_loss=best,
                             start_batch_offset=offset)
        equal = _same_state(_state_bits(state_a), _state_bits(state_b))
        require("resume_equal_bits", interrupted and offset == 2 and equal and state_a.step == state_b.step == 3,
                (interrupted, offset, equal, state_a.step, state_b.step))
    emit({"phase": "train_clstm_compare", "card": card, **checks, "phase_seconds": time.perf_counter() - t_phase,
          "required": "every check true"})


def phase_cnn_3d(api, counters, failures, card: str) -> None:
    """``cnn_3d`` (the TF half's plain 3D CNN) at 32x120x160, 16 clips, 6
    classes, Adam, dropout 0.5, f32 and bf16: a train step and an eval
    pass, each run twice: equal bits (state, loss, logits), finite, and
    the step's wall ms; no hand kernel lies on this model's path."""
    import numpy as np

    from ivf_tpu_torch.train import make_eval_step, make_train_step

    t_phase = time.perf_counter()
    (clips, labels), = _clstm_train_batches(1, 41)
    for dtype in ("float32", "bfloat16"):
        runs = []
        for _ in range(2):
            cfg = _train_preset(api, "config_clstm_kth.py", "", "cnn_3d", conv_model="cnn_3d",
                                compute_dtype=dtype)
            state = _train_state(api, cfg)
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = make_train_step(compute_dtype=dtype)(state, clips, labels)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3
            ev = make_eval_step(compute_dtype=dtype)(state, clips, labels)
            runs.append({"bits": _state_bits(state), "loss": float(metrics["loss"]), "logits": ev["logits"],
                         "eval_loss": float(ev["loss"]), "step_ms": step_ms,
                         "launches": sum(fn.launches for fn in counters.values())})
        a, b = runs
        equal = _same_state(a["bits"], b["bits"]) and a["loss"] == b["loss"] and torch.equal(a["logits"], b["logits"])
        finite = bool(np.isfinite(a["loss"]) and torch.isfinite(a["logits"]).all())
        emit({"phase": "cnn_3d", "card": card, "dtype": dtype, "batch": CLSTM_BATCH,
              "clip_shape": [CLSTM_T, *CLSTM_HW, 3], "loss": a["loss"], "eval_loss": a["eval_loss"],
              "step_ms_first_second": [a["step_ms"], b["step_ms"]], "equal_bits_two_runs": equal,
              "finite": finite, "kernel_launches": a["launches"]})
        if not (equal and finite and a["launches"] == 0):
            failures.append(f"cnn_3d {dtype}: equal {equal}, finite {finite}, launches {a['launches']}")
    emit({"phase": "cnn_3d_done", "phase_seconds": time.perf_counter() - t_phase})


def phase_records_search(api, counters, failures, card: str) -> None:
    """``find_masks`` from ``configs/config_clstm_kth_records.py`` (the TF
    family: hard-sigmoid gates, so the gate kernel does not run; 'valid'
    padding, per-layer BN, records with per-subject shards, batch 24,
    ``min_score`` 0.1) on generated shards of the validation subjects
    17-25, ``opt_iter`` 300 -> 10, run twice: equal bits per clip, masks
    and CAMs finite, no kernel launched. The weights are seeded and scaled
    as the clstm_kth phases scale theirs (unit-std gate pre-activations,
    class scores of std 2)."""
    import numpy as np

    from ivf_tpu_torch.data.records import RecordWriter

    t_phase = time.perf_counter()
    rng = np.random.RandomState(51)
    with tempfile.TemporaryDirectory() as tmp:
        folder = Path(tmp) / "records"
        folder.mkdir()
        for s in RECORDS_SUBJECTS:
            with RecordWriter(str(folder / f"kth_subject_{s}.ivfrecords")) as w:
                for k in range(RECORDS_PER_SUBJECT):
                    clip = rng.randint(0, 256, (CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8)
                    w.write(clip, label=(s + k) % CLSTM_CLASSES, video_id=f"person{s}_boxing_d{k + 1}_1",
                            extra={"subject": s})
        runs = []
        for k in range(2):
            cfg = _train_preset(api, "config_clstm_kth_records.py", tmp, f"records_{k}")
            cfg.data.records_folder = str(folder)
            cfg.mask.opt_iter = RECORDS_STEPS
            if k == 0:
                probe = api.build_dataset(cfg, "validation")[0][0]
                weights = _clstm_scaled_weights(api, probe, cfg)
            runs.append(_find_masks_run(api, counters, tmp, "", {}, weights, None, cfg.data.batch_size,
                                        RECORDS_STEPS, cfg=cfg, split="validation"))
        a, b = runs
        equal = _same_bits_by_id(a, b)
        n = len(RECORDS_SUBJECTS) * RECORDS_PER_SUBJECT
        kept = len(a["tm"])
        finite = bool(np.isfinite(a["masks"]).all() and np.isfinite(a["cams"]).all())
        launched = {k: v for k, v in a["launches"].items() if v}
        emit({"phase": "records_search", "card": card, "preset": "configs/config_clstm_kth_records.py",
              "changed": {"records_folder": "generated", "mask.opt_iter": RECORDS_STEPS}, "clips": n,
              "kept_over_min_score": kept,
              "equal_bits_two_runs": equal, "finite": finite, "launches": launched,
              "gate_kernel": "not run: hard-sigmoid gates (the kernel computes sigmoid gates only)",
              "mask_steps_per_s": [a["rate"], b["rate"]], "wall_seconds": [a["wall"], b["wall"]],
              "phase_seconds": time.perf_counter() - t_phase})
        if not (equal and finite and kept > 0 and not launched):
            failures.append(f"records_search: equal {equal}, finite {finite}, kept {kept}, launches {launched}")


CKPT_CLI_CLIPS, CKPT_CLI_STEPS, CKPT_CLI_SEED = 4, 5, 61
# the two I3D routes of the `find-masks` runs: flags and the kernels each must launch
CKPT_CLI_I3D_ROUTES = {
    "f32_pointwise": (["--use_pallas", "1"], ("pointwise_conv",)),
    "bf16_default": (["-cdt", "bfloat16"], ARGMAX_COUNTERS),
}
# the route run as a `python -m ivf_tpu_torch.cli` process (the other runs `cli.main` in this one)
CKPT_CLI_PROCESS_ROUTE = "bf16_default"
CKPT_CLI_CLSTM_FLAGS = ["-cdt", "bfloat16", "-pls", "1"]  # bf16 training on the gate kernel
CKPT_CLI_TF_SUBJECTS = RECORDS_SUBJECTS[:3]  # one validation clip each


def _preset_module(path: Path, preset: Path, **flat) -> str:
    """A config module (``Config.load`` reads its ``config``) that loads a
    preset of ``configs/`` as it is and sets the reference's flat keys
    ``flat``: the output and data folders a run writes and reads."""
    path.write_text(
        "import runpy\n\n"
        f"config = dict(runpy.run_path({str(preset)!r})['config'])\n"
        f"config.update({flat!r})\n"
    )
    return str(path)


def _keras_tensors(sd: dict, layers: int) -> dict:
    """A TF-family ConvLSTM state dict under the Keras graph's names
    (``video_features_tf/models/clstm.py``): the inverse of
    ``utils/import_tf.py``'s walk."""
    out = {}
    for i in range(layers):
        sfx = "" if i == 0 else f"_{i}"
        out[f"conv_lst_m2d{sfx}/kernel"] = sd[f"clstm.cells.{i}.wx"].permute(2, 3, 1, 0)
        out[f"conv_lst_m2d{sfx}/recurrent_kernel"] = sd[f"clstm.cells.{i}.wh"].permute(2, 3, 1, 0)
        out[f"conv_lst_m2d{sfx}/bias"] = sd[f"clstm.cells.{i}.bx"]
        for tf_name, name in (("gamma", "weight"), ("beta", "bias"), ("moving_mean", "running_mean"),
                              ("moving_variance", "running_var")):
            out[f"batch_normalization{sfx}/{tf_name}"] = sd[f"clstm.bns.{i}.{name}"]
    out["dense/kernel"] = sd["end_fc.weight"].t()
    out["dense/bias"] = sd["end_fc.bias"]
    return {k: v.detach().cpu().contiguous() for k, v in out.items()}


def _pickled_run(run_dir: Path) -> dict:
    """A find_masks run's records as its two result pickles hold them."""
    import pickle

    def load(kind):
        with open(next((run_dir / "results").glob(f"all{kind}Results_*.p")), "rb") as f:
            return pickle.load(f)

    return {"tm": load("TimeMask"), "gc": load("GradCam")}


def phase_checkpoint_cli(api, counters, failures, card: str, weights: dict) -> dict:
    """Checkpoint I/O and the command line at full width
    (``python -m ivf_tpu_torch.cli``), each run against the API with the
    same weights passed in memory.

    I3D (``configs/config_i3d_smth.py`` as loaded: 174 classes,
    16x224x224; a generated JPEG tree of 4 validation clips; ``-bs 4``,
    ``opt_iter`` 300 -> 5): the seeded weights exported with the port's
    exporter to a reference-layout ``.pth.tar``; ``find-masks -c ...
    --checkpoint <file>`` on the f32 route with ``--use_pallas 1`` through
    ``cli.main`` in this process (launch counters set to 0 just before and
    read just after: the pointwise kernel must launch), and on the bf16
    default route as one ``python -m ivf_tpu_torch.cli`` process (exit 0;
    the argmax pool pair must launch in the same route's in-memory run);
    each run's records, the process's as its pickles hold them, equal bit
    for bit, per clip, to ``api.find_masks`` with the weights in memory.

    ConvLSTM (``configs/config_clstm_kth.py`` as loaded; a generated KTH
    tree of 16 train and 16 validation clips of 32x120x160): ``cli train
    -cdt bfloat16 -pls 1`` for one epoch (one step; the all-bf16 gate
    entries must launch, and no other gate entry), then ``--resume`` to
    the second epoch, against an uninterrupted two-epoch run: equal bits;
    ``export-checkpoint`` of that run (its ``model_best``) loads back
    ``strict=True`` with its bits. The TF family
    (``configs/config_clstm_kth_records.py`` as loaded, on generated
    shards of three of its validation subjects, ``val_subjects`` cut to
    those, ``opt_iter`` 100 -> 5): its seeded
    weights written as a Keras-named TF bundle with the port's
    ``save_bundle``; ``find-masks --checkpoint <prefix>`` gives the bits of
    the in-memory run.

    Returns the all-bf16 gate entries' launches of the first train run
    (the kernels line's)."""
    import numpy as np

    from ivf_tpu_torch import cli
    from ivf_tpu_torch.data.records import RecordWriter
    from ivf_tpu_torch.ops.kernels import fused_gates as gates
    from ivf_tpu_torch.utils import export_torch, import_torch, tf_bundle
    from ivf_tpu_torch.utils.checkpoint import Checkpointer

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rng = np.random.RandomState(CKPT_CLI_SEED)
    checks, seconds = {}, {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"checkpoint_cli {label}: {detail}")
        checks[label] = bool(ok)

    def counted(run):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        return out, {k: fn.launches for k, fn in counters.items() if fn.launches}, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        out_dir = tmp / "out"
        # ---- I3D from a reference .pth.tar
        smth = tmp / "smth"
        _write_jpegs({smth / "validation" / str(i * 41 % CLASSES) / f"clip{i}":
                      rng.randint(0, 256, (CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8)
                      for i in range(CKPT_CLI_CLIPS)})
        pth = str(tmp / "i3d.pth.tar")
        export_torch.save_checkpoint_file(pth, export_torch.i3d_state_dict_to_reference(weights), arch="i3d_smth")
        i3d_cfg = _preset_module(tmp / "i3d_cfg.py", root / "configs" / "config_i3d_smth.py",
                                 output_dir=str(out_dir), data_folder=str(smth))
        common = ["-c", i3d_cfg, "-bs", str(CKPT_CLI_CLIPS), "-opti", str(CKPT_CLI_STEPS)]
        for route, (flags, kernels) in CKPT_CLI_I3D_ROUTES.items():
            cli_args = ["find-masks", *common, "--checkpoint", pth, "--subDir", f"cli_{route}", *flags]
            if route == CKPT_CLI_PROCESS_ROUTE:
                t0 = time.perf_counter()
                proc = subprocess.run([sys.executable, "-m", "ivf_tpu_torch.cli", *cli_args], cwd=str(root),
                                      capture_output=True, text=True, timeout=600)
                seconds[f"i3d_{route}_process"] = time.perf_counter() - t0
                require(f"i3d_{route}_process_exit_0", proc.returncode == 0, proc.stderr[-2000:])
                run = _pickled_run(out_dir / f"cli_{route}") if proc.returncode == 0 else {"tm": [], "gc": []}
            else:
                (tm, gc), cli_launched, seconds[f"i3d_{route}_cli"] = counted(lambda: cli.main(cli_args))
                run = {"tm": tm, "gc": gc}
            cfg = cli._load_cfg(cli.build_parser().parse_args(
                ["find-masks", *common, "--subDir", f"api_{route}", *flags]))
            want, api_launched, seconds[f"i3d_{route}_api"] = counted(
                lambda: api.find_masks(cfg, weights, split="validation", save_viz=False))
            launched = api_launched if route == CKPT_CLI_PROCESS_ROUTE else cli_launched
            require(f"i3d_{route}_cli_equals_api", _same_bits_by_id(run, {"tm": want[0], "gc": want[1]})
                    and len(run["tm"]) == CKPT_CLI_CLIPS, len(run["tm"]))
            require(f"i3d_{route}_kernels_launched", all(launched.get(k, 0) > 0 for k in kernels), launched)
            masks = np.stack([r["time_mask"] for r in run["tm"]]) if run["tm"] else np.full(1, np.nan)
            require(f"i3d_{route}_finite", np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1
                    and all(np.isfinite(r["GCHeatMap"]).all() for r in run["gc"]), "masks or CAMs")

        # ---- ConvLSTM: bf16 training through the CLI, resumed, exported
        kth = tmp / "kth"
        tags = data_kth_tags(CLSTM_BATCH)
        for split in ("train", "validation"):
            _write_jpegs({kth / split / str(i): rng.randint(0, 256, (CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8)
                          for i in range(CLSTM_BATCH)})
            for i, tag in enumerate(tags):
                (kth / split / str(i) / "class.txt").write_text(f"{i % CLSTM_CLASSES}\n")
                (kth / split / str(i) / "label.txt").write_text(f"{tag}\n")
        clstm_cfg = _preset_module(tmp / "clstm_cfg.py", root / "configs" / "config_clstm_kth.py",
                                   output_dir=str(out_dir), data_folder=str(kth))
        train = ["train", "-c", clstm_cfg, *CKPT_CLI_CLSTM_FLAGS]
        gates.release_gate_tables()  # so that this run builds them, as a fresh process does
        _, train_launches, seconds["clstm_train_1"] = counted(lambda: cli.main(
            [*train, "--subDir", "resumed", "-ne", "1"]))
        gate_entries = CLSTM_GATES["bfloat16"] + ("lstm_gate_tables",)
        require("clstm_all_bf16_gates_launched", all(train_launches.get(k, 0) > 0 for k in gate_entries)
                and train_launches.get("lstm_gate_tables") == 1
                and not any("lstm_gates" in k and k not in gate_entries for k in train_launches), train_launches)
        (resumed, _), _, seconds["clstm_train_resume"] = counted(lambda: cli.main(
            [*train, "--subDir", "resumed", "-ne", "2", "--resume"]))
        (full, _), _, seconds["clstm_train_2"] = counted(lambda: cli.main([*train, "--subDir", "full", "-ne", "2"]))
        require("clstm_resume_equal_bits", _same_state(_state_bits(resumed), _state_bits(full)) and
                resumed.step == full.step == 2, (resumed.step, full.step))
        exported = str(tmp / "clstm.pth.tar")
        cli.main(["export-checkpoint", "-c", clstm_cfg, "--checkpoint", str(out_dir / "full"), "--out", exported])
        cfg = cli._load_cfg(cli.build_parser().parse_args(["train", "-c", clstm_cfg]))
        m = cfg.model
        back = import_torch.convlstm_state_dict(
            import_torch.load_checkpoint_file(exported), image_size=api._clip_hw(cfg), conv_stride=m.conv_stride,
            pool_kernel=tuple(m.pool_kernel), lstm_layers=m.clstm_layers, nb_lstm_units=m.clstm_hidden)
        model = api._construct_model(cfg, False)
        strict = True
        try:
            model.load_state_dict(back, strict=True)
        except RuntimeError:
            strict = False
        best = Checkpointer(str(out_dir / "full")).load_variables("model_best")
        require("clstm_export_loads_strict", strict and _same_state(back, best), "export / import")
        require("clstm_counts_batches", int(back["clstm.bn.num_batches_tracked"]) > 0,
                int(back["clstm.bn.num_batches_tracked"]))

        # ---- the TF family from a TF bundle written by the port
        records = tmp / "records"
        records.mkdir()
        for s in CKPT_CLI_TF_SUBJECTS:
            with RecordWriter(str(records / f"kth_subject_{s}.ivfrecords")) as w:
                w.write(rng.randint(0, 256, (CLSTM_T, *CLSTM_HW, 3)).astype(np.uint8), label=s % CLSTM_CLASSES,
                        video_id=f"person{s}_boxing_d1_1", extra={"subject": s})
        tf_cfg = _preset_module(tmp / "tf_cfg.py", root / "configs" / "config_clstm_kth_records.py",
                                output_dir=str(out_dir), records_folder=str(records),
                                val_subjects=CKPT_CLI_TF_SUBJECTS)
        tf_common = ["-c", tf_cfg, "-opti", str(CKPT_CLI_STEPS)]
        cfg = cli._load_cfg(cli.build_parser().parse_args(["find-masks", *tf_common, "--subDir", "tf_api"]))
        tf_weights = _clstm_scaled_weights(api, api.build_dataset(cfg, "validation")[0][0], cfg)
        prefix = str(tmp / "tf" / "model.ckpt")
        tf_bundle.save_bundle(prefix, _keras_tensors(tf_weights, cfg.model.clstm_layers))
        (tm, gc), _, seconds["tf_cli"] = counted(lambda: cli.main(
            ["find-masks", *tf_common, "--checkpoint", prefix, "--subDir", "tf_cli"]))
        want = api.find_masks(cfg, tf_weights, split="validation", save_viz=False)
        require("tf_bundle_cli_equals_api", _same_bits_by_id({"tm": tm, "gc": gc}, {"tm": want[0], "gc": want[1]})
                and len(gc) > 0, (len(tm), len(gc)))
    emit({"phase": "checkpoint_cli", "card": card, **checks, "seconds": seconds,
          "train_launches": train_launches, "phase_seconds": time.perf_counter() - t_phase,
          "required": "every check true"})
    return {k: train_launches.get(k, 0) for k in gate_entries}


# serving (``ivf_tpu_torch/serve.py``): the float32 models the batcher
# serves, their routes, the kernel launches one forward makes on each (the
# counters of launch_counters()), and the buckets of the default batcher
SERVE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)
SERVE_I3D_ROUTES = {"kernels": dict(use_pallas=True, pallas_pool=True),
                    "tblock": dict(use_pallas=True, fuse_pool_conv="tblock"), "stock": {}}
SERVE_CLSTM_ROUTES = {"gates": True, "stock": False}
SERVE_LAUNCHES = {  # (model, route) -> launches of one forward; every other counter stays 0
    ("i3d_smth", "kernels"): {"pointwise_conv": 20, "maxpool3d_s1_fwd": 9},
    ("i3d_smth", "tblock"): {"pointwise_conv": 11, "fused_pool_conv_tblock_fwd": 9},
    ("i3d_smth", "stock"): {},
    ("clstm_kth", "gates"): {"lstm_gates_fwd": 2 * CLSTM_T},
    ("clstm_kth", "stock"): {},
}
SERVE_RTOL, SERVE_ATOL = 1e-6, 1e-7  # tests/test_serve.py's, where an op of the graph changes bits
SERVE_BURST = 512  # requests of the batcher burst, from 8 threads
SERVE_PAIRS, SERVE_PAIR_CLIPS = 6, 8  # artifact / live timing pairs a bucket; clips a sample holds at least
# its rows against one call at bucket 16: other buckets may take other cuDNN
# algorithms (a sum in another order); tests/test_serve.py's batcher tolerance
SERVE_BURST_RTOL, SERVE_BURST_ATOL = 1e-5, 1e-6


def _serve_model(api, model_name: str, route: str, weights: dict):
    """The float32 model the ``export-model`` command exports
    (``init_eval_state``, softmax on) on the card, with ``weights``."""
    from ivf_tpu_torch.config import Config

    if model_name == "i3d_smth":
        cfg = Config()
        for key, value in SERVE_I3D_ROUTES[route].items():
            setattr(cfg.model, key, value)
        shape = (CLIP_T, CLIP_HW, CLIP_HW, 3)
    else:
        cfg = _clstm_cfg(SERVE_CLSTM_ROUTES[route])
        shape = (CLSTM_T, *CLSTM_HW, 3)
    model, _ = api.init_eval_state(cfg, softmax_override=True)
    model.load_state_dict(weights)
    return cfg, model.requires_grad_(False), shape


def _paired_clips_per_s(call, live, x) -> dict:
    """clips/s of the artifact (``call``) and of the live model at ``x``'s
    bucket, timed in ``SERVE_PAIRS`` pairs with the side timed first
    alternating, a sample ``max(1, SERVE_PAIR_CLIPS // bucket)`` calls: per
    side the median and range, and the median of the pairs' ratios
    artifact / live with the number of pairs the artifact lost."""
    b = x.shape[0]
    n = max(1, SERVE_PAIR_CLIPS // b)
    sides = {"artifact": call, "live": live}
    rates = {side: [] for side in sides}
    for k in range(SERVE_PAIRS):
        for side in (("artifact", "live") if k % 2 == 0 else ("live", "artifact")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                sides[side](x)
            torch.cuda.synchronize()
            rates[side].append(n * b / (time.perf_counter() - t0))
    ratios = [a / w for a, w in zip(rates["artifact"], rates["live"])]
    out = {f"{side}_clips_per_s": statistics.median(r) for side, r in rates.items()}
    out.update({f"{side}_clips_per_s_range": [min(r), max(r)] for side, r in rates.items()})
    return {**out, "pair_ratio_median": statistics.median(ratios), "pairs_artifact_slower": sum(r < 1 for r in ratios),
            "pairs": SERVE_PAIRS, "calls_per_sample": n}


def _serve_route(api, serve, counters, failures, card, tmp, model_name, route, weights) -> dict:
    """Export one route's model on the card, save and load the artifact,
    then at every bucket: the artifact's output against the live model's
    (equal bits, else rtol 1e-6 / atol 1e-7 with the differing output
    named), the launch counters around one artifact call, and clips/s of
    each in alternating pairs (``_paired_clips_per_s``); at bucket 128 the
    device ms by group of one call of each."""
    cfg, model, shape = _serve_model(api, model_name, route, weights)
    gen = torch.Generator(device="cuda").manual_seed(11)
    x_all = torch.rand((SERVE_BUCKETS[-1], *shape), generator=gen, device="cuda") * 255
    t0 = time.perf_counter()
    program = serve.export_forward(model, shape)
    export_s = time.perf_counter() - t0
    path = str(Path(tmp) / f"{model_name}_{route}.ivfptx")
    serve.save_artifact(program, path, meta={"family": cfg.model.conv_model, "num_classes": cfg.model.num_classes,
                                             "clip_shape": list(shape)})
    call, meta = serve.load_artifact(path)
    live = serve.live_forward(model)
    ops = {}
    for node in call.program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("ivf_tpu_torch."):
            ops[str(node.target)] = ops.get(str(node.target), 0) + 1
    want = SERVE_LAUNCHES[(model_name, route)]
    rows, ok = [], True
    for b in SERVE_BUCKETS:
        x = x_all[:b]
        for fn in counters.values():
            fn.launches = 0
        got = call(x)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items() if fn.launches}
        ref = live(x)
        equal = torch.equal(got, ref)
        close = equal or torch.allclose(got, ref, rtol=SERVE_RTOL, atol=SERVE_ATOL)
        row = {"bucket": b, "equal_bits": equal, "max_abs_err": (got - ref).abs().max().item(),
               "finite": bool(torch.isfinite(got).all()), "shape_ok": tuple(got.shape) == (b, cfg.model.num_classes),
               "launches": launches, **_paired_clips_per_s(call, live, x)}
        if launches != want:
            failures.append(f"serve {model_name} {route} bucket {b}: launches {launches}, want {want}")
            ok = False
        if not (close and row["finite"] and row["shape_ok"]):
            failures.append(f"serve {model_name} {route} bucket {b}: artifact against live {row}")
            ok = False
        rows.append(row)
    x = x_all[:SERVE_BUCKETS[-1]]
    prof = {"artifact": _train_profile(lambda: call(x)), "live": _train_profile(lambda: live(x))}
    out = {"phase": "serve", "card": card, "model": model_name, "route": route, "flags": (
               SERVE_I3D_ROUTES[route] if model_name == "i3d_smth" else {"use_pallas": SERVE_CLSTM_ROUTES[route]}),
           "clip_shape": list(shape), "export_seconds": export_s, "artifact_bytes": os.path.getsize(path),
           "meta": meta, "graph_ops": ops, "launches_per_forward_want": want, "buckets": rows,
           "bucket128": {side: {k: p[k] for k in ("device_ms", "groups_ms", "kernels_per_step", "peak_mem_gib")}
                         for side, p in prof.items()},
           "ok": ok}
    emit(out)
    return {"path": path, "call": call, "shape": shape, "ok": ok}


def _serve_smoke_and_burst(serve, failures, card, art) -> dict:
    """``cli serve --artifact <kernel-route artifact> --smoke`` (one POST
    /predict of a zero clip through the CLI's server), then the batcher
    behind ``serve_http`` on the loaded artifact: a burst of
    ``SERVE_BURST`` clips from 8 threads (occupancy, p50 / p95 latency,
    clips/s) and ``GET /stats`` / ``/healthz``."""
    import io as _io
    import threading
    import urllib.request

    import numpy as np

    from ivf_tpu_torch import cli

    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        resp = cli.main(["serve", "--artifact", art["path"], "--port", "0", "--max-batch", "128", "--smoke"])
    text = out.getvalue()
    smoke_ok = (resp is not None and resp["top1"] == int(np.argmax(resp["scores"]))
                and "serving on http://" in text and len(resp["scores"]) == CLASSES)
    if not smoke_ok:
        failures.append(f"serve cli smoke: {text[-500:]}")
    rng = np.random.RandomState(12)
    clips = (rng.rand(16, *art["shape"]) * 255).astype(np.float32)
    with serve.DynamicBatcher(art["call"], max_batch=128, max_wait_ms=5.0) as batcher:
        batcher.warmup(art["shape"])
        server = serve.serve_http(batcher, port=0)
        try:
            host, port = server.server_address
            futs = [None] * SERVE_BURST

            def submit(k0):
                for k in range(k0, SERVE_BURST, 8):
                    futs[k] = batcher.submit(clips[k % len(clips)])

            t0 = time.perf_counter()
            threads = [threading.Thread(target=submit, args=(k,)) for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            results = [f.result(timeout=600) for f in futs]
            burst_s = time.perf_counter() - t0
            direct = art["call"](torch.from_numpy(clips).cuda()).cpu().numpy()
            burst_err = max(float(np.abs(r - direct[k % len(clips)]).max()) for k, r in enumerate(results))
            rows_close = all(np.allclose(r, direct[k % len(clips)], rtol=SERVE_BURST_RTOL, atol=SERVE_BURST_ATOL)
                             for k, r in enumerate(results))
            stats = json.loads(urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=60).read())
            health = json.loads(urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=60).read())
        finally:
            server.shutdown()
    burst_ok = rows_close and stats["requests"] == SERVE_BURST and health == {"ok": True}
    if not burst_ok:
        failures.append(f"serve burst: rows_close {rows_close} ({burst_err}), stats {stats}, health {health}")
    row = {"phase": "serve_http", "card": card, "cli_smoke_response_top1": resp and resp["top1"],
           "cli_smoke_ok": smoke_ok, "burst_requests": SERVE_BURST, "burst_seconds": burst_s,
           "burst_clips_per_s": SERVE_BURST / burst_s, "stats": stats, "rows_close_to_bucket16": rows_close,
           "max_abs_err_to_bucket16": burst_err, "tol": [SERVE_BURST_RTOL, SERVE_BURST_ATOL],
           "healthz": health, "ok": smoke_ok and burst_ok}
    emit(row)
    return row


def serve_child() -> int:
    """``python3 chip_smoke.py --serve-child``, the ``serve`` phase's own
    process (``phase_serve``). Serving at full width: i3d_smth (174
    classes, 16x224x224, f32, the main path's seeded weights) on the
    kernel route, the fused ``tblock`` route and the stock route, and
    clstm_kth (32x120x160, 2 layers x 4 hidden) with the gate kernel and
    without, each exported on the card (``serve.export_forward``), saved,
    loaded and called at every bucket 1-128 against the live model
    (``_serve_route``); then the CLI's ``serve --artifact --smoke`` and a
    batcher burst on the I3D kernel route's artifact
    (``_serve_smoke_and_burst``). One JSON line per route; the failures on
    stderr and exit code 1."""
    from ivf_tpu_torch import api, serve
    from ivf_tpu_torch.config import Config

    t_phase = time.perf_counter()
    card, counters, failures = nvidia_smi(), launch_counters(), []
    cfg = Config()
    for name, value in FUSED_ROUTES["kernels"].items():
        setattr(cfg.model, name, value)
    weights = {"i3d_smth": _scaled_weights(cfg, api),
               "clstm_kth": _clstm_scaled_weights(api, _clstm_clips()[0][0])}
    arts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for model_name, routes in (("i3d_smth", SERVE_I3D_ROUTES), ("clstm_kth", SERVE_CLSTM_ROUTES)):
            for route in routes:
                arts[(model_name, route)] = _serve_route(api, serve, counters, failures, card, tmp, model_name,
                                                         route, weights[model_name])
                torch.cuda.empty_cache()
        http = _serve_smoke_and_burst(serve, failures, card, arts[("i3d_smth", "kernels")])
    emit({"phase": "serve_compare", "card": card, "routes_ok": {f"{m} {r}": a["ok"] for (m, r), a in arts.items()},
          "http_ok": http["ok"], "phase_seconds": time.perf_counter() - t_phase, "required": "every check true"})
    for f in failures:
        print(f, file=sys.stderr)
    return 1 if failures else 0


def phase_serve(failures) -> None:
    """The ``serve`` phase in a child process (``serve_child``), as a
    server runs: in this process, after the earlier phases, the host-bound
    forwards ran several times slower, the exported ConvLSTM's most
    (PERF.md)."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--serve-child"],
                          capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            emit(json.loads(line))
    if proc.returncode != 0:
        failures.append(f"serve child exited {proc.returncode}: {proc.stderr[-3000:]}")


# the parallel phase: a world of one rank over NCCL, full i3d_smth width
PAR_TRAIN_STEPS, PAR_BF16_STEPS, PAR_FM_CLIPS, PAR_FM_STEPS = 3, 2, 4, 10
PAR_TIMED_PAIRS = 8  # single train steps with the mesh and without, in pairs
PAR_DEVICE = None  # the ranks' device: None is the card over NCCL
PAR_TRAIN_ROUTES = {"f32_kernels": TRAIN_I3D_ROUTES["f32_kernels"], "bf16_default": TRAIN_I3D_ROUTES["bf16_default"]}
# stated before the first run: on one rank every collective of the mesh
# path is a copy (a sum over one rank) or a division by 1, so the steps are
# predicted bit for bit equal; the limit is what a BN mean summed in
# another order would move (float32 rounding through training BN and
# Adam's normalization: 7.3e-5 on parameters after two Adam steps,
# tests/test_torch_parallel.py)
PAR_TRAIN_TOL = {"loss_rel": 1e-5, "param_max_abs": 1e-4}
PAR_TRAIN_TOL_REASON = (
    "one rank: the all-reduces are copies and the divisions by the rank count exact, so equal bits are "
    "predicted; the limit is a BN sum taken in another order through training BN and Adam (CPU, the "
    "two-node ConvLSTM train: 7.3e-5 on the parameters after two Adam steps)"
)


def _par_train_runs(api, counters, cfg, clips, labels, mesh, steps: int) -> dict:
    """Without the mesh, then with it: ``steps`` steps of the preset's
    optimizer from its seeded state on one fixed batch, the launch counters
    set to 0 just before and read just after; then ``PAR_TIMED_PAIRS``
    single steps of each, in pairs with the first alternating (wall ms,
    synchronized), and one profiled step of each."""
    from ivf_tpu_torch.parallel import shard_batch
    from ivf_tpu_torch.train import make_train_step

    runs = {}
    for name, m in (("no_mesh", None), ("mesh", mesh)):
        inputs = (clips, labels) if m is None else shard_batch((clips, labels), m)
        state = _train_state(api, cfg)
        step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype, mesh=m)
        for fn in counters.values():
            fn.launches = 0
        losses = []
        for _ in range(steps):
            state, metrics = step(state, *inputs)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        runs[name] = {"losses": [float(x) for x in losses], "bits": _state_bits(state), "wall_ms": [],
                      "launches": {k: fn.launches for k, fn in counters.items() if fn.launches},
                      "step": lambda state=state, step=step, inputs=inputs: step(state, *inputs)}
    for k in range(PAR_TIMED_PAIRS):
        for name in ("no_mesh", "mesh") if k % 2 == 0 else ("mesh", "no_mesh"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]["step"]()
            torch.cuda.synchronize()
            runs[name]["wall_ms"].append((time.perf_counter() - t0) * 1e3)
    for r in runs.values():
        r.update(_train_profile(r.pop("step")))
    return runs


def _par_train_gap(a: dict, b: dict) -> dict:
    loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    param = max(float((a["bits"][n].float() - b["bits"][n].float()).abs().max()) for n in b["bits"])
    return {"loss_rel_diff": loss_rel, "param_max_abs_diff": param,
            "equal_bits": a["losses"] == b["losses"] and _same_state(a["bits"], b["bits"])}


def parallel_child() -> int:
    """``python3 chip_smoke.py --parallel-child``, the ``parallel`` phase's
    own process (``phase_parallel``): a world of one rank over NCCL
    (``tcp://127.0.0.1``, a free port) and its data mesh
    (``parallel.get_mesh``: ``init_device_mesh("cuda", (1,), ("data",))``),
    i3d_smth at full width (174 classes, 16x224x224). Each run goes once
    with the mesh and once without, its launch counters set to 0 just
    before and read just after:

      * ``PAR_TRAIN_STEPS`` train steps of the preset (batch 16, Adam,
        dropout 0.5) on the float32 kernel route (``use_pallas`` +
        ``pallas_pool``), and ``PAR_BF16_STEPS`` on the bf16 default route
        (the argmax pool): the losses and the state equal bits or within
        ``PAR_TRAIN_TOL``; then ``PAR_TIMED_PAIRS`` single steps of each
        in pairs, the first alternating (wall ms), and one profiled step
        of each (device ms, the NCCL kernels' share);
      * ``find_masks`` on ``PAR_FM_CLIPS`` clips x ``PAR_FM_STEPS`` steps on
        the float32 kernel route with the main path's seeded weights:
        equal bits;
      * ``infer`` on one batch of 16: equal bits.

    Every collective runs, on one rank: the NCCL path of the port. The
    launch counts must be equal with and without the mesh, and above 0
    for the route's kernels. One JSON line per run and a
    ``parallel_compare`` line; failures on stderr and exit code 1."""
    import socket

    import numpy as np
    import torch.distributed as dist

    from ivf_tpu_torch import api
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips
    from ivf_tpu_torch.parallel import get_mesh, initialize_multihost

    t_phase = time.perf_counter()
    card, counters, failures, checks = nvidia_smi(), launch_counters(), [], {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"parallel {label}: {detail}")
        checks[label] = bool(ok)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    initialize_multihost(f"tcp://127.0.0.1:{port}", 1, 0, device=PAR_DEVICE, timeout_s=300)
    mesh = get_mesh()
    init_s = time.perf_counter() - t0
    require("nccl_backend", dist.get_backend() == ("nccl" if PAR_DEVICE is None else "gloo"), dist.get_backend())
    emit({"phase": "parallel_init", "card": card, "backend": dist.get_backend(), "world": dist.get_world_size(),
          "mesh": {"device_type": mesh.device_type, "shape": list(mesh.shape), "axes": list(mesh.mesh_dim_names)},
          "init_seconds": init_s})
    rng = np.random.RandomState(23)
    dev = TRAIN_DEVICE
    clips = torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8)).to(dev)
    labels = torch.from_numpy((np.arange(TRAIN_BATCH) * 7 % CLASSES).astype(np.int32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        for route, flags in PAR_TRAIN_ROUTES.items():
            cfg = _train_preset(api, "config_i3d_smth.py", tmp, f"par_{route}", **flags)
            steps = PAR_TRAIN_STEPS if route == "f32_kernels" else PAR_BF16_STEPS
            runs = _par_train_runs(api, counters, cfg, clips, labels, mesh, steps)
            gap = _par_train_gap(runs["mesh"], runs["no_mesh"])
            for name, r in runs.items():
                nccl_ms = r["groups_ms"].get("NCCL collectives", 0.0)
                emit({"phase": "parallel_train", "card": card, "route": route, "run": name, "batch": TRAIN_BATCH,
                      "steps": steps, "losses": r["losses"], "wall_ms_pairs": r["wall_ms"],
                      "wall_ms_median": statistics.median(r["wall_ms"]),
                      "device_ms_per_step": r["device_ms"], "nccl_device_ms": nccl_ms,
                      "nccl_share": nccl_ms / r["device_ms"] if r["device_ms"] else None,
                      "launches": r["launches"], "kernels_per_step": r["kernels_per_step"],
                      "groups_ms": r["groups_ms"], "peak_mem_gib": r["peak_mem_gib"]})
            mesh_ms, none_ms = runs["mesh"]["wall_ms"], runs["no_mesh"]["wall_ms"]
            emit({"phase": "parallel_train_compare", "card": card, "route": route, **gap, "tol": PAR_TRAIN_TOL,
                  "tol_reason": PAR_TRAIN_TOL_REASON,
                  "device_ms_mesh_over_no_mesh": runs["mesh"]["device_ms"] / runs["no_mesh"]["device_ms"],
                  "wall_ms_median_mesh_over_no_mesh": statistics.median(mesh_ms) / statistics.median(none_ms),
                  "pairs_mesh_slower": sum(a > b for a, b in zip(mesh_ms, none_ms)), "pairs": PAR_TIMED_PAIRS})
            require(f"{route}_train_within_tol", gap["equal_bits"] or (
                gap["loss_rel_diff"] <= PAR_TRAIN_TOL["loss_rel"]
                and gap["param_max_abs_diff"] <= PAR_TRAIN_TOL["param_max_abs"]), gap)
            require(f"{route}_train_launches_equal", runs["mesh"]["launches"] == runs["no_mesh"]["launches"],
                    (runs["mesh"]["launches"], runs["no_mesh"]["launches"]))
            require(f"{route}_train_kernels", all(runs["mesh"]["launches"].get(n, 0) > 0
                                                  for n in TRAIN_I3D_KERNELS[route]), runs["mesh"]["launches"])
            require(f"{route}_train_finite", np.isfinite(runs["mesh"]["losses"]).all(), runs["mesh"]["losses"])
            del runs
            torch.cuda.empty_cache()
        # find_masks: the float32 kernel route, the main path's weights
        fm_cfg = Config()
        for name, value in FUSED_ROUTES["kernels"].items():
            setattr(fm_cfg.model, name, value)
        weights = _scaled_weights(fm_cfg, api)
        dataset = SyntheticClips(PAR_FM_CLIPS, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
        fm = {name: _find_masks_run(api, counters, tmp, f"par_fm_{name}", FUSED_ROUTES["kernels"], weights, dataset,
                                    batch=PAR_FM_CLIPS, steps=PAR_FM_STEPS, **kw)
              for name, kw in (("no_mesh", {}), ("mesh", {"mesh": mesh}))}
        for name, r in fm.items():
            emit({"phase": "parallel_find_masks", "card": card, "run": name, "clips": PAR_FM_CLIPS,
                  "steps": PAR_FM_STEPS, "wall_seconds": r["wall"], "mask_steps_per_s": r["rate"],
                  "search_seconds": r["stats"]["search_seconds"],
                  "launches": {k: v for k, v in r["launches"].items() if v}, "pickles": r["pickles"]})
            _check_outputs(f"parallel find_masks {name}", r, failures, batch=PAR_FM_CLIPS)
        same = _equal_bits(fm["mesh"], fm["no_mesh"])
        require("find_masks_equal_bits", same, _diffs(fm["mesh"], fm["no_mesh"]))
        require("find_masks_launches_equal", fm["mesh"]["launches"] == fm["no_mesh"]["launches"],
                (fm["mesh"]["launches"], fm["no_mesh"]["launches"]))
        require("find_masks_kernels", all(fm["mesh"]["launches"][n] > 0 for n in TRAIN_I3D_KERNELS["f32_kernels"]),
                fm["mesh"]["launches"])
        fm_launches = {k: v for k, v in fm["mesh"]["launches"].items() if v}
        del fm
        # infer: one batch, the same seeded state
        cfg = _train_preset(api, "config_i3d_smth.py", tmp, "par_infer", **TRAIN_I3D_ROUTES["f32_kernels"])
        _, state = api.init_eval_state(cfg, device=dev)
        val = [(c, int(y)) for c, y in zip(clips.cpu().numpy(), labels.cpu().numpy())]
        res, inf_launches = {}, {}
        for name, kw in (("no_mesh", {}), ("mesh", {"mesh": mesh})):
            for fn in counters.values():
                fn.launches = 0
            res[name] = api.infer(cfg, state, dataset=val, save_npy=False, **kw)
            inf_launches[name] = {k: fn.launches for k, fn in counters.items() if fn.launches}
        same_inf = all(np.array_equal(res["mesh"][k], res["no_mesh"][k]) for k in ("y_true", "y_hat", "y_hat_top5")) \
            and all(res["mesh"][k] == res["no_mesh"][k] for k in ("loss", "top1", "top5"))
        emit({"phase": "parallel_infer", "card": card, "clips": TRAIN_BATCH, "equal_bits": same_inf,
              "loss": res["mesh"]["loss"], "launches": inf_launches})
        require("infer_equal_bits", same_inf, {k: (res["mesh"][k], res["no_mesh"][k]) for k in ("loss", "top1")})
        require("infer_launches_equal", inf_launches["mesh"] == inf_launches["no_mesh"], inf_launches)
    dist.destroy_process_group()
    emit({"phase": "parallel_compare", "card": card, **checks, "find_masks_launches": fm_launches,
          "phase_seconds": time.perf_counter() - t_phase, "required": "every check true",
          "note": "a world of one rank: the multi-rank paths run on the CPU over gloo (tests/test_torch_parallel.py)"})
    for f in failures:
        print(f, file=sys.stderr)
    return 1 if failures else 0


def phase_parallel(failures) -> dict:
    """The ``parallel`` phase in a child process (``parallel_child``): the
    process group and its NCCL communicator stay out of this process. Its
    JSON lines pass through; returns the launch counts of its mesh runs by
    run (the kernels line's ``dp_launches``)."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--parallel-child"],
                          capture_output=True, text=True, timeout=600)
    dp = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            emit(row)
            if row.get("phase") == "parallel_train" and row["run"] == "mesh":
                dp[f"train_{row['route']}"] = row["launches"]
            elif row.get("phase") == "parallel_compare":
                dp["find_masks"] = row["find_masks_launches"]
    if proc.returncode != 0:
        failures.append(f"parallel child exited {proc.returncode}: {proc.stderr[-3000:]}")
    return dp


# the interpret_extras phase: the I3D options guided_relu, remat and
# fuse_3x3, find_mask and `cli --profile`, i3d_smth at full width
GUIDED_ROUTES = {  # route -> (I3D flags, dtype)
    "f32_plain": ({}, torch.float32),
    "f32_kernels": (dict(use_pallas=True, pallas_pool=True), torch.float32),
    "bf16_default": (dict(pool_impl="argmax"), torch.bfloat16),
}
# launches of one guided saliency (a forward and its input gradient):
# every pointwise conv apart under the guided ReLU (Conv3d_2b_1x1, four
# units in each of the nine blocks, the logits), forward and dx
GUIDED_LAUNCHES = {"f32_kernels": {"pointwise_conv": 76, "maxpool3d_s1_fwd": 9, "maxpool3d_s1_bwd": 9},
                   "bf16_default": {"argmax_pool_fwd": 9, "argmax_pool_bwd": 9}, "f32_plain": {}}
# guided against unguided forward (class probabilities): float32 at the
# JAX test's rtol (tests/test_aux.py), bf16 at one bf16 rounding
GUIDED_FWD_RTOL, GUIDED_FWD_REASON = 1e-4, (
    "the guided model runs the trio as three convs where the unguided one runs one: float32 sums in "
    "another order (rtol 1e-4, the JAX test's); in bf16 an activation may round to the neighbouring "
    "value, held at BF16_ROUTES_TOL on the probabilities")
# the kernel route against the same route with its wrappers patched to
# their plain versions on the card: relative L2 of the saliency
GUIDED_PLAIN_TOL, GUIDED_PLAIN_REASON = 1e-3, (
    "the pool pair gives the plain bits; the f32 GEMM sums in another order than cuBLAS (1e-5 of "
    "the largest output a call, kernel_check), 38 GEMMs deep each way, and the guided gate (x > 0 "
    "and g > 0) passes that on")
# the kernel route against the plain route: other tie rules (the pool
# kernel credits every tied maximum, and ReLU zeros are plateaus), so the
# maps differ in scale; held by the forward and the maps' directions
GUIDED_ROUTE_TOL, GUIDED_ROUTE_REASON = 0.5, (
    "relative L2 of the unit-normalized maps (sqrt(2 - 2 cos)); the every-tie rule scales the map "
    "(30-39x at 8x32x32 on the CPU) but keeps its direction: 0.14-0.18 there")
REMAT_CLIPS, REMAT_STEPS = 128, 5  # the bf16 default-route search with remat and without
FUSE3_F32_TOL, FUSE3_REASON = {"scores": 1e-5, "masks": 1e-3}, (
    "the block-diagonal conv adds exact zeros, only cuDNN's summation order changes (rtol 1e-4 at "
    "8x32x32 on the CPU, tests/test_torch_model_options.py); Adam's step is scale-free, so a "
    "near-zero mask-gradient component may move by a rounding")
# bf16, fused against off: cuDNN's bf16 3x3x3 conv sums the fused input
# channels in another order, so an output may round to the neighbouring
# bf16 value, and the later blocks carry that on. On an H100 at 700 W at
# 128 clips (the same bits in two runs) fusing all blocks moves the scores
# by 0.0059 (3 ulps of 2**-9), and so does fusing Mixed_3c, 4c or 4d alone
# (the other blocks alone: 0); the masks by 0.0078 (True) and 0.0047
# ('auto'). Wrong fusions (FUSE3_CONTROLS) read 0.0117-0.051 there. So the
# scores are held at 4 ulps (2**-7), between the two, and the masks at
# about twice their reading (BF16_TOL_REASON)
FUSE3_BF16_TOL, FUSE3_BF16_REASON = {"scores": 2.0**-7, "masks": 0.016}, (
    "bf16 fused against off: cuDNN sums the fused input channels in another order, so an output "
    "may round to the neighbouring bf16 value and later blocks carry it; one such rounding moves the "
    "scores by 0.0059 on an H100 (one block fused alone does it), wrong fusions 0.0117-0.051: scores "
    "at 2**-7 between the two, which every wrong fusion of FUSE3_CONTROLS must exceed; masks at about "
    "twice their reading (0.0078)")
FIND_MASK_TOL, FIND_MASK_REASON = {"scores": 1e-4, "masks": 1e-3}, (
    "cuDNN picks other algorithms at batch 1 than at 4, so float32 sums run in another order; the "
    "masks as FUSE3_REASON")
PROFILE_CLIPS, PROFILE_STEPS = 2, 5
EXTRAS_DEVICE = "cuda"  # where the phase runs: the card


@contextmanager
def _f32_kernels_plain():
    """The float32 pointwise GEMM's and pool pair's plain versions in place
    of their CUDA wrappers, on CUDA tensors: the f32 kernel route with
    nothing else changed."""
    from unittest import mock

    from ivf_tpu_torch.ops.kernels import maxpool3d as pool
    from ivf_tpu_torch.ops.kernels import pointwise_conv as pw

    with mock.patch.object(pw, "pointwise_conv_cuda", pw._gemm_plain), \
            mock.patch.object(pool, "maxpool3d_s1_fwd_cuda", lambda x, tile=None: pool.maxpool3d_s1_fwd_plain(x)), \
            mock.patch.object(pool, "maxpool3d_s1_bwd_cuda",
                              lambda x, y, g, tile=None: pool.maxpool3d_s1_bwd_plain(x, y, g)):
        yield


def _extras_i3d(weights: dict, dtype=torch.float32, softmax: bool = True, **flags):
    from ivf_tpu_torch.models import I3D

    model = I3D(num_classes=CLASSES, softmax=softmax, **flags)
    model.load_state_dict(weights)
    return model.to(EXTRAS_DEVICE, dtype).eval().requires_grad_(False)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _launched(counters, fn):
    """``fn()`` with every launch counter set to 0 just before it, read
    just after: (its result, the nonzero counts)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: c.launches for k, c in counters.items() if c.launches}


def _extras_guided(counters, weights, clip, require, card) -> dict:
    from ivf_tpu_torch.interpret import guided_backprop_i3d

    target, rows, maps = 7, {}, {}
    for route, (flags, dtype) in GUIDED_ROUTES.items():
        guided = _extras_i3d(weights, dtype, softmax=False, guided_relu=True, **flags)
        sal, launched = _launched(counters, lambda: guided_backprop_i3d(guided, clip, target))
        with torch.no_grad():
            x = clip[None].to(dtype)
            fwd_g = torch.softmax(guided(x).float(), -1)
            fwd_u = torch.softmax(_extras_i3d(weights, dtype, softmax=False, **flags)(x).float(), -1)
        gap = float((fwd_g - fwd_u).abs().max())
        ok_fwd = gap <= (GUIDED_FWD_RTOL * float(fwd_u.abs().max()) if dtype == torch.float32 else BF16_ROUTES_TOL)
        require(f"guided_{route}_forward", ok_fwd, gap)
        require(f"guided_{route}_finite_nonzero", bool(torch.isfinite(sal).all()) and float(sal.abs().max()) > 0,
                float(sal.abs().max()))
        require(f"guided_{route}_launches", launched == GUIDED_LAUNCHES[route], launched)
        maps[route] = sal.float()
        rows[route] = {"forward_max_abs_gap": gap, "launches": launched, "saliency_norm": float(sal.float().norm())}
        if route == "f32_kernels":
            with _f32_kernels_plain():
                plain_sal, plain_launched = _launched(counters, lambda: guided_backprop_i3d(guided, clip, target))
            rel = _rel_l2(sal, plain_sal)
            require("guided_kernels_vs_plain_versions", rel <= GUIDED_PLAIN_TOL and not plain_launched, rel)
            rows[route]["vs_plain_versions_rel_l2"] = rel
            for variant in (True, "tblock"):
                fused = _extras_i3d(weights, dtype, softmax=False, guided_relu=True, use_pallas=True,
                                    fuse_pool_conv=variant)
                _, fl = _launched(counters, lambda: guided_backprop_i3d(fused, clip, target))
                require(f"guided_fuse_pool_conv_{variant}_no_fused_kernel",
                        not any(k.startswith("fused_pool_conv") for k in fl) and fl.get("pointwise_conv") == 76, fl)
                rows[route][f"fuse_pool_conv_{variant}_launches"] = fl
    unit = {r: m / m.norm() for r, m in maps.items()}
    route_gap = _rel_l2(unit["f32_kernels"], unit["f32_plain"])
    require("guided_kernels_vs_plain_route", route_gap <= GUIDED_ROUTE_TOL, route_gap)
    emit({"phase": "interpret_extras_guided", "card": card, "clip": list(clip.shape), "target": target,
          "routes": rows, "kernels_vs_plain_route_unit_rel_l2": route_gap,
          "kernels_vs_plain_route_norm_ratio": float(maps["f32_kernels"].norm() / maps["f32_plain"].norm()),
          "limits": {"forward_f32_rtol": GUIDED_FWD_RTOL, "forward_bf16_atol": BF16_ROUTES_TOL,
                     "vs_plain_versions_rel_l2": GUIDED_PLAIN_TOL, "vs_plain_route_unit_rel_l2": GUIDED_ROUTE_TOL},
          "reasons": [GUIDED_FWD_REASON, GUIDED_PLAIN_REASON, GUIDED_ROUTE_REASON]})
    return rows


def _search_from_carry(counters, model, clips, targets, steps: int):
    """``steps`` search steps from one central-shaped carry: the masks and
    the launches, the peak memory of the run."""
    from ivf_tpu_torch.interpret import mask_opt

    score = lambda x: model(x).float()  # noqa: E731

    def run():
        carry = _central_carry(clips.shape[0], clips.shape[1])
        for _ in range(steps):
            carry = mask_opt.search_step(score, clips, targets, carry)
        return torch.sigmoid(carry.logits)

    torch.cuda.reset_peak_memory_stats()
    masks, launched = _launched(counters, run)
    return masks, launched, torch.cuda.max_memory_allocated() / 2**30


def _extras_remat(api, counters, weights, require, card) -> dict:
    from ivf_tpu_torch.train import make_train_step

    gen = torch.Generator(device=EXTRAS_DEVICE).manual_seed(24)
    big = torch.randint(0, 256, (REMAT_CLIPS, CLIP_T, CLIP_HW, CLIP_HW, 3), generator=gen,
                        device=EXTRAS_DEVICE, dtype=torch.uint8).float()
    targets = torch.arange(REMAT_CLIPS, device=EXTRAS_DEVICE) % CLASSES
    models = {name: _extras_i3d(weights, torch.bfloat16, pool_impl="argmax", remat=remat)
              for name, remat in (("off", False), ("on", True))}
    runs = {name: _search_from_carry(counters, m, big, targets, REMAT_STEPS) for name, m in models.items()}
    held = {}  # GiB the forward leaves saved for the backward
    for name, m in models.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        x = big.requires_grad_(True)
        out = m(x)
        held[name] = (torch.cuda.memory_allocated() - before) / 2**30
        del out, x
        big.requires_grad_(False)
    require("remat_search_equal_masks", torch.equal(runs["on"][0], runs["off"][0]),
            float((runs["on"][0] - runs["off"][0]).abs().max()))
    fwd = {name: r[1].get("argmax_pool_fwd", 0) for name, r in runs.items()}
    require("remat_search_block_forwards_twice", fwd["on"] == 2 * fwd["off"] == 2 * 9 * REMAT_STEPS, fwd)
    _step_timing("interpret_extras_remat_timing", models, big, card, turns=("off", "on", "on", "off"), steps=3)
    del big
    torch.cuda.empty_cache()
    # one train step of the preset at batch 16, f32 kernel route
    import numpy as np

    rng = np.random.RandomState(24)
    clips = torch.from_numpy(rng.randint(0, 256, (TRAIN_BATCH, CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8))
    labels = torch.from_numpy((np.arange(TRAIN_BATCH) * 11 % CLASSES).astype(np.int32)).to(EXTRAS_DEVICE)
    train = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = _train_preset(api, "config_i3d_smth.py", tmp, "remat", **TRAIN_I3D_ROUTES["f32_kernels"])
        for name, remat in (("off", False), ("on", True)):
            state = _train_state(api, cfg)
            state.model.remat = remat
            step = make_train_step(kernel_l2=cfg.model.kernel_l2, compute_dtype=cfg.model.compute_dtype)
            torch.cuda.reset_peak_memory_stats()
            (state, metrics), launched = _launched(counters, lambda: step(state, clips, labels))
            train[name] = {"loss": float(metrics["loss"]), "bits": _state_bits(state), "launches": launched,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            del state, step
            torch.cuda.empty_cache()
    on, off = train["on"], train["off"]
    stats = [n for n, t in off["bits"].items() if "running" in n or "num_batches" in n]
    require("remat_train_equal_statistics", all(torch.equal(on["bits"][n], off["bits"][n]) for n in stats),
            [n for n in stats if not torch.equal(on["bits"][n], off["bits"][n])][:5])
    require("remat_train_batches_tracked_once",
            {int(t) for n, t in on["bits"].items() if n.endswith("num_batches_tracked")} == {1}, "")
    params_equal = _same_state(on["bits"], off["bits"]) and on["loss"] == off["loss"]
    require("remat_train_equal_loss_and_parameters", params_equal, (on["loss"], off["loss"]))
    require("remat_train_block_forwards_twice",
            on["launches"].get("pointwise_conv") == off["launches"].get("pointwise_conv", 0) + 36 == 112
            and on["launches"].get("maxpool3d_s1_fwd") == 2 * off["launches"].get("maxpool3d_s1_fwd", 0) == 18,
            (on["launches"], off["launches"]))
    row = {"search": {name: {"launches": r[1], "peak_gib": r[2], "held_after_forward_gib": held[name]}
                      for name, r in runs.items()},
           "train": {name: {k: v for k, v in r.items() if k != "bits"} for name, r in train.items()}}
    emit({"phase": "interpret_extras_remat", "card": card, "search_clips": REMAT_CLIPS,
          "search_steps": REMAT_STEPS, "train_batch": TRAIN_BATCH, **row})
    return row


def _extras_fuse_3x3(counters, weights, require, card) -> dict:
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    ds = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    small = torch.stack([torch.from_numpy(ds[i][0]) for i in range(BATCH)]).to(EXTRAS_DEVICE).float()
    gen = torch.Generator(device=EXTRAS_DEVICE).manual_seed(33)
    big = torch.randint(0, 256, (REMAT_CLIPS, CLIP_T, CLIP_HW, CLIP_HW, 3), generator=gen,
                        device=EXTRAS_DEVICE, dtype=torch.uint8).float()
    out = {}
    for label, clips, dtype, flags in (("f32_kernels_b4", small, torch.float32, GUIDED_ROUTES["f32_kernels"][0]),
                                       ("bf16_default_b128", big, torch.bfloat16, dict(pool_impl="argmax"))):
        targets = torch.arange(clips.shape[0], device=EXTRAS_DEVICE) % CLASSES
        models = {name: _extras_i3d(weights, dtype, fuse_3x3=fuse, **flags)
                  for name, fuse in (("off", False), ("true", True), ("auto", "auto"))}
        with torch.no_grad():
            scores = {name: m(clips).float() for name, m in models.items()}
            if dtype == torch.bfloat16:
                f32 = _extras_i3d(weights)(clips)
        masks = {name: _search_from_carry(counters, m, clips, targets, REMAT_STEPS)[0]
                 for name, m in models.items()}
        tol = FUSE3_BF16_TOL if dtype == torch.bfloat16 else {
            "scores": FUSE3_F32_TOL["scores"] * float(scores["off"].abs().max()), "masks": FUSE3_F32_TOL["masks"]}
        row = {}
        for name in ("true", "auto"):
            s_gap = float((scores[name] - scores["off"]).abs().max())
            m_gap = float((masks[name] - masks["off"]).abs().max())
            row[name] = {"scores_max_abs_gap": s_gap, "masks_max_abs_gap": m_gap}
            if dtype == torch.bfloat16:
                row[name]["scores_vs_f32"] = float((scores[name] - f32).abs().max())
            require(f"fuse_3x3_{label}_{name}", s_gap <= tol["scores"] and m_gap <= tol["masks"], row[name])
        if dtype == torch.bfloat16:
            row["off_scores_vs_f32"] = float((scores["off"] - f32).abs().max())
            row.update(_fuse3_bf16_cause(models, clips, scores["off"]))
            wrong = row["wrong_fusion_scores_gap"]
            require("fuse_3x3_bf16_controls_caught", min(wrong.values()) > tol["scores"], wrong)
        out[label] = row
        emit({"phase": "interpret_extras_fuse_3x3", "card": card, "run": label, "vs_off": row,
              "limits": {"f32": FUSE3_F32_TOL, "bf16": FUSE3_BF16_TOL}, "reasons": [FUSE3_REASON, FUSE3_BF16_REASON]})
        _step_timing("interpret_extras_fuse_3x3_timing", models, clips, card,
                     turns=("off", "true", "auto", "auto", "true", "off"), steps=3)
        del models, scores, masks
        torch.cuda.empty_cache()
    return out


# wrong fusions, the bf16 limit's controls: one block's b2b kernel as the
# block-diagonal conv would take it with a layout slip, its input channels
# one off or its taps turned 180 degrees in H and W (not at Mixed_5c, where
# the logits' global mean sums a turned kernel's outputs almost alike)
FUSE3_CONTROLS = {
    "Mixed_3b_input_channels_rolled": ("Mixed_3b", lambda k: k.roll(1, 1)),
    "Mixed_5c_input_channels_rolled": ("Mixed_5c", lambda k: k.roll(1, 1)),
    "Mixed_3b_turned_hw": ("Mixed_3b", lambda k: k.flip(3, 4)),
}


def _fuse3_bf16_cause(models: dict, clips, off_scores) -> dict:
    """The bf16 scores' gap to off with ``fuse_3x3`` on one block at a time
    (in the off model), and with every block fused but one block's b2b
    kernel slipped as in ``FUSE3_CONTROLS`` (wrong fusions, the limit's
    controls)."""
    from unittest import mock

    gap = lambda m: float((m(clips).float() - off_scores).abs().max())  # noqa: E731
    one, wrong = {}, {}
    with torch.no_grad():
        for name, _, _ in FUSED_SITES:
            block = getattr(models["off"], name)
            block.fuse_3x3 = True
            one[name] = gap(models["off"])
            block.fuse_3x3 = False
        for bug, (name, slip) in FUSE3_CONTROLS.items():
            b2b = getattr(models["true"], name).b2b
            k, c = b2b.folded()
            with mock.patch.object(b2b, "folded", lambda: (slip(k), c)):
                wrong[bug] = gap(models["true"])
    return {"one_block_scores_gap": one, "wrong_fusion_scores_gap": wrong}


def _extras_find_mask(weights, require, card) -> dict:
    from ivf_tpu_torch.data.synthetic import SyntheticClips
    from ivf_tpu_torch.interpret import find_mask, mask_opt

    ds = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    clips = torch.stack([torch.from_numpy(ds[i][0]) for i in range(BATCH)]).to(EXTRAS_DEVICE).float()
    targets = torch.tensor([ds[i][1] for i in range(BATCH)], device=EXTRAS_DEVICE)
    model = _extras_i3d(weights, torch.float32, **GUIDED_ROUTES["f32_kernels"][0])
    score = lambda x: model(x).float()  # noqa: E731
    init = _central_carry(BATCH, CLIP_T).logits
    batched = mask_opt.find_mask_batched(score, clips, targets, init, n_steps=REMAT_STEPS)
    one = find_mask(score, clips[0], int(targets[0]), init[0], n_steps=REMAT_STEPS)
    m_gap = float((one.mask - batched.mask[0]).abs().max())
    s_gap = max(abs(float(getattr(one, k)) - float(getattr(batched, k)[0])) / max(abs(float(getattr(batched, k)[0])),
                                                                                 1e-12)
                for k in ("freeze_score", "reverse_score", "orig_score"))
    require("find_mask_vs_batched_row0", m_gap <= FIND_MASK_TOL["masks"] and s_gap <= FIND_MASK_TOL["scores"],
            (m_gap, s_gap))
    row = {"masks_max_abs_gap": m_gap, "scores_max_rel_gap": s_gap, "n_steps_run": int(one.n_steps_run)}
    emit({"phase": "interpret_extras_find_mask", "card": card, "clips": BATCH, "steps": REMAT_STEPS, **row,
          "limits": FIND_MASK_TOL, "reason": FIND_MASK_REASON})
    return row


def _extras_profile(counters, require, card) -> dict:
    """``cli find-masks --profile DIR`` on the f32 pointwise route: the trace
    names the hand kernels the run launched."""
    import numpy as np

    from ivf_tpu_torch import cli

    root = Path(__file__).resolve().parent
    rng = np.random.RandomState(44)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _write_jpegs({tmp / "smth" / "validation" / str(i * 17 % CLASSES) / f"clip{i}":
                      rng.randint(0, 256, (CLIP_T, CLIP_HW, CLIP_HW, 3)).astype(np.uint8)
                      for i in range(PROFILE_CLIPS)})
        cfg = _preset_module(tmp / "cfg.py", root / "configs" / "config_i3d_smth.py",
                             output_dir=str(tmp / "out"), data_folder=str(tmp / "smth"))
        args = ["find-masks", "-c", cfg, "-bs", str(PROFILE_CLIPS), "-opti", str(PROFILE_STEPS),
                "--use_pallas", "1", "--profile", str(tmp / "trace")]
        t0 = time.perf_counter()
        (tm, _), launched = _launched(counters, lambda: cli.main(args))
        seconds = time.perf_counter() - t0
        traces = list((tmp / "trace").glob("*.pt.trace.json"))
        text = traces[0].read_text() if len(traces) == 1 else ""
        named = {k: k in text for k in ("pw_gemm_f32",)}
        row = {"records": len(tm), "launches": launched, "trace_files": len(traces), "trace_bytes": len(text),
               "trace_names": named, "seconds": seconds}
    require("profile_trace_names_the_kernels",
            len(traces) == 1 and all(named.values()) and launched.get("pointwise_conv", 0) > 0
            and len(tm) == PROFILE_CLIPS, row)
    emit({"phase": "interpret_extras_profile", "card": card, "clips": PROFILE_CLIPS, "steps": PROFILE_STEPS, **row})
    return row


def interpret_extras_child() -> int:
    """``python3 chip_smoke.py --interpret-extras-child``, the
    ``interpret_extras`` phase's own process: i3d_smth at full width (174
    classes, 16x224x224, the main path's seeded weights). Guided backprop
    on one clip on three routes, the kernel route against its plain
    versions and the plain route; ``remat`` in the bf16 default-route
    search at 128 clips and in one f32 kernel-route train step at batch
    16 (equal bits, statistics moved once, the blocks' forward kernels
    launched twice); ``fuse_3x3`` True and ``'auto'`` against off at batch
    4 (f32 kernel route) and 128 (bf16 default route), with device ms in
    turns; ``find_mask`` against row 0 of ``find_mask_batched``; ``cli
    find-masks --profile``. One JSON line per part; the failures on stderr
    and exit code 1."""
    from ivf_tpu_torch import api
    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    t_phase = time.perf_counter()
    card, counters, failures, checks = nvidia_smi(), launch_counters(), [], {}

    def require(label, ok, detail):
        if not ok:
            failures.append(f"interpret_extras {label}: {detail}")
        checks[label] = bool(ok)

    cfg = Config()
    for name, value in FUSED_ROUTES["kernels"].items():
        setattr(cfg.model, name, value)
    weights = _scaled_weights(cfg, api)
    clip = torch.from_numpy(SyntheticClips(1, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)[0][0]).to(EXTRAS_DEVICE).float()
    seconds = {}
    for part, run in (("guided", lambda: _extras_guided(counters, weights, clip, require, card)),
                      ("remat", lambda: _extras_remat(api, counters, weights, require, card)),
                      ("fuse_3x3", lambda: _extras_fuse_3x3(counters, weights, require, card)),
                      ("find_mask", lambda: _extras_find_mask(weights, require, card)),
                      ("profile", lambda: _extras_profile(counters, require, card))):
        t0 = time.perf_counter()
        run()
        seconds[part] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    emit({"phase": "interpret_extras_compare", "card": card, "checks": checks, "seconds": seconds,
          "phase_seconds": time.perf_counter() - t_phase, "required": "every check true"})
    for f in failures:
        print(f, file=sys.stderr)
    return 1 if failures else 0


def phase_interpret_extras(failures) -> None:
    """The ``interpret_extras`` phase in a child process
    (``interpret_extras_child``), after the earlier phases' memory is
    released. Its JSON lines pass through."""
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--interpret-extras-child"],
                          capture_output=True, text=True, timeout=600)
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            emit(json.loads(line))
    if proc.returncode != 0:
        failures.append(f"interpret_extras child exited {proc.returncode}: {proc.stderr[-3000:]}")


def kernels_line(cases: dict, launches: dict, dp: dict) -> dict:
    """One entry per kernel, timed at its headline main-path shape;
    ``launches`` from the main path that runs it; ``dp_launches`` the
    ``parallel`` phase's mesh runs that launched it (each equal to the run
    without the mesh)."""
    headline = {
        "pointwise_conv": ("Mixed_3b_trio", "ivf_tpu/ops/pallas/pointwise_conv.py:29",
                           "ivf_tpu_torch/csrc/pointwise_conv.cu"),
        "maxpool3d_s1_fwd": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:88",
                             "ivf_tpu_torch/csrc/maxpool3d.cu"),
        "maxpool3d_s1_bwd": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:99",
                             "ivf_tpu_torch/csrc/maxpool3d.cu"),
        "lstm_gates_fwd": ("layer1", "ivf_tpu/ops/pallas/fused_gates.py:33",
                           "ivf_tpu_torch/csrc/fused_gates.cu"),
        "lstm_gates_bwd": ("layer1", "ivf_tpu/ops/pallas/fused_gates.py:92",
                           "ivf_tpu_torch/csrc/fused_gates.cu"),
    }
    headline.update({
        "pointwise_conv_bf16": ("Mixed_3b_trio", "ivf_tpu/ops/pallas/pointwise_conv.py:29",
                                "ivf_tpu_torch/csrc/pointwise_conv.cu"),
        "maxpool3d_s1_fwd_bf16": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:88",
                                  "ivf_tpu_torch/csrc/maxpool3d.cu"),
        "maxpool3d_s1_bwd_bf16": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:99",
                                  "ivf_tpu_torch/csrc/maxpool3d.cu"),
        "argmax_pool_fwd": ("Mixed_3b", "ivf_tpu/ops/conv.py:330", "ivf_tpu_torch/csrc/argmax_pool.cu"),
        "argmax_pool_bwd": ("Mixed_3b", "ivf_tpu/ops/conv.py:356", "ivf_tpu_torch/csrc/argmax_pool.cu"),
    })
    fb_src = "ivf_tpu_torch/csrc/fused_branch3.cu"
    for name, line in (("fused_pool_conv_fwd", 57), ("fused_pool_conv_bwd", 72),
                       ("fused_pool_conv_tblock_fwd", 279), ("fused_pool_conv_tblock_bwd", 327)):
        headline[name] = ("Mixed_3b", f"ivf_tpu/ops/pallas/fused_branch3.py:{line}", fb_src)
        headline[f"{name}_bf16"] = headline[name]
    headline["lstm_gates_fwd_bf16"] = headline["lstm_gates_fwd"]
    headline["lstm_gates_bwd_bf16"] = headline["lstm_gates_bwd"]
    headline["lstm_gates_fwd_bf16s"] = headline["lstm_gates_fwd"]
    headline["lstm_gates_bwd_bf16s"] = headline["lstm_gates_bwd"]
    headline["lstm_gate_tables"] = ("all_bf16", "ivf_tpu/ops/pallas/fused_gates.py:33",
                                    "ivf_tpu_torch/csrc/fused_gates.cu")
    out = []
    for name, (site, replaces, source) in headline.items():
        row = next(c for c in cases[name] if c["site"] == site and c.get("relu", True))
        entry = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "at": {"site": site, "shape": row["shape"]},
        }
        dp_launches = {run: counts[name] for run, counts in dp.items() if counts.get(name)}
        if dp_launches:
            entry["dp_launches"] = dp_launches
        if "events_ms" in row:  # the pool pair's second timer (pool_rows)
            entry.update({"events_ms": row["events_ms"], "library_events_ms": row["library_events_ms"]})
        if name.startswith("fused_pool_conv"):
            entry.update({
                "cold_ms": row["cold_ms"], "unfused_kernel_pair_ms": row["pair_ms"],
                "library": "F.max_pool3d + torch.matmul: no one PyTorch call computes the fused function"
                if "fwd" in name else "none: no PyTorch call has the every-tie gather",
            })
        elif name in BF16_GATE_COUNTERS:
            entry.update({"f32_kernel_ms": row["f32_kernel_ms"], "library": row["library_note"]})
        elif name in BF16S_GATE_COUNTERS:
            entry.update({"library": row["library_note"], "cold_ms": row["cold_ms"],
                          "launches_of": "checkpoint_cli: the bf16 ConvLSTM `cli train` run (2 steps)"})
        elif name == "lstm_gate_tables":
            entry.update({"library": row["library_note"], "ranges": row["ranges"],
                          "launches_of": "checkpoint_cli: the bf16 ConvLSTM `cli train` run, the tables "
                                         "released just before it (once per device and process)"})
        out.append(entry)
    return {"kernels": out}


def launch_counters() -> dict:
    """Every CUDA wrapper of the port by name; each counts its launches in
    its ``launches`` attribute."""
    from ivf_tpu_torch.ops.kernels import argmax_pool as ap
    from ivf_tpu_torch.ops.kernels import fused_branch3 as fb
    from ivf_tpu_torch.ops.kernels import fused_gates as gates
    from ivf_tpu_torch.ops.kernels import maxpool3d as pool
    from ivf_tpu_torch.ops.kernels import pointwise_conv as pw

    return {
        "pointwise_conv": pw.pointwise_conv_cuda,
        "maxpool3d_s1_fwd": pool.maxpool3d_s1_fwd_cuda,
        "maxpool3d_s1_bwd": pool.maxpool3d_s1_bwd_cuda,
        "lstm_gates_fwd": gates.lstm_gates_fwd_cuda,
        "lstm_gates_bwd": gates.lstm_gates_bwd_cuda,
        "fused_pool_conv_fwd": fb.fused_pool_conv_fwd_cuda,
        "fused_pool_conv_bwd": fb.fused_pool_conv_bwd_cuda,
        "fused_pool_conv_tblock_fwd": fb.fused_pool_conv_tblock_fwd_cuda,
        "fused_pool_conv_tblock_bwd": fb.fused_pool_conv_tblock_bwd_cuda,
        "pointwise_conv_bf16": pw.pointwise_conv_bf16_cuda,
        "maxpool3d_s1_fwd_bf16": pool.maxpool3d_s1_fwd_bf16_cuda,
        "maxpool3d_s1_bwd_bf16": pool.maxpool3d_s1_bwd_bf16_cuda,
        "argmax_pool_fwd": ap.argmax_pool_fwd_cuda,
        "argmax_pool_bwd": ap.argmax_pool_bwd_cuda,
        "fused_pool_conv_fwd_bf16": fb.fused_pool_conv_fwd_bf16_cuda,
        "fused_pool_conv_bwd_bf16": fb.fused_pool_conv_bwd_bf16_cuda,
        "fused_pool_conv_tblock_fwd_bf16": fb.fused_pool_conv_tblock_fwd_bf16_cuda,
        "fused_pool_conv_tblock_bwd_bf16": fb.fused_pool_conv_tblock_bwd_bf16_cuda,
        "lstm_gates_fwd_bf16": gates.lstm_gates_fwd_bf16_cuda,
        "lstm_gates_bwd_bf16": gates.lstm_gates_bwd_bf16_cuda,
        "lstm_gates_fwd_bf16s": gates.lstm_gates_fwd_bf16s_cuda,
        "lstm_gates_bwd_bf16s": gates.lstm_gates_bwd_bf16s_cuda,
        "lstm_gate_tables": gates.lstm_gate_tables_cuda,
    }


def main() -> int:
    global _T0
    _T0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ivf_tpu_torch import api
        from ivf_tpu_torch.ops.kernels import argmax_pool as ap
        from ivf_tpu_torch.ops.kernels import build
        from ivf_tpu_torch.ops.kernels import fused_branch3 as fb
        from ivf_tpu_torch.ops.kernels import fused_gates as gates
        from ivf_tpu_torch.ops.kernels import maxpool3d as pool
        from ivf_tpu_torch.ops.kernels import pointwise_conv as pw
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    failures: list = []
    counters = launch_counters()
    info = phase_build(build)
    cases = phase_kernel_check(pw, pool, failures)
    cases.update(phase_gate_check(gates, failures))
    cases.update(phase_fused_check(fb, pool, pw, failures))
    cases.update(phase_bf16_kernel_check(pw, pool, ap, failures))
    cases.update(phase_bf16_fused_gate_check(fb, gates, pool, pw, failures))
    phase_stem_s2d_check(failures, info["smi"])
    phase_small_reference(failures)
    launches, f32_run = phase_main_path(api, counters, failures, info["smi"])
    phase_step_timing(api, info["smi"], failures)
    phase_determinism(api, counters, failures, info["smi"], f32_run["weights"])
    launches.update(phase_bf16_main_path(api, counters, failures, info["smi"], f32_run))
    phase_bf16_step_timing(api, info["smi"], f32_run["weights"])
    phase_clstm_small_reference(failures)
    clstm_weights = _clstm_scaled_weights(api, _clstm_clips()[0][0])
    clstm_run = phase_clstm_main_path(api, counters, failures, info["smi"], clstm_weights)
    launches.update({k: clstm_run["launches"][k] for k in ("lstm_gates_fwd", "lstm_gates_bwd")})
    launches.update(phase_clstm_bf16_main_path(api, counters, failures, info["smi"], clstm_weights, clstm_run))
    phase_clstm_step_timing(api, info["smi"], clstm_weights)
    phase_refill(api, counters, failures, info["smi"], f32_run["weights"])
    phase_driver(api, counters, failures, info["smi"], f32_run["weights"])
    phase_data_path(api, counters, failures, info["smi"], f32_run["weights"], clstm_weights)
    phase_artifacts(api, counters, failures, info["smi"], f32_run["weights"], clstm_weights)
    phase_pool_impls(api, counters, failures, info["smi"], f32_run["weights"])
    phase_train_kernel_check(pw, gates, failures, info["smi"])
    phase_train_i3d(api, counters, failures, info["smi"])
    phase_train_clstm(api, counters, failures, info["smi"])
    phase_cnn_3d(api, counters, failures, info["smi"])
    phase_records_search(api, counters, failures, info["smi"])
    launches.update(phase_checkpoint_cli(api, counters, failures, info["smi"], f32_run["weights"]))
    phase_serve(failures)
    dp = phase_parallel(failures)
    phase_interpret_extras(failures)
    phase_whole_search(api, counters, failures, info["smi"], f32_run["weights"])
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit(kernels_line(cases, launches, dp))
    print(info["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:] == ["--determinism-child"]:
        sys.exit(determinism_child())
    if sys.argv[1:] == ["--serve-child"]:
        sys.exit(serve_child())
    if sys.argv[1:] == ["--parallel-child"]:
        sys.exit(parallel_child())
    if sys.argv[1:] == ["--interpret-extras-child"]:
        sys.exit(interpret_extras_child())
    if sys.argv[1:] == ["--bf16-width-sweep"]:
        sys.exit(bf16_width_sweep())
    if sys.argv[1:] == ["--fused-sweep"]:
        sys.exit(fused_sweep())
    if sys.argv[1:] == ["--f32-tile-sweep"]:
        sys.exit(f32_tile_sweep())
    if len(sys.argv) == 3 and sys.argv[1] == "--f32-compare":
        sys.exit(f32_compare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--f32-rows":
        sys.exit(f32_rows(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--argmax-compare":
        sys.exit(argmax_compare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--argmax-rows":
        sys.exit(_rows_child(sys.argv[2], "argmax_pool", "argmax_rows",
                             lambda ap, failures: [argmax_rows(ap, failures)]))
    if sys.argv[1:] == ["--pool-sweep"]:
        sys.exit(pool_sweep())
    if len(sys.argv) == 3 and sys.argv[1] == "--gates-compare":
        sys.exit(gates_compare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pool-compare":
        sys.exit(pool_compare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--whole-compare":
        sys.exit(whole_compare(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--whole-rows":
        sys.exit(whole_rows(sys.argv[2]))
    if len(sys.argv) == 3 and sys.argv[1] == "--pool-rows":
        sys.exit(_rows_child(sys.argv[2], "maxpool3d", "pool_rows", lambda pool, failures: (
            pool_rows(pool, failures, dtype) for dtype in (torch.float32, torch.bfloat16))))
    sys.exit(main())
