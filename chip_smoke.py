#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ivf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase"``); any failure exits
non-zero without the final line:

1. build: compile the CUDA kernels from ``ivf_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and report the compiler's register/spill
   summary and the card's ``nvidia-smi`` name and power limit.
2. kernel_check: each CUDA kernel against its plain PyTorch version on
   the card, at the main paths' shapes and a ragged one, TF32 off; with
   the kernel's time, the plain version's, one PyTorch library call's
   (a yardstick only) and the card's lower bound for the same work. The
   four fused branch-3 kernels at all nine branch-3 sites, per-frame
   against whole-sample too, timed beside the unfused kernel pair.
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
   routes, in turns, and a profiled step of each (device time by kernel
   group, top kernels).
6. clstm_small_reference: the ConvLSTM (torch family with the gate
   kernel; TF family with hard-sigmoid gates, 'valid' padding, per-layer
   BN) on the card vs the same model on the CPU: logits, input gradient.
7. clstm_main_path: ``find_masks`` on the clstm_kth preset at full width
   (6 classes, 32x120x160 clips, 2 layers x 4 hidden, stride 2) over 16
   clips, 10 search steps, Grad-CAM on -- a warm-up run, then one with the
   gate kernel (counters reset just before, read just after) and one
   without; outputs checked and compared.
8. clstm_step_timing: as step_timing, for the ConvLSTM search step, in
   twice the turns, plus 12 pairs of single steps (on and off back to
   back) and the host's launch rate before and after them.

Then the ``kernels`` line, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

# H100 SXM published peaks (float32 on the CUDA cores, HBM3)
PEAK_F32_FLOPS = 67e12
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
# (kernel_check, route_step_bits), but whole find_masks runs on the card
# are not reproducible: the same route run twice gives other masks
# (float32 noise, which Adam's scale-free update carries into the masks).
# That run twice is reported beside the comparisons ("kernels_again").
FUSED_MASK_TOL = 1e-3
FUSED_MASK_TOL_REASON = (
    "the fused kernels keep the pool kernel's every-tie rule and give the "
    "unfused kernel pair's bits, but find_masks on the card is not "
    "reproducible run to run (kernels_again vs kernels); the fused routes "
    "came 1.2e-4 to 2.6e-4 from the pool route in two full runs on an "
    "H100; equal bits on the CPU (tests/test_torch_api.py)"
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
# operations counted per (row, channel) of the gate block: the gate sums,
# three sigmoids, two tanh and the state update (forward); the recompute
# plus the five gradient formulas (backward)
GATE_OPS_FWD, GATE_OPS_BWD = 20, 40


def emit(obj: dict) -> None:
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush()
            fn()
        torch.cuda.synchronize()
    return sum(kernel_us(prof, skip).values()) / reps / 1e3


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take: bytes over HBM bandwidth vs
    operations over the float32 peak, the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    reports = build.build(["pointwise_conv", "maxpool3d", "fused_gates", "fused_branch3"])
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


def phase_kernel_check(pw, pool, failures) -> dict:
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cases = {"pointwise_conv": [], "maxpool3d_s1_fwd": [], "maxpool3d_s1_bwd": []}
    b = BATCH
    pw_shapes = [  # the main path's batch, then one clip's, then ragged
        ("Conv3d_2b", b * 8 * 56 * 56, 64, 64),
        ("Mixed_3b_trio", b * 8 * 28 * 28, 192, 176),
        ("logits", b, 1024, 174),
        ("Conv3d_2b/clip", 8 * 56 * 56, 64, 64),
        ("Mixed_3b_trio/clip", 8 * 28 * 28, 192, 176),
        ("logits/clip", 1, 1024, 174),
        ("ragged", 150, 112, 48),
    ]
    for site, n, cin, cout in pw_shapes:
        x = _ties((n, cin), gen, dev)
        w = (torch.randn(cin, cout, generator=gen) / cin**0.5).to(dev)
        bias = torch.randn(cout, generator=gen).to(dev)
        for relu, use_bias in ((True, True), (False, False)):
            bb = bias if use_bias else None
            y = pw.pointwise_conv_cuda(x, w, bb, relu)
            ref = pw.pointwise_conv_plain(x, w, bb, relu)
            torch.cuda.synchronize()
            err = (y - ref).abs().max().item()
            tol = 1e-5 * ref.abs().max().item()
            nbytes = 4 * (n * cin + cin * cout + n * cout + (cout if use_bias else 0))
            bms, by = bound(nbytes, 2 * n * cin * cout)
            case = {
                "site": site, "shape": [n, cin, cout], "relu": relu, "bias": use_bias,
                "max_abs_err": err, "tol": tol,
                "ms": cuda_ms(lambda: pw.pointwise_conv_cuda(x, w, bb, relu)),
                "plain_ms": cuda_ms(lambda: pw.pointwise_conv_plain(x, w, bb, relu)),
                "library_ms": cuda_ms(lambda: torch.matmul(x, w)),
                "bound_ms": bms, "bound_by": by,
            }
            cases["pointwise_conv"].append(case)
            if not err <= tol:
                failures.append(f"pointwise_conv {site} relu={relu} bias={use_bias}: err {err} > {tol}")

    for site, shape in (("Mixed_3b", (b, 8, 28, 28, 192)), ("Mixed_5b", (b, 2, 7, 7, 832))):
        x = _ties(shape, gen, dev)
        g = torch.randn(shape, generator=gen).to(dev)
        y = pool.maxpool3d_s1_fwd_cuda(x)
        dx = pool.maxpool3d_s1_bwd_cuda(x, y, g)
        y_ref = pool.maxpool3d_s1_fwd_plain(x)
        dx_ref = pool.maxpool3d_s1_bwd_plain(x, y, g)
        torch.cuda.synchronize()
        numel = x.numel()
        xc = x.permute(0, 4, 1, 2, 3)
        for name, err, tol, fn, plain, lib, nbytes, ops in (
            ("maxpool3d_s1_fwd", (y - y_ref).abs().max().item(), 0.0,
             lambda: pool.maxpool3d_s1_fwd_cuda(x), lambda: pool.maxpool3d_s1_fwd_plain(x),
             lambda: torch.nn.functional.max_pool3d(xc, 3, 1, 1), 8 * numel, 26 * numel),
            ("maxpool3d_s1_bwd", (dx - dx_ref).abs().max().item(), 1e-6,
             lambda: pool.maxpool3d_s1_bwd_cuda(x, y, g),
             lambda: pool.maxpool3d_s1_bwd_plain(x, y, g), None, 16 * numel, 54 * numel),
        ):
            bms, by = bound(nbytes, ops)
            cases[name].append({
                "site": site, "shape": list(shape), "max_abs_err": err, "tol": tol,
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain, reps=5),
                "library_ms": cuda_ms(lib) if lib is not None else None,
                "bound_ms": bms, "bound_by": by,
            })
            if not err <= tol:
                failures.append(f"{name} {site}: err {err} > {tol}")
    for name, rows in cases.items():
        for row in rows:
            emit({"phase": "kernel_check", "kernel": name, **row})
    return cases


def phase_gate_check(gates, failures) -> dict:
    """The fused-gates kernels against their plain versions at both
    layers of the clstm_kth main path (batch 16), the merged-conv route
    (no ``gates_h``) and a ragged size; ``_thnn_fused_lstm_cell`` (and its
    backward) on the same inputs as the yardstick, checked to agree.

    Tolerances: h' in (-1, 1) within 1e-6 absolute; c', dz and dc within
    1e-6 of max(1, their largest magnitude): accurate expf/tanhf in both,
    but the kernel contracts products into FMAs where PyTorch rounds each
    elementwise op, a few ulps apart."""
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    b, (h1, w1) = CLSTM_BATCH, (CLSTM_HW[0] // 2, CLSTM_HW[1] // 2)
    sites = [  # (site, leading shape, Ch, with gates_h)
        ("layer1", (b, h1, w1), 4, True),
        ("layer2", (b, h1 // 4, w1 // 4), 4, True),
        ("layer1_merged", (b, h1, w1), 4, False),
        ("ragged", (3, 7, 9), 5, True),
        ("ragged_merged", (3, 7, 9), 5, False),
    ]
    aten = torch.ops.aten
    cases = {"lstm_gates_fwd": [], "lstm_gates_bwd": []}
    for site, lead, ch, with_gh in sites:
        gx = torch.randn(*lead, 4 * ch, generator=gen).to(dev)
        gh = torch.randn(*lead, 4 * ch, generator=gen).to(dev) if with_gh else None
        c, dh, dc_out = (torch.randn(*lead, ch, generator=gen).to(dev) for _ in range(3))
        h_new, c_new = gates.lstm_gates_fwd_cuda(gx, gh, c)
        dz, dc = gates.lstm_gates_bwd_cuda(gx, gh, c, dh, dc_out)
        h_ref, c_ref = gates.gate_math_plain(gx, gh, c)
        dz_ref, dc_ref = gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out)
        # the library call: the same function on (rows, 4 Ch) views
        rows = c.numel() // ch
        lib_in = (gx.view(rows, 4 * ch), (gh if with_gh else torch.zeros_like(gx)).view(rows, 4 * ch),
                  c.view(rows, ch))
        hy, cy, ws = aten._thnn_fused_lstm_cell(*lib_in)
        dgates, dcx, _ = aten._thnn_fused_lstm_cell_backward_impl(
            dh.view(rows, ch), dc_out.view(rows, ch), lib_in[2], cy, ws, False)
        torch.cuda.synchronize()

        def err(a, b_):
            return (a - b_).abs().max().item()

        def rel_tol(ref):
            return 1e-6 * max(1.0, ref.abs().max().item())

        fwd_errs = {"h": (err(h_new, h_ref), 1e-6), "c": (err(c_new, c_ref), rel_tol(c_ref))}
        bwd_errs = {"dz": (err(dz, dz_ref), rel_tol(dz_ref)), "dc": (err(dc, dc_ref), rel_tol(dc_ref))}
        lib_errs = {
            "h": (err(hy.view_as(h_new), h_new), 1e-6), "c": (err(cy.view_as(c_new), c_new), rel_tol(c_ref)),
            "dz": (err(dgates.view_as(dz), dz), rel_tol(dz_ref)), "dc": (err(dcx.view_as(dc), dc), rel_tol(dc_ref)),
        }
        numel, znumel = c.numel(), gx.numel()
        z_in = znumel * (2 if with_gh else 1)
        for name, errs, fn, plain, lib, nbytes, ops, lib_keys in (
            ("lstm_gates_fwd", fwd_errs,
             lambda: gates.lstm_gates_fwd_cuda(gx, gh, c), lambda: gates.gate_math_plain(gx, gh, c),
             lambda: aten._thnn_fused_lstm_cell(*lib_in),
             4 * (z_in + 3 * numel), GATE_OPS_FWD * numel, ("h", "c")),
            ("lstm_gates_bwd", bwd_errs,
             lambda: gates.lstm_gates_bwd_cuda(gx, gh, c, dh, dc_out),
             lambda: gates.gate_math_bwd_plain(gx, gh, c, dh, dc_out),
             lambda: aten._thnn_fused_lstm_cell_backward_impl(
                 dh.view(rows, ch), dc_out.view(rows, ch), lib_in[2], cy, ws, False),
             4 * (z_in + znumel + 4 * numel), GATE_OPS_BWD * numel, ("dz", "dc")),
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
    for name, rows_ in cases.items():
        for row in rows_:
            emit({"phase": "kernel_check", "kernel": name, **row})
    return cases


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
                    timed = {"fwd": lambda: fwd(x, wt, b, True), "bwd": lambda: bwd(x, y, g, wt, True)}
                    for d, fn in timed.items():
                        rows[d].update({"ms": device_ms(fn), "cold_ms": device_ms(fn, cold=True), **shared[d]})
                for d, row in rows.items():
                    bms, by = row.pop("bound")
                    cases[f"{name}_{d}"].append({
                        "site": site, "shape": list(shape), "cout": cout, "relu": relu, **row,
                        "bound_ms": bms, "bound_by": by, "frame_vs_tblock": between,
                    })
                    if not row["max_abs_err"] <= row["tol"]:
                        failures.append(f"{name}_{d} {site} relu={relu}: err {row['max_abs_err']} > {row['tol']}")
            if not (between["fwd_err"] <= y_tol and between["bwd_err"] <= 1e-5 * max(1.0, dxf.abs().max().item())):
                failures.append(f"fused per-frame vs tblock {site} relu={relu}: {between}")
    for name, rows_ in cases.items():
        for row in rows_:
            emit({"phase": "kernel_check", "kernel": name, **row})
    return cases


def phase_small_reference(failures) -> None:
    """Each kernel route inside the whole model, on a small input, against
    the same model on the CPU (plain versions, CPU conv)."""
    from ivf_tpu_torch.models import i3d_smth

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


def _check_route_launches(route: str, launches: dict, runs: dict, failures) -> None:
    """Which kernels each route must launch: none without kernels; the
    pointwise and pool kernels on the pool-kernel route; on a fused route
    its two kernels exactly as often as the pool kernels launched there,
    the pointwise kernel that many times fewer (b3b's convs), the pool
    kernels and the other fused variant never."""
    pool = ("maxpool3d_s1_fwd", "maxpool3d_s1_bwd")
    fused = FUSED_COUNTERS
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


def phase_main_path(api, counters, failures, card: str) -> dict:
    import numpy as np

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        # the first run in the process pays cuDNN's per-shape algorithm
        # choice and module loading: a run without the kernels goes first,
        # then the runs that are compared; the pool-kernel route runs again
        # last, to show how far the search differs from itself
        order = ("plain", "kernels", "plain", "fused", "fused_tblock", "kernels_again")
        for run, label in enumerate(order):
            route = label.replace("_again", "")
            cfg = Config()
            cfg.output_dir = out_dir
            cfg.model_name = f"chip_smoke_{run}_{label}"
            cfg.data.batch_size = BATCH
            cfg.mask.opt_iter = STEPS
            for name, value in FUSED_ROUTES[route].items():
                setattr(cfg.model, name, value)
            weights = _scaled_weights(cfg, api)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats = {}
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            tm, gc = api.find_masks(cfg, weights, dataset, stats=stats)
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            masks = np.stack([r["time_mask"] for r in tm])
            cams = np.stack([r["GCHeatMap"] for r in gc])
            res = Path(out_dir) / cfg.model_name / "results"
            pickles = sorted(p.name for p in res.glob("all*Results_*.p"))
            rate = stats["searched_rows"] * STEPS / stats["search_seconds"]
            runs[label] = dict(tm=tm, masks=masks, cams=cams, launches=launches)
            emit({
                "phase": "main_path", "run": run, "route": label, "flags": FUSED_ROUTES[route],
                "kernels": route != "plain", "card": card, "model": "i3d_smth",
                "clips": BATCH, "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3],
                "steps": STEPS, "mask_steps_per_s": rate,
                "search_seconds": stats["search_seconds"], "init_seconds": stats["init_seconds"],
                "wall_seconds": wall, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "masks": masks.round(4).tolist(), "pickles": pickles,
            })
            _check_route_launches(route, launches, runs, failures)
            if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
                failures.append(f"{route}: masks not finite in [0, 1]")
            if cams.shape != (BATCH, CLIP_T, CLIP_HW, CLIP_HW) or not np.isfinite(cams).all():
                failures.append(f"{route}: CAMs {cams.shape} not finite (B, 16, 224, 224)")
            if len(pickles) != 2:
                failures.append(f"{route}: pickles missing: {pickles}")
    # the masks differ here (the pool's tie rule), so the freeze and reverse
    # scores do too: only the original scores are held
    d = _diffs(runs["kernels"], runs["plain"], ("original_score_guess",))
    emit({"phase": "main_path_compare", "routes": ["kernels", "plain"], **d, "mask_tol": MASK_TOL,
          "mask_tol_reason": MASK_TOL_REASON, "cam_tol": 1e-3, "score_tol": 1e-4})
    if not (d["max_mask_diff"] <= MASK_TOL and d["max_cam_diff"] <= 1e-3 and d["max_score_diff"] <= 1e-4):
        failures.append(f"kernels on vs off: {d}")
    for a, b in (("kernels_again", "kernels"), ("fused", "kernels"), ("fused_tblock", "kernels"),
                 ("fused", "fused_tblock")):
        d = _diffs(runs[a], runs[b])
        emit({"phase": "main_path_compare", "routes": [a, b], **d, "mask_tol": FUSED_MASK_TOL,
              "mask_tol_reason": FUSED_MASK_TOL_REASON, "cam_tol": 1e-3, "score_tol": 1e-4})
        if not (d["max_mask_diff"] <= FUSED_MASK_TOL and d["max_cam_diff"] <= 1e-3
                and d["max_score_diff"] <= 1e-4):
            failures.append(f"{a} vs {b}: {d}")
    launches = dict(runs["kernels"]["launches"])
    for route, names in FUSED_COUNTERS.items():
        launches.update({n: runs[route]["launches"][n] for n in names})
    return launches


def _clstm_cfg(kernels: bool, out_dir: str = "", run_name: str = ""):
    """The clstm_kth preset (configs/config_clstm_kth.py) as the port's
    config, with 10 search steps."""
    from ivf_tpu_torch.config import Config

    cfg = Config()
    cfg.output_dir, cfg.model_name = out_dir, run_name
    m = cfg.model
    m.conv_model, m.num_classes = "clstm_kth", CLSTM_CLASSES
    m.clstm_hidden, m.clstm_layers, m.conv_stride, m.conv_kernel_size = 4, 2, 2, 5
    m.batch_norm, m.dropout, m.effective_steps = True, 0.5, (7, 15, 23, 31)
    m.use_pallas = kernels
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


def _clstm_scaled_weights(api, clip) -> dict:
    """Seeded weights with each layer's ``wx`` scaled so its gate
    pre-activations have unit std on one clip (raw 0-255 frames would
    otherwise saturate every sigmoid) and the fc head scaled so the 6
    class scores have std 2, as ``_scaled_weights`` does for I3D."""
    from ivf_tpu_torch.ops.conv import conv2d_same_torch

    model = api.build_model(_clstm_cfg(True), softmax_override=False, device="cuda")
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


def phase_clstm_main_path(api, counters, failures, card: str, weights: dict) -> dict:
    import numpy as np

    dataset = _clstm_clips()
    gate_names = ("lstm_gates_fwd", "lstm_gates_bwd")
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        # a run without the kernel first pays cuDNN's algorithm choice
        for run, kernels in enumerate((False, True, False)):
            cfg = _clstm_cfg(kernels, out_dir, f"chip_smoke_clstm_{run}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            stats = {}
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            tm, gc = api.find_masks(cfg, weights, dataset, stats=stats)
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            masks = np.stack([r["time_mask"] for r in tm])
            cams = np.stack([r["GCHeatMap"] for r in gc])
            res = Path(out_dir) / cfg.model_name / "results"
            pickles = sorted(p.name for p in res.glob("all*Results_*.p"))
            runs[kernels] = dict(tm=tm, masks=masks, cams=cams, launches=launches)
            emit({
                "phase": "clstm_main_path", "run": run, "kernels": kernels, "card": card,
                "model": "clstm_kth", "clips": CLSTM_BATCH,
                "clip_shape": [CLSTM_T, *CLSTM_HW, 3], "steps": STEPS,
                "mask_steps_per_s": stats["searched_rows"] * STEPS / stats["search_seconds"],
                "search_seconds": stats["search_seconds"], "init_seconds": stats["init_seconds"],
                "wall_seconds": wall, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "mask_std_over_clips": float(masks.std(axis=0).mean()),
                "masks": masks.round(4).tolist()[:4], "pickles": pickles,
            })
            gate = [launches[n] for n in gate_names]
            if kernels and not all(n > 0 for n in gate):
                failures.append(f"clstm main path with the kernel: a gate kernel never launched {launches}")
            if not kernels and any(launches.values()):
                failures.append(f"clstm main path without kernels launched one {launches}")
            if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
                failures.append("clstm masks not finite in [0, 1]")
            want = (CLSTM_BATCH, CLSTM_T, *CLSTM_HW)
            if cams.shape != want or not np.isfinite(cams).all():
                failures.append(f"clstm CAMs {cams.shape} not finite {want}")
            if len(pickles) != 2:
                failures.append(f"clstm pickles missing: {pickles}")
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
    return on["launches"]


def _group(name: str) -> str:
    if "fpc_frame" in name or "fpc_tblock" in name:
        return "fused_branch3 kernels"
    if "lstm_gates" in name:
        return "fused_gates kernels"
    if "pw_gemm" in name:
        return "pointwise_conv kernel"
    if "pool_fwd" in name or "pool_bwd" in name:
        return "maxpool3d_s1 kernels"
    low = name.lower()
    # cuDNN's implicit-GEMM convs carry "xmma" too, as cuBLAS's sm80_xmma_gemm
    # does: tell them apart by "implicit_gemm"
    if "conv" in low or "implicit_gemm" in low or "cudnn" in low:
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
    for route in ("kernels", "plain", "fused", "fused_tblock"):
        cfg = Config()
        for name, value in FUSED_ROUTES[route].items():
            setattr(cfg.model, name, value)
        model = api.build_model(cfg, softmax_override=True)
        model.load_state_dict(weights)
        models[route] = model.requires_grad_(False)
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
    turns = ("kernels", "plain", "fused", "fused_tblock", "fused_tblock", "fused", "plain", "kernels")
    _step_timing("step_timing", models, clips, card, turns=turns)


def phase_clstm_step_timing(api, card: str, weights: dict) -> None:
    """Steady per-step wall time of the ConvLSTM search (kernel on / off)."""
    import numpy as np

    clips = torch.from_numpy(np.stack([c for c, _, _ in _clstm_clips()])).cuda().float()
    models = {}
    for route in ("kernels", "plain"):
        model = api.build_model(_clstm_cfg(route == "kernels"), softmax_override=True)
        model.load_state_dict(weights)
        models[route] = model.requires_grad_(False)
    # the host bounds this step and shares its cores: twice the turns
    _step_timing("clstm_step_timing", models, clips, card,
                 turns=("kernels", "plain", "plain", "kernels") * 2, pairs=12)


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


def _step_timing(phase: str, models: dict, clips, card: str, turns, pairs: int = 0) -> None:
    """Steady per-step wall time of the search for each route of ``models``
    (route name -> model), five steps after a warm-up in each of ``turns``,
    then one profiled step of each: device time by kernel group, the
    device-busy share and the top kernels. With ``pairs``, also that many
    single steps of the first two routes (kernels on, then off), back to
    back with the first of each pair alternating, and the host's launch
    rate before and after: a host-bound step drifts with the host's speed,
    which pairs of neighbouring steps cancel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch.interpret import mask_opt

    b, t = clips.shape[:2]
    targets = torch.zeros(b, dtype=torch.long, device="cuda")
    steps = {}
    for route, model in models.items():
        score = lambda x, m=model: m(x).float()  # noqa: E731
        steps[route] = lambda c, score=score: mask_opt.search_step(score, clips, targets, c)
    carry0 = _central_carry(b, t)
    wall = {route: [] for route in models}
    for route in turns:
        carry = steps[route](steps[route](carry0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            carry = steps[route](carry)
        torch.cuda.synchronize()
        wall[route].append((time.perf_counter() - t0) / 5 * 1e3)
    if pairs:
        on_route, off_route = list(models)[:2]
        host_us = [_host_us_per_launch()]
        single = {on_route: [], off_route: []}
        for k in range(pairs):
            for route in ((on_route, off_route) if k % 2 == 0 else (off_route, on_route)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                carry = steps[route](carry)
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps[route](carry0)
            torch.cuda.synchronize()
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
              "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              "top_kernels": [list(t) for t in sorted(top, reverse=True)[:12]]})


def kernels_line(cases: dict, launches: dict) -> dict:
    """One entry per kernel, timed at its headline main-path shape;
    ``launches`` from the main path that runs it."""
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
    fb_src = "ivf_tpu_torch/csrc/fused_branch3.cu"
    for name, line in (("fused_pool_conv_fwd", 57), ("fused_pool_conv_bwd", 72),
                       ("fused_pool_conv_tblock_fwd", 279), ("fused_pool_conv_tblock_bwd", 327)):
        headline[name] = ("Mixed_3b", f"ivf_tpu/ops/pallas/fused_branch3.py:{line}", fb_src)
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
        if name.startswith("fused_pool_conv"):
            entry.update({
                "cold_ms": row["cold_ms"], "unfused_kernel_pair_ms": row["pair_ms"],
                "library": "F.max_pool3d + torch.matmul: no one PyTorch call computes the fused function"
                if name.endswith("fwd") else "none: no PyTorch call has the every-tie gather",
            })
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ivf_tpu_torch import api
        from ivf_tpu_torch.ops.kernels import build
        from ivf_tpu_torch.ops.kernels import fused_branch3 as fb
        from ivf_tpu_torch.ops.kernels import fused_gates as gates
        from ivf_tpu_torch.ops.kernels import maxpool3d as pool
        from ivf_tpu_torch.ops.kernels import pointwise_conv as pw
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures: list = []
    counters = {
        "pointwise_conv": pw.pointwise_conv_cuda,
        "maxpool3d_s1_fwd": pool.maxpool3d_s1_fwd_cuda,
        "maxpool3d_s1_bwd": pool.maxpool3d_s1_bwd_cuda,
        "lstm_gates_fwd": gates.lstm_gates_fwd_cuda,
        "lstm_gates_bwd": gates.lstm_gates_bwd_cuda,
        "fused_pool_conv_fwd": fb.fused_pool_conv_fwd_cuda,
        "fused_pool_conv_bwd": fb.fused_pool_conv_bwd_cuda,
        "fused_pool_conv_tblock_fwd": fb.fused_pool_conv_tblock_fwd_cuda,
        "fused_pool_conv_tblock_bwd": fb.fused_pool_conv_tblock_bwd_cuda,
    }
    info = phase_build(build)
    cases = phase_kernel_check(pw, pool, failures)
    cases.update(phase_gate_check(gates, failures))
    cases.update(phase_fused_check(fb, pool, pw, failures))
    phase_small_reference(failures)
    launches = phase_main_path(api, counters, failures, info["smi"])
    phase_step_timing(api, info["smi"], failures)
    phase_clstm_small_reference(failures)
    clstm_weights = _clstm_scaled_weights(api, _clstm_clips()[0][0])
    clstm_launches = phase_clstm_main_path(api, counters, failures, info["smi"], clstm_weights)
    launches.update({k: clstm_launches[k] for k in ("lstm_gates_fwd", "lstm_gates_bwd")})
    phase_clstm_step_timing(api, info["smi"], clstm_weights)
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    emit(kernels_line(cases, launches))
    print(info["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
