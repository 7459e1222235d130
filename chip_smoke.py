#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ivf_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase"``); any failure exits
non-zero without the final line:

1. build: compile the CUDA kernels from ``ivf_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and report the compiler's register/spill
   summary and the card's ``nvidia-smi`` name and power limit.
2. kernel_check: each CUDA kernel against its plain PyTorch version on
   the card, at the main path's shapes and a ragged one, TF32 off; with
   the kernel's time, the plain version's, one PyTorch library call's
   (a yardstick only) and the card's lower bound for the same work.
3. small_reference: I3D at (1, 8, 32, 32, 3) with the kernels on the card
   vs the same model on the CPU (plain versions): logits and input
   gradient.
4. main_path: ``find_masks`` on i3d_smth at full width (174 classes,
   16x224x224 clips, float32, seeded weights) over 4 clips, 10 search
   steps, Grad-CAM on -- once with the kernels (``use_pallas`` and
   ``pallas_pool``), with every launch counter reset just before and read
   just after, then once with them off; outputs checked and compared.
5. step_timing: steady wall time of one search step with the kernels on
   and off, in turns, and a profiled step of each (device time by
   kernel group, top kernels).

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


def bound(nbytes: float, ops: float):
    """Least time (ms) the card could take: bytes over HBM bandwidth vs
    operations over the float32 peak, the larger of the two."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    reports = build.build(["pointwise_conv", "maxpool3d"])
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


def phase_small_reference(failures) -> None:
    """The kernel path inside the whole model, on a small input, against
    the same model on the CPU (plain versions, CPU conv)."""
    from ivf_tpu_torch.models import i3d_smth

    model = i3d_smth(num_classes=5, pool_shape=(1, 1, 1), use_pallas=True, pallas_pool=True)
    model.reset_parameters(torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.logits.conv3d.weight.mul_(0.005)
    model.eval().requires_grad_(False)
    x = torch.rand(1, 8, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 255
    r = torch.randn(1, 5, generator=torch.Generator().manual_seed(3))
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
    emit({"phase": "small_reference", "logits_rel_err": logit_err, "logits_tol": 1e-4,
          "input_grad_rel_err": grad_err, "input_grad_tol": 1e-3})
    if not (logit_err <= 1e-4 and grad_err <= 1e-3):
        failures.append(f"small_reference: logits {logit_err}, grad {grad_err}")


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


def phase_main_path(api, pw, pool, failures, card: str) -> dict:
    import numpy as np

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips

    counters = {
        "pointwise_conv": pw.pointwise_conv_cuda,
        "maxpool3d_s1_fwd": pool.maxpool3d_s1_fwd_cuda,
        "maxpool3d_s1_bwd": pool.maxpool3d_s1_bwd_cuda,
    }
    dataset = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    runs = {}
    with tempfile.TemporaryDirectory() as out_dir:
        # the first run in the process pays cuDNN's per-shape algorithm
        # choice and module loading: a run without the kernels goes first,
        # then the two runs that are compared
        for run, kernels in enumerate((False, True, False)):
            cfg = Config()
            cfg.output_dir = out_dir
            cfg.model_name = f"chip_smoke_{run}_{'kernels' if kernels else 'plain'}"
            cfg.data.batch_size = BATCH
            cfg.mask.opt_iter = STEPS
            cfg.model.use_pallas = cfg.model.pallas_pool = kernels
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
            runs[kernels] = dict(tm=tm, masks=masks, cams=cams, launches=launches)
            emit({
                "phase": "main_path", "run": run, "kernels": kernels, "card": card,
                "model": "i3d_smth",
                "clips": BATCH, "clip_shape": [CLIP_T, CLIP_HW, CLIP_HW, 3],
                "steps": STEPS, "mask_steps_per_s": rate,
                "search_seconds": stats["search_seconds"], "init_seconds": stats["init_seconds"],
                "wall_seconds": wall, "launches": launches,
                "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "masks": masks.round(4).tolist(), "pickles": pickles,
            })
            if kernels and not all(n > 0 for n in launches.values()):
                failures.append(f"main path with kernels: a kernel never launched {launches}")
            if not kernels and any(launches.values()):
                failures.append(f"main path without kernels launched one {launches}")
            if not (np.isfinite(masks).all() and masks.min() >= 0 and masks.max() <= 1):
                failures.append("masks not finite in [0, 1]")
            if cams.shape != (BATCH, CLIP_T, CLIP_HW, CLIP_HW) or not np.isfinite(cams).all():
                failures.append(f"CAMs {cams.shape} not finite (B, 16, 224, 224)")
            if len(pickles) != 2:
                failures.append(f"pickles missing: {pickles}")
    on, off = runs[True], runs[False]
    mask_diff = float(np.abs(on["masks"] - off["masks"]).max())
    cam_diff = float(np.abs(on["cams"] - off["cams"]).max())
    score_diff = max(
        abs(a["original_score_guess"] - b["original_score_guess"]) for a, b in zip(on["tm"], off["tm"])
    )
    emit({"phase": "main_path_compare", "max_mask_diff": mask_diff, "mask_tol": MASK_TOL,
          "mask_tol_reason": MASK_TOL_REASON, "max_cam_diff": cam_diff, "cam_tol": 1e-3,
          "max_orig_score_diff": score_diff, "orig_score_tol": 1e-4})
    if not (mask_diff <= MASK_TOL and cam_diff <= 1e-3 and score_diff <= 1e-4):
        failures.append(f"kernels on vs off: mask {mask_diff}, cam {cam_diff}, score {score_diff}")
    return on["launches"]


def _group(name: str) -> str:
    if "pw_gemm" in name:
        return "pointwise_conv kernel"
    if "pool_fwd" in name or "pool_bwd" in name:
        return "maxpool3d_s1 kernels"
    low = name.lower()
    if "conv" in low or "xmma" in low or "implicit_gemm" in low or "cudnn" in low:
        return "cuDNN convolution"
    if "gemm" in low or "gemv" in low:
        return "cuBLAS matmul"
    if "max_pool" in low:
        return "torch max pool"
    return "elementwise and other"


def phase_step_timing(api, card: str) -> None:
    """Steady per-step wall time of the search (kernels on / off, in turns
    on, off, off, on after a warm-up), then one profiled step of each: device
    time by kernel group and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ivf_tpu_torch.config import Config
    from ivf_tpu_torch.data.synthetic import SyntheticClips
    from ivf_tpu_torch.interpret import mask_opt

    ds = SyntheticClips(BATCH, CLIP_T, CLIP_HW, CLASSES, seed=1, lazy=False)
    clips = torch.stack([torch.from_numpy(ds[i][0]) for i in range(BATCH)]).cuda().float()
    targets = torch.zeros(BATCH, dtype=torch.long, device="cuda")
    steps = {}
    for kernels in (True, False):
        cfg = Config()
        cfg.model.use_pallas = cfg.model.pallas_pool = kernels
        model = api.build_model(cfg, softmax_override=True).requires_grad_(False)
        score = lambda x, m=model: m(x).float()  # noqa: E731
        steps[kernels] = lambda c, score=score: mask_opt.search_step(score, clips, targets, c)
    carry0 = mask_opt.make_search_carry(torch.zeros(BATCH, CLIP_T, device="cuda"))
    wall = {True: [], False: []}
    for kernels in (True, False, False, True):
        carry = steps[kernels](steps[kernels](carry0))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            carry = steps[kernels](carry)
        torch.cuda.synchronize()
        wall[kernels].append((time.perf_counter() - t0) / 5 * 1e3)
    for kernels in (True, False):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps[kernels](carry0)
            torch.cuda.synchronize()
        groups, top = {}, []
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", 0) or 0
            if dev_us <= 0 or ev.device_type != DeviceType.CUDA:
                continue  # CPU-side ops carry their kernels' time too
            groups[_group(ev.key)] = groups.get(_group(ev.key), 0.0) + dev_us / 1e3
            top.append((dev_us / 1e3, ev.count, ev.key[:110]))
        device_ms = sum(groups.values())
        wall_ms = sum(wall[kernels]) / len(wall[kernels])
        emit({"phase": "step_timing", "kernels": kernels, "card": card, "batch": BATCH,
              "wall_ms_per_step": wall[kernels], "device_ms_per_step": device_ms,
              "device_busy_share": device_ms / wall_ms,
              "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1])),
              "top_kernels": [list(t) for t in sorted(top, reverse=True)[:12]]})


def kernels_line(cases: dict, launches: dict) -> dict:
    """One entry per kernel, timed at its headline main-path shape."""
    headline = {
        "pointwise_conv": ("Mixed_3b_trio", "ivf_tpu/ops/pallas/pointwise_conv.py:29",
                           "ivf_tpu_torch/csrc/pointwise_conv.cu"),
        "maxpool3d_s1_fwd": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:88",
                             "ivf_tpu_torch/csrc/maxpool3d.cu"),
        "maxpool3d_s1_bwd": ("Mixed_3b", "ivf_tpu/ops/pallas/maxpool3d.py:99",
                             "ivf_tpu_torch/csrc/maxpool3d.cu"),
    }
    out = []
    for name, (site, replaces, source) in headline.items():
        row = next(c for c in cases[name] if c["site"] == site)
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "at": {"site": site, "shape": row["shape"]},
        })
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from ivf_tpu_torch import api
        from ivf_tpu_torch.ops.kernels import build
        from ivf_tpu_torch.ops.kernels import maxpool3d as pool
        from ivf_tpu_torch.ops.kernels import pointwise_conv as pw
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    failures: list = []
    info = phase_build(build)
    cases = phase_kernel_check(pw, pool, failures)
    phase_small_reference(failures)
    launches = phase_main_path(api, pw, pool, failures, info["smi"])
    phase_step_timing(api, info["smi"])
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
