"""Command-line interface: ``python -m ivf_tpu_torch.cli <command>`` (port of
``ivf_tpu/cli.py``, with its subcommands and arguments).

Entry points mirroring the reference's script surface:
  train             <- python train_*.py -c config (``--resume``, ``--eval_only``)
  infer             <- python inference_*.py
  find-masks        <- python FindMasksComparison_*.py / mask/find_mask_*.py
  grad-cam          <- a Grad-CAM-only pass
  make-records      <- tfrecords/script_generate_tfrecords_*.py
  inspect-records   <- tfrecords/inspect_tfrecords.py
  make-kth-records  <- the KTH per-subject shards
  extract-frames    <- create_folders_and_extract_frames.py
  export-checkpoint <- the weights as a reference-layout .pth.tar
  export-model      <- the float32 forward as a torch.export artifact (``serve.py``)
  serve             <- the dynamic batcher behind an HTTP endpoint, on an
                       artifact or on the configured model

Every command that runs a model takes ``--device`` (default ``cuda``),
passed to the API's ``device=``: with no card and no ``--device cpu`` it
raises, as the API does. ``--checkpoint`` sets ``pretrained_model_path``:
a reference ``.pth.tar``, a reference TF bundle prefix or a directory of
the port's checkpoints. ``--profile DIR`` runs the command inside
``utils.profiling.trace(DIR)`` (a ``torch.profiler`` trace for
TensorBoard); ``--detect-anomaly`` inside ``utils.profiling.detect_anomaly``
(the first op with a NaN output raises, forward or backward).

``export-model`` takes ``--device`` where the JAX package takes
``--platforms``: the artifact runs on the device it was exported on, and
``serve --artifact`` runs it there unless ``--device`` names another,
which raises.

``--multihost`` joins the process group (``parallel.initialize_multihost``:
``torchrun``'s variables, else the JAX package's) before anything touches
a device; ``-dp N`` runs ``train``, ``infer`` and ``find-masks`` on a data
mesh of N ranks (``parallel.get_mesh``): 0 is the whole world, 1 (or a
world of one rank) no mesh, any other N must be the world size. ``-dp``
joins the process group too. On N cards of one host::

    torchrun --nproc-per-node N -m ivf_tpu_torch.cli train -c cfg.py -dp 0

``batch_size`` is then the node's batch, split over its ranks.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re

from ivf_tpu_torch.config import Config, add_cli_overrides, apply_cli_overrides


def _load_cfg(args) -> Config:
    cfg = Config.load(args.config) if args.config else Config()
    cfg = apply_cli_overrides(cfg, args)
    if getattr(args, "test_run", False):
        cfg.test_run = True
    if getattr(args, "checkpoint", None):
        cfg.model.pretrained_model_path = args.checkpoint
    return cfg


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ivf_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, device_default="cuda"):
        p.add_argument("--config", "-c", help="config .py (exposing `config`) or .json")
        p.add_argument("--test_run", action="store_true", help="5-step smoke mode")
        p.add_argument("--checkpoint", "-chp", help="checkpoint path")
        p.add_argument("--device", default=device_default, help="torch device the run uses (default: cuda; "
                       "serve --artifact: the artifact's)")
        p.add_argument("--data-parallel", "-dp", type=int, default=None, metavar="N",
                       help="run on a data mesh of N ranks (0: the whole world; omit or 1: no mesh); "
                       "batch_size is the node's batch and must divide over its ranks")
        p.add_argument("--profile", metavar="DIR", default=None,
                       help="write a torch.profiler trace of the command into DIR (TensorBoard)")
        p.add_argument("--detect-anomaly", action="store_true",
                       help="raise at the first op with a NaN output, forward or backward, under "
                       "torch.autograd.set_detect_anomaly (the reference mask drivers run under it)")
        p.add_argument("--multihost", action="store_true",
                       help="join the process group before any device use (torchrun's MASTER_ADDR / MASTER_PORT / "
                       "WORLD_SIZE / RANK, else JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID); "
                       "with -dp 0 a global data mesh, each node reading its shard")
        add_cli_overrides(p)
        return p

    p = common(sub.add_parser("train"))
    p.add_argument("--eval_only", "-e", action="store_true")
    p.add_argument("--resume", "-r", action="store_true")
    common(sub.add_parser("infer"))
    p = common(sub.add_parser("find-masks"))
    p.add_argument("--no-gradcam", action="store_true")
    p.add_argument("--no-temp-mask", action="store_true")
    p.add_argument("--train", "-tr", action="store_true",
                   help="run on the train split instead of validation (utils.py:43)")
    p.add_argument("--resume", "-r", action="store_true",
                   help="resume an interrupted run from results/emission_journal.p")
    common(sub.add_parser("grad-cam")).add_argument(
        "--train", "-tr", action="store_true", help="run on the train split instead of validation"
    )

    p = sub.add_parser("make-records")
    p.add_argument("--frames-root", required=True, help="root of frame dirs")
    p.add_argument("--out", required=True, help="output .ivfrecords path")
    p.add_argument("--nb-frames", type=int, default=16)
    p.add_argument("--mode", choices=["all", "sample", "sample_cohesive_crop"], default="sample")

    p = sub.add_parser("inspect-records")
    p.add_argument("path", help=".ivfrecords or .tfrecords file to inspect")
    p.add_argument("--index", type=int, default=0)

    p = sub.add_parser("make-kth-records")
    p.add_argument("--labels-csv", required=True)
    p.add_argument("--frames-root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--mode", choices=["all", "sample", "sample_cohesive_crop"], default="sample")
    p.add_argument("--nb-frames", type=int, default=32)

    p = common(sub.add_parser("export-model"))
    p.add_argument("--out", required=True, help="output artifact path")
    p.add_argument("--static-batch", type=int, default=None, metavar="B",
                   help="export a fixed batch size instead of the default batch-polymorphic artifact")

    p = common(sub.add_parser("export-checkpoint"))
    p.add_argument("--out", required=True,
                   help="output reference-layout .pth.tar (loads into the reference torch modules with strict=True)")

    p = common(sub.add_parser("serve"), device_default=None)
    p.add_argument("--artifact", help="export-model artifact (skips the model build)")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--max-batch", type=int, default=128)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--warmup", action="store_true", help="run every batch bucket once before accepting requests")
    p.add_argument("--smoke", action="store_true",
                   help="POST one zero clip to the running server, print the response and the stats, and exit")

    p = sub.add_parser("extract-frames")
    p.add_argument("--json-input", required=True)
    p.add_argument("--json-labels", required=True)
    p.add_argument("--video-root", required=True)
    p.add_argument("--out-root", required=True)
    p.add_argument("--nb-frames", type=int, default=16)
    p.add_argument("--width", type=int, default=256)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) == "cuda" and not getattr(args, "artifact", None):
        args.device = None  # the API's own default: cuda, or a clear error with no card (an artifact has its own)
    if getattr(args, "multihost", False) or getattr(args, "data_parallel", None) not in (None, 1):
        # before anything touches a device: NCCL ranks take their card first
        from ivf_tpu_torch.parallel import initialize_multihost

        initialize_multihost(device=args.device)
    with contextlib.ExitStack() as stack:
        if getattr(args, "profile", None):
            from ivf_tpu_torch.utils.profiling import trace

            stack.enter_context(trace(args.profile))
        if getattr(args, "detect_anomaly", False):
            from ivf_tpu_torch.utils.profiling import detect_anomaly

            stack.enter_context(detect_anomaly(True))
        return _run(args)


def _mesh(args) -> dict:
    """``{"mesh": ...}``, the data mesh of ``-dp`` (``ivf_tpu/cli.py:179-191``),
    or ``{}``: none unless asked; 0 the whole world; a mesh of one rank is
    no mesh."""
    n = getattr(args, "data_parallel", None)
    if n is None:
        return {}
    from ivf_tpu_torch.parallel import get_mesh
    from ivf_tpu_torch.parallel.multihost import world_size

    n = n or world_size()
    return {"mesh": get_mesh(n)} if n > 1 else {}


def _run(args):
    if args.command == "train":
        from ivf_tpu_torch.api import train

        return train(_load_cfg(args), eval_only=args.eval_only, resume=args.resume, device=args.device,
                     **_mesh(args))
    if args.command == "infer":
        from ivf_tpu_torch.api import infer

        res = infer(_load_cfg(args), device=args.device, **_mesh(args))
        print(f"val loss {res['loss']:.4f} top1 {res['top1']:.2f} top5 {res['top5']:.2f} (predictions saved)")
        return res
    if args.command in ("find-masks", "grad-cam"):
        # grad-cam IS find_masks without the mask search: the same clip
        # filters, the same batched-CAM path, the same pickle artifact
        from ivf_tpu_torch.api import find_masks, init_eval_state

        cfg = _load_cfg(args)
        mesh = _mesh(args)
        device = args.device
        if mesh:
            from ivf_tpu_torch.parallel import mesh_device

            device = mesh_device(mesh["mesh"])
        _, state = init_eval_state(cfg, softmax_override=True, device=device)
        cam_only = args.command == "grad-cam"
        out = find_masks(
            cfg,
            state.model.state_dict(),
            device=device,
            **mesh,
            do_gradcam=cam_only or not args.no_gradcam,
            run_temp_mask=not cam_only and not args.no_temp_mask,
            save_viz=not cam_only,
            max_batches=1 if cfg.test_run else None,
            split="train" if args.train else "validation",
            resume=getattr(args, "resume", False),
        )
        if cam_only:
            print(f"grad-cam: {len(out[1])} clips (results pickled)")
        return out
    if args.command == "export-checkpoint":
        return _export_checkpoint(args)
    if args.command == "export-model":
        return _export_model(args)
    if args.command == "serve":
        return _serve(args)
    if args.command == "make-records":
        return _make_records(args)
    if args.command == "inspect-records":
        # the same extension dispatch as RecordDataset: reference-made
        # .tfrecords shards inspect directly too
        if args.path.endswith((".tfrecord", ".tfrecords")):
            from ivf_tpu_torch.data.tfrecords import TFRecordReader as _Reader
        else:
            from ivf_tpu_torch.data.records import RecordReader as _Reader

        r = _Reader(args.path)
        meta, frames = r.read(args.index)
        print(f"{len(r)} records in {args.path}")
        print(f"record[{args.index}] meta: {meta}")
        print(f"frames: {frames.shape} dtype {frames.dtype} min {frames.min()} max {frames.max()}")
        return meta, frames
    if args.command == "make-kth-records":
        from ivf_tpu_torch.data.kth import write_kth_subject_records

        paths = write_kth_subject_records(
            args.labels_csv, args.frames_root, args.out, mode=args.mode, nb_frames=args.nb_frames
        )
        print(f"wrote {len(paths)} subject shards to {args.out}")
        return paths
    if args.command == "extract-frames":
        from ivf_tpu_torch.data.catalogs import SmthSmthCatalog
        from ivf_tpu_torch.data.frames import extract_dataset

        cat = SmthSmthCatalog(args.json_input, args.json_labels, args.video_root, ".webm")
        return extract_dataset(cat.items, args.out_root, args.nb_frames, args.width)
    raise ValueError(f"unknown command {args.command!r}")


def _export_checkpoint(args):
    """The run's (or ``--checkpoint``'s) weights as a reference-layout torch
    ``.pth.tar`` (``utils/export_torch.py``): the reference stack loads it
    with ``strict=True``."""
    from ivf_tpu_torch.api import _clip_hw, init_eval_state
    from ivf_tpu_torch.utils.export_torch import (
        convlstm_state_dict_to_reference,
        i3d_state_dict_to_reference,
        save_checkpoint_file,
    )

    cfg = _load_cfg(args)
    _, state = init_eval_state(cfg, device=args.device)
    weights = state.model.state_dict()
    m = cfg.model
    if "i3d" in m.conv_model.lower():
        sd = i3d_state_dict_to_reference(weights)
    else:
        sd = convlstm_state_dict_to_reference(
            weights, image_size=_clip_hw(cfg), conv_stride=m.conv_stride, pool_kernel=tuple(m.pool_kernel),
            lstm_layers=m.clstm_layers, nb_lstm_units=m.clstm_hidden,
        )
    save_checkpoint_file(args.out, sd, arch=m.conv_model)
    print(f"exported {len(sd)} tensors -> {args.out} (reference layout)")
    return sd


def _clip_shape(cfg) -> tuple:
    from ivf_tpu_torch.api import _clip_hw

    return (cfg.data.clip_size, *_clip_hw(cfg), 3)


def _export_model(args):
    """The float32 forward (softmax on, as ``find-masks`` serves it) of the
    configured model as a batch-polymorphic artifact on ``--device``."""
    from ivf_tpu_torch.api import init_eval_state
    from ivf_tpu_torch.serve import export_forward, save_artifact

    cfg = _load_cfg(args)
    model, _ = init_eval_state(cfg, softmax_override=True, device=args.device)
    shape = _clip_shape(cfg)
    program = export_forward(
        model, shape, batch_polymorphic=args.static_batch is None, static_batch=args.static_batch or 1
    )
    device = str(next(model.parameters()).device)
    save_artifact(
        program, args.out,
        meta={"family": cfg.model.conv_model, "num_classes": cfg.model.num_classes, "clip_shape": list(shape),
              "device": device},
    )
    print(
        f"exported {cfg.model.conv_model} forward -> {args.out} "
        f"({os.path.getsize(args.out) / 1e6:.1f} MB, device {device}, clip {shape})"
    )
    return program


def _serve(args):
    """Serve an artifact (``--artifact``, on the device it was exported
    on; a ``--device`` given must name that device) or the configured
    model on ``--device`` (default ``cuda``) behind the batcher and the
    HTTP endpoint; ``--smoke`` posts one zero clip and returns."""
    import io
    import time
    import urllib.request

    import numpy as np
    import torch

    from ivf_tpu_torch.serve import DynamicBatcher, live_forward, load_artifact, serve_http

    if args.artifact:
        infer_fn, meta = load_artifact(args.artifact)
        if args.device is not None and torch.device(args.device).type != infer_fn.device.type:
            raise ValueError(f"{args.artifact} runs on {infer_fn.device}, not on --device {args.device}")
        shape = tuple(meta["clip_shape"])
    else:
        from ivf_tpu_torch.api import init_eval_state

        cfg = _load_cfg(args)
        model, _ = init_eval_state(cfg, softmax_override=True, device=args.device)
        infer_fn, shape = live_forward(model), _clip_shape(cfg)

    with DynamicBatcher(infer_fn, max_batch=args.max_batch, max_wait_ms=args.max_wait_ms) as batcher:
        if args.warmup:
            print(f"warming {len(batcher.buckets)} bucket programs ...")
            batcher.warmup(shape)
        server = serve_http(batcher, port=args.port, host=args.host)
        host, port = server.server_address
        print(f"serving on http://{host}:{port} (clip shape {shape})", flush=True)
        try:
            if args.smoke:
                buf = io.BytesIO()
                np.save(buf, np.zeros(shape, np.float32))
                req = urllib.request.Request(f"http://{host}:{port}/predict", data=buf.getvalue())
                body = urllib.request.urlopen(req, timeout=300).read().decode()
                print(f"smoke response: {body}")
                print(f"stats: {batcher.stats.summary()}")
                return json.loads(body)
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            server.shutdown()


def _make_records(args):
    import numpy as np

    from ivf_tpu_torch.data import (
        FrameDirCatalog,
        RecordWriter,
        sample_all,
        sample_cohesive_crop,
        sample_fixed_count,
    )
    from ivf_tpu_torch.data.loaders import _load_frame

    catalog = FrameDirCatalog(args.frames_root)
    skipped = 0
    # one rng shared by the clips, as kth.write_kth_subject_records shares it
    rng = np.random.RandomState(0)
    with RecordWriter(args.out) as w:
        for item in catalog.items:
            # the sorted frame files themselves: gaps do not shift indices
            # and stray .jpg files are left out
            frame_files = sorted(f for f in os.listdir(item.path) if re.fullmatch(r"frame\d+\.jpg", f))
            n = len(frame_files)
            if n == 0:
                print(f"  skipping empty clip dir {item.path}")
                skipped += 1
                continue
            if args.mode == "all":
                idxs = sample_all(1, n)
            elif n == 1:
                # the samplers assert on single-frame clips; repeat the frame
                idxs = [1] * args.nb_frames
            elif args.mode == "sample":
                idxs = sample_fixed_count(1, n, args.nb_frames)
            else:
                idxs = sample_cohesive_crop(1, n, args.nb_frames, rng)
            frames = np.stack([_load_frame(os.path.join(item.path, frame_files[i - 1])) for i in idxs])
            w.write(frames, label=int(item.label), video_id=item.id)
    print(f"wrote {args.out}" + (f" ({skipped} empty clips skipped)" if skipped else ""))
    return args.out


if __name__ == "__main__":
    main()
