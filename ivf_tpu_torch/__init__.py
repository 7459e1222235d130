"""ivf_tpu_torch — the PyTorch/CUDA port of ``ivf_tpu`` for NVIDIA Hopper.

The JAX package ``ivf_tpu`` stays the reference; this package reproduces
its temporal-mask search + Grad-CAM path (``api.find_masks``) on I3D and
the ConvLSTM family, and its training and inference (``api.train``,
``api.infer``) on those and ``cnn_3d``, with PyTorch on one H100 or on
several over ``torch.distributed``. Module
names mirror ``ivf_tpu``:

  ops/          conv/pool semantics (TF-SAME 3D, torch-padded 2D), the
                ConvLSTM cell step; ``ops/kernels/`` holds the
                hand-written CUDA kernels (sources in ``csrc/``) that
                replace the Pallas TPU kernels, each beside its plain
                PyTorch version
  models/       I3D, the ConvLSTM classifier and ``cnn_3d``, with the
                kernel routes and training-mode BN and dropout
  train/        optimizers, LR schedules, the train state and loops
  interpret/    perturbations, the batched mask search (and its one-clip
                ``find_mask``), Grad-CAM (I3D and ConvLSTM), 2-D Grad-CAM
                and guided backprop
  data/         catalogs, samplers, ``.ivfrecords`` / ``.tfrecords``
                readers, the frame-tree, KTH and record datasets, the
                prefetching ``ClipLoader``; the synthetic clip dataset and
                the KTH clip whitelist
  native/       the loader's batched libjpeg decoder (host C++, built with
                g++ at first use; PIL where it cannot build)
  parallel/     ranks over ``torch.distributed``: device meshes with the
                JAX axis names, node shards, the data mesh's collectives,
                the GPipe schedule and tensor parallelism
  utils/        weight conversion from the JAX package's variable tree,
                checkpoints, result files, TF bundles, the reference
                TF and torch checkpoint imports, the torch export, and
                profiling (``torch.profiler`` traces, the NaN check, the
                step timer); the JAX package's ``utils/compile.py`` (XLA's
                TPU compiler options and its persistent cache) has no
                analogue: the port runs eagerly, with no XLA to set
  config.py     the config tree, its preset loading (``Config.load``) and
                the command-line overrides
  api.py        ``build_model`` / ``build_dataset`` / ``build_loader`` /
                ``find_masks`` (with its filters, compaction, ``min_score``
                probe and emission journal) / ``grad_cam_run`` / ``train``
                / ``init_eval_state`` / ``infer``, loading
                ``pretrained_model_path``
  cli.py        ``python -m ivf_tpu_torch.cli <command>``
  quickstart.py ``python -m ivf_tpu_torch.quickstart [out_dir] [--cpu]``:
                train, infer and the search on a generated dataset

Public tensors keep the JAX layout: clips are ``(B, T, H, W, C)``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package never imports JAX or ``ivf_tpu``: what it needs from there is
copied.
"""

__version__ = "0.1.0"
