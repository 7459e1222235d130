"""ivf_tpu_torch — the PyTorch/CUDA port of ``ivf_tpu`` for NVIDIA Hopper.

The JAX package ``ivf_tpu`` stays the reference; this package reproduces
its temporal-mask search + Grad-CAM path (``api.find_masks``) on I3D and
the ConvLSTM family, and its training and inference (``api.train``,
``api.infer``) on those and ``cnn_3d``, with PyTorch on one H100. Module
names mirror ``ivf_tpu``:

  ops/          conv/pool semantics (TF-SAME 3D, torch-padded 2D), the
                ConvLSTM cell step; ``ops/kernels/`` holds the
                hand-written CUDA kernels (sources in ``csrc/``) that
                replace the Pallas TPU kernels, each beside its plain
                PyTorch version
  models/       I3D, the ConvLSTM classifier and ``cnn_3d``, with the
                kernel routes and training-mode BN and dropout
  train/        optimizers, LR schedules, the train state and loops
  interpret/    perturbations, the batched mask search, Grad-CAM (I3D and
                ConvLSTM)
  data/         catalogs, samplers, ``.ivfrecords`` / ``.tfrecords``
                readers, the frame-tree, KTH and record datasets, the
                prefetching ``ClipLoader``; the synthetic clip dataset and
                the KTH clip whitelist
  native/       the loader's batched libjpeg decoder (host C++, built with
                g++ at first use; PIL where it cannot build)
  utils/        weight conversion from the JAX package's variable tree,
                checkpoints, result files
  config.py     the config tree and its preset loading (``Config.load``)
  api.py        ``build_model`` / ``build_dataset`` / ``build_loader`` /
                ``find_masks`` (with its filters, compaction, ``min_score``
                probe and emission journal) / ``grad_cam_run`` / ``train``
                / ``init_eval_state`` / ``infer``

Public tensors keep the JAX layout: clips are ``(B, T, H, W, C)``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package never imports JAX or ``ivf_tpu``: what it needs from there is
copied.
"""

__version__ = "0.1.0"
