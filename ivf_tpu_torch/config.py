"""Configuration for the ported path (copy of the fields of
``ivf_tpu/config.py`` that ``find_masks`` reads, same names and defaults).

``ModelConfig.pool_impl`` takes the JAX package's ``'reduce_window'`` and
``'argmax'`` (``POOL_IMPLS``); its other pool impls are not ported, and
``compute_dtype`` is ``'float32'`` or ``'bfloat16'``.

The one field the JAX package's config lacks is ``ModelConfig.pallas_pool``:
there the branch-3 pool kernel is a model argument only, here it is set
from the config like ``use_pallas``. ``DataConfig.input_spatial_size``
fixes the width of the ConvLSTM's ``fc`` head, which flax infers lazily
from the first input and ``nn.Linear`` needs when it is built.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple, Union


COMPUTE_DTYPES = ("float32", "bfloat16")
# the JAX package's others (shift, eqbwd, argmax_full, argmax_shift) raise
POOL_IMPLS = ("reduce_window", "argmax")


@dataclass
class DataConfig:
    clip_size: int = 16
    input_spatial_size: Union[int, Tuple[int, int]] = 224
    batch_size: int = 16


@dataclass
class ModelConfig:
    conv_model: str = "i3d_smth"  # registry name or reference alias
    num_classes: int = 174
    soft_max: bool = False
    last_relu: Optional[str] = None
    last_stride: int = 1
    stride_mod_layers: Tuple[str, ...] = ()
    final_temp_time: int = 2
    dropout: float = 0.5  # identity in eval mode
    # ConvLSTM-specific
    clstm_hidden: int = 32
    clstm_layers: int = 4
    conv_stride: int = 1
    batch_norm: bool = True
    use_entire_seq: bool = False
    conv_kernel_size: int = 5
    pool_kernel: Tuple[int, int] = (2, 2)
    effective_steps: Tuple[int, ...] = ()
    # torch family: drop->bn->pool (CLSTM_4); tf family: pool->bn
    block_order: str = "torch"  # torch | tf
    pooling: str = "max"  # max | avg
    # rectangular ConvLSTM kernels (conv_kernel_size, conv_kernel_size_2);
    # None means square conv_kernel_size
    conv_kernel_size_2: Optional[int] = None
    # Keras ConvLSTM2D input-conv padding: torch (symmetric) | valid
    padding_clstm: str = "torch"
    recurrent_activation: str = "sigmoid"  # sigmoid | hard_sigmoid
    compute_dtype: str = "float32"  # float32 | bfloat16 (I3D only)
    # max pools: 'reduce_window' (F.max_pool3d) | 'argmax' (bf16 stride-1
    # pools via the argmax-index pool); bfloat16 runs with 'reduce_window'
    # become 'argmax' in find_masks, as in the JAX package
    pool_impl: str = "reduce_window"
    # 1x1x1 convs via the pointwise CUDA kernel (I3D); the ConvLSTM gate
    # block via the fused-gates CUDA kernel (sigmoid gates)
    use_pallas: bool = False
    pallas_pool: bool = False  # branch-3 pools via the max-pool CUDA kernels
    fuse_pool_conv: object = False  # I3D Inception branch-3 pool+1x1conv
    # as one CUDA kernel per direction (inference/mask search only);
    # True = per-frame kernels, 'tblock' = whole-sample kernels


@dataclass
class MaskConfig:
    lam1: float = 0.01
    lam2: float = 0.02
    opt_iter: int = 300
    opt_lr: float = 0.2
    mask_init_type: str = "central"  # central (random: not ported yet)
    mask_perturb_type: str = "freeze"  # freeze | reverse
    grad_cam_type: str = "guessed"  # guessed | true
    class_oi: Optional[int] = None  # class-of-interest filter (not ported yet)
    top_layer: str = "Mixed_5c"
    # both reference FindMasks scripts hardcode normalizePerFrame=True
    normalization_mode: str = "frame"  # sequence | frame
    eta: float = 1e-5
    early_stop: bool = False  # default keeps exact reference parity
    # freeze a row only after this many CONSECUTIVE sub-eta steps
    eta_patience: int = 1
    # freeze perturbation in the search loop: closed-form transition matrix
    # (~1e-4 reassociation drift) vs the exact recurrence
    closed_form: bool = True


@dataclass
class Config:
    model_name: str = "model"
    output_dir: str = "trained_models/"
    seed: int = 0
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    mask: MaskConfig = field(default_factory=MaskConfig)
