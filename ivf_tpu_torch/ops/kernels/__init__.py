"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

  pointwise_conv.py  <- ivf_tpu/ops/pallas/pointwise_conv.py (float32, bfloat16)
  maxpool3d.py       <- ivf_tpu/ops/pallas/maxpool3d.py (float32, bfloat16)
  fused_gates.py     <- ivf_tpu/ops/pallas/fused_gates.py (float32; bf16 gates with a float32
                        or a bf16 state)
  fused_branch3.py   <- ivf_tpu/ops/pallas/fused_branch3.py (both variants; float32, bfloat16)
  argmax_pool.py     <- ivf_tpu/ops/conv.py::_max_pool3d_same_argmax (not Pallas)
  build.py           nvcc build + ctypes binding of ``csrc/*.cu``
  custom_ops.py      the float32 forward kernels as ``torch.library`` custom ops, which
                     ``torch.export`` records (``ivf_tpu_torch/serve.py``)

A wrapper given a CUDA tensor launches its kernel or raises; a CPU tensor
takes the plain version. Each CUDA wrapper counts its launches in a
``launches`` attribute.
"""
