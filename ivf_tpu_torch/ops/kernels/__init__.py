"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

  pointwise_conv.py  <- ivf_tpu/ops/pallas/pointwise_conv.py (float32, bfloat16)
  maxpool3d.py       <- ivf_tpu/ops/pallas/maxpool3d.py (float32, bfloat16)
  fused_gates.py     <- ivf_tpu/ops/pallas/fused_gates.py (float32; bf16 gates, float32 state)
  fused_branch3.py   <- ivf_tpu/ops/pallas/fused_branch3.py (both variants; float32, bfloat16)
  argmax_pool.py     <- ivf_tpu/ops/conv.py::_max_pool3d_same_argmax (not Pallas)
  build.py           nvcc build + ctypes binding of ``csrc/*.cu``

A wrapper given a CUDA tensor launches its kernel or raises; a CPU tensor
takes the plain version. Each CUDA wrapper counts its launches in a
``launches`` attribute.
"""
