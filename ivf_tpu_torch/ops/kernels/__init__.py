"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

  pointwise_conv.py  <- ivf_tpu/ops/pallas/pointwise_conv.py
  maxpool3d.py       <- ivf_tpu/ops/pallas/maxpool3d.py
  fused_gates.py     <- ivf_tpu/ops/pallas/fused_gates.py
  fused_branch3.py   <- ivf_tpu/ops/pallas/fused_branch3.py (both variants)
  build.py           nvcc build + ctypes binding of ``csrc/*.cu``

A wrapper given a CUDA tensor launches its kernel or raises; a CPU tensor
takes the plain version. Each CUDA wrapper counts its launches in a
``launches`` attribute.
"""
