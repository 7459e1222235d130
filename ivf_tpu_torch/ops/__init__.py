"""Conv/pool primitives (``conv.py``, ``padding.py``) and the hand-written
CUDA kernels with their plain PyTorch versions (``kernels/``)."""
