"""Conv/pool primitives (``conv.py``, ``padding.py``), the ConvLSTM cell
step (``convlstm_cell.py``) and the hand-written CUDA kernels with their
plain PyTorch versions (``kernels/``)."""
