"""The float32 forward kernels as ``torch.library`` custom ops, so that a
graph of ``torch.export`` launches them.

The wrappers of the other modules here launch their kernels through
``ctypes`` on raw data pointers and choose kernel or plain version in
Python, from the tensor's device. ``torch.export`` traces with fake
tensors, which have no data pointer, and it records what the Python code
did: traced on the card the launch fails, traced on the CPU the graph
would hold the plain version and run it on the card too. So while
``torch.export`` traces, each float32 forward that a served model runs
goes through its op instead, and the op chooses at run time:

  ivf_tpu_torch::pw_gemm_f32                     pointwise_conv.py  (``pw_gemm_f32``, ``_rows``)
  ivf_tpu_torch::maxpool3d_s1_fwd_f32            maxpool3d.py       (``pool_fwd<float>``)
  ivf_tpu_torch::fused_pool_conv_fwd_f32         fused_branch3.py   (``fpc_fwd<float>``, per frame)
  ivf_tpu_torch::fused_pool_conv_tblock_fwd_f32  fused_branch3.py   (``fpc_fwd<float>``, whole sample)
  ivf_tpu_torch::lstm_gates_fwd_f32              fused_gates.py     (``lstm_gates_fwd_f32``)

Each op has a fake (shape) implementation, the plain version on CPU
tensors and the counted ``*_cuda`` launch on CUDA tensors, which raises
where the kernel does not build or launch; no other device runs it.
Outside a trace the wrappers launch their kernels directly: a call
through the op costs ~5.5 us more of host time on the card, and the
host-bound clstm_kth float32 steps make 64 gate calls each (PERF.md).
The backward kernels and the bfloat16 kernels have no op: an export never
runs a backward, and the served forward is float32, so a trace that
reaches a bfloat16 kernel raises rather than record its plain version.
"""

from __future__ import annotations

import torch

NAMESPACE = "ivf_tpu_torch"


def load() -> None:
    """Register every op of the namespace: import the modules that define
    them (before an exported program that calls them is loaded)."""
    from ivf_tpu_torch.ops.kernels import fused_branch3, fused_gates, maxpool3d, pointwise_conv  # noqa: F401


def refuse_export(kernel: str, dtype: torch.dtype) -> None:
    """Raise while ``torch.export`` traces: ``kernel`` has no custom op in
    ``dtype``, and the trace would record its plain version in its place."""
    if torch.compiler.is_exporting():
        raise NotImplementedError(
            f"{kernel}: no custom op for {dtype}, so torch.export would record the plain version "
            "in the kernel's place; export the float32 model (the served forward)"
        )


def through_op(kernel: str, t: torch.Tensor) -> bool:
    """Whether a wrapper reaches ``kernel``'s float32 forward through its
    custom op: while ``torch.export`` traces. A tensor of another dtype
    raises there (``refuse_export``)."""
    if not torch.compiler.is_exporting():
        return False
    if t.dtype != torch.float32:
        refuse_export(kernel, t.dtype)
    return True


_LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, plain_fn, cuda_fn, fake_fn):
    """The op ``ivf_tpu_torch::<name>``, its schema that of ``plain_fn``'s
    annotated signature: ``plain_fn`` its CPU kernel, ``cuda_fn`` its CUDA
    kernel, ``fake_fn`` its shape function. Returns the op's overload.

    It is registered with ``torch.library.Library`` directly, not with
    ``torch.library.custom_op``: inside an exported program on the card,
    custom_op's Python dispatch (autograd and aliasing wrappers) cost the
    clstm_kth gate route ~1 ms of host time a call, 4x the live model's
    forward at every bucket (PERF.md); registered directly, the artifact
    trails the live model about as much as the stock route's artifact,
    which has no op."""
    _LIB.define(name + torch.library.infer_schema(plain_fn, mutates_args=()))
    _LIB.impl(name, plain_fn, "CPU")
    _LIB.impl(name, cuda_fn, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_fn, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
