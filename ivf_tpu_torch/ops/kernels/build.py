"""Builds the CUDA sources in ``ivf_tpu_torch/csrc/`` and binds them.

Each ``csrc/<name>.cu`` exports plain C functions. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into
``ivf_tpu_torch/_build/lib<name>.so`` and loaded with ``ctypes``: no
PyTorch headers, so a build takes seconds. A library is rebuilt when its
source, or a header in ``csrc/`` (``*.cuh``), is newer than it. ``build`` compiles several sources at once, one
``nvcc`` process each, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    candidates = [
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ]
    for path in candidates:
        if path and os.path.isfile(path):
            return path
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of ivf_tpu_torch "
        "are compiled at first use"
    )


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile ``csrc/<name>.cu`` for every name, all in parallel. Returns
    each name's ``ptxas`` report (registers, shared memory, spills).
    Raises with the compiler's output if any source fails."""
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    procs = {}
    for name in names:
        tmp = BUILD_DIR / f"lib{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    reports, failures = {}, []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name}.cu (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, library_path(name))
        reports[name] = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return reports


def _stale(name: str) -> bool:
    """The library is missing, or older than its source or any header in
    ``csrc/`` (the sources include them)."""
    lib = library_path(name)
    if not lib.exists():
        return True
    inputs = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or stale."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        return lib


def stream(t: torch.Tensor) -> int:
    """The raw handle of the current CUDA stream on ``t``'s device, for a
    launch: one C call, where ``torch.cuda.current_stream`` runs several
    Python functions a launch (on the card, far slower inside an exported
    program's op than in eager code)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)
