"""Build, load and count the port's hand-written CUDA kernels.

All kernels live in ``lantern_tpu_torch/csrc/*.cu``, each behind a plain C
launcher; ``csrc/bindings.cpp`` binds the launchers to Python.  At first
use ``torch.utils.cpp_extension.load`` compiles them for ``sm_90a`` (ninja
runs one ``nvcc`` per source in parallel) into ``build/lantern_kernels/``
at the repository root, listed in ``.gitignore``; it rebuilds whenever a
source or flag changes.  Nothing here runs at import time.

A build or launch failure raises; there is no fallback to the plain
PyTorch versions.  The kernels have no backward: ``no_autograd`` makes
each wrapper refuse an input that requires grad while grad mode is on,
rather than return a result that autograd silently cuts off.  ``LAUNCHES`` counts kernel launches per kernel: each
wrapper adds one where it launches, so a run can show which kernels its
main path went through.
"""

from __future__ import annotations

import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "lantern_kernels"
SOURCES = ("bindings.cpp", "int8_matmul.cu", "tree_attention.cu",
           "kv_write.cu", "kv_gather.cu")
# torch's default nvcc flags forbid implicit half/bf16 conversions; the
# kernels convert explicitly, so the -U flags only restore nvcc's defaults
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-O3",
              "-U__CUDA_NO_HALF_OPERATORS__", "-U__CUDA_NO_HALF_CONVERSIONS__",
              "-U__CUDA_NO_BFLOAT16_CONVERSIONS__",
              "-U__CUDA_NO_HALF2_OPERATORS__", "-Xptxas", "-v"]

LAUNCHES = {"int8_matmul": 0, "tree_attention": 0, "kv_write": 0,
            "kv_gather": 0}

_lock = threading.Lock()
_state: dict = {}
_sms: dict = {}
_tickets: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def library(verbose: bool = False):
    """The kernel extension module, built at first call.  ``verbose`` shows
    the build's output (``ptxas`` register and spill counts included)."""
    with _lock:
        ext = _state.get("ext")
        if ext is None:
            from torch.utils.cpp_extension import load

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            ext = load(name="lantern_kernels",
                       sources=[str(CSRC / s) for s in SOURCES],
                       extra_cflags=["-O3"], extra_cuda_cflags=NVCC_FLAGS,
                       extra_include_paths=[str(CSRC)],
                       build_directory=str(BUILD_DIR), verbose=verbose)
            _state["ext"] = ext
        return ext


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (read once per device)."""
    n = _sms.get(device)
    if n is None:
        n = _sms[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def tickets(device, kernel: str, n: int) -> torch.Tensor:
    """At least ``n`` int32 arrival counters for ``kernel`` on ``device``,
    zero between launches: a kernel whose thread blocks elect the last to
    finish counts on them and resets them itself, so they are zeroed only
    when (re)allocated.  Launches that share them must follow one another
    on one stream, as the port's do."""
    t = _tickets.get((device, kernel))
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _tickets[(device, kernel)] = t
    return t


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lives on a CUDA device, False when all are on
    the CPU; mixed placement raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"lantern_tpu_torch: tensors on mixed devices {kinds}")


def no_autograd(what: str, *tensors) -> None:
    """Raise when grad mode is on and an input of the kernel ``what``
    requires grad: the CUDA kernels return tensors without a ``grad_fn``,
    so a backward through them would stop there unnoticed.  Inference runs
    under ``torch.no_grad()``; training goes through the dense, cache-free
    ``models.transformer.forward_train``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"lantern_tpu_torch: {what}: an input requires grad under grad "
            f"mode, and the CUDA kernel has no backward; run it under "
            f"torch.no_grad(), or train through forward_train")


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lantern_tpu_torch: {msg}")


def aligned(t: torch.Tensor, nbytes: int = 16) -> bool:
    return t.data_ptr() % nbytes == 0
