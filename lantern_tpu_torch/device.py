"""Device resolution for the port's entry points, and full-f32 math."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  A CUDA device without a card raises: the port
    never falls back to the CPU silently; callers ask for it by name."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lantern_tpu_torch: CUDA device requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): a host clock
    read after it measures the work, not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def full_f32():
    """Full-f32 convolutions and matmuls inside the block: cuDNN and cuBLAS
    may otherwise pick TF32 tensor-core paths on the card, whose 10-bit
    mantissas move results by ~1e-3, far past the CPU comparisons."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                        allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
