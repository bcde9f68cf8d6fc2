"""PyTorch / CUDA port of ``lantern_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's layout (``configs``, ``kv``,
``trees``, ``ops``, ``models``, ``engine``) so each module has an obvious
counterpart.  It imports ``torch`` only — never ``jax`` and nothing of
``lantern_tpu`` — and keeps its own copies of the numpy-only code it needs.

Entry points take an explicit ``device``: ``None`` means ``"cuda"`` and
raises when no card is present; tests pass ``device="cpu"``.  On a CUDA
tensor every op that replaced a Pallas kernel launches a hand-written CUDA
kernel (``csrc/``, built by ``torch.utils.cpp_extension.load`` at first
use); on a CPU tensor it
runs the op's plain PyTorch version.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
