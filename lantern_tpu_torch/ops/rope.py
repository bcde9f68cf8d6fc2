"""1-D rotary position embeddings, rotate-half pairing (Chameleon family).

Counterpart of ``lantern_tpu/ops/rope.py``: ``rope_table_1d`` and
``apply_rope_half``.  The 2-D grid tables and interleaved pairing belong to
the LlamaGen lane, which is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_table_1d(max_pos: int, head_dim: int, base: float
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) host tables [max_pos, head_dim] for rotate-half application."""
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    f = np.outer(np.arange(max_pos), inv)                    # [p, hd/2]
    emb = np.concatenate([f, f], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; positions broadcastable to [..., T];
    ``cos``/``sin`` f32 tables on x's device.  Computed in f32."""
    c = cos[positions].unsqueeze(-2)                          # [..., T, 1, hd]
    s = sin[positions].unsqueeze(-2)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)
