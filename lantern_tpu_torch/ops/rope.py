"""Rotary position embeddings: 1-D (Chameleon) and 2-D image grid (LlamaGen).

Counterpart of ``lantern_tpu/ops/rope.py``.  Two pairings:

- **half** (Chameleon): the first and second half of a head rotate together
  (``rope_table_1d``, ``apply_rope_half``);
- **interleaved** (LlamaGen): adjacent channel pairs rotate together, over
  a 2-D table whose first half of the pair frequencies follows the grid row
  and second half the grid column (``rope_table_2d``,
  ``apply_rope_interleaved``).

The 2-D table's conditioning-prefix rows are ZERO (cos = sin = 0), which
zeroes q and k at prefix positions: LlamaGen's own quirk, reproduced
exactly (prefix keys then score 0 against every query before masking).
Ten zero rows past the grid absorb a speculative block's overshoot.
Tables are host numpy arrays; application gathers rows by per-token
position ids (tree nodes share positions) and computes in f32.
"""

from __future__ import annotations

import numpy as np
import torch


def rope_table_2d(grid_size: int, head_dim: int, base: float,
                  cls_token_num: int, pad: int = 10
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) host tables [cls + grid^2 + pad, head_dim // 2] for
    interleaved application over an image grid in raster order."""
    half = head_dim // 2
    freqs = 1.0 / (base ** (np.arange(0, half, 2)[: half // 2] / half))
    f = np.outer(np.arange(grid_size), freqs)                 # [g, hd/4]
    fx = np.broadcast_to(f[:, None, :], (grid_size, grid_size, f.shape[1]))
    fy = np.broadcast_to(f[None, :, :], (grid_size, grid_size, f.shape[1]))
    grid = np.concatenate([fx, fy], axis=-1).reshape(grid_size * grid_size,
                                                     half)
    zeros_pre = np.zeros((cls_token_num, half), np.float32)
    zeros_post = np.zeros((pad, half), np.float32)
    return (np.concatenate([zeros_pre, np.cos(grid).astype(np.float32),
                            zeros_post], 0),
            np.concatenate([zeros_pre, np.sin(grid).astype(np.float32),
                            zeros_post], 0))


def rope_table_1d(max_pos: int, head_dim: int, base: float
                  ) -> tuple[np.ndarray, np.ndarray]:
    """(cos, sin) host tables [max_pos, head_dim] for rotate-half application."""
    inv = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    f = np.outer(np.arange(max_pos), inv)                    # [p, hd/2]
    emb = np.concatenate([f, f], axis=-1)
    return np.cos(emb).astype(np.float32), np.sin(emb).astype(np.float32)


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor,
                           positions: torch.Tensor) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; positions broadcastable to [..., T];
    ``cos``/``sin`` f32 [P, head_dim // 2] on x's device.  Channels 2i and
    2i+1 rotate by row i of the table.  Computed in f32."""
    c = cos[positions].unsqueeze(-2)                          # [..., T, 1, hd/2]
    s = sin[positions].unsqueeze(-2)
    xf = x.float().reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * c - x1 * s, x1 * c + x0 * s], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """x: [..., T, n_heads, head_dim]; positions broadcastable to [..., T];
    ``cos``/``sin`` f32 tables on x's device.  Computed in f32."""
    c = cos[positions].unsqueeze(-2)                          # [..., T, 1, hd]
    s = sin[positions].unsqueeze(-2)
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return (x.float() * c + rotated.float() * s).to(x.dtype)
