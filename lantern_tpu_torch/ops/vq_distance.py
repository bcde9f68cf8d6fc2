"""VQ-codebook nearest-latent tables for LANTERN relaxed acceptance
(counterpart of ``lantern_tpu/ops/vq_distance.py``)."""

from __future__ import annotations

import numpy as np
import torch


def nearest_latents(codebook: torch.Tensor, k: int | None = None,
                    l2_normalize: bool = False) -> np.ndarray:
    """codebook [V, d] -> [V, k] int32 nearest code ids (self excluded),
    sorted by ascending L2 distance."""
    cb = torch.as_tensor(codebook).float()
    V = cb.shape[0]
    k = k if k is not None else V - 1
    if l2_normalize:
        cb = cb / torch.clamp(cb.norm(dim=-1, keepdim=True), min=1e-12)
    sq = (cb * cb).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (cb @ cb.T)
    d2.fill_diagonal_(float("inf"))
    idx = torch.topk(-d2, k, dim=-1).indices
    return idx.to(torch.int32).cpu().numpy()


def save_table(path: str, table: np.ndarray) -> None:
    """uint16 .npy, the reference's on-disk format
    (``ckpts/<model>/vq_distances/top_<k>_indices.npy``)."""
    np.save(path, np.asarray(table).astype(np.uint16))


def load_table(path: str) -> np.ndarray:
    return np.load(path).astype(np.int32)
