"""Chameleon (Lumina-mGPT, Anole): token prompts under parallel CFG and the
rotate-half 1-D rope."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def prompt(cfg: dict, text_ids) -> Tuple[list, list]:
    """Lumina's parallel-CFG prompt: cond = text + [image-start, h-grid,
    w-grid]; uncond = the same three-token header (its pads are invisible
    and its positions restart at the header, so the reference leaves them
    out)."""
    im = cfg["image"]
    h, w = im["grid"]
    per = im["latents_per_patch"]
    header = [im["start_id"], im["grid_token_base"] + h // per,
              im["grid_token_base"] + w // per]
    return list(text_ids) + header, header


def rows(cfg: dict, weights: dict, desc: dict, served: np.ndarray,
         device) -> Tuple[List[dict], List[torch.Tensor]]:
    n = len(served)
    fed = torch.as_tensor(np.asarray(served[: n - 1], np.int64),
                          device=device)
    cond, uncond = prompt(cfg, desc["text_ids"])
    out = []
    for p in (cond, uncond):
        ids = torch.cat([torch.as_tensor(p, device=device), fed])
        T = ids.shape[0]
        out.append(dict(ids=ids, prefix=None,
                        positions=torch.arange(T, device=device),
                        key_valid=torch.ones(T, dtype=torch.bool,
                                             device=device)))
    return out, [torch.arange(a, a + n, device=device)
                 for a in (len(cond) - 1, len(uncond) - 1)]


def rope(cfg: dict, row: dict, device):
    """Rotate-half 1-D rope at the row's positions."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, hd, 2, device=device, dtype=torch.float64) / hd))
    f = row["positions"].double()[:, None] * inv[None]
    f = torch.cat([f, f], -1)
    cos, sin = torch.cos(f).float()[:, None], torch.sin(f).float()[:, None]

    def apply(x):
        h = x.shape[-1] // 2
        return x * cos + torch.cat([-x[..., h:], x[..., :h]], -1) * sin

    return apply
