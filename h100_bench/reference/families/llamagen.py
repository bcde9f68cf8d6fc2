"""LlamaGen t2i: a caption prefix from T5 features through
``CaptionEmbedder``'s MLP, and the 2-D rope of ``precompute_freqs_cis_2d``
on interleaved lane pairs, zero over the prefix."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import captions


def caption_prefix(weights: dict, feats: torch.Tensor) -> torch.Tensor:
    """LlamaGen's caption MLP over T5 features [Tc, Dc] -> [Tc, H] f32
    (bfloat16 adapter weights, no biases, tanh GELU; not quantised)."""
    c = weights["cond"]
    h = F.gelu(feats.float() @ c["fc1"].float(), approximate="tanh")
    return h @ c["fc2"].float()


def rows(cfg: dict, weights: dict, desc: dict, served: np.ndarray,
         device) -> Tuple[List[dict], List[torch.Tensor]]:
    n = len(served)
    fed = torch.as_tensor(np.asarray(served[: n - 1], np.int64),
                          device=device)
    cap = cfg["caption"]
    feats, valid = captions.features(desc["caption"], cap["dim"],
                                     cap["rows"])
    valid = torch.as_tensor(valid, device=device)
    # the caption's pads are zero features; their rows are invisible
    cond_pre = caption_prefix(weights, torch.as_tensor(
        feats, device=device)) * valid[:, None]
    uncond_pre = caption_prefix(weights, weights["cond"]["uncond"])
    Tc = cap["rows"]
    T = Tc + fed.shape[0]
    # both CFG rows mask the caption's pads (LlamaGen's emb_mask)
    kv = torch.cat([valid, torch.ones(fed.shape[0], dtype=torch.bool,
                                      device=device)])
    out = [dict(ids=fed, prefix=pre, positions=torch.arange(T, device=device),
                key_valid=kv) for pre in (cond_pre, uncond_pre)]
    return out, [torch.arange(Tc - 1, Tc - 1 + n, device=device)] * 2


def rope(cfg: dict, row: dict, device):
    """(cos, sin) [prefix + grid^2, hd / 2] of the 2-D table, zero over the
    prefix, applied to interleaved lane pairs."""
    hd = cfg["hidden_size"] // cfg["num_attention_heads"]
    grid, prefix = cfg["image"]["grid"][0], cfg["caption"]["rows"]
    half = hd // 2
    freqs = 1.0 / (cfg["rope_theta"] ** (torch.arange(
        0, half, 2, device=device, dtype=torch.float64)[: half // 2] / half))
    f = torch.outer(torch.arange(grid, device=device, dtype=torch.float64),
                    freqs)
    fg = torch.cat([f[:, None, :].expand(grid, grid, -1),
                    f[None, :, :].expand(grid, grid, -1)], -1).reshape(
        grid * grid, half)
    z = torch.zeros((prefix, half), dtype=torch.float64, device=device)
    pos = torch.clamp(row["positions"], max=prefix + grid * grid - 1)
    c = torch.cat([z, torch.cos(fg)]).float()[pos][:, None]
    s = torch.cat([z, torch.sin(fg)]).float()[pos][:, None]

    def apply(x):
        x0, x1 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x0 * c - x1 * s, x1 * c + x0 * s],
                           -1).reshape(x.shape)

    return apply
