"""Emu3-Gen: token prompts under CFG with a negative prompt, an image that
may already be in flight (a prefix of whole rows in both prompts), and the
rotate-half 1-D rope at the configuration's theta (1e6).

A request is ``{"text_ids", "negative_ids", "prefix_ids"}``: cond = bos +
caption + header + prefix, uncond = bos + negative + header + prefix, the
header ``boi + size ids + img`` from the configuration's ``image`` group.
Each row is its own sequence, unpadded, its positions from 0: the reference
knows nothing of the program's padding.  The served tokens continue both
rows; the rows that predict them are compared."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import chameleon


def prompt(cfg: dict, desc: dict) -> Tuple[list, list]:
    im = cfg["image"]
    head = [im["start_id"]] + list(im["size_ids"]) + [im["img_id"]]
    tail = head + [int(t) for t in desc.get("prefix_ids", ())]
    return ([im["bos_id"]] + [int(t) for t in desc["text_ids"]] + tail,
            [im["bos_id"]] + [int(t) for t in desc["negative_ids"]] + tail)


def rows(cfg: dict, weights: dict, desc: dict, served: np.ndarray,
         device) -> Tuple[List[dict], List[torch.Tensor]]:
    n = len(served)
    fed = torch.as_tensor(np.asarray(served[: n - 1], np.int64),
                          device=device)
    out, idx = [], []
    for p in prompt(cfg, desc):
        ids = torch.cat([torch.as_tensor(p, device=device), fed])
        T = ids.shape[0]
        out.append(dict(ids=ids, prefix=None,
                        positions=torch.arange(T, device=device),
                        key_valid=torch.ones(T, dtype=torch.bool,
                                             device=device)))
        idx.append(torch.arange(len(p) - 1, len(p) - 1 + n, device=device))
    return out, idx


# the published rope of a LLaMA block: rotate-half pairs, 1-D positions
rope = chameleon.rope
