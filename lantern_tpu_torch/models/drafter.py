"""Stale-distribution (drafter-free) static drafting.

Counterpart of ``StaticDraft``, ``_sample_rows`` and ``draft_stale`` in
``lantern_tpu/models/drafter.py``.  Every tree node proposes from the base
model's raw cfg-combined distribution at the last accepted node (which the
verify step already computed); per level only the position-indexed
constraints (logits mask, Lumina grid FSM) change.  The EAGLE drafter
network (``extend``, ``draft_static``, ``draft_dynamic``) comes with the
LlamaGen/XL lane.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ops.sampling import LogitsWarp, residual_q, uniform, warp_logits
from ..trees import TreeSpec


class StaticDraft(NamedTuple):
    ss_token: torch.Tensor       # [G, K] sampled tokens, level-major rows
    ss_prob: torch.Tensor        # [G, K] residual q-probs (sampling) / logits
    level_probs: Tuple[torch.Tensor, ...]  # per level [rows, V] full dists


def _sample_rows(logits: torch.Tensor, K: int, warp: LogitsWarp):
    """[rows, V] cfg-combined logits -> (idx [rows, K], q [rows, K], dist)
    for the deterministic proposals: pinned top-k of the warped
    distribution, or greedy top-k logits.  (Unpinned sampling is
    ``draft_stale``'s batched Gumbel top-k.)"""
    if warp.active:
        probs = torch.softmax(warp_logits(logits, warp), dim=-1)
        p_sel, idx = torch.topk(probs, K, dim=-1)
        return idx.to(torch.int32), residual_q(p_sel), probs
    idx = torch.topk(logits, K, dim=-1).indices
    vals = torch.gather(logits, -1, idx)
    return (idx.to(torch.int32), vals,
            torch.zeros((logits.shape[0], 0), dtype=torch.float32,
                        device=logits.device))


def draft_stale(
    spec: TreeSpec,
    root_logits: torch.Tensor,   # [V] raw cfg-combined logits at the root
    length: torch.Tensor,        # [] committed base length (FSM position base)
    warp: LogitsWarp,
    generator: Optional[torch.Generator],
    logits_mask: Optional[torch.Tensor] = None,
    logits_fn=None,
    pin: Optional[float] = None,
) -> StaticDraft:
    """Drafter-free static drafting from one stale distribution: per level,
    re-apply the position-indexed constraints to the root logits at that
    level's parent position, broadcast to the level's rows, and sample."""
    K = spec.topk
    lg0 = root_logits.float()[None, :]                           # [1, V]
    if logits_mask is not None:
        lg0 = torch.where(logits_mask, torch.finfo(torch.float32).min, lg0)
    V = lg0.shape[-1]
    n_levels = len(spec.levels) + 1
    lgs = lg0.expand(n_levels, V)
    if logits_fn is not None:
        lgs = logits_fn(lgs, length + torch.arange(
            n_levels, dtype=torch.int32, device=lg0.device))
    level_rows = [1] + [len(lv.child_flat_idx) for lv in spec.levels]
    ss_token, ss_prob, level_probs = [], [], []
    if warp.active and pin is None:
        dists = torch.softmax(warp_logits(lgs, warp), dim=-1)
        zs = []
        for i, rows in enumerate(level_rows):
            logp = torch.log(torch.clamp(dists[i], min=1e-30))
            u = uniform(generator, (rows, V), lg0.device, 1e-20, 1.0)
            zs.append(logp[None] + (-torch.log(-torch.log(u))))
        idx_all = torch.topk(torch.cat(zs, dim=0), K, dim=-1).indices
        off = 0
        for i, rows in enumerate(level_rows):
            idx = idx_all[off: off + rows]
            off += rows
            dist = dists[i: i + 1].expand(rows, V)
            ss_token.append(idx.to(torch.int32))
            ss_prob.append(residual_q(torch.gather(dist, -1, idx)))
            level_probs.append(dist)
    else:
        for i, rows in enumerate(level_rows):
            idx1, q1, dist1 = _sample_rows(lgs[i: i + 1], K, warp)
            ss_token.append(idx1.expand(rows, K))
            ss_prob.append(q1.expand(rows, K))
            level_probs.append(dist1.expand(rows, dist1.shape[-1]))
    return StaticDraft(
        ss_token=torch.cat(ss_token, dim=0),
        ss_prob=torch.cat(ss_prob, dim=0).float(),
        level_probs=tuple(level_probs),
    )
