"""EAGLE-style drafter and static-tree drafting.

Counterpart of ``lantern_tpu/models/drafter.py``: a shallow decoder that
predicts the base model's next hidden state from (token embedding, previous
base hidden) pairs, ``h = fc([embed(tok), base_hidden])`` -> decoder layers
(no final norm); logits come from the BASE model's lm_head over drafter
hiddens, CFG-combined across the cond/uncond batch pair.

- ``extend`` appends accepted (token, hidden) pairs to the drafter's
  committed prefix;
- ``draft_static`` (EAGLE-1) runs one drafter forward per tree level: a
  level's rows are written provisionally at ``length + block_offset`` and
  see the earlier levels' rows through the forward's ``window_mask``;
- ``draft_stale`` is the drafter-free form: every node proposes from the
  base model's distribution at the last accepted node, which is what the
  hidden-passthrough drafter (``fc_w = [0; I]``, zeroed layers) computes.

``draft_dynamic`` (EAGLE-2) is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..configs import DrafterConfig
from ..kv import KVCache
from ..ops.quant import head_matmul, mm
from ..ops.sampling import (LogitsWarp, cfg_combine, residual_q,
                            sample_without_replacement, uniform, warp_logits)
from ..trees import TreeSpec
from . import transformer as tfm


def init_drafter_params(generator: torch.Generator, dcfg: DrafterConfig,
                        embed: torch.Tensor) -> dict:
    """Random-init drafter params on ``embed``'s device, drawn from
    ``generator`` (which lives there too); ``embed`` is the base model's
    token embedding, shared (not copied)."""
    m = dcfg.model
    p = tfm.init_params(generator, m, device=embed.device)
    del p["lm_head"], p["norm"]
    p["embed"] = embed
    H = m.hidden_size
    fc = torch.empty((2 * H, H), dtype=torch.float32, device=embed.device)
    fc.normal_(generator=generator)
    p["fc_w"] = fc.mul_(0.02).to(m.torch_dtype)
    p["fc_b"] = torch.zeros((H,), dtype=m.torch_dtype, device=embed.device)
    return p


def fuse_inputs(params: dict, tokens: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
    """``fc([embed(tokens), hidden])``."""
    emb = params["embed"][tokens.long()].to(hidden.dtype)
    return mm(torch.cat([emb, hidden], dim=-1), params, "fc_w") + params["fc_b"]


def extend(
    params: dict,
    dcfg: DrafterConfig,
    rope,
    kv: KVCache,
    tokens: torch.Tensor,        # [B2, T] next-token ids (shifted-left stream)
    hidden: torch.Tensor,        # [B2, T, H] base hiddens aligned with tokens
    n_valid,                     # rows actually accepted (<= T), tensor or int
    prefix_valid: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    pos_offsets: Optional[torch.Tensor] = None,
    block_valid: Optional[torch.Tensor] = None,
):
    """Append accepted (token, hidden) pairs to the drafter's committed
    prefix.  Writes all T rows (the tail past ``n_valid`` is garbage above
    the committed length that the next write covers) and advances the cache
    length by ``n_valid`` only.  Returns the drafter output hiddens
    [B2, T, H] and the updated cache.

    ``pos_offsets`` [2]: per-branch position offsets (the uncond stream
    restarts near 0), clamped at 0; ``positions`` overrides entirely.
    ``block_valid`` [B2, T]: pad mask over this block's rows (prompt
    prefill)."""
    T = tokens.shape[1]
    dev = hidden.device
    x = fuse_inputs(params, tokens, hidden)
    if positions is None:
        positions = kv.length + torch.arange(T, device=dev)
        if pos_offsets is not None:
            positions = torch.clamp(
                positions[None, :] - pos_offsets[:, None], min=0)
    block_mask = None
    if block_valid is not None:
        block_mask = (torch.tril(torch.ones((T, T), dtype=torch.bool,
                                            device=dev))[None]
                      & block_valid[:, None, :].bool())
    res = tfm.forward(params, dcfg.model, x, kv, positions, rope,
                      prefix_valid=prefix_valid, block_mask=block_mask,
                      commit=False)
    return res.hidden, res.kv.commit(n_valid)


def _head_logits(base_lm_head, hidden: torch.Tensor, cfg_scale: float,
                 logits_mask: Optional[torch.Tensor] = None, logits_fn=None,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Base lm_head over drafter hiddens, CFG-combined: [2, T, H] -> [T, V],
    with the token mask and the position-indexed constraints applied."""
    logits = cfg_combine(head_matmul(hidden, base_lm_head), cfg_scale)[0]
    if logits_mask is not None:
        logits = torch.where(logits_mask, torch.finfo(torch.float32).min,
                             logits)
    if logits_fn is not None:
        logits = logits_fn(logits, positions)
    return logits


class StaticDraft(NamedTuple):
    ss_token: torch.Tensor       # [G, K] sampled tokens, level-major rows
    ss_prob: torch.Tensor        # [G, K] residual q-probs (sampling) / logits
    level_probs: Tuple[torch.Tensor, ...]  # per level [rows, V] full dists


def _sample_rows(logits: torch.Tensor, generator: Optional[torch.Generator],
                 K: int, warp: LogitsWarp, pin):
    """[rows, V] cfg-combined logits -> (idx [rows, K], q [rows, K], dist).
    Shared by ``draft_static`` (per-level drafter logits) and
    ``draft_stale`` (one stale distribution per level): sampled Gumbel
    top-k, pinned top-k of the warped distribution, or greedy top-k
    logits."""
    if warp.active:
        probs = torch.softmax(warp_logits(logits, warp), dim=-1)
        if pin is not None:
            p_sel, idx = torch.topk(probs, K, dim=-1)
            return idx.to(torch.int32), residual_q(p_sel), probs
        idx, q = sample_without_replacement(generator, probs, K)
        return idx, q, probs
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
            idx1, q1, dist1 = _sample_rows(lgs[i: i + 1], generator, K, warp,
                                           pin)
            ss_token.append(idx1.expand(rows, K))
            ss_prob.append(q1.expand(rows, K))
            level_probs.append(dist1.expand(rows, dist1.shape[-1]))
    return StaticDraft(
        ss_token=torch.cat(ss_token, dim=0),
        ss_prob=torch.cat(ss_prob, dim=0).float(),
        level_probs=tuple(level_probs),
    )


class DeviceLevel(NamedTuple):
    """One ``trees.DrafterLevel`` as device tensors."""
    child_flat_idx: torch.Tensor   # [n] long
    parent_row: torch.Tensor       # [n] long
    window_mask: Optional[torch.Tensor]   # [n, block_offset] bool, or None
    block_mask: torch.Tensor       # [n, n] bool
    block_offset: int


def device_levels(spec: TreeSpec, device) -> Tuple[DeviceLevel, ...]:
    """The tree's drafter levels on ``device`` (built once per decode run).
    A level's compiled ancestor mask splits at its block offset: the
    columns before it are the earlier levels' provisional cache rows (the
    forward's ``window_mask``), the rest the level's own block."""
    out = []
    for lv in spec.levels:
        off = int(lv.block_offset)
        mask = torch.as_tensor(lv.attn_mask, dtype=torch.bool, device=device)
        out.append(DeviceLevel(
            child_flat_idx=torch.as_tensor(lv.child_flat_idx).to(
                device=device, dtype=torch.long),
            parent_row=torch.as_tensor(lv.parent_row).to(
                device=device, dtype=torch.long),
            window_mask=mask[:, :off].contiguous() if off else None,
            block_mask=mask[:, off:].contiguous(), block_offset=off))
    return tuple(out)


def draft_static(
    params: dict,
    dcfg: DrafterConfig,
    spec: TreeSpec,
    rope,
    kv: KVCache,
    root_hidden: torch.Tensor,   # [2, 1, H] drafter output at the root token
    base_lm_head,
    cfg_scale: float,
    warp: LogitsWarp,
    generator: Optional[torch.Generator],
    pos_offsets: Optional[torch.Tensor] = None,
    logits_mask: Optional[torch.Tensor] = None,
    logits_fn=None,
    prefix_valid: Optional[torch.Tensor] = None,
    pin: Optional[float] = None,
    levels: Optional[Tuple[DeviceLevel, ...]] = None,
):
    """EAGLE-1 static-tree drafting.  Returns the draft and the cache whose
    buffers now hold the provisional tree-level rows (length unchanged).
    ``levels``: ``device_levels(spec, device)`` when the caller keeps them
    across steps."""
    K = spec.topk
    dev = root_hidden.device
    if levels is None:
        levels = device_levels(spec, dev)
    ss_token, ss_prob, level_probs = [], [], []
    out_hidden = root_hidden

    def row_positions(n: int, shift: int):
        return (kv.length + shift).to(torch.int32).expand(n)

    # the root row scores depth-1 tokens, which sit at cond position
    # kv.length + 1: the FSM's node-position argument is kv.length
    logits = _head_logits(base_lm_head, out_hidden, cfg_scale, logits_mask,
                          logits_fn, row_positions(1, 0))
    for d in range(len(levels) + 1):
        idx, q, dist = _sample_rows(logits, generator, K, warp, pin)
        ss_token.append(idx)
        ss_prob.append(q)
        level_probs.append(dist)
        if d == len(levels):
            break
        lvl = levels[d]
        flat_tok = idx.reshape(-1)[lvl.child_flat_idx]               # [n_d]
        T = flat_tok.shape[0]
        x = fuse_inputs(params, flat_tok[None, :].expand(2, T),
                        out_hidden.index_select(1, lvl.parent_row))
        pos = row_positions(T, d)
        if pos_offsets is not None:
            pos = torch.clamp(pos[None, :] - pos_offsets[:, None], min=0)
        res = tfm.forward(
            params, dcfg.model, x, kv, positions=pos, rope=rope,
            block_mask=lvl.block_mask, prefix_valid=prefix_valid,
            window_mask=lvl.window_mask, commit=False,
            write_offset=lvl.block_offset)
        kv = res.kv
        out_hidden = res.hidden
        # level-d rows are depth-(d+1) nodes: drafter index kv.length + d,
        # hence cond position kv.length + d + 1 (the drafter stream is
        # shifted one left of the cond stream); the FSM takes the row's own
        # cond position, as in the verifier
        logits = _head_logits(base_lm_head, out_hidden, cfg_scale,
                              logits_mask, logits_fn, row_positions(T, d + 1))
    return StaticDraft(
        ss_token=torch.cat(ss_token, dim=0),
        ss_prob=torch.cat(ss_prob, dim=0).float(),
        level_probs=tuple(level_probs),
    ), kv
