"""EAGLE-style drafter: static (EAGLE-1) and dynamic (EAGLE-2) drafting.

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
  hidden-passthrough drafter (``fc_w = [0; I]``, zeroed layers) computes;
- ``draft_dynamic`` (EAGLE-2) beam-expands ``depth`` levels of ``top_k``
  rows each (level ``i`` written at ``length + i * top_k`` behind a window
  of the earlier levels' rows), keeps the best ``total_tokens - 1`` nodes
  by cumulative log-probability and re-assembles them into a tree (ancestor
  closure, children table, all-node root paths in lexicographic order).

Every top-k that can decide a tree goes through ``topk_stable``: among
equal values the lower index comes first, as in ``jax.lax.top_k``.  With the
passthrough drafter a level's rows share one distribution, so ties there
are the rule, not the exception.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..configs import DrafterConfig
from ..kv import KVCache
from ..ops.quant import head_matmul, mm
from ..ops.sampling import (LogitsWarp, cfg_combine, residual_q,
                            sample_without_replacement, topk_stable, uniform,
                            warp_logits)
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
            p_sel, idx = topk_stable(probs, K)
            return idx.to(torch.int32), residual_q(p_sel), probs
        idx, q = sample_without_replacement(generator, probs, K)
        return idx, q, probs
    vals, idx = topk_stable(logits, K)
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


class DynamicDraft(NamedTuple):
    draft_tokens: torch.Tensor       # [N+1] int32, the committed root first
    retrieve_indices: torch.Tensor   # [N+1, depth+2] root paths, -1 pads
    tree_mask: torch.Tensor          # [N+1, N+1] bool ancestor-or-self
    tree_position_ids: torch.Tensor  # [N+1] node depths
    children: torch.Tensor           # [N+1, top_k] child slots, -1 pads


def _ancestor_closure(parent: torch.Tensor, depth_bound: int) -> torch.Tensor:
    """``parent`` [n] (the root's parent is 0) -> the ancestor-or-self
    matrix [n, n] bool; column 0 (the root) is always visible."""
    n = parent.shape[0]
    A = torch.eye(n, dtype=torch.bool, device=parent.device)
    A[:, 0] = True
    for _ in range(depth_bound):
        A = A | A[parent]
    return A


def draft_dynamic(
    params: dict,
    dcfg: DrafterConfig,
    rope,
    kv: KVCache,
    root_hidden: torch.Tensor,   # [2, 1, H] drafter output at the root token
    root_token: torch.Tensor,    # [] committed root token id
    base_lm_head,
    cfg_scale: float,
    warp: LogitsWarp,
    pos_offsets: Optional[torch.Tensor] = None,
    logits_mask: Optional[torch.Tensor] = None,
    logits_fn=None,
    prefix_valid: Optional[torch.Tensor] = None,
):
    """EAGLE-2 dynamic beam drafting.  Returns the draft and the cache whose
    buffers hold the ``depth * top_k`` provisional level rows (length
    unchanged).  Deterministic given the drafter's logits: every choice is
    a top-k of (warped) log-probabilities."""
    K, depth = dcfg.top_k, dcfg.depth
    N = dcfg.total_tokens - 1          # nodes besides the root
    dev = root_hidden.device
    i32 = dict(dtype=torch.int32, device=dev)

    def head_logp(hidden, shift: int, n: int):
        logits = _head_logits(base_lm_head, hidden, cfg_scale, logits_mask,
                              logits_fn, (kv.length + shift).to(
                                  torch.int32).expand(n))
        return torch.log_softmax(warp_logits(logits, warp), dim=-1)

    # the root row scores depth-1 tokens (cond position kv.length + 1)
    topk_p, topk_i = topk_stable(head_logp(root_hidden, 0, 1), K)   # [1, K]
    scores = topk_p[0]
    scores_list, ss_list = [scores], [topk_i[0]]
    parents_list = [torch.zeros((1,), **i32)]
    tokens = topk_i.to(torch.int32).expand(2, K)
    input_hidden = root_hidden.expand(2, K, root_hidden.shape[-1])
    eye = torch.eye(K, dtype=torch.bool, device=dev)
    tree_mask = eye                                    # [K, K * (i + 1)]
    topk_cs_index = torch.arange(K, **i32)
    for i in range(depth):
        x = fuse_inputs(params, tokens, input_hidden)
        pos = (kv.length + i).to(torch.int32).expand(K)
        if pos_offsets is not None:
            pos = torch.clamp(pos[None, :] - pos_offsets[:, None], min=0)
        res = tfm.forward(
            params, dcfg.model, x, kv, positions=pos, rope=rope,
            block_mask=tree_mask[:, i * K:], prefix_valid=prefix_valid,
            window_mask=tree_mask[:, :i * K] if i else None, commit=False,
            write_offset=i * K)
        kv = res.kv
        out_hidden = res.hidden                                  # [2, K, H]
        bias = 1 + K * K * max(i - 1, 0) + (K if i > 0 else 0)
        parents_list.append(topk_cs_index + bias)
        # level-i rows sit at cond position kv.length + i + 1
        topk_p, topk_i = topk_stable(head_logp(out_hidden, i + 1, K), K)
        cu = topk_p + scores[:, None]                            # [K, K]
        scores, topk_cs_index = topk_stable(cu.reshape(-1), K)
        topk_cs_index = topk_cs_index.to(torch.int32)
        out_ids = (topk_cs_index // K).long()
        input_hidden = out_hidden.index_select(1, out_ids)
        tokens = topk_i.reshape(-1)[topk_cs_index.long()].to(
            torch.int32)[None, :].expand(2, K)
        ss_list.append(topk_i.reshape(-1))
        scores_list.append(cu.reshape(-1))
        tree_mask = torch.cat([tree_mask[out_ids], eye], dim=1)

    scores_flat = torch.cat(scores_list)                 # [K + depth * K^2]
    ss_flat = torch.cat(ss_list)
    top_idx = torch.sort(topk_stable(scores_flat, N)[1]).values
    draft_tokens = torch.cat([root_token.reshape(1).to(torch.int32),
                              ss_flat[top_idx].to(torch.int32)])
    parents_flat = torch.cat(parents_list)               # [1 + depth * K]
    draft_parents = parents_flat[top_idx // K]
    mask_index = torch.searchsorted(top_idx, (draft_parents - 1).to(
        top_idx.dtype), right=False)
    mask_index = torch.where(draft_parents == 0, -1, mask_index) + 1
    n1 = N + 1
    # a parent missing from the kept nodes would index past the table, where
    # the JAX gathers clamp: clamp explicitly
    parent = torch.clamp(torch.cat([torch.zeros((1,), **i32),
                                    mask_index.to(torch.int32)]), 0, N).long()
    A = _ancestor_closure(parent, depth + 1)                     # [N+1, N+1]
    tree_position_ids = A.sum(dim=1).to(torch.int32) - 1

    # children table for the tree walk: child slots per parent in sibling
    # order (rank = earlier slots with the same parent, the root excluded:
    # its own parent entry is 0).  (parent, rank) pairs are unique; a rank
    # past top_k lands in a spare column that is cut off, as the JAX
    # scatter drops it
    slots = torch.arange(n1, device=dev)
    same_before = ((parent[None, :] == parent[:, None])
                   & (slots[None, :] < slots[:, None]) & (slots[None, :] > 0))
    sib_rank = torch.clamp(same_before.sum(dim=1), max=K)
    children = torch.full((n1, K + 1), -1, **i32)
    children.index_put_((parent[1:], sib_rank[1:]), slots[1:].to(torch.int32))
    children = children[:, :K].contiguous()

    # all-node root paths (a prefix-closed superset of the leaf paths),
    # sorted lexicographically with pads last
    D = depth + 2
    rows = torch.arange(n1, device=dev)
    paths = torch.full((n1, D), -1, **i32)
    cur = rows.clone()
    col = tree_position_ids.long()
    for _ in range(D):
        c = torch.clamp(col, 0, D - 1)
        paths[rows, c] = torch.where(col >= 0, cur.to(torch.int32),
                                     paths[rows, c])
        cur = parent[cur]
        col = col - 1
    keys = torch.where(paths < 0, n1 + 5, paths)
    order = rows
    for c in range(D - 1, -1, -1):       # least significant column first
        order = order[torch.sort(keys[order, c], stable=True).indices]
    return DynamicDraft(
        draft_tokens=draft_tokens,
        retrieve_indices=paths[order],
        tree_mask=A,
        tree_position_ids=tree_position_ids,
        children=children,
    ), kv
