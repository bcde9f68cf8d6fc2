"""Speculative decode engine: static (EAGLE-1) and dynamic (EAGLE-2) trees.

Counterpart of ``lantern_tpu/engine/spec.py``: draft -> one tree-verify
forward -> acceptance (greedy or LANTERN rejection-sampling walk) -> commit
-> next draft.

Drafting, static mode: the EAGLE drafter (``drafter.extend`` over the
accepted rows, then ``drafter.draft_static``: one drafter forward per tree
level) or, with ``stale_draft``, ``drafter.draft_stale`` (no drafter
forwards).  Dynamic mode: ``drafter.draft_dynamic`` beam-expands a tree of
its own shape each step (``DrafterConfig.total_tokens``, ``depth``,
``top_k``).

Commit is either provisional write + rollback (the verify forward writes
all N+1 tree rows at ``length`` and ``KVCache.accept_path`` compacts the
accepted ones: kernel K4) or, with ``deferred_commit`` (static mode only),
deferred: the tree block's K/V never hit the cache, the state carries them
and the NEXT verify forward commits only the accepted rows
(``forward(extra_kv=...)``).  Both commit the same bytes.

Two conditioning styles: a LlamaGen embedding prefix (``cond``/``uncond``
label ids or caption features, ``prefix_valid`` for caption pads) or a
Chameleon token prompt (``token_prompt``).

A plain Python loop replaces ``lax.while_loop``; its condition reads three
scalars back per step.  Everything else stays on the device.

A step is built from per-request pieces that the batched engine
(``engine/batch.py``) shares: ``static_tree_block`` (the tree of a draft),
``verify_forward`` (one tree-verify forward of R requests' CFG row pairs),
``accept`` (one request's acceptance walk), ``advance`` (commit the
verdict into the request's state and extend its drafter),
``next_static_draft`` and, in dynamic mode, ``dynamic_tree_block`` and
``next_dynamic_draft``.  ``request_generator`` is a request's random
stream.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..configs import DrafterConfig, ModelConfig
from ..device import resolve_device
from ..kv import KVCache
from ..models import drafter as drf
from ..models import transformer as tfm
from ..models.chameleon import TokenPrompt
from ..ops import acceptance as acc
from ..ops.quant import head_of
from ..ops.sampling import LogitsWarp, categorical, cfg_combine, sample_token
from ..trees import TreeSpec

__all__ = ["SpecDecodeConfig", "SpecState", "SpecResult", "TokenPrompt",
           "make_static_step", "make_dynamic_step", "prefill_request",
           "generate", "request_generator"]


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Engine config (see the JAX counterpart for each field)."""

    warp: LogitsWarp = LogitsWarp()
    cfg_scale: float = 4.0
    lantern: acc.LanternSpec = acc.LanternSpec()
    max_new: int = 256
    mode: str = "static"            # "static" (EAGLE-1) | "dynamic" (EAGLE-2)
    kv_quant: bool = False
    # pin every stochastic choice: acceptance coins become this constant,
    # proposals deterministic top-k, bonus/t0 sampling argmax
    pin: Optional[float] = None
    drafter_warp: Optional[LogitsWarp] = None
    stale_draft: bool = False
    deferred_commit: bool = False
    walk_batch_warp: Optional[bool] = None
    stop_ids: Tuple[int, ...] = ()

    @property
    def dwarp(self) -> LogitsWarp:
        return self.drafter_warp if self.drafter_warp is not None else self.warp


class SpecState(NamedTuple):
    base_kv: KVCache
    draft_kv: Optional[KVCache]     # the drafter's cache (None when stale)
    draft: object                   # drf.StaticDraft | drf.DynamicDraft
    root_token: torch.Tensor        # [] sampled-but-unverified next token
    tokens: torch.Tensor            # [max_new + pad] committed ids
    n_new: torch.Tensor             # [] committed count
    steps: torch.Tensor             # [] verify steps taken
    accept_sum: torch.Tensor        # [] total accepted tokens (incl. roots)
    stopped: torch.Tensor           # [] a stop id was committed
    # deferred-commit carry (None otherwise).  INVARIANT: between steps
    # base_kv lags the committed token stream by ``pn`` rows; they live in
    # blk[psel[:pn]] and the NEXT verify forward commits them.
    blk: Optional[tuple] = None             # (k, v) [L, B, N+1, n_kv, hd]
    psel: Optional[torch.Tensor] = None     # [D] accepted slots into blk
    pn: Optional[torch.Tensor] = None       # [] accepted count


class SpecResult(NamedTuple):
    tokens: torch.Tensor            # [max_new]
    steps: int
    accept_sum: int
    n_valid: int

    @property
    def step_compression(self) -> float:
        return self.accept_sum / max(self.steps, 1)


class _Ctx(NamedTuple):
    params: dict
    rope: tuple
    nearest: Optional[torch.Tensor]
    prefix_valid: torch.Tensor          # [2, S] bool
    pos_offsets: torch.Tensor           # [2] per-branch position shift (0s
                                        # for an embedding prefix)
    logits_mask: Optional[torch.Tensor]
    logits_fn: object
    generator: Optional[torch.Generator]
    # the EAGLE drafter (None with stale drafting)
    dparams: Optional[dict] = None
    dcfg: Optional[DrafterConfig] = None
    drope: Optional[tuple] = None
    # pad mask threaded into the drafter's forwards: token prompts only
    # (the LlamaGen drafter takes no mask)
    drafter_pv: Optional[torch.Tensor] = None
    levels: tuple = ()                  # drafter.device_levels of the tree
    # ``ecfg.stop_ids`` on the device, made once at prefill so that a step
    # copies nothing from the host
    stops: Optional[torch.Tensor] = None
    # the LANTERN operating point as device tensors (``acc.LanternRT``);
    # None is ``ecfg.lantern``'s static (k, delta)
    lantern_rt: Optional[acc.LanternRT] = None


def bind_logits_fn(logits_fn, pos_offsets):
    """Bind the request's grid-start index (``pos_offsets[1]``) into a
    Lumina grid FSM."""
    if logits_fn is None or not hasattr(logits_fn, "image_start_idx"):
        return logits_fn

    def bound(logits, positions):
        return logits_fn(logits, positions, start=pos_offsets[1])
    return bound


def _safe_gather_ext(vec_ext: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather with -1 indices mapped to the last (pad) slot of ``vec_ext``."""
    return vec_ext[torch.where(idx < 0, vec_ext.shape[0] - 1, idx).long()]


def _mask_logits(logits, mask):
    if mask is None:
        return logits
    return torch.where(mask, torch.finfo(torch.float32).min, logits)


class TreeBlock(NamedTuple):
    """One request's draft tree as a verify forward and its acceptance take
    it (static: the spec's constants and the draft's tokens; dynamic: the
    draft's own tree)."""
    tokens: torch.Tensor              # [N+1] node tokens, the root first
    candidates: torch.Tensor          # [P, D] root paths' tokens, -1 pads
    node_q: Optional[torch.Tensor]    # [N+1] residual q (sampling, static)
    level_probs: Optional[tuple]      # per level [rows, V] (sampling, static)
    children: torch.Tensor            # [N+1, K] child slots, -1 pads
    inlevel_rank: Optional[torch.Tensor]  # [N+1] (sampling, static)
    mask: torch.Tensor                # [N+1, N+1] ancestor-or-self
    pos: torch.Tensor                 # [N+1] node depths
    retrieve: torch.Tensor            # [P, D] root paths' slots, -1 pads
    max_depth: int


class Verdict(NamedTuple):
    """One request's acceptance of its tree."""
    sel_slots: torch.Tensor           # [D] accepted path's slots (pads in
                                      # range: clamped into the block)
    alen: torch.Tensor                # [] accepted draft nodes
    n_acc: torch.Tensor               # [] int32 committed tokens, alen + 1
    bonus: torch.Tensor               # [] int32 the next root token


class StaticTree(NamedTuple):
    """A static tree's constants on the device, built once per engine."""
    spec: TreeSpec
    tree_indices: torch.Tensor
    retrieve: torch.Tensor
    mask: torch.Tensor
    depth: torch.Tensor
    children: torch.Tensor
    inlevel: torch.Tensor
    minus_one: torch.Tensor           # [1] int32, the pad slot's token
    one: torch.Tensor                 # [1] f32, the root's q


def static_tree(spec: TreeSpec, device) -> StaticTree:
    def t(a, dtype=torch.long):
        return torch.as_tensor(a).to(device=device, dtype=dtype)

    return StaticTree(spec=spec, tree_indices=t(spec.tree_indices),
                      retrieve=t(spec.retrieve_indices),
                      mask=t(spec.attn_mask, torch.bool),
                      depth=t(spec.depth, torch.int32),
                      children=t(spec.children), inlevel=t(spec.inlevel_rank),
                      minus_one=t([-1], torch.int32), one=t([1.0],
                                                            torch.float32))


def static_tree_block(ecfg: SpecDecodeConfig, tree: StaticTree,
                      state: SpecState) -> TreeBlock:
    """The static tree filled with the state's root token and draft."""
    d = state.draft
    cand_vec = torch.cat([state.root_token.reshape(1).to(torch.int32),
                          d.ss_token.reshape(-1)])
    tree_tokens = cand_vec[tree.tree_indices]                     # [N+1]
    candidates = _safe_gather_ext(torch.cat([tree_tokens, tree.minus_one]),
                                  tree.retrieve)
    node_q = level_probs = inlevel = None
    if ecfg.warp.active:
        node_q = torch.cat([tree.one, d.ss_prob.reshape(-1)])[
            tree.tree_indices]
        level_probs, inlevel = d.level_probs, tree.inlevel
    return TreeBlock(tokens=tree_tokens, candidates=candidates, node_q=node_q,
                     level_probs=level_probs, children=tree.children,
                     inlevel_rank=inlevel, mask=tree.mask, pos=tree.depth,
                     retrieve=tree.retrieve, max_depth=tree.spec.max_depth)


def verify_forward(ecfg: SpecDecodeConfig, cfg: ModelConfig, params: dict,
                   rope: tuple, base_kv: KVCache, tokens: torch.Tensor,
                   mask: torch.Tensor, pos: torch.Tensor,
                   prefix_valid: torch.Tensor, pos_offsets: torch.Tensor,
                   eff_len: torch.Tensor, extra_kv=None,
                   defer_block: bool = False):
    """The tree-verify forward of R requests at once: ``tokens`` [R, N+1]
    (one tree each), their CFG pairs on batch rows ``2r`` / ``2r + 1`` of
    ``base_kv``.  The trees' ancestor ``mask`` and node depths ``pos`` are
    shared ([N+1, N+1] and [N+1]: a static tree) or per request ([R, N+1,
    N+1] and [R, N+1]: dynamic trees of one node count, each repeated to
    its two rows); ``eff_len`` ([] or [2R]) is each row's committed length
    as this forward sees it, ``prefix_valid`` [2R, S] and ``pos_offsets``
    [2R] are per row.  The block is written provisionally at each row's
    length (or, with ``defer_block``, returned).  Returns ``(forward
    result, raw cfg-combined logits [R, N+1, V])``."""
    R, N1 = tokens.shape
    tok2 = tokens.repeat_interleave(2, dim=0)                     # [2R, N+1]
    if mask.ndim == 3:
        mask = mask.repeat_interleave(2, dim=0)                   # [2R, ...]
    pos = pos[None, :] if pos.ndim == 1 else pos.repeat_interleave(2, dim=0)
    positions = pos + eff_len.reshape(-1, 1)
    positions = torch.clamp(positions - pos_offsets[:, None], min=0)
    res = tfm.forward(
        params, cfg, tfm.token_embed(params, tok2), base_kv,
        positions=positions, rope=rope, block_mask=mask,
        prefix_valid=prefix_valid, commit=False, extra_kv=extra_kv,
        defer_block=defer_block)
    return res, cfg_combine(tfm.logits_head(params, res.hidden),
                            ecfg.cfg_scale)


def accept(ecfg: SpecDecodeConfig, ctx: _Ctx, blk: TreeBlock,
           logits_raw: torch.Tensor, eff_len: torch.Tensor) -> Verdict:
    """One request's acceptance of its verified tree: the token mask and
    the request's position constraints on its raw logits [N+1, V], then the
    greedy walk or the LANTERN rejection-sampling walk (coins and the bonus
    token drawn from ``ctx.generator``)."""
    N1 = blk.tokens.shape[0]
    D = blk.candidates.shape[1]
    dev = blk.tokens.device
    logits_all = _mask_logits(logits_raw, ctx.logits_mask)
    if ctx.logits_fn is not None:
        logits_all = ctx.logits_fn(logits_all, blk.pos + eff_len)
    if ecfg.warp.greedy:
        retrieve_safe = torch.clamp(blk.retrieve, min=0).long()
        path_logits = logits_all[retrieve_safe]                  # [P, D, V]
        best, alen, bonus_logits = acc.greedy_verify(
            path_logits, blk.candidates, ctx.nearest, ecfg.lantern,
            rt=ctx.lantern_rt)
        bonus = torch.argmax(bonus_logits).to(torch.int32)
        sel_slots = acc.take1(retrieve_safe, best)               # [D]
    else:
        pinned_u = (None if ecfg.pin is None else
                    torch.full((blk.max_depth, blk.children.shape[1]),
                               ecfg.pin, dtype=torch.float32, device=dev))
        walk_path, alen, dist = acc.stochastic_verify_tree(
            ctx.generator, logits_all, blk.tokens, blk.children,
            depth=blk.max_depth, warp=ecfg.warp, nearest=ctx.nearest,
            lantern=ecfg.lantern, node_q=blk.node_q,
            level_probs=blk.level_probs, node_level_row=blk.inlevel_rank,
            uniforms=pinned_u, rt=ctx.lantern_rt,
            batch_warp=ecfg.walk_batch_warp)
        if ecfg.pin is None:
            bonus = categorical(ctx.generator,
                                torch.log(torch.clamp(dist, min=1e-30)))
        else:
            bonus = torch.argmax(dist).to(torch.int32)
        sel_slots = torch.zeros((D,), dtype=torch.long, device=dev)
        sel_slots[: walk_path.shape[0]] = walk_path.long()
    # pads of the slot path are 0, but a gather asserts on the device where
    # the JAX one clamps: keep every data-dependent index in range
    return Verdict(sel_slots=torch.clamp(sel_slots, 0, N1 - 1), alen=alen,
                   n_acc=(alen + 1).to(torch.int32), bonus=bonus)


def advance(ecfg: SpecDecodeConfig, ctx: _Ctx, state: SpecState,
            blk: TreeBlock, v: Verdict, logits_raw: torch.Tensor,
            hidden: torch.Tensor):
    """Commit a verdict into one request's state: the accepted tokens into
    its stream (a fixed block of D at ``n_new``), the stop flag, the
    counters, and (with the EAGLE drafter) the drafter's extension over
    the accepted rows, whose base hidden states are ``hidden`` [2, N+1, H]
    (the request's rows of the verify forward).  The base cache is the
    caller's.  Returns ``(state', root_out)``: the next draft's root hidden
    [2, 1, H] or, with ``ecfg.stale_draft``, the raw cfg-combined logits row
    [V] at the last accepted node."""
    D = v.sel_slots.shape[0]
    dev = v.sel_slots.device
    sel_tokens = blk.tokens[v.sel_slots]
    ar_d = torch.arange(D, device=dev)
    cand_row = torch.where(ar_d < v.n_acc, sel_tokens,
                           torch.zeros_like(sel_tokens)).to(torch.int32)
    # fixed-size block write at n_new (the buffer is padded by D); the
    # start is clamped as lax.dynamic_update_slice clamps it, which only a
    # finished slot of the batched engine (frozen, or empty at 1 << 30)
    # reaches
    n0 = torch.clamp(state.n_new.long(), 0, state.tokens.shape[0] - D)
    tokens = state.tokens.index_copy(0, n0 + ar_d, cand_row)
    stopped = state.stopped
    if ctx.stops is not None:
        hit = ((cand_row[:, None] == ctx.stops[None, :]).any(-1)
               & (ar_d < v.n_acc))
        stopped = stopped | hit.any()
    draft_kv = state.draft_kv
    if ecfg.stale_draft:
        root_out = acc.take1(logits_raw, acc.take1(v.sel_slots, v.alen))
    else:
        # drafter extension over the accepted rows: (next token, base
        # hidden) pairs; the last valid pair carries the bonus token
        next_tok = torch.where(
            ar_d < v.alen, sel_tokens[torch.clamp(ar_d + 1, max=D - 1)],
            v.bonus).to(torch.int32)
        out_hidden, draft_kv = drf.extend(
            ctx.dparams, ctx.dcfg, ctx.drope, draft_kv,
            next_tok[None, :].expand(2, D),
            hidden.index_select(1, v.sel_slots), v.n_acc,
            prefix_valid=ctx.drafter_pv, pos_offsets=ctx.pos_offsets)
        root_out = out_hidden.index_select(
            1, torch.clamp(v.alen, 0, D - 1).long().reshape(1))
    return state._replace(
        draft_kv=draft_kv, root_token=v.bonus, tokens=tokens,
        n_new=state.n_new + v.n_acc, steps=state.steps + 1,
        accept_sum=state.accept_sum + v.n_acc, stopped=stopped), root_out


def next_static_draft(ecfg: SpecDecodeConfig, spec: TreeSpec, ctx: _Ctx,
                      state: SpecState, root_out: torch.Tensor,
                      committed: torch.Tensor) -> SpecState:
    """The next static draft from ``advance``'s ``root_out``: stale
    drafting from the logits row (``committed`` [] is the request's
    committed base length, the grid constraints' position base), or the
    drafter's levels."""
    if ecfg.stale_draft:
        return state._replace(draft=drf.draft_stale(
            spec, root_out, committed, ecfg.dwarp, ctx.generator,
            logits_mask=ctx.logits_mask, logits_fn=ctx.logits_fn,
            pin=ecfg.pin))
    new_draft, dkv = _draft_static(ecfg, spec, ctx, state.draft_kv, root_out)
    return state._replace(draft=new_draft, draft_kv=dkv)


def _verify_and_update(ecfg: SpecDecodeConfig, cfg: ModelConfig, ctx: _Ctx,
                       state: SpecState, blk: TreeBlock):
    """One request's verify forward, acceptance and commit: the base cache
    by rollback (``accept_path``: kernel K4) or, with ``deferred_commit``,
    by carrying the block to the next forward.  Returns ``(state',
    root_out)`` as ``advance`` does."""
    N1 = blk.tokens.shape[0]
    deferred = ecfg.deferred_commit
    # committed length as seen by this forward: with deferred commit the
    # previous step's accepted rows ride in as extra_kv and are committed
    # by this call
    eff_len = state.base_kv.length + (state.pn if deferred else 0)
    ex = None
    if deferred:
        # rows past pn land above the committed frontier and are
        # overwritten by the next commit before any read
        sel_prev = torch.clamp(state.psel, 0, N1 - 1).long()
        ex = (state.blk[0][:, :, sel_prev], state.blk[1][:, :, sel_prev],
              state.pn)
    res, logits_raw = verify_forward(
        ecfg, cfg, ctx.params, ctx.rope, state.base_kv, blk.tokens[None],
        blk.mask, blk.pos, ctx.prefix_valid, ctx.pos_offsets, eff_len,
        extra_kv=ex, defer_block=deferred)
    v = accept(ecfg, ctx, blk, logits_raw[0], eff_len)
    if deferred:
        base_kv = res.kv             # the previous accepted rows, committed
    else:
        # rollback: compact the accepted rows of the provisional tree block
        base_kv = res.kv.accept_path(v.sel_slots, v.n_acc, block_size=N1)
    state, root_out = advance(ecfg, ctx, state, blk, v, logits_raw[0],
                              res.hidden)
    state = state._replace(base_kv=base_kv)
    if deferred:
        state = state._replace(blk=res.block,
                               psel=v.sel_slots.to(torch.int32), pn=v.n_acc)
    return state, root_out


def make_static_step(ecfg: SpecDecodeConfig, cfg: ModelConfig,
                     spec: TreeSpec, ctx: _Ctx):
    """One EAGLE-1 static-tree speculative step."""
    tree = static_tree(spec, ctx.prefix_valid.device)

    def step(state: SpecState) -> SpecState:
        state, root_out = _verify_and_update(
            ecfg, cfg, ctx, state, static_tree_block(ecfg, tree, state))
        committed = state.base_kv.length + (
            state.pn if ecfg.deferred_commit else 0)
        return next_static_draft(ecfg, spec, ctx, state, root_out, committed)

    return step


def _draft_static(ecfg: SpecDecodeConfig, spec: TreeSpec, ctx: _Ctx,
                  draft_kv: KVCache, root_hidden: torch.Tensor):
    return drf.draft_static(
        ctx.dparams, ctx.dcfg, spec, ctx.drope, draft_kv, root_hidden,
        head_of(ctx.params), ecfg.cfg_scale, ecfg.dwarp, ctx.generator,
        pos_offsets=ctx.pos_offsets, logits_mask=ctx.logits_mask,
        logits_fn=ctx.logits_fn, prefix_valid=ctx.drafter_pv, pin=ecfg.pin,
        levels=ctx.levels)


def dynamic_tree_block(dcfg: DrafterConfig, state: SpecState) -> TreeBlock:
    """The tree a dynamic draft carries (tokens, ancestor mask, depths,
    root paths, children)."""
    d: drf.DynamicDraft = state.draft
    minus_one = torch.full((1,), -1, dtype=torch.int32,
                           device=d.draft_tokens.device)
    candidates = _safe_gather_ext(torch.cat([d.draft_tokens, minus_one]),
                                  d.retrieve_indices)
    return TreeBlock(tokens=d.draft_tokens, candidates=candidates,
                     node_q=None, level_probs=None, children=d.children,
                     inlevel_rank=None, mask=d.tree_mask,
                     pos=d.tree_position_ids, retrieve=d.retrieve_indices,
                     max_depth=dcfg.depth + 1)


def next_dynamic_draft(ecfg: SpecDecodeConfig, ctx: _Ctx, state: SpecState,
                       root_hidden: torch.Tensor) -> SpecState:
    """The next dynamic draft from ``advance``'s root hidden."""
    new_draft, dkv = _draft_dynamic(ecfg, ctx, state.draft_kv, root_hidden,
                                    state.root_token)
    return state._replace(draft=new_draft, draft_kv=dkv)


def make_dynamic_step(ecfg: SpecDecodeConfig, cfg: ModelConfig, ctx: _Ctx):
    """One EAGLE-2 dynamic-tree speculative step: the draft carries its own
    tree."""
    def step(state: SpecState) -> SpecState:
        state, root_hidden = _verify_and_update(
            ecfg, cfg, ctx, state, dynamic_tree_block(ctx.dcfg, state))
        return next_dynamic_draft(ecfg, ctx, state, root_hidden)

    return step


def _draft_dynamic(ecfg: SpecDecodeConfig, ctx: _Ctx, draft_kv: KVCache,
                   root_hidden: torch.Tensor, root_token: torch.Tensor):
    return drf.draft_dynamic(
        ctx.dparams, ctx.dcfg, ctx.drope, draft_kv, root_hidden, root_token,
        head_of(ctx.params), ecfg.cfg_scale, ecfg.dwarp,
        pos_offsets=ctx.pos_offsets, logits_mask=ctx.logits_mask,
        logits_fn=ctx.logits_fn, prefix_valid=ctx.drafter_pv)


def _check_request(ecfg: SpecDecodeConfig, token_prompt, cond, uncond,
                   prefix_valid, dparams, dcfg) -> None:
    """The JAX engine's rejections, and the port's own checks of a call."""
    if ecfg.mode not in ("static", "dynamic"):
        raise ValueError(f"mode must be 'static' or 'dynamic', got "
                         f"{ecfg.mode!r}")
    if ecfg.stale_draft and ecfg.mode != "static":
        raise ValueError("stale_draft requires mode='static'")
    if ecfg.deferred_commit and ecfg.mode != "static":
        raise ValueError("deferred_commit requires mode='static'")
    if not ecfg.stale_draft and (dparams is None or dcfg is None):
        raise ValueError("the EAGLE drafter (stale_draft=False, and dynamic "
                         "mode) needs its weights: pass dparams and dcfg")
    embedding = cond is not None or uncond is not None
    if (token_prompt is not None) == embedding or (
            embedding and (cond is None or uncond is None)):
        raise ValueError("pass exactly one conditioning: token_prompt, or "
                         "cond and uncond")
    if token_prompt is not None and prefix_valid is not None:
        raise ValueError("pass padding via token_prompt.valid, not "
                         "prefix_valid, for token-prompt requests")


def prefill_request(params: dict, ecfg: SpecDecodeConfig, cfg: ModelConfig,
                    spec: Optional[TreeSpec],
                    token_prompt: Optional[TokenPrompt] = None,
                    generator: Optional[torch.Generator] = None,
                    logits_mask: Optional[torch.Tensor] = None,
                    logits_fn=None, device=None,
                    dparams: Optional[dict] = None,
                    dcfg: Optional[DrafterConfig] = None,
                    cond: Optional[torch.Tensor] = None,
                    uncond: Optional[torch.Tensor] = None,
                    prefix_valid: Optional[torch.Tensor] = None):
    """Prefill one request: base (and drafter) prefix, first token, first
    draft tree.  Returns ``(SpecState, ctx)``.

    Conditioning: a token prompt (``token_prompt``), or an embedding prefix
    (``cond``/``uncond``: label ids [1] or caption features [1, Tc, Dc],
    with ``prefix_valid`` [2, <= S] False on caption pads).  ``dparams`` and
    ``dcfg`` are the EAGLE drafter, needed unless ``ecfg.stale_draft``;
    ``spec`` is the static tree (unused in dynamic mode)."""
    _check_request(ecfg, token_prompt, cond, uncond, prefix_valid, dparams,
                   dcfg)
    dev = resolve_device(device)
    rope = tfm.make_rope_tables(cfg, dev)
    nearest = params.get("nearest_latents")
    if ecfg.lantern.enabled and nearest is None:
        raise ValueError("lantern enabled but params lack 'nearest_latents'")
    base_kv = KVCache.create(cfg, 2, quantized=ecfg.kv_quant, device=dev,
                             groups=tfm.cache_groups(cfg, params))
    S = base_kv.max_len
    pv = torch.ones((2, S), dtype=torch.bool, device=dev)
    zero2 = torch.zeros((2,), dtype=torch.int32, device=dev)
    if token_prompt is not None:
        tp = token_prompt.to(dev)
        L = tp.tokens.shape[1]
        pv[:, :L] = tp.valid.bool()
        offs = torch.stack([zero2[0], tp.pos_diff.to(torch.int32)])
        ctx = _Ctx(params=params, rope=rope, nearest=nearest, prefix_valid=pv,
                   pos_offsets=offs, logits_mask=logits_mask,
                   logits_fn=bind_logits_fn(logits_fn, offs),
                   generator=generator, drafter_pv=pv)
        block = (torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=dev))[None]
                 & tp.valid.bool()[:, None, :])
        res = tfm.forward(params, cfg, tfm.token_embed(params, tp.tokens),
                          base_kv, tp.positions, rope, block_mask=block)
    else:
        # an embedding prefix: its pad mask masks the prefill block itself
        # as well as every later read of the cached prefix
        L = cfg.cls_token_num
        if prefix_valid is not None:
            pv[:, :prefix_valid.shape[-1]] = prefix_valid.to(dev).bool()
        ctx = _Ctx(params=params, rope=rope, nearest=nearest, prefix_valid=pv,
                   pos_offsets=zero2, logits_mask=logits_mask,
                   logits_fn=logits_fn, generator=generator)
        embeds = tfm.cond_embed(params, cfg,
                                torch.cat([cond, uncond], dim=0).to(dev))
        block = (torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=dev))[None] & pv[:, None, :L])
        res = tfm.forward(params, cfg, embeds, base_kv,
                          torch.arange(L, device=dev), rope, block_mask=block)
    if not ecfg.stale_draft:
        ctx = ctx._replace(dparams=dparams, dcfg=dcfg,
                           drope=tfm.make_rope_tables(dcfg.model, dev))
        if ecfg.mode == "static":
            ctx = ctx._replace(levels=drf.device_levels(spec, dev))
    if ecfg.stop_ids:
        ctx = ctx._replace(stops=torch.tensor(ecfg.stop_ids,
                                              dtype=torch.int32, device=dev))
    base_kv = res.kv
    logits0 = cfg_combine(tfm.logits_head(params, res.hidden[:, -1:]),
                          ecfg.cfg_scale)
    first = _mask_logits(logits0[0, -1], logits_mask)
    if token_prompt is not None and ctx.logits_fn is not None:
        first = ctx.logits_fn(first[None, :], torch.full(
            (1,), L - 1, dtype=torch.int32, device=dev))[0]
    t0 = (torch.argmax(first) if ecfg.pin is not None
          else sample_token(generator, first, ecfg.warp)).to(torch.int32)
    draft_kv = None
    if ecfg.stale_draft:
        draft = drf.draft_stale(spec, logits0[0, -1], base_kv.length,
                                ecfg.dwarp, generator, logits_mask=logits_mask,
                                logits_fn=ctx.logits_fn, pin=ecfg.pin)
    else:
        # drafter prefill: the base rows' next tokens (the prompt shifted
        # left one, or for an embedding prefix Tc - 1 zeros; the first
        # generated token closes the stream) with the base hiddens aligned
        dk = KVCache.create(dcfg.model, 2, device=dev)
        t0_2 = t0.reshape(1, 1).expand(2, 1)
        if token_prompt is not None:
            dtok = torch.cat([tp.tokens[:, 1:], t0_2.to(tp.tokens.dtype)],
                             dim=1)
            dpos = torch.clamp(torch.arange(L, device=dev)[None, :]
                               - ctx.pos_offsets[:, None], min=0)
            out_hidden, dk = drf.extend(
                dparams, dcfg, ctx.drope, dk, dtok, res.hidden, L,
                prefix_valid=pv, positions=dpos, block_valid=tp.valid)
        else:
            dtok = torch.cat([torch.zeros((2, L - 1), dtype=torch.int32,
                                          device=dev), t0_2], dim=1)
            out_hidden, dk = drf.extend(dparams, dcfg, ctx.drope, dk, dtok,
                                        res.hidden, L)
        if ecfg.mode == "static":
            draft, draft_kv = _draft_static(ecfg, spec, ctx, dk,
                                            out_hidden[:, -1:])
        else:
            draft, draft_kv = _draft_dynamic(ecfg, ctx, dk,
                                             out_hidden[:, -1:], t0)

    def zero(dtype=torch.int32):
        return torch.zeros((), dtype=dtype, device=dev)

    # the committed stream is written in fixed blocks of a path's length at
    # n_new: pad the buffer by one block
    pad = (spec.path_len if ecfg.mode == "static" else dcfg.depth + 2) + 1
    state = SpecState(
        base_kv=base_kv, draft_kv=draft_kv, draft=draft, root_token=t0,
        tokens=torch.zeros((ecfg.max_new + pad,), dtype=torch.int32,
                           device=dev),
        n_new=zero(), steps=zero(), accept_sum=zero(),
        stopped=zero(torch.bool))
    if ecfg.deferred_commit:
        N1 = int(spec.tree_indices.shape[0])
        D = int(spec.retrieve_indices.shape[1])
        # this rank's KV heads under a tp mesh
        zblk = torch.zeros(
            (cfg.num_layers, 2, N1, tfm.head_counts(cfg, params["layers"])[1],
             cfg.head_dim), dtype=cfg.torch_dtype, device=dev)
        state = state._replace(
            blk=(zblk, zblk),
            psel=torch.zeros((D,), dtype=torch.int32, device=dev), pn=zero())
    return state, ctx


def request_generator(seed: int, device=None) -> torch.Generator:
    """A request's random stream: a ``torch.Generator`` on ``device`` seeded
    with ``seed``.  ``generate`` draws from the generator its caller
    passes; the batched engine's scheduler gives every request this one, so
    that under sampling a request's tokens are the same batched as alone."""
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)


@torch.no_grad()
def generate(params: dict, ecfg: SpecDecodeConfig, cfg: ModelConfig,
             spec: Optional[TreeSpec],
             token_prompt: Optional[TokenPrompt] = None,
             generator: Optional[torch.Generator] = None, max_steps: int = 0,
             logits_mask: Optional[torch.Tensor] = None, logits_fn=None,
             device=None, dparams: Optional[dict] = None,
             dcfg: Optional[DrafterConfig] = None,
             cond: Optional[torch.Tensor] = None,
             uncond: Optional[torch.Tensor] = None,
             prefix_valid: Optional[torch.Tensor] = None,
             lantern_rt: Optional[acc.LanternRT] = None) -> SpecResult:
    """Full speculative generation for one request (CFG cond/uncond as the
    batch pair), conditioned on a token prompt or on an embedding prefix
    (see ``prefill_request``).  ``dparams``/``dcfg``: the EAGLE drafter,
    needed unless ``ecfg.stale_draft``; ``spec``: the static tree, unused
    in dynamic mode.  ``lantern_rt`` (``acc.LanternSpec.runtime``, device
    tensors) overrides the static operating point without a host read;
    ``ecfg.lantern.k`` still bounds the neighbor-table width."""
    max_steps = max_steps or ecfg.max_new
    state, ctx = prefill_request(params, ecfg, cfg, spec, token_prompt,
                                 generator, logits_mask=logits_mask,
                                 logits_fn=logits_fn, device=device,
                                 dparams=dparams, dcfg=dcfg, cond=cond,
                                 uncond=uncond, prefix_valid=prefix_valid)
    ctx = ctx._replace(lantern_rt=lantern_rt)
    step = (make_static_step(ecfg, cfg, spec, ctx) if ecfg.mode == "static"
            else make_dynamic_step(ecfg, cfg, ctx))
    n_new = steps = 0
    stopped = False
    while n_new < ecfg.max_new and steps < max_steps and not stopped:
        state = step(state)
        n_new, steps, stopped = torch.stack(
            [state.n_new, state.steps, state.stopped.int()]).tolist()
    toks = state.tokens[: ecfg.max_new]
    n_valid = min(n_new, ecfg.max_new)
    if ecfg.stop_ids:
        stops = torch.tensor(ecfg.stop_ids, dtype=torch.int32,
                             device=toks.device)
        hit = ((toks[:, None] == stops[None, :]).any(-1)
               & (torch.arange(ecfg.max_new, device=toks.device) < n_valid))
        if bool(hit.any()):
            n_valid = int(torch.argmax(hit.to(torch.int32))) + 1
    return SpecResult(tokens=toks, steps=steps,
                      accept_sum=int(state.accept_sum), n_valid=n_valid)
