"""Speculative decode engine, static EAGLE-1 mode with stale-distribution
drafting and deferred KV commit.

Counterpart of ``lantern_tpu/engine/spec.py`` for the Lumina lane:
draft (``drafter.draft_stale``, no drafter forwards) -> one tree-verify
forward -> acceptance (greedy or LANTERN rejection-sampling walk) -> commit.
With deferred commit the tree block's K/V never hit the cache: the state
carries them and the NEXT verify forward commits only the accepted rows
(``forward(extra_kv=...)``), so no rollback kernel runs.

A plain Python loop replaces ``lax.while_loop``; its condition reads three
scalars back per step.  Everything else stays on the device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..configs import ModelConfig
from ..device import resolve_device
from ..kv import KVCache
from ..models import drafter as drf
from ..models import transformer as tfm
from ..models.chameleon import TokenPrompt
from ..ops import acceptance as acc
from ..ops.sampling import LogitsWarp, categorical, cfg_combine, sample_token
from ..trees import TreeSpec

__all__ = ["SpecDecodeConfig", "SpecState", "SpecResult", "TokenPrompt",
           "make_static_step", "prefill_request", "generate"]

_NOT_PORTED = ("not ported yet: only static mode with stale_draft=True and "
               "deferred_commit=True runs in lantern_tpu_torch; see ROADMAP "
               "queue 1, item {item}")


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """Static engine config (see the JAX counterpart for each field)."""

    warp: LogitsWarp = LogitsWarp()
    cfg_scale: float = 4.0
    lantern: acc.LanternSpec = acc.LanternSpec()
    max_new: int = 256
    mode: str = "static"
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

    def check_ported(self) -> None:
        if self.mode != "static":
            raise NotImplementedError(_NOT_PORTED.format(item=13))
        if not self.stale_draft:
            raise NotImplementedError(_NOT_PORTED.format(item=10))
        if not self.deferred_commit:
            raise NotImplementedError(_NOT_PORTED.format(item=12))


class SpecState(NamedTuple):
    base_kv: KVCache
    draft: drf.StaticDraft
    root_token: torch.Tensor        # [] sampled-but-unverified next token
    tokens: torch.Tensor            # [max_new + pad] committed ids
    n_new: torch.Tensor             # [] committed count
    steps: torch.Tensor             # [] verify steps taken
    accept_sum: torch.Tensor        # [] total accepted tokens (incl. roots)
    stopped: torch.Tensor           # [] a stop id was committed
    # deferred-commit carry.  INVARIANT: between steps base_kv lags the
    # committed token stream by ``pn`` rows; they live in blk[psel[:pn]]
    # and the NEXT verify forward commits them.
    blk: tuple                      # (k, v) [L, B, N+1, n_kv, hd]
    psel: torch.Tensor              # [D] accepted slots into blk
    pn: torch.Tensor                # [] accepted count (rows to commit)


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
    pos_offsets: torch.Tensor           # [2] per-branch position shift
    logits_mask: Optional[torch.Tensor]
    logits_fn: object
    generator: Optional[torch.Generator]


def bind_logits_fn(logits_fn, pos_offsets):
    """Bind the request's grid-start index (``pos_offsets[1]``) into a
    Lumina grid FSM."""
    if logits_fn is None or not hasattr(logits_fn, "image_start_idx"):
        return logits_fn

    def bound(logits, positions):
        return logits_fn(logits, positions, start=pos_offsets[1])
    return bound


def _mask_logits(logits, mask):
    if mask is None:
        return logits
    return torch.where(mask, torch.finfo(torch.float32).min, logits)


def _verify_and_update(ecfg: SpecDecodeConfig, cfg: ModelConfig, ctx: _Ctx,
                       state: SpecState, candidates, node_q, level_probs,
                       children, inlevel_rank, tree_tokens, tree_mask,
                       tree_pos, retrieve, max_depth: int):
    """Tree-verify forward, acceptance and commit.  Returns
    ``(state', root_logits)``: the raw cfg-combined logits row at the last
    accepted node, from which the next stale draft proposes."""
    N1 = tree_tokens.shape[0]
    D = candidates.shape[1]
    dev = tree_tokens.device
    tok2 = tree_tokens[None, :].expand(2, N1)
    # committed length as seen by this forward: the previous step's
    # accepted rows ride in as extra_kv and are committed by this call
    eff_len = state.base_kv.length + state.pn
    positions = tree_pos + eff_len
    positions = torch.clamp(positions[None, :] - ctx.pos_offsets[:, None],
                            min=0)
    # rows past pn land above the committed frontier and are overwritten
    # by the next commit before any read
    sel_prev = torch.clamp(state.psel, 0, N1 - 1).long()
    ex = (state.blk[0][:, :, sel_prev], state.blk[1][:, :, sel_prev],
          state.pn)
    res = tfm.forward(
        ctx.params, cfg, tfm.token_embed(ctx.params, tok2), state.base_kv,
        positions=positions, rope=ctx.rope, block_mask=tree_mask,
        prefix_valid=ctx.prefix_valid, commit=False, extra_kv=ex,
        defer_block=True)
    logits_raw = cfg_combine(tfm.logits_head(ctx.params, res.hidden),
                             ecfg.cfg_scale)[0]
    logits_all = _mask_logits(logits_raw, ctx.logits_mask)
    if ctx.logits_fn is not None:
        logits_all = ctx.logits_fn(logits_all, tree_pos + eff_len)

    if ecfg.warp.greedy:
        retrieve_safe = torch.clamp(retrieve, min=0).long()
        path_logits = logits_all[retrieve_safe]                  # [P, D, V]
        best, alen, bonus_logits = acc.greedy_verify(
            path_logits, candidates, ctx.nearest, ecfg.lantern)
        bonus = torch.argmax(bonus_logits).to(torch.int32)
        sel_slots = acc.take1(retrieve_safe, best)               # [D]
    else:
        pinned_u = (None if ecfg.pin is None else
                    torch.full((max_depth, children.shape[1]), ecfg.pin,
                               dtype=torch.float32, device=dev))
        walk_path, alen, dist = acc.stochastic_verify_tree(
            ctx.generator, logits_all, tree_tokens, children,
            depth=max_depth, warp=ecfg.warp, nearest=ctx.nearest,
            lantern=ecfg.lantern, node_q=node_q, level_probs=level_probs,
            node_level_row=inlevel_rank, uniforms=pinned_u,
            batch_warp=ecfg.walk_batch_warp)
        if ecfg.pin is None:
            bonus = categorical(ctx.generator,
                                torch.log(torch.clamp(dist, min=1e-30)))
        else:
            bonus = torch.argmax(dist).to(torch.int32)
        sel_slots = torch.zeros((D,), dtype=torch.long, device=dev)
        sel_slots[: walk_path.shape[0]] = walk_path.long()

    n_acc = (alen + 1).to(torch.int32)
    sel_tokens = tree_tokens[sel_slots]
    ar_d = torch.arange(D, device=dev)
    cand_row = torch.where(ar_d < n_acc, sel_tokens,
                           torch.zeros_like(sel_tokens)).to(torch.int32)
    # fixed-size block write at n_new (the buffer is padded by D)
    idx = state.n_new.long() + ar_d
    tokens = state.tokens.index_copy(0, idx, cand_row)
    stopped = state.stopped
    if ecfg.stop_ids:
        stops = torch.tensor(ecfg.stop_ids, dtype=torch.int32, device=dev)
        hit = (cand_row[:, None] == stops[None, :]).any(-1) & (ar_d < n_acc)
        stopped = stopped | hit.any()
    root_logits = acc.take1(logits_raw, acc.take1(sel_slots, alen))
    state = state._replace(
        base_kv=res.kv, root_token=bonus, tokens=tokens,
        n_new=state.n_new + n_acc, steps=state.steps + 1,
        accept_sum=state.accept_sum + n_acc, stopped=stopped,
        blk=res.block, psel=sel_slots.to(torch.int32), pn=n_acc)
    return state, root_logits


def make_static_step(ecfg: SpecDecodeConfig, cfg: ModelConfig,
                     spec: TreeSpec, ctx: _Ctx):
    """One EAGLE-1 static-tree speculative step (stale drafting)."""
    dev = ctx.prefix_valid.device

    def t(a, dtype=torch.long):
        return torch.as_tensor(a).to(device=dev, dtype=dtype)

    tree_indices = t(spec.tree_indices)
    retrieve = t(spec.retrieve_indices)
    attn_mask = t(spec.attn_mask, torch.bool)
    depth_arr = t(spec.depth, torch.int32)
    children = t(spec.children)
    inlevel = t(spec.inlevel_rank)
    sampling = ecfg.warp.active
    minus_one = torch.full((1,), -1, dtype=torch.int32, device=dev)
    ones = torch.ones((1,), dtype=torch.float32, device=dev)

    def step(state: SpecState) -> SpecState:
        d = state.draft
        cand_vec = torch.cat([state.root_token.reshape(1).to(torch.int32),
                              d.ss_token.reshape(-1)])
        tree_tokens = cand_vec[tree_indices]                     # [N+1]
        ext = torch.cat([tree_tokens, minus_one])
        candidates = ext[torch.where(retrieve < 0, ext.shape[0] - 1, retrieve)]
        if sampling:
            node_q = torch.cat([ones, d.ss_prob.reshape(-1)])[tree_indices]
            level_probs = d.level_probs
        else:
            node_q, level_probs = None, None
        state, root_logits = _verify_and_update(
            ecfg, cfg, ctx, state, candidates, node_q, level_probs,
            children, inlevel if sampling else None, tree_tokens, attn_mask,
            depth_arr, retrieve, spec.max_depth)
        committed = state.base_kv.length + state.pn
        new_draft = drf.draft_stale(
            spec, root_logits, committed, ecfg.dwarp, ctx.generator,
            logits_mask=ctx.logits_mask, logits_fn=ctx.logits_fn,
            pin=ecfg.pin)
        return state._replace(draft=new_draft)

    return step


def prefill_request(params: dict, ecfg: SpecDecodeConfig, cfg: ModelConfig,
                    spec: TreeSpec, token_prompt: TokenPrompt,
                    generator: Optional[torch.Generator],
                    logits_mask: Optional[torch.Tensor] = None,
                    logits_fn=None, device=None):
    """Prefill one token-prompt request: base prefix, first token, first
    draft tree.  Returns ``(SpecState, ctx)``."""
    ecfg.check_ported()
    dev = resolve_device(device)
    rope = tfm.make_rope_tables(cfg, dev)
    nearest = params.get("nearest_latents")
    if ecfg.lantern.enabled and nearest is None:
        raise ValueError("lantern enabled but params lack 'nearest_latents'")
    base_kv = KVCache.create(cfg, 2, quantized=ecfg.kv_quant, device=dev)
    S = base_kv.max_len
    tp = token_prompt.to(dev)
    L = tp.tokens.shape[1]
    pv = torch.ones((2, S), dtype=torch.bool, device=dev)
    pv[:, :L] = tp.valid.bool()
    offs = torch.stack([torch.zeros((), dtype=torch.int32, device=dev),
                        tp.pos_diff.to(torch.int32)])
    ctx = _Ctx(params=params, rope=rope, nearest=nearest, prefix_valid=pv,
               pos_offsets=offs, logits_mask=logits_mask,
               logits_fn=bind_logits_fn(logits_fn, offs), generator=generator)
    block = (torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None]
             & tp.valid.bool()[:, None, :])
    res = tfm.forward(params, cfg, tfm.token_embed(params, tp.tokens),
                      base_kv, tp.positions, rope, block_mask=block)
    base_kv = res.kv
    logits0 = cfg_combine(tfm.logits_head(params, res.hidden[:, -1:]),
                          ecfg.cfg_scale)
    first = _mask_logits(logits0[0, -1], logits_mask)
    if ctx.logits_fn is not None:
        first = ctx.logits_fn(first[None, :], torch.full(
            (1,), L - 1, dtype=torch.int32, device=dev))[0]
    t0 = (torch.argmax(first) if ecfg.pin is not None
          else sample_token(generator, first, ecfg.warp)).to(torch.int32)
    draft = drf.draft_stale(spec, logits0[0, -1], base_kv.length, ecfg.dwarp,
                            generator, logits_mask=logits_mask,
                            logits_fn=ctx.logits_fn, pin=ecfg.pin)
    N1 = int(spec.tree_indices.shape[0])
    D = int(spec.retrieve_indices.shape[1])
    zblk = torch.zeros((cfg.num_layers, 2, N1, cfg.num_kv_heads, cfg.head_dim),
                       dtype=cfg.torch_dtype, device=dev)

    def zero(dtype=torch.int32):
        return torch.zeros((), dtype=dtype, device=dev)

    state = SpecState(
        base_kv=base_kv, draft=draft, root_token=t0,
        tokens=torch.zeros((ecfg.max_new + spec.path_len + 1,),
                           dtype=torch.int32, device=dev),
        n_new=zero(), steps=zero(), accept_sum=zero(),
        stopped=zero(torch.bool), blk=(zblk, zblk),
        psel=torch.zeros((D,), dtype=torch.int32, device=dev), pn=zero())
    return state, ctx


def generate(params: dict, ecfg: SpecDecodeConfig, cfg: ModelConfig,
             spec: TreeSpec, token_prompt: TokenPrompt,
             generator: Optional[torch.Generator], max_steps: int = 0,
             logits_mask: Optional[torch.Tensor] = None, logits_fn=None,
             device=None) -> SpecResult:
    """Full speculative generation for one token-prompt request (CFG
    cond/uncond as the batch pair)."""
    max_steps = max_steps or ecfg.max_new
    state, ctx = prefill_request(params, ecfg, cfg, spec, token_prompt,
                                 generator, logits_mask=logits_mask,
                                 logits_fn=logits_fn, device=device)
    step = make_static_step(ecfg, cfg, spec, ctx)
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
