"""Vanilla CFG autoregressive decode loops — the 1.0x baseline the
speculative engine is measured against.

Counterpart of ``lantern_tpu/engine/ar.py``: ``generate`` prefills a
LlamaGen conditioning prefix (class label or caption features, with the
caption's pad mask) as the cond/uncond batch pair; ``generate_tokens``
prefills a Chameleon token prompt whose cond/uncond rows carry their own
position ids.  Every step samples ONE token from the CFG-combined logits
and feeds it to both rows.  A plain Python loop replaces ``lax.fori_loop``;
the only host read per step is the stop check when ``stop_ids`` is set.

``generate_many`` and ``generate_tokens_many`` are lockstep batched AR (the
JAX package vmaps the lone loop): R requests of one prompt length share
every forward over 2R rows (request r's cond and uncond rows at ``2r`` and
``2r + 1``), so K1 reads each weight once for all of them, K2 takes a
length per row and K3 a start per row, as in the batched engine.  Each
request samples from its own generator in a lone run's order, so its
tokens equal a lone ``generate`` / ``generate_tokens`` with that
generator.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from ..configs import ModelConfig
from ..device import resolve_device
from ..kv import KVCache
from ..models import transformer as tfm
from ..models.chameleon import TokenPrompt
from ..ops.sampling import LogitsWarp, cfg_combine, sample_token
from ..utils.profiling import count, span


class ARResult(NamedTuple):
    tokens: torch.Tensor     # [max_new] generated ids
    kv: KVCache
    # committed length: max_new, or with stop_ids the index one past the
    # first stop id; -1 means "no stop tracking requested"
    n_valid: int = -1


@torch.no_grad()
def generate(
    params: dict,
    cfg: ModelConfig,
    cond: torch.Tensor,            # label ids [1] or caption feats [1, Tc, Dc]
    uncond: torch.Tensor,          # the uncond counterpart (same shape)
    max_new: int,
    cfg_scale: float,
    warp: LogitsWarp,
    generator: Optional[torch.Generator],
    rope=None,
    prefix_valid: Optional[torch.Tensor] = None,   # [2, <= S] caption pads
    kv_quant: bool = False,
    device=None,
) -> ARResult:
    """LlamaGen base-mode CFG AR loop over an embedding prefix.
    ``prefix_valid`` (bool, False on the caption's left pads) masks the pad
    rows in the prefill block itself and in every later read."""
    dev = resolve_device(device)
    if rope is None:
        rope = tfm.make_rope_tables(cfg, dev)
    Tc = cfg.cls_token_num
    embeds = tfm.cond_embed(params, cfg,
                            torch.cat([cond, uncond], dim=0).to(dev))
    kv = KVCache.create(cfg, 2, quantized=kv_quant, device=dev,
                        groups=tfm.cache_groups(cfg, params))
    block = None
    if prefix_valid is not None:
        pv = torch.ones((2, kv.max_len), dtype=torch.bool, device=dev)
        pv[:, :prefix_valid.shape[-1]] = prefix_valid.to(dev).bool()
        prefix_valid = pv
        block = (torch.tril(torch.ones((Tc, Tc), dtype=torch.bool,
                                       device=dev))[None]
                 & pv[:, None, :Tc])
    res = tfm.forward(params, cfg, embeds, kv,
                      torch.arange(Tc, device=dev), rope, block_mask=block)
    kv = res.kv
    logits = tfm.logits_head(params, res.hidden[:, -1])           # [2, V]
    tok = sample_token(generator, cfg_combine(logits, cfg_scale), warp)
    out = torch.zeros((max_new,), dtype=torch.int32, device=dev)
    for i in range(max_new):
        out[i] = tok[0]
        emb = tfm.token_embed(params, tok[:, None].expand(2, 1))
        res = tfm.forward(params, cfg, emb, kv,
                          torch.full((1,), Tc + i, device=dev), rope,
                          prefix_valid=prefix_valid)
        kv = res.kv
        logits = tfm.logits_head(params, res.hidden[:, -1])
        tok = sample_token(generator, cfg_combine(logits, cfg_scale), warp)
    return ARResult(tokens=out, kv=kv)


@torch.no_grad()
def generate_tokens(
    params: dict,
    cfg: ModelConfig,
    token_prompt: TokenPrompt,
    max_new: int,
    cfg_scale: float,
    warp: LogitsWarp,
    generator: Optional[torch.Generator],
    logits_mask: Optional[torch.Tensor] = None,
    logits_fn=None,
    rope=None,
    kv_quant: bool = False,
    stop_ids: tuple = (),
    device=None,
) -> ARResult:
    """Chameleon-family base-mode CFG AR loop.  ``logits_mask`` (bool [V])
    suppresses tokens; ``logits_fn(logits [T, V], cond_positions)`` applies
    the Lumina grid FSM; ``stop_ids`` ends the loop after committing one."""
    dev = resolve_device(device)
    if rope is None:
        rope = tfm.make_rope_tables(cfg, dev)
    tp = token_prompt.to(dev)
    L = tp.tokens.shape[1]

    def warp_rows(logits, cond_pos):              # [2, 1, V], [1] -> [1, V]
        logits = cfg_combine(logits, cfg_scale)[0]
        if logits_mask is not None:
            logits = torch.where(logits_mask, torch.finfo(torch.float32).min,
                                 logits)
        if logits_fn is not None:
            logits = logits_fn(logits, cond_pos)
        return logits

    kv = KVCache.create(cfg, 2, quantized=kv_quant, device=dev,
                        groups=tfm.cache_groups(cfg, params))
    valid = tp.valid.bool()
    block = (torch.tril(torch.ones((L, L), dtype=torch.bool, device=dev))[None]
             & valid[:, None, :])
    res = tfm.forward(params, cfg, tfm.token_embed(params, tp.tokens), kv,
                      positions=tp.positions, rope=rope, block_mask=block)
    pv = torch.ones((2, kv.max_len), dtype=torch.bool, device=dev)
    pv[:, :L] = valid
    logits = tfm.logits_head(params, res.hidden[:, -1:])
    last_pos = tp.positions[:, -1]                                # [2]
    tok = sample_token(generator, warp_rows(logits, last_pos[:1]), warp)
    kv = res.kv
    out = torch.zeros((max_new,), dtype=torch.int32, device=dev)
    stops = (torch.tensor(stop_ids, dtype=torch.int32, device=dev)
             if stop_ids else None)
    n_valid = -1
    for i in range(max_new):
        out[i] = tok[0]
        emb = tfm.token_embed(params, tok[:, None].expand(2, 1))
        pos = (last_pos + 1 + i)[:, None]                         # [2, 1]
        res = tfm.forward(params, cfg, emb, kv, pos, rope, prefix_valid=pv)
        kv = res.kv
        logits = tfm.logits_head(params, res.hidden[:, -1:])
        nxt = sample_token(generator, warp_rows(logits, pos[0]), warp)
        if stops is not None and bool((tok[0] == stops).any()):
            n_valid = i + 1
            break
        tok = nxt
    else:
        if stops is not None:
            n_valid = max_new
    return ARResult(tokens=out, kv=kv, n_valid=n_valid)


def _sample_rows(generators, logits: torch.Tensor, warp: LogitsWarp):
    """One token per request from its row of ``logits`` [R, V]: argmax
    when greedy, else a draw from each request's own generator on its
    [1, V] row, as a lone run draws."""
    if warp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.cat([sample_token(g, logits[r: r + 1], warp)
                      for r, g in enumerate(generators)])


@torch.no_grad()
def generate_many(
    params: dict,
    cfg: ModelConfig,
    conds: torch.Tensor,           # [R] label ids or [R, 1, Tc, Dc] captions
    uncond: torch.Tensor,          # one uncond row, shared by the requests
    max_new: int,
    cfg_scale: float,
    warp: LogitsWarp,
    generators: Optional[Sequence[torch.Generator]],
    rope=None,
    prefix_valid: Optional[torch.Tensor] = None,   # [R, 2, <= S] or None
    kv_quant: bool = False,
    device=None,
) -> torch.Tensor:
    """Lockstep batched ``generate``: R requests share every forward.
    ``generators``: one per request (``None`` when greedy).  Returns tokens
    [R, max_new]."""
    dev = resolve_device(device)
    if rope is None:
        rope = tfm.make_rope_tables(cfg, dev)
    R, Tc = conds.shape[0], cfg.cls_token_num
    with span("ar.prefill"):
        # each request's conditioning embeds as in a lone run (one pair at
        # a time), then the pairs stack on the batch axis
        embeds = torch.cat([tfm.cond_embed(
            params, cfg, torch.cat([conds[r].reshape((1,) + uncond.shape[1:]),
                                    uncond], dim=0).to(dev))
            for r in range(R)])
        kv = KVCache.create(cfg, 2 * R, quantized=kv_quant, device=dev,
                            row_lengths=True,
                            groups=tfm.cache_groups(cfg, params))
        block = None
        if prefix_valid is not None:
            pv = torch.ones((2 * R, kv.max_len), dtype=torch.bool,
                            device=dev)
            pv[:, :prefix_valid.shape[-1]] = prefix_valid.to(
                dev).bool().reshape(2 * R, -1)
            prefix_valid = pv
            block = (torch.tril(torch.ones((Tc, Tc), dtype=torch.bool,
                                           device=dev))[None]
                     & pv[:, None, :Tc])
        res = tfm.forward(params, cfg, embeds, kv,
                          torch.arange(Tc, device=dev), rope,
                          block_mask=block)
        kv = res.kv
        logits = tfm.logits_head(params, res.hidden[:, -1])      # [2R, V]
        with span("sample"):
            tok = _sample_rows(generators, cfg_combine(logits, cfg_scale),
                               warp)
    out = torch.zeros((R, max_new), dtype=torch.int32, device=dev)
    for i in range(max_new):
        with span("ar.token"):
            count("ar_tokens")
            out[:, i] = tok
            emb = tfm.token_embed(params, tok.repeat_interleave(2)[:, None])
            res = tfm.forward(params, cfg, emb, kv,
                              torch.full((1,), Tc + i, device=dev), rope,
                              prefix_valid=prefix_valid)
            kv = res.kv
            logits = tfm.logits_head(params, res.hidden[:, -1])
            with span("sample"):
                tok = _sample_rows(generators, cfg_combine(logits, cfg_scale),
                                   warp)
    return out


@torch.no_grad()
def generate_tokens_many(
    params: dict,
    cfg: ModelConfig,
    token_prompt: TokenPrompt,     # tokens / positions / valid [R, 2, L]
    max_new: int,
    cfg_scale: float,
    warp: LogitsWarp,
    generators: Optional[Sequence[torch.Generator]],
    logits_mask: Optional[torch.Tensor] = None,
    logits_fn=None,
    rope=None,
    kv_quant: bool = False,
    stop_ids: tuple = (),
    device=None,
):
    """Lockstep batched ``generate_tokens``: R token-prompt requests of one
    length L share every forward.  ``token_prompt`` carries a leading
    request axis on ``tokens``, ``positions`` and ``valid`` (``pos_diff``
    is unused, as in the lone loop).  With ``stop_ids`` a request stops
    after committing one (its row keeps riding through the forwards, its
    outputs no longer recorded) and the loop ends when every request has
    stopped.  Returns ``(tokens [R, max_new], n_valid [R] int32)``:
    ``n_valid`` is ``max_new``, or one past a request's first stop id."""
    dev = resolve_device(device)
    if rope is None:
        rope = tfm.make_rope_tables(cfg, dev)
    tokens = token_prompt.tokens.to(dev)
    R, _, L = tokens.shape
    positions = token_prompt.positions.to(dev).reshape(2 * R, L)
    valid = token_prompt.valid.to(dev).bool().reshape(2 * R, L)

    def warp_rows(logits, cond_pos):        # [2R, 1, V], [R] -> [R, V]
        logits = cfg_combine(logits, cfg_scale)[:, 0]
        if logits_mask is not None:
            logits = torch.where(logits_mask, torch.finfo(torch.float32).min,
                                 logits)
        if logits_fn is not None:
            logits = logits_fn(logits, cond_pos)
        return logits

    with span("ar.prefill"):
        kv = KVCache.create(cfg, 2 * R, quantized=kv_quant, device=dev,
                            row_lengths=True,
                            groups=tfm.cache_groups(cfg, params))
        block = (torch.tril(torch.ones((L, L), dtype=torch.bool,
                                       device=dev))[None]
                 & valid[:, None, :])
        res = tfm.forward(params, cfg,
                          tfm.token_embed(params, tokens.reshape(2 * R, L)),
                          kv, positions=positions, rope=rope,
                          block_mask=block)
        pv = torch.ones((2 * R, kv.max_len), dtype=torch.bool, device=dev)
        pv[:, :L] = valid
        last_pos = positions[:, -1]                              # [2R]
        logits = tfm.logits_head(params, res.hidden[:, -1:])
        with span("sample"):
            tok = _sample_rows(generators, warp_rows(logits, last_pos[0::2]),
                               warp)
        kv = res.kv
    out = torch.zeros((R, max_new), dtype=torch.int32, device=dev)
    stops = (torch.tensor(stop_ids, dtype=torch.int32, device=dev)
             if stop_ids else None)
    n_valid = [max_new] * R
    live: List[int] = list(range(R))       # requests still generating
    for i in range(max_new):
        with span("ar.token"):
            count("ar_tokens")
            out[live, i] = tok[live]
            emb = tfm.token_embed(params, tok.repeat_interleave(2)[:, None])
            pos = (last_pos + 1 + i)[:, None]                    # [2R, 1]
            res = tfm.forward(params, cfg, emb, kv, pos, rope,
                              prefix_valid=pv)
            kv = res.kv
            logits = warp_rows(tfm.logits_head(params, res.hidden[:, -1:]),
                               pos[0::2, 0])
            nxt = tok.clone()
            with span("sample"):
                if warp.greedy:
                    nxt[live] = torch.argmax(logits[live], dim=-1).to(
                        torch.int32)
                else:
                    for r in live:
                        nxt[r] = sample_token(generators[r],
                                              logits[r: r + 1], warp)[0]
            if stops is not None:
                hit = (tok[:, None] == stops[None, :]).any(-1).tolist()
                for r in [r for r in live if hit[r]]:
                    n_valid[r] = i + 1
                    live.remove(r)
                if not live:
                    break
        tok = nxt
    return out, torch.tensor(n_valid, dtype=torch.int32, device=dev)
