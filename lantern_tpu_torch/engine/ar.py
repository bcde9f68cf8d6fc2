"""Vanilla CFG autoregressive decode — the 1.0x baseline the speculative
engine is measured against.  Counterpart of ``lantern_tpu/engine/ar.py``.

One loop per conditioning, over R requests in lockstep: ``_embed_loop``
(a LlamaGen class label or caption prefix, with the caption's pad mask) and
``_token_loop`` (a Chameleon token prompt, per-row position ids).  The R
requests share every forward over 2R rows (request r's cond and uncond rows
at ``2r`` and ``2r + 1``): K1 reads each weight once for all of them, K2
takes a length per row and K3 a start per row.  Each step samples ONE token
a request from its CFG-combined logits, from the request's own generator in
a lone run's order; the only host read a step is the stop check when
``stop_ids`` is set.  ``generate_many`` / ``generate_tokens_many`` run the
loops over R requests, ``generate`` / ``generate_tokens`` at R = 1 (the JAX
package vmaps its lone loop instead), so a request's tokens do not depend
on the batch it rides in.
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


def _sample_rows(generators, logits: torch.Tensor, warp: LogitsWarp):
    """One token per request from its row of ``logits`` [R, V]: argmax
    when greedy, else a draw from each request's own generator on its
    [1, V] row, as a lone run draws."""
    if warp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return torch.cat([sample_token(g, logits[r: r + 1], warp)
                      for r, g in enumerate(generators)])


def _embed_loop(params, cfg, conds, uncond, max_new, cfg_scale, warp,
                generators, rope, prefix_valid, kv_quant, dev):
    """The embedding-prefix loop: ``(tokens [R, max_new], cache)``."""
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
    return out, kv


def _token_loop(params, cfg, token_prompt, max_new, cfg_scale, warp,
                generators, logits_mask, logits_fn, rope, kv_quant, stop_ids,
                dev):
    """The token-prompt loop: ``(tokens [R, max_new], n_valid, cache)``,
    ``n_valid`` R ints, each ``max_new`` or one past its first stop id."""
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
            out[:, i] = tok        # a stopped row's tail is zeroed below
            emb = tfm.token_embed(params, tok.repeat_interleave(2)[:, None])
            pos = (last_pos + 1 + i)[:, None]                    # [2R, 1]
            res = tfm.forward(params, cfg, emb, kv, pos, rope,
                              prefix_valid=pv)
            kv = res.kv
            logits = warp_rows(tfm.logits_head(params, res.hidden[:, -1:]),
                               pos[0::2, 0])
            with span("sample"):
                if len(live) == R:
                    nxt = _sample_rows(generators, logits, warp)
                else:           # a stopped request's generator draws no more
                    nxt = tok.clone()
                    nxt[live] = _sample_rows(
                        None if generators is None
                        else [generators[r] for r in live],
                        logits[live], warp)
            if stops is not None:
                hit = (tok[:, None] == stops[None, :]).any(-1).tolist()
                for r in [r for r in live if hit[r]]:
                    n_valid[r] = i + 1
                    live.remove(r)
                if not live:
                    break
        tok = nxt
    for r, n in enumerate(n_valid):
        if n < max_new:
            out[r, n:] = 0
    return out, n_valid, kv


@torch.no_grad()
def generate(params: dict, cfg: ModelConfig, cond: torch.Tensor,
             uncond: torch.Tensor, max_new: int, cfg_scale: float,
             warp: LogitsWarp, generator: Optional[torch.Generator],
             rope=None, prefix_valid: Optional[torch.Tensor] = None,
             kv_quant: bool = False, device=None) -> ARResult:
    """LlamaGen base-mode CFG AR over an embedding prefix, ``cond`` and
    ``uncond`` label ids [1] or caption feats [1, Tc, Dc]: the lockstep
    loop at R = 1.  ``prefix_valid`` [2, <= S] (False on the caption's left
    pads) masks the pad rows in the prefill block and in every later read."""
    out, kv = _embed_loop(
        params, cfg, cond, uncond, max_new, cfg_scale, warp, [generator],
        rope, None if prefix_valid is None else prefix_valid[None], kv_quant,
        resolve_device(device))
    return ARResult(tokens=out[0], kv=kv)


@torch.no_grad()
def generate_tokens(params: dict, cfg: ModelConfig, token_prompt: TokenPrompt,
                    max_new: int, cfg_scale: float, warp: LogitsWarp,
                    generator: Optional[torch.Generator],
                    logits_mask: Optional[torch.Tensor] = None,
                    logits_fn=None, rope=None, kv_quant: bool = False,
                    stop_ids: tuple = (), device=None) -> ARResult:
    """Chameleon-family base-mode CFG AR: the lockstep loop at R = 1.
    ``logits_mask`` (bool [V]) suppresses tokens; ``logits_fn(logits
    [1, V], cond_positions)`` applies the grid FSM; ``stop_ids`` ends the
    loop after committing one."""
    one = TokenPrompt(*(t[None] for t in token_prompt[:3]),
                      token_prompt.pos_diff)
    out, n_valid, kv = _token_loop(
        params, cfg, one, max_new, cfg_scale, warp, [generator], logits_mask,
        logits_fn, rope, kv_quant, stop_ids, resolve_device(device))
    return ARResult(tokens=out[0], kv=kv,
                    n_valid=n_valid[0] if stop_ids else -1)


@torch.no_grad()
def generate_many(params: dict, cfg: ModelConfig, conds: torch.Tensor,
                  uncond: torch.Tensor, max_new: int, cfg_scale: float,
                  warp: LogitsWarp,
                  generators: Optional[Sequence[torch.Generator]],
                  rope=None, prefix_valid: Optional[torch.Tensor] = None,
                  kv_quant: bool = False, device=None) -> torch.Tensor:
    """Lockstep batched ``generate``: R requests share every forward.
    ``conds``: [R] label ids or [R, 1, Tc, Dc] captions; ``uncond``: one
    row, shared; ``generators``: one per request (``None`` when greedy);
    ``prefix_valid``: [R, 2, <= S] or None.  Returns tokens [R, max_new]."""
    return _embed_loop(params, cfg, conds, uncond, max_new, cfg_scale, warp,
                       generators, rope, prefix_valid, kv_quant,
                       resolve_device(device))[0]


@torch.no_grad()
def generate_tokens_many(params: dict, cfg: ModelConfig,
                         token_prompt: TokenPrompt, max_new: int,
                         cfg_scale: float, warp: LogitsWarp,
                         generators: Optional[Sequence[torch.Generator]],
                         logits_mask: Optional[torch.Tensor] = None,
                         logits_fn=None, rope=None, kv_quant: bool = False,
                         stop_ids: tuple = (), device=None):
    """Lockstep batched ``generate_tokens``: R token-prompt requests of one
    length L share every forward.  ``token_prompt`` carries a leading
    request axis on ``tokens``, ``positions`` and ``valid`` [R, 2, L]
    (``pos_diff`` is unused).  With ``stop_ids`` a request stops after
    committing one (its rows keep riding through the forwards, their
    outputs no longer recorded) and the loop ends when every request has
    stopped.  Returns ``(tokens [R, max_new], n_valid [R] int32)``:
    ``n_valid`` is ``max_new``, or one past a request's first stop id."""
    dev = resolve_device(device)
    out, n_valid, _ = _token_loop(
        params, cfg, token_prompt, max_new, cfg_scale, warp, generators,
        logits_mask, logits_fn, rope, kv_quant, stop_ids, dev)
    return out, torch.tensor(n_valid, dtype=torch.int32, device=dev)
