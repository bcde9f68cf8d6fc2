"""Drafter acceptance calibration -> data-driven draft-tree shapes.

Counterpart of ``lantern_tpu/engine/calibrate.py``.  Measure how often the
r-th ranked draft proposal matches (or, under the stochastic LANTERN walk,
is accepted against) the base model's next token, teacher-forced over a
base rollout, then feed the matrix to ``trees.optimize_tree`` to build the
expected-accept-length-optimal static tree for a node budget:

    probs = measure_rank_probs(params, dparams, cfg, dcfg, cond, uncond, gen)
    paths = trees.optimize_tree(probs, num_nodes=57, max_depth=5)
    spec  = trees.get_tree(paths)

Where the JAX code ``jit``s and ``vmap``s its per-chunk work, the port runs
the same work over a chunk's rows as batched tensors: the rank histograms
accumulate on the device and reach the host once a call, and the star-tree
Monte Carlo (``_star_accepts``) walks all rows of a chunk at once, one
tensor step per drafted child.  Every function runs on the device of
``params`` and draws from the ``torch.Generator`` it is given (the JAX code
takes a key).  The teacher caches round their rows up to a multiple of 128
as every ``KVCache`` does (T = 376 at LlamaGen-XL becomes 384).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..configs import DrafterConfig, ModelConfig
from ..kv import KVCache
from ..models import drafter as drf
from ..models import transformer as tfm
from ..ops import acceptance as acc
from ..ops.sampling import (LogitsWarp, cfg_combine, sample_without_replacement,
                            uniform, warp_logits)
from . import ar

NEG = torch.finfo(torch.float32).min


def _cond_pair(cfg: ModelConfig, cond, uncond) -> torch.Tensor:
    if cfg.cond_kind == "caption":
        return torch.cat([cond, uncond], dim=0)
    return torch.cat([torch.atleast_1d(cond), torch.atleast_1d(uncond)])


def _teacher_hidden(params, cfg: ModelConfig, cond_pair, tokens, rope):
    """Base-model hidden states over [cond prefix | tokens], batch-2 CFG
    rows, causal, no cache reuse."""
    dev = tokens.device
    emb = torch.cat(
        [tfm.cond_embed(params, cfg, cond_pair),
         tfm.token_embed(params, tokens[None].expand(2, -1))], dim=1)
    T = emb.shape[1]
    kv = KVCache.create(cfg, 2, max_len=T, device=dev)
    res = tfm.forward(params, cfg, emb, kv, torch.arange(T, device=dev), rope,
                      commit=False)
    return res.hidden                                         # [2, Tc+T, H]


def _drafter_hidden(params, dparams, cfg: ModelConfig, dcfg: DrafterConfig,
                    toks, drope, rope, cond, uncond):
    """The teacher's hidden states and the drafter's over the engine's
    draft-root inputs: Tc-1 zero-token prefix rows paired with the base's
    conditioning hiddens, then (tok_t, hidden that emitted tok_t) at drafter
    position Tc-1+t, the row that scores tok_{t+1}."""
    dev = toks.device
    Tc = cfg.cls_token_num
    hid = _teacher_hidden(params, cfg, _cond_pair(cfg, cond, uncond), toks,
                          rope)
    T = toks.shape[0]
    Dp = Tc - 1 + T
    dr_tokens = torch.cat([torch.zeros((Tc - 1,), dtype=toks.dtype,
                                       device=dev), toks])[None].expand(2, Dp)
    kv = KVCache.create(dcfg.model, 2, max_len=Dp, device=dev)
    x = drf.fuse_inputs(dparams, dr_tokens, hid[:, :Dp])
    out = tfm.forward(dparams, dcfg.model, x, kv,
                      torch.arange(Dp, device=dev), drope,
                      commit=False).hidden                    # [2, Dp, H]
    return hid, out


def _head(params, hidden, cfg_scale: float) -> torch.Tensor:
    """f32 CFG-combined logits [T, V] of hidden rows [2, T, H]."""
    return cfg_combine(tfm.logits_head(params, hidden), cfg_scale)[0].float()


def measure_rank_probs(
    params: dict,
    dparams: dict,
    cfg: ModelConfig,
    dcfg: DrafterConfig,
    cond,
    uncond,
    generator: Optional[torch.Generator],
    num_tokens: Optional[int] = None,
    max_rank: int = 10,
    cfg_scale: float = 3.0,
    warp: LogitsWarp = LogitsWarp(),
    num_rollouts: int = 1,
) -> np.ndarray:
    """P(drafter's rank-r prediction == base's next token), r < max_rank.

    For each rollout: sample a CFG AR stream from the base, teacher-force
    the base for hidden states, teacher-force the drafter over (token,
    hidden) pairs (exactly the engine's draft-root input), CFG-combine its
    head logits, and histogram the rank of the true next token (strictly
    larger logits ahead of it).  Returns ``[max_rank]`` f64 probabilities
    (the rest of the mass is a miss)."""
    dev = params["embed"].device
    num_tokens = num_tokens or cfg.block_size
    rope = tfm.make_rope_tables(cfg, dev)
    drope = tfm.make_rope_tables(dcfg.model, dev)
    Tc = cfg.cls_token_num

    hits = torch.zeros((max_rank,), dtype=torch.int64, device=dev)
    total = 0
    for _ in range(num_rollouts):
        toks = ar.generate(params, cfg, cond, uncond, num_tokens, cfg_scale,
                           warp, generator, rope=rope, device=dev).tokens
        _, out = _drafter_hidden(params, dparams, cfg, dcfg, toks, drope,
                                 rope, cond, uncond)
        T = toks.shape[0]
        # the head over every drafter row, as the JAX code takes it
        lg = _head(params, out, cfg_scale)[Tc - 1: Tc - 2 + T]    # [T-1, V]
        true_lg = torch.gather(lg, 1, toks[1:, None].long())
        ranks = (lg > true_lg).sum(dim=1)                          # [T-1]
        hits += (ranks[:, None] == torch.arange(max_rank, device=dev)).sum(0)
        total += T - 1
    probs = hits.cpu().numpy() / max(total, 1)
    # optimize_tree needs strictly positive probabilities: floor at 1/total
    return np.maximum(probs, 1.0 / max(total, 2))


def _teacher_hidden_chunked(params, cfg: ModelConfig, tp, toks, rope,
                            kv_quant: bool, seg: int = 512):
    """Hidden states [2, L+T, H] of the token prompt and the rollout,
    teacher-forced as a chunked committed prefill of ``seg``-row segments
    (a bounded attention workspace at 7B), and the cond positions [L+T]."""
    dev = toks.device
    T = toks.shape[0]
    full = torch.cat([tp.tokens, toks[None].expand(2, T).to(tp.tokens.dtype)],
                     dim=1)
    last_pos = tp.positions[:, -1]
    gen_pos = last_pos[:, None] + 1 + torch.arange(T, device=dev)[None]
    positions = torch.cat([tp.positions.long(), gen_pos.long()], dim=1)
    valid = torch.cat([tp.valid.bool(),
                       torch.ones((2, T), dtype=torch.bool, device=dev)], 1)
    n_full = full.shape[1]
    pad = (-n_full) % seg
    full_p = torch.nn.functional.pad(full, (0, pad))
    pos_p = torch.cat([positions, positions[:, -1:].expand(2, pad)], dim=1)
    valid_p = torch.nn.functional.pad(valid, (0, pad))
    kv = KVCache.create(cfg, 2, max_len=n_full + pad, quantized=kv_quant,
                        device=dev)
    pv = torch.nn.functional.pad(valid_p, (0, kv.max_len - valid_p.shape[1]),
                                 value=True)
    causal = torch.tril(torch.ones((seg, seg), dtype=torch.bool, device=dev))
    parts = []
    for lo in range(0, n_full + pad, seg):
        block = causal[None] & valid_p[:, None, lo:lo + seg]
        res = tfm.forward(params, cfg, tfm.token_embed(params,
                                                       full_p[:, lo:lo + seg]),
                          kv, pos_p[:, lo:lo + seg], rope, block_mask=block,
                          prefix_valid=pv, commit=True)
        kv = res.kv
        parts.append(res.hidden)
    return torch.cat(parts, dim=1)[:, :n_full], positions[0]


def _constrain(lg, pos, logits_mask, logits_fn):
    if logits_mask is not None:
        lg = torch.where(logits_mask, NEG, lg)
    if logits_fn is not None:
        lg = logits_fn(lg, pos)
    return lg


def measure_stale_rank_probs(
    params: dict,
    cfg: ModelConfig,
    token_prompt,
    generator: Optional[torch.Generator],
    num_tokens: int,
    max_rank: int = 10,
    max_depth: int = 8,
    cfg_scale: float = 3.0,
    warp: LogitsWarp = LogitsWarp(),
    logits_fn=None,
    logits_mask=None,
    kv_quant: bool = False,
    num_rollouts: int = 1,
    chunk: int = 512,
) -> np.ndarray:
    """Depth-dependent rank probabilities ``[max_depth, max_rank]`` of the
    hidden-passthrough drafter on a token-prompt (Chameleon / Lumina)
    model, for ``trees.optimize_tree``'s 2-D form.

    The passthrough drafter proposes from the root's distribution at every
    level, so at depth d the candidates are ranked by a distribution d
    positions stale against the verifier's: roll out the base stream (grid
    FSM included), teacher-force it once, and for each depth d histogram
    the rank of the token at row + d within the row's constrained logits
    (the FSM at the parent position ``P + d``, the engine's convention)."""
    dev = params["embed"].device
    rope = tfm.make_rope_tables(cfg, dev)
    tp = token_prompt.to(dev)
    L = tp.tokens.shape[1]
    T = num_tokens
    ranks_r = torch.arange(max_rank, device=dev)

    hits = torch.zeros((max_depth, max_rank), dtype=torch.int64, device=dev)
    totals = torch.zeros((max_depth,), dtype=torch.int64, device=dev)
    for _ in range(num_rollouts):
        toks = ar.generate_tokens(params, cfg, tp, T, cfg_scale, warp,
                                  generator, logits_mask=logits_mask,
                                  logits_fn=logits_fn, rope=rope,
                                  kv_quant=kv_quant, device=dev).tokens
        hid, cond_pos = _teacher_hidden_chunked(params, cfg, tp, toks, rope,
                                             kv_quant)
        # row L-1+t emits the distribution that scores toks[t] at depth 1
        for lo in range(0, T, chunk):
            hi = min(lo + chunk, T)
            rows = torch.arange(L - 1 + lo, L - 1 + hi, device=dev)
            lg = _head(params, hid[:, rows], cfg_scale)          # [C, V]
            t_idx = torch.arange(lo, hi, device=dev)
            for d in range(1, max_depth + 1):
                tpos = t_idx + d
                ok = tpos < T
                tgt = toks[torch.clamp(tpos, 0, T - 1)].long()
                ml = _constrain(lg, cond_pos[rows] + d, logits_mask, logits_fn)
                tv = torch.gather(ml, 1, tgt[:, None])
                r = (ml > tv).sum(dim=1)
                hits[d - 1] += ((r[:, None] == ranks_r) & ok[:, None]).sum(0)
                totals[d - 1] += ok.sum()
    hits, totals = hits.cpu().numpy(), totals.cpu().numpy()
    probs = hits / np.maximum(totals, 1)[:, None]
    return np.maximum(probs, 1.0 / max(int(totals.max()), 2))


def _star_accepts(lg_prop, lg_tgt, generator, warp: LogitsWarp, nearest,
                  lantern: acc.LanternSpec, K: int) -> torch.Tensor:
    """[C] rank of the child that ONE level of the stochastic LANTERN walk
    accepts (-1: none), for C independent star trees at once.

    Row c: the stale proposal is the warped softmax of ``lg_prop[c]``, from
    which K children are drawn without replacement (Gumbel top-k, residual
    q), tried in rank order against the warped target ``lg_tgt[c]`` exactly
    as ``acceptance.stochastic_verify_tree`` does at depth 1 with
    ``level_probs = (s,)``, every row's proposal at in-level row 0 and the
    target warped per row: LANTERN inflation, residual subtraction with the
    earlier siblings masked out, and the walk's stop at the first accept."""
    C, V = lg_prop.shape
    dev = lg_prop.device
    s = torch.softmax(warp_logits(lg_prop, warp), dim=-1)          # [C, V]
    idx, q = sample_without_replacement(generator, s, K)           # [C, K]
    idx = idx.long()
    u = uniform(generator, (C, K), dev)
    gtp = torch.softmax(warp_logits(lg_tgt, warp), dim=-1)
    lower = torch.tril(torch.ones((K, K), dtype=torch.bool, device=dev), -1)
    dup = ((idx[:, None, :] == idx[:, :, None]) & lower).any(dim=2)  # [C, K]
    accepted = torch.zeros((C,), dtype=torch.bool, device=dev)
    slot = torch.full((C,), -1, dtype=torch.long, device=dev)
    for c in range(K):
        x = idx[:, c]
        do_try = (~accepted) & (~dup[:, c]) & (q[:, c] > 0)
        px = torch.gather(gtp, 1, x[:, None])[:, 0]
        if lantern.enabled:
            neigh = nearest[x][:, : lantern.k].long()
            cum = torch.cumsum(torch.gather(gtp, 1, neigh), dim=1)
            jstar = acc._neighbor_budget_index(cum, px, lantern.delta)
            px = torch.where(
                jstar >= 0,
                px + torch.gather(cum, 1, torch.clamp(jstar, min=0)[:, None])[:, 0],
                px)
        accept_now = do_try & (u[:, c] <= px / q[:, c])
        reject_now = do_try & (~accept_now)
        # the drafter's distribution minus the earlier-drafted siblings
        qd = s.scatter(1, idx[:, :c], 0.0) if c > 0 else s
        if c > 0:
            qd = qd / torch.clamp(qd.sum(dim=1, keepdim=True), min=1e-30)
        if lantern.enabled:
            neigh1 = nearest[x][:, : lantern.k + 1].long()
            qd = torch.where((jstar >= 0)[:, None], qd.scatter(1, neigh1, 0.0),
                             qd)
        new_gtp = torch.clamp(gtp - qd, min=0.0)
        ssum = new_gtp.sum(dim=1, keepdim=True)
        new_gtp = torch.where(ssum == 0, torch.ones_like(new_gtp), new_gtp)
        new_gtp = new_gtp / torch.clamp(new_gtp.sum(dim=1, keepdim=True),
                                        min=1e-30)
        gtp = torch.where(reject_now[:, None], new_gtp, gtp)
        slot = torch.where(accept_now, torch.full_like(slot, c), slot)
        accepted = accepted | accept_now
    return slot


def _accept_hist(hits, totals, d: int, ranks: torch.Tensor, max_rank: int):
    r = torch.arange(max_rank, device=ranks.device)
    hits[d - 1] += (ranks[:, None] == r).sum(0)
    totals[d - 1] += ranks.shape[0]


def measure_stale_accept_probs(
    params: dict,
    cfg: ModelConfig,
    token_prompt,
    generator: Optional[torch.Generator],
    num_tokens: int,
    nearest: torch.Tensor,
    lantern,
    max_rank: int = 10,
    max_depth: int = 8,
    cfg_scale: float = 3.0,
    warp: LogitsWarp = LogitsWarp(),
    logits_fn=None,
    logits_mask=None,
    kv_quant: bool = False,
    num_rollouts: int = 1,
    chunk: int = 32,
) -> np.ndarray:
    """Depth x rank probabilities that the STOCHASTIC LANTERN walk accepts
    the rank-r child of a correct node at depth d: ``rho[d-1, r]``, the
    per-edge factor of ``trees.optimize_tree``'s model, measured with the
    engine's own acceptance rule (under sampling, acceptance is about
    min(1, p/q) per trial, far above rank match, so the greedy matrix
    mis-sizes the tree).

    Per teacher position t and depth d: the stale proposals are drawn as
    ``drafter.draft_stale`` draws them (warped softmax of the root row
    under the FSM at the parent position), and one level of the walk runs
    against the true distribution at t + d: the engine's next root token
    is the bonus sampled from the same distribution that then serves as
    the stale proposal, so depth-d children verify d rows past the
    proposal's."""
    dev = params["embed"].device
    rope = tfm.make_rope_tables(cfg, dev)
    tp = token_prompt.to(dev)
    L = tp.tokens.shape[1]
    T = num_tokens

    hits = torch.zeros((max_depth, max_rank), dtype=torch.int64, device=dev)
    totals = torch.zeros((max_depth,), dtype=torch.int64, device=dev)
    for _ in range(num_rollouts):
        toks = ar.generate_tokens(params, cfg, tp, T, cfg_scale, warp,
                                  generator, logits_mask=logits_mask,
                                  logits_fn=logits_fn, rope=rope,
                                  kv_quant=kv_quant, device=dev).tokens
        hid, cond_pos = _teacher_hidden_chunked(params, cfg, tp, toks, rope,
                                             kv_quant)
        for d in range(1, max_depth + 1):
            Td = T - d               # valid roots: target row t + d exists
            if Td <= 0:
                break
            for lo in range(0, Td, chunk):
                hi = min(lo + chunk, Td)
                root = torch.arange(L - 1 + lo, L - 1 + hi, device=dev)
                pos = cond_pos[root] + d
                lg_root = _constrain(_head(params, hid[:, root], cfg_scale),
                                     pos, logits_mask, logits_fn)
                lg_tgt = _constrain(_head(params, hid[:, root + d],
                                          cfg_scale),
                                    pos, logits_mask, logits_fn)
                ranks = _star_accepts(lg_root, lg_tgt, generator, warp,
                                      nearest, lantern, max_rank)
                _accept_hist(hits, totals, d, ranks, max_rank)
    probs = hits.cpu().numpy() / np.maximum(totals.cpu().numpy(), 1)[:, None]
    return np.maximum(probs, 1e-4)


def measure_drafter_accept_probs(
    params: dict,
    dparams: dict,
    cfg: ModelConfig,
    dcfg: DrafterConfig,
    cond,
    uncond,
    generator: Optional[torch.Generator],
    nearest: torch.Tensor,
    lantern,
    num_tokens: Optional[int] = None,
    max_rank: int = 10,
    max_depth: int = 6,
    cfg_scale: float = 3.0,
    warp: LogitsWarp = LogitsWarp(),
    num_rollouts: int = 1,
    chunk: int = 64,
) -> np.ndarray:
    """Depth x rank stochastic-walk acceptance probabilities for an EAGLE
    drafter on a label- or caption-conditioned (LlamaGen) model: the
    drafter counterpart of ``measure_stale_accept_probs`` (the same star
    trees through the same walk).

    Teacher-forced along a base rollout: the depth-d proposal is the
    drafter's CFG-combined head distribution at the row scoring toks[t+d]
    with the true path's (token, base hidden) inputs; the target is the
    base model's distribution at the same position.  The drafter
    conditions on position t+d-1's token and hidden, so there is no
    staleness offset."""
    dev = params["embed"].device
    num_tokens = num_tokens or cfg.block_size
    rope = tfm.make_rope_tables(cfg, dev)
    drope = tfm.make_rope_tables(dcfg.model, dev)
    Tc = cfg.cls_token_num

    hits = torch.zeros((max_depth, max_rank), dtype=torch.int64, device=dev)
    totals = torch.zeros((max_depth,), dtype=torch.int64, device=dev)
    for _ in range(num_rollouts):
        toks = ar.generate(params, cfg, cond, uncond, num_tokens, cfg_scale,
                           warp, generator, rope=rope, device=dev).tokens
        hid, out = _drafter_hidden(params, dparams, cfg, dcfg, toks, drope,
                                   rope, cond, uncond)
        T = toks.shape[0]
        # base row Tc-1+u scores toks[u]; drafter row Tc-1+u scores toks[u+1]
        base_lg = _head(params, hid[:, Tc - 1: Tc - 1 + T], cfg_scale)
        dr_lg = _head(params, out[:, Tc - 1: Tc - 1 + T], cfg_scale)
        for d in range(1, max_depth + 1):
            # root committed toks[t]; level-d children score toks[t+d]:
            # proposal = drafter row t+d-1, target = base row t+d
            Td = T - d
            if Td <= 0:
                break
            for lo in range(0, Td, chunk):
                hi = min(lo + chunk, Td)
                ranks = _star_accepts(dr_lg[lo + d - 1: hi + d - 1],
                                      base_lg[lo + d: hi + d], generator,
                                      warp, nearest, lantern, max_rank)
                _accept_hist(hits, totals, d, ranks, max_rank)
    probs = hits.cpu().numpy() / np.maximum(totals.cpu().numpy(), 1)[:, None]
    return np.maximum(probs, 1e-4)
