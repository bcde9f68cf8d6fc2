"""Speculative-decoding acceptance rules (counterpart of
``lantern_tpu/ops/acceptance.py``): greedy tree verification with optional
LANTERN relaxation, and the EAGLE-1 rejection-sampling tree walk.

The functions are written with tensor ops only (no host reads), in the
same order as the JAX code, so each branch can be compared line by line.
``stochastic_verify_tree`` takes ``uniforms`` to pin its coin flips; with
``uniforms=None`` it draws them from a ``torch.Generator``.  The traced
operating point (``LanternRT``) and the path-table ``stochastic_verify``
are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from .sampling import LogitsWarp, uniform, warp_logits


def take1(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` for a 0-d index tensor without a host sync (indexing with
    a 0-d tensor reads it back to the host first)."""
    return t.index_select(0, idx.reshape(1).long())[0]


class LanternSpec(NamedTuple):
    """Static relaxed-acceptance config; ``k == 0`` disables relaxation."""

    k: int = 0
    delta: float = 0.0

    @property
    def enabled(self) -> bool:
        return self.k > 0


def _neighbor_budget_index(cumsum_neighbors: torch.Tensor, px: torch.Tensor,
                           delta: float) -> torch.Tensor:
    """Largest neighbor index whose cumulative prob stays within the TVD
    budget (delta, or (delta-1)*p(x) when delta > 1); -1 if none."""
    if delta > 1.0:
        ok = cumsum_neighbors <= (delta - 1.0) * px[..., None]
    else:
        ok = cumsum_neighbors <= delta
    idx = torch.arange(cumsum_neighbors.shape[-1],
                       device=cumsum_neighbors.device).expand_as(ok)
    return torch.where(ok, idx, torch.full_like(idx, -1)).amax(dim=-1)


def relaxed_prob(probs: torch.Tensor, token: torch.Tensor,
                 nearest: torch.Tensor, lantern: LanternSpec):
    """LANTERN-inflated acceptance probability of ``token`` under ``probs``
    [..., V]; returns ``(p_relaxed, budget_idx)``."""
    token = token.long()
    px = torch.gather(probs, -1, token[..., None])[..., 0]
    neigh = nearest[token][..., : lantern.k].long()
    np_ = torch.gather(probs, -1, neigh)
    cum = torch.cumsum(np_, dim=-1)
    j = _neighbor_budget_index(cum, px, lantern.delta)
    gain = torch.gather(cum, -1, torch.clamp(j, min=0)[..., None])[..., 0]
    return torch.where(j >= 0, px + gain, px), j


def greedy_verify(path_logits: torch.Tensor, candidates: torch.Tensor,
                  nearest: Optional[torch.Tensor] = None,
                  lantern: LanternSpec = LanternSpec()):
    """Strict (or LANTERN-relaxed) greedy tree verification over the
    [P, D, V] path logits.  Returns ``(best_path, accept_len,
    bonus_logits)``."""
    P, D, V = path_logits.shape
    xi = candidates[:, 1:].long()
    valid = xi >= 0
    xi_safe = torch.clamp(xi, min=0)
    if lantern.enabled:
        if nearest is None:
            raise ValueError("lantern acceptance requires a nearest-latent table")
        probs = torch.softmax(path_logits[:, :-1], dim=-1)
        px_rel, _ = relaxed_prob(probs, xi_safe, nearest, lantern)
        onehot = torch.nn.functional.one_hot(xi_safe, V).bool()
        probs = torch.where(onehot, px_rel[..., None], probs)
        top = torch.argmax(probs, dim=-1)
    else:
        top = torch.argmax(path_logits[:, :-1], dim=-1)
    match = (xi == top) & valid
    accept_per_path = torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1)
    accept_len = accept_per_path.max()
    best = torch.where(accept_len == 0, torch.zeros_like(accept_len),
                       torch.argmax(accept_per_path))
    bonus_logits = take1(path_logits.flatten(0, 1), best * D + accept_len)
    return best.to(torch.int32), accept_len.to(torch.int32), bonus_logits


def _lantern_zero_mask(nearest, x, jstar, lantern: LanternSpec, V: int):
    """[V] bool mask of the drafted token's aggregated neighbors to zero on
    rejection (the reference zeroes ``k + 1`` slots while aggregating over
    ``k`` — kept as the reference has it)."""
    neigh1 = take1(nearest, x)[: lantern.k + 1].long()
    mask = torch.zeros((V,), dtype=torch.bool, device=nearest.device)
    return mask.index_fill(0, neigh1, True) & (jstar >= 0)


def stochastic_verify_tree(
    generator: Optional[torch.Generator],
    node_logits: torch.Tensor,      # [N+1, V] cfg-combined logits per slot
    tree_tokens: torch.Tensor,      # [N+1]
    children: torch.Tensor,         # [N+1, C] child slots, -1 padded
    depth: int,                     # max depth (levels to walk)
    warp: LogitsWarp,
    nearest: Optional[torch.Tensor] = None,
    lantern: LanternSpec = LanternSpec(),
    node_q: Optional[torch.Tensor] = None,       # [N+1] drafter residual q
    level_probs: Optional[Sequence[torch.Tensor]] = None,
    node_level_row: Optional[torch.Tensor] = None,  # [N+1]
    uniforms: Optional[torch.Tensor] = None,     # [depth, C]
    batch_warp: Optional[bool] = None,
):
    """Multi-round rejection sampling as a direct tree walk.  Returns
    ``(accepted_slots [depth+1], accept_len, sample_dist [V])``;
    ``accepted_slots[0] == 0`` and entries past ``accept_len`` are
    garbage."""
    N1, V = node_logits.shape
    C = children.shape[1]
    dev = node_logits.device
    multidraft = node_q is not None
    if lantern.enabled and nearest is None:
        raise ValueError("lantern acceptance requires a nearest-latent table")
    D = depth + 1
    if batch_warp is None:
        batch_warp = N1 * V <= (1 << 20)
    warped_all = (torch.softmax(warp_logits(node_logits, warp), dim=-1)
                  if batch_warp else None)

    def node_dist(cur):
        if batch_warp:
            return take1(warped_all, cur)
        return torch.softmax(warp_logits(take1(node_logits, cur), warp), dim=-1)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.long, device=dev)
    done, adjusted = false, false
    cur = zero
    accept_len = torch.ones((), dtype=torch.long, device=dev)
    path = torch.zeros((D,), dtype=torch.long, device=dev)
    sample_dist = torch.zeros((V,), dtype=torch.float32, device=dev)
    lower = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), -1)
    ar_c = torch.arange(C, device=dev)

    for i in range(1, D):
        u = (uniforms[i - 1] if uniforms is not None
             else uniform(generator, (C,), dev))
        active = (~done) & (accept_len == i)
        gtp = node_dist(cur)
        kids = take1(children, cur).long()                        # [C]
        kid_tok = torch.where(kids >= 0,
                              tree_tokens[torch.clamp(kids, min=0)].long(),
                              torch.full_like(kids, -1))
        dup = ((kid_tok[None, :] == kid_tok[:, None]) & lower
               & (kids >= 0)[None, :]).any(dim=1)
        lvl_row = take1(node_level_row, cur) if multidraft else None
        accepted, c_adjusted = false, false
        slot = zero
        for c in range(C):
            child = kids[c]
            x = torch.clamp(kid_tok[c], min=0)
            child_s = torch.clamp(child, min=0)
            do_try = (child >= 0) & (~accepted) & (~dup[c])
            if multidraft:
                do_try = do_try & (take1(node_q, child_s) > 0)
            px = take1(gtp, x)
            if lantern.enabled:
                neigh = take1(nearest, x)[: lantern.k].long()
                cum = torch.cumsum(gtp[neigh], dim=0)
                jstar = _neighbor_budget_index(cum[None, :], px[None],
                                               lantern.delta)[0]
                px = torch.where(jstar >= 0,
                                 px + take1(cum, torch.clamp(jstar, min=0)),
                                 px)
            qx = take1(node_q, child_s) if multidraft else 1.0
            accept_now = do_try & (u[c] <= px / qx)
            reject_now = do_try & (~accept_now)

            if multidraft:
                # clamp like a JAX gather: after the walk has stopped, cur
                # may sit on a level whose rank exceeds this level's rows
                # (the result is discarded by ``active``)
                rows = level_probs[i - 1].shape[0]
                q = take1(level_probs[i - 1], torch.clamp(lvl_row, max=rows - 1))
                sib_tok = torch.where(ar_c < c, kid_tok,
                                      torch.full_like(kid_tok, -1))
                sib_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
                sib_mask = sib_mask.index_put(
                    (torch.clamp(sib_tok, min=0),), sib_tok >= 0,
                    accumulate=True)
                q = torch.where(sib_mask, torch.zeros_like(q), q)
                if c > 0:
                    q = q / torch.clamp(q.sum(), min=1e-30)
                if lantern.enabled:
                    q = torch.where(
                        _lantern_zero_mask(nearest, x, jstar, lantern, V),
                        torch.zeros_like(q), q)
                new_gtp = torch.clamp(gtp - q, min=0.0)
            else:
                new_gtp = gtp.index_fill(0, x[None], 0.0)
                if lantern.enabled:
                    new_gtp = torch.where(
                        _lantern_zero_mask(nearest, x, jstar, lantern, V),
                        torch.zeros_like(new_gtp), new_gtp)
            ssum = new_gtp.sum()
            new_gtp = torch.where(ssum == 0, torch.ones_like(new_gtp),
                                  new_gtp)
            new_gtp = new_gtp / torch.clamp(new_gtp.sum(), min=1e-30)

            gtp = torch.where(reject_now, new_gtp, gtp)
            accepted = accepted | accept_now
            slot = torch.where(accept_now, child, slot)
            c_adjusted = c_adjusted | reject_now

        acc = active & accepted
        done = done | (active & ~accepted)
        cur = torch.where(acc, slot, cur)
        accept_len = torch.where(acc, accept_len + 1, accept_len)
        stepped = path.clone()
        stepped[i] = slot
        path = torch.where(acc, stepped, path)
        sample_dist = torch.where(active, gtp, sample_dist)
        adjusted = torch.where(active, c_adjusted, adjusted)

    full = accept_len == D
    base_dist = node_dist(cur)
    use_residual = adjusted & (~full)
    sample_dist = torch.where(use_residual, sample_dist, base_dist)
    return path.to(torch.int32), (accept_len - 1).to(torch.int32), sample_dist
