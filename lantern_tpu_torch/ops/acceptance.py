"""Speculative-decoding acceptance rules (counterpart of
``lantern_tpu/ops/acceptance.py``): greedy tree verification with optional
LANTERN relaxation, the path-table rejection-sampling verifier
(``stochastic_verify``, EAGLE-2 and EAGLE-1 multi-draft) and the engine's
tree walk (``stochastic_verify_tree``).

The functions are written with tensor ops only (no host reads), in the
same order as the JAX code, so each branch can be compared line by line;
on CUDA tensors the tree walk is instead one launch of kernel K5
(``csrc/tree_walk.cu``), held to its plain version.
The stochastic verifiers take ``uniforms`` to pin their coin flips; with
``uniforms=None`` they draw them from a ``torch.Generator``.  ``rt``
(``LanternSpec.runtime``) is the operating point as device tensors: it
narrows the static ``LanternSpec`` without a host read, so one engine
serves a whole (k, delta) sweep.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from . import _cuda
from .sampling import LogitsWarp, keep_threshold, uniform, warp_logits


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

    def runtime(self, k_eff=None, delta_eff=None,
                device=None) -> "LanternRT":
        """The operating point as device tensors (defaults: the static
        one).  ``k_eff`` must not exceed ``k``, the table width."""
        k = self.k if k_eff is None else k_eff
        d = self.delta if delta_eff is None else delta_eff
        return LanternRT(k=torch.as_tensor(k, dtype=torch.int32,
                                           device=device),
                         delta=torch.as_tensor(d, dtype=torch.float32,
                                               device=device))


class LanternRT(NamedTuple):
    """(k, delta) as device tensors; shapes stay those of the static
    ``LanternSpec.k`` table width."""

    k: torch.Tensor         # int32 [], <= spec.k
    delta: torch.Tensor     # f32 []


def _neighbor_budget_index(cumsum_neighbors: torch.Tensor, px: torch.Tensor,
                           delta, k_eff=None) -> torch.Tensor:
    """Largest neighbor index whose cumulative prob stays within the TVD
    budget (delta, or (delta-1)*p(x) when delta > 1); -1 if none.
    ``delta`` is a Python float or a device scalar; ``k_eff`` (a device
    scalar) masks neighbors past the effective table width."""
    if isinstance(delta, (int, float)):
        if delta > 1.0:
            ok = cumsum_neighbors <= (delta - 1.0) * px[..., None]
        else:
            ok = cumsum_neighbors <= delta
    else:
        d = delta.to(torch.float32)
        ok = torch.where(d > 1.0,
                         cumsum_neighbors <= (d - 1.0) * px[..., None],
                         cumsum_neighbors <= d)
    idx = torch.arange(cumsum_neighbors.shape[-1],
                       device=cumsum_neighbors.device)
    if k_eff is not None:
        ok = ok & (idx < k_eff)
    idx = idx.expand_as(ok)
    return torch.where(ok, idx, torch.full_like(idx, -1)).amax(dim=-1)


def _budget(cum, px, lantern: LanternSpec, rt: Optional[LanternRT]):
    if rt is None:
        return _neighbor_budget_index(cum, px, lantern.delta)
    return _neighbor_budget_index(cum, px, rt.delta, k_eff=rt.k)


def relaxed_prob(probs: torch.Tensor, token: torch.Tensor,
                 nearest: torch.Tensor, lantern: LanternSpec,
                 rt: Optional[LanternRT] = None):
    """LANTERN-inflated acceptance probability of ``token`` under ``probs``
    [..., V]; returns ``(p_relaxed, budget_idx)``.  ``rt`` narrows the
    budget to ``rt.k`` neighbors and ``rt.delta``."""
    token = token.long()
    px = torch.gather(probs, -1, token[..., None])[..., 0]
    neigh = nearest[token][..., : lantern.k].long()
    np_ = torch.gather(probs, -1, neigh)
    cum = torch.cumsum(np_, dim=-1)
    j = _budget(cum, px, lantern, rt)
    gain = torch.gather(cum, -1, torch.clamp(j, min=0)[..., None])[..., 0]
    return torch.where(j >= 0, px + gain, px), j


def greedy_verify(path_logits: torch.Tensor, candidates: torch.Tensor,
                  nearest: Optional[torch.Tensor] = None,
                  lantern: LanternSpec = LanternSpec(),
                  rt: Optional[LanternRT] = None):
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
        px_rel, _ = relaxed_prob(probs, xi_safe, nearest, lantern, rt)
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


def _lantern_zero_mask(nearest, x, jstar, lantern: LanternSpec,
                       rt: Optional[LanternRT], V: int):
    """[V] bool mask of the drafted token's aggregated neighbors to zero on
    rejection (the reference zeroes ``k + 1`` slots while aggregating over
    ``k`` — kept as the reference has it); ``rt`` keeps the first
    ``rt.k + 1`` of them."""
    neigh1 = take1(nearest, x)[: lantern.k + 1].long()
    mask = torch.zeros((V,), dtype=torch.bool, device=nearest.device)
    if rt is None:
        return mask.index_fill(0, neigh1, True) & (jstar >= 0)
    in_k = torch.arange(lantern.k + 1, device=nearest.device) <= rt.k
    return mask.index_put((neigh1,), in_k & (jstar >= 0))


def _dedup_mask(tokens: torch.Tensor, eligible: torch.Tensor) -> torch.Tensor:
    """dup[j] = some eligible j' < j carries the same token (the
    reference's sequential ``candidates_set`` dedup, vectorized)."""
    P = tokens.shape[0]
    same = tokens[None, :] == tokens[:, None]                 # [j, j']
    earlier = torch.tril(torch.ones((P, P), dtype=torch.bool,
                                    device=tokens.device), -1)
    return (same & earlier & eligible[None, :]).any(dim=1)


class _LevelState(NamedTuple):
    done: torch.Tensor          # bool: no acceptance happened at some level
    accept_len: torch.Tensor    # accepted candidates incl. root (starts 1)
    best: torch.Tensor          # path index
    sample_dist: torch.Tensor   # [V] residual distribution (if adjusted)
    adjusted: torch.Tensor      # bool: sample_dist holds a residual


def stochastic_verify(
    generator: Optional[torch.Generator],
    path_logits: torch.Tensor,              # [P, D, V]
    candidates: torch.Tensor,               # [P, D], -1 padded
    warp: LogitsWarp,
    nearest: Optional[torch.Tensor] = None,
    lantern: LanternSpec = LanternSpec(),
    q_probs: Optional[torch.Tensor] = None,        # [P, D]
    level_probs: Optional[Sequence[torch.Tensor]] = None,
    p_indices: Optional[torch.Tensor] = None,      # [P, D]
    b_indices: Optional[torch.Tensor] = None,      # [P, D, S]
    tree_tokens: Optional[torch.Tensor] = None,    # [N+1]
    uniforms: Optional[torch.Tensor] = None,       # [D-1, P]
    rt: Optional[LanternRT] = None,
):
    """Multi-round speculative rejection sampling over the path table.

    EAGLE-2 (``q_probs=None``): the proposal q is 1, a token is accepted
    with probability p(x).  EAGLE-1 multi-draft: q comes from the drafter's
    residual probabilities; on rejection the drafter's distribution at the
    parent node (``level_probs`` rows by ``p_indices``) minus its
    already-drafted siblings (``b_indices`` slots into ``tree_tokens``) is
    subtracted from p.  ``uniforms`` row ``i - 1`` pins level ``i``'s coins.
    Returns ``(best_path, accept_len, sample_dist [V])``."""
    P, D, V = path_logits.shape
    dev = path_logits.device
    multidraft = q_probs is not None
    if lantern.enabled and nearest is None:
        raise ValueError("lantern acceptance requires a nearest-latent table")
    false = torch.zeros((), dtype=torch.bool, device=dev)
    state = _LevelState(
        done=false,
        accept_len=torch.ones((), dtype=torch.long, device=dev),
        best=torch.zeros((), dtype=torch.long, device=dev),
        sample_dist=torch.zeros((V,), dtype=torch.float32, device=dev),
        adjusted=false)
    for i in range(1, D):
        level_u = (uniforms[i - 1] if uniforms is not None
                   else uniform(generator, (P,), dev))
        state = _run_level(state, i, level_u, path_logits, candidates, warp,
                           nearest, lantern, q_probs, level_probs, p_indices,
                           b_indices, tree_tokens, multidraft, rt)
    # the bonus distribution: the residual if the last processed level
    # adjusted p and the walk ended early, else the warped base
    # distribution at the last accepted position
    full = state.accept_len == D
    base_logits = take1(path_logits.flatten(0, 1),
                        state.best * D + state.accept_len - 1)
    base_dist = torch.softmax(warp_logits(base_logits, warp), dim=-1)
    use_residual = state.adjusted & (~full)
    sample_dist = torch.where(use_residual, state.sample_dist, base_dist)
    return (state.best.to(torch.int32), (state.accept_len - 1).to(torch.int32),
            sample_dist)


def _run_level(state: _LevelState, i: int, uniforms: torch.Tensor,
               path_logits, candidates, warp, nearest, lantern, q_probs,
               level_probs, p_indices, b_indices, tree_tokens,
               multidraft: bool, rt: Optional[LanternRT] = None):
    """One level of ``stochastic_verify``: the candidates at depth ``i`` of
    the paths that share the accepted prefix, tried in path order (the
    JAX ``fori_loop`` over P, unrolled over tensors)."""
    P, D, V = path_logits.shape
    dev = path_logits.device
    candidates = candidates.long()
    active = (~state.done) & (state.accept_len == i)
    pos = torch.arange(D, device=dev)
    prefix_region = pos[None, :] < state.accept_len
    prefix_eq = torch.where(prefix_region,
                            candidates == take1(candidates, state.best)[None],
                            torch.ones_like(prefix_region))
    is_eq = prefix_eq.all(dim=1)                               # [P]
    fi = torch.argmax(is_eq.to(torch.int32))                   # first match
    gtp = torch.softmax(warp_logits(take1(path_logits[:, i - 1], fi), warp),
                        dim=-1)
    tokens = candidates[:, i]
    eligible = is_eq & (tokens >= 0)
    tryable = eligible & ~_dedup_mask(tokens, eligible)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    accepted, adjusted = false, false
    best = torch.zeros((), dtype=torch.long, device=dev)
    for j in range(P):
        do_try = tryable[j] & (~accepted)
        if multidraft:
            do_try = do_try & (q_probs[j, i] > 0)
        x = torch.clamp(tokens[j], min=0)
        px = take1(gtp, x)
        if lantern.enabled:
            neigh = take1(nearest, x)[: lantern.k].long()
            cum = torch.cumsum(gtp[neigh], dim=0)
            jstar = _budget(cum[None, :], px[None], lantern, rt)[0]
            px = torch.where(jstar >= 0,
                             px + take1(cum, torch.clamp(jstar, min=0)), px)
        qx = q_probs[j, i] if multidraft else 1.0
        accept_now = do_try & (uniforms[j] <= px / qx)
        reject_now = do_try & (~accept_now)

        if multidraft:
            # subtract the drafter's sibling-masked distribution at the
            # parent node; indices clamp as a JAX gather does
            lp = level_probs[i - 1]
            q = take1(lp, torch.clamp(p_indices[j, i].long(), 0,
                                      lp.shape[0] - 1))
            sib_slots = b_indices[j, i].long()                  # [S]
            sib_tok = torch.where(
                sib_slots >= 0,
                tree_tokens.long()[torch.clamp(sib_slots, min=0)],
                torch.full_like(sib_slots, -1))
            sib_mask = torch.zeros((V,), dtype=torch.bool, device=dev)
            sib_mask = sib_mask.index_put(
                (torch.clamp(sib_tok, min=0),), sib_tok >= 0,
                accumulate=True)
            has_sib = (sib_slots >= 0).any()
            q = torch.where(sib_mask, torch.zeros_like(q), q)
            q = torch.where(has_sib, q / torch.clamp(q.sum(), min=1e-30), q)
            if lantern.enabled:
                q = torch.where(
                    _lantern_zero_mask(nearest, x, jstar, lantern, rt, V),
                    torch.zeros_like(q), q)
            new_gtp = torch.clamp(gtp - q, min=0.0)
        else:
            new_gtp = gtp.index_fill(0, x[None], 0.0)
            if lantern.enabled:
                new_gtp = torch.where(
                    _lantern_zero_mask(nearest, x, jstar, lantern, rt, V),
                    torch.zeros_like(new_gtp), new_gtp)
        ssum = new_gtp.sum()
        new_gtp = torch.where(ssum == 0, torch.ones_like(new_gtp), new_gtp)
        new_gtp = new_gtp / torch.clamp(new_gtp.sum(), min=1e-30)

        gtp = torch.where(reject_now, new_gtp, gtp)
        accepted = accepted | accept_now
        best = torch.where(accept_now, torch.full_like(best, j), best)
        adjusted = adjusted | reject_now

    acc = active & accepted
    return _LevelState(
        done=state.done | (active & ~accepted),
        accept_len=torch.where(acc, state.accept_len + 1, state.accept_len),
        best=torch.where(acc, best, state.best),
        sample_dist=torch.where(active, gtp, state.sample_dist),
        adjusted=torch.where(active, adjusted, state.adjusted))


def walk_coins(generator: Optional[torch.Generator], depth: int, width: int,
               device) -> torch.Tensor:
    """The tree walk's coins [depth, width]: ``width`` uniform draws a level
    from ``generator``, level by level, each row as ``torch.rand((width,))``
    draws it; all are drawn before the walk starts."""
    u = torch.empty((depth, width), dtype=torch.float32, device=device)
    for row in u:
        row.uniform_(generator=generator)
    return u


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
    rt: Optional[LanternRT] = None,
    batch_warp: Optional[bool] = None,
):
    """Multi-round rejection sampling as a direct tree walk: the same
    result as ``stochastic_verify`` over the tree's path table, in
    O(depth x children) steps.  Returns ``(accepted_slots [depth+1],
    accept_len, sample_dist [V])``; ``accepted_slots[0] == 0`` and entries
    past ``accept_len`` are 0.

    ``uniforms`` pins the coins; ``None`` draws them from ``generator``
    before the walk (``walk_coins``).  Dispatch by device: one launch of
    kernel K5 (``stochastic_verify_tree_cuda``) on CUDA tensors, the plain
    version on CPU tensors; ``batch_warp`` is the plain version's."""
    if lantern.enabled and nearest is None:
        raise ValueError("lantern acceptance requires a nearest-latent table")
    if uniforms is None:
        uniforms = walk_coins(generator, depth, children.shape[1],
                              node_logits.device)
    args = (node_logits, tree_tokens, children, depth, warp, uniforms)
    kw = dict(nearest=nearest, lantern=lantern, node_q=node_q,
              level_probs=level_probs, node_level_row=node_level_row, rt=rt)
    if _cuda.on_cuda(node_logits, tree_tokens, children, uniforms, nearest,
                     node_q, node_level_row):
        return stochastic_verify_tree_cuda(*args, **kw)
    return stochastic_verify_tree_plain(*args, **kw, batch_warp=batch_warp)


def stochastic_verify_tree_plain(
    node_logits: torch.Tensor,      # [N+1, V]
    tree_tokens: torch.Tensor,      # [N+1]
    children: torch.Tensor,         # [N+1, C]
    depth: int,
    warp: LogitsWarp,
    uniforms: torch.Tensor,         # [depth, C]
    nearest: Optional[torch.Tensor] = None,
    lantern: LanternSpec = LanternSpec(),
    node_q: Optional[torch.Tensor] = None,
    level_probs: Optional[Sequence[torch.Tensor]] = None,
    node_level_row: Optional[torch.Tensor] = None,
    rt: Optional[LanternRT] = None,
    batch_warp: Optional[bool] = None,
):
    """``stochastic_verify_tree`` as fixed-shape tensor ops with no host
    read: every child of every level is evaluated, and the result selected
    by masks.  ``batch_warp`` warps all rows at once (default: when
    ``N+1 x V`` is at most 2^20)."""
    N1, V = node_logits.shape
    C = children.shape[1]
    dev = node_logits.device
    multidraft = node_q is not None
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
        u = uniforms[i - 1]
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
                jstar = _budget(cum[None, :], px[None], lantern, rt)[0]
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
                        _lantern_zero_mask(nearest, x, jstar, lantern, rt, V),
                        torch.zeros_like(q), q)
                new_gtp = torch.clamp(gtp - q, min=0.0)
            else:
                new_gtp = gtp.index_fill(0, x[None], 0.0)
                if lantern.enabled:
                    new_gtp = torch.where(
                        _lantern_zero_mask(nearest, x, jstar, lantern, rt, V),
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


MAX_WALK_LEVELS = 16        # csrc/tree_walk.cu: MAX_LEVELS
MAX_WALK_CHILDREN = 32      # csrc/tree_walk.cu: MAX_CHILDREN


def _ragged_rows(t: torch.Tensor, ld: int) -> torch.Tensor:
    """``t`` [n, V] as rows ``ld`` floats apart from a 16-byte aligned
    start, as K5 reads a vocabulary that is no multiple of 4: ``t`` itself
    where it is laid out so, else a copy into a padded buffer (one row for
    a broadcast row).  The pads are never read as entries."""
    n, V = t.shape
    if t.stride(1) == 1 and t.stride(0) == ld and _cuda.aligned(t):
        return t
    src = t[:1] if t.stride(0) == 0 else t
    buf = torch.empty((src.shape[0], ld), dtype=t.dtype, device=t.device)
    buf[:, :V] = src
    return buf[:, :V].expand(n, V) if t.stride(0) == 0 else buf[:, :V]



def stochastic_verify_tree_cuda(
    node_logits: torch.Tensor,      # [N+1, V] f32
    tree_tokens: torch.Tensor,      # [N+1] int32 / int64
    children: torch.Tensor,         # [N+1, C] int32 / int64
    depth: int,
    warp: LogitsWarp,
    uniforms: torch.Tensor,         # [depth, C] f32
    nearest: Optional[torch.Tensor] = None,
    lantern: LanternSpec = LanternSpec(),
    node_q: Optional[torch.Tensor] = None,
    level_probs: Optional[Sequence[torch.Tensor]] = None,
    node_level_row: Optional[torch.Tensor] = None,
    rt: Optional[LanternRT] = None,
):
    """K5 on the card: the whole walk in one launch of one thread block
    (``csrc/tree_walk.cu``), with the plain version's rule and f32
    arithmetic.  The rows are scaled by the temperature here (torch's own
    division); top-k's threshold is selected in the kernel, top-p's comes
    from ``keep_threshold`` over all rows.  Nothing is read back to the
    host; the level rows are passed as pointers, not stacked.  A vocabulary
    that is no multiple of 4 goes in rows padded to the next one
    (``_ragged_rows``), whose pads the kernel masks: nothing outside the V
    columns is kept, summed or written to the bonus row."""
    _cuda.no_autograd("tree_walk", node_logits, node_q,
                      *(level_probs or ()))
    req = _cuda.require
    N1, V = node_logits.shape
    C = children.shape[1]
    dev = node_logits.device
    multidraft = node_q is not None
    # rows ld floats apart: V itself, or the next multiple of 4 (ragged)
    ld = -(-V // 4) * 4
    req(node_logits.dtype == torch.float32 and node_logits.is_contiguous()
        and _cuda.aligned(node_logits),
        f"tree_walk: logits must be contiguous, 16-byte aligned f32 [N+1, V], "
        f"got {node_logits.dtype} {tuple(node_logits.shape)}")
    req(1 <= C <= MAX_WALK_CHILDREN and 0 <= depth <= MAX_WALK_LEVELS,
        f"tree_walk: {C} children a node (at most {MAX_WALK_CHILDREN}) and "
        f"depth {depth} (at most {MAX_WALK_LEVELS})")
    req(tuple(tree_tokens.shape) == (N1,)
        and tuple(children.shape) == (N1, C),
        f"tree_walk: tokens {tuple(tree_tokens.shape)} and children "
        f"{tuple(children.shape)} do not fit {N1} nodes")
    req(uniforms.dtype == torch.float32 and uniforms.is_contiguous()
        and tuple(uniforms.shape) == (depth, C),
        f"tree_walk: coins must be contiguous f32 [{depth}, {C}]")
    index = (tree_tokens, children, node_level_row,
             nearest if lantern.enabled else None)
    for t in index:
        req(t is None or (t.dtype in (torch.int32, torch.int64)
                          and t.is_contiguous()),
            "tree_walk: index tensors must be contiguous int32 or int64")
    lp = []
    if multidraft:
        req(node_q.dtype == torch.float32 and node_q.is_contiguous()
            and tuple(node_q.shape) == (N1,) and node_level_row is not None
            and tuple(node_level_row.shape) == (N1,),
            "tree_walk: multi-draft needs f32 node_q and node_level_row "
            f"[{N1}]")
        req(level_probs is not None and len(level_probs) >= depth,
            f"tree_walk: {depth} levels need as many drafter rows")
        lp = list(level_probs[:depth])
        for t in lp:
            req(t.dtype == torch.float32 and t.ndim == 2
                and t.shape[1] == V and t.stride(1) == 1
                and (ld != V or (t.stride(0) % 4 == 0 and _cuda.aligned(t)))
                and t.shape[0] >= 1,
                f"tree_walk: drafter rows must be f32 [rows, {V}], 16-byte "
                f"aligned, with contiguous columns")
        if ld != V:
            lp = [_ragged_rows(t, ld) for t in lp]
    if lantern.enabled:
        req(nearest.ndim == 2 and nearest.shape[0] == V,
            f"tree_walk: nearest must be [{V}, nn]")
        if rt is not None:
            req(rt.k.dtype == torch.int32 and rt.delta.dtype == torch.float32,
                "tree_walk: LanternRT must be an int32 k and an f32 delta")
    rows = node_logits
    top_k, thr = 0, None
    if warp.active:
        if warp.temperature != 1.0:
            rows = node_logits / warp.temperature
        if 0.0 < warp.top_p < 1.0:
            thr = keep_threshold(rows, dataclasses.replace(warp,
                                                           temperature=1.0))
        elif 0 < warp.top_k < V:
            top_k = warp.top_k
    if ld != V:
        rows = _ragged_rows(rows, ld)
    rtk = rt.k if lantern.enabled and rt is not None else None
    rtd = rt.delta if lantern.enabled and rt is not None else None
    dist = torch.empty((ld,), dtype=torch.float32, device=dev)
    path = torch.empty((depth + 2,), dtype=torch.int32, device=dev)
    _cuda.library().tree_walk(
        rows, thr, tree_tokens, children, uniforms, node_q, lp,
        node_level_row if multidraft else None,
        nearest if lantern.enabled else None, rtk, rtd, dist, path, depth,
        lantern.k if lantern.enabled else 0, float(lantern.delta),
        float(lantern.delta) - 1.0, float(lantern.delta) > 1.0, top_k)
    _cuda.LAUNCHES["tree_walk"] += 1
    return path[: depth + 1], path[depth + 1], dist[:V]
