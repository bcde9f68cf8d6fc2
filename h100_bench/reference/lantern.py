"""LANTERN's relaxed acceptance, worked out again: the latent
neighbourhoods from the codebook's latents, the sampling distribution of a
row, and the acceptance walk over a draft tree replayed with the walk's own
coins.

The walk (LANTERN over multi-draft rejection sampling) visits the tree from
the root: at each level it tries the children of the node it stands on in
order, skipping an empty slot, a token an earlier sibling carries and a
draft of probability 0; it accepts child ``x`` when its coin ``u`` is at most
``p'(x) / q(x)``, where ``q(x)`` is the draft's probability of ``x`` and
``p'(x)`` the relaxed probability: ``p(x)`` plus the cumulative mass of
``x``'s nearest latent neighbours for as many as keep that mass within the
budget (``(delta - 1) p(x)`` for ``delta > 1``, else ``delta``).  A refused
child leaves the residual ``max(p - q', 0)``, renormalised, for the next:
``q'`` is the draft distribution (drafted stale: the row that predicted the
step's root, as the grammar leaves it at the child's place) with the
earlier siblings' tokens removed (renormalised after the first), and with
``x``'s first ``k + 1`` neighbours removed where the budget took any.
It stops at the first level where no child is accepted.
"""

from __future__ import annotations

import numpy as np
import torch

def nearest(latents: torch.Tensor, k: int, rows: int = 1024) -> torch.Tensor:
    """Each code's ``k`` nearest other codes by L2 distance (float64, in
    blocks of ``rows`` codes), nearest first."""
    cb = latents.double()
    out = []
    for a in range(0, cb.shape[0], rows):
        d2 = torch.cdist(cb[a:a + rows], cb)
        i = torch.arange(a, a + d2.shape[0], device=cb.device)
        d2[i - a, i] = float("inf")
        out.append(torch.topk(-d2, k, dim=-1).indices)
    return torch.cat(out)


def warped(rows: torch.Tensor, top_k: int, temperature: float) -> torch.Tensor:
    """The sampling distribution of each logits row [n, C]: temperature,
    then every logit below the ``top_k``-th largest dropped (ties kept)."""
    x = rows.float() / temperature
    if 0 < top_k < x.shape[-1]:
        kth = torch.topk(x, top_k, dim=-1).values[:, -1:]
        x = torch.where(x < kth, torch.full_like(x, -float("inf")), x)
    return torch.softmax(x, dim=-1)


def support_rank(ref: torch.Tensor, cols: torch.Tensor,
                 rows: int = 256) -> torch.Tensor:
    """Per row of ``ref`` [n, C], the rank (0: the best) of column
    ``cols[i]`` under the row's logits."""
    out = []
    for a in range(0, ref.shape[0], rows):
        r = ref[a:a + rows]
        v = torch.gather(r, 1, cols[a:a + rows, None])
        out.append((r > v).sum(-1))
    return torch.cat(out) if out else ref.new_zeros(0, dtype=torch.long)


class Walk:
    """One request's walks, replayed against the reference.

    ``probs`` [n_served, C] float64 is the reference's sampling
    distribution of the row predicting each served token, over the image
    columns ``lo .. lo + C - 1`` of a ``V``-token vocabulary; ``forced``
    [n_served] the token the image grammar forces at a served index (a row
    end, the image's end), or -1; ``near`` [C, >= k + 1] the image columns'
    neighbours."""

    def __init__(self, probs, forced, near, lo: int, V: int, k: int,
                 delta: float):
        self.P, self.forced, self.near = probs, forced, near
        self.lo, self.V, self.k, self.delta = lo, V, k, delta
        self.C = probs.shape[1]

    def dist(self, row: int, at: int) -> np.ndarray:
        """Over the vocabulary: row ``row``'s distribution as the grammar
        leaves it for served index ``at``."""
        p = np.zeros(self.V)
        if self.forced[at] >= 0:
            p[self.forced[at]] = 1.0
        else:
            p[self.lo:self.lo + self.C] = self.P[row]
        return p

    def neighbours(self, x: int, m: int) -> np.ndarray:
        c = x - self.lo
        if 0 <= c < self.C:
            return self.near[c, :m] + self.lo
        return np.zeros(0, np.int64)

    def relaxed(self, p: np.ndarray, x: int):
        """``(p'(x), the budget reached any neighbour)``."""
        px = p[x]
        cum = np.cumsum(p[self.neighbours(x, self.k)])
        ok = cum <= ((self.delta - 1.0) * px if self.delta > 1.0
                     else self.delta)
        if not ok.any():
            return px, False
        return px + cum[np.nonzero(ok)[0][-1]], True

    def step(self, rec: dict, coins: np.ndarray):
        """One verify step's decisions (``rec`` as the program's capture
        keeps it: ``n``, ``alen``, ``depth``, ``tokens``, ``children``,
        ``q``, ``sel``) replayed with the coins [depth, children] its walk
        drew: for each draft the program tried, whether the relaxed rule
        with that coin decides otherwise on the reference's distribution
        (the program took it and ``u q(x) > p'(x)``, or refused it and ``u
        q(x) <= p'(x)``).  A sound walk flips a decision only where its
        probability rounds across the coin; a draft taken where the walk
        could not take it counts as a flip."""
        n, alen, sel = rec["n"], rec["alen"], rec["sel"]
        toks, kids_all, q = rec["tokens"], rec["children"], rec["q"]
        out = []
        cur = 0
        for i in range(1, rec["depth"] + 1):
            at = n + i
            if at >= len(self.forced):
                break                      # past what the request served
            took = int(sel[i]) if i <= alen else -1
            p = self.dist(at, at)
            kids = kids_all[cur]
            ktok = np.where(kids >= 0, toks[np.maximum(kids, 0)], -1)
            hit = False
            for c in range(len(kids)):
                child = int(kids[c])
                if child < 0:
                    continue
                qx = float(q[child])
                if qx <= 0 or any(ktok[e] == ktok[c] for e in range(c)
                                  if kids[e] >= 0):
                    continue
                x = int(ktok[c])
                pr, budget = self.relaxed(p, x)
                uq = coins[i - 1, c] * qx
                if child == took:
                    out.append(bool(uq > pr))
                    hit = True
                    break
                out.append(bool(uq <= pr))
                # the residual for the next sibling
                qv = self.dist(n, at)
                for e in range(c):
                    if kids[e] >= 0:
                        qv[ktok[e]] = 0.0
                if c > 0:
                    qv = qv / max(qv.sum(), 1e-30)
                if budget:
                    qv[self.neighbours(x, self.k + 1)] = 0.0
                p = np.maximum(p - qv, 0.0)
                p = p / p.sum() if p.sum() > 0 else np.full(self.V,
                                                            1.0 / self.V)
            if took >= 0 and not hit:
                out.append(True)
            if took < 0 or not hit:
                break
            cur = took
        return out


def coins(state: torch.Tensor, depth: int, width: int, device) -> np.ndarray:
    """The walk's coins [depth, width]: one uniform draw of ``width`` a
    level from the request's random stream at ``state``, as the walk draws
    them."""
    g = torch.Generator(device=device)
    g.set_state(state)
    u = [torch.rand((width,), generator=g, device=device)
         for _ in range(depth)]
    return torch.stack(u).double().cpu().numpy()
