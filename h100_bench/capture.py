"""What the timed path produces, kept for the comparison that decides
``correct``.

The program's logits are its output: every verify step's CFG-combined
logits feed the acceptance walk and the sampling, and every lockstep AR
step's feed the sampling.  ``Capture`` wraps the two calls that receive
them, ``engine.spec.accept`` (one request's acceptance in
``BatchedEngine.step``) and ``engine.ar._sample_rows`` (a lockstep AR
step's sampling), and for the requests drawn for the check keeps, on the
device and without a host read, the 8 largest image-token logits of each
row that predicts a served token, with their columns.  For each verify
step it also keeps what the acceptance walk was handed and what it chose:
the state of the request's random stream on entry (the walk draws its
coins from it), the draft tree's tokens, child slots and draft
probabilities, and the accepted path.  A request is known by its random
stream's seed (``Generator.initial_seed``), which the scheduler and the
sessions derive from the request's own seed.

A verify step's accepted path ``sel_slots[:n_acc]`` starts at the root,
which is the request's served token ``n``; its row ``j`` predicts served
token ``n + j + 1``.  A lockstep AR step's row predicts the next served
token, the prefill's the first.
"""

from __future__ import annotations

from typing import Dict, Set

import numpy as np
import torch

TOP = 8


class Capture:
    def __init__(self, cols: slice):
        self.cols = cols
        self.want: Set[int] = set()
        self.spec: Dict[int, list] = {}      # seed -> [(vals, idx, n_acc,
        #                                      walk)]
        self.ar: Dict[int, list] = {}        # seed -> [(vals, idx)]
        self._undo = []

    def watch(self, seeds) -> None:
        self.want.update(int(s) for s in seeds)

    def _top(self, rows: torch.Tensor):
        v, i = torch.topk(rows[..., self.cols].float(), TOP, dim=-1)
        return v, i.to(torch.int32)

    def install(self):
        from lantern_tpu_torch.engine import ar, spec

        accept, sample = spec.accept, ar._sample_rows

        def accept_wrapped(ecfg, ctx, blk, logits_raw, eff_len):
            g = ctx.generator
            if g is None or g.initial_seed() not in self.want:
                return accept(ecfg, ctx, blk, logits_raw, eff_len)
            state = g.get_state()
            v = accept(ecfg, ctx, blk, logits_raw, eff_len)
            vals, idx = self._top(logits_raw.index_select(
                0, v.sel_slots.long()))
            walk = dict(state=state, depth=blk.max_depth,
                        tokens=blk.tokens.clone(),
                        children=blk.children.clone(),
                        q=blk.node_q.clone(),
                        sel=v.sel_slots.clone())
            self.spec.setdefault(g.initial_seed(), []).append(
                (vals, idx, v.n_acc, walk))
            return v

        def sample_wrapped(generators, logits, warp):
            if generators is not None:
                for r, g in enumerate(generators):
                    if g.initial_seed() in self.want:
                        self.ar.setdefault(g.initial_seed(), []).append(
                            self._top(logits[r:r + 1])[:2])
            return sample(generators, logits, warp)

        spec.accept, ar._sample_rows = accept_wrapped, sample_wrapped
        self._undo.append(lambda: (setattr(spec, "accept", accept),
                                   setattr(ar, "_sample_rows", sample)))
        return self

    def uninstall(self) -> None:
        while self._undo:
            self._undo.pop()()

    def rows_of(self, seed: int, n_served: int) -> dict:
        """On the host: ``index`` [m], the served-token indices whose
        predicting rows were captured, ``vals`` / ``cols`` [m, TOP], the
        program's largest logits there and their columns (within
        ``cols``), ``sampled`` [n_served], which served tokens were sampled
        from their own row (a verify step's root, the bonus of the step
        before; every lockstep AR token) rather than accepted from the
        draft, and ``walk``, each verify step's walk record with ``n``, the
        served index of its root, and ``alen``, the drafts it accepted."""
        index, vals, cols, walks = [], [], [], []
        sampled = np.ones(n_served, bool)
        if seed in self.spec:
            # a verify step's rows; the first served token came from the
            # prefill, whose row is not captured
            recs = self.spec[seed]
            n_acc = torch.stack([r[2] for r in recs]).cpu().numpy()
            n = 0
            sampled[:] = False
            sampled[:1] = True
            for (v, i, _, w), a in zip(recs, n_acc):
                a = int(a)
                walks.append(dict(
                    {k: (x.cpu().numpy() if torch.is_tensor(x)
                         and k != "state" else x) for k, x in w.items()},
                    n=n, alen=a - 1))
                if n + a < n_served:
                    sampled[n + a] = True
                for j in range(a):
                    k = n + j + 1
                    if k < n_served:
                        index.append(k)
                        vals.append(v[j])
                        cols.append(i[j])
                n += a
                if n >= n_served:
                    break       # the slot is done: later steps are frozen
        elif seed in self.ar:
            for k, (v, i) in enumerate(self.ar[seed][:n_served]):
                index.append(k)
                vals.append(v[0])
                cols.append(i[0])
        out = dict(index=np.asarray(index, np.int64), vals=None, cols=None,
                   sampled=sampled, walk=walks)
        if index:
            out.update(vals=torch.stack(vals).cpu().numpy(),
                       cols=torch.stack(cols).cpu().numpy().astype(np.int64))
        return out
