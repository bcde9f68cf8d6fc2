"""Batched speculative decoding: R concurrent requests in one verify forward.

Counterpart of ``lantern_tpu/engine/batch.py``.  Single-request decode reads
every base weight once a verify step; batching R requests amortizes that
read R ways, which is what continuous batching buys a server.

Design (static EAGLE-1 and dynamic EAGLE-2 trees; see the JAX module for
the vmap form):

- **One base forward for all slots.**  The base cache folds the slots into
  its batch axis, ``B = 2R``: slot ``r`` owns rows ``2r`` (cond) and
  ``2r + 1`` (uncond), each row at its own length (``KVCache.length``
  ``[2R]``).  A step runs ``spec.verify_forward`` once over the 2R rows: per
  layer one launch of the attention kernel (K2) and four of the matmul
  (K1, ``ceil(2R * (N+1) / 64)`` launches each), then one block write (K3),
  and after the acceptance one rollback gather (K4) with a start and an
  accepted path per row.  The JAX engine vmaps the whole step and stacks
  the caches slot-major instead; the port keeps every layer's planes one
  contiguous ``[2R, G, S, W]`` tensor, which K2 reads.
- **Per-request glue per slot.**  Each slot keeps its own ``SpecState``
  (draft, root token, token stream, counters, the drafter's one-layer
  cache), its own ``_Ctx`` (pad mask, position offsets, the grid FSM bound
  to its own start, and its own ``torch.Generator``) and runs
  ``spec.accept``, ``spec.advance`` and ``spec.next_static_draft`` in a
  host loop over the slots: the acceptance walk, sampling, the FSM, and
  the drafter's forwards (``extend`` and the tree levels, one request at a
  time, R times the single-request drafter's launches).  A slot draws from
  its generator in the single-request engine's order, so its tokens equal
  a lone run's.
- **Dynamic trees.**  Each slot drafts a tree of its own shape
  (``draft_dynamic``), but every tree has ``total_tokens`` nodes, so the
  verify forward stays one launch of K2 a layer: it takes the slots'
  ancestor masks as one ``[2R, N+1, N+1]`` block mask and their node
  depths as ``[R, N+1]`` positions.  The commit is one K4 launch with a
  start and a path per row, as in static mode.
- **Freezing.**  A finished slot (``n_new >= max_new`` or stopped; an empty
  slot carries ``n_new = 1 << 30``) still rides through the forward and
  the glue, and its result is masked back: its cheap leaves and its KV
  lengths keep their old values (``torch.where``), its K4 commit count is
  0, and its cache rows past its length are scribble space that attention
  masks and later writes cover.  No KV plane is copied to freeze a slot.
- No step reads anything back to the host, so ``step_many(n)`` is n steps
  without a sync; ``slot_status`` is one fetch.

- **Mesh.**  ``mesh`` (``parallel.mesh.make_mesh``) serves over a (dp, tp)
  process mesh: each dp row holds ``num_slots / dp`` slots (``slots``),
  with the base weights and KV over its tp ranks (shard ``params`` with
  ``parallel.mesh.shard_pytree`` first) and the drafter replicated; the
  engine runs its forwards under ``set_mesh(mesh)``.  ``Scheduler`` deals
  the requests over dp and gathers the results.

Not ported here: ``deferred_commit`` (the JAX engine rejects it too).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..configs import DrafterConfig, ModelConfig
from ..device import resolve_device
from ..kv import KVCache
from ..models import drafter as drf
from ..models import transformer as tfm
from ..parallel.mesh import set_mesh
from ..trees import TreeSpec
from . import spec
from .spec import SpecDecodeConfig, SpecState, _Ctx

# n_new of an empty slot: past any max_new, so the slot stays frozen
EMPTY = 1 << 30


@dataclasses.dataclass
class Batch:
    """The state of R slots."""
    base_kv: KVCache               # [L, 2R, G, S, W]; length [2R]
    prefix_valid: torch.Tensor     # [2R, S] bool pad mask, per row
    pos_offsets: torch.Tensor      # [2R] int32 position shift, per row
    states: List[SpecState]        # per slot (``base_kv`` None: it is above)
    ctxs: List[_Ctx]               # per slot


def _clone_state(state: SpecState) -> SpecState:
    """A copy of a request's per-slot leaves with buffers of its own."""
    def c(x):
        return None if x is None else x.clone()

    dkv = state.draft_kv
    if dkv is not None:
        dkv = KVCache(k=c(dkv.k), v=c(dkv.v), length=c(dkv.length),
                      k_scale=c(dkv.k_scale), v_scale=c(dkv.v_scale))
    d = state.draft
    if isinstance(d, drf.DynamicDraft):
        draft = drf.DynamicDraft(*(c(x) for x in d))
    else:
        draft = drf.StaticDraft(ss_token=c(d.ss_token), ss_prob=c(d.ss_prob),
                                level_probs=tuple(c(p) for p in
                                                  d.level_probs))
    return state._replace(
        base_kv=None, draft_kv=dkv, draft=draft, root_token=c(state.root_token),
        tokens=c(state.tokens), n_new=torch.full_like(state.n_new, EMPTY),
        steps=c(state.steps), accept_sum=c(state.accept_sum),
        stopped=c(state.stopped))


def _freeze(active: torch.Tensor, old: SpecState,
            new: SpecState) -> SpecState:
    """``new`` where the slot was active at the step's start, else ``old``:
    the cheap leaves and the drafter cache's length only (its buffers were
    written in place above its length)."""
    def sel(a, b):
        return torch.where(active, b, a)

    d0, d1 = old.draft, new.draft
    if isinstance(d0, drf.DynamicDraft):
        draft = drf.DynamicDraft(*(sel(a, b) for a, b in zip(d0, d1)))
    else:
        draft = drf.StaticDraft(
            ss_token=sel(d0.ss_token, d1.ss_token),
            ss_prob=sel(d0.ss_prob, d1.ss_prob),
            level_probs=tuple(sel(a, b) for a, b in zip(d0.level_probs,
                                                        d1.level_probs)))
    dkv = new.draft_kv
    if dkv is not None:
        dkv = dataclasses.replace(dkv, length=sel(old.draft_kv.length,
                                                  dkv.length))
    return new._replace(
        draft=draft, draft_kv=dkv, root_token=sel(old.root_token,
                                                  new.root_token),
        tokens=sel(old.tokens, new.tokens), n_new=sel(old.n_new, new.n_new),
        steps=sel(old.steps, new.steps),
        accept_sum=sel(old.accept_sum, new.accept_sum),
        stopped=sel(old.stopped, new.stopped))


@dataclasses.dataclass
class BatchedEngine:
    """R-slot continuous-batching speculative decoder (static or dynamic
    trees, ``ecfg.mode``).

    ``tree``: the static draft tree (unused in dynamic mode);
    ``dparams``/``dcfg``: the EAGLE drafter, needed unless
    ``ecfg.stale_draft``; ``logits_fn``: a grid FSM (each slot binds its
    own start, ``spec.bind_logits_fn``); ``device``: ``None`` is
    ``cuda``; ``mesh``: a (dp, tp) ``parallel.mesh.Mesh`` (``num_slots``
    must be a multiple of its dp size; this rank serves ``slots`` of
    them)."""

    ecfg: SpecDecodeConfig
    cfg: ModelConfig
    tree: TreeSpec
    params: dict
    num_slots: int
    dparams: Optional[dict] = None
    dcfg: Optional[DrafterConfig] = None
    logits_mask: Optional[torch.Tensor] = None
    logits_fn: object = None
    device: object = None
    mesh: object = None

    def __post_init__(self):
        if self.ecfg.deferred_commit:
            raise ValueError("deferred_commit is unsupported in BatchedEngine "
                             "(as in the JAX engine): the batched step "
                             "commits by rollback")
        if self.ecfg.mode not in ("static", "dynamic"):
            raise ValueError(f"mode must be 'static' or 'dynamic', got "
                             f"{self.ecfg.mode!r}")
        if self.ecfg.mode == "dynamic" and self.ecfg.stale_draft:
            raise ValueError("stale_draft requires mode='static'")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        dp = 1 if self.mesh is None else self.mesh.dp
        if self.num_slots % dp:
            raise ValueError(
                f"num_slots {self.num_slots} must be a multiple of the "
                f"mesh dp size {dp}")
        self.device = resolve_device(self.device)
        self._tree = (spec.static_tree(self.tree, self.device)
                      if self.ecfg.mode == "static" else None)
        self._rope = tfm.make_rope_tables(self.cfg, self.device)

    @property
    def slots(self) -> int:
        """The slots this rank serves: ``num_slots / dp``."""
        return self.num_slots // (1 if self.mesh is None else self.mesh.dp)

    def _on_mesh(self):
        return (contextlib.nullcontext() if self.mesh is None
                else set_mesh(self.mesh))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def prefill(self, cond=None, uncond=None,
                generator: Optional[torch.Generator] = None,
                token_prompt=None, prefix_valid=None):
        """Prefill one request -> ``(SpecState, _Ctx)``, as
        ``spec.prefill_request`` (its draws come from ``generator``)."""
        with self._on_mesh():
            return spec.prefill_request(
                self.params, self.ecfg, self.cfg, self.tree, token_prompt,
                generator, logits_mask=self.logits_mask,
                logits_fn=self.logits_fn, device=self.device,
                dparams=self.dparams, dcfg=self.dcfg, cond=cond,
                uncond=uncond, prefix_valid=prefix_valid)

    def empty_batch(self, proto) -> Batch:
        """R empty slots shaped like the prefilled request ``proto``: a base
        cache ALLOCATED for 2R rows (lengths 0), and per slot copies of the
        proto's leaves marked finished (``n_new = 1 << 30``), each with a
        drafter cache and (under sampling) a generator of its own, so that
        steps leave them frozen until ``insert`` fills them."""
        state, ctx = proto
        R, dev = self.slots, self.device
        base = KVCache.create(self.cfg, 2 * R, max_len=state.base_kv.max_len,
                              quantized=self.ecfg.kv_quant, device=dev,
                              row_lengths=True,
                              groups=tfm.cache_groups(self.cfg, self.params))
        S = base.max_len

        def idle_ctx():
            g = ctx.generator
            if g is not None:
                g = torch.Generator(device=g.device).manual_seed(0)
            return ctx._replace(generator=g)

        return Batch(
            base_kv=base,
            prefix_valid=torch.ones((2 * R, S), dtype=torch.bool, device=dev),
            pos_offsets=torch.zeros((2 * R,), dtype=torch.int32, device=dev),
            states=[_clone_state(state) for _ in range(R)],
            ctxs=[idle_ctx() for _ in range(R)])

    @torch.no_grad()
    def insert(self, batch: Batch, slot: int, request) -> Batch:
        """Write a prefilled request into slot ``slot``: its cache rows into
        batch rows ``2 * slot`` and ``2 * slot + 1`` (``index_copy_``), its
        pad mask and offsets, its leaves and its context."""
        state, ctx = request
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} outside [0, {self.slots})")
        r0 = 2 * slot
        batch.base_kv = batch.base_kv.put_rows(r0, state.base_kv)
        batch.prefix_valid[r0:r0 + 2] = ctx.prefix_valid
        batch.pos_offsets[r0:r0 + 2] = ctx.pos_offsets
        batch.states[slot] = state._replace(base_kv=None)
        batch.ctxs[slot] = ctx
        return batch

    @torch.no_grad()
    def step(self, batch: Batch) -> Batch:
        """One speculative step of every slot (finished slots stay frozen);
        updates ``batch`` in place and returns it."""
        with self._on_mesh():
            return self._step(batch)

    def _step(self, batch: Batch) -> Batch:
        ecfg, tree = self.ecfg, self._tree
        R = self.slots
        kv = batch.base_kv
        if tree is not None:
            blocks = [spec.static_tree_block(ecfg, tree, st)
                      for st in batch.states]
            mask, pos = tree.mask, tree.depth
        else:
            # every slot's own tree, one node count: one [2R, N+1, N+1]
            # block mask and [R, N+1] depths for the single verify forward
            blocks = [spec.dynamic_tree_block(self.dcfg, st)
                      for st in batch.states]
            mask = torch.stack([b.mask for b in blocks])
            pos = torch.stack([b.pos for b in blocks])
        N1 = blocks[0].tokens.shape[0]
        res, logits_raw = spec.verify_forward(
            ecfg, self.cfg, self.params, self._rope, kv,
            torch.stack([b.tokens for b in blocks]), mask, pos,
            batch.prefix_valid, batch.pos_offsets, kv.length)
        verdicts = [spec.accept(ecfg, batch.ctxs[r], blocks[r], logits_raw[r],
                                kv.length[2 * r]) for r in range(R)]
        active = torch.stack([(st.n_new < ecfg.max_new) & ~st.stopped
                              for st in batch.states])                # [R]
        n_acc = torch.stack([v.n_acc for v in verdicts])
        commit = torch.where(active, n_acc, torch.zeros_like(n_acc))
        # one K4 launch: every row compacts its own accepted path at its
        # own length; a frozen slot's rows move above its length and its
        # length stays
        kv = res.kv.accept_path(
            torch.stack([v.sel_slots for v in verdicts]).repeat_interleave(
                2, dim=0), commit.repeat_interleave(2), block_size=N1)
        for r in range(R):
            old, ctx = batch.states[r], batch.ctxs[r]
            new, root_out = spec.advance(ecfg, ctx, old, blocks[r],
                                         verdicts[r], logits_raw[r],
                                         res.hidden[2 * r:2 * r + 2])
            if tree is not None:
                new = spec.next_static_draft(ecfg, self.tree, ctx, new,
                                             root_out, kv.length[2 * r])
            else:
                new = spec.next_dynamic_draft(ecfg, ctx, new, root_out)
            batch.states[r] = _freeze(active[r], old, new)
        batch.base_kv = kv
        return batch

    @torch.no_grad()
    def step_many(self, batch: Batch, n: int) -> Batch:
        """``n`` steps with no host readback between them."""
        for _ in range(n):
            batch = self.step(batch)
        return batch

    # -- host-side ---------------------------------------------------------
    def slot_status(self, batch: Batch):
        """(n_new, steps, accept_sum) per slot as numpy, in one device
        fetch.  With ``ecfg.stop_ids``, stopped slots report ``n_new`` as
        ``max_new`` so schedulers see them as done."""
        st = torch.stack([x.to(torch.int32) for s in batch.states
                          for x in (s.n_new, s.steps, s.accept_sum,
                                    s.stopped)]).reshape(-1, 4).cpu().numpy()
        n_new, steps, acc, stopped = st.T
        if self.ecfg.stop_ids:
            n_new = np.where(stopped != 0, self.ecfg.max_new, n_new)
        return n_new, steps, acc

    def slot_tokens(self, batch: Batch, slot: int) -> np.ndarray:
        """The slot's committed stream, truncated at the first stop id when
        ``ecfg.stop_ids`` is set."""
        toks = batch.states[slot].tokens[: self.ecfg.max_new].cpu().numpy()
        if self.ecfg.stop_ids:
            hit = np.isin(toks, np.asarray(self.ecfg.stop_ids))
            if hit.any():
                toks = toks[: int(np.argmax(hit)) + 1]
        return toks
