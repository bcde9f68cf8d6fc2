"""Full-model finetuning in PyTorch.

Counterpart of ``lantern_tpu/train/finetune.py`` (the xllmx
FinetuneSolverBase equivalent):

- next-token cross entropy over ``(tokens, loss_mask)`` with an optional
  conditioning prefix (``cond``: class labels or caption features) and a
  token-aligned pad mask, plus an optional z-loss;
- ``transformer.forward_train`` with each layer recomputed in the backward
  (``remat``), the reference's gradient-checkpointing wrap policy;
- optax's optimizer (``train.optim``): global-norm clip, then AdamW with a
  first moment in f32 beside bf16 parameters (``mu_dtype``), weight decay
  only on 2-D+ kernels (``_decay_mask``: no norms, biases or embeddings),
  linear warmup then cosine decay (``lr_schedule``);
- checkpoints ``step_XXXXXXXX`` through ``utils.checkpoint.save_pytree``,
  the newest ``keep_last`` kept, resumed from the newest; an FSDP state is
  gathered and written whole by one rank, and restored into any sharding
  (orbax's global arrays), so one file serves FSDP and one process alike;
- FSDP, the reference's FULL_SHARD (the JAX module's
  ``fsdp_param_specs``), over a ``(dp, tp)`` mesh of processes
  (``parallel/mesh.make_mesh``): ``init_state(..., mesh=)`` keeps each
  rank's contiguous slice, along the dim ``fsdp_param_specs`` picks, of
  every split leaf and of its AdamW moments; ``train_step(..., mesh=)``
  gathers a layer's weights when the layer runs (its backward
  reduce-scatters their gradients over tp), gives each of the ``dp x tp``
  ranks its own rows of the batch, sums the gradients over dp, and clips
  by the whole model's gradient norm.  Every rank returns the
  one-process loss, accuracy and gradient norm.

``train_step`` updates the state's parameters in place.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import NamedTuple, Optional

import torch
import torch.distributed as tdist

from ..configs import ModelConfig
from ..models import transformer as tfm
from ..parallel import dist as pdist
from ..parallel.mesh import TP, Mesh
from ..utils.checkpoint import restore_pytree, save_pytree
from .optim import AdamState, AdamW, clip_by_norm_, flatten, global_norm
from .optim import unflatten, warmup_cosine_decay_schedule


@dataclasses.dataclass(frozen=True)
class FinetuneConfig:
    lr: float = 2e-5
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    weight_decay: float = 0.1
    betas: tuple = (0.9, 0.95)
    grad_clip_norm: float = 1.0
    remat: bool = True
    z_loss: float = 0.0            # optional logit regularizer


def _decay_mask(params: dict) -> dict:
    """True where weight decay applies: 2-D+ kernels; norms, biases and
    embeddings excluded (xllmx/util/misc.py:154-200 semantics).  The same
    nesting as ``params``."""
    paths, leaves = flatten(params)

    def on(name: str, leaf: torch.Tensor) -> bool:
        if "norm" in name or name.endswith("b") or "bias" in name:
            return False
        if "embed" in name or name == "cond/uncond":
            return False
        return leaf.ndim >= 2

    return unflatten(params, paths,
                     [on(n, x) for n, x in zip(paths, leaves)])


def lr_schedule(cfg: FinetuneConfig):
    return warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.lr,
        warmup_steps=max(cfg.warmup_steps, 1),
        decay_steps=max(cfg.total_steps, cfg.warmup_steps + 1),
        end_value=cfg.lr * cfg.min_lr_ratio)


def build_optimizer(cfg: FinetuneConfig, params: dict) -> AdamW:
    return AdamW(lr=lr_schedule(cfg), b1=cfg.betas[0], b2=cfg.betas[1],
                 weight_decay=cfg.weight_decay,
                 decay_mask=flatten(_decay_mask(params))[1],
                 mu_dtype=torch.float32, clip_norm=cfg.grad_clip_norm)


class FinetuneState(NamedTuple):
    params: dict
    opt_state: AdamState
    step: int
    # FSDP: ``fsdp_param_specs`` of the whole leaves (``params`` holds this
    # rank's slices of them); None for an unsharded state
    specs: Optional[dict] = None


def init_state(params: dict, fcfg: FinetuneConfig,
               mesh: Optional[Mesh] = None) -> FinetuneState:
    """A fresh state.  With ``mesh`` (FSDP) ``params`` are the whole leaves
    and the state keeps this rank's slices of them (copies: the whole tree
    can be freed) with AdamW moments of the slices' shapes."""
    specs = None
    if mesh is not None:
        specs = fsdp_param_specs(params, mesh)
        params = fsdp_shard(params, specs, mesh)
    return FinetuneState(
        params=params,
        opt_state=build_optimizer(fcfg, params).init(flatten(params)[1]),
        step=0, specs=specs)


def ce_sums(params, hidden, tokens, loss_mask, z_loss: float = 0.0):
    """The next-token cross entropy's sums over ``hidden`` [B, T, H]
    (position t predicts token t+1): ``(nll, z, hits, count)``, the masked
    NLL sum, the masked sum of the squared log-partition (None without
    ``z_loss``), the masked count of top-1 hits and the mask's sum.  Sums,
    so that shards of a batch add up to the whole batch's."""
    logits = tfm.logits_head(params, hidden)                  # [B, T, V]
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = loss_mask[:, 1:]
    z = None
    if z_loss:
        z = torch.sum((torch.logsumexp(logits[:, :-1], dim=-1) ** 2) * mask)
    with torch.no_grad():
        hits = torch.sum((torch.argmax(logits[:, :-1], -1) == tgt) * mask)
    return torch.sum(nll * mask), z, hits, torch.sum(mask)


def mean_loss(nll, z, hits, count, z_loss: float = 0.0):
    """``(loss, acc)`` from ``ce_sums``' sums over ``count`` masked
    positions (the whole batch's, where the sums are a shard's)."""
    loss = nll / (count + 1e-6)
    if z_loss:
        loss = loss + z_loss * z / (count + 1e-6)
    return loss, hits / (count + 1e-6)


def token_loss(params, cfg: ModelConfig, rope, batch, fcfg: FinetuneConfig):
    """``(loss, acc)``: next-token CE over ``(tokens, loss_mask)``, with the
    optional conditioning prefix ``cond`` and token-aligned ``attn_valid``
    (the prefix's columns are always valid)."""
    return mean_loss(*token_sums(params, cfg, rope, batch, fcfg),
                     fcfg.z_loss)


def token_sums(params, cfg: ModelConfig, rope, batch, fcfg: FinetuneConfig,
               gather=None):
    """``token_loss``'s ``ce_sums``; ``gather``: the layers' FSDP gather
    (``transformer.train_layer_block``)."""
    tokens = batch["tokens"]                  # [B, T]
    B, T = tokens.shape
    embeds = tfm.token_embed(params, tokens)
    if "cond" in batch:
        embeds = torch.cat([tfm.cond_embed(params, cfg, batch["cond"]),
                            embeds], dim=1)
    Tc = embeds.shape[1] - T
    positions = torch.arange(embeds.shape[1], device=embeds.device)
    attn_valid = batch.get("attn_valid")
    if attn_valid is not None and Tc > 0:
        attn_valid = torch.cat([torch.ones((B, Tc), dtype=attn_valid.dtype,
                                           device=attn_valid.device),
                                attn_valid], dim=1)
    hidden = tfm.forward_train(params, cfg, embeds, positions, rope,
                               attn_valid=attn_valid, remat=fcfg.remat,
                               gather=gather)
    return ce_sums(params, hidden[:, Tc:], tokens, batch["loss_mask"],
                   fcfg.z_loss)


def train_step(state: FinetuneState, cfg: ModelConfig, fcfg: FinetuneConfig,
               rope, batch, mesh: Optional[Mesh] = None):
    """One optimizer step: ``(state, {"loss", "acc", "grad_norm"})``, the
    grad norm before clipping; the parameters are updated in place.  With
    ``mesh``: the FSDP step (``fsdp_step``) of a state from
    ``init_state(..., mesh=)``."""
    if mesh is not None:
        return fsdp_step(state, cfg, fcfg, rope, batch, mesh)
    paths, leaves = flatten(state.params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, acc = token_loss(unflatten(state.params, paths, live), cfg,
                               rope, batch, fcfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    grad_norm = global_norm(grads)
    opt_state = build_optimizer(fcfg, state.params).update(
        leaves, grads, state.opt_state)
    return (FinetuneState(state.params, opt_state, state.step + 1),
            {"loss": loss.detach(), "acc": acc, "grad_norm": grad_norm})


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------

def fsdp_param_specs(params: dict, mesh: Mesh) -> dict:
    """FULL_SHARD: every >= 2-D leaf split over ``tp`` on its largest dim
    that ``tp`` divides (ties to the lower dim, as JAX's stable sort breaks
    them), smaller leaves replicated.  Per leaf (a fused kernel takes its
    own largest dim), in the tuple form of ``parallel/mesh.py``."""
    def spec(leaf: torch.Tensor) -> tuple:
        dims = [None] * leaf.ndim
        if leaf.ndim >= 2:
            for d in sorted(range(leaf.ndim), key=lambda d: -leaf.shape[d]):
                if leaf.shape[d] % mesh.tp == 0:
                    dims[d] = TP
                    break
        return tuple(dims)

    paths, leaves = flatten(params)
    return unflatten(params, paths, [spec(x) for x in leaves])


def split_dims(specs: dict) -> list:
    """Per leaf, in ``flatten`` order: the dim split over tp, or None."""
    return [s.index(TP) if TP in s else None for s in flatten(specs)[1]]


def fsdp_shard(params: dict, specs: dict, mesh: Mesh) -> dict:
    """This rank's contiguous slice, along its split dim, of every split
    leaf (a copy of its own); replicated leaves as they are.  A contiguous
    slice is what ``all_gather`` along that dim inverts (unlike
    ``parallel/mesh.shard_pytree``'s part-by-part cut of fused kernels)."""
    paths, leaves = flatten(params)
    out = []
    for x, d in zip(leaves, split_dims(specs)):
        if d is not None:
            w = x.shape[d] // mesh.tp
            x = x.narrow(d, mesh.tp_rank * w, w).clone(
                memory_format=torch.contiguous_format)
        out.append(x)
    return unflatten(params, paths, out)


def fsdp_gather(state: FinetuneState, mesh: Mesh) -> dict:
    """The whole parameters of an FSDP state, gathered over tp (every rank
    of a tp row calls it and gets the whole tree)."""
    paths, leaves = flatten(state.params)
    return unflatten(state.params, paths, [
        x if d is None else pdist.all_gather(x, d, mesh.tp_group)
        for x, d in zip(leaves, split_dims(state.specs))])


def batch_rows(batch: dict, part: int, parts: int) -> dict:
    """Part ``part`` of ``parts`` equal parts of the whole batch's rows (a
    shared ``[1, T]`` ``attn_valid`` stays whole): a rank's rows where the
    ranks split the batch."""
    B = batch["tokens"].shape[0]
    if B % parts:
        raise ValueError(f"a batch of {B} rows does not split into {parts} "
                         f"equal parts")
    b = B // parts
    return {k: v if k == "attn_valid" and v.shape[0] == 1
            else v[part * b:(part + 1) * b] for k, v in batch.items()}


class _GatherOnUse(torch.autograd.Function):
    """The whole leaf from the tp ranks' slices; the backward reduce-scatters
    the whole leaf's gradient (summed over tp) back to this rank's slice."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        out = pdist.all_gather(x, dim, group)
        return out.clone() if out is x else out

    @staticmethod
    def backward(ctx, g):
        return pdist.reduce_scatter(g, ctx.dim, ctx.group), None, None


def sum_grads_(grads, sharded, dp_group) -> None:
    """In place: every leaf's gradient summed over the ranks that hold the
    same part of it.  ``sharded`` leaves (an FSDP slice, a pipeline
    stage's layers) are held by one rank of each dp replica: summed over
    ``dp_group``; whole leaves are on every rank: summed over the world."""
    for g, part in zip(grads, sharded):
        pdist.all_reduce(g, dp_group if part else None)


def sharded_global_norm(grads, sharded, group) -> torch.Tensor:
    """``optax.global_norm`` of a model whose ``sharded`` leaves are split
    over ``group`` (each rank a distinct part, their squared norms summed
    over it) and whose other leaves are whole on every rank (counted once).
    Summed in leaf order as ``global_norm`` sums, so over a group of one its
    bits are ``global_norm``'s."""
    sq = torch.stack([torch.sum(g.float() * g.float()) for g in grads])
    part = torch.tensor(list(sharded), device=sq.device)
    total = pdist.all_reduce(torch.where(part, sq, 0.0), group)
    return torch.sqrt(sum(torch.where(part, total, sq).unbind()))


def fsdp_step(state: FinetuneState, cfg: ModelConfig, fcfg: FinetuneConfig,
              rope, batch, mesh: Mesh):
    """``train_step`` over a ``(dp, tp)`` mesh (FULL_SHARD, each rank on its
    own rows): every rank passes the whole ``batch`` and takes its rows
    (``batch_rows``).  Split leaves outside the layer stack are gathered
    once, each layer's inside the layer loop; each rank divides its masked
    NLL sum by the whole batch's mask count, so the ranks' gradients sum to
    the one-process gradient: split leaves' over tp (the gathers'
    backward), then over dp; whole leaves' over every rank.  The clip is by
    the whole model's norm (``sharded_global_norm``), then AdamW runs on
    the slices without clipping again (optax's ``chain(clip_by_global_norm,
    adamw)``)."""
    if state.specs is None:
        raise ValueError("train_step(mesh=) needs a state from "
                         "init_state(..., mesh=)")
    if tdist.is_initialized() and (mesh.tp_group is None
                                   or mesh.dp_group is None):
        raise ValueError("FSDP needs the mesh's process groups: build it "
                         "with parallel.mesh.make_mesh after "
                         "init_distributed")
    paths, leaves = flatten(state.params)
    dims = split_dims(state.specs)
    # a layer leaf split past the layer axis is gathered a layer at a time
    per_layer = {p[len("layers/"):]: d - 1 for p, d in zip(paths, dims)
                 if d and p.startswith("layers/")}

    def gather(name, w):
        d = per_layer.get(name)
        return w if d is None else _GatherOnUse.apply(w, d, mesh.tp_group)

    rows = batch_rows(batch, mesh.rank, mesh.dp * mesh.tp)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        use = [x if d is None or (p.startswith("layers/")
                                  and p[len("layers/"):] in per_layer)
               else _GatherOnUse.apply(x, d, mesh.tp_group)
               for p, x, d in zip(paths, live, dims)]
        nll, z, hits, count = token_sums(unflatten(state.params, paths, use),
                                         cfg, rope, rows, fcfg, gather=gather)
        total = pdist.all_reduce(count.detach().clone())
        loss, _ = mean_loss(nll, z, hits, total, fcfg.z_loss)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    split = [d is not None for d in dims]
    sum_grads_(grads, split, mesh.dp_group)
    grad_norm = sharded_global_norm(grads, split, mesh.tp_group)
    clip_by_norm_(grads, grad_norm, fcfg.grad_clip_norm)
    opt = dataclasses.replace(build_optimizer(fcfg, state.params),
                              clip_norm=None)
    opt_state = opt.update(leaves, grads, state.opt_state)
    metrics = {"loss": pdist.all_reduce(loss.detach().clone()),
               "acc": pdist.all_reduce(hits.clone()) / (total + 1e-6),
               "grad_norm": grad_norm}
    return (FinetuneState(state.params, opt_state, state.step + 1,
                          state.specs), metrics)


# ---------------------------------------------------------------------------
# checkpoint management
# ---------------------------------------------------------------------------

def _checkpoints(save_dir: str) -> list:
    """The finished ``step_XXXXXXXX`` entries, oldest first (a ``.tmp``
    entry is a save that never finished)."""
    if not os.path.isdir(save_dir):
        return []
    return sorted(d for d in os.listdir(save_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def _tree(state: FinetuneState) -> dict:
    return {"params": state.params, "opt_state": state.opt_state.to_tree(),
            "step": torch.tensor(int(state.step), dtype=torch.int64)}


def _fsdp_mesh(state: FinetuneState, mesh: Optional[Mesh], what: str):
    if state.specs is not None and mesh is None:
        raise ValueError(f"{what}: an FSDP state holds this rank's slices; "
                         f"pass the mesh it is sharded over (mesh=)")
    return None if state.specs is None else mesh


def fsdp_whole_state(state: FinetuneState, mesh: Mesh) -> FinetuneState:
    """An FSDP state made whole: the parameters and both AdamW moments of
    every split leaf gathered over tp (every rank of a tp row calls it)."""
    dims = split_dims(state.specs)

    def whole(xs):
        return [x if d is None else pdist.all_gather(x, d, mesh.tp_group)
                for x, d in zip(xs, dims)]
    opt = state.opt_state
    return FinetuneState(fsdp_gather(state, mesh),
                         AdamState(opt.count, whole(opt.mu), whole(opt.nu)),
                         state.step)


def fsdp_shard_state(state: FinetuneState, specs: dict,
                     mesh: Mesh) -> FinetuneState:
    """A whole state's FSDP form under ``specs``: this rank's slices of the
    parameters and of both AdamW moments (``fsdp_shard``'s cut)."""
    paths = flatten(state.params)[0]
    opt = state.opt_state

    def cut(xs):
        return flatten(fsdp_shard(unflatten(state.params, paths, xs), specs,
                                  mesh))[1]
    return FinetuneState(fsdp_shard(state.params, specs, mesh),
                         AdamState(opt.count, cut(opt.mu), cut(opt.nu)),
                         state.step, specs)


def save_checkpoint(save_dir: str, state: FinetuneState, keep_last: int = 3,
                    mesh: Optional[Mesh] = None) -> str:
    """Save ``state`` as ``save_dir/step_XXXXXXXX`` (written to a ``.tmp``
    name, then renamed) and prune all but the newest ``keep_last``.  An
    FSDP state needs ``mesh``: every rank calls this, the state is gathered
    whole (``fsdp_whole_state``), world rank 0 writes it in the format of
    an unsharded state, and the ranks meet at a barrier before returning
    the path."""
    mesh = _fsdp_mesh(state, mesh, "save_checkpoint")
    if mesh is not None:
        state = fsdp_whole_state(state, mesh)
    path = os.path.join(save_dir, f"step_{int(state.step):08d}")
    if mesh is None or mesh.rank == 0:
        os.makedirs(save_dir, exist_ok=True)
        save_pytree(path + ".tmp", _tree(state))
        os.replace(path + ".tmp", path)
        for old in _checkpoints(save_dir)[:-keep_last]:
            old = os.path.join(save_dir, old)
            if os.path.isdir(old):
                shutil.rmtree(old, ignore_errors=True)
            else:
                os.remove(old)
    if mesh is not None:
        pdist.barrier()
    return path


def restore_checkpoint(save_dir: str, like: FinetuneState,
                       mesh: Optional[Mesh] = None
                       ) -> Optional[FinetuneState]:
    """The newest checkpoint under ``save_dir`` on ``like``'s device (its
    structure, dtypes and whole shapes must equal ``like``'s), or None.
    With an FSDP ``like`` (and its ``mesh``) the whole state is read and
    each rank keeps its slices (``fsdp_shard_state``); a checkpoint written
    by an FSDP run or by one process restores into either."""
    mesh = _fsdp_mesh(like, mesh, "restore_checkpoint")
    ckpts = _checkpoints(save_dir)
    if not ckpts:
        return None
    tree = _tree(like)
    if mesh is not None:
        # the whole leaves' shapes: a split dim is tp slices long
        dims = split_dims(like.specs)
        paths, leaves = flatten(like.params)

        def whole(xs):
            return [torch.empty(x.shape[:d] + (x.shape[d] * mesh.tp,)
                                + x.shape[d + 1:], dtype=x.dtype,
                                device="meta") if d is not None else x
                    for x, d in zip(xs, dims)]
        opt = like.opt_state
        tree = _tree(FinetuneState(
            unflatten(like.params, paths, whole(leaves)),
            AdamState(opt.count, whole(opt.mu), whole(opt.nu)), like.step))
    device = flatten(like.params)[1][0].device
    tree = restore_pytree(os.path.join(save_dir, ckpts[-1]), like=tree,
                          device=device)
    state = FinetuneState(params=tree["params"],
                          opt_state=AdamState.from_tree(tree["opt_state"]),
                          step=int(tree["step"]))
    return state if mesh is None else fsdp_shard_state(state, like.specs,
                                                       mesh)
