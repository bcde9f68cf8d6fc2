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
  the newest ``keep_last`` kept, resumed from the newest.

The JAX module also shards parameters for FSDP over a mesh
(``fsdp_param_specs``); that needs the port's parallelism, not this one
card.  ``train_step`` updates the state's parameters in place.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import NamedTuple, Optional

import torch

from ..configs import ModelConfig
from ..models import transformer as tfm
from ..utils.checkpoint import restore_pytree, save_pytree
from .optim import AdamState, AdamW, flatten, global_norm, unflatten
from .optim import warmup_cosine_decay_schedule


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


def init_state(params: dict, fcfg: FinetuneConfig) -> FinetuneState:
    return FinetuneState(
        params=params,
        opt_state=build_optimizer(fcfg, params).init(flatten(params)[1]),
        step=0)


def token_loss(params, cfg: ModelConfig, rope, batch, fcfg: FinetuneConfig):
    """``(loss, acc)``: next-token CE over ``(tokens, loss_mask)``, with the
    optional conditioning prefix ``cond`` and token-aligned ``attn_valid``
    (the prefix's columns are always valid)."""
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
                               attn_valid=attn_valid, remat=fcfg.remat)
    logits = tfm.logits_head(params, hidden[:, Tc:])          # [B, T, V]
    # predict token t+1 from position t
    logp = torch.log_softmax(logits[:, :-1], dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = batch["loss_mask"][:, 1:]
    loss = torch.sum(nll * mask) / (torch.sum(mask) + 1e-6)
    if fcfg.z_loss:
        z = torch.logsumexp(logits[:, :-1], dim=-1)
        loss = loss + fcfg.z_loss * torch.sum((z ** 2) * mask) / (
            torch.sum(mask) + 1e-6)
    with torch.no_grad():
        acc = torch.sum((torch.argmax(logits[:, :-1], -1) == tgt) * mask) / (
            torch.sum(mask) + 1e-6)
    return loss, acc


def train_step(state: FinetuneState, cfg: ModelConfig, fcfg: FinetuneConfig,
               rope, batch):
    """One optimizer step: ``(state, {"loss", "acc", "grad_norm"})``, the
    grad norm before clipping; the parameters are updated in place."""
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


def save_checkpoint(save_dir: str, state: FinetuneState,
                    keep_last: int = 3) -> str:
    """Save ``state`` as ``save_dir/step_XXXXXXXX`` (written to a ``.tmp``
    name, then renamed) and prune all but the newest ``keep_last``."""
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"step_{int(state.step):08d}")
    save_pytree(path + ".tmp", _tree(state))
    os.replace(path + ".tmp", path)
    for old in _checkpoints(save_dir)[:-keep_last]:
        old = os.path.join(save_dir, old)
        if os.path.isdir(old):
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.remove(old)
    return path


def restore_checkpoint(save_dir: str,
                       like: FinetuneState) -> Optional[FinetuneState]:
    """The newest checkpoint under ``save_dir`` on ``like``'s device (its
    structure, shapes and dtypes must equal ``like``'s), or None."""
    ckpts = _checkpoints(save_dir)
    if not ckpts:
        return None
    device = flatten(like.params)[1][0].device
    tree = restore_pytree(os.path.join(save_dir, ckpts[-1]),
                          like=_tree(like), device=device)
    return FinetuneState(params=tree["params"],
                         opt_state=AdamState.from_tree(tree["opt_state"]),
                         step=int(tree["step"]))
