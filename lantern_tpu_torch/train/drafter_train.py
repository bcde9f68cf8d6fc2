"""Drafter self-distillation training in PyTorch.

Counterpart of ``lantern_tpu/train/drafter_train.py``: the drafter
regresses the base model's next hidden state (SmoothL1 "vloss") and
distills the frozen base head's distribution (soft cross-entropy "ploss",
weighted ``p_w``), teacher-forced over (token, hidden) pairs under an
image-token loss mask; optional CFG-aware loss (cond/uncond rows combined
before the soft-CE), on-policy rollout levels (``rollout_depth`` > 1), a
T-chunked head loss (``head_chunk``) and a recomputed drafter forward
(``remat``).  The optimizer is optax's: elementwise gradient clip, then
AdamW(0.9, 0.95) at optax's default weight decay, with linear warmup and
decay (``train.optim``).

The forward is ``transformer.forward_train`` (dense, cache-free): the JAX
trainer runs the dense attention path over a scratch cache whose prefix
is empty, which gives the same rows for every row that sees a key, and
``batch_iterator``'s trailing pads leave every row of a non-empty sample a
key (its first).  No kernel runs here, so autograd never meets one.

``train_step`` updates ``TrainState.dparams`` in place (PyTorch's optimizer
idiom); the parameters never require grad outside the step, so a trained
drafter serves through the kernels as it is.

Sample format (one .npz per sequence, written by generate_train_data):
  tokens    [T] int32   drafter input tokens (shifted stream: token_{i+1})
  hidden    [T, H]      base hidden states h_i (post final norm)
  target    [T, H]      h_{i+1} (zero row at the end)
  loss_mask [T] f32     1 on image-token positions
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs import DrafterConfig
from ..models import transformer as tfm
from ..ops.sampling import topk_stable
from .optim import (AdamState, AdamW, flatten, join_schedules,
                    linear_schedule, unflatten)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    betas: tuple = (0.9, 0.95)
    grad_clip: float = 0.5
    p_w: float = 0.1
    v_w: float = 1.0
    num_epochs: int = 20
    warmup_steps: int = 0
    total_steps: int = 0
    noise: str = "uniform"           # "uniform" | "gaussian" | "none"
    noise_std: float = 0.2
    cfg_loss: bool = False
    cfg_scale: float = 3.0
    rollout_depth: int = 1
    rollout_w: float = 0.5
    head_chunk: int = 0
    remat: bool = False


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def add_noise(generator: Optional[torch.Generator], hidden: torch.Tensor,
              tcfg: TrainConfig) -> torch.Tensor:
    """Noise augmentation drawn from ``generator`` (on ``hidden``'s
    device): uniform noise in ``[-0.5, 0.5)`` scaled by ``noise_std * 512 /
    T``, or gaussian noise of deviation ``noise_std``."""
    if tcfg.noise == "none" or tcfg.noise_std == 0.0:
        return hidden
    if tcfg.noise == "uniform":
        scale = tcfg.noise_std * 512.0 / hidden.shape[1]
        u = torch.rand(hidden.shape, generator=generator,
                       device=hidden.device)
        return hidden + (u - 0.5) * scale
    return hidden + torch.randn(hidden.shape, generator=generator,
                                device=hidden.device) * tcfg.noise_std


class Metrics(NamedTuple):
    loss: torch.Tensor
    vloss: torch.Tensor
    ploss: torch.Tensor
    correct: torch.Tensor     # top-1 vs the base head's argmax
    top_acc: torch.Tensor     # [3] top-1/2/3 correct counts
    total: torch.Tensor


def fuse_inputs(dparams: dict, tokens: torch.Tensor,
                hidden: torch.Tensor) -> torch.Tensor:
    """``fc([embed(tokens), hidden])`` in ``hidden``'s dtype (dense
    ``fc_w``; f32 teacher hiddens promote bf16 weights, as in JAX)."""
    emb = dparams["embed"][tokens.long()].to(hidden.dtype)
    x = torch.cat([emb, hidden], dim=-1)
    return tfm.dense_matmul(x, dparams["fc_w"]) + dparams["fc_b"]


def drafter_teacher_forward(dparams: dict, dcfg: DrafterConfig, rope, tokens,
                            hidden, attn_valid, positions=None):
    """Teacher-forced causal drafter forward over full sequences, cache-free
    and differentiable.  ``positions`` [B, T] overrides the default arange
    (Chameleon CFG pairs train with the deployment position scheme)."""
    T = tokens.shape[1]
    if positions is None:
        positions = torch.arange(T, device=tokens.device)
    return tfm.forward_train(dparams, dcfg.model,
                             fuse_inputs(dparams, tokens, hidden), positions,
                             rope, attn_valid=attn_valid, remat=False)


def _soft_ce_and_topacc(out_head, tgt_head, m):
    """Summed soft-CE and top-1/2/3 hit counts over one logits block.
    ``m`` [B, C, 1] loss mask."""
    tgt_p = torch.softmax(tgt_head, dim=-1)
    out_logp = torch.log_softmax(out_head, dim=-1)
    pl = -torch.sum(m * torch.sum(tgt_p * out_logp, -1, keepdim=True))
    with torch.no_grad():
        tgt_tok = torch.argmax(tgt_head, dim=-1)
        _, topk = topk_stable(out_head, 3)
        hits = topk == tgt_tok[..., None]
        mm = m[..., 0]
        acc = torch.stack([torch.sum(mm * hits[..., : k + 1].any(-1))
                           for k in range(3)])
    return pl, acc


def _head_block(pr, tg, m, head, tcfg: TrainConfig):
    out_head = tfm.dense_matmul(pr, head).float()
    with torch.no_grad():
        tgt_head = tfm.dense_matmul(tg, head).float()
    if tcfg.cfg_loss:
        tgt_head = tgt_head[::2] + tcfg.cfg_scale * (tgt_head[::2]
                                                     - tgt_head[1::2])
        out_head = out_head[::2] + tcfg.cfg_scale * (out_head[::2]
                                                     - out_head[1::2])
        m = m[::2]
    return _soft_ce_and_topacc(out_head, tgt_head, m)


def _head_ce_sums(predict, target, mask, head, tcfg: TrainConfig):
    """(soft-CE sum, top-acc counts [3]) for drafter hiddens vs teacher
    hiddens through the frozen head: the full logits, or T-chunks of
    ``tcfg.head_chunk`` rows each recomputed in the backward."""
    if tcfg.head_chunk <= 0:
        return _head_block(predict, target, mask, head, tcfg)
    pl = torch.zeros((), dtype=torch.float32, device=predict.device)
    acc = torch.zeros((3,), dtype=torch.float32, device=predict.device)
    for c0 in range(0, predict.shape[1], tcfg.head_chunk):
        rows = slice(c0, c0 + tcfg.head_chunk)
        args = (predict[:, rows], target[:, rows], mask[:, rows], head, tcfg)
        if torch.is_grad_enabled():
            p_c, a_c = checkpoint(_head_block, *args, use_reentrant=False,
                                  preserve_rng_state=False)
        else:
            p_c, a_c = _head_block(*args)
        pl = pl + p_c
        acc = acc + a_c
    return pl, acc


def _shift_left(x: torch.Tensor, s: int) -> torch.Tensor:
    """``x`` moved ``s`` rows left along axis 1, zeros shifted in."""
    if s == 0:
        return x
    return torch.cat([x[:, s:], torch.zeros_like(x[:, :s])], dim=1)


def loss_and_metrics(dparams: dict, dcfg: DrafterConfig, rope,
                     head: torch.Tensor,          # [H, V] frozen base lm_head
                     batch: dict, tcfg: TrainConfig):
    """``(loss, Metrics)`` of one batch (tensors on one device)."""
    positions = batch.get("positions")

    def fwd(tokens, hidden):
        return drafter_teacher_forward(dparams, dcfg, rope, tokens, hidden,
                                       batch["attn_valid"], positions)

    def run(tokens, hidden):
        if tcfg.remat and torch.is_grad_enabled():
            return checkpoint(fwd, tokens, hidden, use_reentrant=False,
                              preserve_rng_state=False)
        return fwd(tokens, hidden)

    predict = run(batch["tokens"], batch["hidden"])
    target = batch["target"]
    mask = batch["loss_mask"][..., None]                     # [B, T, 1]

    vloss = torch.sum(mask * smooth_l1(predict, target).mean(-1, keepdim=True))
    vloss = vloss / (torch.sum(mask) + 1e-5)

    pl_sum, top_acc = _head_ce_sums(predict, target, mask, head, tcfg)
    p_mask = mask[::2] if tcfg.cfg_loss else mask
    n_mask = torch.sum(p_mask)
    ploss = pl_sum / (n_mask + 1e-5)
    loss = tcfg.v_w * vloss + tcfg.p_w * ploss

    # on-policy rollout levels: level d consumes (teacher token_{p+d-1},
    # the drafter's own level-(d-1) hidden at p) and matches the teacher
    # head distribution d steps ahead
    h_prev = predict
    for d in range(2, tcfg.rollout_depth + 1):
        tok_d = _shift_left(batch["tokens"], d - 1)
        h_d = run(tok_d, h_prev)
        tgt_d = _shift_left(target, d - 1)
        m_d = batch["loss_mask"] * _shift_left(batch["loss_mask"], d - 1)
        pl_d, _ = _head_ce_sums(h_d, tgt_d, m_d[..., None], head, tcfg)
        m_dn = m_d[::2] if tcfg.cfg_loss else m_d
        pl_d = pl_d / (torch.sum(m_dn) + 1e-5)
        loss = loss + tcfg.p_w * (tcfg.rollout_w ** (d - 1)) * pl_d
        h_prev = h_d

    metrics = Metrics(loss=loss, vloss=vloss, ploss=ploss,
                      correct=top_acc[0], top_acc=top_acc, total=n_mask)
    return loss, metrics


class TrainState(NamedTuple):
    dparams: dict
    opt_state: AdamState
    step: int


def build_optimizer(tcfg: TrainConfig) -> AdamW:
    """Elementwise clip at ``grad_clip``, then AdamW at optax's defaults
    (weight decay 1e-4 on every trainable leaf, eps 1e-8), with linear
    warmup then linear decay when both step counts are set."""
    if tcfg.warmup_steps > 0 and tcfg.total_steps > 0:
        lr = join_schedules(
            [linear_schedule(0.0, tcfg.lr, tcfg.warmup_steps),
             linear_schedule(tcfg.lr, 0.0,
                             max(tcfg.total_steps - tcfg.warmup_steps, 1))],
            [tcfg.warmup_steps])
    else:
        lr = tcfg.lr
    return AdamW(lr=lr, b1=tcfg.betas[0], b2=tcfg.betas[1],
                 clip_value=tcfg.grad_clip)


def trainable(dparams: dict):
    """``(paths, leaves)`` of every drafter leaf but the shared ``embed``."""
    paths, leaves = flatten(dparams)
    keep = [i for i, p in enumerate(paths) if p != "embed"]
    return [paths[i] for i in keep], [leaves[i] for i in keep]


def init_train_state(dparams: dict, tcfg: TrainConfig) -> TrainState:
    _, leaves = trainable(dparams)
    return TrainState(dparams=dparams,
                      opt_state=build_optimizer(tcfg).init(leaves), step=0)


def train_step(state: TrainState, dcfg: DrafterConfig, tcfg: TrainConfig,
               rope, head: torch.Tensor, batch: dict,
               generator: Optional[torch.Generator] = None):
    """One optimizer step on ``batch`` (tensors on the params' device);
    ``generator`` draws the noise.  Returns ``(state, Metrics)``; the
    state's parameters are updated in place."""
    batch = dict(batch, hidden=add_noise(generator, batch["hidden"], tcfg))
    paths, leaves = trainable(state.dparams)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        loss, metrics = loss_and_metrics(unflatten(state.dparams, paths, live),
                                         dcfg, rope, head, batch, tcfg)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    opt_state = build_optimizer(tcfg).update(leaves, grads, state.opt_state)
    metrics = Metrics(*(m.detach() for m in metrics))
    return TrainState(state.dparams, opt_state, state.step + 1), metrics


@torch.no_grad()
def eval_step(state: TrainState, dcfg: DrafterConfig, tcfg: TrainConfig,
              rope, head: torch.Tensor, batch: dict) -> Metrics:
    _, metrics = loss_and_metrics(state.dparams, dcfg, rope, head, batch,
                                  tcfg)
    return metrics


# ---------------------------------------------------------------------------
# data pipeline (numpy, as the reference's, so a seed gives the same batches)
# ---------------------------------------------------------------------------

def load_sample(path: str) -> dict:
    z = np.load(path)
    return {k: z[k] for k in ("tokens", "hidden", "target", "loss_mask")}


def batch_iterator(paths, batch_size: int, max_len: int,
                   rng: np.random.Generator,
                   shuffle: bool = True) -> Iterator[dict]:
    """Pad/truncate samples to ``max_len`` and batch them (numpy);
    ``attn_valid`` masks pad columns out of the causal attention."""
    order = np.arange(len(paths))
    if shuffle:
        rng.shuffle(order)
    for i in range(0, len(order) - batch_size + 1, batch_size):
        toks, hids, tgts, masks, valid = [], [], [], [], []
        for j in order[i: i + batch_size]:
            s = load_sample(paths[j])
            T = min(len(s["tokens"]), max_len)
            H = s["hidden"].shape[-1]
            t = np.zeros((max_len,), np.int32)
            h = np.zeros((max_len, H), np.float32)
            g = np.zeros((max_len, H), np.float32)
            m = np.zeros((max_len,), np.float32)
            v = np.zeros((max_len,), np.float32)
            t[:T] = s["tokens"][:T]
            h[:T] = s["hidden"][:T]
            g[:T] = s["target"][:T]
            m[:T] = s["loss_mask"][:T]
            v[:T] = 1.0
            toks.append(t)
            hids.append(h)
            tgts.append(g)
            masks.append(m)
            valid.append(v)
        yield {
            "tokens": np.stack(toks), "hidden": np.stack(hids),
            "target": np.stack(tgts), "loss_mask": np.stack(masks),
            "attn_valid": np.stack(valid),
        }


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}
