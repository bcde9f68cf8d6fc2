"""GPipe pipeline parallelism over the ``pp`` processes of a ``(dp, pp)``
mesh (training).

Counterpart of ``lantern_tpu/parallel/pipeline.py``.  The layer stack is
split into ``pp`` consecutive stages (``split_stages``), and the process of
stage ``s`` holds its ``[L/pp, ...]`` slice of every stacked layer weight
(``stage_layers``).  The JAX module runs the schedule as one ``shard_map``
program whose ``ppermute`` moves activations and whose backward follows
from ``ppermute``'s transpose.  Here each stage is a process:

- stage 0 embeds; each microbatch goes from stage to stage through
  ``send`` / ``recv`` inside ``torch.autograd.Function`` s: the backward of
  a send receives the gradient from the next stage, the backward of a
  receive sends it to the previous one, so autograd runs the backward
  pipeline;
- a stage's sends, and its receives, form chains through zero scalars (tokens):
  the backward reaches them in reverse microbatch order, the order the
  neighbour posts its half in, so neither gloo nor NCCL pairs a gradient
  with another microbatch or waits on a message sent after it.  A non-last
  stage's loss is the token of its last send (zero) plus the last stage's
  share, so its backward starts at that send;
- the last stage applies the final norm and the head to all microbatches
  at once and computes the next-token CE; loss and accuracy are sums over
  (pp, dp) divided by the whole batch's mask count, and every rank returns
  them;
- the batch splits over dp: every rank passes the whole batch and takes its
  dp row's rows.

``value_and_grad`` returns the stage's layer gradients summed over dp and
every other leaf's (embedding, final norm, head, the conditioning adapters)
summed over pp and dp: what ``shard_map``'s transpose gives a replicated
input.  ``make_train_step`` clips by the whole model's gradient norm and
runs the finetune's AdamW; its decay mask names the leaves as the finetune
does (``cond/uncond`` stays undecayed, where the JAX mask over the
``(params, staged)`` tuple decays it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import transformer as tfm
from ..train import finetune as ft
from ..train.optim import clip_by_norm_, flatten, unflatten
from . import dist as pdist
from . import mesh as pmesh

PP = "pp"


def split_stages(layers: dict, pp: int) -> dict:
    """Layer-stacked weights ``[L, ...]`` -> ``[pp, L/pp, ...]`` (stage s
    holds layers ``[s L/pp, (s+1) L/pp)``)."""
    def f(a):
        L = a.shape[0]
        if L % pp:
            raise ValueError(f"num_layers {L} not divisible by pp={pp}")
        return a.reshape(pp, L // pp, *a.shape[1:])
    return {k: f(v) for k, v in layers.items()}


def merge_stages(staged: dict) -> dict:
    """Inverse of ``split_stages``."""
    return {k: v.reshape(-1, *v.shape[2:]) for k, v in staged.items()}


def stage_specs(staged: dict) -> dict:
    """Specs of ``split_stages``' leaves: the leading stage axis over
    ``pp`` (the tuple form of ``parallel/mesh.py``)."""
    return {k: (PP,) + (None,) * (v.ndim - 1) for k, v in staged.items()}


@dataclasses.dataclass
class PipeMesh:
    """``dp x pp`` processes; rank ``r`` is stage ``r % pp`` of dp row
    ``r // pp``.  ``pp_group``: this rank's dp row (its pipeline);
    ``dp_group``: the ranks of its stage (None without a process group)."""
    dp: int
    pp: int
    rank: int = 0
    pp_group: object = None
    dp_group: object = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.pp

    @property
    def stage(self) -> int:
        return self.rank % self.pp


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> PipeMesh:
    """The ``(dp, pp)`` mesh over the initialized process group, ``pp = n /
    dp``: its groups are ``parallel/mesh.make_mesh``'s, whose tp rows are
    the pipelines."""
    m = pmesh.make_mesh(n_devices, dp)
    return PipeMesh(dp=m.dp, pp=m.tp, rank=m.rank, pp_group=m.tp_group,
                    dp_group=m.dp_group)


def stage_layers(layers: dict, mesh: PipeMesh) -> dict:
    """This rank's ``[L/pp, ...]`` slice of the stacked layers (a copy of
    its own, so the whole stack can be freed)."""
    return {k: v[mesh.stage].clone()
            for k, v in split_stages(layers, mesh.pp).items()}


class _Send(torch.autograd.Function):
    """Send ``y`` to the next stage; returns a zero token chained to the
    previous send's.  Backward: the gradient of ``y`` from that stage."""

    @staticmethod
    def forward(ctx, y, prev, dst, group):
        ctx.meta = (y.shape, y.dtype, y.device, dst, group)
        pdist.send(y, dst, group)
        return torch.zeros((), dtype=torch.float32, device=y.device)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device, dst, group = ctx.meta
        gy = pdist.recv(shape, dtype, device, dst, group)
        return gy, (g if ctx.needs_input_grad[1] else None), None, None


class _Recv(torch.autograd.Function):
    """Receive a microbatch's activations from the previous stage, after
    the receive whose token is ``prev``; returns them and this receive's
    token.  Backward: their gradient sent back to that stage."""

    @staticmethod
    def forward(ctx, prev, shape, dtype, src, group):
        ctx.meta = (src, group)
        x = pdist.recv(shape, dtype, prev.device, src, group)
        return x, torch.zeros_like(prev)

    @staticmethod
    def backward(ctx, gx, gtok):
        src, group = ctx.meta
        pdist.send(gx, src, group)
        return gtok, None, None, None, None


class _SumOverRanks(torch.autograd.Function):
    """The world's sum of a scalar each rank holds a share of.  Every rank
    seeds the backward of its own copy of the sum, so the backward hands
    the gradient on unchanged (JAX's transpose of a ``psum`` into a
    replicated output)."""

    @staticmethod
    def forward(ctx, x):
        return pdist.all_reduce(x.detach().clone())

    @staticmethod
    def backward(ctx, g):
        return g


def pipeline_loss_fn(cfg, mesh: PipeMesh, n_micro: int, rope,
                     remat: bool = True):
    """``loss_fn(params, staged, batch) -> (loss, acc)`` running the decoder
    as a ``pp``-stage GPipe pipeline: ``staged`` is this rank's ``[L/pp,
    ...]`` layers (``stage_layers``), ``params`` the rest (a "layers"
    entry is ignored), ``batch`` the whole batch: tokens ``[B, T]``,
    ``loss_mask``, optional ``attn_valid`` ``[1, T]`` or ``[B, T]``; each dp
    row's ``B / dp`` rows split into ``n_micro`` microbatches.  The
    semantics are ``finetune.token_loss``'s without a conditioning prefix.
    A backward must reach ``staged`` (``value_and_grad`` does): the
    receives hang off it, and every stage's backward must run."""
    pp, stage = mesh.pp, mesh.stage
    first, last = stage == 0, stage == pp - 1
    cos, _ = rope

    def loss_fn(params, staged, batch):
        if "cond" in batch:
            raise NotImplementedError(
                "conditional (cond-prefix) batches are not supported by the "
                "pipeline trainer yet; use finetune.train_step")
        rows = ft.batch_rows(batch, mesh.dp_rank, mesh.dp)
        tokens = rows["tokens"]
        B, T = tokens.shape
        if B % n_micro:
            raise ValueError(f"{B} rows a dp row do not split into "
                             f"{n_micro} microbatches")
        mb = B // n_micro
        dev = tokens.device
        positions = torch.clamp(torch.arange(T, device=dev), 0,
                                cos.shape[0] - 1)[None]
        mask = tfm.train_mask(T, rows.get("attn_valid"), device=dev)
        Ls = next(iter(staged.values())).shape[0]
        shape = (mb, T, cfg.hidden_size)
        # the first receive's token: a zero on the stage's weights, so a
        # backward that reaches them runs the receives
        got = next(iter(staged.values())).reshape(-1)[:1].sum().float() * 0
        outs, sent = [], None
        for m in range(n_micro):
            sl = slice(m * mb, (m + 1) * mb)
            if first:
                x = tfm.token_embed(params, tokens[sl])
            else:
                x, got = _Recv.apply(got, shape, params["embed"].dtype,
                                     stage - 1, mesh.pp_group)
            y = tfm.train_layer_block(
                staged, cfg, x, positions, rope,
                mask if mask.shape[0] == 1 else mask[sl],
                idx0=stage * Ls, remat=remat)
            if last:
                outs.append(y)
            else:
                sent = _Send.apply(y, sent, stage + 1, mesh.pp_group)
        count = pdist.all_reduce(torch.sum(rows["loss_mask"][:, 1:]),
                                 mesh.dp_group)
        if last:
            hidden = torch.cat(outs)
            if cfg.final_norm:
                hidden = tfm.rms_norm(hidden, params["norm"],
                                      cfg.rms_norm_eps)
            nll, _, hits, _ = ft.ce_sums(params, hidden, tokens,
                                         rows["loss_mask"])
        else:
            nll, hits = sent, torch.zeros((), device=dev)
        nll = _SumOverRanks.apply(nll)
        hits = pdist.all_reduce(hits.float())
        return ft.mean_loss(nll, None, hits, count)

    return loss_fn


def _merged(params: dict, staged: dict) -> dict:
    """``params`` with this stage's layers under "layers": the finetune's
    tree, so leaves come in ``finetune.train_step``'s order and names."""
    return dict({k: v for k, v in params.items() if k != "layers"},
                layers=staged)


def value_and_grad(loss_fn, mesh: PipeMesh, params: dict, staged: dict,
                   batch):
    """``((loss, acc), (param_grads, stage_grads))`` of a
    ``pipeline_loss_fn`` loss on every rank: the stage's layer gradients
    summed over dp, every other leaf's summed over pp and dp."""
    tree = _merged(params, staged)
    paths, leaves = flatten(tree)
    with torch.enable_grad():
        live = unflatten(tree, paths,
                         [x.detach().requires_grad_() for x in leaves])
        loss, acc = loss_fn(live, live["layers"], batch)
        inputs = flatten(live)[1]
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(inputs, grads)]
    ft.sum_grads_(grads, [p.startswith("layers/") for p in paths],
                  mesh.dp_group)
    g = unflatten(tree, paths, grads)
    return (loss.detach(), acc), (
        {k: v for k, v in g.items() if k != "layers"}, g["layers"])


def make_train_step(cfg, mesh: PipeMesh, n_micro: int, rope, fcfg=None):
    """``(step_fn, init_fn)``: AdamW over ``(params, staged)`` with the
    pipeline loss, the pp counterpart of ``finetune.train_step``.
    ``init_fn(params, staged)`` gives the optimizer state of this rank's
    leaves; ``step_fn(params, staged, opt_state, batch)`` returns ``(params,
    staged, opt_state, {"loss", "acc", "grad_norm"})``, the parameters
    updated in place.  The clip is by the whole model's norm (stage parts
    summed over pp, replicated leaves once), then AdamW runs without
    clipping again; the optimizer is ``finetune.build_optimizer``'s, decay
    mask included, so stacked norms stay undecayed."""
    fcfg = fcfg or ft.FinetuneConfig()
    loss_fn = pipeline_loss_fn(cfg, mesh, n_micro, rope, remat=fcfg.remat)

    def optimizer(tree):
        return dataclasses.replace(ft.build_optimizer(fcfg, tree),
                                   clip_norm=None)

    def init_fn(params, staged):
        tree = _merged(params, staged)
        return optimizer(tree).init(flatten(tree)[1])

    def step_fn(params, staged, opt_state, batch):
        (loss, acc), (gp, gs) = value_and_grad(loss_fn, mesh, params,
                                               staged, batch)
        tree = _merged(params, staged)
        paths, leaves = flatten(tree)
        grads = flatten(_merged(gp, gs))[1]
        norm = ft.sharded_global_norm(
            grads, [p.startswith("layers/") for p in paths], mesh.pp_group)
        clip_by_norm_(grads, norm, fcfg.grad_clip_norm)
        opt_state = optimizer(tree).update(leaves, grads, opt_state)
        return params, staged, opt_state, {"loss": loss, "acc": acc,
                                           "grad_norm": norm}

    return step_fn, init_fn
