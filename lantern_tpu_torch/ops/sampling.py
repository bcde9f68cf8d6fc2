"""Logit warping, CFG combination and categorical sampling.

Counterpart of ``lantern_tpu/ops/sampling.py``.  Random draws take an
explicit ``torch.Generator`` where the JAX code takes a key; the two
frameworks give different numbers from the same seed, so sampling is held
to the reference by distribution, and the engines' ``pin`` hook makes every
stochastic choice deterministic for token-exact comparisons.
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = torch.finfo(torch.float32).min


@dataclasses.dataclass(frozen=True)
class LogitsWarp:
    """Static sampling config.  ``temperature <= 1e-5`` means greedy."""

    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    warp_order: str = "hf"  # "hf": temp->top_p->top_k; "ar": temp->top_k->top_p

    @property
    def greedy(self) -> bool:
        return self.temperature <= 1e-5

    @property
    def active(self) -> bool:
        return not self.greedy


def cfg_combine(logits: torch.Tensor, cfg_scale: float) -> torch.Tensor:
    """[2R, ..., V] logits of R (cond, uncond) row pairs, cond on row 2r and
    uncond on row 2r + 1 (the port's batch layout; for one pair, [2, ...],
    the JAX form) -> [R, ..., V] = uncond + scale * (cond - uncond)."""
    pairs = logits.reshape((-1, 2) + tuple(logits.shape[1:]))
    cond, uncond = pairs[:, 0], pairs[:, 1]
    return uncond + (cond - uncond) * cfg_scale


def kth_largest(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest value per row, keepdim ([..., 1])."""
    return torch.topk(logits.float(), k, dim=-1).values[..., -1:]


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit (ties at the threshold
    are all kept)."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = kth_largest(logits, k).to(logits.dtype)
    return torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering (HF shift-right convention: the first token that
    crosses ``p`` is kept).  ``p`` outside (0, 1) disables it."""
    if p >= 1.0 or p <= 0.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    remove = (cum - probs) >= p
    kept = torch.where(remove, torch.full_like(sorted_logits, float("inf")),
                       sorted_logits)
    thresh = kept.amin(dim=-1, keepdim=True)
    return torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                       logits)


def warp_logits(logits: torch.Tensor, warp: LogitsWarp) -> torch.Tensor:
    """Apply the static warp spec.  No-op for greedy."""
    if warp.greedy:
        return logits
    if warp.temperature != 1.0:
        logits = logits / warp.temperature
    if warp.warp_order == "ar":
        logits = apply_top_k(logits, warp.top_k)
        logits = apply_top_p(logits, warp.top_p)
    else:
        logits = apply_top_p(logits, warp.top_p)
        logits = apply_top_k(logits, warp.top_k)
    return logits


def keep_threshold(logits: torch.Tensor, warp: LogitsWarp) -> torch.Tensor:
    """[...] per row of ``logits`` [..., V], the least value that
    ``warp_logits`` keeps above float32's lowest (``inf`` where it keeps
    none): ``warp_logits(logits, warp)`` equals ``where(s >= t, s, NEG_INF)``
    for the scaled row ``s``, since top-k and top-p each keep every entry
    at or above a cut."""
    kept = warp_logits(logits, warp)
    return torch.where(kept > NEG_INF, kept,
                       torch.full_like(kept, float("inf"))).amin(dim=-1)


def topk_stable(x: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest entries along the last
    axis, in descending order and, among equal values, the lower index
    first, as ``jax.lax.top_k`` orders them (``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def uniform(generator: torch.Generator, shape, device, low: float = 0.0,
            high: float = 1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return low + (high - low) * u


def categorical(generator: torch.Generator, logits: torch.Tensor
                ) -> torch.Tensor:
    """One draw per row from softmax(logits), by the Gumbel-max trick (as
    ``jax.random.categorical``; no host sync).  Returns int32 ids with the
    leading shape of ``logits``."""
    u = uniform(generator, logits.shape, logits.device, 1e-20, 1.0)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(logits.float() + gumbel, dim=-1).to(torch.int32)


def sample_token(generator: torch.Generator, logits: torch.Tensor,
                 warp: LogitsWarp) -> torch.Tensor:
    """Warp + sample (or argmax when greedy); int32 ids with the leading
    batch shape of ``logits``."""
    if warp.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    return categorical(generator, warp_logits(logits, warp))


def sample_without_replacement(generator: torch.Generator,
                               probs: torch.Tensor, k: int):
    """Draw ``k`` tokens without replacement from each row of ``probs``
    [.., V] by the Gumbel top-k trick.  Returns ``(indices int32 [.., k],
    q [.., k])`` with the residual acceptance probabilities of
    ``residual_q``."""
    logp = torch.log(torch.clamp(probs, min=1e-30))
    u = uniform(generator, probs.shape, probs.device, 1e-20, 1.0)
    idx = torch.topk(logp - torch.log(-torch.log(u)), k, dim=-1).indices
    return idx.to(torch.int32), residual_q(torch.gather(probs, -1, idx))


def residual_q(p_sel: torch.Tensor) -> torch.Tensor:
    """The reference drafter's residual acceptance probabilities of the
    top-k draws ``p_sel`` [.., k]: ``q[i] = p(x_i) / (1 - sum_{j<i}
    p(x_j))``, clamped to [0, 1] with non-finite entries zeroed."""
    prev_cum = torch.cumsum(p_sel, dim=-1) - p_sel
    q = p_sel / (1.0 - prev_cum)
    return torch.where(torch.isfinite(q), torch.clamp(q, 0.0, 1.0),
                       torch.zeros_like(q))
