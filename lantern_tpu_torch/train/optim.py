"""AdamW and learning-rate schedules with optax's semantics.

The JAX trainers are ``optax`` chains, whose defaults and orders differ
from ``torch.optim.AdamW``'s, so the port keeps its own small optimizer and
holds it to optax on identical gradients:

- ``optax.adamw``: weight decay 1e-4 by default (torch: 1e-2), eps 1e-8
  outside the square root, bias correction at the update count after the
  increment, decay added to the Adam direction before the learning rate
  scales it, an optional per-leaf decay mask and an optional dtype of the
  first moment (``mu_dtype``); the second moment keeps the leaf's dtype;
- the learning rate is the schedule at the update count BEFORE the
  increment (``scale_by_learning_rate``), and the step is added to the
  parameter in the promoted dtype, then cast back to the parameter's;
- ``optax.clip`` clips each gradient element to ``[-c, c]``;
  ``optax.clip_by_global_norm`` scales every leaf by ``max_norm / norm``
  when ``norm >= max_norm`` (no ``+1e-6``, unlike
  ``torch.nn.utils.clip_grad_norm_``).

Parameters are a flat list of tensors (``flatten`` gives the leaves of a
nested dict in sorted-key order, as ``jax.tree`` does, with their "a/b"
paths); ``AdamW.update`` writes the new values into them in place, one
leaf at a time (the layer weights are stacked, so a model has a few dozen
leaves).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Callable[[int], float]
# optax.adamw's eps, added outside the square root
EPS = 1e-8


# ---------------------------------------------------------------- schedules

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Schedule:
    """``optax.linear_schedule`` (no ``transition_begin``): from
    ``init_value`` at 0 to ``end_value`` at ``transition_steps``, held
    after; a constant ``init_value`` when ``transition_steps <= 0``."""
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac
                     + np.float32(end_value))

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule`` (exponent 1)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = np.float32(min(count, decay_steps))
        cos = np.float32(0.5) * (np.float32(1) + np.cos(
            np.float32(math.pi) * c / np.float32(decay_steps)))
        decayed = np.float32(1 - alpha) * cos + np.float32(alpha)
        return float(np.float32(init_value) * decayed)

    return schedule


def join_schedules(schedules: Sequence[Schedule],
                   boundaries: Sequence[int]) -> Schedule:
    """``optax.join_schedules``: past each boundary the next schedule, fed
    the steps since that boundary."""
    def schedule(count: int) -> float:
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): linear warmup
    to ``peak_value``, then cosine decay to ``end_value`` at
    ``decay_steps`` (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules(
        [linear_schedule(init_value, peak_value, warmup_steps),
         cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)],
        [warmup_steps])


# ---------------------------------------------------------------- trees

def flatten(tree: dict, prefix: str = ""):
    """``(paths, leaves)`` of a nested dict of tensors in sorted-key order
    (``jax.tree``'s order for dicts); a path joins the keys with "/"."""
    paths, leaves = [], []
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            p, l = flatten(v, name + "/")
            paths += p
            leaves += l
        else:
            paths.append(name)
            leaves.append(v)
    return paths, leaves


def unflatten(tree: dict, paths: Sequence[str], leaves) -> dict:
    """A copy of ``tree`` with the leaves at ``paths`` replaced."""
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in tree.items()}
    for path, leaf in zip(paths, leaves):
        *head, last = path.split("/")
        node = out
        for k in head:
            node[k] = dict(node[k])
            node = node[k]
        node[last] = leaf
    return out


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: the L2 norm over every element (f32)."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float()) for t in tensors))


@torch.no_grad()
def clip_by_norm_(grads: Sequence[torch.Tensor], norm: torch.Tensor,
                  max_norm: float) -> None:
    """``optax.clip_by_global_norm``'s scaling, in place, by a norm the
    caller computed (a sharded trainer's is the whole model's, not its
    shard's): ``t / norm * max_norm`` where ``norm >= max_norm``, else
    ``t / 1 * 1 == t``, with no read-back to the host."""
    keep = norm < max_norm
    one = torch.ones_like(norm)
    den = torch.where(keep, one, norm)
    num = torch.where(keep, one, torch.full_like(norm, max_norm))
    for t in grads:
        t.div_(den.to(t.dtype)).mul_(num.to(t.dtype))


# ---------------------------------------------------------------- AdamW

class AdamState(NamedTuple):
    count: int                    # updates applied so far
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    def to_tree(self) -> dict:
        """The state as a dict of tensors (``utils.checkpoint``'s pytree)."""
        return {"count": torch.tensor(self.count, dtype=torch.int64),
                "mu": list(self.mu), "nu": list(self.nu)}

    @classmethod
    def from_tree(cls, tree: dict) -> "AdamState":
        return cls(int(tree["count"]), list(tree["mu"]), list(tree["nu"]))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``optax.chain([clip | clip_by_global_norm,] adamw(...))``."""

    lr: Union[float, Schedule]
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 1e-4
    decay_mask: Optional[Sequence[bool]] = None   # per leaf; None: all
    mu_dtype: Optional[torch.dtype] = None
    clip_value: Optional[float] = None            # optax.clip
    clip_norm: Optional[float] = None             # optax.clip_by_global_norm

    def learning_rate(self, count: int) -> float:
        return self.lr(count) if callable(self.lr) else float(self.lr)

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return AdamState(
            0, [torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor],
               state: AdamState) -> AdamState:
        """One step.  ``params`` are written in place and ``grads`` are
        consumed (clipped in place); returns the new state, whose moments
        are the old state's tensors, updated."""
        g = list(grads)
        if self.clip_value is not None:
            torch._foreach_clamp_min_(g, -self.clip_value)
            torch._foreach_clamp_max_(g, self.clip_value)
        if self.clip_norm is not None:
            clip_by_norm_(g, global_norm(g), self.clip_norm)
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        lr = -self.learning_rate(state.count)
        decay = (self.decay_mask if self.decay_mask is not None
                 else [True] * len(params))
        for p, t, m, v, on in zip(params, g, state.mu, state.nu, decay):
            # (1 - b1) g + b1 m and (1 - b2) g^2 + b2 v, each product
            # rounded in its operand's dtype as optax rounds it
            m.mul_(self.b1).add_(t * (1 - self.b1))
            v.mul_(self.b2).add_((t * t) * (1 - self.b2))
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            if self.weight_decay and on:
                u = u + p * self.weight_decay
            p.copy_(p + u * lr)
        return AdamState(count, state.mu, state.nu)
