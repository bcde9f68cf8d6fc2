"""Draft-budget autotune: pick ``total_tokens`` by timing the verify forward.

Counterpart of ``lantern_tpu/engine/autotune.py``.  When ``total_token ==
-1`` the reference loader times the base model's forward at candidate tree
sizes {40, 48, 50, 56, 60}, divides each time by a latency weight {1, 1.05,
1.07, 1.1, 1.13} (larger trees earn more accepted tokens per step), and
keeps the argmin.

The timed op is the tree-verification forward and head: a [2, L]-token
forward against a committed KV prefix, the per-step hot op of speculative
decoding.  On the card it runs K1 (every matmul, at M = 2L rows: two
launches a matmul past 64 rows) and K2 (T = L over the prefix).  The first
call builds the kernels and warms up outside the timed region; the clock is
read after ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from .. import configs
from ..device import synchronize
from ..kv import KVCache
from ..models import transformer as tfm

# (candidate tree size, latency weight), the reference's
CANDIDATES = (40, 48, 50, 56, 60)
WEIGHTS = (1.0, 1.05, 1.07, 1.1, 1.13)


def verify_forward(params: dict, cfg: configs.ModelConfig, length: int,
                   prefix: int = 128, rope=None) -> Callable[[], torch.Tensor]:
    """The timed op as a closure: a [2, length]-token causal forward at
    positions ``prefix..`` against a cache whose first ``prefix`` rows are
    committed (zeros), then the head; each call returns the f32 logits
    [2, length, V].  Runs on the device of ``params``."""
    dev = params["embed"].device
    if rope is None:
        rope = tfm.make_rope_tables(cfg, dev)
    kv = KVCache.create(cfg, 2, device=dev).commit(
        min(prefix, cfg.max_seq_len - length))
    toks = torch.zeros((2, length), dtype=torch.int32, device=dev)
    pos = torch.arange(length, device=dev) + kv.length
    mask = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                 device=dev))

    def fwd() -> torch.Tensor:
        res = tfm.forward(params, cfg, tfm.token_embed(params, toks), kv,
                          positions=pos, rope=rope, block_mask=mask,
                          commit=False)
        return tfm.logits_head(params, res.hidden)

    return fwd


def time_verify_forward(params: dict, cfg: configs.ModelConfig, length: int,
                        prefix: int = 128, iters: int = 20,
                        rope=None) -> float:
    """Steady-state seconds per [2, length]-token verify forward."""
    dev = params["embed"].device
    fwd = verify_forward(params, cfg, length, prefix, rope)
    fwd()                        # builds and warms up outside the clock
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fwd()
    synchronize(dev)
    return (time.perf_counter() - t0) / iters


def autotune_total_tokens(
    params: dict,
    cfg: configs.ModelConfig,
    candidates: Sequence[int] = CANDIDATES,
    weights: Optional[Sequence[float]] = None,
    prefix: int = 128,
    iters: int = 20,
    verbose: bool = False,
) -> int:
    """The latency-weighted-argmin candidate ``total_tokens``."""
    if weights is None:
        weights = WEIGHTS if tuple(candidates) == CANDIDATES else None
    if weights is None:
        # the reference weights interpolated over tree size
        lo, hi = min(candidates), max(candidates)
        weights = [1.0 + 0.13 * (c - lo) / max(1, hi - lo) for c in candidates]
    rope = tfm.make_rope_tables(cfg, params["embed"].device)
    scores = []
    for c, w in zip(candidates, weights):
        dt = time_verify_forward(params, cfg, c, prefix=prefix, iters=iters,
                                 rope=rope)
        scores.append(dt / w)
        if verbose:
            print(f"autotune: L={c} {dt*1e3:.2f} ms/fwd weighted {dt/w*1e3:.2f}")
    return int(candidates[scores.index(min(scores))])
