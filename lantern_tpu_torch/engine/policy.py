"""Serving policy: draft shape, or lockstep AR, by slot count.

Counterpart of ``lantern_tpu/engine/policy.py``: the same rule
(``serving_plan``) over a table of its own.  Speculation multiplies the
rows of every forward by the tree's size; batching multiplies the tokens
of every weight stream.  As the slot count R grows the one gain overlaps
the other, so the best configuration moves from big trees to small ones
to plain AR, and where it moves is a property of the card and of the host
that drives it, not of the model alone.  On the H100 the serving paths are
host-bound: the batched speculative step pays host glue per slot, lockstep
AR pays one forward's launches for all slots.

``MEASURED_BEST`` is what ``python -m lantern_tpu_torch.engine.sweep``
measured on the card (int8 weights and int8 KV on both paths, LANTERN
k=10 delta=5, top-2000, cfg 3.0, random weights; PERF.md, "the serving
policy").  Callers: ``session.generate_batch(tree="auto")`` of both
session classes, and through it ``generate_images --tree-choices auto
--slots N``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

# "calibrated" in the table: the repository's calibrated Lumina tree
CALIBRATED_LUMINA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "ckpts", "bench_tree_lumina.json")

# The winners by geometry and R: the highest median aggregate tok/s over 3
# timed repeats after a warm-up, on "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader), from
# ``python -m lantern_tpu_torch.engine.sweep --geom xl`` (36 layers, 128
# tokens) and ``--geom lumina`` (32 layers, 16x16 grid), with the
# acceptance walk as one K5 launch a slot.  Both draft from the stale
# distribution, which is what a session with the passthrough drafter serves
# in static mode; the port has no trained drafter for its base, whose
# forwards would add a per-slot cost at another compression.  Within spread
# (the winner's slowest repeat under the runner-up's fastest), each against
# another tree: XL R=1 (chain against chain_bush_8), R=4 (naive_extend_57
# against chain), R=8 (chain_bush_8 against chain), Lumina R=1 and R=2
# (calibrated against chain_bush_8); every winner clears the other mode.
MEASURED_BEST = {
    "llamagen_xl": {
        1: ("spec", "chain"),
        4: ("spec", "naive_extend_57"),
        8: ("spec", "chain_bush_8"),
        16: ("ar", None),
    },
    "lumina_7b": {
        1: ("spec", "calibrated"),
        2: ("spec", "calibrated"),
        4: ("spec", "calibrated"),
    },
}


def resolve_tree(name: str) -> str:
    """A table's tree name as ``trees.get_tree`` takes it: "calibrated" is
    ``CALIBRATED_LUMINA`` where it exists, else ``chain_bush_8`` (the JAX
    Lumina session's fallback); any other name is itself."""
    if name != "calibrated":
        return name
    return (CALIBRATED_LUMINA if os.path.exists(CALIBRATED_LUMINA)
            else "chain_bush_8")


def serving_plan(slots: int,
                 geometry: str = "llamagen_xl") -> Tuple[str, Optional[str]]:
    """``(mode, tree_name)`` for ``slots`` concurrent requests: mode "spec"
    with a static tree name (``resolve_tree`` reads "calibrated"), or mode
    "ar" (lockstep batched AR) with None.  One slot or fewer takes the
    smallest measured R; otherwise the nearest measured R, ties toward the
    larger.  An unknown geometry uses ``llamagen_xl``'s table."""
    table = MEASURED_BEST.get(geometry) or MEASURED_BEST["llamagen_xl"]
    if slots <= 1:
        return table[min(table)]
    best_r = min(table, key=lambda r: abs(r - slots))
    for r in table:
        if abs(r - slots) == abs(best_r - slots):
            best_r = max(best_r, r)
    return table[best_r]
