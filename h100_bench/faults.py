"""Faults planted under the timed path, for the check's own tests and for
reading a number's upper end on the card: each must turn ``correct``
false.

- ``token``: every produced image token is altered where it is produced
  (the bonus token of a verify step, a lockstep AR step's sample) to the
  code half the codebook away; the program serves it and conditions on
  it, as on a token it had drawn;
- ``stuck``: ``BatchedEngine.step`` returns its batch unchanged;
- ``accept_all``: the acceptance walk takes every draft it tries (its
  coins pinned at 0), whatever the relaxed rule says.
"""

from __future__ import annotations

import contextlib

import torch


def _alter(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    span = hi - lo + 1
    img = (x >= lo) & (x <= hi)
    return torch.where(img, lo + (x - lo + span // 2) % span, x).to(x.dtype)


@contextlib.contextmanager
def planted(kind: str, cfg: dict):
    from lantern_tpu_torch.engine import ar, batch, spec
    from lantern_tpu_torch.ops import acceptance

    lo, hi = cfg["image"]["image_token_ids"]
    undo = []
    if kind == "token":
        accept, sample = spec.accept, ar._sample_rows

        def accept_f(*a, **k):
            v = accept(*a, **k)
            return v._replace(bonus=_alter(v.bonus, lo, hi))

        def sample_f(*a, **k):
            return _alter(sample(*a, **k), lo, hi)

        spec.accept, ar._sample_rows = accept_f, sample_f
        undo.append(lambda: (setattr(spec, "accept", accept),
                             setattr(ar, "_sample_rows", sample)))
    elif kind == "stuck":
        step = batch.BatchedEngine.step
        batch.BatchedEngine.step = lambda eng, b: b
        undo.append(lambda: setattr(batch.BatchedEngine, "step", step))
    elif kind == "accept_all":
        walk = acceptance.stochastic_verify_tree

        def walk_f(generator, node_logits, tree_tokens, children, depth,
                   *a, **k):
            k["uniforms"] = torch.zeros((depth, children.shape[1]),
                                        device=node_logits.device)
            return walk(generator, node_logits, tree_tokens, children,
                        depth, *a, **k)

        acceptance.stochastic_verify_tree = walk_f
        undo.append(lambda: setattr(acceptance, "stochastic_verify_tree",
                                    walk))
    else:
        raise ValueError(f"unknown fault {kind!r}")
    try:
        yield
    finally:
        for u in undo:
            u()
