"""Offline image-quality evals (counterpart of ``lantern_tpu/evals``)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def pinned_tensors(state_dict, shapes: Dict[str, tuple], what: str
                   ) -> Dict[str, torch.Tensor]:
    """The tensors of a pinned census out of ``state_dict`` (numpy arrays
    or tensors), as f32 CPU tensors.  A missing or misshapen tensor is a
    ``ValueError``; keys outside the census are ignored."""
    missing = [k for k in shapes if k not in state_dict]
    if missing:
        raise ValueError(f"{what} state dict missing {len(missing)} tensors, "
                         f"e.g. {missing[:4]}")
    bad = [k for k, s in shapes.items() if tuple(np.shape(state_dict[k])) != s]
    if bad:
        raise ValueError(f"{what} state dict shapes differ from the census "
                         f"at {bad[:4]}: "
                         f"{[tuple(np.shape(state_dict[k])) for k in bad[:4]]}")
    return {k: torch.as_tensor(state_dict[k]).to(torch.float32)
            for k in shapes}


def read_state_dict(path: str) -> dict:
    """A state dict from a ``.npz`` (numpy arrays) or a torch ``.pth``
    (tensors, ``weights_only``)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    return torch.load(path, map_location="cpu", weights_only=True)
