"""Weight bridge: a ``lantern_tpu`` parameter pytree -> the port's params.

The port keeps the JAX package's parameter layout, so the bridge is a
checked leaf-by-leaf copy.  It accepts the split layout (``wq``/``wk``/
``wv``, ``w_gate``/``w_up``), the fused layout (``wqkv``, ``w_gu``), the
quantized layout (``*_q`` int8 with ``*_s`` f32 scales, ``lm_head_q``/
``lm_head_s``) and the LANTERN ``nearest_latents`` table.  Leaves arrive as
numpy arrays (``np.asarray`` of each JAX leaf); bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) are moved bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.quant import LAYER_KERNELS

_TOP = {"embed", "norm", "lm_head", "lm_head_q", "lm_head_s",
        "nearest_latents", "layers"}
_LAYER = {"attn_norm", "ffn_norm", "q_norm_w", "q_norm_b", "k_norm_w",
          "k_norm_b"}
_LAYER |= set(LAYER_KERNELS)
_LAYER |= {n + "_q" for n in LAYER_KERNELS} | {n + "_s" for n in LAYER_KERNELS}


def to_tensor(a, device) -> torch.Tensor:
    """One numpy leaf -> a torch tensor on ``device`` (bf16 bit-exact)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _check_pairs(names, where: str) -> None:
    for n in names:
        if n.endswith("_q") and n[:-2] + "_s" not in names:
            raise ValueError(f"{where}: {n} without its scale {n[:-2]}_s")
        if n.endswith("_s") and n[:-2] + "_q" not in names:
            raise ValueError(f"{where}: {n} without its int8 weight {n[:-2]}_q")


def convert_params(params: dict, device=None) -> dict:
    """Convert a Chameleon-family ``lantern_tpu`` param pytree (numpy
    leaves) to the port's dict of tensors on ``device``.  Unknown entries
    (conditioning adapters, drafter-only weights) raise: they belong to
    lanes that are not ported yet."""
    dev = resolve_device(device)
    unknown = set(params) - _TOP
    if unknown:
        raise ValueError(f"convert_params: entries of unported lanes: "
                         f"{sorted(unknown)}")
    layers = params["layers"]
    unknown = set(layers) - _LAYER
    if unknown:
        raise ValueError(f"convert_params: unknown layer entries "
                         f"{sorted(unknown)}")
    _check_pairs(set(layers), "layers")
    _check_pairs({n for n in params if n.startswith("lm_head")}, "lm_head")
    out = {k: to_tensor(v, dev) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: to_tensor(v, dev) for k, v in layers.items()}
    for n in list(out["layers"]) + list(out):
        if n.endswith("_q"):
            src = out["layers"] if n in out["layers"] else out
            if src[n].dtype != torch.int8:
                raise ValueError(f"convert_params: {n} must be int8")
    if "nearest_latents" in out:
        out["nearest_latents"] = out["nearest_latents"].to(torch.int32)
    return out
