"""Weight bridge: a ``lantern_tpu`` parameter pytree -> the port's params.

The port keeps the JAX package's parameter layout, so the bridge is a
checked leaf-by-leaf copy.  It accepts the split layout (``wq``/``wk``/
``wv``, ``w_gate``/``w_up``), the fused layout (``wqkv``, ``w_gu``; with
grouped-query attention ``wk``/``wv`` and ``k_norm_*`` hold ``num_kv_heads``
heads and ``wqkv`` is ``(nh + 2 nkv) * hd`` wide), the
quantized layout (``*_q`` int8 with ``*_s`` f32 scales, ``lm_head_q``/
``lm_head_s``), the LANTERN ``nearest_latents`` table and the LlamaGen
conditioning adapters ``cond`` (a label ``table``, or the caption MLP's
``fc1``, ``fc2`` and ``uncond``; never quantized);
``convert_drafter_params`` carries an EAGLE drafter's pytree (``fc_w`` or
``fc_w_q``/``fc_w_s``, ``fc_b``, the shared ``embed``, no ``norm`` or
``lm_head``); ``convert_vqgan_params`` carries a VQ-GAN codec (HWIO conv
kernels to OIHW).  Leaves arrive as
numpy arrays (``np.asarray`` of each JAX leaf); bfloat16 leaves (numpy's
``ml_dtypes`` bfloat16) are moved bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .ops.quant import LAYER_KERNELS

_TOP = {"embed", "norm", "lm_head", "lm_head_q", "lm_head_s",
        "nearest_latents", "layers", "cond"}
_COND = ({"table"}, {"fc1", "fc2", "uncond"})
_DRAFTER_TOP = {"embed", "fc_w", "fc_w_q", "fc_w_s", "fc_b", "layers"}
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


def _convert(params: dict, top: set, what: str, device, skip=()) -> dict:
    dev = resolve_device(device)
    unknown = set(params) - top
    if unknown:
        raise ValueError(f"{what}: unknown entries {sorted(unknown)} (they "
                         f"belong to another pytree)")
    layers = params["layers"]
    unknown = set(layers) - _LAYER
    if unknown:
        raise ValueError(f"{what}: unknown layer entries {sorted(unknown)}")
    _check_pairs(set(layers), "layers")
    _check_pairs({n for n in params if n.endswith(("_q", "_s"))}, what)
    out = {k: to_tensor(v, dev) for k, v in params.items()
           if k not in ("layers", "cond") and k not in skip}
    if "cond" in params:
        if set(params["cond"]) not in _COND:
            raise ValueError(f"{what}: cond must hold {sorted(_COND[0])} or "
                             f"{sorted(_COND[1])}, got "
                             f"{sorted(params['cond'])}")
        out["cond"] = {k: to_tensor(v, dev) for k, v in params["cond"].items()}
    out["layers"] = {k: to_tensor(v, dev) for k, v in layers.items()}
    for n in list(out["layers"]) + list(out):
        if n.endswith("_q"):
            src = out["layers"] if n in out["layers"] else out
            if src[n].dtype != torch.int8:
                raise ValueError(f"{what}: {n} must be int8")
    return out


def convert_params(params: dict, device=None) -> dict:
    """Convert a ``lantern_tpu`` base-model pytree (numpy leaves) to the port's dict of tensors on ``device``.  Unknown entries
    raise (a drafter's pytree goes through ``convert_drafter_params``)."""
    out = _convert(params, _TOP, "convert_params", device)
    if "nearest_latents" in out:
        out["nearest_latents"] = out["nearest_latents"].to(torch.int32)
    return out


def convert_drafter_params(dparams: dict, device=None,
                           embed: torch.Tensor = None) -> dict:
    """Convert a ``lantern_tpu`` EAGLE-drafter pytree (``init_drafter_params``,
    optionally fused and quantized).  ``embed``: the converted base model's
    embedding tensor, shared instead of copied a second time."""
    out = _convert(dparams, _DRAFTER_TOP, "convert_drafter_params", device,
                   skip=("embed",) if embed is not None else ())
    if embed is not None:
        out["embed"] = embed
    return out


def convert_vqgan_params(vq_params, device=None):
    """Convert a ``lantern_tpu`` VQ-GAN parameter tree (numpy leaves, NHWC
    convs with HWIO kernels) to the port's tree (OIHW kernels): the same
    nesting of dicts and lists, every 4-D conv kernel ``w`` transposed, every
    other leaf copied."""
    dev = resolve_device(device)

    def walk(node, key=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        a = np.asarray(node)
        if key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)                   # HWIO -> OIHW
        return to_tensor(a, dev)

    return walk(vq_params)
