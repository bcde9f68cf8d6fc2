"""Weight-only int8 (W8A16) quantization and the dequant-matmul kernel K1.

Counterpart of ``lantern_tpu/ops/quant.py``.  Layout convention is the
same: a quantized kernel replaces params entry ``name`` with ``name + "_q"``
(int8, same shape) and ``name + "_s"`` (f32 per-output-channel scale).

``mm`` and ``head_matmul`` route every quantized product through
``w8a16_matmul``: on CUDA tensors that launches the hand-written kernel in
``csrc/int8_matmul.cu`` (replacing ``int8_matmul_pallas``,
``lantern_tpu/ops/quant.py:73``); on CPU tensors it runs ``int8_matmul``,
the plain PyTorch version.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..kv import _127

LAYER_KERNELS = ("wqkv", "w_gu", "wq", "wk", "wv", "wo",
                 "w_gate", "w_up", "w_down")

# rows per K1 launch: the kernel keeps all rows of its N-tile in shared
# memory as 16-row mma tiles
K1_MAX_ROWS = 64


def quantize_weight(w: torch.Tensor, axis: int = -2):
    """Symmetric per-output-channel int8 quantization over the contraction
    ``axis``.  Returns ``(q int8, s f32)`` with ``q * s ~= w`` and ``s``
    shaped like ``w`` with ``axis`` collapsed to 1."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / _127(amax)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """Plain dequant-matmul ``(x @ q) * s`` with f32 accumulation (the K1
    kernel's plain version).  bf16 activations times int8 weights are exact
    in f32, so only the summation order can differ from the kernel."""
    y = torch.matmul(x.float(), q.float())
    return (y * s).to(out_dtype or x.dtype)


def int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """K1 on the card: ``x [..., K]`` bf16, ``q [K, N]`` int8, ``s`` [1, N]
    f32 -> ``[..., N]`` bf16 (or f32).  Rows go in launches of at most
    ``K1_MAX_ROWS``; a row's result does not depend on the row count."""
    out_dtype = out_dtype or x.dtype
    *lead, K = x.shape
    N = q.shape[-1]
    _cuda.require(x.dtype == torch.bfloat16, f"int8_matmul: x must be "
                  f"bfloat16 on CUDA, got {x.dtype}")
    _cuda.require(q.dtype == torch.int8 and q.shape == (K, N),
                  f"int8_matmul: q must be int8 [{K}, N], got {q.dtype} "
                  f"{tuple(q.shape)}")
    _cuda.require(s.dtype == torch.float32 and s.numel() == N,
                  "int8_matmul: s must be f32 with N elements")
    _cuda.require(out_dtype in (torch.bfloat16, torch.float32),
                  f"int8_matmul: out dtype {out_dtype} unsupported")
    _cuda.require(K % 8 == 0 and N % 16 == 0,
                  f"int8_matmul: needs K % 8 == 0 and N % 16 == 0, got "
                  f"K={K} N={N}")
    x2 = x.reshape(-1, K).contiguous()
    q = q.contiguous()
    s = s.contiguous()
    _cuda.require(_cuda.aligned(x2) and _cuda.aligned(q),
                  "int8_matmul: x and q must be 16-byte aligned")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ext = _cuda.library()
    for m0 in range(0, M, K1_MAX_ROWS):
        rows = slice(m0, m0 + K1_MAX_ROWS)
        ext.int8_matmul(x2[rows], q, s, out[rows])
        _cuda.LAUNCHES["int8_matmul"] += 1
    return out.reshape(*lead, N)


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """Dispatch by device: K1 on CUDA tensors, ``int8_matmul`` on CPU."""
    if _cuda.on_cuda(x, q, s):
        return int8_matmul_cuda(x, q, s, out_dtype)
    return int8_matmul(x, q, s, out_dtype)


def mm(x: torch.Tensor, w: dict, name: str) -> torch.Tensor:
    """Matmul against ``w[name]``, using the quantized entries if present."""
    if name in w:
        return x @ w[name]
    return w8a16_matmul(x, w[name + "_q"], w[name + "_s"])


def has_kernel(w: dict, name: str) -> bool:
    return name in w or name + "_q" in w


def head_of(params: dict):
    """The lm_head as a dense [H, V] tensor or an ``(int8, scale)`` pair."""
    if "lm_head" in params:
        return params["lm_head"]
    return (params["lm_head_q"], params["lm_head_s"])


def head_matmul(hidden: torch.Tensor, head) -> torch.Tensor:
    """f32 logits from a ``head_of`` value."""
    if isinstance(head, tuple):
        return w8a16_matmul(hidden, head[0], head[1], out_dtype=torch.float32)
    return (hidden @ head).float()


def _quantize_stacked(w: torch.Tensor):
    """quantize_weight over a [L, K, N] stack one layer at a time (bounds
    the f32 temporaries at 7B scale; the result is identical)."""
    if w.ndim != 3:
        return quantize_weight(w)
    qs, ss = zip(*(quantize_weight(w[i]) for i in range(w.shape[0])))
    return torch.stack(qs), torch.stack(ss)


def quantize_params(params: dict) -> dict:
    """Quantize the decoder's matmul kernels, the lm_head and a drafter's
    input-fusion projection ``fc_w``; embeddings, norms and biases keep
    their dtype.  Either layer layout."""
    p = dict(params)
    layers = dict(p["layers"])
    for name in LAYER_KERNELS:
        if name in layers:
            q, s = _quantize_stacked(layers.pop(name))
            layers[name + "_q"] = q
            layers[name + "_s"] = s
    p["layers"] = layers
    if "fc_w" in p:
        p["fc_w_q"], p["fc_w_s"] = quantize_weight(p.pop("fc_w"))
    if "lm_head" in p:
        p["lm_head_q"], p["lm_head_s"] = quantize_weight(p.pop("lm_head"))
    return p
