"""The plain reference decoder: float32 PyTorch, TF32 off, one layer at a
time over every sequence, no cache, no kernel and no batching.

It follows the published models, not the port's code: LLaMA blocks
(SwiGLU, a final RMSNorm, an untied head), pre-norm, or with
``swin_norm`` (Chameleon) the ordering ``h1 = h + norm(attn(h))``, ``h =
h1 + norm(mlp(h1))``; with ``qk_layernorm`` a per-head LayerNorm on q and k
(weight and bias, over the head's lanes).  What differs by family, the
rope and the rows a request makes, is in ``families/<family>.py``.

The configuration states int8 weights per output channel, an int8 KV cache
per token and 128-lane group, and bfloat16 activations.  The reference works
the int8 weights and the int8 cache out again from the benchmark's bfloat16
weights (``fake_quant``, ``fake_quant_groups``) and computes everything else
in float32.  ``wbits`` / ``kvbits`` = 4 is the control: the same reference
one precision step below the configuration (int4).

A sequence row is a dict: ``ids`` (int64 [T] token ids, or None),
``prefix`` (f32 [Tp, H] embedded prefix rows before the ids, or None),
``positions`` (int64 [Tp + T] rope rows) and ``key_valid`` (bool [Tp + T]:
False on rows no query may read, the caption's pads).  ``logits`` returns,
for each row, the head's f32 logits over the columns ``cols`` at the row
indices ``out_rows``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import families

NEG = -1e30          # finite: a query that sees no key averages all rows
GROUP = 128          # lanes of one KV scale


def strict_f32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric per-output-column quantisation of ``w`` [K, N] over K,
    returned dequantised in f32."""
    qmax = float(2 ** (bits - 1) - 1)
    wf = w.float()
    amax = wf.abs().amax(dim=0, keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.tensor(
        qmax, device=w.device)
    return torch.clamp(torch.round(wf / s), -qmax, qmax) * s


def fake_quant_groups(x: torch.Tensor, bits: int, hd: int) -> torch.Tensor:
    """Symmetric quantisation of ``x`` [T, lanes] with one scale per token
    and group: ``GROUP`` consecutive lanes (a head of 128, or two heads of
    64) where the heads tile them, else one head."""
    qmax = float(2 ** (bits - 1) - 1)
    T, D = x.shape
    w = GROUP if GROUP % hd == 0 and D % GROUP == 0 else hd
    g = x.reshape(T, D // w, w)
    amax = g.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / torch.tensor(
        qmax, device=x.device)
    return (torch.clamp(torch.round(g / s), -qmax, qmax) * s).reshape(T, D)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def head_layer_norm(x, w, b, eps):
    """x [T, n, hd]; w, b [n, hd]."""
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def attention(q, k, v, key_valid):
    """q [T, nh, hd], k/v [T, nkv, hd]: causal, keys masked by
    ``key_valid`` [T]."""
    T, nh, hd = q.shape
    rep = nh // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    s = torch.einsum("tnh,unh->ntu", q, k) / math.sqrt(hd)
    vis = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    vis = vis & key_valid[None, :]
    s = torch.where(vis[None], s, torch.full_like(s, NEG))
    return torch.einsum("ntu,unh->tnh", torch.softmax(s, -1), v)


def _layer(cfg: dict, w: Dict[str, torch.Tensor], h, row, rope, kvbits):
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nkv, hd = cfg["num_key_value_heads"], H // cfg["num_attention_heads"]
    eps = cfg["rms_norm_eps"]
    T = h.shape[0]
    swin = cfg.get("swin_norm", False)
    x = h if swin else rms_norm(h, w["attn_norm"], eps)
    q = (x @ w["wq"]).reshape(T, nh, hd)
    k = (x @ w["wk"]).reshape(T, nkv, hd)
    v = (x @ w["wv"]).reshape(T, nkv, hd)
    if cfg.get("qk_layernorm"):
        q = head_layer_norm(q, w["q_norm_w"], w["q_norm_b"], eps)
        k = head_layer_norm(k, w["k_norm_w"], w["k_norm_b"], eps)
    q, k = rope(q), rope(k)
    k = fake_quant_groups(k.reshape(T, nkv * hd), kvbits, hd).reshape(
        T, nkv, hd)
    v = fake_quant_groups(v.reshape(T, nkv * hd), kvbits, hd).reshape(
        T, nkv, hd)
    o = attention(q, k, v, row["key_valid"]).reshape(T, nh * hd) @ w["wo"]
    if swin:
        h1 = h + rms_norm(o, w["attn_norm"], eps)
        mlp_in = h1
    else:
        h1 = h + o
        mlp_in = rms_norm(h1, w["ffn_norm"], eps)
    mlp = (F.silu(mlp_in @ w["w_gate"]) * (mlp_in @ w["w_up"])) @ w["w_down"]
    if swin:
        mlp = rms_norm(mlp, w["ffn_norm"], eps)
    return h1 + mlp


MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@torch.no_grad()
def logits(cfg: dict, weights: dict, rows: Sequence[dict],
           out_rows: Sequence[torch.Tensor], cols: slice, wbits: int = 8,
           kvbits: int = 8) -> List[torch.Tensor]:
    """f32 logits [len(out_rows[r]), cols] of each row (see the module)."""
    strict_f32()
    dev = weights["embed"].device
    fam = families.of(cfg)
    hs, ropes = [], []
    for row in rows:
        parts = []
        if row.get("prefix") is not None:
            parts.append(row["prefix"].float())
        if row.get("ids") is not None:
            parts.append(weights["embed"][row["ids"]].float())
        hs.append(torch.cat(parts))
        ropes.append(fam.rope(cfg, row, dev))
    lw = weights["layers"]
    for li in range(cfg["num_hidden_layers"]):
        w = {n: (fake_quant(t[li], wbits) if n in MATRICES else t[li])
             for n, t in lw.items()}
        hs = [_layer(cfg, w, h, row, rope, kvbits)
              for h, row, rope in zip(hs, rows, ropes)]
        del w
    head = fake_quant(weights["lm_head"][:, cols], wbits)
    out = []
    for h, idx in zip(hs, out_rows):
        hn = rms_norm(h[idx], weights["norm"], cfg["rms_norm_eps"])
        out.append(hn @ head)
    return out
