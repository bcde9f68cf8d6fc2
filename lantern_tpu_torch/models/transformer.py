"""The unified decoder as plain functions over parameter dicts.

Counterpart of ``lantern_tpu/models/transformer.py``.  One forward serves
both families: Chameleon (Lumina / Anole: 1-D rope with half pairing,
QK-LayerNorm, swin or pre-norm ordering, token prompts) and LlamaGen (2-D
rope with interleaved pairing over the image grid, pre-norm, a class-label
or T5-caption conditioning prefix from ``cond_embed``).  Every family is
MHA.  The params dict has the JAX package's layout (stacked ``[L, ...]``
layer weights, split or fused, dense or int8, and the unquantized ``cond``
adapters), so ``convert.py`` can move a JAX pytree over unchanged.

Per layer the TPU kernels of the path have hand-written CUDA
counterparts, each reached through a device-dispatching op:
``quant.mm`` (K1, four W8A16 matmuls), ``tree_attention`` (K2), and after
the layer loop ``KVCache.write`` (K3, one launch for all layers).  The
EAGLE drafter runs the same ``forward`` with its own config (pre-norm, no
final norm) and a bf16 cache.

Under a tensor-parallel mesh (``parallel.mesh.set_mesh``) ``forward``
takes this rank's shard of the weights: its head count from the shard's
q columns, and an all-reduce over tp (``quant.mm_row``) right after each
row-split matmul, before anything that follows it (Lumina's swin
post-norms included); ``logits_head`` gathers a vocab-split head.

Training goes through ``forward_train`` (``train_layer_block`` over the
layer stack): cache-free, dense and differentiable, the JAX package's
einsum + softmax math with plain matmuls and no kernel, each layer
recomputed in the backward under ``torch.utils.checkpoint`` when ``remat``
is set (``jax.checkpoint`` in the reference).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..configs import ModelConfig
from ..device import resolve_device
from ..kv import KVCache, group_dims
from ..ops.quant import has_kernel, head_matmul, head_of, mm, mm_row
from ..ops.rope import (apply_rope_half, apply_rope_interleaved,
                        rope_table_1d, rope_table_2d)
from ..ops.tree_attention import NEG_INF, tree_attention
from ..parallel.mesh import tp_group


def make_rope_tables(cfg: ModelConfig, device=None):
    """Rope (cos, sin) f32 tables on ``device``: the 2-D grid table (zero
    rows over the conditioning prefix) or the 1-D one."""
    if cfg.rope_kind == "2d":
        cos, sin = rope_table_2d(cfg.grid_size, cfg.head_dim, cfg.rope_base,
                                 cfg.cls_token_num)
    else:
        cos, sin = rope_table_1d(cfg.max_seq_len, cfg.head_dim, cfg.rope_base)
    dev = resolve_device(device)
    return (torch.from_numpy(np.asarray(cos)).to(dev),
            torch.from_numpy(np.asarray(sin)).to(dev))


def init_params(generator: torch.Generator, cfg: ModelConfig, dtype=None,
                device=None) -> dict:
    """Random-init parameter dict (N(0, 0.02) weights, unit norms) drawn
    from ``generator``, which must live on ``device``."""
    dev = resolve_device(device)
    dt = dtype or cfg.torch_dtype
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    L = cfg.num_layers

    def w(*shape, scale=0.02):
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        x.normal_(generator=generator)
        return (x.mul_(scale)).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {
        "attn_norm": ones(L, H),
        "wq": w(L, H, nh * hd),
        "wk": w(L, H, nkv * hd),
        "wv": w(L, H, nkv * hd),
        "wo": w(L, nh * hd, H),
        "ffn_norm": ones(L, H),
        "w_gate": w(L, H, I),
        "w_up": w(L, H, I),
        "w_down": w(L, I, H),
    }
    if cfg.qk_norm:
        layers["q_norm_w"] = ones(L, nh, hd)
        layers["q_norm_b"] = torch.zeros((L, nh, hd), dtype=dt, device=dev)
        layers["k_norm_w"] = ones(L, nkv, hd)
        layers["k_norm_b"] = torch.zeros((L, nkv, hd), dtype=dt, device=dev)
    params = {
        "embed": w(V, H),
        "layers": layers,
        "norm": ones(H),
        "lm_head": w(H, V),
    }
    if cfg.cond_kind == "label":
        params["cond"] = {"table": w(cfg.num_classes + 1, H)}
    elif cfg.cond_kind == "caption":
        params["cond"] = {
            "fc1": w(cfg.caption_dim, H),
            "fc2": w(H, H),
            "uncond": w(cfg.cls_token_num, cfg.caption_dim,
                        scale=cfg.caption_dim ** -0.5),
        }
    return params


def fuse_params(params: dict) -> dict:
    """Fuse per-layer QKV and gate/up projections into single matmuls
    (``wqkv`` [L, H, (nh + 2 nkv) * hd]: the q, k and v columns at their own
    widths; ``w_gu`` [L, H, 2I])."""
    p = dict(params)
    layers = dict(p["layers"])
    if "wq" in layers:
        layers["wqkv"] = torch.cat(
            [layers.pop("wq"), layers.pop("wk"), layers.pop("wv")], dim=-1)
    if "w_gate" in layers:
        layers["w_gu"] = torch.cat(
            [layers.pop("w_gate"), layers.pop("w_up")], dim=-1)
    p["layers"] = layers
    return p


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return w * (xf * torch.rsqrt(var + eps)).to(x.dtype)


def head_layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """Per-head LayerNorm over head_dim (Chameleon QK-norm).
    x: [B, T, n, hd]; w, b: [n, hd]."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mu) * torch.rsqrt(var + eps)
    return (normed * w + b).to(x.dtype)


def cond_embed(params: dict, cfg: ModelConfig, cond) -> torch.Tensor:
    """Conditioning prefix -> [B, cls_token_num, H].

    - label: int [B] class ids (``num_classes`` selects the uncond row);
    - caption: float [B, cls_token_num, caption_dim] T5 features through the
      two-layer MLP (tanh GELU), as plain matmuls: the JAX package computes
      them outside any kernel and keeps the adapters unquantized."""
    if cfg.cond_kind == "label":
        return params["cond"]["table"][cond.long()][:, None, :]
    if cfg.cond_kind == "caption":
        p = params["cond"]
        h = torch.matmul(cond.to(p["fc1"].dtype), p["fc1"])
        return torch.matmul(F.gelu(h, approximate="tanh"), p["fc2"])
    raise ValueError(f"no conditioning for cond_kind={cfg.cond_kind}")


def token_embed(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][input_ids.long()]


def logits_head(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    return head_matmul(hidden, head_of(params))


def _kernel(lp: dict, name: str) -> torch.Tensor:
    return lp[name] if name in lp else lp[name + "_q"]


def head_counts(cfg: ModelConfig, lp: dict) -> tuple[int, int]:
    """``(query heads, KV heads)`` of the (layer-stacked) weights ``lp``:
    all of them, or one tp rank's share.  A fused ``wqkv`` is
    ``(nh + 2 nkv) * hd`` wide, and a rank keeps the config's ratio
    ``nh / nkv``."""
    hd = cfg.head_dim
    if has_kernel(lp, "wqkv"):
        rep = cfg.num_heads // cfg.num_kv_heads
        nkv = _kernel(lp, "wqkv").shape[-1] // ((rep + 2) * hd)
        return rep * nkv, nkv
    return (_kernel(lp, "wq").shape[-1] // hd,
            _kernel(lp, "wk").shape[-1] // hd)


def local_heads(cfg: ModelConfig, lp: dict) -> int:
    """Query heads of the weights ``lp`` (``head_counts``' first)."""
    return head_counts(cfg, lp)[0]


def cache_groups(cfg: ModelConfig, params: dict) -> int:
    """Head groups of the KV cache that ``params`` serve: all of them, or
    one tp rank's share (``KVCache.create(.., groups=)``)."""
    W = group_dims(cfg.num_kv_heads, cfg.head_dim)[1]
    return head_counts(cfg, params["layers"])[1] * cfg.head_dim // W


def _row_groups(cfg: ModelConfig, lp: dict):
    """The tp group each row-split kernel (``wo``, ``w_down``) reduces over,
    or None where ``lp`` holds all its rows."""
    attn = local_heads(cfg, lp) != cfg.num_heads
    ffn = _kernel(lp, "w_down").shape[-2] != cfg.intermediate_size
    group = tp_group() if attn or ffn else None
    if (attn or ffn) and group is None:
        raise ValueError("forward: the weights are one tp rank's shard; run "
                         "it under parallel.mesh.set_mesh(mesh) with tp > 1")
    return (group if attn else None), (group if ffn else None)


def build_mask(T: int, S: int, cur_len: torch.Tensor,
               block_mask: Optional[torch.Tensor],
               prefix_valid: Optional[torch.Tensor], batch: int):
    """Additive f32 {0, NEG_INF} masks ``(prefix [B, 1, T, S], block
    [B or 1, 1, T, T])``: key j of row b visible iff j < cur_len (a scalar,
    or ``[B]``: one per row) and (optionally) prefix_valid[b, j]; the block
    is ``block_mask`` or causal."""
    dev = cur_len.device
    vis = (torch.arange(S, device=dev)[None, :]
           < cur_len.reshape(-1, 1))                              # [1|B, S]
    if prefix_valid is not None:
        vis = vis & prefix_valid.bool()
    mp = torch.where(vis, 0.0, NEG_INF)
    mp = mp[:, None, None, :].expand(max(mp.shape[0], batch), 1, T, S)
    bm = (torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
          if block_mask is None else block_mask.bool())
    if bm.ndim == 2:
        bm = bm[None]
    mb = torch.where(bm, 0.0, NEG_INF)[:, None]
    return mp, mb


class ForwardResult(NamedTuple):
    hidden: torch.Tensor          # [B, T, H] final-norm hidden states
    kv: KVCache                   # cache with the new block written
    # deferred commit: the block's roped K/V ([L, B, T, n_kv, hd] pair),
    # returned INSTEAD of being written to the cache
    block: object = None


def forward(
    params: dict,
    cfg: ModelConfig,
    embeds: torch.Tensor,            # [B, T, H]
    kv: KVCache,
    positions: torch.Tensor,         # [T] or [B, T] position ids
    rope: tuple[torch.Tensor, torch.Tensor],
    block_mask: Optional[torch.Tensor] = None,   # [T, T] or [B, T, T]
    prefix_valid: Optional[torch.Tensor] = None,  # [B or 1, S] padding mask
    commit: bool = True,
    extra_kv=None,
    defer_block: bool = False,
    window_mask: Optional[torch.Tensor] = None,  # [B or 1, T, window] bool
    write_offset: int = 0,
) -> ForwardResult:
    """Run the decoder over a new token block against the KV cache.

    ``kv.length`` is one committed length for every batch row, or ``[B]``:
    each row then reads its own prefix and writes its block at its own
    length (the batched engine's rows).

    ``extra_kv`` ``(k_ex [L, B, A, n_kv, hd], v_ex, n_valid)``: a previous
    block's accepted rows, committed BEFORE the layer loop (one K3 launch)
    so this block's attention reads them from the cache prefix.
    ``defer_block`` skips writing the new block and returns its roped K/V
    in ``ForwardResult.block``.  ``commit=False`` writes the block without
    advancing the cache length; ``write_offset`` then places it at
    ``length + write_offset``, past earlier provisional rows (the levels of
    a draft tree).  ``window_mask`` shows those rows to this block: cache
    row ``length + u`` is visible to block row ``t`` iff
    ``window_mask[b, t, u]`` (the JAX forward's ``prefix_override``,
    restricted to the rows it ever exposes)."""
    if commit and write_offset != 0:
        raise ValueError("forward(commit=True) requires write_offset == 0")
    B, T, H = embeds.shape
    lp = params["layers"]
    # this rank's heads (all of them without a tp split)
    nh, nkv = head_counts(cfg, lp)
    hd = cfg.head_dim
    wo_group, down_group = _row_groups(cfg, lp)
    if kv.k.shape[2] != cache_groups(cfg, params):
        raise ValueError(
            f"forward: the cache holds {kv.k.shape[2]} head groups, the "
            f"weights serve {cache_groups(cfg, params)}: create it with "
            f"groups=cache_groups(cfg, params)")
    L = cfg.num_layers
    S = kv.max_len
    cos, sin = rope
    if positions.ndim == 1:
        positions = positions[None, :]
    positions = torch.clamp(positions.long(), 0, cos.shape[0] - 1)

    if extra_kv is not None:
        kv = kv.write(extra_kv[0], extra_kv[1], advance=False)
        kv = kv.commit(extra_kv[2])

    dev = embeds.device
    bm = (torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))
          if block_mask is None else block_mask.bool())
    if bm.ndim == 2:
        bm = bm[None]
    # laid out once per forward: the attention op takes them as they are
    bm = bm.expand(B, T, T).contiguous()
    if prefix_valid is None:
        p_bias = torch.zeros((B, S), dtype=torch.float32, device=dev)
    else:
        pv = prefix_valid.bool().expand(B, S)
        p_bias = torch.where(pv, 0.0, NEG_INF)
    apply_rope = (apply_rope_interleaved if cfg.rope_pairing == "interleaved"
                  else apply_rope_half)
    scale = hd ** -0.5
    k_all = torch.empty((L, B, T, nkv, hd), dtype=embeds.dtype, device=dev)
    v_all = torch.empty_like(k_all)

    h = embeds
    for li in range(L):
        w = {name: t[li] for name, t in lp.items()}
        if cfg.swin_norm:
            x = h
        else:
            x = rms_norm(h, w["attn_norm"], cfg.rms_norm_eps)
            if cfg.first_layer_no_input_norm and li == 0:
                x = h
        if has_kernel(w, "wqkv"):
            y = mm(x, w, "wqkv")
            q = y[..., : nh * hd].reshape(B, T, nh, hd)
            k = y[..., nh * hd: (nh + nkv) * hd].reshape(B, T, nkv, hd)
            v = y[..., (nh + nkv) * hd:].reshape(B, T, nkv, hd)
        else:
            q = mm(x, w, "wq").reshape(B, T, nh, hd)
            k = mm(x, w, "wk").reshape(B, T, nkv, hd)
            v = mm(x, w, "wv").reshape(B, T, nkv, hd)
        if cfg.qk_norm:
            q = head_layer_norm(q, w["q_norm_w"], w["q_norm_b"], cfg.norm_eps)
            k = head_layer_norm(k, w["k_norm_w"], w["k_norm_b"], cfg.norm_eps)
        q = apply_rope(q, cos, sin, positions)
        k = apply_rope(k, cos, sin, positions)
        k_all[li] = k
        v_all[li] = v

        o = tree_attention(
            q, k, v, kv.k[li], kv.v[li], kv.length, bm, p_bias, scale,
            k_scale=None if kv.k_scale is None else kv.k_scale[li],
            v_scale=None if kv.v_scale is None else kv.v_scale[li],
            window_mask=window_mask)
        # a row-split wo is reduced here, before the swin post-norm
        attn_out = mm_row(o.reshape(B, T, nh * hd), w, "wo", wo_group)

        if cfg.swin_norm:
            h1 = h + rms_norm(attn_out, w["attn_norm"], cfg.rms_norm_eps)
            mlp_in = h1
        else:
            h1 = h + attn_out
            mlp_in = rms_norm(h1, w["ffn_norm"], cfg.rms_norm_eps)
        if has_kernel(w, "w_gu"):
            gu = mm(mlp_in, w, "w_gu")
            inter = gu.shape[-1] // 2
            act = F.silu(gu[..., :inter]) * gu[..., inter:]
        else:
            act = F.silu(mm(mlp_in, w, "w_gate")) * mm(mlp_in, w, "w_up")
        mlp = mm_row(act, w, "w_down", down_group)
        if cfg.swin_norm:
            mlp = rms_norm(mlp, w["ffn_norm"], cfg.rms_norm_eps)
        h = h1 + mlp

    block = None
    if defer_block:
        block = (k_all, v_all)
    else:
        kv = kv.write(k_all, v_all, advance=commit, offset=write_offset)
    if cfg.final_norm:
        h = rms_norm(h, params["norm"], cfg.rms_norm_eps)
    return ForwardResult(hidden=h, kv=kv, block=block)


def train_mask(T: int, attn_valid: Optional[torch.Tensor],
               device=None) -> torch.Tensor:
    """Additive f32 ``[B or 1, 1, T, T]`` causal (+padding) mask for
    training: key ``u`` of row ``b`` is visible to row ``t`` iff ``u <= t``
    and ``attn_valid[b, u]``."""
    dev = attn_valid.device if attn_valid is not None else device
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=dev))[None]
    if attn_valid is not None:
        causal = causal & attn_valid[:, None, :].bool()
    return torch.where(causal, 0.0, NEG_INF).float()[:, None]


def dense_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``x``'s dtype: f32 activations against bf16 weights
    promote the weights, as JAX's type promotion does (the drafter trains on
    f32 teacher hiddens); the weight's gradient comes back in its dtype."""
    return x @ w.to(x.dtype)


def _train_layer(cfg: ModelConfig, idx: int, positions, rope, mask,
                 h: torch.Tensor, w: dict) -> torch.Tensor:
    B, T, _ = h.shape
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope
    apply_rope = (apply_rope_interleaved if cfg.rope_pairing == "interleaved"
                  else apply_rope_half)
    if cfg.swin_norm:
        x = h
    elif cfg.first_layer_no_input_norm and idx == 0:
        x = h
    else:
        x = rms_norm(h, w["attn_norm"], cfg.rms_norm_eps)
    if "wqkv" in w:
        y = dense_matmul(x, w["wqkv"])
        q = y[..., : nh * hd].reshape(B, T, nh, hd)
        k = y[..., nh * hd: (nh + nkv) * hd].reshape(B, T, nkv, hd)
        v = y[..., (nh + nkv) * hd:].reshape(B, T, nkv, hd)
    else:
        q = dense_matmul(x, w["wq"]).reshape(B, T, nh, hd)
        k = dense_matmul(x, w["wk"]).reshape(B, T, nkv, hd)
        v = dense_matmul(x, w["wv"]).reshape(B, T, nkv, hd)
    if cfg.qk_norm:
        q = head_layer_norm(q, w["q_norm_w"], w["q_norm_b"], cfg.norm_eps)
        k = head_layer_norm(k, w["k_norm_w"], w["k_norm_b"], cfg.norm_eps)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    if nkv != nh:
        # grouped-query: query head n reads KV head n // (nh / nkv)
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
    # scores and values in f32, as the reference's preferred_element_type
    s = torch.einsum("btnh,bunh->bntu", q.float(), k.float()) * (hd ** -0.5)
    p = torch.softmax(s + mask, dim=-1)
    o = torch.einsum("bntu,bunh->btnh", p, v.float())
    attn_out = dense_matmul(o.to(h.dtype).reshape(B, T, nh * hd),
                            w["wo"])
    if cfg.swin_norm:
        h1 = h + rms_norm(attn_out, w["attn_norm"], cfg.rms_norm_eps)
        mlp_in = h1
    else:
        h1 = h + attn_out
        mlp_in = rms_norm(h1, w["ffn_norm"], cfg.rms_norm_eps)
    if "w_gu" in w:
        gu = dense_matmul(mlp_in, w["w_gu"])
        inter = gu.shape[-1] // 2
        mlp = dense_matmul(F.silu(gu[..., :inter]) * gu[..., inter:],
                           w["w_down"])
    else:
        mlp = dense_matmul(F.silu(dense_matmul(mlp_in, w["w_gate"]))
                           * dense_matmul(mlp_in, w["w_up"]), w["w_down"])
    if cfg.swin_norm:
        mlp = rms_norm(mlp, w["ffn_norm"], cfg.rms_norm_eps)
    return h1 + mlp


def train_layer_block(
    layers: dict,                 # layer-stacked weights [Ls, ...]
    cfg: ModelConfig,
    x: torch.Tensor,              # [B, T, H]
    positions: torch.Tensor,      # [B or 1, T] (already clamped)
    rope,
    mask: torch.Tensor,           # additive [B or 1, 1, T, T]
    idx0: int = 0,                # global index of this block's first layer
    remat: bool = True,
    gather=None,                  # (name, one layer's weight) -> its whole
) -> torch.Tensor:
    """Run a (slice of the) layer stack over ``x``: the cache-free training
    block of ``forward_train`` and of pipeline stages, which apply it to
    consecutive layer slices with their global ``idx0`` (layer 0 of a
    drafter skips the input norm).  Takes the split and the fused layouts;
    dense weights only.  ``remat`` recomputes each layer in the backward
    (``checkpoint``, non-reentrant) instead of keeping its activations.
    ``gather`` (FSDP) turns each layer's weight slices into whole weights
    when the layer runs, inside the recomputed function, so remat gathers
    again in the backward and no layer's whole weights outlive it."""
    names = sorted(layers)
    # one unbind a weight: its backward stacks the layers' gradients once
    per_layer = list(zip(*(layers[n].unbind(0) for n in names)))
    for i, ws in enumerate(per_layer):
        def layer(h, *ws, idx=idx0 + i):
            if gather is not None:
                ws = [gather(n, w) for n, w in zip(names, ws)]
            return _train_layer(cfg, idx, positions, rope, mask, h,
                                dict(zip(names, ws)))
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, *ws, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer(x, *ws)
    return x


def forward_train(
    params: dict,
    cfg: ModelConfig,
    embeds: torch.Tensor,         # [B, T, H]
    positions: torch.Tensor,      # [T] or [B, T]
    rope,
    attn_valid: Optional[torch.Tensor] = None,   # [B, T] padding mask
    remat: bool = True,
    gather=None,
) -> torch.Tensor:
    """Cache-free causal forward for training (full-model finetuning,
    teacher-forced distillation): ``train_layer_block`` over every layer,
    then the final norm.  ``remat`` recomputes each layer under grad to
    trade operations for device memory; ``gather``: as
    ``train_layer_block``'s."""
    T = embeds.shape[1]
    cos, _ = rope
    if positions.ndim == 1:
        positions = positions[None, :]
    positions = torch.clamp(positions.long(), 0, cos.shape[0] - 1)
    mask = train_mask(T, attn_valid, device=embeds.device)
    hidden = train_layer_block(params["layers"], cfg, embeds, positions, rope,
                               mask, remat=remat, gather=gather)
    if cfg.final_norm:
        hidden = rms_norm(hidden, params["norm"], cfg.rms_norm_eps)
    return hidden
