"""Checkpoint IO: HF / torch checkpoints -> the port's parameter dicts, and
a native save / restore.

Counterpart of ``lantern_tpu/utils/checkpoint.py``.  The name maps follow
the published module names, so LANTERN / LlamaGen / Chameleon / drafter
checkpoints load directly:

- base LlamaGen (``modeling_llamagen_kv.py``): ``model.embed_tokens``,
  ``model.layers.N.{self_attn.{q,k,v,o}_proj, mlp.{gate,up,down}_proj,
  input_layernorm, post_attention_layernorm}``, ``model.norm``,
  ``lm_head``, ``model.cls_embedding.*``;
- Chameleon (Anole-7b, Lumina-mGPT): the same plus per-head QK-norm
  (``self_attn.{q,k}_norm.{weight,bias}``, stored once per model-parallel
  shard by Lumina);
- the EAGLE drafter: ``embed_tokens``, ``fc``, ``layers.0...``.

Linear weights are transposed once to the ``[in, out]`` convention and
stacked over layers, and the projections are fused as ``fuse_params``
fuses them (``wqkv``, ``w_gu``): the layout the port's forward and
``quantize_params`` take.  The native format is ``torch.save`` of the
param dict, read back with ``torch.load(weights_only=True)``.  The
``safetensors`` package is imported only for a ``.safetensors`` file.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..configs import DrafterConfig, ModelConfig
from ..device import resolve_device
from ..models.transformer import fuse_params


def _as_f32(t: torch.Tensor) -> torch.Tensor:
    return t.float() if t.is_floating_point() else t


def load_torch_file(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors or torch .bin/.pt/.ckpt file -> CPU tensors (floating
    ones as f32; non-tensor metadata dropped)."""
    if path.endswith(".safetensors"):
        from safetensors import safe_open

        out = {}
        with safe_open(path, framework="pt") as f:
            for k in f.keys():
                out[k] = _as_f32(f.get_tensor(k))
        return out
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        # Lightning-style ckpts (taming VQGAN) carry non-tensor metadata
        # that weights_only rejects
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict):
        for wrapper in ("model", "state_dict"):
            if wrapper in sd and isinstance(sd[wrapper], dict):
                sd = sd[wrapper]
                break
    out = {}
    for k, v in sd.items():
        if isinstance(v, torch.Tensor):
            out[k] = _as_f32(v)
        elif isinstance(v, (np.ndarray, int, float, list, tuple)):
            out[k] = torch.as_tensor(np.asarray(v))
    return out


def load_torch_dir(path: str) -> Dict[str, torch.Tensor]:
    """A HF model dir (sharded or single safetensors / pytorch_model), or one
    file."""
    if os.path.isfile(path):
        return load_torch_file(path)
    for index in ("model.safetensors.index.json",
                  "pytorch_model.bin.index.json"):
        ip = os.path.join(path, index)
        if os.path.exists(ip):
            with open(ip) as f:
                weight_map = json.load(f)["weight_map"]
            out = {}
            for shard in sorted(set(weight_map.values())):
                out.update(load_torch_file(os.path.join(path, shard)))
            return out
    for name in ("model.safetensors", "pytorch_model.bin"):
        p = os.path.join(path, name)
        if os.path.exists(p):
            return load_torch_file(p)
    raise FileNotFoundError(f"no checkpoint found under {path}")


def _t(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))


class _Mapper:
    """Reads a state dict into tensors of one dtype on one device."""

    def __init__(self, sd, L: int, dtype, device):
        self.sd, self.L, self.dt = sd, L, dtype
        self.dev = resolve_device(device)

    def one(self, key: str, transpose: bool = False) -> torch.Tensor:
        w = _t(self.sd[key]).float()
        return (w.T if transpose else w).contiguous().to(self.dt).to(self.dev)

    def stack(self, fmt: str, transpose: bool = False) -> torch.Tensor:
        return torch.stack([self.one(fmt.format(li), transpose)
                            for li in range(self.L)])

    def linear_layers(self, p: str, attn_norm=None) -> dict:
        """The stacked layer weights under prefix ``p`` (``attn_norm``:
        given, or read)."""
        S = self.stack
        return {
            "attn_norm": (S(p + "layers.{}.input_layernorm.weight")
                          if attn_norm is None else attn_norm),
            "wq": S(p + "layers.{}.self_attn.q_proj.weight", True),
            "wk": S(p + "layers.{}.self_attn.k_proj.weight", True),
            "wv": S(p + "layers.{}.self_attn.v_proj.weight", True),
            "wo": S(p + "layers.{}.self_attn.o_proj.weight", True),
            "ffn_norm": S(p + "layers.{}.post_attention_layernorm.weight"),
            "w_gate": S(p + "layers.{}.mlp.gate_proj.weight", True),
            "w_up": S(p + "layers.{}.mlp.up_proj.weight", True),
            "w_down": S(p + "layers.{}.mlp.down_proj.weight", True),
        }


def llamagen_params_from_torch(sd, cfg: ModelConfig, prefix: str = "model.",
                               dtype=None, device=None) -> dict:
    """A LlamaGen LlamaForCausalLM state dict -> the port's fused params on
    ``device`` (``None`` is ``cuda``)."""
    m = _Mapper(sd, cfg.num_layers, dtype or cfg.torch_dtype, device)
    p = prefix
    params = {
        "embed": m.one(p + "embed_tokens.weight"),
        "layers": m.linear_layers(p),
        "norm": m.one(p + "norm.weight"),
        "lm_head": m.one("lm_head.weight", True),
    }
    if cfg.cond_kind == "label":
        params["cond"] = {
            "table": m.one(p + "cls_embedding.embedding_table.weight")}
    elif cfg.cond_kind == "caption":
        params["cond"] = {
            "fc1": m.one(p + "cls_embedding.cap_proj.fc1.weight", True),
            "fc2": m.one(p + "cls_embedding.cap_proj.fc2.weight", True),
            "uncond": m.one(p + "cls_embedding.uncond_embedding"),
        }
    return fuse_params(params)


def chameleon_params_from_torch(sd, cfg: ModelConfig, prefix: str = "model.",
                                dtype=None, device=None) -> dict:
    """A HF ChameleonForConditionalGeneration state dict (Anole-7b,
    Lumina-mGPT) -> the port's fused params: the LLaMA layout plus
    per-head QK-norm as ``[L, heads, head_dim]``.  Lumina stores one
    QK-norm row per model-parallel shard, each repeated over its heads."""
    m = _Mapper(sd, cfg.num_layers, dtype or cfg.torch_dtype, device)
    nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = prefix

    def qknorm(fmt, heads):
        ws = []
        for li in range(cfg.num_layers):
            w = _t(sd[p + fmt.format(li)]).float().reshape(-1, hd)
            if w.shape[0] < heads:
                if heads % w.shape[0]:
                    raise ValueError(
                        f"{fmt.format(li)}: {w.shape[0]} stored rows don't "
                        f"tile {heads} heads")
                w = w.repeat_interleave(heads // w.shape[0], dim=0)
            ws.append(w[:heads])
        return torch.stack(ws).to(m.dt).to(m.dev)

    layers = m.linear_layers(p)
    if cfg.qk_norm:
        layers["q_norm_w"] = qknorm("layers.{}.self_attn.q_norm.weight", nh)
        layers["q_norm_b"] = qknorm("layers.{}.self_attn.q_norm.bias", nh)
        layers["k_norm_w"] = qknorm("layers.{}.self_attn.k_norm.weight", nkv)
        layers["k_norm_b"] = qknorm("layers.{}.self_attn.k_norm.bias", nkv)
    return fuse_params({
        "embed": m.one(p + "embed_tokens.weight"),
        "layers": layers,
        "norm": m.one(p + "norm.weight"),
        "lm_head": m.one("lm_head.weight", True),
    })


def drafter_params_from_torch(sd, dcfg: DrafterConfig,
                              embed: Optional[torch.Tensor] = None,
                              dtype=None, device=None) -> dict:
    """An EAGLE drafter state dict -> the port's fused drafter params.
    ``embed`` (the base model's embedding) replaces the checkpoint's frozen
    copy when given."""
    mc = dcfg.model
    L = mc.num_layers
    m = _Mapper(sd, L, dtype or mc.torch_dtype, device)
    # layer 0 has no input norm in the drafter: a unit row keeps the stack
    # uniform (the forward skips it)
    layers = m.linear_layers("", attn_norm=torch.stack([
        m.one(f"layers.{li}.input_layernorm.weight")
        if f"layers.{li}.input_layernorm.weight" in sd
        else torch.ones((mc.hidden_size,), dtype=m.dt, device=m.dev)
        for li in range(L)]))
    if mc.qk_norm:
        hd = mc.head_dim

        def qn(fmt, heads):
            return torch.stack([
                _t(sd[fmt.format(li)]).float().reshape(-1, hd)[:heads]
                for li in range(L)]).to(m.dt).to(m.dev)

        layers["q_norm_w"] = qn("layers.{}.self_attn.q_norm.weight",
                                mc.num_heads)
        layers["q_norm_b"] = qn("layers.{}.self_attn.q_norm.bias",
                                mc.num_heads)
        layers["k_norm_w"] = qn("layers.{}.self_attn.k_norm.weight",
                                mc.num_kv_heads)
        layers["k_norm_b"] = qn("layers.{}.self_attn.k_norm.bias",
                                mc.num_kv_heads)
    return fuse_params({
        "layers": layers,
        "fc_w": m.one("fc.weight", True),
        "fc_b": (m.one("fc.bias") if "fc.bias" in sd else
                 torch.zeros((mc.hidden_size,), dtype=m.dt, device=m.dev)),
        "embed": embed if embed is not None else m.one("embed_tokens.weight"),
    })


# ---------------------------------------------------------------------------
# native checkpoints
# ---------------------------------------------------------------------------

def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


def save_pytree(path: str, tree) -> None:
    """``torch.save`` of a param dict (nested dicts / lists of tensors)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(tree, path)


def restore_pytree(path: str, like=None, device=None):
    """Read a ``save_pytree`` file back (``weights_only``: tensors and
    containers only) onto ``device`` (``None`` is ``cuda``).  With ``like``,
    the tree's structure, shapes and dtypes must equal ``like``'s."""
    tree = torch.load(path, map_location=resolve_device(device),
                      weights_only=True)
    if like is not None and _shapes(tree) != _shapes(like):
        raise ValueError(f"{path}: the stored tree does not match `like` "
                         f"(structure, shapes or dtypes differ)")
    return tree


def meta_chameleon_to_hf(shards, num_layers: int, n_heads: int, dim: int,
                         n_kv_heads: int = None) -> Dict[str, np.ndarray]:
    """Original-Meta Chameleon ``consolidated.*.pth`` shard dict(s) (numpy
    arrays) -> the HF-layout state dict ``chameleon_params_from_torch``
    reads: q / k get the sliced-rotary permute (interleaved Meta rope ->
    half pairing), as do the QK-norm gamma / beta; MLP w1 / w2 / w3 map to
    gate / down / up; shards concatenate on the converter's axes, and the
    replicated norms of several shards stack."""
    if isinstance(shards, dict):
        shards = [shards]
    ns = len(shards)
    n_kv = n_kv_heads or n_heads
    hd = dim // n_heads

    def permute(w, heads, dim1=dim, dim2=dim):
        w = np.asarray(w).reshape(heads, dim1 // heads // 2, 2, dim2)
        return w.transpose(0, 2, 1, 3).reshape(dim1, dim2)

    def cat(key, axis):
        return np.concatenate([np.asarray(s[key]) for s in shards], axis=axis)

    def qk_permute(v):
        r = np.asarray(v).reshape(-1, hd // 2, 2)
        return r.transpose(0, 2, 1).reshape(np.shape(v))

    out: Dict[str, np.ndarray] = {}
    for li in range(num_layers):
        P = f"layers.{li}."
        O = f"model.layers.{li}."
        out[O + "self_attn.q_proj.weight"] = permute(
            cat(P + "attention.wq.weight", 0), n_heads)
        out[O + "self_attn.k_proj.weight"] = permute(
            cat(P + "attention.wk.weight", 0), n_kv, dim1=hd * n_kv)
        out[O + "self_attn.v_proj.weight"] = cat(P + "attention.wv.weight", 0)
        out[O + "self_attn.o_proj.weight"] = cat(P + "attention.wo.weight", 1)
        for norm, hf in (("q_normalization", "q_norm"),
                         ("k_normalization", "k_norm")):
            for part in ("weight", "bias"):
                key = P + f"attention.{norm}.{part}"
                if key in shards[0]:
                    out[O + f"self_attn.{hf}.{part}"] = qk_permute(cat(key, 0))
        out[O + "mlp.gate_proj.weight"] = cat(P + "feed_forward.w1.weight", 0)
        out[O + "mlp.down_proj.weight"] = cat(P + "feed_forward.w2.weight", 1)
        out[O + "mlp.up_proj.weight"] = cat(P + "feed_forward.w3.weight", 0)
        if ns == 1:
            out[O + "input_layernorm.weight"] = np.asarray(
                shards[0][P + "attention_norm.weight"])
            out[O + "post_attention_layernorm.weight"] = np.asarray(
                shards[0][P + "ffn_norm.weight"])
        else:
            out[O + "input_layernorm.weight"] = np.stack(
                [np.asarray(s[P + "attention_norm.weight"]) for s in shards])
            out[O + "post_attention_layernorm.weight"] = np.stack(
                [np.asarray(s[P + "ffn_norm.weight"]) for s in shards])
    out["model.embed_tokens.weight"] = cat("tok_embeddings.weight",
                                           1 if ns > 1 else 0)
    if ns == 1:
        out["model.norm.weight"] = np.asarray(shards[0]["norm.weight"])
    else:
        out["model.norm.weight"] = np.stack(
            [np.asarray(s["norm.weight"]) for s in shards]).mean(axis=0)
    out["lm_head.weight"] = cat("output.weight", 0)
    return out


def load_meta_chameleon_dir(path: str):
    """An original-Meta Chameleon checkpoint directory (``consolidated.NN.pth``
    shards + ``params.json``) -> ``(hf_state_dict, params_json)``."""
    import glob

    with open(os.path.join(path, "params.json")) as f:
        pj = json.load(f)
    files = sorted(glob.glob(os.path.join(path, "consolidated.*.pth")))
    if not files:
        raise FileNotFoundError(f"no consolidated.*.pth under {path}")
    shards = [
        {k: _as_f32(v).numpy() for k, v in
         torch.load(f, map_location="cpu", weights_only=True).items()}
        for f in files
    ]
    model = pj.get("model", pj)
    sd = meta_chameleon_to_hf(
        shards, num_layers=model["n_layers"], n_heads=model["n_heads"],
        dim=model["dim"], n_kv_heads=model.get("n_kv_heads"))
    return sd, pj
