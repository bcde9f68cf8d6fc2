"""OpenAI-CLIP ViT towers, the pinned CLIP-score and HPSv2.1 backbones.

Counterpart of ``lantern_tpu/evals/clip.py``.  The reference scores CLIP
similarity with the OpenAI ``clip`` package's ViT-B/32 (bicubic resize,
center crop, CLIP mean / std, the "A photo depicts " token splice, cosine
similarity) and HPS with the ``hpsv2`` package's v2.1 checkpoint, an
OpenCLIP ViT-H/14 fine-tune scored as the diagonal of normalised image @
text.T.  ``expected_state_dict_shapes(geom)`` is the exact census of the
canonical checkpoint (OpenAI / OpenCLIP naming, shared by both lineages);
the parameters are that state dict's tensors, by name, on one device.

- ``VIT_B32``: OpenAI CLIP ViT-B/32 (QuickGELU), the CLIP-score backbone;
- ``VIT_H14``: OpenCLIP ViT-H/14 (exact GELU), the HPSv2.1 backbone.

Attention is a plain f32 ``matmul`` + ``softmax``, as in the JAX ``_attn``
(no SDPA, so no library backend choice moves the result), under
``full_f32`` on the card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import pinned_tensors
from ..device import full_f32, resolve_device
from ..utils.image import resize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPGeom:
    vision_width: int
    vision_layers: int
    vision_heads: int
    patch: int
    image_size: int
    embed_dim: int
    text_width: int
    text_layers: int
    text_heads: int
    vocab: int = 49408
    ctx: int = 77
    quick_gelu: bool = True     # OpenAI checkpoints; OpenCLIP uses exact GELU

    @property
    def grid(self) -> int:
        return self.image_size // self.patch


VIT_B32 = CLIPGeom(vision_width=768, vision_layers=12, vision_heads=12,
                   patch=32, image_size=224, embed_dim=512,
                   text_width=512, text_layers=12, text_heads=8,
                   quick_gelu=True)
# HPSv2.1 backbone: OpenCLIP ViT-H-14 (laion2B lineage)
VIT_H14 = CLIPGeom(vision_width=1280, vision_layers=32, vision_heads=16,
                   patch=14, image_size=224, embed_dim=1024,
                   text_width=1024, text_layers=24, text_heads=16,
                   quick_gelu=False)


def _block_shapes(prefix: str, width: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.ln_1.weight": (width,),
        f"{prefix}.ln_1.bias": (width,),
        f"{prefix}.attn.in_proj_weight": (3 * width, width),
        f"{prefix}.attn.in_proj_bias": (3 * width,),
        f"{prefix}.attn.out_proj.weight": (width, width),
        f"{prefix}.attn.out_proj.bias": (width,),
        f"{prefix}.ln_2.weight": (width,),
        f"{prefix}.ln_2.bias": (width,),
        f"{prefix}.mlp.c_fc.weight": (4 * width, width),
        f"{prefix}.mlp.c_fc.bias": (4 * width,),
        f"{prefix}.mlp.c_proj.weight": (width, 4 * width),
        f"{prefix}.mlp.c_proj.bias": (width,),
    }


def expected_state_dict_shapes(geom: CLIPGeom = VIT_B32) -> Dict[str, tuple]:
    """Tensor census of the canonical checkpoint (OpenAI/OpenCLIP naming)."""
    g = geom
    exp: Dict[str, tuple] = {
        "visual.class_embedding": (g.vision_width,),
        "visual.positional_embedding": (g.grid * g.grid + 1, g.vision_width),
        "visual.conv1.weight": (g.vision_width, 3, g.patch, g.patch),
        "visual.ln_pre.weight": (g.vision_width,),
        "visual.ln_pre.bias": (g.vision_width,),
        "visual.ln_post.weight": (g.vision_width,),
        "visual.ln_post.bias": (g.vision_width,),
        "visual.proj": (g.vision_width, g.embed_dim),
        "token_embedding.weight": (g.vocab, g.text_width),
        "positional_embedding": (g.ctx, g.text_width),
        "ln_final.weight": (g.text_width,),
        "ln_final.bias": (g.text_width,),
        "text_projection": (g.text_width, g.embed_dim),
        "logit_scale": (),
    }
    for i in range(g.vision_layers):
        exp.update(_block_shapes(f"visual.transformer.resblocks.{i}",
                                 g.vision_width))
    for i in range(g.text_layers):
        exp.update(_block_shapes(f"transformer.resblocks.{i}", g.text_width))
    return exp


def _unwrap(sd: dict) -> dict:
    """Strip hpsv2 / lightning wrappers: {'state_dict': ...} and a uniform
    leading 'module.' or 'model.' key prefix."""
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    for pre in ("module.", "model."):
        if sd and all(k.startswith(pre) for k in sd):
            sd = {k[len(pre):]: v for k, v in sd.items()}
    return sd


def params_from_openai(sd, geom: CLIPGeom = VIT_B32, device=None
                       ) -> Dict[str, torch.Tensor]:
    """An OpenAI / OpenCLIP state dict (numpy arrays or tensors, wrappers
    stripped) -> the census tensors in f32 on ``device`` (``None``:
    ``cuda``), by name; a missing or misshapen tensor is a ``ValueError``."""
    dev = resolve_device(device)
    params = pinned_tensors(_unwrap(sd), expected_state_dict_shapes(geom),
                            f"CLIP ({geom})")
    return {k: v.to(dev) for k, v in params.items()}


def hf_to_openai(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """transformers-CLIPModel state dict -> OpenAI/OpenCLIP naming (the
    census format above)."""
    a = lambda k: np.asarray(sd[k], np.float32)  # noqa: E731
    out: Dict[str, np.ndarray] = {
        "visual.class_embedding": a("vision_model.embeddings.class_embedding"),
        "visual.positional_embedding":
            a("vision_model.embeddings.position_embedding.weight"),
        "visual.conv1.weight":
            a("vision_model.embeddings.patch_embedding.weight"),
        "visual.ln_pre.weight": a("vision_model.pre_layrnorm.weight"),
        "visual.ln_pre.bias": a("vision_model.pre_layrnorm.bias"),
        "visual.ln_post.weight": a("vision_model.post_layernorm.weight"),
        "visual.ln_post.bias": a("vision_model.post_layernorm.bias"),
        "visual.proj": a("visual_projection.weight").T,
        "token_embedding.weight": a("text_model.embeddings.token_embedding.weight"),
        "positional_embedding":
            a("text_model.embeddings.position_embedding.weight"),
        "ln_final.weight": a("text_model.final_layer_norm.weight"),
        "ln_final.bias": a("text_model.final_layer_norm.bias"),
        "text_projection": a("text_projection.weight").T,
        "logit_scale": a("logit_scale"),
    }

    def blocks(src, dst):
        i = 0
        while f"{src}.{i}.self_attn.q_proj.weight" in sd:
            p, q = f"{src}.{i}", f"{dst}.{i}"
            out[f"{q}.attn.in_proj_weight"] = np.concatenate(
                [a(f"{p}.self_attn.{x}_proj.weight") for x in "qkv"], axis=0)
            out[f"{q}.attn.in_proj_bias"] = np.concatenate(
                [a(f"{p}.self_attn.{x}_proj.bias") for x in "qkv"], axis=0)
            out[f"{q}.attn.out_proj.weight"] = a(f"{p}.self_attn.out_proj.weight")
            out[f"{q}.attn.out_proj.bias"] = a(f"{p}.self_attn.out_proj.bias")
            out[f"{q}.ln_1.weight"] = a(f"{p}.layer_norm1.weight")
            out[f"{q}.ln_1.bias"] = a(f"{p}.layer_norm1.bias")
            out[f"{q}.ln_2.weight"] = a(f"{p}.layer_norm2.weight")
            out[f"{q}.ln_2.bias"] = a(f"{p}.layer_norm2.bias")
            out[f"{q}.mlp.c_fc.weight"] = a(f"{p}.mlp.fc1.weight")
            out[f"{q}.mlp.c_fc.bias"] = a(f"{p}.mlp.fc1.bias")
            out[f"{q}.mlp.c_proj.weight"] = a(f"{p}.mlp.fc2.weight")
            out[f"{q}.mlp.c_proj.bias"] = a(f"{p}.mlp.fc2.bias")
            i += 1

    blocks("vision_model.encoder.layers", "visual.transformer.resblocks")
    blocks("text_model.encoder.layers", "transformer.resblocks")
    return out


def random_state_dict(geom: CLIPGeom = VIT_B32, seed: int = 0, rng=None
                      ) -> Dict[str, np.ndarray]:
    """The census with random weights, drawn as the JAX
    ``init_random_params`` draws them: N(0, 0.02) matrices, N(0, 1)
    vectors, zero biases, unit LayerNorm scales, logit scale log(1/0.07).
    ``rng``: what draws the normals (numpy's ``normal(scale=, size=)``;
    default ``np.random.default_rng(seed)``)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    sd = {}
    for k, s in expected_state_dict_shapes(geom).items():
        scale = 0.02 if len(s) != 1 else 1.0
        sd[k] = (rng.normal(scale=scale, size=s).astype(np.float32)
                 if not k.endswith("bias") else np.zeros(s, np.float32))
        if k.endswith(("ln_1.weight", "ln_2.weight", "ln_pre.weight",
                       "ln_post.weight", "ln_final.weight")):
            sd[k] = np.ones(s, np.float32)
    sd["logit_scale"] = np.float32(np.log(1 / 0.07))
    return sd


def _ln(x, p, name):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"],
                        p[name + ".bias"], 1e-5)


def _attn(x, p, pre: str, heads: int, mask=None):
    N, T, W = x.shape
    hd = W // heads
    qkv = F.linear(x, p[pre + "in_proj_weight"], p[pre + "in_proj_bias"])
    q, k, v = (t.reshape(N, T, heads, hd).transpose(1, 2)
               for t in qkv.split(W, dim=-1))
    att = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
    if mask is not None:
        att = att + mask
    y = (att.softmax(dim=-1) @ v).transpose(1, 2).reshape(N, T, W)
    return F.linear(y, p[pre + "out_proj.weight"], p[pre + "out_proj.bias"])


def _tower(x, p, prefix: str, layers: int, heads: int, quick: bool,
           mask=None):
    for i in range(layers):
        b = f"{prefix}.{i}."
        x = x + _attn(_ln(x, p, b + "ln_1"), p, b + "attn.", heads, mask)
        h = F.linear(_ln(x, p, b + "ln_2"), p[b + "mlp.c_fc.weight"],
                     p[b + "mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h) if quick else F.gelu(h)
        x = x + F.linear(h, p[b + "mlp.c_proj.weight"],
                         p[b + "mlp.c_proj.bias"])
    return x


@torch.no_grad()
def encode_image(params, images, geom: CLIPGeom = VIT_B32) -> torch.Tensor:
    """``[N, 224, 224, 3]`` float RGB in [0, 1] -> ``[N, embed_dim]``
    (unnormalised).  CLIP mean / std here; the resize and crop are
    ``preprocess_images``'."""
    g, p = geom, params
    dev = p["visual.proj"].device
    with full_f32():
        x = torch.as_tensor(images).to(dev, torch.float32)
        x = (x - x.new_tensor(CLIP_MEAN)) / x.new_tensor(CLIP_STD)
        N = x.shape[0]
        # patchify: [N, gh, p, gw, p, 3] -> [N, gh*gw, p*p*3] in the conv
        # kernel's (kh, kw, cin) order
        x = x.reshape(N, g.grid, g.patch, g.grid, g.patch, 3)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(N, g.grid * g.grid, -1)
        w = p["visual.conv1.weight"].permute(2, 3, 1, 0).reshape(
            -1, g.vision_width)
        x = x @ w
        cls = p["visual.class_embedding"].expand(N, 1, g.vision_width)
        x = torch.cat([cls, x], dim=1) + p["visual.positional_embedding"]
        x = _ln(x, p, "visual.ln_pre")
        x = _tower(x, p, "visual.transformer.resblocks", g.vision_layers,
                   g.vision_heads, g.quick_gelu)
        return _ln(x[:, 0], p, "visual.ln_post") @ p["visual.proj"]


@torch.no_grad()
def encode_text(params, tokens, geom: CLIPGeom = VIT_B32) -> torch.Tensor:
    """``[N, ctx]`` CLIP-BPE ids -> ``[N, embed_dim]`` (unnormalised); the
    feature row is the EOT position (the argmax of the ids, OpenAI's
    convention)."""
    g, p = geom, params
    dev = p["text_projection"].device
    with full_f32():
        toks = torch.as_tensor(tokens).to(dev, torch.long)
        x = p["token_embedding.weight"][toks] + p["positional_embedding"]
        mask = torch.full((g.ctx, g.ctx), float("-inf"), device=dev).triu(1)
        x = _tower(x, p, "transformer.resblocks", g.text_layers,
                   g.text_heads, g.quick_gelu, mask)
        x = _ln(x, p, "ln_final")
        x = x[torch.arange(x.shape[0], device=dev), toks.argmax(dim=-1)]
        return x @ p["text_projection"]


def cosine_scores(img_feats, txt_feats) -> torch.Tensor:
    """Row-wise cosine similarity (the reference's CLIP-score similarity
    and hpsv2's diagonal score)."""
    a = img_feats / torch.linalg.norm(img_feats, dim=-1, keepdim=True)
    b = txt_feats / torch.linalg.norm(txt_feats, dim=-1, keepdim=True)
    return (a * b).sum(dim=-1)


def preprocess_images(images, size: int = 224) -> torch.Tensor:
    """uint8 / float ``[N, H, W, 3]`` (one size) -> ``[N, size, size, 3]``
    float in [0, 1]: PIL's bicubic uint8 resize of the shorter side to
    ``size`` (Python's ``round``, half to even) and a center crop, the
    OpenAI ``clip`` preprocessor."""
    x = torch.as_tensor(images)
    if x.dtype != torch.uint8:
        x = x.to(torch.float32)
        # per image: [0, 1] images scale to [0, 255]; truncation to uint8
        small = x.flatten(1).amax(dim=1) <= 1.0
        x = torch.where(small[:, None, None, None], x * 255.0, x)
        x = x.clamp(0, 255).to(torch.uint8)
    h, w = x.shape[1], x.shape[2]
    s = size / min(w, h)
    x = resize(x, (max(size, int(round(w * s))), max(size, int(round(h * s)))),
               "bicubic")
    h, w = x.shape[1], x.shape[2]
    top, left = (h - size) // 2, (w - size) // 2
    return x[:, top: top + size, left: left + size].to(torch.float32) / 255.0


def load_any(weights: str | None, geom: CLIPGeom = VIT_B32, device=None
             ) -> Dict[str, torch.Tensor]:
    """Census tensors on ``device`` from any common on-disk form: an OpenAI
    / OpenCLIP torch ``.pt`` (the HPS_v2.1 release format too), a same-key
    ``.npz``, a transformers CLIPModel directory, or ``None`` for random
    weights (tests and structural runs)."""
    from ..utils.checkpoint import load_torch_file

    if weights is None:
        sd = random_state_dict(geom)
    elif os.path.isdir(weights):
        st = [f for f in os.listdir(weights) if f.endswith(".safetensors")]
        sd = {}
        for f in st or ["pytorch_model.bin"]:
            sd.update(load_torch_file(os.path.join(weights, f)))
    elif weights.endswith(".npz"):
        with np.load(weights) as z:
            sd = {k: z[k] for k in z.files}
    else:
        sd = torch.load(weights, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        sd = _unwrap(sd)
    if any(k.startswith("vision_model.") for k in sd):
        sd = hf_to_openai({k: np.asarray(torch.as_tensor(v).float())
                           for k, v in sd.items()})
    return params_from_openai(sd, geom, device)


class CLIPExtractor:
    """Image and text features through the pinned CLIP on ``device``
    (``None``: ``cuda``).  ``weights``: any ``load_any`` form;
    ``tokenizer``: texts -> ``[N, ctx]`` int ids (``evals.clip_bpe``)."""

    def __init__(self, weights: str | None = None, geom: CLIPGeom = VIT_B32,
                 tokenizer=None, batch: int = 32, device=None):
        self.device = resolve_device(device)
        self.params = load_any(weights, geom, self.device)
        self.geom = geom
        self.tokenizer = tokenizer
        self.batch = batch

    def image_features(self, images, batch: int | None = None
                       ) -> torch.Tensor:
        b = batch or self.batch
        x = preprocess_images(torch.as_tensor(images).to(self.device),
                              self.geom.image_size)
        outs = [encode_image(self.params, x[i:i + b], self.geom)
                for i in range(0, len(x), b)]
        return torch.cat(outs) if outs else torch.zeros(
            (0, self.geom.embed_dim), device=self.device)

    def text_features(self, texts, batch: int | None = None) -> torch.Tensor:
        if self.tokenizer is None:
            raise ValueError("text scoring needs a tokenizer "
                             "(evals.clip_bpe.ClipTokenizer)")
        b = batch or self.batch
        toks = torch.as_tensor(np.asarray(self.tokenizer(list(texts)),
                                          np.int64))
        outs = [encode_text(self.params, toks[i:i + b], self.geom)
                for i in range(0, len(toks), b)]
        return torch.cat(outs) if outs else torch.zeros(
            (0, self.geom.embed_dim), device=self.device)
