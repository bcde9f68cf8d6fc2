"""Model configuration (counterpart of ``lantern_tpu/configs.py``).

Same frozen dataclasses and presets as the JAX package, with
``torch_dtype`` in place of ``jnp_dtype``.  The JAX fields that only steer
XLA or the TPU kernels (``use_flash_attention``, ``flash_min_seq``,
``dense_softmax``, ``dense_qk_mulsum_max_t``, ``scan_unroll``) have no
counterpart here: the port has one attention path (``ops/tree_attention``).
``dense_qk_mulsum_max_t`` in particular, which ``llamagen_config`` sets in
the JAX package, picks how XLA lowers the decode block's contractions; the
port's attention is the same function at every T.
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # transformer dims
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    rms_norm_eps: float = 1e-5
    attention_bias: bool = False

    # rope
    rope_kind: str = "1d"          # "1d" (Chameleon) | "2d" (LlamaGen image grid)
    rope_pairing: str = "half"     # "half" (rotate-half) | "interleaved"
    rope_base: float = 10000.0
    block_size: int = 0            # image tokens (grid_size**2); 2-D rope only

    # conditioning prefix
    cond_kind: str = "none"        # "none" | "label" (c2i) | "caption" (t2i)
    cls_token_num: int = 0
    caption_dim: int = 0
    num_classes: int = 0

    # chameleon extras
    qk_norm: bool = False          # per-head LayerNorm on q/k
    swin_norm: bool = False        # post-norm residual ordering
    norm_eps: float = 1e-5         # LayerNorm eps for qk_norm

    # EAGLE-drafter structural quirks
    first_layer_no_input_norm: bool = False
    final_norm: bool = True

    # budget
    max_seq_len: int = 2048

    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid_size(self) -> int:
        g = int(round(self.block_size ** 0.5))
        if g * g != self.block_size:
            raise ValueError(f"block_size {self.block_size} not a perfect square")
        return g

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class DrafterConfig:
    """EAGLE drafter geometry (a shallow copy of the base model's block)."""

    model: ModelConfig
    fc_bias: bool = True
    total_tokens: int = 59
    depth: int = 4
    top_k: int = 10


def _ffn_dim(hidden: int, multiple_of: int = 256) -> int:
    inner = int(2 * (4 * hidden) / 3)
    return multiple_of * ((inner + multiple_of - 1) // multiple_of)


def llamagen_config(
    size: str = "B",
    task: str = "c2i",
    image_tokens: int = 256,
    max_extra: int = 74,
) -> ModelConfig:
    """LlamaGen family: LLaMA blocks, 2-D interleaved rope over the image
    grid, vocab 16384.  ``task`` 'c2i': a one-row class-label prefix; 't2i':
    120 T5 caption rows.  ``image_tokens``: generated VQ tokens (256 for
    256 px).  The sequence holds the prefix, the image and ``max_extra`` rows
    of room for a provisional tree block.  Head_dim is 64 from B to XXL, so
    the KV cache packs two heads into each 128-lane group ('nano' is a CPU
    test size; '3B' has head_dim 100, which no 128-lane group packs)."""
    dims = {
        "nano": (2, 4, 64),
        "B": (12, 12, 768),
        "L": (24, 16, 1024),
        "XL": (36, 20, 1280),
        "XXL": (48, 24, 1536),
        "3B": (24, 32, 3200),
    }
    n_layer, n_head, dim = dims[size]
    if task == "c2i":
        cond = dict(cond_kind="label", cls_token_num=1, num_classes=1000)
    elif task == "t2i":
        cond = dict(cond_kind="caption", cls_token_num=120, caption_dim=2048)
    else:
        raise ValueError(task)
    return ModelConfig(
        vocab_size=16384,
        hidden_size=dim,
        intermediate_size=_ffn_dim(dim),
        num_layers=n_layer,
        num_heads=n_head,
        num_kv_heads=n_head,
        rope_kind="2d",
        rope_pairing="interleaved",
        block_size=image_tokens,
        max_seq_len=cond["cls_token_num"] + image_tokens + max_extra,
        **cond,
    )


def chameleon_7b_config(max_seq_len: int = 4096, swin_norm: bool = False) -> ModelConfig:
    """Anole-7B / Lumina-mGPT-7B share the Chameleon-7B geometry:
    32L x 4096h x 32 heads, QK-norm, vocab 65536."""
    return ModelConfig(
        vocab_size=65536,
        hidden_size=4096,
        intermediate_size=11008,
        num_layers=32,
        num_heads=32,
        num_kv_heads=32,
        rope_kind="1d",
        rope_pairing="half",
        cond_kind="none",
        qk_norm=True,
        swin_norm=swin_norm,
        max_seq_len=max_seq_len,
    )


def emu3_gen_config(max_seq_len: int = 8335) -> ModelConfig:
    """Emu3-Gen (BAAI/Emu3-Gen ``config.json``): 32 x 4,096, 32 query heads
    over 8 KV heads of 128, SwiGLU 14,336, pre-norm RMSNorm (eps 1e-5), no
    QK-norm, an untied head, rotate-half 1-D rope at theta 1e6, vocabulary
    184,622 (Qwen's text ids, special ids, then 32,768 visual ids from
    151,854).  The default cache holds a 70-token prompt, the 8,191 tokens
    of a 720-px image (90 rows of 90 visual ids and a row end, then the
    end of frame) and 74 rows of tree room."""
    return ModelConfig(
        vocab_size=184622,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        rms_norm_eps=1e-5,
        rope_kind="1d",
        rope_pairing="half",
        rope_base=1_000_000.0,
        cond_kind="none",
        max_seq_len=max_seq_len,
    )


def tiny_config(
    vocab_size: int = 256,
    hidden_size: int = 64,
    num_layers: int = 2,
    num_heads: int = 4,
    rope_kind: str = "2d",
    cond_kind: str = "label",
    block_size: int = 16,
    qk_norm: bool = False,
    **kw,
) -> ModelConfig:
    """Small CPU-runnable config for tests."""
    cond = {
        "label": dict(cls_token_num=1, num_classes=10),
        "caption": dict(cls_token_num=8, caption_dim=32),
        "none": dict(),
    }[cond_kind]
    pairing = "interleaved" if rope_kind == "2d" else "half"
    kw.setdefault("max_seq_len", 96)
    kw.setdefault("dtype", "float32")
    return ModelConfig(
        vocab_size=vocab_size,
        hidden_size=hidden_size,
        intermediate_size=_ffn_dim(hidden_size, 32),
        num_layers=num_layers,
        num_heads=num_heads,
        num_kv_heads=num_heads,
        rope_kind=rope_kind,
        rope_pairing=pairing,
        block_size=block_size if rope_kind == "2d" else 0,
        cond_kind=cond_kind,
        qk_norm=qk_norm,
        **{**cond, **kw},
    )


def drafter_config(base: ModelConfig, num_layers: int = 1, **kw) -> DrafterConfig:
    """Drafter mirroring a base model's block geometry, one decoder layer by
    default and always pre-norm with no final norm.  For a LlamaGen base
    (a conditioning prefix) its first layer skips the input norm, and its
    2-D rope prefix is one row shorter than the base's: its inputs are the
    base's rows shifted left by one."""
    m = base.replace(
        num_layers=num_layers,
        cls_token_num=max(base.cls_token_num - 1, 0),
        first_layer_no_input_norm=base.cond_kind != "none",
        final_norm=False,
        cond_kind="none",
        swin_norm=False,
    )
    return DrafterConfig(model=m, **kw)
