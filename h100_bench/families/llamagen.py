"""LlamaGen t2i geometry: pre-norm LLaMA blocks, 2-D interleaved rope, a
T5 caption prefix, and the one-layer hidden-passthrough drafter."""

from __future__ import annotations

import torch

from lantern_tpu_torch import configs
from lantern_tpu_torch.models import transformer as tfm
from lantern_tpu_torch.ops.quant import quantize_params
from lantern_tpu_torch.ops.vq_distance import nearest_latents

from .. import weights


def model_config(cfg: dict, traffic: dict) -> configs.ModelConfig:
    """The caption prefix, the image and a tree block's room."""
    cap, n = cfg["caption"], cfg["image"]["tokens"]
    return configs.ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_kind="2d",
        rope_pairing="interleaved", rope_base=cfg["rope_theta"],
        block_size=n, cond_kind="caption", cls_token_num=cap["rows"],
        caption_dim=cap["dim"], max_seq_len=cap["rows"] + n
        + traffic["tree_room"], dtype="bfloat16")


def passthrough_drafter(raw: dict, H: int) -> dict:
    """The hidden-passthrough drafter over the base's embedding: ``fc_w =
    [0; I]``, a zero bias and one zeroed layer of the base's shapes."""
    dev, bf = raw["embed"].device, torch.bfloat16
    fc = torch.zeros((2 * H, H), dtype=bf, device=dev)
    fc[H:] = torch.eye(H, dtype=bf, device=dev)
    return {"embed": raw["embed"], "fc_w": fc,
            "fc_b": torch.zeros((H,), dtype=bf, device=dev),
            "layers": {k: torch.zeros_like(v[:1])
                       for k, v in raw["layers"].items()}}


def program_params(cfg: dict, traffic: dict, seed: int, device):
    raw = weights.base_weights(cfg, seed, device)
    d = passthrough_drafter(raw, cfg["hidden_size"])
    params = quantize_params(tfm.fuse_params(raw))
    del raw
    dparams = quantize_params(tfm.fuse_params(d))
    params["nearest_latents"] = torch.as_tensor(nearest_latents(
        weights.codebook_latents(cfg, seed, device),
        k=traffic["nearest_k"]), device=device)
    dcfg = configs.drafter_config(model_config(cfg, traffic), num_layers=1)
    return params, dparams, dcfg
