"""Chameleon geometry (Lumina-mGPT, Anole): 1-D rotate-half rope, QK-norm,
swin norm, token prompts, the Lumina grid FSM."""

from __future__ import annotations

import torch

from lantern_tpu_torch import configs
from lantern_tpu_torch.models import chameleon as cham
from lantern_tpu_torch.models import transformer as tfm
from lantern_tpu_torch.ops.quant import quantize_params
from lantern_tpu_torch.ops.vq_distance import nearest_latents

from .. import weights


def model_config(cfg: dict, traffic: dict) -> configs.ModelConfig:
    """The longest prompt, its 3-token image header, the image and a tree
    block's room."""
    return configs.ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_kind="1d",
        rope_pairing="half", rope_base=cfg["rope_theta"], cond_kind="none",
        qk_norm=cfg["qk_layernorm"], swin_norm=cfg["swin_norm"],
        norm_eps=cfg["rms_norm_eps"],
        max_seq_len=(traffic["prompt_tokens"][1] + 3 + cfg["image"]["tokens"]
                     + traffic["tree_room"]),
        dtype="bfloat16")


def program_params(cfg: dict, traffic: dict, seed: int, device):
    params = quantize_params(tfm.fuse_params(
        weights.base_weights(cfg, seed, device)))
    near = nearest_latents(weights.codebook_latents(cfg, seed, device),
                           k=traffic["nearest_k"])
    params["nearest_latents"] = torch.as_tensor(
        cham.shift_nearest_table(near, cfg["vocab_size"]), device=device)
    return params, None, None


def grid_fsm(cfg: dict, image_start_idx: int):
    h, w = cfg["image"]["grid"]
    return cham.LuminaGridFSM(w=w, h=h, image_start_idx=image_start_idx,
                              vocab_size=cfg["vocab_size"])


def token_prompt(cfg: dict, text_ids, device):
    return cham.lumina_token_prompt(list(text_ids),
                                    grid=tuple(cfg["image"]["grid"])).to(
        device)
