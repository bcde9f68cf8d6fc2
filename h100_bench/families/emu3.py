"""Emu3-Gen: pre-norm LLaMA blocks with grouped-query attention, the
rotate-half 1-D rope, token prompts under CFG with a negative prompt (and,
for an image in flight, a prefix of whole rows), the grid FSM at Emu3's
ids, the nearest table at its visual offset."""

from __future__ import annotations

import torch

from lantern_tpu_torch import configs
from lantern_tpu_torch.models import emu3
from lantern_tpu_torch.models import transformer as tfm
from lantern_tpu_torch.ops.quant import quantize_params
from lantern_tpu_torch.ops.vq_distance import nearest_latents

from .. import weights


def model_config(cfg: dict, traffic: dict) -> configs.ModelConfig:
    """The longest prompt row (bos, the longer of caption and negative
    prompt, the header), the image and a tree block's room: an image in
    flight carries its rows in the prompt and has as many fewer to go."""
    im = cfg["image"]
    longest = max(traffic["prompt_tokens"][1], traffic["negative_tokens"])
    return configs.ModelConfig(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rms_norm_eps=cfg["rms_norm_eps"], rope_kind="1d",
        rope_pairing="half", rope_base=cfg["rope_theta"], cond_kind="none",
        max_seq_len=(1 + longest + len(im["size_ids"]) + 2 + im["tokens"]
                     + traffic["tree_room"]),
        dtype="bfloat16")


def ids(cfg: dict) -> emu3.Emu3Ids:
    """The configuration's ids (its ``image`` group)."""
    im = cfg["image"]
    lo, hi = im["image_token_ids"]
    return emu3.Emu3Ids(vocab=cfg["vocab_size"], pad=im["pad_id"],
                        eol=im["row_end_id"], eof=im["end_id"],
                        bos=im["bos_id"], img=im["img_id"],
                        boi=im["start_id"], visual_start=lo,
                        codes=hi - lo + 1)


def program_params(cfg: dict, traffic: dict, seed: int, device):
    params = quantize_params(tfm.fuse_params(
        weights.base_weights(cfg, seed, device)))
    near = nearest_latents(weights.codebook_latents(cfg, seed, device),
                           k=traffic["nearest_k"])
    params["nearest_latents"] = torch.as_tensor(
        emu3.nearest_table(near, ids(cfg)), device=device)
    return params, None, None


def grid_fsm(cfg: dict):
    return emu3.grid_fsm(tuple(cfg["image"]["grid"]), ids(cfg))


def token_prompt(cfg: dict, text_ids, device, negative_ids=(),
                 prefix_ids=()):
    return emu3.token_prompt(
        text_ids, negative_ids, cfg["image"]["size_ids"], prefix_ids,
        grid=tuple(cfg["image"]["grid"]), ids=ids(cfg)).to(device)
