"""The benchmark's weights and codebook latents, made from the run's seed.

Every tensor is drawn on the run's device by one ``normal_`` call of a
``torch.Generator`` seeded with the seed, in the dtype the weights are
served in (bfloat16), in a fixed order, so the same seed gives the same
bytes on every call: the program takes them through its own
``fuse_params`` / ``quantize_params``, and the plain reference draws them
again after the program's state is freed.  The layout is the port's split
layout (``wq``/``wk``/``wv``, ``w_gate``/``w_up`` stacked over layers), the
published geometry of the configuration file, with N(0, 0.02) matrices,
unit norm weights and zero norm biases (the families' own initialisation).

This module imports torch alone: the reference uses it too.
"""

from __future__ import annotations

import torch

SCALE = 0.02


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def _normal(gen, shape, device, scale=SCALE, dtype=torch.bfloat16):
    x = torch.empty(shape, dtype=dtype, device=device)
    x.normal_(0.0, scale, generator=gen)
    return x


def base_weights(cfg: dict, seed: int, device) -> dict:
    """The decoder's weights for configuration file ``cfg`` (split layout,
    bfloat16), drawn from ``seed``."""
    gen = generator(seed, device)
    L, H = cfg["num_hidden_layers"], cfg["hidden_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd, I, V = H // nh, cfg["intermediate_size"], cfg["vocab_size"]
    bf = torch.bfloat16

    def ones(*shape):
        return torch.ones(shape, dtype=bf, device=device)

    layers = {
        "attn_norm": ones(L, H),
        "wq": _normal(gen, (L, H, nh * hd), device),
        "wk": _normal(gen, (L, H, nkv * hd), device),
        "wv": _normal(gen, (L, H, nkv * hd), device),
        "wo": _normal(gen, (L, nh * hd, H), device),
        "ffn_norm": ones(L, H),
        "w_gate": _normal(gen, (L, H, I), device),
        "w_up": _normal(gen, (L, H, I), device),
        "w_down": _normal(gen, (L, I, H), device),
    }
    if cfg.get("qk_layernorm"):
        layers["q_norm_w"] = ones(L, nh, hd)
        layers["q_norm_b"] = torch.zeros((L, nh, hd), dtype=bf, device=device)
        layers["k_norm_w"] = ones(L, nkv, hd)
        layers["k_norm_b"] = torch.zeros((L, nkv, hd), dtype=bf, device=device)
    params = {"embed": _normal(gen, (V, H), device), "layers": layers,
              "norm": ones(H), "lm_head": _normal(gen, (H, V), device)}
    cap = cfg.get("caption")
    if cap:
        Dc, Tc = cap["dim"], cap["rows"]
        params["cond"] = {"fc1": _normal(gen, (Dc, H), device),
                          "fc2": _normal(gen, (H, H), device),
                          "uncond": _normal(gen, (Tc, Dc), device,
                                            scale=Dc ** -0.5)}
    return params


def codebook_latents(cfg: dict, seed: int, device) -> torch.Tensor:
    """The VQ codebook's latents [codes, dim] in f32 (random: no codec is
    loaded), drawn after the decoder from the same seed's second stream."""
    gen = generator(int(seed) + 1, device)
    vq = cfg["vq"]
    return _normal(gen, (vq["codes"], vq["latent_dim"]), device, scale=1.0,
                   dtype=torch.float32)
