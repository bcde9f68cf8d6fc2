"""VQ-GAN image codec (LlamaGen VQ-8/VQ-16, and the Chameleon / Anole /
Lumina taming VQGAN) in PyTorch, NCHW layout.

Counterpart of ``lantern_tpu/models/vqgan.py``.  Encoder and decoder are
conv towers of GroupNorm + swish ResNet blocks with single-head attention
blocks at the configured levels; the quantizer is an (optionally
L2-normalized) nearest-neighbour codebook.

The JAX module runs NHWC activations with HWIO kernels (the TPU's native
layout) through ``lax.conv``, outside any Pallas kernel; the port runs
PyTorch's NCHW with OIHW kernels through ``F.conv2d`` and ``F.group_norm``
on either device.  The parameter tree has the JAX module's nesting (dicts
of ``w``/``b`` and ``scale``/``bias``, lists of blocks), so
``convert.convert_vqgan_params`` carries a JAX tree across by transposing
the conv kernels, and the torch-checkpoint loaders are near-identities:
the published layout is already OIHW.  Images are ``[B, 3, H, W]`` in
[-1, 1]; the sessions turn them into ``[B, H, W, 3]`` uint8 arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import full_f32, resolve_device


@dataclasses.dataclass(frozen=True)
class VQGANConfig:
    codebook_size: int = 16384
    codebook_dim: int = 8
    l2_norm: bool = True
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    z_channels: int = 256
    in_channels: int = 3
    out_channels: int = 3
    # encoder levels (by index) with attention blocks: the lowest
    # resolution for LlamaGen, the taming config's pixel resolutions for
    # Chameleon (``chameleon_vq_config``)
    attn_levels: Tuple[int, ...] = (-1,)

    @property
    def downsample_factor(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)

    def enc_attn(self, level: int) -> bool:
        n = len(self.ch_mult)
        return level in tuple(a % n for a in self.attn_levels)


def vq16_config(**kw) -> VQGANConfig:
    return VQGANConfig(ch_mult=(1, 1, 2, 2, 4), **kw)


def vq8_config(**kw) -> VQGANConfig:
    return VQGANConfig(ch_mult=(1, 2, 2, 4), **kw)


def chameleon_vq_config(
    resolution: int = 512,
    attn_resolutions: Tuple[int, ...] = (32,),
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4),
    **kw,
) -> VQGANConfig:
    """Chameleon / Anole / Lumina VQ-GAN: codebook 8192x256, un-normalized
    codes, attention at the taming config's pixel resolutions."""
    levels = []
    curr = resolution
    for i in range(len(ch_mult)):
        if curr in attn_resolutions:
            levels.append(i)
        if i != len(ch_mult) - 1:
            curr //= 2
    kw.setdefault("codebook_size", 8192)
    kw.setdefault("codebook_dim", 256)
    kw.setdefault("l2_norm", False)
    return VQGANConfig(ch_mult=tuple(ch_mult), attn_levels=tuple(levels), **kw)


# ---------------------------------------------------------------------------
# primitive layers (params are dicts of tensors)
# ---------------------------------------------------------------------------

def conv2d(p: dict, x: torch.Tensor, stride: int = 1,
           padding: str = "same") -> torch.Tensor:
    """OIHW conv with bias; ``same`` pads (k - 1) / 2 on every side (odd
    kernels at stride 1, as XLA's SAME), ``valid`` pads nothing."""
    pad = p["w"].shape[-1] // 2 if padding == "same" else 0
    return F.conv2d(x, p["w"], p["b"], stride=stride, padding=pad)


def group_norm(p: dict, x: torch.Tensor, groups: int = 32,
               eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (C / groups, H, W) in f32, affine, back to x's dtype."""
    return F.group_norm(x.float(), groups, p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def resnet_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = conv2d(p["conv1"], swish(group_norm(p["norm1"], x)))
    h = conv2d(p["conv2"], swish(group_norm(p["norm2"], h)))
    if "nin_shortcut" in p:
        x = conv2d(p["nin_shortcut"], x)
    return x + h


def attn_block(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Single-head self-attention over the H*W positions, the JAX module's
    plain math: scores in f32, softmax, cast, weighted sum."""
    B, C, H, W = x.shape
    h = group_norm(p["norm"], x)
    q = conv2d(p["q"], h).reshape(B, C, H * W).transpose(1, 2)
    k = conv2d(p["k"], h).reshape(B, C, H * W).transpose(1, 2)
    v = conv2d(p["v"], h).reshape(B, C, H * W).transpose(1, 2)
    w = torch.matmul(q.float(), k.float().transpose(1, 2))
    w = torch.softmax(w * (C ** -0.5), dim=-1).to(x.dtype)
    h = torch.matmul(w, v).transpose(1, 2).reshape(B, C, H, W)
    return x + conv2d(p["proj_out"], h)


def downsample(p: dict, x: torch.Tensor) -> torch.Tensor:
    # torch pads (left 0, right 1, top 0, bottom 1)
    return conv2d(p["conv"], F.pad(x, (0, 1, 0, 1)), stride=2,
                  padding="valid")


def upsample(p: dict, x: torch.Tensor) -> torch.Tensor:
    x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return conv2d(p["conv"], x)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_vqgan_params(generator: torch.Generator, cfg: VQGANConfig,
                      device=None) -> dict:
    """Random-init parameter tree (conv kernels N(0, 1 / fan_in), zero
    biases, unit norms, a uniform codebook) drawn from ``generator``, which
    must live on ``device``."""
    dev = resolve_device(device)

    def conv(kh, kw, cin, cout):
        w = torch.empty((cout, cin, kh, kw), device=dev)
        w.normal_(generator=generator)
        return {"w": w.mul_(1.0 / np.sqrt(kh * kw * cin)),
                "b": torch.zeros((cout,), device=dev)}

    def gn(c):
        return {"scale": torch.ones((c,), device=dev),
                "bias": torch.zeros((c,), device=dev)}

    def res(cin, cout):
        p = {"norm1": gn(cin), "conv1": conv(3, 3, cin, cout),
             "norm2": gn(cout), "conv2": conv(3, 3, cout, cout)}
        if cin != cout:
            p["nin_shortcut"] = conv(1, 1, cin, cout)
        return p

    def attn(c):
        return {"norm": gn(c), "q": conv(1, 1, c, c), "k": conv(1, 1, c, c),
                "v": conv(1, 1, c, c), "proj_out": conv(1, 1, c, c)}

    nr = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    enc = {"conv_in": conv(3, 3, cfg.in_channels, cfg.ch)}
    blocks = []
    for i in range(nr):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        blk = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks):
            blk["res"].append(res(cin, cout))
            cin = cout
            if cfg.enc_attn(i):
                blk["attn"].append(attn(cin))
        if i != nr - 1:
            blk["downsample"] = {"conv": conv(3, 3, cin, cin)}
        blocks.append(blk)
    enc["blocks"] = blocks
    bi = cfg.ch * cfg.ch_mult[-1]
    enc["mid"] = [res(bi, bi), attn(bi), res(bi, bi)]
    enc["norm_out"] = gn(bi)
    enc["conv_out"] = conv(3, 3, bi, cfg.z_channels)

    dec = {"conv_in": conv(3, 3, cfg.z_channels, bi)}
    dec["mid"] = [res(bi, bi), attn(bi), res(bi, bi)]
    blocks = []
    cin = bi
    for i in reversed(range(nr)):
        cout = cfg.ch * cfg.ch_mult[i]
        blk = {"res": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            blk["res"].append(res(cin, cout))
            cin = cout
            if cfg.enc_attn(i):
                blk["attn"].append(attn(cin))
        if i != 0:
            blk["upsample"] = {"conv": conv(3, 3, cin, cin)}
        blocks.append(blk)
    dec["blocks"] = blocks
    dec["norm_out"] = gn(cin)
    dec["conv_out"] = conv(3, 3, cin, cfg.out_channels)

    codebook = torch.empty((cfg.codebook_size, cfg.codebook_dim), device=dev)
    codebook.uniform_(-1.0 / cfg.codebook_size, 1.0 / cfg.codebook_size,
                      generator=generator)
    if cfg.l2_norm:
        codebook = codebook / codebook.norm(dim=-1, keepdim=True)
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv(1, 1, cfg.z_channels, cfg.codebook_dim),
        "post_quant_conv": conv(1, 1, cfg.codebook_dim, cfg.z_channels),
        "codebook": codebook,
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _tower(blocks, mid, x, up: bool):
    if not up:
        for blk in blocks:
            for i, r in enumerate(blk["res"]):
                x = resnet_block(r, x)
                if blk["attn"]:
                    x = attn_block(blk["attn"][i], x)
            if "downsample" in blk:
                x = downsample(blk["downsample"], x)
        for i, m in enumerate(mid):
            x = attn_block(m, x) if i == 1 else resnet_block(m, x)
    else:
        for i, m in enumerate(mid):
            x = attn_block(m, x) if i == 1 else resnet_block(m, x)
        for blk in blocks:
            for i, r in enumerate(blk["res"]):
                x = resnet_block(r, x)
                if blk["attn"]:
                    x = attn_block(blk["attn"][i], x)
            if "upsample" in blk:
                x = upsample(blk["upsample"], x)
    return x


def _norm_codebook(params: dict, cfg: VQGANConfig) -> torch.Tensor:
    cb = params["codebook"]
    if cfg.l2_norm:
        cb = cb / torch.clamp(cb.norm(dim=-1, keepdim=True), min=1e-12)
    return cb


@torch.no_grad()
def encode(params: dict, cfg: VQGANConfig,
           images: torch.Tensor) -> torch.Tensor:
    """images [B, 3, H, W] in [-1, 1] -> codes [B, (H/f)*(W/f)] int32 (the
    nearest codebook row, as one distance matmul and an argmin)."""
    with full_f32():
        enc = params["encoder"]
        h = conv2d(enc["conv_in"], images)
        h = _tower(enc["blocks"], enc["mid"], h, up=False)
        h = conv2d(enc["conv_out"], swish(group_norm(enc["norm_out"], h)))
        z = conv2d(params["quant_conv"], h)                    # [B, d, h, w]
    B, d, hh, ww = z.shape
    zf = z.permute(0, 2, 3, 1).reshape(-1, d)
    if cfg.l2_norm:
        zf = zf / torch.clamp(zf.norm(dim=-1, keepdim=True), min=1e-12)
    cb = _norm_codebook(params, cfg)
    d2 = ((zf * zf).sum(dim=1, keepdim=True) + (cb * cb).sum(dim=1)[None, :]
          - 2.0 * zf @ cb.T)
    return torch.argmin(d2, dim=1).to(torch.int32).reshape(B, hh * ww)


@torch.no_grad()
def decode_code(params: dict, cfg: VQGANConfig, codes: torch.Tensor,
                grid) -> torch.Tensor:
    """codes [B, h*w] -> images [B, 3, h*f, w*f].  ``grid`` is the latent
    grid: an int (square) or an (h, w) tuple (Lumina's rectangular
    grids)."""
    gh, gw = (grid, grid) if isinstance(grid, int) else grid
    cb = _norm_codebook(params, cfg)
    z = cb[codes.long()].reshape(codes.shape[0], gh, gw, cfg.codebook_dim)
    with full_f32():
        z = conv2d(params["post_quant_conv"], z.permute(0, 3, 1, 2))
        dec = params["decoder"]
        h = conv2d(dec["conv_in"], z)
        h = _tower(dec["blocks"], dec["mid"], h, up=True)
        return conv2d(dec["conv_out"], swish(group_norm(dec["norm_out"], h)))


def to_uint8(images: torch.Tensor) -> np.ndarray:
    """Decoded images [B, 3, H, W] in [-1, 1] -> uint8 [B, H, W, 3] numpy
    (``(x + 1) * 127.5``, clipped, truncated as the JAX sessions do)."""
    arr = images.permute(0, 2, 3, 1).float().cpu().numpy()
    return np.clip((arr + 1.0) * 127.5, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# torch checkpoint loading
# ---------------------------------------------------------------------------

def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                           else a).float().to(device)


def _loader(sd: dict, device):
    def conv(prefix):
        return {"w": _tensor(sd[prefix + ".weight"], device),
                "b": _tensor(sd[prefix + ".bias"], device)}

    def gn(prefix):
        return {"scale": _tensor(sd[prefix + ".weight"], device),
                "bias": _tensor(sd[prefix + ".bias"], device)}

    def res(prefix, cin, cout):
        p = {"norm1": gn(prefix + ".norm1"), "conv1": conv(prefix + ".conv1"),
             "norm2": gn(prefix + ".norm2"), "conv2": conv(prefix + ".conv2")}
        if cin != cout:
            p["nin_shortcut"] = conv(prefix + ".nin_shortcut")
        return p

    def attn(prefix):
        return {"norm": gn(prefix + ".norm"), "q": conv(prefix + ".q"),
                "k": conv(prefix + ".k"), "v": conv(prefix + ".v"),
                "proj_out": conv(prefix + ".proj_out")}

    return conv, gn, res, attn


def _load(sd: dict, cfg: VQGANConfig, device, names) -> dict:
    """The shared walk of both checkpoint layouts; ``names`` maps a module
    role to its state-dict prefix."""
    dev = resolve_device(device)
    conv, gn, res, attn = _loader(sd, dev)
    nr = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    enc = {"conv_in": conv("encoder.conv_in")}
    blocks = []
    for i in range(nr):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        blk = {"res": [], "attn": []}
        for j in range(cfg.num_res_blocks):
            blk["res"].append(res(names["enc_res"](i, j), cin, cout))
            cin = cout
            if cfg.enc_attn(i):
                blk["attn"].append(attn(names["enc_attn"](i, j)))
        if i != nr - 1:
            blk["downsample"] = {"conv": conv(names["down"](i))}
        blocks.append(blk)
    enc["blocks"] = blocks
    bi = cfg.ch * cfg.ch_mult[-1]
    enc["mid"] = [res(names["mid"]("encoder", 0), bi, bi),
                  attn(names["mid"]("encoder", 1)),
                  res(names["mid"]("encoder", 2), bi, bi)]
    enc["norm_out"] = gn("encoder.norm_out")
    enc["conv_out"] = conv("encoder.conv_out")

    dec = {"conv_in": conv("decoder.conv_in")}
    dec["mid"] = [res(names["mid"]("decoder", 0), bi, bi),
                  attn(names["mid"]("decoder", 1)),
                  res(names["mid"]("decoder", 2), bi, bi)]
    blocks = []
    cin = bi
    for bidx, i in enumerate(reversed(range(nr))):
        cout = cfg.ch * cfg.ch_mult[i]
        blk = {"res": [], "attn": []}
        for j in range(cfg.num_res_blocks + 1):
            blk["res"].append(res(names["dec_res"](bidx, i, j), cin, cout))
            cin = cout
            if cfg.enc_attn(i):
                blk["attn"].append(attn(names["dec_attn"](bidx, i, j)))
        if i != 0:
            blk["upsample"] = {"conv": conv(names["up"](bidx, i))}
        blocks.append(blk)
    dec["blocks"] = blocks
    dec["norm_out"] = gn("decoder.norm_out")
    dec["conv_out"] = conv("decoder.conv_out")
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv("quant_conv"),
        "post_quant_conv": conv("post_quant_conv"),
        "codebook": _tensor(sd["quantize.embedding.weight"], dev),
    }


_LLAMAGEN_NAMES = {
    "enc_res": lambda i, j: f"encoder.conv_blocks.{i}.res.{j}",
    "enc_attn": lambda i, j: f"encoder.conv_blocks.{i}.attn.{j}",
    "down": lambda i: f"encoder.conv_blocks.{i}.downsample.conv",
    "mid": lambda part, m: f"{part}.mid.{m}",
    "dec_res": lambda b, i, j: f"decoder.conv_blocks.{b}.res.{j}",
    "dec_attn": lambda b, i, j: f"decoder.conv_blocks.{b}.attn.{j}",
    "up": lambda b, i: f"decoder.conv_blocks.{b}.upsample.conv",
}

_TAMING_MID = ("block_1", "attn_1", "block_2")
_TAMING_NAMES = {
    "enc_res": lambda i, j: f"encoder.down.{i}.block.{j}",
    "enc_attn": lambda i, j: f"encoder.down.{i}.attn.{j}",
    "down": lambda i: f"encoder.down.{i}.downsample.conv",
    "mid": lambda part, m: f"{part}.mid.{_TAMING_MID[m]}",
    # decoder level i is stored fine-to-coarse: our block b is up.{i}
    "dec_res": lambda b, i, j: f"decoder.up.{i}.block.{j}",
    "dec_attn": lambda b, i, j: f"decoder.up.{i}.attn.{j}",
    "up": lambda b, i: f"decoder.up.{i}.upsample.conv",
}


def load_torch_state_dict(sd: dict, cfg: VQGANConfig, device=None) -> dict:
    """A torch VQModel state dict (LlamaGen ``vq_model.py`` names; numpy
    arrays or tensors, OIHW kernels) -> the port's parameter tree."""
    return _load(sd, cfg, device, _LLAMAGEN_NAMES)


def load_taming_state_dict(sd: dict, cfg: VQGANConfig, device=None) -> dict:
    """A taming-transformers VQModel state dict (the Chameleon / Anole /
    Lumina tokenizer: ``encoder.down.{i}.block.{j}``, ``mid.block_1`` /
    ``attn_1`` / ``block_2``, ``decoder.up.{i}`` fine-to-coarse) -> the
    port's parameter tree."""
    return _load(sd, cfg, device, _TAMING_NAMES)


def random_taming_state_dict(cfg: VQGANConfig, seed: int = 0,
                             rng=None) -> dict:
    """Random numpy state dict in the taming-transformers naming that
    ``load_taming_state_dict`` reads (a synthetic checkpoint: weights
    N(0, 0.02), zero biases, unit norms, a N(0, 1) codebook, drawn from
    ``np.random.default_rng(seed)`` in the JAX module's order, or from
    ``rng``: anything with numpy's ``standard_normal(size)``)."""
    rng = np.random.default_rng(seed) if rng is None else rng
    sd: dict = {}

    def conv(prefix, cout, cin, k):
        sd[prefix + ".weight"] = (rng.standard_normal((cout, cin, k, k))
                                  * 0.02).astype(np.float32)
        sd[prefix + ".bias"] = np.zeros((cout,), np.float32)

    def gn(prefix, c):
        sd[prefix + ".weight"] = np.ones((c,), np.float32)
        sd[prefix + ".bias"] = np.zeros((c,), np.float32)

    def res(prefix, cin, cout):
        gn(prefix + ".norm1", cin)
        conv(prefix + ".conv1", cout, cin, 3)
        gn(prefix + ".norm2", cout)
        conv(prefix + ".conv2", cout, cout, 3)
        if cin != cout:
            conv(prefix + ".nin_shortcut", cout, cin, 1)

    def attn(prefix, c):
        gn(prefix + ".norm", c)
        for nm in ("q", "k", "v", "proj_out"):
            conv(prefix + "." + nm, c, c, 1)

    nr = len(cfg.ch_mult)
    in_mult = (1,) + tuple(cfg.ch_mult)
    conv("encoder.conv_in", cfg.ch, cfg.in_channels, 3)
    for i in range(nr):
        cin, cout = cfg.ch * in_mult[i], cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks):
            res(f"encoder.down.{i}.block.{j}", cin, cout)
            cin = cout
            if cfg.enc_attn(i):
                attn(f"encoder.down.{i}.attn.{j}", cout)
        if i != nr - 1:
            conv(f"encoder.down.{i}.downsample.conv", cout, cout, 3)
    bi = cfg.ch * cfg.ch_mult[-1]
    res("encoder.mid.block_1", bi, bi)
    attn("encoder.mid.attn_1", bi)
    res("encoder.mid.block_2", bi, bi)
    gn("encoder.norm_out", bi)
    conv("encoder.conv_out", cfg.z_channels, bi, 3)

    conv("decoder.conv_in", bi, cfg.z_channels, 3)
    res("decoder.mid.block_1", bi, bi)
    attn("decoder.mid.attn_1", bi)
    res("decoder.mid.block_2", bi, bi)
    cin = bi
    for i in reversed(range(nr)):
        cout = cfg.ch * cfg.ch_mult[i]
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.up.{i}.block.{j}", cin, cout)
            cin = cout
            if cfg.enc_attn(i):
                attn(f"decoder.up.{i}.attn.{j}", cout)
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", cout, cout, 3)
    gn("decoder.norm_out", cin)
    conv("decoder.conv_out", cfg.out_channels, cin, 3)
    conv("quant_conv", cfg.codebook_dim, cfg.z_channels, 1)
    conv("post_quant_conv", cfg.z_channels, cfg.codebook_dim, 1)
    sd["quantize.embedding.weight"] = (
        rng.standard_normal((cfg.codebook_size, cfg.codebook_dim))
        .astype(np.float32))
    return sd
