"""Lumina-mGPT flexible-resolution item processing (FlexARItemProcessor).

Counterpart of ``lantern_tpu/models/item_processor.py``:

- crop-size enumeration and variable center-crop to the nearest token grid;
- image -> Chameleon VQGAN codes -> BPE ids with per-row newline tokens,
  wrapped ``[image_start, h_grid_tok, w_grid_tok, ..., image_end]``;
- the reverse ``decode_image`` / ``decode_ids`` walk that splits a
  generated stream into text spans and decoded uint8 images.

The codec calls run the port's ``vqgan.encode`` / ``decode_code`` on
tensors on the codec's device.  Token ids live in the Lumina BPE space:
``<reservedNNNNN>`` is BPE id ``NNNNN + 4`` (the newline 8803, the n-grids
token ``8804 + n``); a 32 px patch is 2 VQ latents.  Text tokenization is
any ``str -> List[int]`` callable; ``hash_tokenize`` is the deterministic
stand-in when no tokenizer file is at hand.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import chameleon as cham
from . import vqgan
from ..utils.image import resize
from .chameleon import (GRID_TOKEN_BASE, LATENTS_PER_PATCH,  # noqa: F401
                        grid_token)

PATCH_SIZE = 32                  # pixels per grid token


def generate_crop_size_list(num_patches: int, patch_size: int = PATCH_SIZE,
                            max_ratio: float = 4.0) -> List[Tuple[int, int]]:
    """All (w, h) pixel sizes with w/32 * h/32 <= num_patches and aspect
    ratio <= max_ratio, walking the Pareto frontier."""
    assert max_ratio >= 1.0
    out = []
    wp, hp = num_patches, 1
    while wp > 0:
        if max(wp, hp) / min(wp, hp) <= max_ratio:
            out.append((wp * patch_size, hp * patch_size))
        if (hp + 1) * wp <= num_patches:
            hp += 1
        else:
            wp -= 1
    return out


def var_center_crop_size(w: int, h: int,
                         crop_size_list: Sequence[Tuple[int, int]],
                         random_top_k: int = 1,
                         rng: Optional[np.random.Generator] = None):
    """The crop size whose aspect best matches ``w`` x ``h``."""
    rem = [min(cw / w, ch / h) / max(cw / w, ch / h)
           for cw, ch in crop_size_list]
    ranked = sorted(zip(rem, crop_size_list), reverse=True)[:random_top_k]
    if len(ranked) > 1 and rng is not None:
        return ranked[int(rng.integers(len(ranked)))][1]
    return ranked[0][1]


def center_crop(image: np.ndarray, cw: int, ch: int) -> np.ndarray:
    """uint8 HWC center crop, rescaling first (PIL's Lanczos, through
    ``utils.image.resize``) so the short edge covers the crop."""
    h, w = image.shape[:2]
    scale = max(cw / w, ch / h)
    if scale != 1.0:
        nw, nh = max(cw, int(round(w * scale))), max(ch, int(round(h * scale)))
        image = resize(torch.from_numpy(np.ascontiguousarray(image)),
                       (nw, nh), "lanczos").numpy()
        h, w = image.shape[:2]
    top, left = (h - ch) // 2, (w - cw) // 2
    return image[top: top + ch, left: left + cw]


def codes_to_image_tokens(codes: np.ndarray) -> List[int]:
    """VQ code grid [h_lat, w_lat] -> flat Lumina BPE token list with the
    grid header, per-row newline tokens and the end-of-image token."""
    h_lat, w_lat = codes.shape
    assert h_lat % LATENTS_PER_PATCH == 0 and w_lat % LATENTS_PER_PATCH == 0
    bpe = cham.img_to_bpe(codes)
    rows = np.concatenate(
        [bpe, np.full((h_lat, 1), cham.LUMINA_NEWLINE_ID, np.int64)], axis=1
    ).reshape(-1)
    return [
        cham.IMAGE_START_ID,
        grid_token(h_lat // LATENTS_PER_PATCH),
        grid_token(w_lat // LATENTS_PER_PATCH),
        *rows.tolist(),
        cham.IMAGE_END_ID,
    ]


def image_tokens_to_codes(tokens: Sequence[int]) -> Tuple[np.ndarray, int, int]:
    """Reverse of ``codes_to_image_tokens``: ``(codes [h_lat, w_lat], h_lat,
    w_lat)``; a bad header or a span of the wrong length raises."""
    toks = list(tokens)
    if toks and toks[0] == cham.IMAGE_START_ID:
        toks = toks[1:]
    if toks and toks[-1] == cham.IMAGE_END_ID:
        toks = toks[:-1]
    h_grids, w_grids = toks[0] - GRID_TOKEN_BASE, toks[1] - GRID_TOKEN_BASE
    if not (0 < h_grids <= 64 and 0 < w_grids <= 64):
        raise ValueError(f"bad grid header {toks[:2]}")
    toks = toks[2:]
    h_lat, w_lat = h_grids * LATENTS_PER_PATCH, w_grids * LATENTS_PER_PATCH
    if len(toks) != h_lat * (w_lat + 1):
        raise ValueError(
            f"image span has {len(toks)} tokens, want {h_lat}x({w_lat}+1)")
    grid = np.asarray(toks, np.int64).reshape(h_lat, w_lat + 1)[:, :-1]
    return cham.bpe_to_img(grid), h_lat, w_lat


def hash_tokenize(text: str, vocab_lo: int = 10000, vocab_hi: int = 55000
                  ) -> List[int]:
    """Deterministic stand-in text tokenizer: each word's FNV-1a hash into
    the text-token range."""
    out = []
    for word in text.split():
        h = 2166136261
        for ch in word.encode():
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        out.append(vocab_lo + h % (vocab_hi - vocab_lo))
    return out


@dataclasses.dataclass
class FlexARItemProcessor:
    """Conversation -> token stream with inline images (Lumina flavor).

    ``qas`` follows the ``[[question, answer], ...]`` conversation shape;
    ``<|image|>`` in a turn splices in the next image's tokens.  The codec
    (``vq_params`` / ``vq_cfg``, the port's Chameleon VQGAN) runs on the
    device its parameters live on."""

    vq_params: Optional[dict] = None
    vq_cfg: Optional[vqgan.VQGANConfig] = None
    target_size: int = 768
    tokenizer: Optional[Callable[[str], List[int]]] = None

    def __post_init__(self):
        self.crop_size_list = generate_crop_size_list(
            (self.target_size // PATCH_SIZE) ** 2, PATCH_SIZE)
        if self.tokenizer is None:
            self.tokenizer = hash_tokenize

    def _device(self):
        return self.vq_params["codebook"].device

    # -- images --------------------------------------------------------
    def process_image(self, image: np.ndarray) -> List[int]:
        """uint8 HWC image -> its Lumina token span."""
        if self.vq_params is None:
            raise ValueError("FlexARItemProcessor needs vq_params to encode "
                             "images (pass the Chameleon VQGAN checkpoint)")
        cw, ch = var_center_crop_size(image.shape[1], image.shape[0],
                                      self.crop_size_list)
        img = center_crop(image, cw, ch)
        x = torch.as_tensor(np.ascontiguousarray(img), dtype=torch.float32,
                            device=self._device())
        x = (x / 127.5 - 1.0).permute(2, 0, 1)[None]             # [1, 3, H, W]
        codes = vqgan.encode(self.vq_params, self.vq_cfg, x)[0].cpu().numpy()
        h_lat = ch // (PATCH_SIZE // LATENTS_PER_PATCH)
        w_lat = cw // (PATCH_SIZE // LATENTS_PER_PATCH)
        return codes_to_image_tokens(codes.reshape(h_lat, w_lat))

    def decode_image(self, tokens: Sequence[int]) -> np.ndarray:
        """An image token span -> uint8 [H, W, 3]."""
        if self.vq_params is None:
            raise ValueError("decode_image needs vq_params")
        codes, h_lat, w_lat = image_tokens_to_codes(tokens)
        px = vqgan.decode_code(
            self.vq_params, self.vq_cfg,
            torch.as_tensor(codes.reshape(1, -1), device=self._device()),
            grid=(h_lat, w_lat))
        return vqgan.to_uint8(px)[0]

    # -- conversations -------------------------------------------------
    def process_item(self, qas: Sequence[Sequence[Optional[str]]],
                     images: Sequence[np.ndarray] = ()) -> List[int]:
        """Flatten a [[q, a], ...] conversation; ``<|image|>`` in any turn
        splices the next image's token span.  A trailing ``None`` answer
        ends the prompt for generation."""
        img_iter = iter(images)
        out: List[int] = []
        for q, a in qas:
            for turn in (q, a):
                if turn is None:
                    continue
                parts = turn.split("<|image|>")
                for i, part in enumerate(parts):
                    if i > 0:
                        out.extend(self.process_image(next(img_iter)))
                    if part.strip():
                        out.extend(self.tokenizer(part.strip()))
        return out

    def decode_ids(self, tokens: Sequence[int]):
        """Split a generated stream into text-token spans and decoded
        images; a truncated image span ends the walk."""
        texts: List[List[int]] = []
        images: List[np.ndarray] = []
        cur: List[int] = []
        toks = list(tokens)
        i = 0
        while i < len(toks):
            if toks[i] == cham.IMAGE_START_ID:
                try:
                    j = toks.index(cham.IMAGE_END_ID, i + 1)
                except ValueError:
                    break
                images.append(self.decode_image(toks[i: j + 1]))
                if cur:
                    texts.append(cur)
                    cur = []
                i = j + 1
            else:
                cur.append(toks[i])
                i += 1
        if cur:
            texts.append(cur)
        return texts, images
