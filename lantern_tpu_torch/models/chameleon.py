"""Chameleon-family (Anole / Lumina-mGPT) glue: the token prompts, image
token ranges, vocab translation, the nearest-table shift and the Lumina
grid FSM.

Counterpart of ``lantern_tpu/models/chameleon.py`` (plus ``TokenPrompt``,
which the JAX package keeps in ``engine/spec.py``, and the two grid-token
constants of ``models/item_processor.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import span

PAD_ID = 1
IMAGE_TOKEN_OFFSET = 4          # VQ code c <-> BPE id c + 4
IMAGE_TOKEN_START = 4
IMAGE_TOKEN_END = 8195          # inclusive
IMAGE_END_ID = 8196             # end-of-image
IMAGE_START_ID = 8197           # begin-of-image
ANOLE_EOT = 8710                # end-of-turn before image
LUMINA_NEWLINE_ID = 8803
VOCAB = 65536
LATENTS_PER_PATCH = 2           # VQGAN downsamples 16x; 32px patch = 2 latents
GRID_TOKEN_BASE = 8804          # BPE id of <reserved08800> == n_grids 0


def grid_token(n_grids: int) -> int:
    return GRID_TOKEN_BASE + n_grids


class TokenPrompt(NamedTuple):
    """Token conditioning prefix: cond/uncond rows with per-branch position
    ids and left-pad masks.  ``image_start`` is the grid FSM's start in the
    cond row (its first image token sits at ``image_start + 3``); None
    leaves it at ``pos_diff``, where the Lumina prompts put it (their
    uncond row restarts its positions at the image header)."""
    tokens: torch.Tensor        # [2, L] int32
    positions: torch.Tensor     # [2, L] int32 base position ids
    valid: torch.Tensor         # [2, L] bool (False on left pads)
    pos_diff: torch.Tensor      # [] int32 uncond position offset
    image_start: Optional[torch.Tensor] = None    # [] int32, or None

    def to(self, device) -> "TokenPrompt":
        return TokenPrompt(*(None if t is None else t.to(device)
                             for t in self))


def non_image_token_mask(vocab_size: int = VOCAB) -> np.ndarray:
    """bool [V]: True on every token outside the image range."""
    m = np.ones((vocab_size,), bool)
    m[IMAGE_TOKEN_START: IMAGE_TOKEN_END + 1] = False
    return m


def shift_nearest_table(table: np.ndarray, vocab_size: int = VOCAB,
                        offset: int = IMAGE_TOKEN_OFFSET) -> np.ndarray:
    """VQ-code nearest table [n_codes, k] -> BPE-id-indexed table [V, k],
    code c at id ``c + offset`` (Lumina's 4, Emu3's 151,854)."""
    out = np.zeros((vocab_size, table.shape[1]), np.int32)
    n = table.shape[0]
    out[offset: offset + n] = table + offset
    return out


def bpe_to_img(tokens: np.ndarray) -> np.ndarray:
    """BPE image-token ids -> VQ codes (contiguous-offset scheme)."""
    return np.asarray(tokens) - IMAGE_TOKEN_OFFSET


def img_to_bpe(codes: np.ndarray) -> np.ndarray:
    return np.asarray(codes) + IMAGE_TOKEN_OFFSET


def vocab_map_tables(vocab_map: dict) -> tuple[np.ndarray, np.ndarray]:
    """img->bpe / bpe->img tables from a real tokenizer vocab map with
    IMGIMG-style names, for checkpoints whose mapping is not the contiguous
    offset: ``(img2bpe [n_codes], bpe2img [max bpe + 1], -1 off images)``."""
    chr_map = {chr(ord("A") + i): str(i) for i in range(10)}
    img_tokens = sorted(v for k, v in vocab_map.items()
                        if k.startswith("IMGIMG"))
    name_of = {v: k for k, v in vocab_map.items()}
    bpe2img = {}
    for tok in img_tokens:
        name = name_of[tok]
        code = int("".join(chr_map.get(c, c)
                           for c in name[len("IMGIMG"):-1]))
        bpe2img[tok] = code
    n_codes = max(bpe2img.values()) + 1
    img2bpe = np.zeros((n_codes,), np.int32)
    bpe2img_arr = np.full((max(bpe2img) + 1,), -1, np.int32)
    for b, c in bpe2img.items():
        img2bpe[c] = b
        bpe2img_arr[b] = c
    return img2bpe, bpe2img_arr


def anole_token_prompt(text_tokens: Sequence[int]) -> TokenPrompt:
    """Anole cond/uncond prompt pair (host tensors): cond = [0] + text +
    [end-of-turn, image-start]; uncond = left pads + [0, image-start],
    its positions restarting (pads at 0, the image start at 1).  Only the
    uncond row's pads are invisible."""
    cond = [0] + list(text_tokens) + [ANOLE_EOT, IMAGE_START_ID]
    L = len(cond)
    uncond = [PAD_ID] * (L - 2) + [0, IMAGE_START_ID]
    tokens = np.stack([cond, uncond]).astype(np.int32)
    uncond_pos = np.zeros((L,), np.int64)
    uncond_pos[-1] = 1
    positions = np.stack([np.arange(L), uncond_pos]).astype(np.int32)
    valid = np.ones_like(tokens, dtype=bool)
    valid[1, : L - 2] = False
    return TokenPrompt(
        tokens=torch.from_numpy(tokens),
        positions=torch.from_numpy(positions),
        valid=torch.from_numpy(valid),
        pos_diff=torch.tensor(L - 2, dtype=torch.int32),
    )


def lumina_token_prompt(text_tokens: Sequence[int],
                        grid: tuple[int, int] = (48, 48)) -> TokenPrompt:
    """Lumina parallel-CFG prompt (host tensors; ``.to(device)`` them):
    cond = text + [image-start, h-grid, w-grid]; the uncond branch is left
    pads followed by the same header, its positions restarting at the
    image-start token."""
    h_lat, w_lat = grid
    prefix = (IMAGE_START_ID,
              grid_token(h_lat // LATENTS_PER_PATCH),
              grid_token(w_lat // LATENTS_PER_PATCH))
    cond = list(text_tokens) + list(prefix)
    L = len(cond)
    image_start_idx = L - 3
    uncond = [PAD_ID] * image_start_idx + list(prefix)
    tokens = np.stack([cond, uncond]).astype(np.int32)
    cond_pos = np.arange(L)
    uncond_pos = np.concatenate(
        [np.zeros((image_start_idx,), np.int64), np.arange(3)])
    positions = np.stack([cond_pos, uncond_pos]).astype(np.int32)
    valid = np.ones_like(tokens, dtype=bool)
    valid[1, :image_start_idx] = False
    return TokenPrompt(
        tokens=torch.from_numpy(tokens),
        positions=torch.from_numpy(positions),
        valid=torch.from_numpy(valid),
        pos_diff=torch.tensor(image_start_idx, dtype=torch.int32),
    )


class LuminaGridFSM(NamedTuple):
    """Position-indexed image-grammar constraints (Lumina
    MultiModalLogitsProcessor semantics, vectorized over tree nodes)."""

    w: int                       # latent width (tokens per row)
    h: int                       # latent height
    image_start_idx: int         # index of the image-start token in cond
    vocab_size: int = VOCAB
    newline_id: int = LUMINA_NEWLINE_ID
    image_end_id: int = IMAGE_END_ID
    image_lo: int = IMAGE_TOKEN_START
    image_hi: int = IMAGE_TOKEN_END

    def __call__(self, logits: torch.Tensor, positions: torch.Tensor,
                 start=None) -> torch.Tensor:
        """logits [T, V] scoring the tokens at cond positions+1; ``start``
        (tensor) overrides the static image-start index.  Recorded as the
        span ``grid_fsm``."""
        with span("grid_fsm"):
            return self._constrain(logits, positions, start)

    def _constrain(self, logits, positions, start):
        if self.newline_id >= self.vocab_size or self.image_end_id >= self.vocab_size:
            raise ValueError(
                f"newline_id {self.newline_id} / image_end_id "
                f"{self.image_end_id} outside vocab {self.vocab_size}; "
                "pass fsm overrides for small-vocab configs")
        isi = self.image_start_idx if start is None else start
        neg = torch.finfo(torch.float32).min
        dev = logits.device
        k = (positions + 1) - (isi + 1 + 2) + 1                       # [T]
        ids = torch.arange(self.vocab_size, device=dev)
        suppress = (ids < self.image_lo) | (ids > self.image_hi)
        inner = (k % (self.w + 1)) != 0
        logits = torch.where(inner[:, None] & suppress[None, :],
                             torch.full_like(logits, neg), logits)
        forced = torch.full((self.vocab_size,), neg, dtype=logits.dtype,
                            device=dev)
        nl_row = forced.clone()
        nl_row[self.newline_id] = 0.0
        newline = (k % (self.w + 1)) == 0
        logits = torch.where(newline[:, None], nl_row[None, :], logits)
        eos_row = forced
        eos_row[self.image_end_id] = 0.0
        eos = k == (self.w + 1) * self.h + 1
        return torch.where(eos[:, None], eos_row[None, :], logits)
