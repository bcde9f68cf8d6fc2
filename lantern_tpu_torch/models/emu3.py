"""Emu3-Gen (BAAI) glue: its special and visual ids, the token prompts of
its CFG generation (a caption row and a negative-prompt row), the grid FSM
at its ids and the LANTERN nearest table at its visual offset.

Emu3 is a decoder over one vocabulary of 184,622 ids: Qwen's 151,643 text
ids, special ids, then 32,768 visual ids (VQ code ``c`` is id ``151,854 +
c``).  An image of ``h x w`` latents is written row by row, each row ``w``
visual ids and a row end (``EOL_ID``), then an end of frame (``EOF_ID``):
90 x 90 latents (720 px) make 8,191 tokens.  A generation prompt is
``bos + caption + boi + "H*W" + img``; classifier-free guidance runs a
second row over a negative prompt with the same header, so either row may
be the longer.  The engines need no Emu3 path: ``token_prompt`` lays both
rows into one ``TokenPrompt`` (left pads, each row's positions from 0 where
its pads allow, the FSM start in ``image_start``), ``grid_fsm`` is
``LuminaGridFSM`` at Emu3's ids, and ``nearest_table`` shifts the codebook
neighbours to the visual ids.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import chameleon as cham

GRID = (90, 90)                 # 720 px


class Emu3Ids(NamedTuple):
    """The ids a generation prompt and the image grammar use (the defaults:
    Emu3-Gen's ``config.json``; a test model passes its own)."""
    vocab: int = 184622
    pad: int = 151643            # Qwen's <|endoftext|>
    eol: int = 151846            # a row's end
    eof: int = 151847            # the image's last row is done
    bos: int = 151849
    img: int = 151851            # the header's last token
    boi: int = 151852            # the header's first token
    visual_start: int = 151854   # VQ code c <-> id c + visual_start
    codes: int = 32768

    @property
    def visual_end(self) -> int:                 # inclusive
        return self.visual_start + self.codes - 1


EMU3 = Emu3Ids()


def token_prompt(text_ids: Sequence[int], negative_ids: Sequence[int],
                 size_ids: Sequence[int], prefix: Sequence[int] = (),
                 grid: tuple = GRID, ids: Emu3Ids = EMU3) -> cham.TokenPrompt:
    """The CFG pair of one request (host tensors; ``.to(device)`` them):
    cond = bos + caption + header + prefix, uncond = bos + negative +
    header + prefix, the header ``boi + size_ids + img`` (``size_ids``: the
    tokenized "H*W").  ``prefix`` continues an image already in flight:
    whole rows of ``w`` visual ids and a row end.  Both rows are left-padded
    to one length L with invisible pads.  The uncond row's positions run
    from 0 at its first token (``pos_diff`` = its pads); the cond row's are
    its index (the engines give it no offset), so a padded cond row starts
    at its pad count, which rotary attention does not see.  The FSM's start
    is the image's first token less 3."""
    h, w = grid
    prefix = [int(t) for t in prefix]
    rows_ok = len(prefix) % (w + 1) == 0 and all(
        (t == ids.eol) if (i + 1) % (w + 1) == 0
        else ids.visual_start <= t <= ids.visual_end
        for i, t in enumerate(prefix))
    if not rows_ok:
        raise ValueError(f"prefix must be whole rows of {w} visual ids and "
                         f"a row end, got {len(prefix)} tokens")
    if len(prefix) >= h * (w + 1):
        raise ValueError(f"prefix holds {len(prefix) // (w + 1)} rows of "
                         f"{h}: the image is done")
    head = [ids.boi] + [int(t) for t in size_ids] + [ids.img]
    cond = [ids.bos] + [int(t) for t in text_ids] + head + prefix
    uncond = [ids.bos] + [int(t) for t in negative_ids] + head + prefix
    L = max(len(cond), len(uncond))
    pc, pu = L - len(cond), L - len(uncond)
    tokens = np.stack([[ids.pad] * pc + cond,
                       [ids.pad] * pu + uncond]).astype(np.int32)
    positions = np.stack([np.arange(L), np.concatenate(
        [np.zeros(pu, np.int64), np.arange(len(uncond))])]).astype(np.int32)
    valid = np.ones_like(tokens, dtype=bool)
    valid[0, :pc] = False
    valid[1, :pu] = False
    return cham.TokenPrompt(
        tokens=torch.from_numpy(tokens),
        positions=torch.from_numpy(positions),
        valid=torch.from_numpy(valid),
        pos_diff=torch.tensor(pu, dtype=torch.int32),
        image_start=torch.tensor(L - len(prefix) - 3, dtype=torch.int32))


def grid_fsm(grid: tuple = GRID, ids: Emu3Ids = EMU3) -> cham.LuminaGridFSM:
    """The image grammar at Emu3's ids: visual ids inside a row, the row end
    after every ``w``, the end of frame after the last row.  A request's
    start comes from its prompt's ``image_start`` (``spec.bind_logits_fn``
    binds it); the static ``image_start_idx`` is unused."""
    h, w = grid
    return cham.LuminaGridFSM(w=w, h=h, image_start_idx=0,
                              vocab_size=ids.vocab, newline_id=ids.eol,
                              image_end_id=ids.eof,
                              image_lo=ids.visual_start,
                              image_hi=ids.visual_end)


def nearest_table(table: np.ndarray, ids: Emu3Ids = EMU3) -> np.ndarray:
    """The codebook's nearest-latent table [codes, k] indexed and valued by
    visual id: [V, k]."""
    return cham.shift_nearest_table(table, ids.vocab,
                                    offset=ids.visual_start)
