"""Caption features for LlamaGen t2i without the T5 encoder.

The port's own copy of the numpy part of ``lantern_tpu/utils/t5.py``:
``clean_caption``, ``RandomT5`` (deterministic per-prompt pseudo-features of
flan-t5-xl's shape, so the t2i path runs with no downloaded checkpoint)
and ``flip_for_left_padding`` (valid rows to the right, pad rows zeroed,
the layout the CFG prefill expects).  The encoder wrapper itself needs
downloaded weights and is not carried over.
"""

from __future__ import annotations

import hashlib
import html
import re
import urllib.parse as ul

import numpy as np


def clean_caption(caption: str) -> str:
    """Strip urls and html tags, unescape, collapse whitespace."""
    caption = str(caption).lower().strip()
    caption = ul.unquote_plus(caption)
    caption = re.sub(r"<person>", "person", caption)
    caption = re.sub(r"\b(?:https?:|www\.)\S+", "", caption)
    caption = re.sub(r"<[^>]+>", "", caption)
    caption = html.unescape(html.unescape(caption))
    caption = re.sub(r"\s+", " ", caption)
    return caption.strip()


class RandomT5:
    """Deterministic per-prompt pseudo-embeddings of flan-t5-xl's shape: a
    prompt of n words gives n + 2 valid rows (at most ``model_max_length``)
    of N(0, 0.25) features seeded by a SHA-1 of the cleaned caption."""

    def __init__(self, dim: int = 2048, model_max_length: int = 120):
        self.dim = dim
        self.model_max_length = model_max_length

    def get_text_embeddings(self, prompts):
        """``(emb f32 [n, model_max_length, dim], mask int64 [n,
        model_max_length])``, valid rows first."""
        embs, masks = [], []
        for p in prompts:
            digest = hashlib.sha1(clean_caption(p).encode()).digest()
            seed = int.from_bytes(digest[:4], "little") % (2 ** 31)
            rng = np.random.default_rng(seed)
            n = min(max(len(p.split()), 1) + 2, self.model_max_length)
            e = np.zeros((self.model_max_length, self.dim), np.float32)
            e[:n] = rng.normal(size=(n, self.dim)).astype(np.float32) * 0.5
            m = np.zeros((self.model_max_length,), np.int64)
            m[:n] = 1
            embs.append(e)
            masks.append(m)
        return np.stack(embs), np.stack(masks)


def flip_for_left_padding(emb: np.ndarray, mask: np.ndarray):
    """Move the valid caption rows to the right and the pads to the left,
    zeroing the pad rows: ``(emb, mask)`` of the same shapes."""
    out_e = np.zeros_like(emb)
    out_m = mask[:, ::-1].copy()
    for i in range(emb.shape[0]):
        n = int(mask[i].sum())
        out_e[i, emb.shape[1] - n:] = emb[i, :n]
    return out_e * out_m[:, :, None], out_m
