"""Caption features for LlamaGen t2i.

The port's counterpart of ``lantern_tpu/utils/t5.py``: ``clean_caption``;
``T5Embedder``, flan-t5-xl's encoder through ``transformers`` from a local
directory on a torch device; ``RandomT5`` (deterministic per-prompt
pseudo-features of flan-t5-xl's shape, so the t2i path runs with no
checkpoint) and ``flip_for_left_padding`` (valid rows to the right, pad
rows zeroed, the layout the CFG prefill expects).
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


class T5Embedder:
    """flan-t5-xl's encoder (``transformers``' ``T5EncoderModel`` and
    ``AutoTokenizer`` from the local ``model_dir``) on ``device`` (``None``:
    ``cuda``).  Captions are cleaned and padded or truncated to
    ``model_max_length`` tokens."""

    def __init__(self, model_dir: str, model_max_length: int = 120,
                 device=None):
        import torch

        from ..device import resolve_device

        try:
            from transformers import AutoTokenizer, T5EncoderModel
        except ImportError as e:
            raise ImportError(
                "T5Embedder needs the transformers package, which is not "
                "installed; without it captions embed through RandomT5") from e
        self.torch = torch
        self.device = resolve_device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_dir)
        self.model = T5EncoderModel.from_pretrained(model_dir).eval().to(
            self.device)
        self.model_max_length = model_max_length

    def get_text_embeddings(self, prompts):
        """``(emb f32 [n, model_max_length, d_model], mask int64 [n,
        model_max_length])`` as numpy arrays, valid rows first."""
        tok = self.tokenizer(
            [clean_caption(p) for p in prompts],
            max_length=self.model_max_length, padding="max_length",
            truncation=True, return_tensors="pt")
        with self.torch.no_grad():
            emb = self.model(
                input_ids=tok["input_ids"].to(self.device),
                attention_mask=tok["attention_mask"].to(self.device),
            ).last_hidden_state
        return emb.cpu().numpy(), tok["attention_mask"].numpy()


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
