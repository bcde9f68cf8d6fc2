"""Caption features as the configuration assumes them (``RandomT5``): a
frozen copy of the pseudo-T5 rule, so the reference works the features out
again from the caption text.  A caption of n words gives n + 2 valid rows
(at most ``rows``) of N(0, 0.25) features drawn by numpy's default
generator seeded with the first four bytes of the SHA-1 of the cleaned
caption; valid rows go to the right of the prefix, pad rows are zero."""

from __future__ import annotations

import hashlib
import html
import re
import urllib.parse as ul

import numpy as np


def clean_caption(caption: str) -> str:
    caption = str(caption).lower().strip()
    caption = ul.unquote_plus(caption)
    caption = re.sub(r"<person>", "person", caption)
    caption = re.sub(r"\b(?:https?:|www\.)\S+", "", caption)
    caption = re.sub(r"<[^>]+>", "", caption)
    caption = html.unescape(html.unescape(caption))
    caption = re.sub(r"\s+", " ", caption)
    return caption.strip()


def features(caption: str, dim: int, rows: int):
    """``(feats f32 [rows, dim], valid bool [rows])``, left-padded."""
    digest = hashlib.sha1(clean_caption(caption).encode()).digest()
    rng = np.random.default_rng(int.from_bytes(digest[:4], "little")
                                % (2 ** 31))
    n = min(max(len(caption.split()), 1) + 2, rows)
    e = np.zeros((rows, dim), np.float32)
    e[rows - n:] = rng.normal(size=(n, dim)).astype(np.float32) * 0.5
    valid = np.zeros((rows,), bool)
    valid[rows - n:] = True
    return e, valid
