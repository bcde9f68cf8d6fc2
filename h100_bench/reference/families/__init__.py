"""What the reference needs of each model family, found by the
configuration's ``family``: ``families/<family>.py`` gives ``rows(cfg,
weights, desc, served, device)``, the request's (cond, uncond) rows over
its prompt and served tokens with the row indices whose logits predict
each served token, and ``rope(cfg, row, device)``, the rotation of a row's
q and k.  A new family is a file of its own.

Shared by every family, from the configuration's ``image`` group: the
image-token columns that are compared, and the grammar a served stream
keeps (with ``row_end``: a row-end id after every ``w`` image tokens and
the end-of-image id last).

A request is described the same way to the program and to the reference:
``{"text_ids": [...]}`` (a token prompt) or ``{"caption": str}``.
"""

from __future__ import annotations

import importlib

import numpy as np


def of(cfg: dict):
    """The configuration's family module."""
    return importlib.import_module(f"{__name__}.{cfg['family']}")


def vocab_cols(cfg: dict) -> slice:
    """The image-token columns of the head: the logits that are compared."""
    lo, hi = cfg["image"]["image_token_ids"]
    return slice(lo, hi + 1)


def forced(cfg: dict, n: int) -> np.ndarray:
    """[n]: the token the image grammar forces at each served index (a row
    end, the image's end), or -1 where an image token goes."""
    im = cfg["image"]
    out = np.full(n, -1, np.int64)
    if im.get("row_end"):
        h, w = im["grid"]
        i = np.arange(n)
        out[(i + 1) % (w + 1) == 0] = im["row_end_id"]
        out[i == (w + 1) * h] = im["end_id"]
    return out


def grammar_violations(cfg: dict, served: np.ndarray) -> int:
    """Served tokens that break the image grammar: a forced token missing,
    or anything but an image id elsewhere."""
    lo, hi = cfg["image"]["image_token_ids"]
    s = np.asarray(served, np.int64)
    f = forced(cfg, len(s))
    img = f < 0
    return int(np.sum(~img & (s != f))
               + np.sum(img & ((s < lo) | (s > hi))))
