"""Chameleon-family BPE tokenizer loading (Anole / Lumina-mGPT).

Counterpart of ``lantern_tpu/models/bpe.py``.  Every Anole and Lumina
checkpoint ships a ``tokenizers``-format JSON file; ``ChameleonBPE`` loads
it and exposes ``encode``/``decode``, the special-token ids and the
image-token translation tables the sessions need.  The ``tokenizers``
package is imported only when a tokenizer is loaded, so the rest of the
port runs without it; ``item_processor.hash_tokenize`` stands in for
weight-free runs.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

import numpy as np

from . import chameleon as cham

# candidate locations of the tokenizer JSON inside a checkpoint dir, in
# search order (Anole layout, Lumina layout, HF exports)
_TOKENIZER_CANDIDATES = (
    "tokenizer/text_tokenizer.json",                 # Anole-7b
    "chameleon/tokenizer/text_tokenizer.json",       # Lumina-mGPT base_path
    "text_tokenizer.json",
    "tokenizer.json",                                # HF-style export
)


class ChameleonBPE:
    """Chameleon BPE tokenizer and vocab info from one ``tokenizer.json``:
    special-token ids from the vocab names, image-token translation from
    the IMGIMG name scheme (``chameleon.vocab_map_tables``)."""

    def __init__(self, tokenizer_path: str):
        from tokenizers import Tokenizer

        self.path = tokenizer_path
        self.tokenizer = Tokenizer.from_file(tokenizer_path)
        with open(tokenizer_path, encoding="utf8") as f:
            vocab_map = json.load(f)["model"]["vocab"]
        self.vocab_map = vocab_map
        self.bos_id = vocab_map.get("<s>")
        self.eos_id = vocab_map.get("</s>")
        self.boi_id = vocab_map.get("<racm3:break>")     # begin image, 8197
        self.eoi_id = vocab_map.get("<eoss>")            # end image, 8196
        self.pad_id = vocab_map.get("<pad>")
        self.eot_id = vocab_map.get("<reserved08706>")   # end turn
        self.newline_id = vocab_map.get("<reserved08799>")  # Lumina, 8803
        self.img2bpe, self.bpe2img = cham.vocab_map_tables(vocab_map)

    @classmethod
    def from_checkpoint_dir(cls, ckpt_dir: str) -> "ChameleonBPE":
        """Find the tokenizer JSON under a checkpoint directory."""
        for rel in _TOKENIZER_CANDIDATES:
            p = os.path.join(ckpt_dir, rel)
            if os.path.exists(p):
                return cls(p)
        raise FileNotFoundError(
            f"no tokenizer json under {ckpt_dir} (tried "
            f"{_TOKENIZER_CANDIDATES}); pass tokenizer_path explicitly")

    def encode(self, text: str, bos: bool = False) -> List[int]:
        ids = self.tokenizer.encode(text, add_special_tokens=False).ids
        if bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        return ids

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        arr = [int(t) for t in np.asarray(ids).reshape(-1)]
        return self.tokenizer.decode(arr, skip_special_tokens=skip_special)

    def img_to_bpe(self, codes: np.ndarray) -> np.ndarray:
        return self.img2bpe[np.asarray(codes)]

    def bpe_to_img(self, tokens: np.ndarray) -> np.ndarray:
        return self.bpe2img[np.asarray(tokens)]

    def __call__(self, text: str) -> List[int]:
        """The ``str -> List[int]`` callable the sessions and the item
        processor take."""
        return self.encode(text)


def load_tokenizer(path_or_dir: Optional[str]) -> Optional[ChameleonBPE]:
    """A tokenizer from a file path or a checkpoint dir; None -> None."""
    if path_or_dir is None:
        return None
    if os.path.isdir(path_or_dir):
        return ChameleonBPE.from_checkpoint_dir(path_or_dir)
    return ChameleonBPE(path_or_dir)
