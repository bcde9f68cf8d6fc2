"""CLIP's SimpleTokenizer (byte-level word BPE), the port's own copy of
``lantern_tpu/evals/clip_bpe.py``.

The reference tokenizes CLIP-score prompts with ``openai_clip.tokenize``:
whitespace cleanup and lowercase, a word / number / apostrophe regex split,
byte-to-unicode remapping, then greedy lowest-rank BPE over each word with
a ``</w>`` end-of-word marker, wrapped in ``<|startoftext|>`` /
``<|endoftext|>``.  ``ClipTokenizer`` takes the path of the canonical
merges file (``bpe_simple_vocab_16e6.txt.gz``, not in the repository) or
an explicit list of merge pairs.  Vocab layout (the canonical file's
contract): 256 byte symbols, 256 byte+``</w>`` symbols, one merged symbol
per merge line, then the two specials: 49408 for the shipped 48894 merges.
"""

from __future__ import annotations

import gzip
import re
from typing import Dict, List, Sequence, Tuple

# canonical pattern uses the `regex` module's \p{L}/\p{N}; stdlib-re
# equivalents: [^\W\d_]+ (unicode letters), \d (unicode digits)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE | re.UNICODE)


def bytes_to_unicode() -> Dict[int, str]:
    """The published GPT-2/CLIP reversible byte->unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipTokenizer:
    """``tokenizer(texts) -> [N, ctx] int32`` with CLIP conventions.

    ``merges``: path to the canonical merges file (.txt or .txt.gz), or an
    explicit list of (a, b) merge pairs (tests).
    """

    def __init__(self, merges, ctx: int = 77):
        self.ctx = ctx
        self.byte_encoder = bytes_to_unicode()
        if isinstance(merges, str):
            opener = gzip.open if merges.endswith(".gz") else open
            with opener(merges, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
            # canonical file: a version header line, merges 1..48894 used
            pairs = [tuple(m.split()) for m in lines[1:48894 + 1]
                     if len(m.split()) == 2]
        else:
            pairs = [tuple(m) for m in merges]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(p) for p in pairs]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {p: i for i, p in enumerate(pairs)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        while pairs:
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if best not in self.bpe_ranks:
                break
            a, b = best
            out: List[str] = []
            i = 0
            while i < len(word):
                if word[i] == a and i < len(word) - 1 and word[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = tuple(out)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        self._cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts: Sequence[str], prepend: str = ""):
        """Tokenize to ``[N, ctx]`` with SOT/EOT + zero padding, truncating
        with EOT at the last column — and, when ``prepend`` is set, splicing
        the prepend-prompt tokens after SOT exactly like the reference's
        "A photo depicts " trick (eval_fid_clip.py:143-155)."""
        import numpy as np

        pre = self.encode(prepend) if prepend else []
        out = np.zeros((len(texts), self.ctx), np.int32)
        for i, t in enumerate(texts):
            ids = [self.sot] + pre + self.encode(t) + [self.eot]
            if len(ids) > self.ctx:
                ids = ids[: self.ctx - 1] + [self.eot]
            out[i, : len(ids)] = ids
        return out
