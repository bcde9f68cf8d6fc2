"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, the plain
reference (``reference/``) runs once over each checked request's prompt
and served tokens, in float32 from the benchmark's own weights, and each
row that predicts a served token is compared with the program's row:

- ``top1_gap``: the widest gap by which the image token that the program
  puts first lies below the reference's best, in logits (0 where they
  agree; a near-tie that rounding flips reads a small gap);
- ``logit_err``: the widest distance between the program's 8 largest
  logits and the reference's at the same columns, over the reference
  row's standard deviation;
- ``support_rank``: the worst rank (0: the best), under the reference's
  logits, of a served image token that was sampled from its own row (a
  verify step's bonus, every AR token: it came from the top-k, so it
  ranks near k at worst); a token altered where it was produced ranks
  anywhere;
- ``walk_flips``: each verify step's acceptance walk replayed by the
  reference (``reference/lantern.Walk``) with the coins the program's walk
  drew (the request's random stream at the walk's start) over the
  program's draft tree, against the reference's own distributions: the
  share (%) of the program's decisions (take or refuse a draft) that the
  relaxed rule decides otherwise with the same coin.  A sound walk flips
  only where its probability rounds across the coin; a walk that takes
  drafts the rule refuses flips most of them.  ``walk_coins`` counts the
  decisions replayed;
- ``grammar``: served tokens that break the image grammar (exact: 0);
- ``failed``: requests that failed (exact: 0).

The control is the same reference one precision step below the
configuration (int4 weights and KV cache) put in the program's place:
``control_numbers`` reads its ``top1_gap`` and ``logit_err`` on the same
prompts and tokens.  Each number's limit is in ``limits/<cell>.json``,
with the readings it was set from, and each count's floor (``rows``,
``walk_coins``: a run that compared too little is not correct).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from .reference import families, lantern, model

HERE = Path(__file__).resolve().parent


def limits(cell: str, root: Path = HERE.parent) -> dict:
    """``limits/<cell>.json`` under the checkout ``root``."""
    return json.loads((root / HERE.name / "limits" / f"{cell}.json")
                      .read_text())


def _gap_err(ref: torch.Tensor, vals: torch.Tensor, cols: torch.Tensor):
    """Per row: the reference's best minus its value at the candidate's
    first column, and the largest distance at the candidate's columns over
    the reference row's standard deviation."""
    best = ref.max(-1).values
    at = torch.gather(ref, 1, cols)
    gap = best - at[:, 0]
    err = (vals - at).abs().max(-1).values / ref.std(-1)
    return gap, err


def reference_logits(cfg: dict, weights: dict, checked: List[dict],
                     cfg_scale: float, device, wbits: int = 8,
                     kvbits: int = 8):
    """The reference's CFG-combined image-token logits [n_served, cols] of
    each checked request (``{"desc", "served"}``)."""
    rows, idx = [], []
    fam = families.of(cfg)
    for c in checked:
        r, i = fam.rows(cfg, weights, c["desc"], c["served"], device)
        rows += r
        idx += i
    out = model.logits(cfg, weights, rows, idx, families.vocab_cols(cfg),
                       wbits=wbits, kvbits=kvbits)
    return [out[2 * k + 1] + cfg_scale * (out[2 * k] - out[2 * k + 1])
            for k in range(len(checked))]


def neighbours(cfg: dict, seed: int, k: int, device) -> np.ndarray:
    """The LANTERN neighbour table [codes, k] over the image columns, from
    the benchmark's codebook latents (``weights.codebook_latents``)."""
    from .weights import codebook_latents

    return lantern.nearest(codebook_latents(cfg, seed, device),
                           k).cpu().numpy()


def numbers(cfg: dict, traffic: dict, checked: List[dict], refs,
            failed: int, near=None) -> Dict:
    """The program's numbers from its captured rows and walks
    (``capture.rows_of``) and its served tokens against the reference's
    logits ``refs``; ``near`` the LANTERN neighbours (spec mode)."""
    gaps, errs, grammar, rows, ranks = [0.0], [0.0], 0, 0, [0]
    flips = []
    lo, hi = cfg["image"]["image_token_ids"]
    for c, ref in zip(checked, refs):
        grammar += families.grammar_violations(cfg, c["served"])
        dev = ref.device
        s = torch.as_tensor(c["served"], device=dev)
        sel = ((s >= lo) & (s <= hi)
               & torch.as_tensor(c["sampled"], device=dev))
        if bool(sel.any()):
            ranks.append(int(lantern.support_rank(ref[sel], s[sel] - lo)
                             .max()))
        if c["walk"]:
            walk = lantern.Walk(
                lantern.warped(ref, traffic["top_k"], traffic["temperature"])
                .double().cpu().numpy(),
                families.forced(cfg, len(c["served"])), near, lo,
                cfg["vocab_size"], traffic["lantern_k"],
                traffic["lantern_delta"])
            for rec in c["walk"]:
                flips += walk.step(rec, lantern.coins(
                    rec["state"], rec["depth"], rec["children"].shape[1],
                    dev))
        if len(c["index"]) == 0:
            continue
        r = ref[torch.as_tensor(c["index"], device=dev)]
        g, e = _gap_err(r, torch.as_tensor(c["vals"], device=dev),
                        torch.as_tensor(c["cols"], device=dev))
        gaps.append(float(g.max()))
        errs.append(float(e.max()))
        rows += len(c["index"])
    out = {"top1_gap": max(gaps), "logit_err": max(errs),
           "support_rank": max(ranks), "grammar": grammar,
           "failed": failed, "rows": rows}
    if flips:
        out.update(walk_flips=100.0 * sum(flips) / len(flips),
                   walk_coins=len(flips))
    return out


def control_numbers(refs, ctrl) -> Dict:
    """The control's ``top1_gap`` and ``logit_err`` at every row of the
    same requests: its own 8 largest logits against the reference's."""
    gaps, errs = [0.0], [0.0]
    for ref, c in zip(refs, ctrl):
        if c.shape[0] == 0:
            continue
        v, i = torch.topk(c, 8, dim=-1)
        g, e = _gap_err(ref, v, i)
        gaps.append(float(g.max()))
        errs.append(float(e.max()))
    return {"top1_gap": max(gaps), "logit_err": max(errs)}


def judge(nums: Dict, lim: Dict) -> Dict:
    """``{"correct": bool, "checks": {name: {"value", "limit"}}}``: each
    number of ``lim["limits"]`` passes at or under its limit, each count of
    ``lim["floors"]`` at or over its floor; a number the run did not read
    fails."""
    checks = {k: {"value": nums.get(k), "limit": v}
              for k, v in lim["limits"].items()}
    checks.update({k: {"value": nums.get(k, 0), "limit": v}
                   for k, v in lim["floors"].items()})
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for k, c in checks.items() if k in lim["limits"])
    ok = ok and all(checks[k]["value"] >= v for k, v in lim["floors"].items())
    return {"correct": bool(ok), "checks": checks}


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def served_sample(n: int, k: int, seed: int) -> np.ndarray:
    """``k`` of ``n`` request indices drawn from ``seed`` (sorted)."""
    rng = np.random.default_rng([int(seed), 17])
    return np.sort(rng.choice(n, size=min(k, n), replace=False))
