"""The batched speculation-vs-AR crossover: the measurements behind
``engine/policy.MEASURED_BEST``.

Counterpart of ``scripts/sweep_batched.py``.  For each slot count R, R
requests are served at once by every candidate: ``BatchedEngine`` in
static mode over each named tree (rollback commit), and lockstep batched
AR.  Both paths run int8 weights and an int8 KV cache, LANTERN k=10
delta=5, top-2000 sampling and cfg 3.0, on random weights from seed 0:

- ``--geom xl``: LlamaGen-XL t2i (36 x 1,280, 20 heads of 64, vocab
  16,384), one ``RandomT5`` caption (left-padded), the one-layer
  hidden-passthrough drafter with stale drafting (what a session with
  that drafter serves in static mode: ``session._resolve_stale``; the
  same tokens as its forwards, none run), ``--tokens`` 128; R in {1, 4,
  8, 16}; trees ``naive_extend_57``, ``chain_bush_8`` and ``chain``; AR
  through ``ar.generate_many``;
- ``--geom lumina``: Lumina-mGPT-7B (32 x 4,096, swin norm), 16 text
  tokens, the ``--grid`` FSM (16: 273 tokens), stale drafting; R in
  {1, 2, 4}; trees ``calibrated`` (``policy.resolve_tree``),
  ``chain_bush_8`` and ``chain``; AR through ``ar.generate_tokens_many``.

``--layers`` cuts the depth (a quick run; the table is measured at full
depth).  Protocol: one untimed warm-up of ``WARMUP_TOKENS`` tokens per
(R, candidate); then ``--repeats`` rounds, each running every candidate
once in turn on the same R requests (seeds ``1000 * (repeat + 1) + i``),
so that host drift falls on all of them alike.  A run is timed on the host
clock from its first prefill to its last token, after a synchronize; a
speculative run steps as ``Scheduler`` serves, one ``step`` then
``slot_status``, and ends on the step that finishes its last slot.  A
candidate that fails fails the sweep: nothing is caught.

Output (stdout): one JSON line per timed run, ``{"geom", "R", "config",
"tok_s", "compression", "repeat"}`` (``config``: ``spec:<tree>`` or
``ar``; ``compression``: tokens committed per verify step, 1.0 for AR),
then one line ``{"summary": [{"geom", "R", "config", "median_tok_s",
"min_tok_s", "max_tok_s", "compression"}, ...], "winners": {R: [mode,
tree]}, "within_spread": [R, ...], "device": name}``.  ``pick_winners``
is the rule that turns the rows into a table of ``MEASURED_BEST``.

Run: ``python -m lantern_tpu_torch.engine.sweep --geom xl|lumina [--rs
1,4,8,16] [--trees a,b] [--tokens N] [--repeats 3] [--layers N] [--grid 16]
[--device cuda|cpu]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

from .. import configs, trees
from ..device import resolve_device, synchronize
from ..models import chameleon as cham
from ..models import drafter as drf
from ..models import transformer as tfm
from ..ops.acceptance import LanternSpec
from ..ops.quant import quantize_params
from ..ops.sampling import LogitsWarp
from ..ops.vq_distance import nearest_latents
from ..utils.t5 import RandomT5, flip_for_left_padding
from . import ar, spec
from .batch import BatchedEngine
from .policy import resolve_tree

GEOMS = {
    "xl": dict(rs="1,4,8,16", trees="naive_extend_57,chain_bush_8,chain",
               tokens=128),
    "lumina": dict(rs="1,2,4", trees="calibrated,chain_bush_8,chain",
                   tokens=None),          # the grid's tokens
}
WARMUP_TOKENS = 16      # allocator, cuBLAS and cache shapes, untimed
CAPTION = "a photo of a red fox standing in fresh snow at dawn"
TEXT = list(range(60000, 60016))          # 16 text tokens
WARP = LogitsWarp(temperature=1.0, top_k=2000, top_p=1.0)
ECFG = spec.SpecDecodeConfig(warp=WARP, cfg_scale=3.0,
                             lantern=LanternSpec(k=10, delta=5.0),
                             mode="static", kv_quant=True)


class Lane:
    """One geometry's model and requests: ``spec_run(tree, R, n, seed)`` and
    ``ar_run(R, n, seed)`` serve R requests of ``n`` tokens and return
    ``(verify steps, committed tokens)`` summed over the requests."""

    def __init__(self, geom: str, layers: Optional[int], grid: int, dev):
        self.geom, self.dev = geom, dev
        gen = torch.Generator(device=dev).manual_seed(0)
        if geom == "xl":
            cfg = configs.llamagen_config("XL", "t2i")
            codes = cfg.vocab_size
        else:
            n = grid * (grid + 1) + 1
            cfg = configs.chameleon_7b_config(
                max_seq_len=len(TEXT) + 3 + n + 74, swin_norm=True)
            codes = 8192
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        self.cfg = cfg
        params = quantize_params(tfm.fuse_params(
            tfm.init_params(gen, cfg, device=dev)))
        near = nearest_latents(torch.randn((codes, 8), generator=gen,
                                           device=dev), k=11)
        if geom == "lumina":
            near = cham.shift_nearest_table(near, cfg.vocab_size)
        params["nearest_latents"] = torch.as_tensor(near, device=dev)
        self.params = params
        self.dcfg = self.dparams = None
        if geom == "xl":
            self.dcfg = configs.drafter_config(cfg, num_layers=1,
                                               total_tokens=59, depth=4,
                                               top_k=10)
            d = drf.init_drafter_params(
                torch.Generator(device=dev).manual_seed(101), self.dcfg,
                params["embed"])
            H = cfg.hidden_size
            fc = torch.zeros((2 * H, H), dtype=d["fc_w"].dtype, device=dev)
            fc[H:] = torch.eye(H, dtype=fc.dtype, device=dev)
            d = dict(d, fc_w=fc,
                     layers={k: v * 0 for k, v in d["layers"].items()})
            self.dparams = quantize_params(tfm.fuse_params(d))
            t5 = RandomT5(cfg.caption_dim, cfg.cls_token_num)
            emb, mask = flip_for_left_padding(
                *t5.get_text_embeddings([CAPTION]))
            self.cond = torch.as_tensor(emb, device=dev)
            self.uncond = params["cond"]["uncond"][None].to(self.cond.dtype)
            pv = torch.ones((2, cfg.max_seq_len), dtype=torch.bool,
                            device=dev)
            pv[:, : cfg.cls_token_num] = torch.as_tensor(mask,
                                                         device=dev).bool()
            self.pv = pv
            self.fsm = None
        else:
            self.prompt = cham.lumina_token_prompt(
                TEXT, grid=(grid, grid)).to(dev)
            self.fsm = cham.LuminaGridFSM(w=grid, h=grid,
                                          image_start_idx=len(TEXT),
                                          vocab_size=cfg.vocab_size)
        synchronize(dev)

    def spec_run(self, name: str, R: int, n: int, seed: int):
        ecfg = dataclasses.replace(ECFG, max_new=n, stale_draft=True)
        eng = BatchedEngine(ecfg=ecfg, cfg=self.cfg,
                            tree=trees.get_tree(resolve_tree(name)),
                            params=self.params, num_slots=R,
                            dparams=self.dparams, dcfg=self.dcfg,
                            logits_fn=self.fsm, device=self.dev)
        if self.geom == "xl":
            kw = dict(cond=self.cond, uncond=self.uncond, prefix_valid=self.pv)
        else:
            kw = dict(token_prompt=self.prompt)
        reqs = [eng.prefill(generator=spec.request_generator(seed + i,
                                                             self.dev), **kw)
                for i in range(R)]
        batch = eng.empty_batch(reqs[0])
        for i, r in enumerate(reqs):
            batch = eng.insert(batch, i, r)
        while True:
            batch = eng.step(batch)
            n_new, steps, acc = eng.slot_status(batch)
            if (n_new >= n).all():
                return int(steps.sum()), int(acc.sum())

    def ar_run(self, R: int, n: int, seed: int):
        gens = [spec.request_generator(seed + i, self.dev) for i in range(R)]
        if self.geom == "xl":
            toks = ar.generate_many(
                self.params, self.cfg, self.cond[None].expand(
                    (R,) + self.cond.shape), self.uncond, n, ECFG.cfg_scale,
                WARP, gens, prefix_valid=self.pv[None].expand(
                    (R,) + self.pv.shape), kv_quant=True, device=self.dev)
        else:
            tp = cham.TokenPrompt(*(None if x is None else torch.stack(
                [x] * R) for x in self.prompt))
            toks, _ = ar.generate_tokens_many(
                self.params, self.cfg, tp, n, ECFG.cfg_scale, WARP, gens,
                logits_fn=self.fsm, kv_quant=True, device=self.dev)
        toks.cpu()
        return R * n, R * n


def _timed(fn, dev):
    synchronize(dev)
    t = time.perf_counter()
    out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t


def sweep(lane: Lane, rs: List[int], names: List[str], tokens: int,
          repeats: int, note=lambda m: None) -> List[dict]:
    """Every timed run's row (the module's protocol), printed as it comes."""
    rows = []
    for R in rs:
        cands = [(f"spec:{n}", lambda r, k, s, n=n: lane.spec_run(n, r, k, s))
                 for n in names] + [("ar", lane.ar_run)]
        for config, run in cands:
            run(R, min(WARMUP_TOKENS, tokens), 0)
            note(f"R={R} {config}: warmed up")
        for rep in range(repeats):
            for config, run in cands:
                (steps, acc), dt = _timed(
                    lambda: run(R, tokens, 1000 * (rep + 1)), lane.dev)
                row = dict(geom=lane.geom, R=R, config=config,
                           tok_s=R * tokens / dt,
                           compression=acc / max(steps, 1), repeat=rep)
                rows.append(row)
                print(json.dumps(row), flush=True)
                note(f"R={R} {config} repeat {rep}: {row['tok_s']:.2f} tok/s "
                     f"(C {row['compression']:.3f}, {dt:.2f} s)")
    return rows


def summarize(rows: List[dict]) -> List[dict]:
    """Per (geom, R, config) in the rows' order: median, min and max
    tok/s over the repeats, and the mean compression."""
    points: Dict[tuple, List[dict]] = {}
    for r in rows:
        points.setdefault((r["geom"], r["R"], r["config"]), []).append(r)
    return [dict(geom=g, R=R, config=c,
                 median_tok_s=statistics.median(x["tok_s"] for x in rs),
                 min_tok_s=min(x["tok_s"] for x in rs),
                 max_tok_s=max(x["tok_s"] for x in rs),
                 compression=statistics.fmean(x["compression"] for x in rs))
            for (g, R, c), rs in points.items()]


def _ranked(rows: List[dict]) -> Dict[int, List[dict]]:
    """Per R, the points best first: the higher median, on a tie the
    higher minimum, then the candidate that came first."""
    out: Dict[int, List[dict]] = {}
    for p in summarize(rows):
        out.setdefault(p["R"], []).append(p)
    return {R: sorted(ps, key=lambda p: (-p["median_tok_s"],
                                         -p["min_tok_s"]))
            for R, ps in sorted(out.items())}


def _plan(config: str) -> Tuple[str, Optional[str]]:
    return ("ar", None) if config == "ar" else ("spec", config[len("spec:"):])


def pick_winners(rows: List[dict]) -> Dict[int, Tuple[str, Optional[str]]]:
    """``{R: (mode, tree)}`` from one geometry's rows: the candidate with
    the highest median tok/s (``_ranked``'s order breaks ties)."""
    return {R: _plan(ps[0]["config"]) for R, ps in _ranked(rows).items()}


def within_spread(rows: List[dict]) -> List[int]:
    """The R whose winner's minimum does not clear the runner-up's maximum:
    the repeats do not order the two."""
    return [R for R, ps in _ranked(rows).items()
            if len(ps) > 1 and ps[0]["min_tok_s"] <= ps[1]["max_tok_s"]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--geom", default="xl", choices=sorted(GEOMS))
    ap.add_argument("--rs", default=None,
                    help="slot counts, comma-separated (default: the "
                         "table's keys)")
    ap.add_argument("--trees", default=None,
                    help="static trees, comma-separated (default: the "
                         "geometry's candidates); 'calibrated' is "
                         "ckpts/bench_tree_lumina.json")
    ap.add_argument("--tokens", type=int, default=None,
                    help="tokens a request (xl: 128; lumina: the grid's)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model to its first N layers")
    ap.add_argument("--grid", type=int, default=16,
                    help="lumina latent grid (16: 273 tokens)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    geo = GEOMS[args.geom]
    dev = resolve_device(args.device)
    tokens = args.tokens or geo["tokens"] or args.grid * (args.grid + 1) + 1
    rs = [int(r) for r in (args.rs or geo["rs"]).split(",")]
    names = [n for n in (args.trees or geo["trees"]).split(",") if n]
    t0 = time.perf_counter()

    def note(m):
        print(f"[sweep {args.geom} +{time.perf_counter() - t0:7.1f}s] {m}",
              file=sys.stderr, flush=True)

    with torch.no_grad():
        lane = Lane(args.geom, args.layers, args.grid, dev)
        note(f"{lane.cfg.num_layers} layers x {lane.cfg.hidden_size}, int8 "
             f"weights on {dev}; {tokens} tokens a request")
        rows = sweep(lane, rs, names, tokens, args.repeats, note)
    summary = summarize(rows)
    for p in summary:
        note(f"R={p['R']:>2} {p['config']:<22} median "
             f"{p['median_tok_s']:9.2f} tok/s (min {p['min_tok_s']:.2f}, "
             f"max {p['max_tok_s']:.2f}), C {p['compression']:.3f}")
    print(json.dumps(dict(
        summary=summary,
        winners={R: list(w) for R, w in pick_winners(rows).items()},
        within_spread=within_spread(rows),
        device=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
