"""A checkout of the benchmark at CPU size for its own tests: the
benchmark's files copied under a temporary root, with tiny configurations,
traffic mixes, limits and cells added as files and entries of their own,
as a later change adds a cell."""

from __future__ import annotations

import argparse
import io
import json
import shutil
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parents[1]

CHAMELEON = {
    "name": "tiny_chameleon", "source": "a CPU-size Chameleon geometry",
    "family": "chameleon", "vocab_size": 9000, "hidden_size": 256,
    "intermediate_size": 512, "num_hidden_layers": 2,
    "num_attention_heads": 2, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0, "qk_layernorm": True,
    "swin_norm": True,
    "image": {"grid": [4, 4], "tokens": 21, "row_end": True,
              "image_token_ids": [4, 8195], "start_id": 8197,
              "row_end_id": 8803, "end_id": 8196, "grid_token_base": 8804,
              "latents_per_patch": 2},
    "vq": {"codes": 8192, "latent_dim": 8}, "reduced": []}
LLAMAGEN = {
    "name": "tiny_llamagen", "source": "a CPU-size LlamaGen t2i geometry",
    "family": "llamagen", "vocab_size": 512, "hidden_size": 128,
    "intermediate_size": 256, "num_hidden_layers": 2,
    "num_attention_heads": 2, "num_key_value_heads": 2,
    "rms_norm_eps": 1e-05, "rope_theta": 10000.0,
    "caption": {"rows": 8, "dim": 32},
    "image": {"grid": [4, 4], "tokens": 16, "row_end": False,
              "image_token_ids": [0, 511]},
    "vq": {"codes": 512, "latent_dim": 8}, "reduced": []}
SAMPLING = {"temperature": 1.0, "top_k": 64, "cfg_scale": 3.0,
            "lantern_k": 4, "lantern_delta": 5.0, "nearest_k": 5,
            "tree_room": 40, "kv_quant": True}
TRAFFIC = {
    "tiny_spec": dict(SAMPLING, driver="engine_window", slots=2, queue=6,
                      prompt_tokens=[3, 6], text_id_range=[8900, 9000],
                      tree="chain_bush_8", mode="static", stale_draft=True,
                      warm_steps=1, check={"requests": 2}),
    "tiny_calls_spec": dict(SAMPLING, driver="session_calls", slots=2,
                            captions_per_call=3, caption_words=[2, 5],
                            word_letters=[3, 6], mode="static",
                            tree="chain", warm_tokens=4,
                            check={"requests": 2}),
    "tiny_calls_ar": dict(SAMPLING, driver="session_calls", slots=2,
                          captions_per_call=3, caption_words=[2, 5],
                          word_letters=[3, 6], mode="ar", tree="chain",
                          warm_tokens=4, check={"requests": 2}),
}
CELLS = {"tiny.lumina": ("tiny_chameleon", "tiny_spec"),
         "tiny.xl_spec": ("tiny_llamagen", "tiny_calls_spec"),
         "tiny.xl_ar": ("tiny_llamagen", "tiny_calls_ar")}
# the tiny cells that stand in for each of the benchmark's cells (the
# session path's speculative mix, ``tiny_calls_spec``, with the spec cell)
STANDS_FOR = {"lumina768.spec8": ["tiny.lumina", "tiny.xl_spec"],
              "xl_t2i.ar16": ["tiny.xl_ar"]}
SPEC = ("tiny.lumina", "tiny.xl_spec")
LOOSE = {"limits": {"top1_gap": 1e9, "logit_err": 1e9,
                    "support_rank": 1e9, "walk_flips": 100.0, "grammar": 0,
                    "failed": 0},
         "floors": {"rows": 1}}


def make_root(tmp: Path, limits=None) -> Path:
    """A checkout under ``tmp`` holding the benchmark and the tiny cells
    (``limits``: a cell's limits file, by default ``LOOSE``)."""
    root = Path(tmp)
    shutil.copytree(BENCH, root / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = root / BENCH.name
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    for c in (CHAMELEON, LLAMAGEN):
        (b / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    for n, t in TRAFFIC.items():
        (b / "traffic" / f"{n}.json").write_text(json.dumps(t))
    man["configs"] = [dict(name=c["name"], source=c["source"],
                           file=f"{BENCH.name}/configs/{c['name']}.json",
                           reduced=[], why="CPU size")
                      for c in (CHAMELEON, LLAMAGEN)]
    man["workloads"] = [dict(name=k, config=c, traffic=t, chips=1,
                             why="CPU size") for k, (c, t) in CELLS.items()]
    for m in man["end_to_end"]:
        m.pop("workloads", None)
    for m in man["per_layer"]:
        m["workloads"] = [t for w in m["workloads"] for t in STANDS_FOR[w]]
    for k in CELLS:
        lim = json.loads(json.dumps(limits or LOOSE))
        if k not in SPEC:
            lim["limits"].pop("walk_flips", None)
            lim["floors"].pop("walk_coins", None)
        (b / "limits" / f"{k}.json").write_text(json.dumps(lim))
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run_cell(root: Path, cell: str, seed: int = 2 ** 31 + 7,
             seconds: float = 1.0, trace: int = 0):
    """One run of ``cell`` on the CPU: ``(exit code, result dict)``."""
    from h100_bench import run

    out = io.StringIO()
    torch.set_num_threads(2)
    rc = run.execute(argparse.Namespace(workload=cell, seed=seed,
                                        seconds=seconds, trace=trace),
                     torch.device("cpu"), root=root, out=out)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None)
