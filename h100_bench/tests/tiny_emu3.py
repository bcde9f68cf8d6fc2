"""A CPU-size Emu3 for the tests: grouped-query attention 4:1 with heads
of 128, pre-norm, rope at theta 1e6, a vocabulary of 1,054 (14 modulo 16)
with its 256 visual ids at the top, a 4 x 4 grid (21 tokens an image); and
its cell in a tiny checkout (``tiny.make_root``), the deep driver's mix at
two slots."""

from __future__ import annotations

import json
from pathlib import Path

from h100_bench.tests import tiny

EMU3 = {
    "name": "tiny_emu3", "source": "a CPU-size Emu3 geometry",
    "family": "emu3", "vocab_size": 1054, "hidden_size": 512,
    "intermediate_size": 1024, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 1,
    "rms_norm_eps": 1e-05, "rope_theta": 1000000.0,
    "image": {"grid": [4, 4], "tokens": 21, "row_end": True,
              "image_token_ids": [798, 1053], "row_end_id": 780,
              "end_id": 781, "bos_id": 782, "start_id": 784,
              "size_ids": [40, 9, 40], "img_id": 783, "pad_id": 785},
    "vq": {"codes": 256, "latent_dim": 4}, "reduced": []}
TRAFFIC = dict(tiny.SAMPLING, driver="engine_window_deep", slots=2, queue=6,
               prompt_tokens=[3, 9], negative_tokens=6,
               text_id_range=[0, 780], depth_rows=[0, 2],
               tree="chain_bush_8", mode="static", stale_draft=True,
               warm_steps=1, check={"requests": 6})
CELL = "tiny.emu3"
# readings of the tiny cell over 6 seeds (program: top1_gap 0-0.055,
# logit_err 0.034-0.051, support_rank 53-64 at top_k 64, walk_flips 0-1.0
# %; the int4 control: top1_gap 1.45-2.51, logit_err 1.26-2.08; the
# altered token: support_rank 242-255; accepting every draft: walk_flips
# 6.8-14.8 %)
LIMITS = {"limits": {"top1_gap": 0.5, "logit_err": 0.3,
                     "support_rank": 150, "walk_flips": 4.0, "grammar": 0,
                     "failed": 0},
          "floors": {"rows": 10, "walk_coins": 10}}


def make_root(tmp: Path, limits=None) -> Path:
    """The tiny checkout with the Emu3 cell added as files and entries:
    its configuration, mix and limits, and the cell appended to every
    per-layer metric that lists the benchmark's Emu3 cell."""
    root = tiny.make_root(tmp)
    b = root / "h100_bench"
    (b / "configs" / f"{EMU3['name']}.json").write_text(json.dumps(EMU3))
    (b / "traffic" / "tiny_deep.json").write_text(json.dumps(TRAFFIC))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(limits or LIMITS))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(
        name=EMU3["name"], source=EMU3["source"],
        file=f"h100_bench/configs/{EMU3['name']}.json", reduced=[],
        why="CPU size"))
    man["workloads"].append(dict(name=CELL, config=EMU3["name"],
                                 traffic="tiny_deep", chips=1,
                                 why="CPU size"))
    real = json.loads((tiny.BENCH.parent / "BENCHMARK.json").read_text())
    lists = {m["name"]: m["workloads"] for m in real["per_layer"]}
    for m in man["per_layer"]:
        if "emu3_720.spec8.deep" in lists[m["name"]]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
