"""The yardstick's arithmetic against PERF.md's kernel table (bound =
max(bytes once / 3.35 TB/s, ops / 989 TFLOP/s)) and the model step's
operation count at both configurations."""

import json
from pathlib import Path

import pytest
import torch

from h100_bench import roofline

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def test_k1_bound_lumina_w_gu():
    # PERF.md §6: K1 Lumina w_gu M=64 K=4096 N=22016 -> bound 0.0279 ms
    ms = roofline.k1_bound_s(64, 4096, 22016) * 1e3
    assert round(ms, 4) == 0.0279
    # M=2: 0.0270 ms; lm_head M=2 f32 output: 0.0804
    assert round(roofline.k1_bound_s(2, 4096, 22016) * 1e3, 4) == 0.0270
    assert round(roofline.k1_bound_s(2, 4096, 65536, 4) * 1e3, 4) == 0.0804


def test_k2_bound_gqa_t1():
    # PERF.md §6: K2 GQA, B=2, 32 query heads over 8 KV heads of 128, int8,
    # T=1 at length 2371 -> bound 0.0030 ms (10.0 MB of planes + 41 KB)
    nbytes = roofline.k2_bytes([2371, 2371], 1, 32, 8, 128, 8, 128, True)
    assert nbytes == 2 * 2 * 8 * 2371 * 132 + 40960
    s = roofline.k2_bound_s([2371, 2371], 1, 32, 8, 128, 8, 128, True,
                            2 * 2372)
    assert round(s * 1e3, 4) == 0.0030
    # MHA at the same length reads 4x the planes: 0.0120
    s = roofline.k2_bound_s([2371, 2371], 1, 32, 32, 128, 32, 128, True,
                            2 * 2372)
    assert round(s * 1e3, 4) == 0.0120


def _matmuls(cfg):
    H, I, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = H // nh
    layer = [(H, (nh + 2 * nkv) * hd), (nh * hd, H), (H, 2 * I), (I, H)]
    return layer, (H, V)


@pytest.mark.parametrize("name,params", [
    ("lumina_mgpt_7b_768", 6_744_440_832),
    ("llamagen_xl_t2i_256", 752_353_280)])
def test_step_flops_at_published_sizes(name, params):
    """One forward of R rows through every layer and the head: 2 x rows x
    the matmul parameters, plus attention; rows of finished slots (a step
    share of 1/2) and pads are left out."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    layer, head = _matmuls(cfg)
    L = cfg["num_hidden_layers"]
    assert L * sum(k * n for k, n in layer) + head[0] * head[1] == params
    B, T, length = 4, 1, 300
    nh, H = cfg["num_attention_heads"], cfg["hidden_size"]
    fwd = dict(L=L, B=B, T=T, nh=nh, nkv=cfg["num_key_value_heads"],
               hd=H // nh, G=1, W=128, int8=True,
               length=torch.full((B,), length), keys=torch.ones((B, T)),
               useful=B * T, frac=None)
    calls = [(B * T, k, n, 2, 0, None) for _ in range(L) for k, n in layer]
    calls.append((B * T, head[0], head[1], 4, -1, None))
    attn = L * 4 * nh * (H // nh) * B * T * (length + 1)
    assert roofline.step_flops(calls, [fwd]) == 2 * B * T * params + attn
    # half the slots finished: half of every row's work is padding
    half = [c[:5] + (0.5,) for c in calls]
    assert roofline.step_flops(half, [dict(fwd, frac=0.5)]) == pytest.approx(
        B * T * params + attn / 2)
    # a prefill whose block holds 3 pad rows of 8
    pre = dict(fwd, B=1, T=8, useful=5, length=torch.zeros(1),
               keys=torch.arange(1, 9)[None])
    calls = [(8, k, n, 2, 0, None) for _ in range(L) for k, n in layer]
    want = 2 * 5 * (params - head[0] * head[1]) + (
        L * 4 * nh * (H // nh) * 36) * 5 / 8
    assert roofline.step_flops(calls, [pre]) == pytest.approx(want)
