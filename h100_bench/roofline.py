"""The yardstick's arithmetic: one H100's peaks, and the operations and
bytes of the port's kernels and of a model step, from the shapes the traced
run recorded.

Peaks (NVIDIA's H100 SXM data sheet, dense): 989 TFLOP/s in bfloat16 and
3.35 TB/s of HBM3.  A call's bound is the larger of its bytes over the
bandwidth and its operations over the peak, counting each input read once
and each output written once, whatever the kernel's launches re-read: the
work of the op call, whichever kernel serves it.
"""

from __future__ import annotations

from typing import Iterable

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S)


def k1_bytes(M: int, K: int, N: int, out_bytes: int = 2) -> int:
    """W8A16 matmul: bf16 activations [M, K], int8 weight [K, N] with f32
    scales [N], output [M, N]."""
    return M * K * 2 + K * N + N * 4 + M * N * out_bytes


def k1_flops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def k1_bound_s(M: int, K: int, N: int, out_bytes: int = 2) -> float:
    return bound_s(k1_bytes(M, K, N, out_bytes), k1_flops(M, K, N))


def k2_bytes(lengths: Iterable[int], T: int, nh: int, nkv: int, hd: int,
             G: int, W: int, int8: bool) -> int:
    """Tree attention of one layer: each batch row's K and V planes read
    once at its length (int8 lanes and an f32 scale a group row, or bf16),
    q, the block's new K and V, and the output in bf16."""
    lengths = list(lengths)
    B = len(lengths)
    row = G * (W + 4) if int8 else G * W * 2
    planes = 2 * sum(lengths) * row
    return planes + B * T * (2 * nh * hd * 2 + 2 * nkv * hd * 2)


def k2_flops(visible_keys: int, nh: int, hd: int) -> int:
    """QK^T and PV over ``visible_keys`` summed over every query row."""
    return 4 * nh * hd * visible_keys


def k2_bound_s(lengths, T, nh, nkv, hd, G, W, int8, visible_keys) -> float:
    return bound_s(k2_bytes(lengths, T, nh, nkv, hd, G, W, int8),
                   k2_flops(visible_keys, nh, hd))


def forward_k2(f: dict):
    """``(bound seconds, flops)`` of one forward's attention calls (one a
    layer) from a ``trace.Tracer`` record."""
    lengths = [int(x) for x in f["length"]]
    vis = int(f["keys"].sum()) + f["T"] * sum(lengths)
    b = k2_bound_s(lengths, f["T"], f["nh"], f["nkv"], f["hd"], f["G"],
                   f["W"], f["int8"], vis)
    return f["L"] * b, f["L"] * k2_flops(vis, f["nh"], f["hd"])


def step_flops(k1_calls, forwards) -> float:
    """The model's useful operations: every weight matmul (K1's calls) and
    every attention, with the rows of finished slots and of prompt pads
    left out (each call's share of useful rows)."""
    total = 0.0
    for M, K, N, _, fi, frac in k1_calls:
        share = 1.0 if frac is None else frac
        if fi >= 0:
            f = forwards[fi]
            share *= f["useful"] / (f["B"] * f["T"])
        total += k1_flops(M, K, N) * share
    for f in forwards:
        share = (1.0 if f["frac"] is None else f["frac"]) * (
            f["useful"] / (f["B"] * f["T"]))
        total += forward_k2(f)[1] * share
    return total
