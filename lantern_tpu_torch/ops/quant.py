"""Weight-only int8 (W8A16) quantization and the dequant-matmul kernel K1.

Counterpart of ``lantern_tpu/ops/quant.py``.  Layout convention is the
same: a quantized kernel replaces params entry ``name`` with ``name + "_q"``
(int8, same shape) and ``name + "_s"`` (f32 per-output-channel scale).

``mm`` and ``head_matmul`` route every quantized product through
``w8a16_matmul``: on CUDA tensors that launches the hand-written kernel in
``csrc/int8_matmul.cu`` (replacing ``int8_matmul_pallas``,
``lantern_tpu/ops/quant.py:73``); on CPU tensors it runs ``int8_matmul``,
the plain PyTorch version.

Under a tensor-parallel mesh (``parallel/mesh.py``) the two Megatron
collectives live here: ``mm_row`` all-reduces a row-split kernel's f32
partial products over tp and rounds them to the activation dtype once, and
``head_matmul`` all-gathers a vocab-split head's logits (``head_of`` marks
such a head as a ``VocabShard``).  Without a mesh, or at ``tp == 1``,
neither runs.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist

from . import _cuda
from ..kv import _127
from ..parallel.mesh import tp_group

LAYER_KERNELS = ("wqkv", "w_gu", "wq", "wk", "wv", "wo",
                 "w_gate", "w_up", "w_down")

# rows per K1 launch: the widest its tensor-core instruction takes on the
# activation side (wgmma n64)
K1_MAX_ROWS = 64
# K1's geometry on the card: output columns a thread block owns, k rows of
# a shared-memory stage, the thread blocks a launch should give every SM,
# and the fewest k rows worth a split of their own (its f32 partials, up to
# 64 rows of them, then stay under a quarter of the weight bytes it streams)
K1_TILE_COLS = 128
K1_STAGE_ROWS = 64
K1_BLOCKS_PER_SM = 2
K1_SPLIT_MIN_ROWS = 1024


def k1_splits(K: int, N: int, sms: int) -> int:
    """Split-K count of a K1 launch on a card of ``sms`` SMs, from ``(K, N)``
    alone (never from the row count: a row's sums must not depend on it):
    the fewest splits that give the grid ``K1_BLOCKS_PER_SM`` blocks an SM,
    at most one per ``K1_SPLIT_MIN_ROWS`` rows of the k range."""
    tiles = -(-N // K1_TILE_COLS)
    return max(1, min(K // K1_SPLIT_MIN_ROWS,
                      -(-K1_BLOCKS_PER_SM * sms // tiles)))


def k1_split_stages(K: int, nsplit: int) -> list:
    """``(first, end)`` stage of every split, as the kernel computes them:
    shares of the stages that differ by at most one."""
    stages = -(-K // K1_STAGE_ROWS)
    return [(z * stages // nsplit, (z + 1) * stages // nsplit)
            for z in range(nsplit)]


def quantize_weight(w: torch.Tensor, axis: int = -2):
    """Symmetric per-output-channel int8 quantization over the contraction
    ``axis``.  Returns ``(q int8, s f32)`` with ``q * s ~= w`` and ``s``
    shaped like ``w`` with ``axis`` collapsed to 1."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / _127(amax)
    q = torch.clamp(torch.round(wf / s), -127, 127).to(torch.int8)
    return q, s


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype=None) -> torch.Tensor:
    """Plain dequant-matmul ``(x @ q) * s`` with f32 accumulation (the K1
    kernel's plain version).  bf16 activations times int8 weights are exact
    in f32, so only the summation order can differ from the kernel."""
    y = torch.matmul(x.float(), q.float())
    return (y * s).to(out_dtype or x.dtype)


def int8_matmul_cuda(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                     out_dtype=None) -> torch.Tensor:
    """K1 on the card: ``x [..., K]`` bf16, ``q [K, N]`` int8, ``s`` [1, N]
    f32 -> ``[..., N]`` bf16 (or f32).  Rows go in launches of at most
    ``K1_MAX_ROWS``; a row's result does not depend on the row count.  Thin
    shapes split the k range over ``k1_splits(K, N, sms)`` thread blocks,
    whose f32 partials the last block to finish adds in split order."""
    return int8_matmul_launch(
        x, q, s, k1_splits(x.shape[-1], q.shape[-1], _cuda.sm_count(x.device)),
        out_dtype)


def int8_matmul_launch(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                       nsplit: int, out_dtype=None) -> torch.Tensor:
    """``int8_matmul_cuda`` at a given split-K count, which
    ``int8_matmul_cuda`` takes from ``k1_splits``."""
    _cuda.no_autograd("int8_matmul", x, q, s)
    out_dtype = out_dtype or x.dtype
    *lead, K = x.shape
    N = q.shape[-1]
    _cuda.require(x.dtype == torch.bfloat16, f"int8_matmul: x must be "
                  f"bfloat16 on CUDA, got {x.dtype}")
    _cuda.require(q.dtype == torch.int8 and q.shape == (K, N),
                  f"int8_matmul: q must be int8 [{K}, N], got {q.dtype} "
                  f"{tuple(q.shape)}")
    _cuda.require(s.dtype == torch.float32 and s.numel() == N,
                  "int8_matmul: s must be f32 with N elements")
    _cuda.require(out_dtype in (torch.bfloat16, torch.float32),
                  f"int8_matmul: out dtype {out_dtype} unsupported")
    _cuda.require(1 <= nsplit <= max(1, K // K1_STAGE_ROWS),
                  f"int8_matmul: {nsplit} splits of K={K}: needs 1 to one "
                  f"per {K1_STAGE_ROWS} k rows")
    _cuda.require(K % 8 == 0 and N % 16 == 0,
                  f"int8_matmul: needs K % 8 == 0 and N % 16 == 0, got "
                  f"K={K} N={N}")
    x2 = x.reshape(-1, K).contiguous()
    q = q.contiguous()
    s = s.contiguous()
    _cuda.require(_cuda.aligned(x2) and _cuda.aligned(q),
                  "int8_matmul: x and q must be 16-byte aligned")
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    ext = _cuda.library()
    part = tickets = None
    if nsplit > 1:
        part = torch.empty((nsplit, min(M, K1_MAX_ROWS), N),
                           dtype=torch.float32, device=x.device)
        tickets = _cuda.tickets(x.device, "int8_matmul",
                                -(-N // K1_TILE_COLS))
    for m0 in range(0, M, K1_MAX_ROWS):
        rows = slice(m0, m0 + K1_MAX_ROWS)
        ext.int8_matmul(x2[rows], q, s, out[rows], part, tickets, nsplit)
        _cuda.LAUNCHES["int8_matmul"] += 1
    return out.reshape(*lead, N)


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                 out_dtype=None) -> torch.Tensor:
    """Dispatch by device: K1 on CUDA tensors, ``int8_matmul`` on CPU."""
    if _cuda.on_cuda(x, q, s):
        return int8_matmul_cuda(x, q, s, out_dtype)
    return int8_matmul(x, q, s, out_dtype)


def mm(x: torch.Tensor, w: dict, name: str, out_dtype=None) -> torch.Tensor:
    """Matmul against ``w[name]``, using the quantized entries if present;
    ``out_dtype`` f32 gives the product unrounded."""
    if name in w:
        if out_dtype is None:
            return x @ w[name]
        return (x.to(out_dtype) @ w[name].to(out_dtype))
    return w8a16_matmul(x, w[name + "_q"], w[name + "_s"], out_dtype)


def mm_row(x: torch.Tensor, w: dict, name: str, group) -> torch.Tensor:
    """``x @ w[name]`` for a kernel whose rows (the contraction) are split
    over ``group``: each rank's f32 partial product, summed over the group
    in f32 and rounded to ``x``'s dtype once, so the result is one f32
    summation order away from one process's.  ``group`` None: ``mm``."""
    if group is None:
        return mm(x, w, name)
    part = mm(x, w, name, torch.float32)
    tdist.all_reduce(part, group=group)
    return part.to(x.dtype)


def has_kernel(w: dict, name: str) -> bool:
    return name in w or name + "_q" in w


class VocabShard:
    """This tp rank's ``[H, V / tp]`` columns of a vocab-split lm_head
    (dense or an ``(int8, scale)`` pair) and the group holding the rest."""

    def __init__(self, head, group):
        self.head, self.group = head, group


def head_of(params: dict):
    """The lm_head as a dense [H, V] tensor or an ``(int8, scale)`` pair;
    under a tp mesh, where it holds fewer columns than the embedding has
    rows, a ``VocabShard`` of it."""
    head = (params["lm_head"] if "lm_head" in params
            else (params["lm_head_q"], params["lm_head_s"]))
    group = tp_group()
    if group is not None and "embed" in params:
        cols = (head[0] if isinstance(head, tuple) else head).shape[-1]
        if cols != params["embed"].shape[0]:
            return VocabShard(head, group)
    return head


def tp_all_gather(local: torch.Tensor, group) -> torch.Tensor:
    """The tp ranks' ``[.., n]`` pieces side by side in rank order:
    ``[.., n * tp]``.  NCCL, and gloo on host tensors, run ``all_gather``;
    gloo has no all-gather of CUDA tensors, so there ``gather_by_reduce``
    stands in."""
    if local.is_cuda and tdist.get_backend(group) == "gloo":
        return gather_by_reduce(local, group)
    pieces = [torch.empty_like(local)
              for _ in range(tdist.get_world_size(group))]
    tdist.all_gather(pieces, local.contiguous(), group=group)
    return torch.cat(pieces, dim=-1)


def gather_by_reduce(local: torch.Tensor, group) -> torch.Tensor:
    """``tp_all_gather`` by an all-reduce: each rank writes its piece into
    a zero-filled ``[.., n * tp]`` buffer and the buffers are summed (exact:
    every element is one rank's value plus zeros)."""
    n, r = local.shape[-1], tdist.get_rank(group)
    full = local.new_zeros(local.shape[:-1]
                           + (n * tdist.get_world_size(group),))
    full[..., r * n:(r + 1) * n] = local
    tdist.all_reduce(full, group=group)
    return full


def head_matmul(hidden: torch.Tensor, head) -> torch.Tensor:
    """f32 logits from a ``head_of`` value (all vocab columns: a
    ``VocabShard``'s are gathered over tp)."""
    if isinstance(head, VocabShard):
        return tp_all_gather(head_matmul(hidden, head.head), head.group)
    if isinstance(head, tuple):
        return w8a16_matmul(hidden, head[0], head[1], out_dtype=torch.float32)
    return (hidden @ head).float()


def _quantize_stacked(w: torch.Tensor):
    """quantize_weight over a [L, K, N] stack one layer at a time (bounds
    the f32 temporaries at 7B scale; the result is identical)."""
    if w.ndim != 3:
        return quantize_weight(w)
    qs, ss = zip(*(quantize_weight(w[i]) for i in range(w.shape[0])))
    return torch.stack(qs), torch.stack(ss)


def quantize_params(params: dict) -> dict:
    """Quantize the decoder's matmul kernels, the lm_head and a drafter's
    input-fusion projection ``fc_w``; embeddings, norms and biases keep
    their dtype.  Either layer layout."""
    p = dict(params)
    layers = dict(p["layers"])
    for name in LAYER_KERNELS:
        if name in layers:
            q, s = _quantize_stacked(layers.pop(name))
            layers[name + "_q"] = q
            layers[name + "_s"] = s
    p["layers"] = layers
    if "fc_w" in p:
        p["fc_w_q"], p["fc_w_s"] = quantize_weight(p.pop("fc_w"))
    if "lm_head" in p:
        p["lm_head_q"], p["lm_head_s"] = quantize_weight(p.pop("lm_head"))
    return p
