"""Tree attention of a T-row block over the committed KV prefix plus itself.

Counterpart of ``lantern_tpu/ops/pallas/tree_attention.py:tree_attention``
(K2).  The function both versions compute is the JAX forward's DENSE-FUSED
attention (``lantern_tpu/models/transformer.py:427-559``), which produces
the reference numbers on every path the JAX tests run:

- scores ``(q . k) * scale`` with f32 accumulation over model-dtype
  operands; for an int8 cache ``(q . k_int8) * scale * k_scale`` — the
  cache is never dequantized;
- the in-flight block is quantized exactly as the cache write will store it
  (``kv.quantize_rows``), so a token sees the same keys during its own
  verification as every later step reads back;
- softmax weights are cast to the model dtype (times ``v_scale`` for an
  int8 cache) before the value contraction, and divided once by the f32 sum
  of the unrounded weights.

Masks: key ``j`` of batch row ``b``'s prefix is visible iff ``j <
length[b]`` (``length`` is one value for every row, or ``[B]``: the
batched engine's rows each sit at their own length; its additive bias row
then applies, 0 or ``NEG_INF`` for padding); block key ``u`` is
visible to row ``t`` iff ``block_mask[b, t, u]``.  An optional provisional
window (``window_mask`` [B or 1, T, window] bool) also shows cache rows
``[length, length + window)``: rows written past the committed prefix but
not committed (the earlier levels of a draft tree); row ``length + u`` is
visible to block row ``t`` iff ``window_mask[b, t, u]`` (and its bias
applies).  The JAX forward builds the same visibility as a dense
``prefix_override`` mask (``lantern_tpu/models/drafter.py:132``).  The
caller keeps ``length + window <= S``.  A row that sees no key at all (a
pad row of a left-padded prefix, in its own prefill) has every score at
the finite ``NEG_INF``, so both versions, as the JAX dense math, give it
the mean of the value rows of the whole cache plane ``[0, S)`` and of the
block.  Later reads mask such rows, but the LlamaGen drafter, which takes
no mask, reads their hidden states.

A 128-lane cache group holds one head of 128 (Chameleon) or two heads of
64 (LlamaGen, ``pk = 2``): each head then takes the scores of its own 64
lanes and its own softmax, and both share the group row's int8 scale.

``tree_attention`` dispatches by device: the hand-written kernel in
``csrc/tree_attention.cu`` on CUDA tensors, ``tree_attention_plain`` on CPU.
Neither bounds ``T`` or the window.  ``k2_rows``, ``k2_splits`` and
``k2_split_tiles`` are the kernel's grid arithmetic as plain functions.
"""

from __future__ import annotations

import torch

from . import _cuda
from ..kv import group_blocks, quantize_rows, row_starts

NEG_INF = -1e30
# K2's geometry on the card: keys per tile; the thread blocks an SM holds
# at once (230-255 registers a thread, 81-115 KB of shared memory a block);
# and the least capacity a split is worth (under four tiles the merge costs
# more than the split saves); the most splits the kernel's merge takes
# (``MAX_SPLIT`` in the source)
K2_TILE_KEYS = 64
K2_BLOCKS_PER_SM = 2
K2_SPLIT_MIN_ROWS = 256
K2_MAX_SPLIT = 32
# the batch rows K2 sizes its prefix splits for: one request's CFG pair.
# A batched verify forward (2R rows) splits each row's prefix as a lone
# request's forward does, so a row's sums, and the tokens they decide,
# never depend on how many requests share the launch (as K1's never
# depend on its row count)
K2_SPLIT_BATCH = 2


def k2_rows(T: int, pk: int = 1) -> int:
    """Query rows one K2 thread block owns: one or two 16-row mma tiles with
    one head a group; with two heads (``pk = 2``) always 16, whose two
    heads already take two tiles (and the registers of 32 rows of one)."""
    return 16 if T <= 16 or pk == 2 else 32


def k2_splits(B: int, G: int, S: int, T: int, sms: int, pk: int = 1) -> int:
    """Prefix splits of a K2 launch on a card of ``sms`` SMs, from the shapes
    alone (``length`` stays on the device): as many as keep the ``B * G * row tiles * splits``
    thread blocks within one wave of ``K2_BLOCKS_PER_SM`` an SM, at most one
    per ``K2_SPLIT_MIN_ROWS`` rows of the capacity ``S`` and
    ``K2_MAX_SPLIT``."""
    blocks = B * G * -(-T // k2_rows(T, pk))
    return max(1, min(K2_BLOCKS_PER_SM * sms // blocks,
                      S // K2_SPLIT_MIN_ROWS, K2_MAX_SPLIT))


def k2_split_tiles(length: int, nsplit: int) -> list:
    """``(first, end)`` prefix tile of every split at a live ``length``, as
    the kernel computes them: shares of the ``ceil(length / K2_TILE_KEYS)``
    tiles that differ by at most one (empty where there are fewer tiles
    than splits)."""
    ntiles = -(-length // K2_TILE_KEYS)
    return [(z * ntiles // nsplit, (z + 1) * ntiles // nsplit)
            for z in range(nsplit)]


def _window_of(window_mask, B: int, T: int):
    """``window_mask`` as a contiguous bool [B, T, window], or None when
    there is no window."""
    if window_mask is None or window_mask.shape[-1] == 0:
        return None
    if window_mask.ndim == 2:
        window_mask = window_mask[None]
    return window_mask.to(torch.bool).expand(
        B, T, window_mask.shape[-1]).contiguous()


def tree_attention_plain(q, k_new, v_new, k_cache, v_cache, length,
                         block_mask, prefix_bias, scale,
                         k_scale=None, v_scale=None, window_mask=None):
    """K2's plain version (the JAX dense-fused math, any head grouping).

    q/k_new/v_new [B, T, nh, hd]; caches [B, G, S, W] grouped; ``length``
    int32 [] or [B]; ``block_mask`` [B, T, T] bool; ``prefix_bias``
    [B, S] f32; ``window_mask`` [B or 1, T, window] bool or None.  Returns
    [B, T, nh, hd] in q's dtype."""
    B, T, nh, hd = q.shape
    _, Gd, S, W = k_cache.shape
    pk = W // hd
    dt = q.dtype
    quant = k_scale is not None
    k5 = k_cache.reshape(B, Gd, S, pk, hd)
    v5 = v_cache.reshape(B, Gd, S, pk, hd)
    qg = q.reshape(B, T, Gd, pk, hd).permute(0, 2, 3, 1, 4).float()
    if quant:
        kq_blk, ks_blk = quantize_rows(group_blocks(k_new))     # [B,G,T,W]
        vq_blk, vs_blk = quantize_rows(group_blocks(v_new))
        ku = kq_blk.to(dt).reshape(B, Gd, T, pk, hd).permute(0, 1, 3, 2, 4)
        vu = vq_blk.to(dt).reshape(B, Gd, T, pk, hd).permute(0, 1, 3, 2, 4)
        k5 = k5.to(dt)
    else:
        ku = k_new.reshape(B, T, Gd, pk, hd).permute(0, 2, 3, 1, 4)
        vu = v_new.reshape(B, T, Gd, pk, hd).permute(0, 2, 3, 1, 4)
    lens = row_starts(length, B, "tree_attention: length").reshape(-1, 1, 1)
    j = torch.arange(S, device=q.device)
    vis = j[None, None, :] < lens                                 # [B|1,1,S]
    wm = _window_of(window_mask, B, T)
    if wm is not None:
        rows = torch.clamp(lens + torch.arange(wm.shape[-1],
                                               device=q.device), max=S - 1)
        vis = vis.expand(B, T, S).clone().scatter_(
            2, rows.long().expand(B, T, wm.shape[-1]), wm)
    mp = torch.where(vis, prefix_bias.float()[:, None, :], NEG_INF)  # [B,T|1,S]
    if block_mask.ndim == 2:
        block_mask = block_mask[None]
    mb = torch.where(block_mask.bool(), 0.0, NEG_INF)        # [B or 1,T,T]

    s_pre = torch.einsum("bgptd,bgspd->bgpts", qg, k5.float()) * scale
    if quant:
        s_pre = s_pre * k_scale[:, :, None, None, :]
    s_pre = s_pre + mp[:, None, None]
    s_blk = torch.einsum("bgptd,bgpud->bgptu", qg, ku.float()) * scale
    if quant:
        s_blk = s_blk * ks_blk[:, :, None, None, :]
    s_blk = s_blk + mb[:, None, None]

    m = torch.maximum(s_pre.amax(-1), s_blk.amax(-1))[..., None]
    e_pre = torch.exp(s_pre - m)
    e_blk = torch.exp(s_blk - m)
    den = e_pre.sum(-1) + e_blk.sum(-1)                           # [B,G,pk,T]
    if quant:
        ep = (e_pre * v_scale[:, :, None, None, :]).to(dt)
        eb = (e_blk * vs_blk[:, :, None, None, :]).to(dt)
        vv = v5.to(dt)
    else:
        ep, eb, vv = e_pre.to(dt), e_blk.to(dt), v5
    o = torch.einsum("bgpts,bgspd->bgptd", ep.float(), vv.float())
    o = o + torch.einsum("bgptu,bgpud->bgptd", eb.float(), vu.float())
    o = o / torch.clamp(den, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, T, nh, hd).to(dt)


def tree_attention_cuda(q, k_new, v_new, k_cache, v_cache, length,
                        block_mask, prefix_bias, scale,
                        k_scale=None, v_scale=None, window_mask=None):
    """K2 on the card, one launch.  Thread blocks per (batch row, head
    group, row tile, prefix split) stream only the row's live prefix ``[0,
    length[b])`` through the tensor cores with an online softmax, the last
    split also the provisional window's cache rows and the block rows under
    their masks; the last split to finish merges all of them.  Needs W ==
    128 lanes a group holding one head of 128 or two of 64, MHA and bf16
    activations; any T, any window."""
    B, T, nh = q.shape[:3]
    _, G, S, _ = k_cache.shape
    return tree_attention_launch(
        q, k_new, v_new, k_cache, v_cache, length, block_mask, prefix_bias,
        scale, k2_splits(min(B, K2_SPLIT_BATCH), G, S, T,
                         _cuda.sm_count(q.device), nh // G),
        k_scale=k_scale, v_scale=v_scale, window_mask=window_mask)


def tree_attention_launch(q, k_new, v_new, k_cache, v_cache, length,
                          block_mask, prefix_bias, scale, nsplit,
                          k_scale=None, v_scale=None, window_mask=None):
    """``tree_attention_cuda`` at a given count of prefix splits (1 to
    ``K2_MAX_SPLIT``), which ``tree_attention_cuda`` takes from
    ``k2_splits``."""
    B, T, nh, hd = q.shape
    _, G, S, W = k_cache.shape
    quant = k_scale is not None
    pk = W // hd
    _cuda.require(W == 128 and hd in (64, 128) and nh == G * pk,
                  f"tree_attention: needs 128-lane groups of one head of 128 "
                  f"or two of 64, got nh={nh} hd={hd} cache G={G} W={W}")
    for t in (q, k_new, v_new):
        _cuda.require(t.dtype == torch.bfloat16 and t.shape == q.shape,
                      "tree_attention: q/k_new/v_new must be bf16 "
                      "[B, T, nh, hd]")
    want = torch.int8 if quant else torch.bfloat16
    for t in (k_cache, v_cache):
        _cuda.require(t.dtype == want and t.is_contiguous()
                      and t.shape == (B, G, S, W) and _cuda.aligned(t),
                      f"tree_attention: caches must be contiguous, 16-byte "
                      f"aligned {want} [B, G, S, W]")
    if quant:
        for t in (k_scale, v_scale):
            _cuda.require(t.dtype == torch.float32 and t.is_contiguous()
                          and t.shape == (B, G, S),
                          "tree_attention: scales must be f32 [B, G, S]")
    length = row_starts(length, B, "tree_attention: length")
    _cuda.require(length.dtype == torch.int32,
                  "tree_attention: length must be an int32 tensor")
    if block_mask.ndim == 2:
        block_mask = block_mask[None].expand(B, T, T)
    mask = block_mask.to(torch.bool).contiguous()
    wmask = _window_of(window_mask, B, T)
    bias = prefix_bias.to(torch.float32).expand(B, S).contiguous()
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    out = torch.empty_like(q)
    _cuda.require(1 <= nsplit <= K2_MAX_SPLIT, f"tree_attention: takes 1 to "
                  f"{K2_MAX_SPLIT} prefix splits, got {nsplit}")
    rows = k2_rows(T, pk)
    part = tickets = None
    if nsplit > 1:
        units = B * G * -(-T // rows)
        part = torch.empty((units * nsplit * rows * (128 + 2 * pk),),
                           dtype=torch.float32, device=q.device)
        tickets = _cuda.tickets(q.device, "tree_attention", units)
    _cuda.library().tree_attention(
        q, k_new, v_new, k_cache, v_cache, k_scale if quant else None,
        v_scale if quant else None, length.contiguous(), mask, wmask, bias,
        out, part, tickets, rows, nsplit, float(scale))
    _cuda.LAUNCHES["tree_attention"] += 1
    return out


def tree_attention(q, k_new, v_new, k_cache, v_cache, length, block_mask,
                   prefix_bias, scale, k_scale=None, v_scale=None,
                   window_mask=None):
    """Dispatch by device: K2 on CUDA tensors, the plain version on CPU."""
    fn = (tree_attention_cuda if _cuda.on_cuda(q, k_cache, length)
          else tree_attention_plain)
    return fn(q, k_new, v_new, k_cache, v_cache, length, block_mask,
              prefix_bias, scale, k_scale=k_scale, v_scale=v_scale,
              window_mask=window_mask)
