"""Static-shape KV cache with the grouped ``[L, B, G, S, W]`` layout.

Counterpart of ``lantern_tpu/kv.py``.  The layout, the S padding to a
multiple of 128 and the int8 granularity (one f32 scale per 128-lane group
row) are the JAX package's, so the tests can hold the two caches against
each other byte for byte.  ``length`` is an int32 tensor on the cache's
device, so the decode loops never read it back to the host: a scalar (one
prefix for every batch row), or ``[B]``, one prefix per batch row, as in
the batched engine, whose cache folds R requests' CFG pairs into the batch
axis (``B = 2R``).  The JAX engine keeps one cache per request slot and
stacks them slot-major under ``vmap``; here every layer's planes stay one
contiguous ``[B, G, S, W]`` tensor, which the attention kernel reads.

``KVCache.write`` goes through ``write_block``: on CUDA tensors one launch
of the hand-written kernel in ``csrc/kv_write.cu`` (replacing
``write_block``, ``lantern_tpu/ops/pallas/kv_update.py:170``) quantizes the
new rows and writes the K/V planes and the scale planes for every layer;
on CPU tensors ``write_block_plain`` does the same with plain PyTorch.
``KVCache.accept_path`` (the tree rollback) goes through
``gather_write_block`` in the same way: ``csrc/kv_gather.cu`` (replacing
``gather_write_block``, ``lantern_tpu/ops/pallas/kv_update.py:313``) on
CUDA tensors, ``gather_write_block_plain`` on CPU tensors.
Unlike the JAX cache, ``write`` and ``accept_path`` update the buffers in
place (the engines never read a cache after writing past it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .configs import ModelConfig
from .ops import _cuda

GRP = 128   # lane-group width


def group_dims(n_kv: int, head_dim: int) -> tuple[int, int]:
    """(G, W): number of head groups and group width."""
    if GRP % head_dim == 0 and (n_kv * head_dim) % GRP == 0:
        return n_kv * head_dim // GRP, GRP
    return n_kv, head_dim


def group_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """[..., T, n_kv, hd] new-block K/V -> grouped [..., G, T, W] (a view)."""
    *lead, T, nkv, hd = blocks.shape
    G, W = group_dims(nkv, hd)
    return blocks.reshape(*lead, T, G, W).movedim(-2, -3)


def ungroup_blocks(grouped: torch.Tensor) -> torch.Tensor:
    """[..., G, T, W] -> [..., T, G*W]."""
    x = grouped.movedim(-3, -2)
    return x.reshape(*x.shape[:-2], -1)


def _127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor on ``like``'s device.  Dividing by it is a true f32
    division on every device; dividing a CUDA tensor by the Python float
    127.0 multiplies by its rounded reciprocal instead, which moves some
    scales by one ulp and flips the rounding of values near .5."""
    return torch.full((), 127.0, dtype=torch.float32, device=like.device)


def quantize_rows(grouped: torch.Tensor):
    """Symmetric int8 quantization, one scale per ``[..., T]`` row of W
    lanes: ``(q int8 [..., T, W], scale f32 [..., T])``."""
    xf = grouped.float()
    amax = xf.abs().amax(dim=-1)
    s = torch.where(amax > 0, amax, torch.ones_like(amax)) / _127(amax)
    q = torch.clamp(torch.round(xf / s[..., None]), -127, 127).to(torch.int8)
    return q, s


def fake_quant_rows(grouped: torch.Tensor) -> torch.Tensor:
    """quantize -> dequantize in the storage granularity (same dtype out)."""
    q, s = quantize_rows(grouped)
    return (q.float() * s[..., None]).to(grouped.dtype)


def _rows(buf: torch.Tensor) -> torch.Tensor:
    """A plane ``[L, B, G, S, W]`` (or a scale plane ``[L, B, G, S]``) as a
    ``[B, S, L, G, (W)]`` view: indexing it with ``(b [B, 1], s [B, n])``
    takes or puts ``n`` rows of every batch row at that row's own
    positions."""
    return buf.movedim((1, 3), (0, 1))


def row_starts(start: torch.Tensor, B: int, what: str) -> torch.Tensor:
    """A per-batch-row index argument: ``[]`` (one value for every row) or
    ``[B]`` (``length``, ``start``), flattened to ``[1]`` or ``[B]``."""
    flat = start.reshape(-1)
    _cuda.require(start.ndim <= 1 and flat.shape[0] in (1, B),
                  f"{what} must be [] or [{B}] (one per batch row), got "
                  f"{tuple(start.shape)}")
    return flat


def write_block_plain(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """K3's plain version.  ``k_new``/``v_new`` [L, B, T, n_kv, hd] land at
    rows ``[start[b], start[b]+T)`` of batch row ``b`` of the ``[L, B, G,
    S, W]`` planes, quantized per group row when the cache is int8 (scales
    into ``k_scale``/``v_scale`` [L, B, G, S]).  ``start`` is ``[]`` or
    ``[B]``, each clamped to ``[0, S-T]`` like ``lax.dynamic_update_slice``.
    In place; no host sync."""
    B, S = k_buf.shape[1], k_buf.shape[3]
    T = k_new.shape[2]
    dev = k_buf.device
    s0 = torch.clamp(row_starts(start, B, "kv_write: start").long(), 0, S - T)
    at = (torch.arange(B, device=dev)[:, None],
          s0[:, None] + torch.arange(T, device=dev))              # [B, T]
    kg, vg = group_blocks(k_new), group_blocks(v_new)
    if k_scale is not None:
        kg, ks = quantize_rows(kg)
        vg, vs = quantize_rows(vg)
        _rows(k_scale)[at] = _rows(ks)
        _rows(v_scale)[at] = _rows(vs)
    _rows(k_buf)[at] = _rows(kg.to(k_buf.dtype))
    _rows(v_buf)[at] = _rows(vg.to(v_buf.dtype))


def write_block_cuda(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """K3 on the card: one launch writes (and, for an int8 cache,
    quantizes) the new rows of every layer into both planes and both scale
    planes, batch row ``b`` at its own ``start[b]``.  A half-warp takes one
    ``(l, b, t, g)`` row of K and of V, in rounds of several rows whose
    loads are all issued first, over a grid of one wave; the quotients go
    through the division sequence K2 shares, so the bytes equal
    ``quantize_rows``'.  ``start`` stays on the device."""
    L, B, G, S, W = k_buf.shape
    T = k_new.shape[2]
    quantized = k_scale is not None
    _cuda.require(W == GRP, f"kv_write: group width must be {GRP}, got {W}")
    for t in (k_new, v_new):
        _cuda.require(t.dtype == torch.bfloat16 and t.is_contiguous()
                      and t.shape[:3] == (L, B, T)
                      and t.shape[3] * t.shape[4] == G * W,
                      f"kv_write: new rows must be contiguous bf16 "
                      f"[{L}, {B}, T, n_kv, hd], got {t.dtype} "
                      f"{tuple(t.shape)}")
    want = torch.int8 if quantized else torch.bfloat16
    for t in (k_buf, v_buf):
        _cuda.require(t.dtype == want and t.is_contiguous(),
                      f"kv_write: planes must be contiguous {want}")
    if quantized:
        for t in (k_scale, v_scale):
            _cuda.require(t.dtype == torch.float32 and t.is_contiguous()
                          and t.shape == (L, B, G, S),
                          "kv_write: scale planes must be f32 [L, B, G, S]")
    starts = row_starts(start, B, "kv_write: start")
    _cuda.require(starts.dtype == torch.int32,
                  "kv_write: start must be an int32 tensor")
    _cuda.require(T <= S, f"kv_write: block of {T} rows exceeds S={S}")
    _cuda.library().kv_write(k_new, v_new, k_buf, v_buf,
                             k_scale if quantized else None,
                             v_scale if quantized else None,
                             starts.contiguous())
    _cuda.LAUNCHES["kv_write"] += 1


def write_block(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """Dispatch by device: K3 on CUDA tensors, the plain version on CPU."""
    if _cuda.on_cuda(k_buf, v_buf, k_new, v_new, start):
        write_block_cuda(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start)
    else:
        write_block_plain(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start)


def _starts_rels(start, rel, B: int, blk: int, S: int):
    """K4's index arguments, checked as far as the host can see them:
    ``start`` [] or [B] -> [1] or [B]; ``rel`` [A] or [B, A]."""
    _cuda.require(1 <= blk <= S, f"kv_gather: blk={blk} outside [1, S={S}]")
    starts = row_starts(start, B, "kv_gather: start")
    _cuda.require(rel.ndim == 1 or (rel.ndim == 2 and rel.shape[0] == B),
                  f"kv_gather: rel must be [A] or [{B}, A], got "
                  f"{tuple(rel.shape)}")
    A = rel.shape[-1]
    _cuda.require(1 <= A <= blk, f"kv_gather: {A} rows > blk={blk}")
    return starts, rel


def gather_write_block_plain(k_buf, v_buf, k_scale, v_scale, rel, start,
                             blk: int):
    """K4's plain version: the tree-rollback compaction
    ``buf[..., b, :, start[b] + j, :] = buf[..., b, :, start[b] + rel[b, j],
    :]`` for ``j < A`` on the ``[L, B, G, S, W]`` planes, and the same rows
    of the ``[L, B, G, S]`` scale planes of an int8 cache.  Every source row
    is read before any row is written.  ``start`` [] or [B], ``rel`` [A] or
    [B, A]: one value (one path) for every batch row, or one each.  ``rel``
    is clamped to ``[0, blk-1]`` and ``start`` to ``[0, S-blk]``, once, for
    rows and scales alike.  In place; no host sync."""
    B, S = k_buf.shape[1], k_buf.shape[3]
    starts, rel = _starts_rels(start, rel, B, blk, S)
    dev = k_buf.device
    A = rel.shape[-1]
    s0 = torch.clamp(starts.long(), 0, S - blk)[:, None]
    b = torch.arange(B, device=dev)[:, None]
    src = (b, s0 + torch.clamp(rel.long(), 0, blk - 1).reshape(-1, A))
    dst = (b, s0 + torch.arange(A, device=dev))
    for buf in (k_buf, v_buf, k_scale, v_scale):
        if buf is not None:
            view = _rows(buf)
            view[dst] = view[src]


# K4 keeps a window's rows in registers when they fit: RC 16-byte chunks a
# lane a tensor, one of these (the kernel's instantiations), for A <= 32
K4_REG_CHUNKS = (1, 2, 4, 8)
# else each warp stages one tensor's rows and scales in its own slice of
# shared memory, which must fit one block's (Hopper's 227 KB opt-in)
K4_MAX_STAGE_BYTES = 227 * 1024


def k4_staging(A: int, row_bytes: int) -> int:
    """K4's staging for ``A`` rows of ``row_bytes``: the 16-byte chunks a
    lane holds in registers per tensor, or 0 for the shared-memory path."""
    if A <= 32:
        need = -(-A * (row_bytes // 16) // 32)
        for rc in K4_REG_CHUNKS:
            if need <= rc:
                return rc
    return 0


def gather_write_block_cuda(k_buf, v_buf, k_scale, v_scale, rel, start,
                            blk: int):
    """K4 on the card: one launch compacts the accepted rows of every
    layer plane, K and V, and (int8 cache) both scale planes.  One warp
    owns one ``(plane, batch row, group)`` window: it loads the ``A``
    source rows and scales of its batch row's path (into registers, or its
    slice of shared memory for a large ``A``: ``k4_staging``), waits at a
    warp barrier, then stores them, so overlapping sources and destinations
    read the original rows.  ``start`` and ``rel`` stay on the device; the
    kernel clamps ``rel`` to ``[0, blk-1]`` and ``start`` to ``[0, S-blk]``
    exactly as the plain version does, so a ``start`` outside the contract
    (``start + blk <= S``) moves rows of the last window and never touches
    memory outside the planes."""
    L, B, G, S, W = k_buf.shape
    quantized = k_scale is not None
    row_bytes = W * k_buf.element_size()
    for t in (k_buf, v_buf):
        _cuda.require(t.dtype == k_buf.dtype and t.shape == k_buf.shape
                      and t.is_contiguous() and _cuda.aligned(t),
                      "kv_gather: K and V planes must be contiguous, "
                      "16-byte aligned and alike")
    _cuda.require(k_buf.dtype in (torch.int8, torch.bfloat16, torch.float32)
                  and row_bytes % 16 == 0,
                  f"kv_gather: planes must be int8, bf16 or f32 with rows of "
                  f"a multiple of 16 bytes, got {k_buf.dtype} W={W}")
    _cuda.require(quantized == (k_buf.dtype == torch.int8)
                  and (v_scale is not None) == quantized,
                  "kv_gather: scale planes go with int8 planes, and only "
                  "with them")
    if quantized:
        for t in (k_scale, v_scale):
            _cuda.require(t.dtype == torch.float32 and t.is_contiguous()
                          and t.shape == (L, B, G, S),
                          "kv_gather: scale planes must be f32 [L, B, G, S]")
    for t in (rel, start):
        _cuda.require(t.dtype in (torch.int32, torch.int64),
                      "kv_gather: start and rel must be integer tensors")
    starts, rel = _starts_rels(start, rel, B, blk, S)
    A = rel.shape[-1]
    staging = k4_staging(A, row_bytes)
    _cuda.require(staging > 0 or A * (row_bytes + 4) <= K4_MAX_STAGE_BYTES,
                  f"kv_gather: {A} rows of {row_bytes} bytes exceed the "
                  f"{K4_MAX_STAGE_BYTES // 1024} KB staging slice")
    _cuda.library().kv_gather(k_buf, v_buf, k_scale if quantized else None,
                              v_scale if quantized else None,
                              starts.to(torch.int32).contiguous(),
                              rel.to(torch.int32).contiguous(), blk, staging)
    _cuda.LAUNCHES["kv_gather"] += 1


def gather_write_block(k_buf, v_buf, k_scale, v_scale, rel, start, blk: int):
    """Dispatch by device: K4 on CUDA tensors, the plain version on CPU."""
    fn = (gather_write_block_cuda
          if _cuda.on_cuda(k_buf, v_buf, k_scale, v_scale, rel, start)
          else gather_write_block_plain)
    fn(k_buf, v_buf, k_scale, v_scale, rel, start, blk)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, G, S, W]  (model dtype, or int8)
    v: torch.Tensor
    length: torch.Tensor   # int32 [] or [B]: valid prefix length(s)
    k_scale: Optional[torch.Tensor] = None   # [L, B, G, S] f32 (int8 only)
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    @property
    def group_width(self) -> int:
        return self.k.shape[4]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(cfg: ModelConfig, batch: int, max_len: Optional[int] = None,
               dtype=None, quantized: bool = False, device=None,
               row_lengths: bool = False) -> "KVCache":
        """Zeroed planes for ``batch`` rows; ``row_lengths`` gives every row
        a length of its own (``[batch]``), else one scalar length."""
        from .device import resolve_device

        dev = resolve_device(device)
        S = max_len or cfg.max_seq_len
        S = -(-S // 128) * 128
        dt = torch.int8 if quantized else (dtype or cfg.torch_dtype)
        G, W = group_dims(cfg.num_kv_heads, cfg.head_dim)
        shape = (cfg.num_layers, batch, G, S, W)

        def scales():
            return (torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                    if quantized else None)

        return KVCache(
            k=torch.zeros(shape, dtype=dt, device=dev),
            v=torch.zeros(shape, dtype=dt, device=dev),
            length=torch.zeros((batch,) if row_lengths else (),
                               dtype=torch.int32, device=dev),
            k_scale=scales(), v_scale=scales(),
        )

    def put_rows(self, row0: int, other: "KVCache") -> "KVCache":
        """Copy ``other``'s batch rows (planes, scales, length) into rows
        ``[row0, row0 + other's B)`` of this cache, whose length is per row.
        In place for the planes (``index_copy_`` on the batch axis); returns
        the cache with the new lengths."""
        n = other.k.shape[1]
        rows = torch.arange(row0, row0 + n, device=self.k.device)
        for mine, theirs in ((self.k, other.k), (self.v, other.v),
                             (self.k_scale, other.k_scale),
                             (self.v_scale, other.v_scale)):
            if mine is not None:
                mine.index_copy_(1, rows, theirs.to(mine.dtype))
        return dataclasses.replace(self, length=self.length.index_copy(
            0, rows, other.length.to(torch.int32).expand(n)))

    def write(self, k_new: torch.Tensor, v_new: torch.Tensor,
              advance: bool = True, offset: int = 0) -> "KVCache":
        """Write a [L, B, T, n_kv, hd] block at ``length + offset`` (each
        batch row at its own length when ``length`` is ``[B]``); optionally
        commit it (advance by T; offset must be 0 then)."""
        if advance and offset != 0:
            raise ValueError("write(advance=True) requires offset == 0: rows "
                             "below the offset would be committed unwritten")
        T = k_new.shape[2]
        start = self.length + offset
        write_block(self.k, self.v, self.k_scale, self.v_scale,
                    k_new, v_new, start)
        return dataclasses.replace(
            self, length=self.length + (T if advance else 0))

    def commit(self, n) -> "KVCache":
        """Advance length by ``n`` (an int, a scalar tensor or, per batch row,
        ``[B]``); rows must be in place."""
        return dataclasses.replace(
            self, length=(self.length + n).to(torch.int32))

    def accept_path(self, rel_indices: torch.Tensor, accept_count,
                    block_size: int) -> "KVCache":
        """Tree rollback: compact the accepted draft path into the prefix.

        ``rel_indices`` [A] (or [B, A], a path per batch row): slots of the
        accepted path's nodes inside the ``block_size``-row provisional
        tree block written at ``length``, padded arbitrarily past
        ``accept_count`` ([] or [B]; pads are clamped to ``[0,
        block_size-1]``, for rows and scales alike).  Moves those rows to
        ``length, length+1, ...`` (one K4 launch on the card) and advances
        by ``accept_count``; rows past the new length are garbage that
        attention masks and later writes cover."""
        gather_write_block(self.k, self.v, self.k_scale, self.v_scale,
                           rel_indices, self.length, block_size)
        return self.commit(accept_count)
