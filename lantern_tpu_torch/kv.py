"""Static-shape KV cache with the grouped ``[L, B, G, S, W]`` layout.

Counterpart of ``lantern_tpu/kv.py``.  The layout, the S padding to a
multiple of 128 and the int8 granularity (one f32 scale per 128-lane group
row) are the JAX package's, so the tests can hold the two caches against
each other byte for byte.  ``length`` is an int32 scalar tensor on the
cache's device, so the decode loops never read it back to the host.

``KVCache.write`` goes through ``write_block``: on CUDA tensors one launch
of the hand-written kernel in ``csrc/kv_write.cu`` (replacing
``write_block``, ``lantern_tpu/ops/pallas/kv_update.py:170``) quantizes the
new rows and writes the K/V planes and the scale planes for every layer;
on CPU tensors ``write_block_plain`` does the same with plain PyTorch.
Unlike the JAX cache, ``write`` updates the buffers in place (the engines
never read a cache after writing past it).
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


def write_block_plain(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """K3's plain version.  ``k_new``/``v_new`` [L, B, T, n_kv, hd] land at
    rows ``[start, start+T)`` of the ``[L, B, G, S, W]`` planes, quantized
    per group row when the cache is int8 (scales into ``k_scale``/
    ``v_scale`` [L, B, G, S]).  ``start`` is clamped to ``[0, S-T]`` like
    ``lax.dynamic_update_slice``.  In place; no host sync."""
    S = k_buf.shape[3]
    T = k_new.shape[2]
    kg, vg = group_blocks(k_new), group_blocks(v_new)
    s0 = torch.clamp(start.to(torch.int64), 0, S - T)
    idx = s0 + torch.arange(T, device=k_buf.device)
    if k_scale is not None:
        kg, ks = quantize_rows(kg)
        vg, vs = quantize_rows(vg)
        k_scale.index_copy_(3, idx, ks)
        v_scale.index_copy_(3, idx, vs)
    k_buf.index_copy_(3, idx, kg.to(k_buf.dtype))
    v_buf.index_copy_(3, idx, vg.to(v_buf.dtype))


def write_block_cuda(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """K3 on the card: one launch writes (and, for an int8 cache,
    quantizes) the new rows of every layer into both planes and both scale
    planes.  ``start`` stays on the device."""
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
    _cuda.require(start.dtype == torch.int32 and start.numel() == 1,
                  "kv_write: start must be an int32 scalar tensor")
    _cuda.require(T <= S, f"kv_write: block of {T} rows exceeds S={S}")
    _cuda.library().kv_write(k_new, v_new, k_buf, v_buf,
                             k_scale if quantized else None,
                             v_scale if quantized else None, start)
    _cuda.LAUNCHES["kv_write"] += 1


def write_block(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start):
    """Dispatch by device: K3 on CUDA tensors, the plain version on CPU."""
    if _cuda.on_cuda(k_buf, v_buf, k_new, v_new, start):
        write_block_cuda(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start)
    else:
        write_block_plain(k_buf, v_buf, k_scale, v_scale, k_new, v_new, start)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # [L, B, G, S, W]  (model dtype, or int8)
    v: torch.Tensor
    length: torch.Tensor   # int32 scalar: valid prefix length
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
               dtype=None, quantized: bool = False, device=None) -> "KVCache":
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
            length=torch.zeros((), dtype=torch.int32, device=dev),
            k_scale=scales(), v_scale=scales(),
        )

    def write(self, k_new: torch.Tensor, v_new: torch.Tensor,
              advance: bool = True, offset: int = 0) -> "KVCache":
        """Write a [L, B, T, n_kv, hd] block at ``length + offset``;
        optionally commit it (advance by T; offset must be 0 then)."""
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
        """Advance length by ``n`` (a tensor or int); rows must be in place."""
        return dataclasses.replace(
            self, length=(self.length + n).to(torch.int32))
