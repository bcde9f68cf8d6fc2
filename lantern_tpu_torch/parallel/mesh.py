"""The (dp, tp) process mesh and its sharding rules.

Counterpart of ``lantern_tpu/parallel/mesh.py``.  Base-model weights and
the KV cache are tensor-parallel over ``tp`` (attention heads, the FFN's
inner width, the vocabulary), the drafter is replicated, and requests go
over ``dp``.  The JAX package leaves the collectives to XLA; here each
process holds one device and its own slice of every split leaf, and the
forward (``models/transformer.py``) runs the Megatron collectives itself
through ``ops/quant.py``:

- column splits (``wq``/``wk``/``wv``, ``w_gate``/``w_up``) need none;
- row splits (``wo``, ``w_down``) give f32 partial products, all-reduced
  over tp in f32 and rounded to the activation dtype once;
- the vocab-split lm_head's ``[.., V/tp]`` logits are all-gathered.

The forward reads the mesh that ``set_mesh`` makes current, and what is
split from the shapes of the weights it is given, so with no mesh (or
``tp == 1``) every path is the single-process one.

Specs have the JAX form: per leaf, a tuple with ``None`` or ``"tp"`` per
axis (``tuple(PartitionSpec)``).  Three layout rules differ from what XLA
would do with the same specs, because a rank here computes on its slice
alone:

- **quantize, then shard**: a row-split kernel's ``*_s`` is the replicated
  full-K column scale (``_match_layout``); quantizing each shard gives
  other scales, which is another result;
- **shard the split layout, then fuse on each rank**: a fused ``wqkv`` /
  ``w_gu`` carries the spec of ``wq`` / ``w_gate``, and ``shard_pytree``
  slices each of its q/k/v (gate/up) parts and concatenates the rank's
  pieces; a fused kernel's columns are never cut contiguously.  The parts
  of ``wqkv`` are ``(nh, nkv, nkv) * hd`` wide (grouped-query attention
  makes them unequal): q as wide as ``wo`` has rows;
- **attention splits only where the head groups divide**: heads go over tp
  only when ``num_heads % tp == 0`` and the KV cache's 128-lane groups
  ``G % tp == 0`` (the JAX rule asks the heads alone); otherwise the
  attention weights, the QK norms and the cache are replicated.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as tdist

from ..configs import ModelConfig
from ..kv import KVCache, group_dims

TP = "tp"
# fused kernels: the split kernel whose spec they carry
FUSED = {"wqkv": "wq", "w_gu": "w_gate"}


@dataclasses.dataclass
class Mesh:
    """``dp x tp`` processes; rank ``r`` sits at ``(r // tp, r % tp)``.
    ``tp_group`` / ``dp_group``: the process groups of this rank's row and
    column (None for a mesh built without a process group, as the spec
    rules and the tests use)."""
    dp: int
    tp: int
    rank: int = 0
    tp_group: object = None
    dp_group: object = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp


def make_mesh(n_devices: Optional[int] = None, dp: int = 1) -> Mesh:
    """The mesh over the initialized process group (``n_devices`` defaults
    to, and must equal, its world size), with ``tp = n / dp`` and the
    groups of every row and column; one process without a group makes a
    1 x 1 mesh."""
    world = tdist.get_world_size() if tdist.is_initialized() else 1
    n = n_devices or world
    if n % dp:
        raise ValueError(f"n_devices {n} not divisible by dp {dp}")
    if n != world:
        raise ValueError(f"n_devices {n} != the {world} processes of the "
                         f"process group: one process drives one device")
    tp = n // dp
    if not tdist.is_initialized():
        return Mesh(dp=dp, tp=tp)
    rank = tdist.get_rank()
    mesh = Mesh(dp=dp, tp=tp, rank=rank)
    # every rank creates every group, in one order
    for d in range(dp):
        g = tdist.new_group(list(range(d * tp, (d + 1) * tp)))
        if d == mesh.dp_rank:
            mesh.tp_group = g
    for t in range(tp):
        g = tdist.new_group(list(range(t, n, tp)))
        if t == mesh.tp_rank:
            mesh.dp_group = g
    return mesh


_CURRENT: Optional[Mesh] = None


@contextlib.contextmanager
def set_mesh(mesh: Optional[Mesh]):
    """Make ``mesh`` the one the forward reads inside the block (the
    counterpart of ``jax.set_mesh``); ``None`` is no mesh."""
    global _CURRENT
    prev, _CURRENT = _CURRENT, mesh
    try:
        yield mesh
    finally:
        _CURRENT = prev


def current_mesh() -> Optional[Mesh]:
    return _CURRENT


def tp_group():
    """The current mesh's tp group where its tp > 1, else None."""
    m = _CURRENT
    if m is None or m.tp == 1:
        return None
    if m.tp_group is None:
        raise ValueError("the current mesh has tp > 1 but no process group: "
                         "build it with make_mesh after init_distributed")
    return m.tp_group


# ---------------------------------------------------------------------------
# sharding rules
# ---------------------------------------------------------------------------

def _divisible(n: int, mesh: Mesh) -> bool:
    return n % mesh.tp == 0


def heads_split(cfg: ModelConfig, mesh: Mesh) -> bool:
    """Attention goes over tp only when the heads and the cache's head
    groups both divide (``kv_specs``)."""
    G, _ = group_dims(cfg.num_kv_heads, cfg.head_dim)
    return (_divisible(cfg.num_heads, mesh)
            and _divisible(cfg.num_kv_heads, mesh) and _divisible(G, mesh))


def base_param_specs(cfg: ModelConfig, mesh: Mesh,
                     params: Optional[dict] = None) -> dict:
    """Megatron-style TP: q/k/v and the FFN's input column-split, ``wo``
    and ``w_down`` row-split, the lm_head split by vocab, the QK norms by
    head; norms, embeddings and the conditioning adapters replicated, and
    anything that does not divide.  With ``params`` the specs mirror its
    layout (``_match_layout``: fused, int8 ``*_q`` / ``*_s``)."""
    heads_ok = heads_split(cfg, mesh)
    ffn_ok = _divisible(cfg.intermediate_size, mesh)
    vocab_ok = _divisible(cfg.vocab_size, mesh)
    col = (None, None, TP)
    row = (None, TP, None)
    rep3 = (None, None, None)
    layers = {
        "attn_norm": (None, None),
        "wq": col if heads_ok else rep3,
        "wk": col if heads_ok else rep3,
        "wv": col if heads_ok else rep3,
        "wo": row if heads_ok else rep3,
        "ffn_norm": (None, None),
        "w_gate": col if ffn_ok else rep3,
        "w_up": col if ffn_ok else rep3,
        "w_down": row if ffn_ok else rep3,
    }
    if cfg.qk_norm:
        qn = (None, TP, None) if heads_ok else rep3
        layers.update(q_norm_w=qn, q_norm_b=qn, k_norm_w=qn, k_norm_b=qn)
    specs = {
        "embed": (None, None),
        "layers": layers,
        "norm": (None,),
        "lm_head": (None, TP) if vocab_ok else (None, None),
    }
    if cfg.cond_kind == "label":
        specs["cond"] = {"table": (None, None)}
    elif cfg.cond_kind == "caption":
        specs["cond"] = {"fc1": (None, None), "fc2": (None, None),
                         "uncond": (None, None)}
    if params is not None:
        specs = _match_layout(specs, params)
    return specs


def _match_layout(specs: dict, params: dict) -> dict:
    """Rewrite a spec tree to mirror a params tree that may carry quantized
    (``name_q`` / ``name_s``) entries or fused (``wqkv`` / ``w_gu``)
    kernels: a fused kernel takes its first part's spec, ``*_q`` its dense
    kernel's, ``*_s`` keeps only the output-column split; a leaf with no
    rule is replicated."""
    def rewrite(spec_d: dict, par_d: dict) -> dict:
        out = {}
        for key, val in par_d.items():
            if isinstance(val, dict):
                out[key] = rewrite(spec_d.get(key, {}), val)
                continue
            base = key[:-2] if key.endswith(("_q", "_s")) else key
            ref = spec_d.get(base, spec_d.get(FUSED.get(base, base)))
            if ref is None:
                ref = (None,) * val.ndim
            if key.endswith("_s") and len(ref) >= 2:
                # scale [.., 1, N]: keep only the output-column split
                ref = ref[:-2] + (None,) + ref[-1:]
            out[key] = tuple(ref)
        return out

    return rewrite(specs, params)


def drafter_param_specs(dparams: dict) -> dict:
    """The drafter is small: replicated."""
    return {k: (drafter_param_specs(v) if isinstance(v, dict)
                else (None,) * v.ndim) for k, v in dparams.items()}


def kv_specs(cfg: ModelConfig, mesh: Mesh, quantized: bool = False):
    """KVCache ``[L, B, G, S, W]``: head groups over tp where attention is
    split (``heads_split``); an int8 cache's ``[L, B, G, S]`` scale planes
    go with their groups."""
    g = TP if heads_split(cfg, mesh) else None
    spec = (None, None, g, None, None)
    sspec = (None, None, g, None) if quantized else None
    return KVCache(k=spec, v=spec, length=(), k_scale=sspec, v_scale=sspec)


# ---------------------------------------------------------------------------
# slicing and its inverse
# ---------------------------------------------------------------------------

def _items(tree):
    if isinstance(tree, dict):
        return tree.items()
    return ((f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree))


def _rebuild(tree, items: dict):
    if isinstance(tree, dict):
        return items
    return dataclasses.replace(tree, **items)


def _spec_of(specs, key):
    """A leaf's spec; a key the spec tree lacks is replicated."""
    if isinstance(specs, dict):
        return specs.get(key, {})
    return getattr(specs, key)


def _split_axis(spec) -> Optional[int]:
    axes = [i for i, a in enumerate(spec or ()) if a == TP]
    return axes[0] if axes else None


def _widths(key: str, x: torch.Tensor, axis: int, level: dict) -> list:
    """The widths along ``axis`` of the parts of leaf ``key`` of the dict
    ``level``: a fused kernel's (``w_gu``: two halves; ``wqkv``: q as wide
    as ``wo`` has rows, ``nh * hd``, then k and v at half the rest each,
    ``nkv * hd``), else the whole leaf as one part."""
    base = key[:-2] if key.endswith(("_q", "_s")) else key
    n = x.shape[axis]
    if base == "w_gu":
        return [n // 2, n // 2]
    if base == "wqkv":
        q = (level["wo"] if "wo" in level else level["wo_q"]).shape[-2]
        return [q, (n - q) // 2, (n - q) // 2]
    return [n]


def _slice(x: torch.Tensor, axis: int, widths: list, tp: int, r: int):
    """Rank ``r``'s piece of every one of ``x``'s parts (``widths`` along
    ``axis``), concatenated (a copy of its own, so the full tensor can be
    freed)."""
    pieces = []
    for p in x.split(widths, dim=axis):
        w = p.shape[axis] // tp
        pieces.append(p.narrow(axis, r * w, w))
    return torch.cat(pieces, dim=axis).contiguous()


def shard_pytree(tree, specs, mesh: Mesh, tp_rank: Optional[int] = None):
    """This rank's slice of every leaf of ``tree`` (nested dicts or a
    ``KVCache``): the leaf's ``tp`` axis cut ``mesh.tp`` ways, a fused
    kernel part by part; replicated leaves are returned as they are.
    ``tp_rank`` defaults to the mesh's."""
    r = mesh.tp_rank if tp_rank is None else tp_rank
    level = dict(_items(tree))
    out = {}
    for key, val in level.items():
        spec = _spec_of(specs, key)
        if isinstance(val, dict):
            out[key] = shard_pytree(val, spec, mesh, r)
            continue
        axis = _split_axis(spec)
        if val is None or axis is None or mesh.tp == 1:
            out[key] = val
            continue
        out[key] = _slice(val, axis, _widths(key, val, axis, level), mesh.tp,
                          r)
    return _rebuild(tree, out)


def gather_pytree(shards: list, specs):
    """The inverse of ``shard_pytree``: the full tree from the ``tp``
    ranks' shards, in tp-rank order (on the host, no collective)."""
    first = shards[0]
    levels = [dict(_items(s)) for s in shards]
    out = {}
    for key, val in levels[0].items():
        spec = _spec_of(specs, key)
        mine = [lv[key] for lv in levels]
        if isinstance(val, dict):
            out[key] = gather_pytree(mine, spec)
            continue
        axis = _split_axis(spec)
        if val is None or axis is None or len(shards) == 1:
            out[key] = val
            continue
        split = [m.split(_widths(key, m, axis, lv), dim=axis)
                 for m, lv in zip(mine, levels)]
        out[key] = torch.cat([torch.cat([s[p] for s in split], dim=axis)
                              for p in range(len(split[0]))], dim=axis)
    return _rebuild(first, out)
